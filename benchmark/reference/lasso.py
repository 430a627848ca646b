"""Lasso's semantics in plain Python and NumPy: the densified tables, the
sparse polynomial's value at a point, the Hyrax row commitments and the
verifier (a16z/Lasso src/lasso/surge.rs, densified.rs, memory_checking.rs,
src/subprotocols/, src/poly/).  What depends on the subtable strategy comes
from its module in `benchmark/reference/strategies/`, handed in as `strat`.

A proof is handed over as plain data: each struct a dict of its fields by
their names in the reference, each point its 32-byte compressed encoding,
each scalar an int.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import curve
from benchmark.reference.transcript import Transcript

FR = curve.FR


class Rejected(Exception):
    """The verifier refused the proof; the message says at which check."""


def log2(n: int) -> int:
    return (n - 1).bit_length()


def next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


# -- densify -------------------------------------------------------------------

def densify(indices: np.ndarray, log_m: int):
    """(dims [C, s], read_ts [C, s], final_ts [C, M]) of [s_raw, C] lookups,
    padded to a power of two with lookups of address 0.  read_ts counts the
    earlier lookups of the same address in the same chunk; final_ts counts
    all of them."""
    s_raw, c = indices.shape
    s = next_pow2(s_raw)
    m = 1 << log_m
    dims = np.zeros((c, s), dtype=np.int64)
    dims[:, :s_raw] = indices.T
    read = np.zeros((c, s), dtype=np.int64)
    final = np.zeros((c, m), dtype=np.int64)
    for i in range(c):
        order = np.argsort(dims[i], kind="stable")
        sorted_addr = dims[i][order]
        first = np.searchsorted(sorted_addr, sorted_addr, side="left")
        read[i][order] = np.arange(s) - first
        final[i] = np.bincount(dims[i], minlength=m)
    return dims, read, final


def combined_tables(indices: np.ndarray, log_m: int):
    """The two committed polynomials' values: dims ++ read_ts and final_ts,
    each flattened and zero-padded to a power of two."""
    dims, read, final = densify(indices, log_m)

    def flat(x):
        x = x.reshape(-1)
        return np.pad(x, (0, next_pow2(x.size) - x.size))

    return flat(np.concatenate([dims, read])), flat(final)


def montgomery_limbs(values: np.ndarray) -> np.ndarray:
    """[n, 16] little-endian 16-bit limbs of v * 2^256 mod r, as int32."""
    uniq, inverse = np.unique(values, return_inverse=True)
    table = np.zeros((uniq.size, 16), dtype=np.int32)
    for row, v in enumerate(uniq.tolist()):
        x = (v << 256) % FR
        table[row] = [(x >> (16 * j)) & 0xFFFF for j in range(16)]
    return table[inverse.reshape(-1)]


# -- the sparse polynomial's value -----------------------------------------------

def eq_evals(r: list[int]) -> list[int]:
    """eq(r, k) for every k in {0,1}^len(r); r[0] is k's top bit."""
    evals = [1]
    for rj in r:
        nxt = []
        for e in evals:
            t = e * rj % FR
            nxt.append((e - t) % FR)
            nxt.append(t)
        evals = nxt
    return evals


def eq(r: list[int], x: list[int]) -> int:
    acc = 1
    for a, b in zip(r, x):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % FR) % FR
    return acc


def evaluation(indices: np.ndarray, r: list[int], log_m: int, strat) -> int:
    """sum_k eq(r, k) g(T_1[nz_k,d_1], ..., T_a[nz_k,d_a]): the claimed
    evaluation, memory j reading its subtable at chunk d_j of lookup k."""
    s_raw, c = indices.shape
    padded = np.zeros((next_pow2(s_raw), c), dtype=np.int64)
    padded[:s_raw] = indices
    vals = strat.combine([
        strat.subtable_values(
            strat.memory_to_subtable(j, c),
            padded[:, strat.memory_to_dimension(j, c)], log_m).astype(object)
        for j in range(strat.num_memories(c))], log_m)
    for rj in r:  # bind the top variable
        half = vals.shape[0] // 2
        lo, hi = vals[:half], vals[half:]
        vals = (lo + (hi - lo) * rj) % FR
    return int(vals[0]) % FR


# -- commitments -----------------------------------------------------------------

def factored(num_vars: int) -> tuple[int, int]:
    """(rows, columns) exponents of a Hyrax matrix."""
    return num_vars // 2, num_vars - num_vars // 2


def rows_match(values: np.ndarray, rows: list, gens: list, rng) -> bool:
    """Whether the Hyrax rows are the Pedersen commitments of `values`:
    sum_i w_i C_i == sum_j (sum_i w_i z_ij) G_j for random 128-bit w_i
    (a wrong row survives with probability 2^-128)."""
    left, right = factored(log2(values.size))
    if len(rows) != 1 << left:
        return False
    z = values.reshape(1 << left, 1 << right)
    w16 = rng.integers(0, 1 << 16, size=(8, 1 << left), dtype=np.int64)
    col = w16 @ z  # [8, columns], each sum below 2^63
    weights = [sum(int(w16[k, i]) << (16 * k) for k in range(8))
               for i in range(1 << left)]
    col_scalars = [sum(int(col[k, j]) << (16 * k) for k in range(8)) % FR
                   for j in range(1 << right)]
    lhs = curve.msm(rows, weights)
    rhs = curve.msm(gens[: 1 << right], col_scalars)
    return curve.equal(lhs, rhs)


# -- the verifier ---------------------------------------------------------------

def _require(ok: bool, what: str) -> None:
    if not ok:
        raise Rejected(what)


def _fold(vals: list[int], challenges: list[int]) -> int:
    for ch in reversed(challenges):
        vals = [(vals[2 * i] + ch * (vals[2 * i + 1] - vals[2 * i])) % FR
                for i in range(len(vals) // 2)]
    return vals[0]


def _sumcheck(polys, claim: int, num_rounds: int, degree: int,
              t: Transcript):
    _require(len(polys) == num_rounds, "sumcheck round count")
    e, r = claim % FR, []
    for cp in polys:
        rest = cp["coeffs_except_linear_term"]
        linear = (e - 2 * rest[0] - sum(rest[1:])) % FR
        coeffs = [rest[0], linear] + list(rest[1:])
        _require(len(coeffs) - 1 == degree, "sumcheck round degree")
        _require((coeffs[0] + sum(coeffs)) % FR == e, "sumcheck G(0)+G(1)")
        t.append_message(b"poly", b"UniPoly_begin")
        for x in coeffs:
            t.append_scalar(b"coeff", x)
        t.append_message(b"poly", b"UniPoly_end")
        ri = t.challenge_scalar(b"challenge_nextround")
        r.append(ri)
        e = 0
        for x in reversed(coeffs):
            e = (e * ri + x) % FR
    return e, r


class _OpeningGens:
    """G_n, G_1 and h of an opening over n generators."""

    def __init__(self, stream: list, n: int):
        self.n, self.G, self.g1, self.h = n, stream[:n], stream[n], stream[n + 1]


def _dot_product_log(proof, gens: _OpeningGens, t: Transcript, a: list[int],
                     cx, cy) -> None:
    n = gens.n
    _require(len(a) == n, "opening length")
    t.append_protocol_name(b"dot product proof (log)")
    t.append_point(b"Cx", cx)
    t.append_point(b"Cy", cy)
    t.append_scalars(b"a", a)
    bullet = proof["bullet_reduction_proof"]
    l_vec, r_vec = bullet["L_vec"], bullet["R_vec"]
    lg_n = len(l_vec)
    _require(len(r_vec) == lg_n and n == 1 << lg_n, "bullet round count")
    u = []
    for lb, rb in zip(l_vec, r_vec):
        t.append_point(b"L", lb)
        t.append_point(b"R", rb)
        u.append(t.challenge_scalar(b"u"))
    u_inv = curve.batch_inv(u, FR)
    all_inv = 1
    for x in u_inv:
        all_inv = all_inv * x % FR
    u_sq = [x * x % FR for x in u]
    u_inv_sq = [x * x % FR for x in u_inv]
    s = [all_inv]
    for i in range(1, n):
        lg_i = i.bit_length() - 1
        s.append(s[i - (1 << lg_i)] * u_sq[lg_n - 1 - lg_i] % FR)
    g_hat = curve.msm(gens.G, s)
    a_hat = sum(x * y for x, y in zip(a, s)) % FR
    gamma = curve.add(cx, cy)
    gamma_hat = curve.msm(
        [curve.decompress(p) for p in l_vec + r_vec] + [gamma],
        u_sq + u_inv_sq + [1])
    t.append_point(b"delta", proof["delta"])
    t.append_point(b"beta", proof["beta"])
    c = t.challenge_scalar(b"c")
    beta, delta = curve.decompress(proof["beta"]), curve.decompress(proof["delta"])
    lhs = curve.add(curve.mul(curve.add(curve.mul(gamma_hat, c), beta), a_hat),
                    delta)
    rhs = curve.add(
        curve.mul(curve.add(g_hat, curve.mul(gens.g1, a_hat)), proof["z1"]),
        curve.mul(gens.h, proof["z2"]))
    _require(curve.equal(lhs, rhs), "dot-product opening")


def _poly_eval(proof, gens: _OpeningGens, t: Transcript, r: list[int],
               zr: int, rows: list) -> None:
    """PolyEvalProof::verify_plain: the Hyrax opening of rows at r to zr."""
    cy = curve.mul(gens.g1, zr)
    t.append_protocol_name(b"polynomial evaluation proof")
    left, _ = factored(len(r))
    cx = curve.msm(rows, eq_evals(r[:left]))
    _dot_product_log(proof["proof"], gens, t, eq_evals(r[left:]), cx, cy)


def _combined_eval(proof, r: list[int], evals: list[int], gens: _OpeningGens,
                   rows: list, t: Transcript) -> None:
    t.append_protocol_name(b"Lasso CombinedTableEvalProof")
    evals = list(evals) + [0] * (next_pow2(len(evals)) - len(evals))
    t.append_scalars(b"evals_ops_val", evals)
    ch = t.challenge_vector(b"challenge_combine_n_to_one", log2(len(evals)))
    joint = _fold(evals, ch)
    t.append_scalar(b"joint_claim_eval", joint)
    _poly_eval(proof["proof_table_eval"], gens, t, ch + list(r), joint, rows)


def _grand_product(layers, claims: list[int], n: int, t: Transcript):
    _require(len(layers) == log2(n), "grand product layer count")
    rand: list[int] = []
    for num_rounds, layer in enumerate(layers):
        coeffs = t.challenge_vector(b"rand_coeffs_next_layer", len(claims))
        claim = sum(c * v for c, v in zip(coeffs, claims)) % FR
        last, rand_prod = _sumcheck(layer["proof"]["compressed_polys"], claim,
                                    num_rounds, 3, t)
        left, right = layer["claims_prod_left"], layer["claims_prod_right"]
        _require(len(left) == len(claims) == len(right),
                 "grand product claim count")
        for cl, cr in zip(left, right):
            t.append_scalar(b"claim_prod_left", cl)
            t.append_scalar(b"claim_prod_right", cr)
        e = eq(rand, rand_prod)
        want = sum(c * (cl * cr % FR * e) for c, cl, cr in
                   zip(coeffs, left, right)) % FR
        _require(want == last, "grand product layer claim")
        r_layer = t.challenge_scalar(b"challenge_r_layer")
        claims = [(cl + r_layer * (cr - cl)) % FR for cl, cr in zip(left, right)]
        rand = [r_layer] + rand_prod
    return claims, rand


def _append_rows(t: Transcript, label: bytes, rows: list[bytes]) -> None:
    t.append_message(label, b"poly_commitment_begin")
    for row in rows:
        t.append_point(b"poly_commitment_share", row)
    t.append_message(label, b"poly_commitment_end")


def verify(proof: dict, rows_l: list, rows_m: list, r: list[int], s: int,
           c: int, log_m: int, stream: list, label: bytes, strat) -> None:
    """SparsePolynomialEvaluationProof::verify for the strategy `strat`;
    raises Rejected.  rows_l, rows_m: the decompressed commitment rows;
    stream: the label's generator points, enough for the widest opening."""
    alpha = strat.num_memories(c)
    num_vars_l = log2(next_pow2(2 * c * s))
    num_vars_m = log2(next_pow2(c)) + log_m
    num_vars_d = log2(next_pow2(alpha * s))

    def gens(num_vars):
        return _OpeningGens(stream, 1 << factored(num_vars)[1])

    t = Transcript(label)
    t.append_protocol_name(b"Lasso SparsePolynomialEvaluationProof")
    _require(len(r) == log2(s), "point length")
    derefs_b = proof["comm_derefs"]["comm_ops_val"]["C"]
    rows_d = [curve.decompress(p) for p in derefs_b]
    t.append_message(b"subtable_evals_commitment",
                     b"begin_subtable_evals_commitment")
    _append_rows(t, b"comm_poly_row_col_ops_val", derefs_b)
    t.append_message(b"subtable_evals_commitment",
                     b"end_subtable_evals_commitment")

    ps = proof["primary_sumcheck"]
    t.append_scalar(b"claim_eval_scalar_product", ps["claimed_evaluation"])
    last, r_z = _sumcheck(ps["proof"]["compressed_polys"],
                          ps["claimed_evaluation"], log2(s),
                          strat.g_degree(c) + 1, t)
    derefs = ps["eval_derefs"]
    _require(len(derefs) == alpha, "lookup evaluation count")
    _require(eq(r, r_z) * strat.combine(derefs, log_m) % FR == last,
             "primary sumcheck final claim")
    _combined_eval(ps["proof_derefs"], r_z, derefs, gens(num_vars_d), rows_d, t)

    r_hash, r_multiset = t.challenge_vector(b"challenge_r_hash", 2)
    mc = proof["memory_check"]
    t.append_protocol_name(b"Lasso MemoryCheckingProof")
    prod = mc["proof_prod_layer"]
    t.append_protocol_name(b"Lasso ProductLayerProof")
    hashes = prod["grand_product_evals"]
    _require(len(hashes) == alpha, "memory count")
    for h_init, h_read, h_write, h_final in hashes:
        _require(h_init * h_write % FR == h_read * h_final % FR,
                 "multiset hash identity")
        t.append_scalar(b"claim_hash_init", h_init)
        t.append_scalar(b"claim_hash_read", h_read)
        t.append_scalar(b"claim_hash_write", h_write)
        t.append_scalar(b"claim_hash_final", h_final)
    claims_ops, rand_ops = _grand_product(
        prod["proof_ops"]["proof"], [x for h in hashes for x in h[1:3]],
        next_pow2(s), t)
    claims_mem, rand_mem = _grand_product(
        prod["proof_mem"]["proof"], [x for h in hashes for x in h[::3]],
        1 << log_m, t)

    hl = mc["proof_hash_layer"]
    t.append_protocol_name(b"Lasso HashLayerProof")
    _combined_eval(hl["proof_derefs"], rand_ops, hl["eval_derefs"],
                   gens(num_vars_d), rows_d, t)
    evals_ops = list(hl["eval_dim"]) + list(hl["eval_read"])
    evals_ops += [0] * (next_pow2(len(evals_ops)) - len(evals_ops))
    t.append_scalars(b"claim_evals_ops", evals_ops)
    ch = t.challenge_vector(b"challenge_combine_n_to_one", log2(len(evals_ops)))
    joint = _fold(evals_ops, ch)
    t.append_scalar(b"joint_claim_eval_ops", joint)
    _poly_eval(hl["proof_ops"], gens(num_vars_l), t, ch + list(rand_ops),
               joint, rows_l)
    evals_mem = list(hl["eval_final"])
    t.append_scalars(b"claim_evals_mem", evals_mem)
    ch = t.challenge_vector(b"challenge_combine_two_to_one",
                            log2(len(evals_mem)))
    evals_mem += [0] * (next_pow2(len(evals_mem)) - len(evals_mem))
    joint = _fold(evals_mem, ch)
    t.append_scalar(b"joint_claim_eval_mem", joint)
    _poly_eval(hl["proof_mem"], gens(num_vars_m), t, ch + list(rand_mem),
               joint, rows_m)

    init_addr = sum((1 << (len(rand_mem) - 1 - i)) * x
                    for i, x in enumerate(rand_mem)) % FR
    g2 = r_hash * r_hash % FR

    def fingerprint(a, v, ts):
        return (ts * g2 + v * r_hash + a - r_multiset) % FR

    for k in range(alpha):  # memory k reads chunk j of subtable sub
        j, sub = strat.memory_to_dimension(k, c), strat.memory_to_subtable(k, c)
        h_init, h_read, h_write, h_final = (
            claims_mem[2 * k], claims_ops[2 * k], claims_ops[2 * k + 1],
            claims_mem[2 * k + 1])
        dim, read, fin = hl["eval_dim"][j], hl["eval_read"][j], hl["eval_final"][j]
        deref = hl["eval_derefs"][k]
        init_val = strat.subtable_mle(sub, rand_mem)
        _require(fingerprint(init_addr, init_val, 0) == h_init, "init fingerprint")
        _require(fingerprint(dim, deref, read) == h_read, "read fingerprint")
        _require(fingerprint(dim, deref, read + 1) == h_write, "write fingerprint")
        _require(fingerprint(init_addr, init_val, fin) == h_final,
                 "final fingerprint")
