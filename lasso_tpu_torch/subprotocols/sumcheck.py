"""Sumcheck prover/verifier (port of subprotocols/sumcheck.py; reference:
src/subprotocols/sumcheck.rs).

Each round evaluates every stacked polynomial at the degree+1 round points
(incremental `prev + (hi - lo)` updates over the half-cube), combines them
with the strategy's g, and reduces each round point to one field element on
the device; with the host transcript, the host interpolates the round
polynomial, feeds the Fiat-Shamir transcript, and the device binds all
tables to the challenge.

PyTorch runs eagerly, so every round uses exact shapes: the reference's
fixed-size masked buffers (SUMCHECK_FIX) only exist to bound XLA
recompilation, and they give the same field values.

With the transcript on the device (transcript/device_strobe.py, chosen by
_device_sumcheck_supported), the rounds never leave the device: each
round's polynomial is interpolated there (one product with the inverse
Vandermonde matrix), absorbed, and its challenge squeezed there, and the
whole sumcheck downloads once at its end, as the reference's device path
does.  Where the reference peels round 0 and loops the rest in one
`fori_loop`, the port runs every round the same way in Python.

Given a mesh (parallel/mesh.py), the same provers run on one rank's cyclic
shard of the tables: the rounds run on the host transcript with the
round sums psummed over the ranks while a rank holds more than one
element, then the remaining rounds run on the gathered tables as above.
The proof is the same (the reference's parallel/prover.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, W, pack_int
from lasso_tpu_torch.poly.dense import _bind_top_single, finish_columns
from lasso_tpu_torch.poly.unipoly import (CompressedUniPoly, UniPoly,
                                          _solve_vandermonde)
from lasso_tpu_torch.transcript.device_strobe import (DeviceTranscript,
                                                      _post_challenge_meta,
                                                      scalar_bytes)
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.tracing import instrument, span


def _log2(n: int) -> int:
    return (n - 1).bit_length()


def _round_evals(zs, comb, degree: int, mesh=None):
    """zs: [alpha, n, W] -> [degree+1, W] sums of comb over the half-cube;
    with a mesh, zs is this rank's cyclic shard and the sums run over the
    ranks."""
    half = zs.shape[1] // 2
    lo = zs[:, :half]
    hi = zs[:, half:]
    cols = [TFr.sum_columns(comb(lo)), TFr.sum_columns(comb(hi))]
    diff = TFr.sub(hi, lo)
    cur = hi
    for _ in range(2, degree + 1):
        cur = TFr.add(cur, diff)
        cols.append(TFr.sum_columns(comb(cur)))
    return finish_columns(torch.stack(cols), mesh)


def _bind_top(zs, r):
    """Bind the top variable of every stacked polynomial:
    [a, n, W] -> [a, n/2, W]."""
    half = zs.shape[1] // 2
    lo = zs[:, :half]
    hi = zs[:, half:]
    return TFr.add(lo, TFr.mul(r, TFr.sub(hi, lo)))


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[CompressedUniPoly]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        """Host-side verification of the round polynomials.

        Returns (final claim e, challenge point r)."""
        e = claim % Fr.p
        r: list[int] = []
        if len(self.compressed_polys) != num_rounds:
            raise LassoError(f"expected {num_rounds} round polys, got {len(self.compressed_polys)}")
        for cp in self.compressed_polys:
            poly = cp.decompress(e)
            if poly.degree() != degree_bound:
                raise LassoError(
                    f"round poly degree {poly.degree()} != bound {degree_bound}")
            if (poly.eval_at_zero() + poly.eval_at_one()) % Fr.p != e:
                raise LassoError("sumcheck round identity G(0)+G(1) != e failed")
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r


@dataclass
class ZKSumcheckInstanceProof:
    """ZK sumcheck: committed round polynomials + dot-product decommitments
    (reference: src/subprotocols/sumcheck.rs:331-448, verify-only like the
    reference -- the non-ZK prover is what Lasso uses)."""

    comm_polys: list  # host Points
    comm_evals: list  # host Points
    proofs: list  # DotProductProof

    def verify(self, comm_claim, num_rounds: int, degree_bound: int,
               gens_1, gens_n, transcript, device="cuda"):
        """Returns (comm_eval_last, r).  `device` is where a decommitment
        wider than the host-MSM threshold runs its MSM."""
        if gens_n.n != degree_bound + 1:
            raise LassoError("ZK sumcheck generator size mismatch")
        if len(self.comm_polys) != num_rounds or len(self.comm_evals) != num_rounds:
            raise LassoError("ZK sumcheck round count mismatch")

        r: list[int] = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            transcript.append_point(b"comm_poly", comm_poly)
            r_i = transcript.challenge_scalar(b"challenge_nextround")

            comm_claim_per_round = comm_claim if i == 0 else self.comm_evals[i - 1]
            comm_eval = self.comm_evals[i]
            transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)

            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
            comm_target = comm_claim_per_round.mul(w[0]).add(comm_eval.mul(w[1]))

            # decommitment vector: w0 * [2,1,..,1] + w1 * [1, r, r^2, ...]
            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1] * (degree_bound + 1)
            for j in range(1, degree_bound + 1):
                a_eval[j] = a_eval[j - 1] * r_i % Fr.p
            a = [(w[0] * x + w[1] * y) % Fr.p for x, y in zip(a_sc, a_eval)]

            self.proofs[i].verify(gens_1, gens_n, transcript, a,
                                  comm_poly, comm_target, device)
            r.append(r_i)

        return self.comm_evals[-1], r


# ---------------------------------------------------------------------------
# the device-transcript rounds
# ---------------------------------------------------------------------------

def _device_sumcheck_supported(transcript, device) -> bool:
    """Whether the provers keep the transcript on the device: by default
    when their tensors lie on a card (the reference: on a TPU); never for a
    TestTranscript.  LASSO_TPU_DEVICE_TRANSCRIPT, read at each call: `0` or
    `off` takes the host path, `force` the device path on any device (the
    CPU tests reach it so)."""
    from lasso_tpu_torch.transcript.proof_transcript import (ProofTranscript,
                                                             TestTranscript)

    flag = os.environ.get("LASSO_TPU_DEVICE_TRANSCRIPT", "1")
    if flag in ("0", "off"):
        return False
    if not isinstance(transcript, ProofTranscript) or \
            isinstance(transcript, TestTranscript):
        return False
    return flag == "force" or torch.device(device).type == "cuda"


_VINV_CACHE: dict[int, np.ndarray] = {}


def _vandermonde_inv_mont(degree: int) -> np.ndarray:
    """[d+1, d+1, W] Montgomery limbs of the inverse Vandermonde matrix over
    the points 0..degree: coeffs[j] = sum_k VINV[j][k] * evals[k].  Column k
    holds the coefficients of the polynomial that is 1 at k and 0 at the
    other points."""
    got = _VINV_CACHE.get(degree)
    if got is None:
        d = degree + 1
        got = np.zeros((d, d, W), dtype=np.uint32)
        for k in range(d):
            col = _solve_vandermonde([int(i == k) for i in range(d)])
            for j in range(d):
                got[j, k] = pack_int(Fr.to_mont(col[j]))
        _VINV_CACHE[degree] = got
    return got


def _interp_coeffs_device(evals, degree: int):
    """evals [d+1, W] Montgomery -> coefficients [d+1, W] Montgomery."""
    vinv = TFr.const(_vandermonde_inv_mont(degree), evals.device)
    prods = TFr.mul(vinv, evals[None])  # [j, k, W]
    return TFr.finish_sum(TFr.sum_columns(prods.movedim(1, 0)))


def _append_round_poly_device(dt, coeffs) -> None:
    """UniPoly.append_to_transcript of device coefficients [d+1, W]."""
    dt.append_message_static(b"poly", b"UniPoly_begin")
    dt.append_scalar_rows(b"coeff", scalar_bytes(coeffs))
    dt.append_message_static(b"poly", b"UniPoly_end")


def _device_round(dt, evals, degree: int):
    """Interpolate, absorb and squeeze one round: (coeffs [d+1, W], r [W])."""
    coeffs = _interp_coeffs_device(evals, degree)
    _append_round_poly_device(dt, coeffs)
    r = dt.challenge_scalar(b"challenge_nextround")
    # every round ends at the canonical post-challenge position
    assert dt.meta() == _post_challenge_meta(), "strobe round exit not canonical"
    return coeffs, r


def _prove_arbitrary_device(zs, comb, degree: int, num_rounds: int, dt):
    """prove_arbitrary's rounds with the transcript `dt` on zs' device; no
    host sync.  Returns (limbs [rounds * (degree + 2) + alpha, W]: each
    round's coefficients and challenge, then the final evals; bound zs)."""
    rows = []
    for _ in range(num_rounds):
        with span("Sumcheck.arbitrary_evals"):
            evals = _round_evals(zs, comb, degree)
        with span("Sumcheck.arbitrary_challenge"):
            coeffs, r = _device_round(dt, evals, degree)
        with span("Sumcheck.arbitrary_bind"):
            zs = _bind_top(zs, r)
        rows += [coeffs, r[None]]
    rows.append(zs[:, 0])
    return torch.cat(rows), zs


def _horner(coeffs, r):
    """poly(r) of Montgomery coefficients [d+1, W] at r [W]."""
    e = coeffs[-1]
    for j in range(coeffs.shape[0] - 2, -1, -1):
        e = TFr.add(TFr.mul(e, r), coeffs[j])
    return e


def _cubic_rounds_device(dt, a, b, c, e, rlc, num_rounds: int):
    """prove_cubic_batched's rounds with the transcript `dt` on the
    device; no host sync.  e: [W] running claim, rlc: [I, W] Montgomery.
    Returns (a, b, c bound, rows: per round [coeffs (4), r], rs: the
    challenges [W])."""
    rows, rs = [], []
    for _ in range(num_rounds):
        with span("Sumcheck.cubic_evals"):
            ev = _cubic_round_evals(a, b, c)  # [3, I, W]
            comb = TFr.finish_sum(TFr.sum_columns(
                TFr.mul(ev, rlc[None]).movedim(1, 0)))  # [3, W]: t = 0, 2, 3
            evals = torch.stack([comb[0], TFr.sub(e, comb[0]), comb[1],
                                 comb[2]])
        with span("Sumcheck.interpolate_and_challenge"):
            coeffs, r = _device_round(dt, evals, 3)
        with span("Sumcheck.bind"):
            a, b, c = _bind_top(a, r), _bind_top(b, r), _bind_top_single(c, r)
            e = _horner(coeffs, r)
        rows += [coeffs, r[None]]
        rs.append(r)
    return a, b, c, rows, rs


def _prove_cubic_batched_device(e_mont, num_rounds: int, a, b, c, rlc, dt):
    """The rounds of prove_cubic_batched and its final claims, on the
    device: limbs [rounds * 5 + 2I + 1, W]."""
    a, b, c, rows, _ = _cubic_rounds_device(dt, a, b, c, e_mont, rlc,
                                            num_rounds)
    return torch.cat(rows + [a[:, 0], b[:, 0], c[:1]])


def _round_polys(vals, num_rounds: int, d1: int):
    """Host ints of `num_rounds` device rounds of d1 coefficients and a
    challenge each -> (compressed polys, challenges)."""
    polys, rs = [], []
    for k in range(num_rounds):
        row = vals[k * (d1 + 1): (k + 1) * (d1 + 1)]
        polys.append(UniPoly(row[:d1]).compress())
        rs.append(row[d1])
    return polys, rs


def _host_rounds(zs, comb, degree: int, num_rounds: int, transcript,
                 compressed: list, r_out: list, mesh=None):
    """prove_arbitrary's rounds on the host transcript, appending to
    compressed and r_out; returns the bound stack."""
    for _ in range(num_rounds):
        evals = TFr.decode(_round_evals(zs, comb, degree, mesh))
        round_poly = UniPoly.from_evals(evals)
        round_poly.append_to_transcript(b"poly", transcript)
        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r_out.append(r_j)
        zs = _bind_top(zs, TFr.encode_scalar(r_j, zs.device))
        compressed.append(round_poly.compress())
    return zs


@instrument("Sumcheck.prove", sync=True)
def prove_arbitrary(polys_stack, comb, degree: int, num_rounds: int, transcript,
                    mesh=None):
    """Arbitrary-degree sumcheck prover over stacked tables [alpha, n, W].

    `comb` maps [alpha, m, W] -> [m, W].  With a mesh (parallel/mesh.py),
    polys_stack is this rank's cyclic shard [alpha, n/D, W]: the rounds run
    on the shard with the host transcript, one psum each, while a rank
    holds more than one element; the last log D rounds (the rank bits) run
    on the gathered stack.  The proof is the same.  Returns
    (SumcheckInstanceProof, r (host ints), final_evals (host ints), bound
    stack)."""
    zs = polys_stack
    device = zs.device
    compressed: list = []
    r_out: list[int] = []
    if mesh is not None:
        sharded = min(_log2(zs.shape[1]), num_rounds)
        zs = _host_rounds(zs, comb, degree, sharded, transcript, compressed,
                          r_out, mesh)
        zs = mesh.gather(zs, axis=1)
        num_rounds -= sharded
    if num_rounds > 0 and _device_sumcheck_supported(transcript, device):
        dt = DeviceTranscript.from_host(transcript, device)
        limbs, zs = _prove_arbitrary_device(zs, comb, degree, num_rounds, dt)
        vals = TFr.decode(dt.finish(transcript, limbs))
        polys, rs = _round_polys(vals, num_rounds, degree + 1)
        final_evals = vals[num_rounds * (degree + 2):]
        return (SumcheckInstanceProof(compressed + polys), r_out + rs,
                final_evals, zs)

    zs = _host_rounds(zs, comb, degree, num_rounds, transcript, compressed,
                      r_out)
    final_evals = TFr.decode(zs[:, 0])
    return SumcheckInstanceProof(compressed), r_out, final_evals, zs


def _cubic_round_evals(a, b, c, mesh=None):
    """Batched cubic round evals at t in {0, 2, 3}.

    a, b: [I, n, W]; c: [n, W] shared (with a mesh, this rank's shards).
    Returns [3, I, W] sums."""
    half = a.shape[1] // 2
    a_lo, a_hi = a[:, :half], a[:, half:]
    b_lo, b_hi = b[:, :half], b[:, half:]
    c_lo, c_hi = c[:half], c[half:]

    def cols(x, y, z):  # [I, half, W] -> [I, W + 3]
        return TFr.sum_columns(TFr.mul(TFr.mul(x, y), z[None]).movedim(1, 0))

    e0 = cols(a_lo, b_lo, c_lo)
    a_d, b_d, c_d = TFr.sub(a_hi, a_lo), TFr.sub(b_hi, b_lo), TFr.sub(c_hi, c_lo)
    a2, b2, c2 = TFr.add(a_hi, a_d), TFr.add(b_hi, b_d), TFr.add(c_hi, c_d)
    e2 = cols(a2, b2, c2)
    a3, b3, c3 = TFr.add(a2, a_d), TFr.add(b2, b_d), TFr.add(c2, c_d)
    e3 = cols(a3, b3, c3)
    return finish_columns(torch.stack([e0, e2, e3]), mesh)


def _cubic_host_rounds(e: int, a, b, c, coeffs: list[int], num_rounds: int,
                       transcript, compressed: list, r_out: list, mesh=None):
    """prove_cubic_batched's rounds on the host transcript, appending to
    compressed and r_out; returns (claim, a, b, c bound)."""
    num_instances = a.shape[0]
    for _ in range(num_rounds):
        flat = TFr.decode(_cubic_round_evals(a, b, c, mesh).reshape(
            3 * num_instances, -1))
        e0 = flat[0:num_instances]
        e2 = flat[num_instances:2 * num_instances]
        e3 = flat[2 * num_instances:]

        comb0 = sum(x * y for x, y in zip(e0, coeffs)) % Fr.p
        comb2 = sum(x * y for x, y in zip(e2, coeffs)) % Fr.p
        comb3 = sum(x * y for x, y in zip(e3, coeffs)) % Fr.p
        evals = [comb0, (e - comb0) % Fr.p, comb2, comb3]
        round_poly = UniPoly.from_evals(evals)
        round_poly.append_to_transcript(b"poly", transcript)

        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r_out.append(r_j)
        r_dev = TFr.encode_scalar(r_j, a.device)
        a = _bind_top(a, r_dev)
        b = _bind_top(b, r_dev)
        c = _bind_top_single(c, r_dev)
        e = round_poly.evaluate(r_j)
        compressed.append(round_poly.compress())
    return e, a, b, c


@instrument("Sumcheck.prove_batched")
def prove_cubic_batched(claim: int, num_rounds: int, a_stack, b_stack, c_poly,
                        coeffs: list[int], transcript, mesh=None):
    """Batched product-layer sumcheck (reference: sumcheck.rs:27-135).

    a_stack, b_stack: [I, n, W] (left/right inputs per instance);
    c_poly: [n, W] shared eq polynomial; coeffs: host RLC coefficients.
    With a mesh, the three are this rank's cyclic shards, as in
    prove_arbitrary.

    Returns (proof, r, (claims_A, claims_B, claim_C))."""
    e = claim % Fr.p
    a, b, c = a_stack, b_stack, c_poly
    del a_stack, b_stack, c_poly
    device = a.device
    num_instances = a.shape[0]
    compressed: list = []
    r_out: list[int] = []
    if mesh is not None:
        sharded = min(_log2(a.shape[1]), num_rounds)
        e, a, b, c = _cubic_host_rounds(e, a, b, c, coeffs, sharded,
                                        transcript, compressed, r_out, mesh)
        a, b, c = mesh.gather(a, axis=1), mesh.gather(b, axis=1), mesh.gather(c)
        num_rounds -= sharded
    if num_rounds > 0 and _device_sumcheck_supported(transcript, device):
        rlc = TFr.encode_ints(coeffs, device)
        e_mont = TFr.encode_scalar(e, device)
        dt = DeviceTranscript.from_host(transcript, device)
        limbs = _prove_cubic_batched_device(e_mont, num_rounds, a, b, c, rlc,
                                            dt)
        del a, b, c
        vals = TFr.decode(dt.finish(transcript, limbs))
        polys, rs = _round_polys(vals, num_rounds, 4)
        claims = vals[num_rounds * 5:]
        return (SumcheckInstanceProof(compressed + polys), r_out + rs,
                (claims[:num_instances], claims[num_instances:-1],
                 claims[-1]))

    e, a, b, c = _cubic_host_rounds(e, a, b, c, coeffs, num_rounds,
                                    transcript, compressed, r_out)
    claims_a = TFr.decode(a[:, 0])
    claims_b = TFr.decode(b[:, 0])
    claim_c = TFr.decode(c[0][None])[0]
    return SumcheckInstanceProof(compressed), r_out, (claims_a, claims_b, claim_c)
