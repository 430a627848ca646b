"""The port's ZK pieces, proof deserialization and subprotocol round trips
(ports of tests/test_zk_serialize.py and tests/test_subprotocols.py;
reference: zk.rs:310-400, sumcheck.rs:331-448, the CanonicalSerialize
derives and the inline tests of src/subprotocols/*.rs), on the CPU.

The Sigma protocols round-trip and their proofs equal the JAX package's
for the same inputs; the log-size dot-product proof gives the same proof
with the transcript on the device as on the host; the ZK sumcheck verifier accepts an honest proof and
rejects a tampered one; a golden proof survives serialize -> deserialize
-> verify -> serialize byte for byte; the sumcheck, grand-product,
dot-product and Hyrax proofs round-trip and their bytes equal the JAX
package's.  All comparisons are exact.  The JAX side runs in one fresh
process with its compile cache off.
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.interop import to_numpy
from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.poly.commitments import MultiCommitGens, commit_scalar
from lasso_tpu_torch.poly.dense import (DensePolynomial, eq_evals_device,
                                        eq_evals_host, eq_evaluate_host)
from lasso_tpu_torch.poly.hyrax import (PolyCommitmentGens, PolyEvalProof,
                                        commit_poly)
from lasso_tpu_torch.poly.unipoly import UniPoly
from lasso_tpu_torch.subprotocols.dot_product import (DotProductProof,
                                                      DotProductProofGens,
                                                      DotProductProofLog,
                                                      batch_commit)
from lasso_tpu_torch.subprotocols.grand_product import (
    BatchedGrandProductArgument, BatchedGrandProductCircuit)
from lasso_tpu_torch.subprotocols.sumcheck import (ZKSumcheckInstanceProof,
                                                   prove_arbitrary)
from lasso_tpu_torch.subprotocols.zk import (EqualityProof, KnowledgeProof,
                                             ProductProof)
from lasso_tpu_torch.subtables.base import get_strategy
from lasso_tpu_torch.transcript.proof_transcript import (ProofTranscript,
                                                         TestTranscript)
from lasso_tpu_torch.transcript.random_tape import RandomTape
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils.serialize import (Writer, _w_batched_gp,
                                             _w_dot_log, _w_poly_commitment,
                                             _w_poly_eval, _w_sumcheck,
                                             deserialize_commitment,
                                             deserialize_proof,
                                             serialize_commitment,
                                             serialize_proof)

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "golden_proofs.json")


def jax_reference(script, tmp_path, **inputs):
    """Run `script` against the JAX package in a fresh process (compile
    cache off, XLA:CPU's LLVM optimizations off: that halves the compile
    work of the unrolled limb kernels and leaves their integer results
    unchanged) and return the arrays it puts in `out`; `inp` holds
    `inputs` there."""
    src, dst = tmp_path / "jax_in.npz", tmp_path / "jax_out.npz"
    np.savez(src, **inputs)
    code = ("import sys\nimport numpy as np\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"inp = dict(np.load({str(src)!r}))\nout = {{}}\n"
            + textwrap.dedent(script)
            + f"\nnp.savez({str(dst)!r}, **out)\n")
    env = dict(os.environ, LASSO_TPU_XLA_CACHE="off", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _gens1():
    return MultiCommitGens.new(1, b"test-zk")


def _zk_inputs():
    """(x, r) for the knowledge proof, (v, s1, s2) for the equality proof,
    (x, y, rx, ry, rz) for the product proof."""
    rng = random.Random(7)
    k = [rng.randrange(Fr.p) for _ in range(2)]
    e = [rng.randrange(Fr.p) for _ in range(3)]
    p = [rng.randrange(Fr.p) for _ in range(5)]
    return k, e, p


def _port_zk_proofs():
    gens = _gens1()
    (x, r), (v, s1, s2), (px, py, rx, ry, rz) = _zk_inputs()
    kp, kc = KnowledgeProof.prove(gens, ProofTranscript(b"zk"),
                                  RandomTape(b"proof"), x, r)
    ep, c1, c2 = EqualityProof.prove(gens, ProofTranscript(b"zk"),
                                     RandomTape(b"proof"), v, s1, v, s2)
    pp, cx, cy, cz = ProductProof.prove(
        gens, ProofTranscript(b"zk"), RandomTape(b"proof"), px, rx, py, ry,
        px * py % Fr.p, rz)
    return gens, (kp, kc), (ep, c1, c2), (pp, cx, cy, cz)


def _check_knowledge_proof_roundtrip():
    gens, (proof, c), _, _ = _port_zk_proofs()
    proof.verify(gens, ProofTranscript(b"zk"), c)
    with pytest.raises(LassoError):
        proof.verify(gens, ProofTranscript(b"zk"), c.mul(2))


def _check_equality_proof_roundtrip():
    gens, _, (proof, c1, c2), _ = _port_zk_proofs()
    proof.verify(gens, ProofTranscript(b"zk"), c1, c2)
    with pytest.raises(LassoError):
        proof.verify(gens, ProofTranscript(b"zk"), c2, c1)


def _check_product_proof_roundtrip():
    gens, _, _, (proof, cx, cy, cz) = _port_zk_proofs()
    proof.verify(gens, ProofTranscript(b"zk"), cx, cy, cz)
    with pytest.raises(LassoError):
        proof.verify(gens, ProofTranscript(b"zk"), cx, cz, cy)


def _jax_refs(tmp_path):
    """Every JAX-side result of this module, from one JAX process: the
    Sigma proofs (_zk_inputs) and the subprotocols (_subprotocol_inputs)."""
    k, e, p = _zk_inputs()
    return jax_reference(_JAX_ZK + _JAX_SUBPROTOCOLS, tmp_path,
                         k=np.array([str(v) for v in k]),
                         e=np.array([str(v) for v in e]),
                         p=np.array([str(v) for v in p]),
                         **_subprotocol_inputs())


_JAX_ZK = """
from lasso_tpu.field.host import Fr
from lasso_tpu.poly.commitments import MultiCommitGens
from lasso_tpu.subprotocols.zk import EqualityProof, KnowledgeProof, ProductProof
from lasso_tpu.transcript.proof_transcript import ProofTranscript
from lasso_tpu.transcript.random_tape import RandomTape
ints = lambda key: [int(v) for v in inp[key]]
gens = MultiCommitGens.new(1, b"test-zk")
(x, r), (v, s1, s2), (px, py, rx, ry, rz) = ints("k"), ints("e"), ints("p")
kp, kc = KnowledgeProof.prove(gens, ProofTranscript(b"zk"), RandomTape(b"proof"), x, r)
ep, c1, c2 = EqualityProof.prove(gens, ProofTranscript(b"zk"), RandomTape(b"proof"), v, s1, v, s2)
pp, cx, cy, cz = ProductProof.prove(gens, ProofTranscript(b"zk"), RandomTape(b"proof"),
                                    px, rx, py, ry, px * py % Fr.p, rz)
pts = [kp.alpha, kc, ep.alpha, c1, c2, pp.alpha, pp.beta, pp.delta, cx, cy, cz]
out["points"] = np.frombuffer(b"".join(q.to_compressed_bytes() for q in pts), np.uint8)
out["scalars"] = np.array([str(s) for s in [kp.z1, kp.z2, ep.z] + pp.z])
"""


def _check_zk_proofs_match_jax(ref):
    """Each Sigma proof and its commitments equal the JAX package's for the
    same inputs: compressed points and scalars, byte for byte."""
    _, (kp, kc), (ep, c1, c2), (pp, cx, cy, cz) = _port_zk_proofs()
    pts = [kp.alpha, kc, ep.alpha, c1, c2, pp.alpha, pp.beta, pp.delta, cx, cy,
           cz]
    assert b"".join(q.to_compressed_bytes() for q in pts) == \
        ref["points"].tobytes()
    assert [kp.z1, kp.z2, ep.z] + pp.z == [int(s) for s in ref["scalars"]]


# The subprotocols in the JAX package, proven on _subprotocol_inputs();
# each proof as its serialized bytes (utils/serialize.py's writers).
_JAX_SUBPROTOCOLS = """
import jax.numpy as jnp
from lasso_tpu.field.jfield import JFr
from lasso_tpu.poly.dense import DensePolynomial, eq_evals_device
from lasso_tpu.poly.hyrax import PolyCommitmentGens, PolyEvalProof, commit_poly
from lasso_tpu.subprotocols.dot_product import (DotProductProof,
                                                DotProductProofGens,
                                                DotProductProofLog)
from lasso_tpu.subprotocols.grand_product import (BatchedGrandProductArgument,
                                                  BatchedGrandProductCircuit)
from lasso_tpu.subprotocols.sumcheck import prove_arbitrary
from lasso_tpu.transcript.proof_transcript import TestTranscript
from lasso_tpu.utils import serialize as S


def written(fn, *objs):
    w = S.Writer()
    for obj in objs:
        fn(w, obj)
    return np.frombuffer(w.getvalue(), np.uint8)


def strs(vals):
    return np.array([str(v) for v in vals])


def sumcheck(a, b, rounds, transcript):
    stack = jnp.stack([JFr.encode_ints(a), JFr.encode_ints(b)])
    proof, r, evals, _ = prove_arbitrary(
        stack, lambda zs: JFr.mul(zs[0], zs[1]), 2, rounds, transcript)
    return written(S._w_sumcheck, proof), strs(list(r) + list(evals))


out["sc"], out["sc_r"] = sumcheck(ints("sc_a"), ints("sc_b"), 4,
                                  ProofTranscript(b"test"))
out["pin"], out["pin_r"] = sumcheck(ints("pin_a"), ints("pin_b"), 3,
                                    TestTranscript(scalars=ints("pin_r")))
circuits = BatchedGrandProductCircuit(jnp.stack(
    [JFr.encode_ints([int(v) for v in row]) for row in inp["gp"]]))
roots = circuits.evaluate()
arg, rand = BatchedGrandProductArgument.prove(circuits, ProofTranscript(b"test"))
out["gp"], out["gp_vals"] = written(S._w_batched_gp, arg), strs(roots + rand)
x, a = ints("dp_x"), ints("dp_a")
y = sum(u * v for u, v in zip(x, a)) % Fr.p
gens = DotProductProofGens.new(len(x), b"test-dot")
proof, cx, cy = DotProductProof.prove(gens.gens_1, gens.gens_n, ProofTranscript(b"dot"),
                                      RandomTape(b"proof"), x, 3, a, y, 5)
out["dp"] = np.frombuffer(b"".join(q.to_compressed_bytes() for q in
                                   [proof.delta, proof.beta, cx, cy]), np.uint8)
out["dp_vals"] = strs(proof.z + [proof.z_delta, proof.z_beta])
x, a = ints("dpl_x"), ints("dpl_a")
y = sum(u * v for u, v in zip(x, a)) % Fr.p
gens = DotProductProofGens.new(len(x), b"test-dotlog")
proof, cx, cy = DotProductProofLog.prove(
    gens, ProofTranscript(b"dotlog"), RandomTape(b"proof"), JFr.encode_ints(x), 7,
    JFr.encode_ints(a), y, 9)
out["dpl"] = written(S._w_dot_log, proof)
out["dpl_c"] = np.frombuffer(cx.to_compressed_bytes() + cy.to_compressed_bytes(),
                             np.uint8)
poly = DensePolynomial.from_ints(ints("hx_z"))
gens = PolyCommitmentGens.new(poly.num_vars, b"test-hyrax")
comm, _ = commit_poly(poly, gens)
r = ints("hx_r")
zr = poly.evaluate(r)
proof, c_zr = PolyEvalProof.prove(poly, None, r, zr, None, gens,
                                  ProofTranscript(b"hyrax"), RandomTape(b"proof"))
proof2, _ = PolyEvalProof.prove(poly, None, r, zr, None, gens,
                                ProofTranscript(b"hyrax2"), RandomTape(b"proof"))
out["hx_comm"] = written(S._w_poly_commitment, comm)
out["hx"] = written(S._w_poly_eval, proof, proof2)
out["hx_c"] = np.frombuffer(c_zr.to_compressed_bytes(), np.uint8)
out["hx_zr"] = np.array(str(zr))
out["eq"] = np.asarray(eq_evals_device([JFr.encode_scalar(v) for v in ints("eq_r")]))
"""


def _subprotocol_inputs():
    """numpy-seeded scalars for the subprotocol round trips (the sizes of
    the reference's tests/test_subprotocols.py)."""
    rng = np.random.default_rng(17)

    def scalars(*shape):
        n = int(np.prod(shape))
        vals = [int.from_bytes(rng.bytes(32), "little") % Fr.p
                for _ in range(n)]
        return np.array([str(v) for v in vals]).reshape(shape)

    return {"sc_a": scalars(16), "sc_b": scalars(16), "pin_a": scalars(8),
            "pin_b": scalars(8), "pin_r": scalars(3), "gp": scalars(4, 8),
            "dp_x": scalars(8), "dp_a": scalars(8), "dpl_x": scalars(16),
            "dpl_a": scalars(16), "hx_z": scalars(64), "hx_r": scalars(6),
            "eq_r": scalars(5), "eq_rx": scalars(5)}


def _written(fn, *objs):
    w = Writer()
    for obj in objs:
        fn(w, obj)
    return w.getvalue()


def _check_subprotocols_match_jax(ref):
    """The prove <-> verify round trips of the reference's
    tests/test_subprotocols.py on the port, each proof byte for byte equal
    to the JAX package's for the same inputs."""
    inp = _subprotocol_inputs()
    ints = lambda key: [int(v) for v in inp[key]]  # noqa: E731
    p = Fr.p

    def mul2(zs):
        return TFr.mul(zs[0], zs[1])

    # the quadratic sumcheck (test_sumcheck_roundtrip_quadratic)
    a, b = ints("sc_a"), ints("sc_b")
    claim = sum(x * y for x, y in zip(a, b)) % p
    stack = torch.stack([TFr.encode_ints(a, "cpu"), TFr.encode_ints(b, "cpu")])
    proof, r, evals, _ = prove_arbitrary(stack, mul2, 2, 4,
                                         ProofTranscript(b"test"))
    assert _written(_w_sumcheck, proof) == ref["sc"].tobytes()
    assert r + evals == [int(v) for v in ref["sc_r"]]
    e, r_v = proof.verify(claim, 4, 2, ProofTranscript(b"test"))
    assert r_v == r and e == evals[0] * evals[1] % p
    assert evals[0] == DensePolynomial.from_ints(a, "cpu").evaluate(r)
    assert evals[1] == DensePolynomial.from_ints(b, "cpu").evaluate(r)

    # the pinned challenge point (test_sumcheck_pinned_point)
    a, b, r_pin = ints("pin_a"), ints("pin_b"), ints("pin_r")
    claim = sum(x * y for x, y in zip(a, b)) % p
    stack = torch.stack([TFr.encode_ints(a, "cpu"), TFr.encode_ints(b, "cpu")])
    proof, r, evals, _ = prove_arbitrary(stack, mul2, 2, 3,
                                         TestTranscript(scalars=r_pin))
    assert r == r_pin
    assert _written(_w_sumcheck, proof) == ref["pin"].tobytes()
    assert r + evals == [int(v) for v in ref["pin_r"]]
    e, _ = proof.verify(claim, 3, 2, TestTranscript(scalars=r_pin))
    assert e == evals[0] * evals[1] % p

    # the batched grand product (test_grand_product_roundtrip)
    vals = [[int(v) for v in row] for row in inp["gp"]]
    circuits = BatchedGrandProductCircuit(
        torch.stack([TFr.encode_ints(v, "cpu") for v in vals]))
    roots = circuits.evaluate()
    for row, root in zip(vals, roots):
        want = 1
        for x in row:
            want = want * x % p
        assert root == want
    arg, rand = BatchedGrandProductArgument.prove(circuits,
                                                  ProofTranscript(b"test"))
    assert _written(_w_batched_gp, arg) == ref["gp"].tobytes()
    assert roots + rand == [int(v) for v in ref["gp_vals"]]
    claims, rand_v = arg.verify(roots, 8, ProofTranscript(b"test"))
    assert rand_v == rand
    for row, c in zip(vals, claims):
        assert c == DensePolynomial.from_ints(row, "cpu").evaluate(rand)

    # the linear-size dot-product proof (test_dot_product_proof_roundtrip)
    x, a = ints("dp_x"), ints("dp_a")
    y = sum(u * v for u, v in zip(x, a)) % p
    gens = DotProductProofGens.new(len(x), b"test-dot")
    proof, cx, cy = DotProductProof.prove(
        gens.gens_1, gens.gens_n, ProofTranscript(b"dot"), RandomTape(b"proof"),
        x, 3, a, y, 5, "cpu")
    assert b"".join(q.to_compressed_bytes() for q in
                    [proof.delta, proof.beta, cx, cy]) == ref["dp"].tobytes()
    assert proof.z + [proof.z_delta, proof.z_beta] == \
        [int(v) for v in ref["dp_vals"]]
    proof.verify(gens.gens_1, gens.gens_n, ProofTranscript(b"dot"), a, cx, cy,
                 "cpu")
    with pytest.raises(LassoError):
        proof.verify(gens.gens_1, gens.gens_n, ProofTranscript(b"dot"),
                     a[:-1] + [(a[-1] + 1) % p], cx, cy, "cpu")

    # the log-size dot-product proof (test_dot_product_log_roundtrip)
    x, a = ints("dpl_x"), ints("dpl_a")
    y = sum(u * v for u, v in zip(x, a)) % p
    gens = DotProductProofGens.new(len(x), b"test-dotlog")
    proof, cx, cy = DotProductProofLog.prove(
        gens, ProofTranscript(b"dotlog"), RandomTape(b"proof"),
        TFr.encode_ints(x, "cpu"), 7, TFr.encode_ints(a, "cpu"), y, 9)
    assert _written(_w_dot_log, proof) == ref["dpl"].tobytes()
    assert cx.to_compressed_bytes() + cy.to_compressed_bytes() == \
        ref["dpl_c"].tobytes()
    proof.verify(len(x), gens, ProofTranscript(b"dotlog"), a, cx, cy, "cpu")

    # the Hyrax commitment and opening (test_hyrax_commit_open_roundtrip)
    poly = DensePolynomial.from_ints(ints("hx_z"), "cpu")
    gens = PolyCommitmentGens.new(poly.num_vars, b"test-hyrax")
    comm, _ = commit_poly(poly, gens)
    r = ints("hx_r")
    zr = poly.evaluate(r)
    assert zr == int(ref["hx_zr"])
    proof, c_zr = PolyEvalProof.prove(poly, None, r, zr, None, gens,
                                      ProofTranscript(b"hyrax"),
                                      RandomTape(b"proof"))
    proof.verify(gens, ProofTranscript(b"hyrax"), r, c_zr, comm, "cpu")
    proof2, _ = PolyEvalProof.prove(poly, None, r, zr, None, gens,
                                    ProofTranscript(b"hyrax2"),
                                    RandomTape(b"proof"))
    proof2.verify_plain(gens, ProofTranscript(b"hyrax2"), r, zr, comm, "cpu")
    assert _written(_w_poly_commitment, comm) == ref["hx_comm"].tobytes()
    assert _written(_w_poly_eval, proof, proof2) == ref["hx"].tobytes()
    assert c_zr.to_compressed_bytes() == ref["hx_c"].tobytes()

    # interpolation and compression (test_unipoly_interpolation_roundtrip,
    # the reference's pinned coefficients; unipoly.rs:128-189)
    coeffs = [5, 7, 11, 13]
    uni = UniPoly(coeffs)
    assert UniPoly.from_evals([uni.evaluate(i) for i in range(4)]).coeffs == coeffs
    hint = (uni.eval_at_zero() + uni.eval_at_one()) % p
    assert uni.compress().decompress(hint).coeffs == coeffs

    # the eq table against its factored halves, on the host and the device
    # (test_eq_factored_cross_check; dense_mlpoly.rs:528-583)
    r = ints("eq_r")
    full = eq_evals_host(r)
    left, right = eq_evals_host(r[:2]), eq_evals_host(r[2:])
    assert full == [li * rj % p for li in left for rj in right]
    dev = eq_evals_device([TFr.encode_scalar(v, "cpu") for v in r], "cpu")
    np.testing.assert_array_equal(to_numpy(dev), ref["eq"])
    assert TFr.decode(dev) == full
    rx = ints("eq_rx")
    want = 1
    for u, v in zip(r, rx):
        want = want * ((u * v + (1 - u) * (1 - v)) % p) % p
    assert eq_evaluate_host(r, rx) == want


def _zk_sumcheck(num_rounds, degree, claim, blind_claim, gens, transcript,
                 tape):
    """An honest ZK sumcheck proof (the prover the reference leaves out):
    round polynomial i has random coefficients c_1..c_d and c_0 chosen so
    that p_i(0) + p_i(1) equals the round's claim; each round commits p_i,
    commits p_i(r_i), and proves the combined dot product."""
    rng = random.Random(11)
    comm_polys, comm_evals, proofs = [], [], []
    comm_claim = commit_scalar(claim, blind_claim, gens.gens_1)
    comm_round, round_claim, round_blind = comm_claim, claim, blind_claim
    for _ in range(num_rounds):
        tail = [rng.randrange(Fr.p) for _ in range(degree)]
        coeffs = [(round_claim - sum(tail)) * pow(2, -1, Fr.p) % Fr.p] + tail
        blind_poly = tape.random_scalar(b"blind_poly")
        comm_poly = batch_commit(TFr.encode_ints(coeffs, "cpu"), blind_poly,
                                 gens.gens_n)
        transcript.append_point(b"comm_poly", comm_poly)
        r_i = transcript.challenge_scalar(b"challenge_nextround")
        ev = sum(c * pow(r_i, j, Fr.p) for j, c in enumerate(coeffs)) % Fr.p
        blind_eval = tape.random_scalar(b"blind_eval")
        comm_eval = commit_scalar(ev, blind_eval, gens.gens_1)
        transcript.append_point(b"comm_claim_per_round", comm_round)
        transcript.append_point(b"comm_eval", comm_eval)
        w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
        a = [(w[0] * (2 if j == 0 else 1) + w[1] * pow(r_i, j, Fr.p)) % Fr.p
             for j in range(degree + 1)]
        target = (w[0] * round_claim + w[1] * ev) % Fr.p
        blind_target = (w[0] * round_blind + w[1] * blind_eval) % Fr.p
        proof, _, _ = DotProductProof.prove(
            gens.gens_1, gens.gens_n, transcript, tape, coeffs, blind_poly, a,
            target, blind_target, "cpu")
        comm_polys.append(comm_poly)
        comm_evals.append(comm_eval)
        proofs.append(proof)
        comm_round, round_claim, round_blind = comm_eval, ev, blind_eval
    return ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs), comm_claim


def _check_zk_sumcheck_verify():
    num_rounds, degree = 3, 3
    gens = DotProductProofGens.new(degree + 1, b"test-zk-sumcheck")
    proof, comm_claim = _zk_sumcheck(num_rounds, degree, 1234, 5678, gens,
                                     ProofTranscript(b"zk-sumcheck"),
                                     RandomTape(b"proof"))
    comm_last, r = proof.verify(comm_claim, num_rounds, degree, gens.gens_1,
                                gens.gens_n, ProofTranscript(b"zk-sumcheck"),
                                device="cpu")
    assert comm_last == proof.comm_evals[-1] and len(r) == num_rounds
    with pytest.raises(LassoError):  # wrong claim commitment
        proof.verify(comm_claim.mul(2), num_rounds, degree, gens.gens_1,
                     gens.gens_n, ProofTranscript(b"zk-sumcheck"), device="cpu")
    proof.comm_evals[0] = proof.comm_evals[0].mul(3)
    with pytest.raises(LassoError):  # tampered round evaluation
        proof.verify(comm_claim, num_rounds, degree, gens.gens_1, gens.gens_n,
                     ProofTranscript(b"zk-sumcheck"), device="cpu")
    with pytest.raises(LassoError):  # generators of the wrong size
        proof.verify(comm_claim, num_rounds, degree + 1, gens.gens_1,
                     gens.gens_n, ProofTranscript(b"zk-sumcheck"), device="cpu")


def _check_proof_serialization_roundtrip():
    """The golden and_4d proof: serialize -> deserialize -> the proof still
    verifies, re-serializes to identical bytes, and corruption is caught."""
    strategy = get_strategy("and", 4, 16)
    nz, r = gen_indices(16, 16, 4), gen_random_point(4)
    dense = DensifiedRepresentation(nz, 4, 4, device="cpu")
    gens = SparsePolyCommitmentGens.new(b"gens_sparse_poly", 4, 16,
                                        strategy.num_memories, 4, device="cpu")
    commitment = dense.commit(gens)
    proof = SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    blob, comm_blob = serialize_proof(proof), serialize_commitment(commitment)
    with open(FIXTURES) as f:
        golden = json.load(f)["and_4d"]
    assert hashlib.sha256(blob).hexdigest() == golden["proof_sha256"]
    assert hashlib.sha256(comm_blob).hexdigest() == golden["commitment_sha256"]

    proof2 = deserialize_proof(blob, strategy)
    commitment2 = deserialize_commitment(comm_blob)
    proof2.verify(commitment2, r, gens, ProofTranscript(b"example"))
    assert serialize_proof(proof2) == blob
    assert serialize_commitment(commitment2) == comm_blob

    bad = bytearray(blob)
    bad[5] ^= 0xFF
    with pytest.raises(Exception):
        p3 = deserialize_proof(bytes(bad), strategy)
        p3.verify(commitment2, r, gens, ProofTranscript(b"example"))


def _dppl_run(route, monkeypatch, gens, x, a, y):
    monkeypatch.setenv("LASSO_TPU_DEVICE_TRANSCRIPT", route)
    tr = ProofTranscript(b"dppl-parity")
    tr.append_scalar(b"claim", 0xABCDEF)  # away from the post-challenge spot
    proof, cx, cy = DotProductProofLog.prove(
        gens, tr, RandomTape(b"proof"), TFr.encode_ints(x, "cpu"), 7,
        TFr.encode_ints(a, "cpu"), y, 9)
    bullet = proof.bullet_reduction_proof
    pts = bullet.L_vec + bullet.R_vec + [proof.delta, proof.beta, cx, cy]
    return ([p.to_compressed_bytes() for p in pts], proof.z1, proof.z2,
            tr.challenge_scalar(b"post")), (proof, cx, cy)


def _check_dppl_device_matches_host(monkeypatch):
    """DotProductProofLog at N=8 on the device-transcript route (the fused
    program of subprotocols/bullet._device_dppl) against the host route:
    every proof point and scalar and the final transcript state; the host
    verifier accepts the fused proof."""
    n = 8
    x = [(0x9E3779B9 * (i + 1)) % Fr.p for i in range(n)]
    a = [(0x61C88647 * (i + 3)) % Fr.p for i in range(n)]
    y = sum(p * q for p, q in zip(x, a)) % Fr.p
    gens = DotProductProofGens.new(n, b"test-dppl-fused")
    host, _ = _dppl_run("0", monkeypatch, gens, x, a, y)
    device, (proof, cx, cy) = _dppl_run("force", monkeypatch, gens, x, a, y)
    assert device == host
    monkeypatch.delenv("LASSO_TPU_DEVICE_TRANSCRIPT")
    tr = ProofTranscript(b"dppl-parity")
    tr.append_scalar(b"claim", 0xABCDEF)
    proof.verify(n, gens, tr, a, cx, cy, "cpu")


def test_zk_pieces_and_serialization(tmp_path, monkeypatch):
    """Every check of this module as one test item: the tier-1 suite keeps
    its item count (ROADMAP.md, ground rules)."""
    _check_dppl_device_matches_host(monkeypatch)
    _check_knowledge_proof_roundtrip()
    _check_equality_proof_roundtrip()
    _check_product_proof_roundtrip()
    ref = _jax_refs(tmp_path)
    _check_zk_proofs_match_jax(ref)
    _check_subprotocols_match_jax(ref)
    _check_zk_sumcheck_verify()
    _check_proof_serialization_roundtrip()
