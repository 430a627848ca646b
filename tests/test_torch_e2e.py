"""End-to-end prove/verify of the port (lasso_tpu_torch) on the CPU.

The proof and commitment bytes of every golden instance (AND/OR/XOR, LT
at C = 4 and at C = 8, range check) must equal the JAX package's fixtures
(tests/fixtures/golden_proofs.json, read as data, and, for instances the
JAX package's own tests do not prove, tests/fixtures/torch_golden_proofs.json,
which LASSO_TPU_REGEN_PORT_GOLDEN=1 recomputes with the JAX package), with the host transcript
and with the device-resident one (LASSO_TPU_DEVICE_TRANSCRIPT=force, which
takes the device paths on the CPU); verify accepts honest proofs and
rejects tampered ones.  A mid-size AND instance, whose Hyrax commits take
the device MSM path, must give the same bytes as when every MSM is routed
to the host Pippenger, and as on the unfused curve path; the sumcheck and
grand-product provers' device-transcript paths must give the host paths'
proofs, challenges and final transcript state.  The multi-device prover
(prove(..., mesh=), parallel/), run as gloo ranks on the CPU, must give
the single-device bytes: every golden at D = 8 ranks, and the mid-size AND
C=2, M=64, s=1024 at D = 4.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
import lasso_tpu_torch.subtables.lt  # noqa: F401
import lasso_tpu_torch.subtables.range_check  # noqa: F401
from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.entry import Spec, agreed, dryrun_spec, prove_instances
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.ops import field_cuda, msm
from lasso_tpu_torch.parallel.launch import spawn
from lasso_tpu_torch.subprotocols.grand_product import (
    BatchedGrandProductArgument, BatchedGrandProductCircuit)
from lasso_tpu_torch.subprotocols.sumcheck import (prove_arbitrary,
                                                   prove_cubic_batched)
from lasso_tpu_torch.subtables.base import get_strategy
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.transcript.random_tape import RandomTape
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils.serialize import (serialize_commitment,
                                             serialize_proof)

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "golden_proofs.json")
# goldens of instances that the JAX package's own golden test
# (tests/test_golden_proofs.py, which owns FIXTURES) does not prove: their
# bytes come from the JAX package, proven in a fresh process by
# _jax_entries, and are pinned here; LASSO_TPU_REGEN_PORT_GOLDEN=1 proves
# them again and rewrites the file (lt_8d: about ten minutes on the CPU,
# most of it XLA compiling the degree-9 sumcheck round)
PORT_FIXTURES = os.path.join(ROOT, "tests", "fixtures",
                             "torch_golden_proofs.json")
PORT_GOLDEN = ("lt_8d",)


def _log2(n):
    return (n - 1).bit_length()


def _prove(strategy_name, c, m, s, options=None):
    strategy = get_strategy(strategy_name, c, m, **(options or {}))
    nz = gen_indices(s, m, c)
    r = gen_random_point(_log2(s))
    dense = DensifiedRepresentation(nz, _log2(m), c, device="cpu")
    gens = SparsePolyCommitmentGens.new(
        b"gens_sparse_poly", c, s, strategy.num_memories, _log2(m),
        device="cpu")
    commitment = dense.commit(gens)
    proof = SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    return proof, commitment, r, gens


def _entry(proof, commitment):
    return _bytes_entry(serialize_proof(proof), serialize_commitment(commitment))


def _bytes_entry(pb, cb):
    return {"proof_sha256": hashlib.sha256(pb).hexdigest(),
            "proof_len": len(pb),
            "commitment_sha256": hashlib.sha256(cb).hexdigest(),
            "commitment_len": len(cb)}


# (strategy, C, M, s, options) of every golden instance
GOLDEN = {
    "and_4d": ("and", 4, 16, 16, {}),
    "or_4d": ("or", 4, 16, 16, {}),
    "xor_4d": ("xor", 4, 16, 16, {}),
    "lt_4d": ("lt", 4, 16, 16, {}),
    "lt_4d_big_s": ("lt", 4, 16, 128, {}),
    # LT at jolt-lt-s16's own C = 8 (16 memories, a degree-9 primary
    # sumcheck), with 2-bit operand halves
    "lt_8d": ("lt", 8, 16, 64, {}),
    "range_3d": ("range_check", 3, 256, 16, {"log_r": 40}),
}


# The JAX package's prove of each instance in argv[1] ({name: (strategy, C,
# M, s, options)}), the same calls as tests/test_golden_proofs.py; prints
# each one's entry as JSON.
_JAX_PROVE = """
import hashlib, json, sys
import lasso_tpu.subtables.bitwise, lasso_tpu.subtables.lt
import lasso_tpu.subtables.range_check
from lasso_tpu.lasso.densified import DensifiedRepresentation
from lasso_tpu.lasso.surge import (SparsePolyCommitmentGens,
                                   SparsePolynomialEvaluationProof)
from lasso_tpu.subtables.base import get_strategy
from lasso_tpu.transcript.proof_transcript import ProofTranscript
from lasso_tpu.transcript.random_tape import RandomTape
from lasso_tpu.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu.utils.serialize import serialize_commitment, serialize_proof

def log2(n):
    return (n - 1).bit_length()

out = {}
for name, (st, c, m, s, opts) in json.loads(sys.argv[1]).items():
    strategy = get_strategy(st, c, m, **opts)
    nz = gen_indices(s, m, c)
    r = gen_random_point(log2(s))
    dense = DensifiedRepresentation(nz, log2(m), c)
    gens = SparsePolyCommitmentGens.new(
        b"gens_sparse_poly", c, s, strategy.num_memories, log2(m))
    cb = serialize_commitment(dense.commit(gens))
    pb = serialize_proof(SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof")))
    out[name] = {"proof_sha256": hashlib.sha256(pb).hexdigest(),
                 "proof_len": len(pb),
                 "commitment_sha256": hashlib.sha256(cb).hexdigest(),
                 "commitment_len": len(cb)}
print(json.dumps(out))
"""


def _jax_entries(names):
    """The JAX package's golden entries of `names`, proven on the CPU in a
    fresh process (compile cache off, XLA:CPU's LLVM optimizations off,
    which leaves integer results unchanged)."""
    env = dict(os.environ, LASSO_TPU_XLA_CACHE="off", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_PROVE,
         json.dumps({name: GOLDEN[name] for name in names})],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _goldens():
    """Every golden's entry: the JAX package's fixtures and the port's
    own, the latter proven again by the JAX package and rewritten first
    when LASSO_TPU_REGEN_PORT_GOLDEN=1."""
    if os.environ.get("LASSO_TPU_REGEN_PORT_GOLDEN") == "1":
        entries = _jax_entries(PORT_GOLDEN)
        with open(PORT_FIXTURES, "w") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
            f.write("\n")
    golden = {}
    for path in (FIXTURES, PORT_FIXTURES):
        with open(path) as f:
            golden.update(json.load(f))
    return golden


def _check_golden(name, golden, monkeypatch):
    """The golden's bytes and verify, on the host transcript and then on
    the device-resident one."""
    for route in ("0", "force"):
        monkeypatch.setenv("LASSO_TPU_DEVICE_TRANSCRIPT", route)
        proof, commitment, r, gens = _prove(*GOLDEN[name])
        assert _entry(proof, commitment) == golden, route
        proof.verify(commitment, r, gens, ProofTranscript(b"example"))


@pytest.mark.parametrize("name", ["and_4d", "or_4d", "xor_4d"])
def test_golden_proof_bytes_and_verify(name, monkeypatch):
    _check_golden(name, _goldens()[name], monkeypatch)


# ranks of each golden's sharded prove: D = 8 meets the reference's
# divisibility asserts for every golden (D | s, D | M, and D | r_size of
# every Hyrax matrix: r_size >= 8 for all of them)
SHARDED_D = 8


def test_lt_and_range_golden_proof_bytes_and_verify(monkeypatch):
    """The LT and range-check goldens, and every golden proven sharded, as
    one test item: the tier-1 suite keeps its item count (ROADMAP.md,
    ground rules).  The sharded proves run in one spawn of SHARDED_D gloo
    ranks on the CPU, with and_4d once more on the unfused curve path and
    the dry run's instance (entry.dryrun_multichip) beside them: each must
    have the golden's bytes on every rank, and the single-device verifier
    accepts it."""
    golden = _goldens()
    for name in ("lt_4d", "lt_4d_big_s", "lt_8d", "range_3d"):
        _check_golden(name, golden[name], monkeypatch)

    monkeypatch.delenv("LASSO_TPU_DEVICE_TRANSCRIPT")  # the ranks' default
    specs = [Spec(st, c, m, s, tuple(opts.items()))
             for st, c, m, s, opts in GOLDEN.values()]
    specs += [Spec("and", 4, 16, 16, fused=False), dryrun_spec(SHARDED_D)]
    results = agreed(spawn(prove_instances, SHARDED_D, "gloo", "cpu", specs))
    for name, res in zip(list(GOLDEN) + ["and_4d"], results):
        assert _bytes_entry(res["proof"], res["commitment"]) == golden[name], \
            name
    assert all(res["verified"] for res in results)


@pytest.fixture(scope="module")
def and_proof():
    return _prove("and", 4, 16, 16)


def test_tampered_claim_rejected(and_proof):
    proof, commitment, r, gens = and_proof
    saved = proof.primary_sumcheck.claimed_evaluation
    proof.primary_sumcheck.claimed_evaluation = (saved + 1) % (2**252)
    try:
        with pytest.raises((LassoError, AssertionError)):
            proof.verify(commitment, r, gens, ProofTranscript(b"example"))
    finally:
        proof.primary_sumcheck.claimed_evaluation = saved


def test_wrong_eq_point_rejected(and_proof):
    proof, commitment, r, gens = and_proof
    r_bad = list(r)
    r_bad[0] = (r_bad[0] + 1) % (2**252)
    with pytest.raises((LassoError, AssertionError)):
        proof.verify(commitment, r_bad, gens, ProofTranscript(b"example"))


def test_tampered_deref_eval_rejected(and_proof):
    proof, commitment, r, gens = and_proof
    evals = proof.memory_check.proof_hash_layer.eval_derefs
    saved = list(evals)
    evals[0] = (evals[0] + 1) % (2**252)
    try:
        with pytest.raises((LassoError, AssertionError)):
            proof.verify(commitment, r, gens, ProofTranscript(b"example"))
    finally:
        evals[:] = saved


def _sumcheck_runs(route, monkeypatch):
    """prove_arbitrary (AND, C=2, M=16, 5 rounds), prove_cubic_batched and
    BatchedGrandProductArgument.prove on [2, 256] leaves, each entered
    after a scalar append (away from the post-challenge position), each
    followed by a challenge that pins the final transcript state."""
    monkeypatch.setenv("LASSO_TPU_DEVICE_TRANSCRIPT", route)
    rng = np.random.default_rng(7)
    strategy = get_strategy("and", 2, 16)
    zs = TFr.encode_u64_array(rng.integers(
        1, 1 << 30, size=(strategy.num_memories + 1, 32)).astype(np.uint64),
        "cpu")
    tr = ProofTranscript(b"sumcheck-parity")
    tr.append_scalar(b"claim", 0x1234)
    proof, r, finals, _ = prove_arbitrary(
        zs, strategy.comb_eq_device(), strategy.sumcheck_poly_degree(), 5, tr)
    out = [[p.coeffs_except_linear_term for p in proof.compressed_polys], r,
           finals, tr.challenge_scalar(b"post")]

    a, b = (TFr.encode_u64_array(rng.integers(
        1, 1 << 30, size=(3, 16)).astype(np.uint64), "cpu") for _ in "ab")
    c = TFr.encode_u64_array(rng.integers(1, 1 << 30, size=16).astype(
        np.uint64), "cpu")
    tr = ProofTranscript(b"cubic-parity")
    tr.append_scalar(b"claim", 0x9876)
    proof, r, claims = prove_cubic_batched(0x5555, 4, a, b, c, [3, 5, 7], tr)
    out += [[p.coeffs_except_linear_term for p in proof.compressed_polys], r,
            claims, tr.challenge_scalar(b"post")]

    leaves = TFr.encode_u64_array(np.random.default_rng(3).integers(
        1, 1 << 30, size=(2, 256)).astype(np.uint64), "cpu")
    tr = ProofTranscript(b"gp")
    tr.append_scalar(b"claim", 0xABC)
    arg, rand = BatchedGrandProductArgument.prove(
        BatchedGrandProductCircuit(leaves), tr)
    out += [[(ly.claims_prod_left, ly.claims_prod_right,
              [p.coeffs_except_linear_term for p in ly.proof.compressed_polys])
             for ly in arg.proof], rand, tr.challenge_scalar(b"post")]
    return out, arg, leaves


def test_device_msm_route_matches_host_route(monkeypatch):
    """AND, C=1, M=2^12, s=2^11: every Hyrax commit exceeds the host-routing
    threshold, so the default run commits through the device MSM (K3's
    plain version here).  Routing every MSM to the host Pippenger must give
    identical proof and commitment bytes, and so must the unfused curve
    configuration (LASSO_TPU_PALLAS_PADD=0: stacked limb-major products,
    K2's plain version here): every MSM result leaves the device as a
    canonical compressed point.  So must the multi-device prover, as 4
    gloo ranks, on AND C=2, M=64, s=1024.  Likewise the device-transcript route of
    the sumcheck and grand-product provers gives the host route's proofs,
    challenges and final transcript state, and the host verifier accepts
    its grand-product argument."""
    host_out, _, _ = _sumcheck_runs("0", monkeypatch)
    device_out, arg, leaves = _sumcheck_runs("force", monkeypatch)
    assert device_out == host_out
    tr = ProofTranscript(b"gp")
    tr.append_scalar(b"claim", 0xABC)
    _, rand = arg.verify(BatchedGrandProductCircuit(leaves).evaluate(), 256,
                         tr)
    assert rand == host_out[-2]
    monkeypatch.delenv("LASSO_TPU_DEVICE_TRANSCRIPT")

    proof, commitment, r, gens = _prove("and", 1, 1 << 12, 1 << 11)
    via_device = _entry(proof, commitment)
    proof.verify(commitment, r, gens, ProofTranscript(b"example"))
    tcurve.set_fused_padd(False)
    try:
        before = dict(field_cuda.launch_counts)
        proof_u, commitment_u, _, _ = _prove("and", 1, 1 << 12, 1 << 11)
        assert field_cuda.launch_counts == before  # plain versions on the CPU
    finally:
        tcurve.set_fused_padd(None)
    assert _entry(proof_u, commitment_u) == via_device

    # AND, C=2, M=64, s=1024 proven as 4 gloo ranks: multi-round sharded
    # sumchecks, multi-layer sharded product trees and non-degenerate
    # sharded L-folds give the single-device bytes
    proof, commitment, _, _ = _prove("and", 2, 64, 1024)
    sharded = agreed(spawn(prove_instances, 4, "gloo", "cpu",
                           [Spec("and", 2, 64, 1024)]))[0]
    assert _bytes_entry(sharded["proof"], sharded["commitment"]) == \
        _entry(proof, commitment)
    assert sharded["verified"]

    monkeypatch.setattr(msm, "MSM_HOST_MAX", 1 << 30)
    proof_h, commitment_h, _, _ = _prove("and", 1, 1 << 12, 1 << 11)
    assert _entry(proof_h, commitment_h) == via_device
