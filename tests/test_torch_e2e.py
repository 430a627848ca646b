"""End-to-end prove/verify of the port (lasso_tpu_torch) on the CPU.

The proof and commitment bytes of every golden instance (AND/OR/XOR, LT,
range check) must equal the JAX package's fixtures
(tests/fixtures/golden_proofs.json, read as data); verify accepts honest
proofs and rejects tampered ones.  A mid-size AND instance, whose Hyrax
commits take the device MSM path, must give the same bytes as when every
MSM is routed to the host Pippenger, and as on the unfused curve path.
"""

import hashlib
import json
import os

import pytest
import torch

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
import lasso_tpu_torch.subtables.lt  # noqa: F401
import lasso_tpu_torch.subtables.range_check  # noqa: F401
from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.ops import field_cuda, msm
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

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_proofs.json")


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
    pb, cb = serialize_proof(proof), serialize_commitment(commitment)
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
    "range_3d": ("range_check", 3, 256, 16, {"log_r": 40}),
}


def _check_golden(name):
    with open(FIXTURES) as f:
        golden = json.load(f)[name]
    proof, commitment, r, gens = _prove(*GOLDEN[name])
    assert _entry(proof, commitment) == golden
    proof.verify(commitment, r, gens, ProofTranscript(b"example"))


@pytest.mark.parametrize("name", ["and_4d", "or_4d", "xor_4d"])
def test_golden_proof_bytes_and_verify(name):
    _check_golden(name)


def test_lt_and_range_golden_proof_bytes_and_verify():
    """The LT and range-check goldens as one test item: the tier-1 suite
    keeps its item count (ROADMAP.md, ground rules)."""
    for name in ("lt_4d", "lt_4d_big_s", "range_3d"):
        _check_golden(name)


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


def test_device_msm_route_matches_host_route(monkeypatch):
    """AND, C=1, M=2^12, s=2^11: every Hyrax commit exceeds the host-routing
    threshold, so the default run commits through the device MSM (K3's
    plain version here).  Routing every MSM to the host Pippenger must give
    identical proof and commitment bytes, and so must the unfused curve
    configuration (LASSO_TPU_PALLAS_PADD=0: stacked limb-major products,
    K2's plain version here): every MSM result leaves the device as a
    canonical compressed point."""
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
    monkeypatch.setattr(msm, "MSM_HOST_MAX", 1 << 30)
    proof_h, commitment_h, _, _ = _prove("and", 1, 1 << 12, 1 << 11)
    assert _entry(proof_h, commitment_h) == via_device
