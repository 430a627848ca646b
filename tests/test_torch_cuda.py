"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
version, the launch counts, and a golden proof proven on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels); without
one they skip.  Run them on the card, from the repository root, with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py imports JAX, which the port does not need.)
The `cuda` marker selects them; it is not registered in pytest.ini, which
stays as the JAX package has it, so pytest warns that it is unknown.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from lasso_tpu_torch.field.tfield import TFp, TFr
from lasso_tpu_torch.ops import field_cuda

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    field_cuda.build()
    return torch.device("cuda")


def _limbs(rng, n, field):
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.int64)
    limbs[:, 15] %= field.p_limbs[-1]
    return limbs.astype(np.int32)


@pytest.mark.parametrize("field", [TFr, TFp], ids=["Fr", "Fp"])
def test_mont_mul_kernel_matches_plain(dev, field):
    rng = np.random.default_rng(1)
    a = torch.as_tensor(_limbs(rng, 4099, field), device=dev)
    b = torch.as_tensor(_limbs(rng, 4099, field), device=dev)
    before = field_cuda.launch_counts["mont_mul"]
    assert torch.equal(field_cuda.mont_mul_cuda(a, b, field.name),
                       field_cuda.mont_mul_plain(a, b, field.name))
    # one operand broadcast (stride 0 in the kernel)
    assert torch.equal(field_cuda.mont_mul(a, b[7], field.name),
                       field_cuda.mont_mul_plain(a, b[7], field.name))
    assert field_cuda.launch_counts["mont_mul"] == before + 2


def test_padd_kernel_matches_plain(dev):
    from lasso_tpu_torch.curve import tcurve
    from lasso_tpu_torch.curve.host import GENERATOR, Point

    pts = [GENERATOR.mul(k) for k in range(1, 65)]
    pool = tcurve.from_host_points(
        pts + [p.neg() for p in pts] + [Point.identity()], dev)
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(rng.integers(0, 129, size=(2, 3 * 1000)), device=dev)
    p = pool[..., idx[0]].reshape(4, 16, 3, 1000).permute(2, 0, 1, 3).contiguous()
    q = pool[..., idx[1]].reshape(4, 16, 3, 1000).permute(2, 0, 1, 3).contiguous()
    before = field_cuda.launch_counts["padd"]
    assert torch.equal(field_cuda.padd_cuda(p, q), field_cuda.padd_plain(p, q))
    assert torch.equal(field_cuda.padd_cuda(p, p), field_cuda.padd_plain(p, p))
    assert field_cuda.launch_counts["padd"] == before + 2


def test_golden_and_4d_on_the_card(dev):
    import lasso_tpu_torch.subtables.bitwise  # noqa: F401
    from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
    from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                             SparsePolynomialEvaluationProof)
    from lasso_tpu_torch.subtables.base import get_strategy
    from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
    from lasso_tpu_torch.transcript.random_tape import RandomTape
    from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
    from lasso_tpu_torch.utils.serialize import (serialize_commitment,
                                                 serialize_proof)

    strategy = get_strategy("and", 4, 16)
    nz = gen_indices(16, 16, 4)
    r = gen_random_point(4)
    dense = DensifiedRepresentation(nz, 4, 4, device=dev)
    gens = SparsePolyCommitmentGens.new(b"gens_sparse_poly", 4, 16,
                                        strategy.num_memories, 4, device=dev)
    comm = dense.commit(gens)
    proof = SparsePolynomialEvaluationProof.prove(
        dense, r, gens, strategy, ProofTranscript(b"example"),
        RandomTape(b"proof"))
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "golden_proofs.json")) as f:
        golden = json.load(f)["and_4d"]
    pb, cb = serialize_proof(proof), serialize_commitment(comm)
    assert hashlib.sha256(pb).hexdigest() == golden["proof_sha256"]
    assert hashlib.sha256(cb).hexdigest() == golden["commitment_sha256"]
    proof.verify(comm, r, gens, ProofTranscript(b"example"))
