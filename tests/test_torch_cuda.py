"""The port's CUDA kernels on a card: each kernel against its plain PyTorch
version, the launch counts, and a golden proof proven on the card on both
transcript routes.

These tests need an NVIDIA GPU with nvcc (they build the kernels); without
one they skip.  Run them on the card, from the repository root, with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py imports JAX, which the port does not need.)
The `cuda` marker, registered in pytest.ini, selects them.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from lasso_tpu_torch.field import tfield
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


def _edge_limbs(rng, n, field):
    """_limbs with the edge values 0, 1 (Montgomery one) and p-1 in its
    first rows, so that a pair of them meets each edge value with each."""
    limbs = _limbs(rng, n, field).astype(np.int64)
    p_minus_1 = np.asarray(field.p_limbs, dtype=np.int64)
    p_minus_1[0] -= 1
    edges = [np.zeros(16, np.int64), np.asarray(field.mont_one, np.int64),
             p_minus_1]
    for i in range(min(n, 9)):
        limbs[i] = edges[i % 3] if i < 3 else edges[i // 3 - 1]
    return limbs.astype(np.int32)


def _check_mont_mul_ragged(dev, field):
    """K1 at ragged n (a partial tile, a few tiles and a ragged tail, a
    persistent grid that strides), with the broadcast constant on either
    side and the edge values 0, 1 and p-1; an operand that is not 16-byte
    aligned is refused by the kernel's wrapper and copied by the
    dispatcher."""
    rng = np.random.default_rng(5)
    for n in (1, 7, 257, (1 << 20) - 3):
        a = torch.as_tensor(_edge_limbs(rng, n, field), device=dev)
        b = torch.as_tensor(_edge_limbs(rng, n, field), device=dev)
        if n >= 9:  # rows 3..8 pair every edge value with every other
            b[3:9] = b[[0, 1, 2, 0, 1, 2]]
        assert torch.equal(field_cuda.mont_mul_cuda(a, b, field.name),
                           field_cuda.mont_mul_plain(a, b, field.name)), n
        for row in range(min(n, 3)):
            const = b[row]
            want = field_cuda.mont_mul_plain(a, const, field.name)
            assert torch.equal(field_cuda.mont_mul_cuda(a, const, field.name),
                               want), (n, row)
            assert torch.equal(field_cuda.mont_mul_cuda(const, a, field.name),
                               want), (n, row)
    n = 300
    buf = torch.zeros(32 * n + 8, dtype=torch.int32, device=dev)
    odd = buf[1:1 + 16 * n].view(n, 16)                # 4 B in: not aligned
    skew = buf[16 * n + 4:32 * n + 4].view(n, 16)      # 16 B in: aligned
    odd.copy_(torch.as_tensor(_limbs(rng, n, field), device=dev))
    skew.copy_(torch.as_tensor(_limbs(rng, n, field), device=dev))
    assert skew.data_ptr() % 16 == 0 and odd.data_ptr() % 16 == 4
    with pytest.raises(ValueError):
        field_cuda.mont_mul_cuda(odd, skew, field.name)
    assert torch.equal(field_cuda.mont_mul(odd, skew, field.name),
                       field_cuda.mont_mul_plain(odd, skew, field.name))


def _check_mont_mul_kernels(dev, field):
    """K1 (element-major) and K2 (limb-major) against their plain versions."""
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

    # K2 on [K, 16, n] limb-major operands with a ragged n, against a
    # broadcast [16, 1] constant, and through the dispatcher's broadcast of
    # leading axes
    rng = np.random.default_rng(3)
    k, n = 3, 1000
    a = torch.as_tensor(_limbs(rng, k * n, field), device=dev)
    b = torch.as_tensor(_limbs(rng, k * n, field), device=dev)
    a = a.reshape(k, n, 16).transpose(1, 2).contiguous()
    b = b.reshape(k, n, 16).transpose(1, 2).contiguous()
    const = b[1, :, 7:8].contiguous()
    before = field_cuda.launch_counts["mont_mul_lm"]
    assert torch.equal(field_cuda.mont_mul_lm_cuda(a, b, field.name),
                       field_cuda.mont_mul_lm_plain(a, b, field.name))
    assert torch.equal(field_cuda.mont_mul_lm_cuda(a, const, field.name),
                       field_cuda.mont_mul_lm_plain(a, const, field.name))
    assert torch.equal(field.mul_lm(a[None], b[:1]),
                       field_cuda.mont_mul_lm_plain(a[None], b[:1], field.name))
    assert field_cuda.launch_counts["mont_mul_lm"] == before + 3
    _check_mont_mul_lm_shapes(dev, field)


def _check_mont_mul_lm_shapes(dev, field):
    """K2 limb for limb against its plain version at the grid's edges: n = 1,
    K = 1, ragged n that are not a multiple of the block or of the columns
    per thread, one column or a pair per thread (an operand only 4-byte
    aligned keeps one), the edge values 0, 1 and p-1 against each other and
    the [16, 1] constant on either side; then the dispatcher's views of
    contiguous stacked operands."""
    rng = np.random.default_rng(6)

    def limb_major(k, n, lo=None):
        x = torch.as_tensor(_edge_limbs(rng, k * n, field), device=dev)
        x = x.reshape(k, n, 16).transpose(1, 2)
        if lo is None:
            return x.contiguous()
        lo.copy_(x.contiguous().reshape(-1))
        return lo.view(k, 16, n)

    for k, n in ((1, 1), (4, 1), (1, 32), (1, 33), (4, 512), (3, 1001),
                 (1, 4097), (3, (1 << 16) + 2), (2, (1 << 16) + 1)):
        a, b = limb_major(k, n), limb_major(k, n)
        if k * n >= 9:  # the edge values of a against every one of b's
            flat = b.transpose(1, 2).reshape(-1, 16)
            flat[3:9] = flat[[0, 1, 2, 0, 1, 2]].clone()
            b = flat.reshape(k, n, 16).transpose(1, 2).contiguous()
        want = field_cuda.mont_mul_lm_plain(a, b, field.name)
        assert torch.equal(field_cuda.mont_mul_lm_cuda(a, b, field.name),
                           want), (k, n)
        for col in range(min(k * n, 3)):  # 0, 1 and p-1 as the constant
            const = a[col // n, :, col % n:col % n + 1].contiguous()
            want = field_cuda.mont_mul_lm_plain(b, const, field.name)
            assert torch.equal(
                field_cuda.mont_mul_lm_cuda(b, const, field.name), want), \
                (k, n, col)
            assert torch.equal(
                field_cuda.mont_mul_lm_cuda(const, b, field.name), want), \
                (k, n, col)
    # operands 4 bytes past an 8-byte boundary: one column per thread
    k, n = 3, (1 << 16) + 2
    buf = torch.zeros(3 * k * 16 * n + 2, dtype=torch.int32, device=dev)
    a = limb_major(k, n, buf[1:1 + k * 16 * n])
    b = limb_major(k, n, buf[2 + k * 16 * n:2 + 2 * k * 16 * n])
    assert a.data_ptr() % 8 == 4 and b.data_ptr() % 8 == 0
    assert torch.equal(field_cuda.mont_mul_lm_cuda(a, b, field.name),
                       field_cuda.mont_mul_lm_plain(a, b, field.name))
    assert torch.equal(field_cuda.mont_mul_lm_cuda(b, a, field.name),
                       field_cuda.mont_mul_lm_plain(b, a, field.name))
    # the dispatcher: stacked [4, 2, 16, n] operands go to K2 as views
    a, b = limb_major(8, 300).view(4, 2, 16, 300), limb_major(8, 300)
    b = b.view(4, 2, 16, 300)
    before = field_cuda.launch_counts["mont_mul_lm"]
    assert torch.equal(field.mul_lm(a, b),
                       field_cuda.mont_mul_lm_plain(a, b, field.name))
    assert field_cuda.launch_counts["mont_mul_lm"] == before + 1


def _check_padd_kernel(dev):
    """K3 against its plain version (ragged n, P+Q, P+P, P+identity and
    P+(-P)), and the unfused path against K3."""
    from lasso_tpu_torch.curve import tcurve
    from lasso_tpu_torch.curve.host import GENERATOR, Point

    pts = [GENERATOR.mul(k) for k in range(1, 65)]
    pool = tcurve.from_host_points(
        pts + [p.neg() for p in pts] + [Point.identity()], dev)
    rng = np.random.default_rng(2)

    def batch(i, k, n):
        return pool[..., i].reshape(4, 16, k, n).permute(2, 0, 1, 3).contiguous()

    before = field_cuda.launch_counts["padd"]
    for k, n in ((3, 1000), (3, 1), (3, 129)):
        i = rng.integers(0, 64, size=k * n)
        j = rng.integers(0, 129, size=k * n)
        kind = np.arange(k * n) % 4
        j = np.where(kind == 1, i, j)        # P + P
        j = np.where(kind == 2, 128, j)      # P + identity
        j = np.where(kind == 3, i + 64, j)   # P + (-P)
        p = batch(torch.as_tensor(i, device=dev), k, n)
        q = batch(torch.as_tensor(j, device=dev), k, n)
        assert torch.equal(field_cuda.padd_cuda(p, q),
                           field_cuda.padd_plain(p, q)), (k, n)
        assert torch.equal(field_cuda.padd_cuda(p, p),
                           field_cuda.padd_plain(p, p)), (k, n)
    assert field_cuda.launch_counts["padd"] == before + 6

    # the unfused curve path (K2) against the fused add (K3): identical
    # limbs for padd, identical compressed bytes for pdbl, and each path
    # launches only its own kernel
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(0, 129, size=(2, 2 * 700)), device=dev)
    p = pool[..., idx[0]].reshape(4, 16, 2, 700).permute(2, 0, 1, 3).contiguous()
    q = pool[..., idx[1]].reshape(4, 16, 2, 700).permute(2, 0, 1, 3).contiguous()
    try:
        tcurve.set_fused_padd(False)
        field_cuda.reset_launch_counts()
        add_u, dbl_u = tcurve.padd(p, q), tcurve.pdbl(p)
        unfused_counts = dict(field_cuda.launch_counts)
        tcurve.set_fused_padd(True)
        field_cuda.reset_launch_counts()
        add_f, dbl_f = tcurve.padd(p, q), tcurve.pdbl(p)
        fused_counts = dict(field_cuda.launch_counts)
    finally:
        tcurve.set_fused_padd(None)
    assert unfused_counts["mont_mul_lm"] == 6 and unfused_counts["padd"] == 0
    assert fused_counts["padd"] == 2 and fused_counts["mont_mul_lm"] == 0
    assert torch.equal(add_u, add_f)
    for k in range(2):
        assert torch.equal(tcurve.compress_points_device(dbl_u[k]),
                           tcurve.compress_points_device(dbl_f[k]))


def _check_keccak_kernel(dev):
    """K4 against its plain version on 1,000 random states and the
    all-zero state, in one launch and one state at a time, and against the
    host keccak; a CPU tensor is refused by the wrapper."""
    from lasso_tpu_torch.transcript.device_strobe import (keccak_f1600_plain,
                                                          keccak_f1600_state)
    from lasso_tpu_torch.utils import keccak as host_keccak

    states = np.random.default_rng(13).integers(0, 256, size=(1001, 200))
    states[0] = 0
    x = torch.as_tensor(states.astype(np.int32), device=dev)
    want = keccak_f1600_plain(x)
    before = field_cuda.launch_counts["keccak"]
    got = field_cuda.keccak_cuda(x.clone())
    assert field_cuda.launch_counts["keccak"] == before + 1
    assert torch.equal(got, want)
    for i in (0, 1, 1000):
        one = x[i].clone()
        assert keccak_f1600_state(one) is one  # in place on the card
        assert torch.equal(one, want[i])
        ref = bytearray(states[i].astype(np.uint8).tobytes())
        host_keccak.keccak_f1600(ref)
        assert bytes(one.cpu().numpy().astype(np.uint8)) == bytes(ref)
    with pytest.raises(ValueError):
        field_cuda.keccak_cuda(x.cpu())


def _check_golden_and_4d(dev):
    """The golden and_4d proof, proven on the card (with the device
    transcript, the default there, and with the host one)."""
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
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "golden_proofs.json")) as f:
        golden = json.load(f)["and_4d"]
    old = os.environ.pop("LASSO_TPU_DEVICE_TRANSCRIPT", None)
    try:
        for route in ("1", "0"):
            os.environ["LASSO_TPU_DEVICE_TRANSCRIPT"] = route
            before = field_cuda.launch_counts["keccak"]
            proof = SparsePolynomialEvaluationProof.prove(
                dense, r, gens, strategy, ProofTranscript(b"example"),
                RandomTape(b"proof"))
            launched = field_cuda.launch_counts["keccak"] - before
            assert (launched > 0) == (route == "1"), (route, launched)
            pb, cb = serialize_proof(proof), serialize_commitment(comm)
            assert hashlib.sha256(pb).hexdigest() == golden["proof_sha256"]
            assert hashlib.sha256(cb).hexdigest() == \
                golden["commitment_sha256"]
            proof.verify(comm, r, gens, ProofTranscript(b"example"))
    finally:
        os.environ.pop("LASSO_TPU_DEVICE_TRANSCRIPT")
        if old is not None:
            os.environ["LASSO_TPU_DEVICE_TRANSCRIPT"] = old


def _check_field_arith_kernel(dev, field):
    """K5 against its plain versions, exactly, at the main path's shapes:
    add/sub on the halves of [2, 2^16, 16] and of [16, 2^16, 16] (read in
    place), a broadcast [16] element on either side, odd n and n = 1, with
    the edge values 0, 1 and p-1; column sums of [2^15, 16] and of the
    transposed [2^15, 16, 16] products limb for limb, their finish; one
    launch a call, and the finish launches no K1."""
    rng = np.random.default_rng(7)
    name = field.name
    counts = field_cuda.launch_counts

    c = field.consts("cpu")

    def cpu_plain(a, b, sub):
        return (tfield._sub_plain if sub else tfield._add_plain)(
            a.cpu(), b.cpu(), c)

    for rows in (2, 16):
        st = torch.as_tensor(_edge_limbs(rng, rows * (1 << 16), field),
                             device=dev).reshape(rows, 1 << 16, 16)
        lo, hi = st[:, :1 << 15], st[:, 1 << 15:]
        for sub in (False, True):
            before = dict(counts)
            got = (field.sub if sub else field.add)(hi, lo)
            assert counts["field_addsub"] == before["field_addsub"] + 1
            assert got.is_contiguous() and got.shape == lo.shape
            assert torch.equal(got.cpu(), cpu_plain(hi, lo, sub)), (rows, sub)
            assert torch.equal(field_cuda.add_sub_cuda(lo, hi, sub, name).cpu(),
                               cpu_plain(lo, hi, sub)), (rows, sub)
    for n in (1, 7, (1 << 15) + 3, 257):
        a = torch.as_tensor(_edge_limbs(rng, n, field), device=dev)
        b = torch.as_tensor(_edge_limbs(rng, n, field), device=dev)
        if n >= 9:  # rows 3..8 pair every edge value with every other
            b[3:9] = b[[0, 1, 2, 0, 1, 2]]
        for sub in (False, True):
            for x, y in ((a, b), (a, b[min(2, n - 1)]), (b[0], a)):
                before = counts["field_addsub"]
                got = field_cuda.add_sub(x, y, sub, name)
                assert counts["field_addsub"] == before + 1
                assert torch.equal(got.cpu(), cpu_plain(x, y, sub)), (n, sub)
        assert torch.equal(field.neg(a).cpu(),
                           cpu_plain(torch.zeros_like(a), a, True))

    prods = torch.as_tensor(_edge_limbs(rng, 16 * (1 << 15), field),
                            device=dev).reshape(16, 1 << 15, 16)
    for x in (prods[0], prods.movedim(1, 0), prods[:, :1].movedim(1, 0),
              prods[:3, :(1 << 15) - 5].movedim(1, 0), prods[0, :1],
              field.mul(prods[:2], prods[2:4]).movedim(1, 0)):
        before = dict(counts)
        cols = field.sum_columns(x)
        assert counts["field_sum"] == before["field_sum"] + 1
        assert torch.equal(cols.cpu(), tfield._sum_columns_plain(x.cpu())), \
            tuple(x.shape)
        got = field.finish_sum(cols)
        assert counts["field_sum"] == before["field_sum"] + 2
        assert counts["mont_mul"] == before["mont_mul"]
        assert torch.equal(got.cpu(),
                           tfield._finish_sum_plain(field, cols.cpu()))
        if x.shape[0] <= 64:  # the values, against the host
            sets = x.reshape(x.shape[0], -1, 16).cpu()
            assert field.decode(got) == [
                sum(field.decode(sets[:, j])) % field.host.p
                for j in range(sets.shape[1])]


def test_kernels_and_golden_proof_on_the_card(dev):
    """Every check of this module as one test item: the tier-1 suite, which
    collects this file on the CPU too, keeps its item count (ROADMAP.md,
    ground rules)."""
    for field in (TFr, TFp):
        _check_mont_mul_kernels(dev, field)
        _check_mont_mul_ragged(dev, field)
        _check_field_arith_kernel(dev, field)
    _check_padd_kernel(dev)
    _check_keccak_kernel(dev)
    _check_golden_and_4d(dev)
