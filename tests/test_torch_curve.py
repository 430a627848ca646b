"""Port curve ops (lasso_tpu_torch.curve.tcurve, K3's plain version and the
unfused curve path on K2's plain version) against the JAX package's curve
code and Pallas K3 kernel body, on the CPU; and the port's host layer (the
native core, keccak, ChaCha, merlin, the host curve and the utilities)
against its host oracles and pinned vectors.

Inputs are host scalar multiples of the basepoint plus their negations and
the identity, so every case of the complete addition law is covered:
P+Q, P+P, P+identity and P+(-P).  Comparisons are exact: padd_plain runs the
same formula with canonical arithmetic as the reference, so even the
projective limbs agree; compressed bytes are compared as well.  The JAX
side runs in a fresh process with its compile cache off
(LASSO_TPU_XLA_CACHE=off), away from the cache parallel workers share.
"""

import hashlib
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lasso_tpu_torch import native
from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.curve.host import (GENERATOR, Point, msm_host,
                                        msm_host_naive, rand_point)
from lasso_tpu_torch.field import constants as K
from lasso_tpu_torch.field.host import Fp, Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.interop import (generators_match, points_from_numpy,
                                     to_numpy)
from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.ops import msm as msm_ops
from lasso_tpu_torch.poly.commitments import MultiCommitGens
from lasso_tpu_torch.transcript.merlin import Transcript
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.utils import chacha as host_chacha
from lasso_tpu_torch.utils import keccak as host_keccak
from lasso_tpu_torch.utils.chacha import ChaChaRng
from lasso_tpu_torch.utils.chacha import test_rng as ark_test_rng
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils.gaussian_elimination import gaussian_elimination
from lasso_tpu_torch.utils.math import (compute_dotproduct, get_bits,
                                        index_to_field_bitvector,
                                        is_power_of_two, log_2, pow_2,
                                        split_bits, square_root)

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _cases(n, seed):
    """(p_host, q_host): random pairs from a pool of multiples of G, with
    every fourth pair P+P, P+identity or P+(-P)."""
    pool = [GENERATOR.mul(k) for k in range(1, 33)]
    rng = np.random.default_rng(seed)
    p_host, q_host = [], []
    for i in range(n):
        p = pool[int(rng.integers(0, len(pool)))]
        kind = i % 4
        if kind == 0:
            q = pool[int(rng.integers(0, len(pool)))]
        elif kind == 1:
            q = p
        elif kind == 2:
            q = Point.identity()
        else:
            q = p.neg()
        p_host.append(p)
        q_host.append(q)
    return p_host, q_host


def _sums(p_host, q_host):
    p = tcurve.from_host_points(p_host, "cpu")
    q = tcurve.from_host_points(q_host, "cpu")
    return p, q, field_cuda.padd_plain(p, q)


def test_padd_plain_matches_jax_xla_path(tmp_path):
    """K3's plain version and the unfused formulas (_padd_unfused /
    _pdbl_unfused) against the reference's stacked-mul formulas (_padd_xla /
    _pdbl_xla), limb for limb, and against the host oracle."""
    p_host, q_host = _cases(64, 1)
    p, q, got = _sums(p_host, q_host)
    ref = jax_reference("""
from lasso_tpu.curve import jcurve
out["r"] = np.asarray(jcurve._padd_xla(inp["p"], inp["q"]))
out["dbl"] = np.asarray(jcurve._pdbl_xla(inp["p"]))
""", tmp_path, p=to_numpy(p), q=to_numpy(q))
    np.testing.assert_array_equal(to_numpy(got), ref["r"])
    assert tcurve.to_host_points(got) == [a.add(b) for a, b in zip(p_host, q_host)]
    np.testing.assert_array_equal(to_numpy(tcurve._padd_unfused(p, q)), ref["r"])
    dbl = tcurve._pdbl_unfused(p)
    np.testing.assert_array_equal(to_numpy(dbl), ref["dbl"])
    assert tcurve.to_host_points(dbl) == [a.double() for a in p_host]


def test_padd_plain_matches_pallas_kernel_body(tmp_path):
    """K3's plain version against the Pallas kernel's body (_padd_body) on
    one [4, 16, 8, 128] tile of 1024 points.  padd_pallas(interpret=True)
    itself cannot be traced by this JAX version (its body captures the
    curve constants), and jit of the unrolled body takes XLA:CPU many
    minutes, so the body runs eagerly, op by op."""
    p, q, got = _sums(*_cases(1024, 2))
    ref = jax_reference("""
import jax.numpy as jnp
from lasso_tpu.curve import jcurve
from lasso_tpu.field.jfield import JFp
from lasso_tpu.ops.field_pallas import _padd_body
tile = lambda x: jnp.asarray(x).reshape(4, 16, 8, 128)
r = _padd_body(tile(inp["p"]), tile(inp["q"]), JFp.p_limbs, JFp.n0inv,
               jcurve._A_TUPLE, jcurve._D_TUPLE)
out["r"] = np.asarray(r).reshape(4, 16, 1024)
""", tmp_path, p=to_numpy(p), q=to_numpy(q))
    np.testing.assert_array_equal(to_numpy(got), ref["r"])


def test_compressed_bytes_match_jax(tmp_path):
    p_host, q_host = _cases(32, 3)
    p, q, sums = _sums(p_host, q_host)
    ref = jax_reference("""
from lasso_tpu.curve import jcurve
xa, ya = jcurve.affine_int_limbs_device(jcurve._padd_xla(inp["p"], inp["q"]))
out["xa"], out["ya"] = np.asarray(xa), np.asarray(ya)
out["bytes"] = np.asarray(jcurve.compress_affine_bytes_device(xa, ya))
""", tmp_path, p=to_numpy(p), q=to_numpy(q))
    xa, ya = tcurve.affine_int_limbs_device(sums)
    np.testing.assert_array_equal(to_numpy(xa), ref["xa"])
    np.testing.assert_array_equal(to_numpy(ya), ref["ya"])
    got = tcurve.compress_affine_bytes_device(xa, ya)
    np.testing.assert_array_equal(to_numpy(got), ref["bytes"])
    np.testing.assert_array_equal(to_numpy(tcurve.compress_points_device(sums)),
                                  to_numpy(got))
    host = [a.add(b).to_compressed_bytes() for a, b in zip(p_host, q_host)]
    assert [bytes(r.astype(np.uint8)) for r in to_numpy(got)] == host


def _check_native_parity(monkeypatch):
    """The native host core (native/host_crypto.cpp through the port's
    ctypes binding) against the pure-Python oracles it stands in for:
    keccak-f[1600], ChaCha blocks, scalar multiplication, the host MSM and
    the Bullet fold (port of tests/test_native.py)."""
    assert native.available()
    st_native, st_py = bytearray(range(200)), bytearray(range(200))
    assert native.keccak_f1600(st_native)
    monkeypatch.setattr(host_keccak, "_NATIVE", False)
    host_keccak.keccak_f1600(st_py)
    assert st_native == st_py

    monkeypatch.setattr(host_chacha, "_NATIVE", False)
    key = [i * 0x01010101 for i in range(8)]
    for ctr in (0, 1, 2**33, 2**63):
        for rounds in (8, 12, 20):
            assert native.chacha_block(key, ctr, [7, 9], rounds) == \
                host_chacha.chacha_block(key, ctr, [7, 9], rounds)

    rng = random.Random(3)
    base = GENERATOR.mul(12345)
    for k in [0, 1, 2, Fr.p - 1, rng.randrange(Fr.p)]:
        acc, b, kk = Point.identity(), base, k  # double-and-add
        while kk:
            if kk & 1:
                acc = acc.add(b)
            b = b.double()
            kk >>= 1
        assert native.point_mul(base, k) == acc

    rng = random.Random(4)
    pts = [GENERATOR.mul(i + 1) for i in range(50)]
    scalars = [0, 1] + [rng.randrange(Fr.p) for _ in range(48)]
    assert native.msm(pts, scalars) == msm_host_naive(pts, scalars)

    rng = random.Random(5)
    g = [GENERATOR.mul(i + 3) for i in range(8)]
    u = rng.randrange(Fr.p)
    u_inv = Fr.inv(u)
    assert native.fold_points(g, u, u_inv) == [
        g[i].mul(u_inv).add(g[4 + i].mul(u)) for i in range(4)]


def _check_host_crypto_core():
    """keccak, ChaCha, merlin, the field and curve reference, point
    encodings, the fixtures and the Pedersen generators against hashlib,
    RFC 8439 and merlin's pinned vectors and the group law (port of
    tests/test_transcript.py)."""
    for msg in [b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 500]:
        assert host_keccak.sha3_256(msg) == hashlib.sha3_256(msg).digest()
    for msg in [b"", b"abc", b"q" * 300]:
        h = hashlib.shake_256()
        h.update(msg)
        assert host_keccak.shake256(msg, 64) == h.digest(64)

    # the zero-key, zero-nonce ChaCha20 keystream block 0
    words = host_chacha.chacha_block([0] * 8, 0, [0, 0], 20)
    assert b"".join(w.to_bytes(4, "little") for w in words) == bytes.fromhex(
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7"
        "da41597c5157488d7724e03fb8d84a376a43b8f41518a11cc387b669b2ee6586")
    # a u64 that straddles the 64-word buffer takes its low half first
    rng = ChaChaRng.chacha20(bytes(32))
    first = [rng.next_u32() for _ in range(63)]
    v = rng.next_u64()
    rng2 = ChaChaRng.chacha20(bytes(32))
    words = [rng2.next_u32() for _ in range(65)]
    assert first == words[:63]
    assert (v & 0xFFFFFFFF, v >> 32) == (words[63], words[64])

    # merlin's documented vector
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    t1, t2, t3 = (ProofTranscript(b"example") for _ in range(3))
    t1.append_scalar(b"x", 12345)
    t2.append_scalar(b"x", 12345)
    t3.append_scalar(b"x", 12346)
    c1 = t1.challenge_scalar(b"c")
    assert c1 == t2.challenge_scalar(b"c") != t3.challenge_scalar(b"c")

    # the curve: a square, d a non-square, G of prime order
    assert Fp.legendre(K.CURVE_A) == 1
    assert Fp.legendre(K.CURVE_D) == Fp.p - 1
    assert GENERATOR.is_on_curve()
    assert GENERATOR.mul(Fr.p).is_identity()
    assert not GENERATOR.mul(Fr.p // 2).is_identity()
    g2 = GENERATOR.add(GENERATOR)
    assert g2 == GENERATOR.double() and g2.is_on_curve()
    assert GENERATOR.add(Point.identity()) == GENERATOR
    assert GENERATOR.add(GENERATOR.neg()).is_identity()
    assert g2.add(GENERATOR) == GENERATOR.add(g2) == GENERATOR.mul(3)

    rng = ark_test_rng()
    for _ in range(8):
        pt = rand_point(rng)
        assert pt.is_on_curve()
        data = pt.to_compressed_bytes()
        assert len(data) == 32 and Point.from_compressed_bytes(data) == pt
    ident = Point.identity().to_compressed_bytes()
    assert Point.from_compressed_bytes(ident).is_identity()
    rng = ark_test_rng()
    vals = [Fr.rand(rng) for _ in range(16)]
    assert all(0 <= x < Fr.p for x in vals) and len(set(vals)) == 16

    a = gen_indices(8, 16, 4)
    assert a == gen_indices(8, 16, 4)
    assert all(len(row) == 4 and all(x < 16 for x in row) for row in a)
    assert gen_random_point(5) == gen_random_point(5)

    pts = [GENERATOR.mul(i + 1) for i in range(5)]
    scalars = [3, 0, 7, 1, 2]
    assert msm_host(pts, scalars) == GENERATOR.mul(
        sum((i + 1) * x for i, x in enumerate(scalars)))

    gens = MultiCommitGens.new(3, b"test-gens")
    assert len(gens.G) == 3 and gens.n == 3
    for g in gens.G + [gens.h]:
        assert g.is_on_curve() and g.mul(Fr.p).is_identity()
    again = MultiCommitGens.new(3, b"test-gens")
    assert gens.G == again.G and gens.h == again.h
    assert gens.G != MultiCommitGens.new(3, b"other").G


def _check_utils(monkeypatch):
    """The math utilities, Gaussian elimination on UniPoly's Vandermonde
    system and the chunked device MSM (port of tests/test_utils_parity.py;
    reference: math.rs, gaussian_elimination.rs, unipoly.rs:36-54)."""
    assert log_2(1024) == 10 and pow_2(10) == 1024
    assert square_root(256) == 16
    assert get_bits(0b1011, 4) == [True, False, True, True]
    assert index_to_field_bitvector(0b1011, 5) == [0, 1, 0, 1, 1]
    assert split_bits(0b110101, 3) == (0b110, 0b101)
    assert is_power_of_two(64) and not is_power_of_two(65)
    rng = random.Random(0)
    a = [rng.randrange(Fr.p) for _ in range(8)]
    b = [rng.randrange(Fr.p) for _ in range(8)]
    assert compute_dotproduct(a, b) == sum(x * y for x, y in zip(a, b)) % Fr.p

    rng = random.Random(1)
    coeffs = [rng.randrange(Fr.p) for _ in range(4)]

    def evaluate(x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % Fr.p
        return acc

    rows = [[pow(i, j, Fr.p) for j in range(4)] + [evaluate(i)]
            for i in range(4)]
    assert gaussian_elimination(rows) == coeffs
    with pytest.raises(ZeroDivisionError):
        gaussian_elimination([[1, 2, 3], [2, 4, 6]])

    rng = random.Random(3)
    pts_host = [GENERATOR.mul(i + 1) for i in range(24)]
    scalars = [rng.randrange(1 << 16) for _ in range(24)]
    monkeypatch.setattr(msm_ops, "MSM_CHUNK", 8)  # three chunks
    got = msm_ops.msm_chunks_device(tcurve.from_host_points(pts_host, "cpu"),
                                    TFr.encode_ints(scalars, "cpu"))
    assert tcurve.to_host_point(got) == msm_host(pts_host, scalars)


def test_host_conversion_and_group_helpers(tmp_path, monkeypatch):
    """The host <-> tensor point conversions and group helpers against the
    JAX package's; then the host-level checks of the reference's
    tests/test_native.py, test_transcript.py and test_utils_parity.py,
    held against the port's host oracles, hashlib and pinned vectors, as
    one test item: the tier-1 suite keeps its item count (ROADMAP.md,
    ground rules)."""
    ks = list(range(3, 10))
    ref = jax_reference("""
from lasso_tpu.curve import jcurve
from lasso_tpu.curve.host import GENERATOR
pts = jcurve.from_host_points([GENERATOR.mul(int(k)) for k in inp["ks"]])
out["pts"], out["neg"] = np.asarray(pts), np.asarray(jcurve.pneg(pts))
out["ident"] = np.asarray(jcurve.identity(3))
""", tmp_path, ks=np.array(ks))
    pts = [GENERATOR.mul(k) for k in ks]
    dev = tcurve.from_host_points(pts, "cpu")
    np.testing.assert_array_equal(to_numpy(dev), ref["pts"])
    assert tcurve.to_host_points(dev) == pts
    assert tcurve.to_host_points(points_from_numpy(ref["pts"], "cpu")) == pts
    total = Point.identity()
    for p in pts:
        total = total.add(p)
    assert tcurve.to_host_point(tcurve.tree_sum(dev)) == total
    assert tcurve.to_host_points(tcurve.pneg(dev)) == [p.neg() for p in pts]
    np.testing.assert_array_equal(to_numpy(tcurve.pneg(dev)), ref["neg"])
    assert tcurve.to_host_points(tcurve.pdbl(dev)) == [p.double() for p in pts]
    mask = torch.tensor([True, False] * 3 + [True])
    sel = tcurve.pselect(mask, dev, tcurve.identity(7))
    assert tcurve.to_host_points(sel) == [
        p if m else Point.identity() for p, m in zip(pts, mask.tolist())]
    np.testing.assert_array_equal(to_numpy(tcurve.identity(3)), ref["ident"])
    _check_native_parity(monkeypatch)
    _check_host_crypto_core()
    _check_utils(monkeypatch)


@pytest.mark.parametrize("n", [1, 64, 257])
def test_generators_match_jax(n, tmp_path):
    label = b"gens_sparse_poly"
    ref = jax_reference("""
from lasso_tpu.poly.commitments import MultiCommitGens
from lasso_tpu.subprotocols.dot_product import _gens_device
n = int(inp["n"])
out["g"] = np.asarray(_gens_device(MultiCommitGens.new(n, b"gens_sparse_poly")))
""", tmp_path, n=np.array(n))
    assert generators_match(n, label, ref["g"])


def _compressed(points):
    """Compressed bytes of each point of [4, 16, n] (ark serialization)."""
    return [pt.to_compressed_bytes() for pt in tcurve.to_host_points(points)]


def test_padd_dispatch_plain_on_cpu():
    """padd takes K3's plain version on the CPU (no launch).  With the fused
    add off, padd / pdbl / tree_sum route to the unfused formulas and give
    the fused path's group elements: equal compressed bytes (pdbl's
    projective limbs differ by design), again with no launch."""
    pts = tcurve.from_host_points([GENERATOR, GENERATOR.double()], "cpu")
    before = dict(field_cuda.launch_counts)
    out = tcurve.padd(pts, pts.flip(-1))
    assert field_cuda.launch_counts == before
    assert torch.equal(out, field_cuda.padd_plain(pts, pts.flip(-1)))
    with pytest.raises(ValueError):
        field_cuda.padd_cuda(pts[None].contiguous(), pts[None].contiguous())

    p_host, q_host = _cases(64, 5)
    p = tcurve.from_host_points(p_host, "cpu")
    q = tcurve.from_host_points(q_host, "cpu")
    tcurve.set_fused_padd(False)
    try:
        add, dbl = tcurve.padd(p, q), tcurve.pdbl(p)
        total = tcurve.tree_sum(p)
        assert field_cuda.launch_counts == before
        assert torch.equal(add, tcurve._padd_unfused(p, q))
        assert torch.equal(dbl, tcurve._pdbl_unfused(p))
        tcurve.set_fused_padd(True)
        fused_total = tcurve.tree_sum(p)
    finally:
        tcurve.set_fused_padd(None)
    fused_dbl = field_cuda.padd_plain(p, p)
    assert not torch.equal(dbl, fused_dbl)
    assert _compressed(add) == _compressed(field_cuda.padd_plain(p, q))
    assert _compressed(dbl) == _compressed(fused_dbl)
    assert _compressed(total) == _compressed(fused_total)

