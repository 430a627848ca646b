"""Port curve ops (lasso_tpu_torch.curve.tcurve, K3's plain version and the
unfused curve path on K2's plain version) against the JAX package's curve
code and Pallas K3 kernel body, on the CPU.

Inputs are host scalar multiples of the basepoint plus their negations and
the identity, so every case of the complete addition law is covered:
P+Q, P+P, P+identity and P+(-P).  Comparisons are exact: padd_plain runs the
same formula with canonical arithmetic as the reference, so even the
projective limbs agree; compressed bytes are compared as well.  The JAX
side runs in a fresh process with its compile cache off
(LASSO_TPU_XLA_CACHE=off), away from the cache parallel workers share.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.curve.host import GENERATOR, Point
from lasso_tpu_torch.interop import (generators_match, points_from_numpy,
                                     to_numpy)
from lasso_tpu_torch.ops import field_cuda

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


def test_host_conversion_and_group_helpers(tmp_path):
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

