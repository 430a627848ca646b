"""Port MSM (lasso_tpu_torch.ops.msm) on the CPU, through K3's plain
version, against the host Pippenger oracle and the JAX package's window
policy (its values written out as constants).

Sizes are above the host-routing thresholds (n > 256 points; rows*n > 1024
scalars for the row-batched MSM), so the device pipeline runs: digit
extraction, sort, blocked segmented bucket sums, blocked weighted sums and
the Horner combine.  Results are compared as canonical points (compressed
bytes), never as projective limbs: the order of curve additions differs
between implementations.  JAX-side computations run in a fresh process
with the compile cache off, away from the cache parallel workers share.
The provers' mesh-aware pieces (prove(..., mesh=), parallel/), run as 8
gloo ranks on the CPU, are held against their single-device counterparts
exactly, at the shapes of the JAX package's own sharded tests.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.curve.host import GENERATOR, Point, msm_host
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.ops import msm
from lasso_tpu_torch.parallel.checks import primitives_rank, product_comb
from lasso_tpu_torch.parallel.launch import spawn
from lasso_tpu_torch.poly.dense import DensePolynomial, eq_evals_host
from lasso_tpu_torch.poly.hyrax import PolyCommitmentGens, commit_poly
from lasso_tpu_torch.subprotocols.grand_product import (
    BatchedGrandProductArgument, BatchedGrandProductCircuit)
from lasso_tpu_torch.subprotocols.sumcheck import (_bind_top, _round_evals,
                                                   prove_arbitrary)
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript

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


def _points(n):
    pts = [GENERATOR]
    step = GENERATOR.mul(7)
    for _ in range(n - 1):
        pts.append(pts[-1].add(step))
    return pts


def _scalars(n, bits, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % Fr.p
            for _ in range(n)]
    vals[:3] = [0, 1, Fr.p - 1 if bits > 252 else (1 << bits) - 1]
    return vals


def _compressed(pt):
    return pt.to_compressed_bytes()


@pytest.mark.parametrize("n,bits", [(300, 16), (260, 253)])
def test_msm_device_matches_host(n, bits):
    pts = _points(n)
    sc = _scalars(n, bits, seed=n)
    before = dict(field_cuda.launch_counts)
    got = msm.msm_device(tcurve.from_host_points(pts, "cpu"),
                         TFr.encode_ints(sc, "cpu"))
    assert field_cuda.launch_counts == before  # plain version on the CPU
    assert _compressed(tcurve.to_host_point(got)) == _compressed(msm_host(pts, sc))


def test_msm_device_routes_small_inputs_to_host():
    pts = _points(40)
    sc = _scalars(40, 253, seed=4)
    got = msm.msm_device(tcurve.from_host_points(pts, "cpu"),
                         TFr.encode_ints(sc, "cpu"))
    assert tcurve.to_host_point(got) == msm_host(pts, sc)


@pytest.mark.parametrize("col_max", [msm.MSM_BATCH_COL_MAX, 128])
def test_msm_batch_device_matches_host(monkeypatch, col_max):
    """Row-batched MSM (the Hyrax commit shape) on the device path, and with
    the column cap forcing the chunked path."""
    monkeypatch.setattr(msm, "MSM_BATCH_COL_MAX", col_max)
    rows, n = 4, 300
    pts = _points(n)
    sc = [_scalars(n, 20, seed=100 + i) for i in range(rows)]
    got = msm.msm_batch_device(
        tcurve.from_host_points(pts, "cpu"),
        TFr.encode_ints([x for row in sc for x in row], "cpu").reshape(
            rows, n, 16))
    assert got.shape == (rows, 4, 16, 1)
    got_host = tcurve.to_host_points(got.movedim(0, -1))
    assert [_compressed(p) for p in got_host] == \
        [_compressed(msm_host(pts, row)) for row in sc]


# (c, num_windows) that the JAX package's ops/msm.py:window_plan gives for
# (n, max_bits), written out so that this file need not import lasso_tpu
JAX_WINDOW_PLANS = {(1, 10): (3, 4), (300, 16): (6, 3), (4096, 253): (10, 26),
                    (1 << 20, 40): (14, 3)}


@pytest.mark.parametrize("n,max_bits", list(JAX_WINDOW_PLANS))
def test_window_plan_matches_jax(n, max_bits):
    assert msm.window_plan(n, max_bits) == JAX_WINDOW_PLANS[(n, max_bits)]


def test_extract_digits_matches_jax(tmp_path):
    sc = _scalars(50, 253, seed=9)
    ints_t = TFr.to_int_limbs(TFr.encode_ints(sc, "cpu"))
    c, k = msm.window_plan(50, 253)
    got = msm._extract_digits(ints_t, c, k)
    ref = jax_reference("""
from lasso_tpu.ops import msm as jmsm
out["d"] = np.asarray(jmsm._extract_digits(
    inp["ints"], int(inp["c"]), int(inp["k"])))
""", tmp_path, ints=ints_t.numpy().astype(np.uint32), c=np.array(c),
        k=np.array(k))
    np.testing.assert_array_equal(got.numpy(), ref["d"])


def test_bucket_reductions_match_host():
    """Blocked segmented sums and blocked weighted sums (both above their
    block thresholds) against direct host sums; the segmented scan alone,
    stopping early and at all of its strides (the flat MSM's sync-free
    form on a card), likewise."""
    rng = np.random.default_rng(5)
    n, num_buckets = 300, 200
    pts = _points(n)
    ids = np.sort(rng.integers(0, num_buckets + 1, size=n))
    dev_pts = tcurve.from_host_points(pts, "cpu")
    buckets = msm._segmented_sum_blocked(
        dev_pts, torch.as_tensor(ids), num_buckets)[..., :num_buckets]
    want = [Point.identity() for _ in range(num_buckets)]
    for p, b in zip(pts, ids):
        if b < num_buckets:
            want[b] = want[b].add(p)
    got = tcurve.to_host_points(buckets)
    assert [_compressed(p) for p in got] == [_compressed(p) for p in want]
    for fixed in (False, True):
        scanned = msm._segmented_sum_sorted(
            dev_pts, torch.as_tensor(ids), num_buckets, fixed)
        assert [_compressed(p) for p in tcurve.to_host_points(
            scanned[..., :num_buckets])] == [_compressed(p) for p in want]

    weighted = msm._bucket_weighted_sum_blocked(buckets)
    total = msm_host(want, list(range(1, num_buckets + 1)))
    assert _compressed(tcurve.to_host_point(weighted)) == _compressed(total)

    _check_sharded_primitives()


def _check_sharded_primitives():
    """The provers' mesh-aware pieces as 8 gloo ranks against the
    single-device functions on the same inputs: round evals and bind, the
    eq table, prove_arbitrary (n = 64, alpha = 3, 6 rounds: three sharded
    rounds and a three-round replicated tail), the grand-product argument
    over a sharded circuit (leaves [3, 64]: three sharded layers, then the
    top circuit) and a Hyrax commitment of 2^6 full-width scalars (one
    matrix column per rank)."""
    rng = np.random.default_rng(21)

    def field(*shape):
        vals = [int.from_bytes(rng.bytes(32), "little") % Fr.p
                for _ in range(int(np.prod(shape)))]
        return TFr.encode_ints(vals, "cpu").reshape(shape + (16,))

    inputs = {"zs": field(2, 64), "r": field(1)[0],
              "eq_r": [int(v) for v in rng.integers(1, 1 << 62, size=6)],
              "sc_zs": field(3, 64), "leaves": field(3, 64),
              "commit_z": field(64)}
    got = spawn(primitives_rank, 8, "gloo", "cpu",
                {k: v.numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in inputs.items()})
    assert all(g == got[0] for g in got[1:])  # replicated on every rank
    got = got[0]

    def dec(t):
        return TFr.decode(t.reshape(-1, 16))

    zs = inputs["zs"]
    assert got["round_evals"] == dec(_round_evals(zs, product_comb, 2))
    assert got["bound"] == dec(_bind_top(zs, inputs["r"]))
    assert got["eq"] == eq_evals_host(inputs["eq_r"])
    proof, r, finals, _ = prove_arbitrary(
        inputs["sc_zs"], product_comb, 3, 6, ProofTranscript(b"dist"))
    assert got["sumcheck"] == (
        [p.coeffs_except_linear_term for p in proof.compressed_polys], r,
        finals)
    gp, gp_rand = BatchedGrandProductArgument.prove(
        BatchedGrandProductCircuit(inputs["leaves"]), ProofTranscript(b"dist"))
    assert got["grand_product"] == (
        [([p.coeffs_except_linear_term for p in layer.proof.compressed_polys],
          layer.claims_prod_left, layer.claims_prod_right)
         for layer in gp.proof], gp_rand)
    comm, _ = commit_poly(DensePolynomial(inputs["commit_z"]),
                          PolyCommitmentGens.new(6, b"dist"))
    assert got["commitment"] == [_compressed(p) for p in comm.C]
