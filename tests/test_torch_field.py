"""Port field arithmetic (lasso_tpu_torch.field.tfield, ops.field_cuda)
against the JAX package's JFr/JFp and its Pallas K1 and K2 kernels, on
the CPU.

All comparisons are exact, limb for limb: this is integer arithmetic.  The
same numpy-seeded inputs, including 0, 1 and p-1, go to both packages.  The
JAX side runs in a fresh process with its compile cache off
(LASSO_TPU_XLA_CACHE=off), so none of its compiles touch the compile cache
that parallel test workers share.  The CUDA kernels' shared header
(csrc/field256.cuh) is also built for the host with g++ and held against
the plain versions, so the arithmetic the card runs is checked here too.
"""

import ctypes
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lasso_tpu_torch.field import tfield
from lasso_tpu_torch.field.tfield import TFp, TFr
from lasso_tpu_torch.interop import (limb_major_from_numpy, limbs_from_numpy,
                                     to_numpy)
from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.transcript.device_strobe import (DeviceTranscript,
                                                      keccak_f1600_plain,
                                                      keccak_f1600_state)
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.utils import keccak as host_keccak

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"Fr": TFr, "Fp": TFp}
N = 64


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


_JFIELD = """
from lasso_tpu.field.jfield import JFp, JFr
jf = {"Fr": JFr, "Fp": JFp}[str(inp["field"])]
a = [int(x) for x in inp["a"]]
b = [int(x) for x in inp["b"]]
ja, jb = jf.encode_ints(a), jf.encode_ints(b)
out["a"], out["b"] = np.asarray(ja), np.asarray(jb)
"""


def _ints(field, n, seed):
    rng = np.random.default_rng(seed)
    p = field.host.p
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def _pair(name, seed=0):
    tf = FIELDS[name]
    a = _ints(tf, N, seed)
    b = _ints(tf, N, seed + 1)
    b[2] = tf.host.p - 1  # (p-1) op (p-1)
    return tf, a, b, tf.encode_ints(a, "cpu"), tf.encode_ints(b, "cpu")


def _strs(vals):
    return np.array([str(v) for v in vals])


def _eq(t, ref):
    np.testing.assert_array_equal(to_numpy(t), ref)


@pytest.mark.parametrize("name", ["Fr", "Fp"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name, op, tmp_path):
    tf, a, b, ta, tb = _pair(name)
    ref = jax_reference(_JFIELD + f"out['r'] = np.asarray(jf.{op}(ja, jb))\n",
                        tmp_path, field=name, a=_strs(a), b=_strs(b))
    _eq(ta, ref["a"])
    _eq(tb, ref["b"])
    _eq(getattr(tf, op)(ta, tb), ref["r"])


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_neg_and_limb_major_ops_match_jax(name, tmp_path):
    tf, a, b, ta, tb = _pair(name, seed=5)
    ref = jax_reference(_JFIELD + """
out["neg"] = np.asarray(jf.neg(ja))
ja_lm = ja.reshape(4, 16, 16).swapaxes(-1, -2)
jb_lm = jb.reshape(4, 16, 16).swapaxes(-1, -2)
out["add_lm"] = np.asarray(jf.add_lm(ja_lm, jb_lm))
out["sub_lm"] = np.asarray(jf.sub_lm(ja_lm, jb_lm))
out["neg_lm"] = np.asarray(jf.neg_lm(ja_lm))
""", tmp_path, field=name, a=_strs(a), b=_strs(b))
    _eq(tf.neg(ta), ref["neg"])
    ta_lm = ta.reshape(4, 16, 16).transpose(-1, -2)
    tb_lm = tb.reshape(4, 16, 16).transpose(-1, -2)
    _eq(tf.add_lm(ta_lm, tb_lm), ref["add_lm"])
    _eq(tf.sub_lm(ta_lm, tb_lm), ref["sub_lm"])
    _eq(tf.neg_lm(ta_lm), ref["neg_lm"])


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_sums_match_jax(name, tmp_path):
    """The field sums; for Fr also the dense polynomial, the densifier's
    timestamps and the single grand-product circuit against the JAX
    package's, in the same JAX process (ports of tests/test_poly_densified.py
    and test_utils_parity.py::test_single_grand_product_circuit)."""
    tf, a, b, ta, _ = _pair(name, seed=7)
    script = _JFIELD + """
out["sum"] = np.asarray(jf.sum(ja))
out["sum3"] = np.asarray(jf.sum(ja.reshape(16, 4, 16)))
"""
    extra = {}
    if name == "Fr":
        script += _JAX_POLY
        extra = _poly_inputs()
    ref = jax_reference(script, tmp_path, field=name, a=_strs(a), b=_strs(b),
                        **extra)
    _eq(tf.sum(ta), ref["sum"])
    _eq(tf.finish_sum(tf.sum_columns(ta.reshape(16, 4, 16))), ref["sum3"])
    assert tf.decode(tf.sum(ta)[None]) == [sum(a) % tf.host.p]
    if name == "Fr":
        _check_poly(extra, ref)


# The dense polynomial's API, the densifier and the single grand-product
# circuit in the JAX package, on _poly_inputs().
_JAX_POLY = """
import jax.numpy as jnp
from lasso_tpu.lasso.densified import DensifiedRepresentation, _timestamps
from lasso_tpu.poly.dense import DensePolynomial, evaluate_host
from lasso_tpu.subprotocols.grand_product import GrandProductCircuit
ints = lambda key: [int(v) for v in inp[key]]
r4 = ints("r4")
rs = [JFr.encode_scalar(x) for x in r4]
p8 = DensePolynomial.from_ints(ints("z8"))
out["top"] = np.asarray(p8.bound_var_top(rs[0]).z)
out["bot"] = np.asarray(p8.bound_var_bot(rs[0]).z)
p16 = DensePolynomial.from_ints(ints("z16"))
out["z16"] = np.asarray(p16.z)
out["eval_device"] = np.asarray(p16.evaluate_device(rs))
out["eval"] = np.array(str(p16.evaluate(r4)))
out["eval_host"] = np.array(str(evaluate_host(ints("z16"), r4)))
cur = p16
for r in rs:
    cur = cur.bound_var_top(r)
out["via_binds"] = np.asarray(cur.z)
out["fold"] = np.asarray(p16.bound(JFr.encode_ints(ints("l4"))))
out["u64"] = np.asarray(DensePolynomial.from_u64(inp["u64"]).z)
merged = DensePolynomial.merge(
    [DensePolynomial.from_ints(ints(k)) for k in ("m1", "m2", "m3")])
out["merged"] = np.asarray(merged.z)
lo, hi = p16.split(4)
out["split_lo"], out["split_hi"] = np.asarray(lo.z), np.asarray(hi.z)
out["item"] = np.array(str(p16[5]))
read_ts, final_ts = _timestamps(jnp.asarray(inp["addrs"], dtype=jnp.int32), 16)
out["read_ts"], out["final_ts"] = np.asarray(read_ts), np.asarray(final_ts)
dense = DensifiedRepresentation(inp["nz"].tolist(), log_m=2, c=2)
out["l_variate"] = np.asarray(dense.combined_l_variate_polys.z)
out["log_m_variate"] = np.asarray(dense.combined_log_m_variate_polys.z)
gp = GrandProductCircuit(JFr.encode_ints(ints("gp")))
out["gp_root"] = np.array(str(gp.evaluate()))
out["gp_layers"] = np.array(gp.num_layers)
for t in range(gp.num_layers):
    out[f"gp_left{t}"] = np.asarray(gp.left_vec(t))
    out[f"gp_right{t}"] = np.asarray(gp.right_vec(t))
"""


def _poly_inputs():
    rng = np.random.default_rng(31)
    return {"z8": _strs(_ints(TFr, 8, 32)), "z16": _strs(_ints(TFr, 16, 33)),
            "r4": _strs(_ints(TFr, 7, 34)[3:]),  # no edge values
            "l4": _strs(_ints(TFr, 4, 35)),
            "u64": rng.integers(0, 2**63, size=11, dtype=np.uint64),
            "m1": _strs(_ints(TFr, 4, 36)), "m2": _strs(_ints(TFr, 4, 37)),
            "m3": _strs(_ints(TFr, 4, 38)),
            "addrs": rng.integers(0, 16, size=64),
            # the reference's pinned instance (test_poly_densified.py)
            "nz": np.array([[1, 2], [3, 0], [1, 2], [1, 1]]),
            "gp": _strs(_ints(TFr, 11, 39)[3:])}


def _check_poly(inp, ref):
    """The port's DensePolynomial, evaluate_host, _timestamps,
    DensifiedRepresentation and GrandProductCircuit against the JAX
    package's (limbs and host ints, exactly) and against the host formulas
    the reference's tests use."""
    from lasso_tpu_torch.lasso.densified import (DensifiedRepresentation,
                                                 _timestamps)
    from lasso_tpu_torch.poly.dense import (DensePolynomial, eq_evals_host,
                                            evaluate_host)
    from lasso_tpu_torch.subprotocols.grand_product import GrandProductCircuit

    p = TFr.host.p
    ints = lambda key: [int(v) for v in inp[key]]  # noqa: E731
    z8, z16, r4 = ints("z8"), ints("z16"), ints("r4")
    rs = [TFr.encode_scalar(x, "cpu") for x in r4]

    # bound_var_top / bound_var_bot (test_bound_var_top_bot)
    p8 = DensePolynomial.from_ints(z8, "cpu")
    top, bot = p8.bound_var_top(rs[0]), p8.bound_var_bot(rs[0])
    _eq(top.z, ref["top"])
    _eq(bot.z, ref["bot"])
    r = r4[0]
    assert top.to_ints() == [(z8[i] + r * (z8[i + 4] - z8[i])) % p
                             for i in range(4)]
    assert bot.to_ints() == [(z8[2 * i] + r * (z8[2 * i + 1] - z8[2 * i])) % p
                             for i in range(4)]

    # evaluate == <eq(r, .), z> (test_evaluate_matches_eq_dot)
    p16 = DensePolynomial.from_ints(z16, "cpu")
    _eq(p16.z, ref["z16"])
    _eq(p16.evaluate_device(rs), ref["eval_device"])
    want = sum(c * v for c, v in zip(eq_evals_host(r4), z16)) % p
    assert p16.evaluate(r4) == evaluate_host(z16, r4) == want
    assert want == int(ref["eval"]) == int(ref["eval_host"])

    # evaluating == binding the variables top-down (test_evaluate_via_binds),
    # and bottom-up at the reversed point
    cur = p16
    for x in rs:
        cur = cur.bound_var_top(x)
    _eq(cur.z, ref["via_binds"])
    assert len(cur) == 1 and cur[0] == want
    cur = p16
    for x in reversed(rs):
        cur = cur.bound_var_bot(x)
    assert cur.to_ints() == [want]

    # the Hyrax L-fold (test_bound_l_fold)
    l4 = ints("l4")
    fold = p16.bound(TFr.encode_ints(l4, "cpu"))
    _eq(fold, ref["fold"])
    assert TFr.decode(fold) == [sum(l4[i] * z16[i * 4 + j] for i in range(4)) % p
                                for j in range(4)]

    # from_u64 pads to a power of two; merge zero-pads the concatenation
    # (test_merge_pads_pow2); split, clone and indexing are views
    u64 = DensePolynomial.from_u64(inp["u64"], "cpu")
    _eq(u64.z, ref["u64"])
    assert u64.to_ints() == [int(v) for v in inp["u64"]] + [0] * 5
    parts = [DensePolynomial.from_ints(ints(k), "cpu") for k in ("m1", "m2", "m3")]
    merged = DensePolynomial.merge(parts)
    _eq(merged.z, ref["merged"])
    assert len(merged) == 16 and merged.num_vars == 4
    vals = merged.to_ints()
    assert vals[:4] == parts[0].to_ints() and vals[8:12] == parts[2].to_ints()
    assert vals[12:] == [0, 0, 0, 0]
    lo, hi = p16.split(4)
    _eq(lo.z, ref["split_lo"])
    _eq(hi.z, ref["split_hi"])
    assert lo.to_ints() == z16[:4] and hi.to_ints() == z16[4:8]
    twin = p16.clone()
    assert twin is not p16 and torch.equal(twin.z, p16.z)
    assert p16[5] == z16[5] == int(ref["item"])

    # the sort/rank timestamps against the sequential counter loop
    # (test_timestamps_match_sequential_reference, densified.rs:44-51)
    addrs = [int(v) for v in inp["addrs"]]
    counters, read_want = [0] * 16, []
    for a in addrs:
        read_want.append(counters[a])
        counters[a] += 1
    read_ts, final_ts = _timestamps(torch.as_tensor(inp["addrs"]), 16)
    assert read_ts.tolist() == read_want == ref["read_ts"].tolist()
    assert final_ts.tolist() == counters == ref["final_ts"].tolist()

    # the reference's pinned densified instance
    # (test_densified_shapes_and_values)
    dense = DensifiedRepresentation(inp["nz"].tolist(), 2, 2, device="cpu")
    assert (dense.s, dense.m, dense.c) == (4, 4, 2)
    assert dense.dim[0].to_ints() == [1, 3, 1, 1]
    assert dense.read[0].to_ints() == [0, 0, 1, 2]
    assert dense.final[0].to_ints() == [0, 3, 0, 1]
    assert len(dense.combined_l_variate_polys) == 16
    assert len(dense.combined_log_m_variate_polys) == 8
    _eq(dense.combined_l_variate_polys.z, ref["l_variate"])
    _eq(dense.combined_log_m_variate_polys.z, ref["log_m_variate"])
    merged = DensePolynomial.merge(dense.dim + dense.read)
    assert torch.equal(merged.z, dense.combined_l_variate_polys.z)

    # the single grand-product circuit (test_single_grand_product_circuit)
    leaves = ints("gp")
    gp = GrandProductCircuit(DensePolynomial.from_ints(leaves, "cpu"))
    root = 1
    for v in leaves:
        root = root * v % p
    assert gp.evaluate() == root == int(ref["gp_root"])
    assert gp.num_layers == int(ref["gp_layers"]) == 3
    assert gp.left_vec(0).shape == (4, 16)
    assert GrandProductCircuit(TFr.encode_ints(leaves, "cpu")).evaluate() == root
    for t in range(gp.num_layers):
        _eq(gp.left_vec(t), ref[f"gp_left{t}"])
        _eq(gp.right_vec(t), ref[f"gp_right{t}"])


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_inverse_and_conversions_match_jax(name, tmp_path):
    """Inversion and the conversions; for Fr also the device-resident
    transcript (keccak-f[1600] and DeviceTranscript, which turns bytes into
    scalars and back) against JAX's and the host transcript, in the same
    JAX process."""
    tf, a, b, ta, _ = _pair(name, seed=9)
    u64 = np.random.default_rng(3).integers(0, 2**63, size=N, dtype=np.uint64)
    wide = to_numpy(ta).copy()
    wide[:, 15] = 0xFFFF  # values below 2^256, not reduced
    script = _JFIELD + """
out["inv"] = np.asarray(jf.inv_device(ja[3:8]))
out["ints"] = np.asarray(jf.to_int_limbs(ja))
out["scalar"] = np.asarray(jf.encode_scalar(a[5]))
out["u64"] = np.asarray(jf.encode_u64_array(inp["u64"]))
out["canon"] = np.asarray(jf.canon_wide(inp["wide"]))
out["decoded"] = np.array([str(v) for v in jf.decode(ja)])
"""
    extra = {}
    if name == "Fr":
        script += _JAX_TRANSCRIPT
        extra = _transcript_inputs(a)
    ref = jax_reference(script, tmp_path, field=name, a=_strs(a), b=_strs(b),
                        u64=u64, wide=wide, **extra)
    _eq(ta, ref["a"])
    _eq(tf.inv_device(ta[3:8]), ref["inv"])
    _eq(tf.to_int_limbs(ta), ref["ints"])
    _eq(tf.encode_scalar(a[5], "cpu"), ref["scalar"])
    assert tf.decode(ta) == [int(v) for v in ref["decoded"]] == a
    _eq(tf.encode_u64_array(u64, "cpu"), ref["u64"])
    _eq(tf.canon_wide(limbs_from_numpy(wide, "cpu")), ref["canon"])
    if name == "Fr":
        _check_transcript(a, extra, ref)


# The device transcript's script, run by the port, the JAX package and the
# host transcript from the same entry position: a scalar append leaves the
# sponge away from the position after a challenge.
_JAX_TRANSCRIPT = """
import jax
import jax.numpy as jnp
from lasso_tpu.transcript.device_strobe import (DeviceTranscript,
                                                keccak_f1600_state)
from lasso_tpu.transcript.proof_transcript import ProofTranscript
out["keccak"] = np.asarray(jax.jit(jax.vmap(keccak_f1600_state))(
    jnp.asarray(inp["states"].astype(np.uint32))))
tr = ProofTranscript(b"device-transcript")
tr.append_scalar(b"claim", 0x1234)
dt = DeviceTranscript.from_host(tr)
dt.append_scalar(b"s", ja[0])
dt.append_scalars(b"v", ja[1:6])
dt.append_point_bytes(b"P", jnp.asarray(inp["point"].astype(np.uint32)))
dt.append_message_static(b"m", inp["message"].tobytes())
c1 = dt.challenge_scalar(b"c1")
dt.append_scalar(b"t", ja[6])
c2 = dt.challenge_scalar(b"c2")
out["challenges"] = np.asarray(jnp.stack([c1, c2]))
out["state"] = np.asarray(dt.state_tuple())
out["meta"] = np.array([dt.s.pos, dt.s.pos_begin, dt.s.cur_flags])
"""


def _transcript_inputs(a):
    from lasso_tpu_torch.curve.host import GENERATOR

    rng = np.random.default_rng(23)
    states = rng.integers(0, 256, size=(8, 200)).astype(np.uint8)
    states[0] = 0
    point = np.frombuffer(GENERATOR.mul(a[7]).to_compressed_bytes(), np.uint8)
    message = rng.integers(0, 256, size=300).astype(np.uint8)  # > STROBE_R
    return {"states": states, "point": point, "message": message}


def _check_transcript(a, inp, ref):
    """keccak_f1600_plain against JAX's keccak_f1600_state and the host
    keccak; the port's DeviceTranscript against JAX's and against the host
    ProofTranscript: both challenges, the final state and its position."""
    states = torch.as_tensor(inp["states"].astype(np.int32))
    got = keccak_f1600_plain(states)
    _eq(got, ref["keccak"])
    for row, out_row in zip(inp["states"], got):
        host = bytearray(row.tobytes())
        host_keccak.keccak_f1600(host)
        assert bytes(out_row.numpy().astype(np.uint8)) == bytes(host)

    host = ProofTranscript(b"device-transcript")
    host.append_scalar(b"claim", 0x1234)
    dt = DeviceTranscript.from_host(host, "cpu")
    scalars = TFr.encode_ints(a[:7], "cpu")
    dt.append_scalar(b"s", scalars[0])
    dt.append_scalars(b"v", scalars[1:6])
    dt.append_point_bytes(b"P", torch.as_tensor(inp["point"].astype(np.int32)))
    dt.append_message_static(b"m", inp["message"].tobytes())
    c1 = dt.challenge_scalar(b"c1")
    dt.append_scalar(b"t", scalars[6])
    c2 = dt.challenge_scalar(b"c2")
    _eq(torch.stack([c1, c2]), ref["challenges"])
    _eq(dt.state, ref["state"])
    assert list(dt.meta()) == ref["meta"].tolist()

    host.append_scalar(b"s", a[0])
    host.append_scalars(b"v", a[1:6])
    host.append_message(b"P", inp["point"].tobytes())
    host.append_message(b"m", inp["message"].tobytes())
    h1 = host.challenge_scalar(b"c1")
    host.append_scalar(b"t", a[6])
    h2 = host.challenge_scalar(b"c2")
    assert TFr.decode(torch.stack([c1, c2])) == [h1, h2]
    st = host.t.strobe
    assert bytes(dt.state.numpy().astype(np.uint8)) == bytes(st.state)
    assert dt.meta() == (st.pos, st.pos_begin, st.cur_flags)


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_mont_mul_plain_matches_pallas_kernel(name, tmp_path):
    """K1's and K2's plain versions against their Pallas kernels (interpret
    mode): K1 on one 1024-element tile; K2 on one [1, 16, 1024] limb-major
    tile and against a broadcast [16, 1] constant, and, for Fp, against the
    reference's XLA limb-major multiply (JFp._mul_lm_xla)."""
    tf = FIELDS[name]
    n = 1024
    a, b = _ints(tf, n, 21), _ints(tf, n, 22)
    x_lm = to_numpy(tf.encode_ints(_ints(tf, n, 41), "cpu")).T[None]
    y_lm = to_numpy(tf.encode_ints(_ints(tf, n, 42), "cpu")).T[None]
    c_lm = y_lm[0, :, 5:6]  # [16, 1]
    ref = jax_reference(_JFIELD + """
from lasso_tpu.ops.field_pallas import _mont_mul_lm, mont_mul_lm
n = 1024
lm = lambda x: np.asarray(x).T.reshape(16, n // 128, 128)
got = _mont_mul_lm(lm(ja), lm(jb), jf.p_limbs, jf.n0inv, interpret=True)
out["r"] = np.asarray(got).reshape(16, n).T
for tag, y in (("full", inp["y"]), ("const", inp["c"])):
    out["lm_" + tag] = np.asarray(
        mont_mul_lm(inp["x"], y, jf.p_limbs, jf.n0inv, interpret=True))
if jf is JFp:
    out["xla"] = np.asarray(JFp._mul_lm_xla(inp["x"], inp["y"]))
""", tmp_path, field=name, a=_strs(a), b=_strs(b), x=x_lm, y=y_lm, c=c_lm)
    plain = field_cuda.mont_mul_plain(
        limbs_from_numpy(ref["a"], "cpu"), limbs_from_numpy(ref["b"], "cpu"),
        name)
    _eq(plain, ref["r"])
    x = limb_major_from_numpy(x_lm, "cpu")
    for tag, y_np in (("full", y_lm), ("const", c_lm)):
        y = limb_major_from_numpy(y_np, "cpu")
        got = field_cuda.mont_mul_lm_plain(x, y, name)
        assert got.shape == (1, 16, n)
        _eq(got, ref["lm_" + tag])
        _eq(tf.mul_lm(x, y), ref["lm_" + tag])
    if name == "Fp":
        _eq(TFp.mul_lm(x, limb_major_from_numpy(y_lm, "cpu")), ref["xla"])


def test_dispatch_uses_plain_version_on_cpu():
    """K1's, K2's, K4's and K5's dispatchers take the plain version for CPU
    tensors (no launch; K2's broadcasts leading axes); the kernel wrappers
    take CUDA tensors only."""
    _, _, _, ta, tb = _pair("Fr", seed=13)
    before = dict(field_cuda.launch_counts)
    out = field_cuda.mont_mul(ta, tb, "Fr")
    assert field_cuda.launch_counts == before  # no kernel launch on the CPU
    assert torch.equal(out, field_cuda.mont_mul_plain(ta, tb, "Fr"))
    with pytest.raises(ValueError):
        field_cuda.mont_mul_cuda(ta, tb, "Fr")  # the kernel takes CUDA only
    # up to SMALL_PRODUCTS products take Python ints, more the limb
    # arithmetic: the same limbs either way, whole or broadcast
    few = tfield.SMALL_PRODUCTS
    assert ta.shape[0] > few
    for name in ("Fr", "Fp"):
        _, _, _, xa, xb = _pair(name, seed=23)
        full = field_cuda.mont_mul_plain(xa, xb, name)
        assert torch.equal(
            field_cuda.mont_mul_plain(xa[:few], xb[:few], name), full[:few])
        assert torch.equal(field_cuda.mont_mul_plain(xa[:3], xb[7], name),
                           field_cuda.mont_mul_plain(xa, xb[7], name)[:3])

    _, _, _, ta, tb = _pair("Fp", seed=17)
    lm_a = ta.T.reshape(16, 4, 16).movedim(1, 0)  # [4, 16, 16] limb-major
    lm_b = tb.T[None, :, :16]                     # [1, 16, 16], broadcast
    before = dict(field_cuda.launch_counts)
    out = field_cuda.mont_mul_lm(lm_a, lm_b, "Fp")
    assert field_cuda.launch_counts == before
    want = field_cuda.mont_mul_plain(lm_a.movedim(-2, -1),
                                     lm_b.movedim(-2, -1), "Fp")
    assert out.shape == (4, 16, 16)
    assert torch.equal(out, want.movedim(-1, -2))
    with pytest.raises(ValueError):
        field_cuda.mont_mul_lm_cuda(lm_a.contiguous(), lm_a.contiguous(), "Fp")
    # contiguous stacked operands of one shape, and a [16, 1] constant on
    # either side: the plain version, limb for limb, and no launch
    st_a = lm_a.contiguous().view(2, 2, 16, 16)
    st_b = torch.flip(st_a, (0,)).contiguous()
    const = lm_b[0, :, 3:4].contiguous()
    for x, y in ((st_a, st_b), (st_a, const), (const, st_a)):
        got = field_cuda.mont_mul_lm(x, y, "Fp")
        assert torch.equal(got, field_cuda.mont_mul_lm_plain(x, y, "Fp"))
        assert got.shape == st_a.shape
    assert field_cuda.launch_counts == before
    with pytest.raises(ValueError):
        field_cuda.mont_mul_lm_cuda(st_a[0], const, "Fp")

    states = torch.as_tensor(np.random.default_rng(19).integers(
        0, 256, size=(3, 200)).astype(np.int32))
    out = keccak_f1600_state(states)
    assert field_cuda.launch_counts == before
    assert torch.equal(out, keccak_f1600_plain(states))
    with pytest.raises(ValueError):
        field_cuda.keccak_cuda(states)
    _check_k5_dispatch_on_cpu()


def _check_k5_dispatch_on_cpu():
    """TFr/TFp add, sub, neg, sum_columns and finish_sum take the plain
    versions for CPU tensors (no launch); K5's wrappers take CUDA tensors
    only; the dispatcher's layouts read half views, broadcast
    elements and transposed sums in place and refuse what does not
    collapse."""
    before = dict(field_cuda.launch_counts)
    for name, tf in FIELDS.items():
        _, _, _, ta, tb = _pair(name, seed=29)
        c = tf.consts("cpu")
        assert torch.equal(tf.add(ta, tb), tfield._add_plain(ta, tb, c))
        assert torch.equal(tf.sub(ta, tb), tfield._sub_plain(ta, tb, c))
        assert torch.equal(tf.neg(ta),
                           tfield._sub_plain(torch.zeros_like(ta), ta, c))
        x = torch.stack([ta, tb], dim=1)  # [64, 2, 16]
        cols = tf.sum_columns(x)
        assert torch.equal(cols, tfield._sum_columns_plain(x))
        assert torch.equal(tf.finish_sum(cols),
                           tfield._finish_sum_plain(tf, cols))
        assert tf.decode(tf.sum(x)) == [sum(tf.decode(x[:, j])) % tf.host.p
                                        for j in range(2)]
        assert field_cuda.launch_counts == before
        # K5's wrappers, strict or copying, take CUDA tensors only
        for call in (lambda: field_cuda.add_sub_cuda(ta, tb, False, name),
                     lambda: field_cuda.add_sub(ta, tb, True, name),
                     lambda: field_cuda.sum_columns_cuda(x),
                     lambda: field_cuda.sum_columns(x),
                     lambda: field_cuda.finish_sum_cuda(cols, name),
                     lambda: field_cuda.finish_sum(cols, name)):
            with pytest.raises(ValueError):
                call()

    layout = field_cuda._batch_layout
    st = torch.zeros(3, 64, 16, dtype=torch.int32)
    lo, hi = st[:, :32], st[:, 32:]
    assert layout(lo.shape, lo, hi) == (3, 32, 1024, 16, 1024, 16)
    assert layout(lo.shape, lo, st[0, 5]) == (3, 32, 1024, 16, 0, 0)
    assert layout(lo.shape, st[1, :1], lo) == (3, 32, 0, 0, 1024, 16)
    assert layout((16,), st[0, 0], st[0, 1]) == (1, 1, 0, 0, 0, 0)
    assert layout(st.shape, st, st[0]) == (3, 64, 1024, 16, 0, 16)
    assert layout(st.shape, st, st) == (1, 192, 0, 16, 0, 16)
    four = torch.zeros(2, 3, 4, 16, dtype=torch.int32)
    assert layout(four[:, :, :2].shape, four[:, :, :2],
                  four[:, :, 2:]) == (6, 2, 64, 16, 64, 16)
    assert layout(four[:, :2, :2].shape, four[:, :2, :2],
                  four[:, 1:, 2:]) is None  # three strided axes
    assert layout(st.shape, st, st.movedim(-1, -2).contiguous().movedim(
        -2, -1)) is None  # limb-major: limbs not the contiguous axis
    sums = field_cuda._sum_layout
    assert sums(st[0]) == (64, 1, 16, 0)
    assert sums(st.movedim(1, 0)) == (64, 3, 16, 1024)
    assert sums(lo.movedim(1, 0)) == (32, 3, 16, 1024)
    assert sums(four) == (2, 12, 192, 16)
    assert sums(four[:, :, :2]) is None


# ---------------------------------------------------------------------------
# the CUDA kernels' arithmetic header, built for the host
# ---------------------------------------------------------------------------

_SHIM = r"""
#include <algorithm>
#include <cstring>
#include <vector>
#include "field256.cuh"
#include "keccak.cuh"
// K4's warp simulated lane by lane: each exchange reads what all 32 lanes
// held at that step, from the source lanes keccak::lane_map gives.
extern "C" void h_keccak(int32_t* state) {
  using namespace keccak;
  uint64_t a[32], c[32], b[32], rc[32];
  LaneMap m[32];
  for (int t = 0; t < 32; ++t) {
    const int l = t < kLanes ? t : 0;
    m[t] = lane_map(l);
    a[t] = load_lane(state, l);
    rc[t] = round_constant(t < kRounds ? t : 0);
  }
  for (int r = 0; r < kRounds; ++r) {
    for (int t = 0; t < 32; ++t) {
      c[t] = a[m[t].column[0]];
      for (int k = 1; k < 5; ++k) c[t] ^= a[m[t].column[k]];
    }
    for (int t = 0; t < 32; ++t) a[t] ^= theta_d(c[m[t].c_prev], c[m[t].c_next]);
    for (int t = 0; t < 32; ++t) b[t] = rotl(a[m[t].pi_src], m[t].pi_rot);
    for (int t = 0; t < 32; ++t) a[t] = chi(b[t], b[m[t].chi1], b[m[t].chi2]);
    a[0] ^= rc[r];
  }
  for (int t = 0; t < kLanes; ++t) store_lane(state, t, a[t]);
}
extern "C" void h_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                           int64_t n, int field) {
  const f256::Modulus m = field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    f256::load16(x, a + 16 * i, 1);
    f256::load16(y, b + 16 * i, 1);
    f256::mont_mul(z, x, y, m);
    f256::store16(out + 16 * i, z, 1);
  }
}
extern "C" int h_tile_slot(int e, int c) { return f256::tile_slot(e, c); }
// K1's staging as the kernel runs it, one tile of `tile` elements at a time:
// 16-byte chunks in through tile_slot, each element out of its slots, the
// product back over its a slots, the chunks out through tile_slot.  b_const:
// b is one element.
extern "C" void h_mont_mul_tiled(const int32_t* a, const int32_t* b,
                                 int32_t* out, int64_t n, int b_const,
                                 int field, int tile) {
  const f256::Modulus m = field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  std::vector<int32_t> sa(64 * tile), sb(64 * tile);
  for (int64_t first = 0; first < n; first += tile) {
    const int elems = (int)std::min<int64_t>(tile, n - first);
    for (int g = 0; g < 4 * elems; ++g) {
      const int slot = f256::tile_slot(g / 4, g % 4);
      std::memcpy(&sa[4 * slot], a + 4 * (4 * first + g), 16);
      if (!b_const) std::memcpy(&sb[4 * slot], b + 4 * (4 * first + g), 16);
    }
    for (int e = 0; e < elems; ++e) {
      int32_t xa[16], xb[16], z[16];
      for (int c = 0; c < 4; ++c) {
        const int slot = f256::tile_slot(e, c);
        std::memcpy(xa + 4 * c, &sa[4 * slot], 16);
        std::memcpy(xb + 4 * c, b_const ? b + 4 * c : &sb[4 * slot], 16);
      }
      uint32_t x[8], y[8], w[8];
      f256::load16(x, xa, 1);
      f256::load16(y, xb, 1);
      f256::mont_mul(w, x, y, m);
      f256::store16(z, w, 1);
      for (int c = 0; c < 4; ++c)
        std::memcpy(&sa[4 * f256::tile_slot(e, c)], z + 4 * c, 16);
    }
    for (int g = 0; g < 4 * elems; ++g)
      std::memcpy(out + 4 * (4 * first + g), &sa[4 * f256::tile_slot(g / 4, g % 4)], 16);
  }
}
// K2's grid (lm_launch) into shape[3]: cols, groups, blocks.
extern "C" void h_lm_launch(int64_t total, int64_t n, int pairs_ok, int sms,
                            int threads, int max_cols, int64_t* shape) {
  const f256::LmLaunch s = f256::lm_launch(
      (uint32_t)total, (uint32_t)n, pairs_ok, sms, threads, max_cols);
  shape[0] = s.cols, shape[1] = s.groups, shape[2] = s.blocks;
}
template <int kField, bool kBConst, int kCols>
void lm_grid(const int32_t* a, const int32_t* b, int32_t* out, uint32_t n,
             int threads, const f256::LmLaunch& s) {
  for (uint32_t blk = 0; blk < s.blocks; ++blk)
    for (int t = 0; t < threads; ++t) {
      const uint32_t g = blk * threads + t;
      if (g < s.groups)
        f256::mont_mul_lm_columns<f256::PortableMul<kField>, kBConst, kCols>(
            a, b, out, g * kCols, n);
    }
}
template <int kField>
void lm_field(const int32_t* a, const int32_t* b, int32_t* out, uint32_t n,
              int b_const, int threads, const f256::LmLaunch& s) {
  if (s.cols == 2)
    b_const ? lm_grid<kField, true, 2>(a, b, out, n, threads, s)
            : lm_grid<kField, false, 2>(a, b, out, n, threads, s);
  else
    b_const ? lm_grid<kField, true, 1>(a, b, out, n, threads, s)
            : lm_grid<kField, false, 1>(a, b, out, n, threads, s);
}
// K2 as its kernel runs it: the grid from lm_launch, every thread's columns
// through mont_mul_lm_columns, with the portable product.  b_const: b is
// one [16, 1] element.
extern "C" void h_mont_mul_lm(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t k, int64_t n, int b_const,
                              int field, int sms, int threads, int max_cols) {
  const f256::LmLaunch s = f256::lm_launch(
      (uint32_t)(k * n), (uint32_t)n, true, sms, threads, max_cols);
  field == 0 ? lm_field<0>(a, b, out, (uint32_t)n, b_const, threads, s)
             : lm_field<1>(a, b, out, (uint32_t)n, b_const, threads, s);
}
// K5's add/sub as its kernel runs it: one element per thread over the
// flat [outer * inner] batch, each operand read through its strides.
extern "C" void h_addsub(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t outer, int64_t inner, int64_t sa0,
                         int64_t sa1, int64_t sb0, int64_t sb1, int sub,
                         int field) {
  const f256::Modulus m = field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  for (uint32_t e = 0; e < (uint32_t)(outer * inner); ++e) {
    if (sub)
      f256::addsub_element<f256::PortableOps, true>(
          a, b, out, e, (uint32_t)inner, sa0, sa1, sb0, sb1, m);
    else
      f256::addsub_element<f256::PortableOps, false>(
          a, b, out, e, (uint32_t)inner, sa0, sa1, sb0, sb1, m);
  }
}
// K5's column-sum grid (sum_launch) into shape[2]: threads, splits.
extern "C" void h_sum_launch(int64_t n, int64_t m, int sms, int64_t* shape) {
  const f256::SumLaunch s = f256::sum_launch(n, m, sms);
  shape[0] = s.threads, shape[1] = s.splits;
}
// K5's column sum as its kernel runs it: the grid from sum_launch, each
// split's rows from split_rows, every thread's share through sum_rows,
// the partial sums added, then wide_columns.
extern "C" void h_sum(const int32_t* x, int64_t* out, int64_t n, int64_t m,
                      int64_t sn, int64_t sm, int sms) {
  const f256::SumLaunch s = f256::sum_launch(n, m, sms);
  for (int64_t set = 0; set < m; ++set) {
    uint64_t total[16] = {0};
    for (int split = 0; split < s.splits; ++split) {
      int64_t begin, end;
      f256::split_rows(n, s.splits, split, &begin, &end);
      for (int t = 0; t < s.threads; ++t) {
        uint64_t acc[4] = {0, 0, 0, 0};
        f256::sum_rows(acc, x + set * sm, sn, begin, end, t, s.threads);
        for (int k = 0; k < 4; ++k) total[4 * (t & 3) + k] += acc[k];
      }
    }
    f256::wide_columns(out + set * f256::kWide, total);
  }
}
// K5's finish, one column set at a time.
extern "C" void h_finish(const int64_t* cols, int32_t* out, int64_t m,
                         int64_t width, int field) {
  const f256::Modulus md = field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  for (int64_t set = 0; set < m; ++set) {
    uint32_t w[8];
    f256::finish_wide<f256::PortableOps>(w, cols + set * width, (int)width,
                                         md, field);
    f256::store16(out + 16 * set, w, 1);
  }
}
extern "C" void h_padd(const int32_t* p, const int32_t* q, int32_t* out,
                       int64_t n) {
  const f256::Curve c = f256::curve25519();
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x[4][8], y[4][8], r[4][8];
    for (int co = 0; co < 4; ++co) {
      f256::load16(x[co], p + co * 16 * n + i, n);
      f256::load16(y[co], q + co * 16 * n + i, n);
    }
    f256::padd_point(r, x, y, c);
    for (int co = 0; co < 4; ++co) f256::store16(out + co * 16 * n + i, r[co], n);
  }
}
"""


@pytest.fixture(scope="module")
def header_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("field256")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    field_cuda.CSRC, str(src), "-o", str(so)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.h_mont_mul.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int]
    lib.h_padd.argtypes = [vp, vp, vp, ctypes.c_int64]
    lib.h_tile_slot.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.h_mont_mul_tiled.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    i32, i64 = ctypes.c_int, ctypes.c_int64
    lib.h_lm_launch.argtypes = [i64, i64, i32, i32, i32, i32, vp]
    lib.h_mont_mul_lm.argtypes = [vp, vp, vp, i64, i64, i32, i32, i32, i32,
                                  i32]
    lib.h_keccak.argtypes = [vp]
    lib.h_addsub.argtypes = [vp, vp, vp, i64, i64, i64, i64, i64, i64, i32,
                             i32]
    lib.h_sum_launch.argtypes = [i64, i64, i32, vp]
    lib.h_sum.argtypes = [vp, vp, i64, i64, i64, i64, i32]
    lib.h_finish.argtypes = [vp, vp, i64, i64, i32]
    return lib


def _lm_launch(lib, total, n, pairs_ok, sms, threads, cols):
    shape = (ctypes.c_int64 * 3)()
    lib.h_lm_launch(total, n, pairs_ok, sms, threads, cols, shape)
    return tuple(shape)


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_cuda_header_mont_mul_matches_plain(header_lib, name):
    """The portable product; K1's shared-memory staging through tile_slot:
    a bijection of each tile's chunks, free of bank conflicts, and the same
    limbs out as the plain version at a ragged n, with b whole or one
    broadcast element; K2's grid and limb-major addressing as its kernel
    runs them, one column or a pair per thread, against the plain version
    at ragged shapes."""
    tf = FIELDS[name]
    n = 512
    ta = tf.encode_ints(_ints(tf, n, 31), "cpu").contiguous()
    tb = tf.encode_ints(_ints(tf, n, 32), "cpu").contiguous()
    out = torch.empty_like(ta)
    header_lib.h_mont_mul(ta.data_ptr(), tb.data_ptr(), out.data_ptr(), n,
                          field_cuda.FIELD_IDS[name])
    assert torch.equal(out, field_cuda.mont_mul_plain(ta, tb, name))

    slot = header_lib.h_tile_slot
    for tile in (1, 7, 128, 256):
        slots = sorted(slot(e, c) for e in range(tile) for c in range(4))
        assert slots == list(range(4 * tile))
    # 16-byte accesses are served 8 threads at a time over 8 chunk-wide
    # bank groups: per-element reads (8 elements, one chunk each) and the
    # copy-in (8 neighbouring chunks) each hit 8 distinct groups
    for e0 in range(0, 128, 8):
        for c in range(4):
            assert len({slot(e, c) % 8 for e in range(e0, e0 + 8)}) == 8
    for g0 in range(0, 512, 8):
        assert len({slot(g // 4, g % 4) % 8 for g in range(g0, g0 + 8)}) == 8

    for b_const in (0, 1):
        m = 300  # two whole tiles of 128 and a ragged one
        b = tb[5:6] if b_const else tb[:m]
        out = torch.empty_like(ta[:m])
        header_lib.h_mont_mul_tiled(ta.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    m, b_const, field_cuda.FIELD_IDS[name], 128)
        assert torch.equal(out, field_cuda.mont_mul_plain(ta[:m], b, name))

    # K2's grid on a 132-SM card with 128-thread blocks: the unfused path's
    # 2048-product launch takes one product per thread; [4, 16, 2^20] takes
    # pairs of columns; an odd n or an unaligned operand keeps one column
    # per thread
    grid = functools.partial(_lm_launch, header_lib, sms=132, threads=128,
                             cols=2)
    assert grid(2048, 512, 1) == (1, 2048, 16)
    assert grid(32, 32, 1) == (1, 32, 1)
    assert grid(1 << 22, 1 << 20, 1) == (2, 1 << 21, 1 << 14)
    assert grid((1 << 22) - 4, (1 << 20) - 1, 1) == (1, (1 << 22) - 4, 1 << 15)
    assert grid(1 << 22, 1 << 20, 0)[0] == 1
    assert grid(4 * 132 * 128 * 2, 8, 1)[0] == 2
    assert grid(4 * 132 * 128 * 2 - 2, 8, 1)[0] == 1
    # K2 itself, limb-major [k, 16, n]: with 2 "SMs" the pairs start at
    # 2 * 4 * 2 * 32 = 512 products, so small shapes reach both paths
    lm = tf.encode_ints(_ints(tf, 2 * 3 * 201, 33), "cpu")
    for k, n in ((1, 1), (3, 7), (1, 129), (3, 200), (3, 201), (2, 96)):
        x = lm[:k * n].reshape(k, n, 16).transpose(1, 2).contiguous()
        y = lm[k * n:2 * k * n].reshape(k, n, 16).transpose(1, 2).contiguous()
        const = y[k - 1, :, n - 1:n].contiguous()
        for b, b_const in ((y, 0), (const, 1)):
            out = torch.empty_like(x)
            header_lib.h_mont_mul_lm(x.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     k, n, b_const, field_cuda.FIELD_IDS[name],
                                     2, 32, 2)
            assert torch.equal(out, field_cuda.mont_mul_lm_plain(x, b, name)), \
                (k, n, b_const)
    assert _lm_launch(header_lib, 3 * 200, 200, 1, 2, 32, 2) == (2, 300, 10)
    assert _lm_launch(header_lib, 3 * 201, 201, 1, 2, 32, 2)[0] == 1
    _check_k5_header(header_lib, name)


def _k5_addsub(lib, a, b, shape, sub, name):
    """K5's add/sub through the host build, on the operands' own storage
    (strides from the dispatcher's layout)."""
    outer, inner, sa0, sa1, sb0, sb1 = field_cuda._batch_layout(shape, a, b)
    out = torch.empty(shape, dtype=torch.int32)
    lib.h_addsub(a.data_ptr(), b.data_ptr(), out.data_ptr(), outer, inner,
                 sa0, sa1, sb0, sb1, int(sub),
                 field_cuda.FIELD_IDS[name])
    return out


def _k5_sum(lib, x, sms):
    n, m, sn, sm = field_cuda._sum_layout(x)
    out = torch.empty(x.shape[1:-1] + (field_cuda.WIDE,), dtype=torch.int64)
    lib.h_sum(x.data_ptr(), out.data_ptr(), n, m, sn, sm, sms)
    return out


def _k5_finish(lib, wide, name):
    wide = wide.contiguous()
    out = torch.empty(wide.shape[:-1] + (16,), dtype=torch.int32)
    lib.h_finish(wide.data_ptr(), out.data_ptr(), out.numel() // 16,
                 wide.shape[-1], field_cuda.FIELD_IDS[name])
    return out


def _check_k5_header(lib, name):
    """K5's arithmetic and addressing as its kernels run them (add/sub over
    strided and broadcast operands, the column-sum grid with its splits and
    per-thread rows, the finish's REDC and product with R^2) against
    tfield's plain versions, with 0, 1, p-1, sums that wrap and a column of
    2^20 elements of p-1."""
    tf = FIELDS[name]
    c = tf.consts("cpu")
    vals = _ints(tf, 96, 51)
    vals[3:9] = [tf.host.p - 1, tf.host.p - 2, 1, 2, tf.host.p // 2,
                 tf.host.p // 2 + 1]
    ta = tf.encode_ints(vals, "cpu")
    tb = tf.encode_ints(vals[::-1], "cpu")  # p-1 + p-1, p-1 - 0, 0 - p-1 ...
    for sub, plain in ((False, tfield._add_plain), (True, tfield._sub_plain)):
        assert torch.equal(_k5_addsub(lib, ta, tb, ta.shape, sub, name),
                           plain(ta, tb, c)), sub
        # half views of a contiguous [I, n, 16], one broadcast element on
        # either side, a [1, 16] row over [I, h, 16], and neg (0 - x)
        st = ta.reshape(3, 32, 16)
        lo, hi = st[:, :16], st[:, 16:]
        for x, y in ((hi, lo), (lo, ta[5]), (ta[4], hi), (hi, ta[3:4]),
                     (c.zero, ta)):
            shape = torch.broadcast_shapes(x.shape, y.shape)
            assert torch.equal(_k5_addsub(lib, x, y, shape, sub, name),
                               plain(x, y, c)), (sub, x.shape, y.shape)

    p_minus_1 = tf.encode_ints([tf.host.p - 1], "cpu")[0]
    plain_sum = tfield._sum_columns_plain
    rows = tf.encode_ints(_ints(tf, 2 * 3 * 300, 52), "cpu").reshape(
        2, 900, 16)
    rows[0, :5] = p_minus_1
    grid = functools.partial(_k5_grid, lib)
    assert grid(1 << 15, 1, 132) == (1024, 8)
    assert grid(1 << 15, 16, 132) == (1024, 8)
    assert grid(1 << 12, 1, 132) == (1024, 4)
    assert grid(4, 512, 132) == (32, 1)
    assert grid(1, 1, 132) == (32, 1)
    assert grid(0, 1, 132) == (32, 1)
    for x, sms in ((rows[0], 132), (rows[0], 1), (rows[0, :1], 1),
                   (rows[0, :0], 1), (rows.movedim(1, 0), 1),
                   (rows.reshape(2, 300, 3, 16)[:, :, 1], 2),
                   (rows.reshape(600, 3, 16), 1),
                   (p_minus_1.expand(1 << 20, 16), 2)):
        got = _k5_sum(lib, x, sms)
        want = plain_sum(x)
        assert torch.equal(got, want), (x.shape, x.stride(), sms)
        assert torch.equal(_k5_finish(lib, got, name),
                           tfield._finish_sum_plain(tf, want)), x.shape
    # the mesh route's psum of 8 ranks' columns, and 33 columns (the
    # widest) of a value below R*p
    cols = plain_sum(rows.reshape(600, 3, 16))
    assert torch.equal(_k5_finish(lib, cols * 8, name),
                       tfield._finish_sum_plain(tf, cols * 8))
    rng = np.random.default_rng(53)
    wide = torch.zeros(5, 33, dtype=torch.int64)
    wide[:, :29] = torch.as_tensor(rng.integers(0, 1 << 36, size=(5, 29)))
    wide[:2] = 0
    wide[1, :16] = torch.as_tensor(tf.p_limbs)  # p -> 0
    assert torch.equal(_k5_finish(lib, wide, name),
                       tfield._finish_sum_plain(tf, wide))
    assert not _k5_finish(lib, wide, name)[:2].any()


def _k5_grid(lib, n, m, sms):
    shape = (ctypes.c_int64 * 2)()
    lib.h_sum_launch(n, m, sms, shape)
    return tuple(shape)


def test_cuda_header_padd_matches_plain(header_lib):
    """K3's formula as the kernel splits it over a pair of lanes
    (padd_pair_first/second, with the small-constant product), run lane by
    lane through padd_point, against the plain version and the host; and
    K4's lane arithmetic (csrc/keccak.cuh) as its warp runs it, against
    the host keccak and the plain version."""
    from lasso_tpu_torch.curve import tcurve
    from lasso_tpu_torch.curve.host import GENERATOR, Point

    pts = [GENERATOR.mul(k) for k in range(1, 9)]
    # P+Q, P+P, P+identity, P+(-P)
    p_host = pts * 4
    q_host = pts[::-1] + pts + [Point.identity()] * 8 + [p.neg() for p in pts]
    p = tcurve.from_host_points(p_host, "cpu")
    q = tcurve.from_host_points(q_host, "cpu")
    out = torch.empty_like(p)
    header_lib.h_padd(p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[-1])
    want = field_cuda.padd_plain(p, q)
    assert torch.equal(out, want)
    assert tcurve.to_host_points(out) == [a.add(b) for a, b in zip(p_host, q_host)]

    states = np.random.default_rng(41).integers(0, 256, size=(24, 200))
    states[0] = 0
    states = torch.as_tensor(states.astype(np.int32))
    got = states.clone()
    for row in got:
        header_lib.h_keccak(row.data_ptr())
    assert torch.equal(got, keccak_f1600_plain(states))
    for row, out_row in zip(states, got):
        ref = bytearray(row.numpy().astype(np.uint8).tobytes())
        host_keccak.keccak_f1600(ref)
        assert bytes(out_row.numpy().astype(np.uint8)) == bytes(ref)
