"""Hand-written CUDA kernels for the field and curve hot path (port of
ops/field_pallas.py), their plain PyTorch versions, and their build.

  K1  mont_mul     csrc/mont_mul.cu     <- field_pallas._mont_mul_lm
  K2  mont_mul_lm  csrc/mont_mul_lm.cu  <- field_pallas._mont_mul_lm_batched
  K3  padd         csrc/padd.cu         <- field_pallas._padd_lm_batched
  K4  keccak       csrc/keccak.cu       <- transcript/device_strobe.py:
                                           keccak_f1600_device (an XLA
                                           program, not a Pallas kernel)
  K5  field_arith  csrc/field_arith.cu  <- no Pallas kernel: the field
                                           layer's add, sub, column sums
                                           and their finish, which the
                                           reference leaves to XLA

K2 carries the unfused curve path (curve/tcurve.py, LASSO_TPU_PALLAS_PADD=0);
K3 the fused one; K4 the device-resident transcript (its plain version is
transcript/device_strobe.keccak_f1600_plain); K5 every add, sub, neg,
column sum and finish of TFr and TFp on CUDA tensors (its plain versions
are tfield's limb arithmetic).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, and the wrapper raises if the kernel cannot take it.  There is no
fallback from one to the other.  K5's choice is made in field/tfield.py,
beside its plain versions: `add_sub`, `sum_columns` and `finish_sum` here
take CUDA tensors only.  K1 copies its operands as 16-byte chunks,
so `mont_mul_cuda` raises on an operand that is not 16-byte aligned; the
dispatcher `mont_mul` hands it aligned operands (a row-major [n, 16] view
is aligned wherever its storage is, since a row is 64 B).  K5 reads each
element as four 16-byte loads likewise, from strided views: its
dispatchers copy only an operand whose batch axes do not collapse to K5's
strided layout, or that is not 16-byte aligned.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` compiles each source
into its own shared library with a plain C entry point (bound with ctypes),
at first use or through `build()`, one nvcc per source, all started
together.  Libraries land in lasso_tpu_torch/build/cuda-<hash>/, keyed by a
hash of the sources and flags; nothing is compiled when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from lasso_tpu_torch.field import tfield as _tf
from lasso_tpu_torch.utils import tracing as _tracing

W = _tf.W

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.abspath(os.path.join(_HERE, "..", "csrc"))
BUILD_DIR = os.path.abspath(os.path.join(_HERE, "..", "build"))
HEADERS = ("field256.cuh", "keccak.cuh")
SOURCES = {"mont_mul": "mont_mul.cu", "mont_mul_lm": "mont_mul_lm.cu",
           "padd": "padd.cu", "keccak": "keccak.cu",
           "field_arith": "field_arith.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FIELD_IDS = {"Fr": 0, "Fp": 1}

# Kernel launches since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else, and counts it into the open span
# while tracing counts (K1 mont_mul, K2 mont_mul_lm, K3 padd, K4 keccak,
# K5 field_addsub for add/sub and field_sum for column sums and finishes).
launch_counts = {"mont_mul": 0, "mont_mul_lm": 0, "padd": 0, "keccak": 0,
                 "field_addsub": 0, "field_sum": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (int64 arithmetic; any device)
# ---------------------------------------------------------------------------

def _field(name: str) -> _tf.TField:
    return {"Fr": _tf.TFr, "Fp": _tf.TFp}[name]


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """a*b*2^-256 mod p on broadcastable [..., 16] canonical limbs."""
    return _tf.mont_mul_limbs(a, b, _field(field).consts(a.device))


def mont_mul_lm_plain(a: torch.Tensor, b: torch.Tensor,
                      field: str) -> torch.Tensor:
    """The same product on broadcastable limb-major [..., 16, n] limbs:
    limbs to the last axis, mont_mul_plain, and back."""
    return mont_mul_plain(a.movedim(-2, -1), b.movedim(-2, -1),
                          field).movedim(-1, -2)


def _curve_consts(device):
    from lasso_tpu_torch.field import constants as K

    fp = _tf.TFp
    a = fp.const(_tf.pack_int(fp.host.to_mont(K.CURVE_A)), device)
    d = fp.const(_tf.pack_int(fp.host.to_mont(K.CURVE_D)), device)
    return a, d


def padd_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """add-2008-hwcd on broadcastable [..., 4, 16, n] extended points: the
    same 9 general and 2 constant products as kernel K3, stacked into three
    products of independent operands (the formula's three stages), so a
    small batch pays the plain product's per-call cost three times, not
    eleven."""
    c = _tf.TFp.consts(p.device)
    a_m, d_m = _curve_consts(p.device)
    p, q = torch.broadcast_tensors(p, q)

    def coords(x):  # [..., 4, W, n] -> [4, ..., n, W]
        return x.movedim(-3, 0).movedim(-2, -1)

    def mul(x, y):
        return _tf.mont_mul_limbs(x, y, c)

    x1, y1, z1, t1 = coords(p)
    x2, y2, z2, t2 = coords(q)
    s1, s2 = _tf._add_plain(torch.stack([x1, x2]), torch.stack([y1, y2]), c)
    a_, b_, tt, d_, s = mul(torch.stack([x1, y1, t1, z1, s1]),
                            torch.stack([x2, y2, t2, z2, s2]))
    c_, a_a = mul(torch.stack([tt, a_]),
                  torch.stack([d_m.expand(tt.shape), a_m.expand(a_.shape)]))
    e = _tf._sub_plain(_tf._sub_plain(s, a_, c), b_, c)
    f, h = _tf._sub_plain(torch.stack([d_, b_]), torch.stack([c_, a_a]), c)
    g = _tf._add_plain(d_, c_, c)
    out = mul(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return out.movedim(-1, -2).movedim(0, -3)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build_dir() -> str:
    h = hashlib.sha256()
    for name in list(HEADERS) + sorted(SOURCES.values()):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "cuda-" + h.hexdigest()[:16])


def _lib_path(name: str) -> str:
    return os.path.join(_build_dir(), f"lib{name}.so")


def build(names=None) -> float:
    """Compile every missing kernel library, all nvcc processes at once.

    Returns the wall seconds spent.  Raises with the compiler's output if
    any source fails to build."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            errors.append(f"nvcc failed on {SOURCES[name]}:\n{log[-4000:]}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and spill report) for `name`."""
    with open(os.path.join(_build_dir(), f"{name}.log")) as f:
        return f.read()


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(_lib_path(name))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    if name == "mont_mul":
        lib.lasso_mont_mul.argtypes = [vp, vp, vp, i64, i64, i64,
                                       ctypes.c_int, vp]
        lib.lasso_mont_mul.restype = ctypes.c_int
    elif name == "mont_mul_lm":
        lib.lasso_mont_mul_lm.argtypes = [vp, vp, vp, i64, i64, ctypes.c_int,
                                          ctypes.c_int, vp]
        lib.lasso_mont_mul_lm.restype = ctypes.c_int
    elif name == "padd":
        lib.lasso_padd.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.lasso_padd.restype = ctypes.c_int
    elif name == "field_arith":
        lib.lasso_field_addsub.argtypes = [vp, vp, vp, i64, i64, i64, i64,
                                           i64, i64, ctypes.c_int,
                                           ctypes.c_int, vp]
        lib.lasso_field_sum.argtypes = [vp, vp, i64, i64, i64, i64, vp]
        lib.lasso_field_finish.argtypes = [vp, vp, i64, i64, ctypes.c_int, vp]
        for fn in (lib.lasso_field_addsub, lib.lasso_field_sum,
                   lib.lasso_field_finish):
            fn.restype = ctypes.c_int
    else:
        lib.lasso_keccak_f1600.argtypes = [vp, i64, vp]
        lib.lasso_keccak_f1600.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def _check_operand(x: torch.Tensor, what: str, align: int = 4) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 limbs, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.data_ptr() % align:
        raise ValueError(f"{what}: expected a {align}-byte aligned tensor")


# ---------------------------------------------------------------------------
# kernel wrappers (strict) and dispatchers
# ---------------------------------------------------------------------------

def mont_mul_cuda(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """Launch K1 on contiguous, 16-byte aligned int32 CUDA limbs: a [n, 16]
    and b [n, 16], or either one a single [16] (or [1, 16]) element
    broadcast to all n."""
    _check_operand(a, "mont_mul a", align=16)
    _check_operand(b, "mont_mul b", align=16)
    if a.device != b.device:
        raise ValueError("mont_mul: operands on different devices")
    if a.shape[-1] != W or b.shape[-1] != W:
        raise ValueError(f"mont_mul: limb axis must be {W}")
    na, nb = a.numel() // W, b.numel() // W
    n = max(na, nb)
    if na not in (1, n) or nb not in (1, n):
        raise ValueError(f"mont_mul: cannot pair {na} with {nb} elements")
    out = torch.empty((n, W), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    rc = _lib("mont_mul").lasso_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
        W if na == n else 0, W if nb == n else 0, FIELD_IDS[field],
        torch.cuda.current_stream(a.device).cuda_stream)
    _check_launch(rc, "mont_mul")
    launch_counts["mont_mul"] += 1
    _tracing.count("k1")
    return out


def _raw_stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on x's device, read anew on
    every call, without building a torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


_K2 = None  # K2's C entry, bound on first use
_K2_CONST = (W, 1)


def mont_mul_lm_cuda(a: torch.Tensor, b: torch.Tensor,
                     field: str) -> torch.Tensor:
    """Launch K2 on contiguous int32 CUDA limbs: a [K, 16, n] and b
    [K, 16, n], or either one a single [16, 1] element broadcast to every
    (k, column).  Returns [K, 16, n]."""
    global _K2
    _check_operand(a, "mont_mul_lm a")
    _check_operand(b, "mont_mul_lm b")
    if a.get_device() != b.get_device():
        raise ValueError("mont_mul_lm: operands on different devices")
    consts = int(a.shape == _K2_CONST) + 2 * int(b.shape == _K2_CONST)
    full = b if consts == 1 else a
    shape = full.shape
    if (consts == 3 or len(shape) != 3 or shape[1] != W
            or (consts == 0 and b.shape != shape)):
        raise ValueError(f"mont_mul_lm: expected [K, {W}, n] operands or a "
                         f"[{W}, 1] constant, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(full)
    k, _, n = shape
    if k * n == 0:
        return out
    if _K2 is None:
        _K2 = _lib("mont_mul_lm").lasso_mont_mul_lm
    rc = _K2(a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n, consts,
             FIELD_IDS[field], _raw_stream(a))
    _check_launch(rc, "mont_mul_lm")
    launch_counts["mont_mul_lm"] += 1
    _tracing.count("k2")
    return out


def padd_cuda(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Launch K3 on contiguous int32 CUDA points p, q [K, 4, 16, n]."""
    _check_operand(p, "padd p")
    _check_operand(q, "padd q")
    if p.device != q.device:
        raise ValueError("padd: operands on different devices")
    if p.dim() != 4 or p.shape[1:3] != (4, W) or q.shape != p.shape:
        raise ValueError(f"padd: expected equal [K, 4, {W}, n] points, got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    out = torch.empty_like(p)
    k, n = p.shape[0], p.shape[3]
    if k * n == 0:
        return out
    rc = _lib("padd").lasso_padd(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), k, n,
        torch.cuda.current_stream(p.device).cuda_stream)
    _check_launch(rc, "padd")
    launch_counts["padd"] += 1
    _tracing.count("k3")
    return out


_K4 = None  # K4's C entry, bound on first use
STATE_BYTES = 200


def keccak_cuda(states: torch.Tensor) -> torch.Tensor:
    """Launch K4 on contiguous int32 CUDA byte states [..., 200]: each
    state is permuted in place.  Returns `states`."""
    global _K4
    _check_operand(states, "keccak states")
    if states.dim() == 0 or states.shape[-1] != STATE_BYTES:
        raise ValueError(f"keccak: expected [..., {STATE_BYTES}] byte states, "
                         f"got {tuple(states.shape)}")
    count = states.numel() // STATE_BYTES
    if count == 0:
        return states
    if _K4 is None:
        _K4 = _lib("keccak").lasso_keccak_f1600
    rc = _K4(states.data_ptr(), count, _raw_stream(states))
    _check_launch(rc, "keccak")
    launch_counts["keccak"] += 1
    _tracing.count("k4")
    return states

_K5 = None  # K5's C entries (addsub, sum, finish), bound on first use
WIDE = W + 3  # limbs of a column sum's wide columns
MAX_WIDE = 2 * W + 1  # widest columns a finish takes


def _k5():
    global _K5
    if _K5 is None:
        lib = _lib("field_arith")
        _K5 = (lib.lasso_field_addsub, lib.lasso_field_sum,
               lib.lasso_field_finish)
    return _K5


def _batch_layout(shape, a: torch.Tensor, b: torch.Tensor):
    """The batch axes of `shape` (all but the limb axis), with a and b
    broadcast to it, as one strided [outer, inner] batch: (outer, inner,
    sa0, sa1, sb0, sb1) in int32 strides, 0 along broadcast axes.  None
    where the axes do not collapse to two or an operand's limbs are not
    its contiguous last axis."""
    sa, sb = a.stride(), b.stride()
    if sa[-1] != 1 or sb[-1] != 1 or a.shape[-1] != W or b.shape[-1] != W:
        return None
    nd = len(shape) - 1
    ash, bsh = a.shape, b.shape
    oa, ob = nd + 1 - len(ash), nd + 1 - len(bsh)
    groups = []
    size, ga, gb = 1, 0, 0  # the group being built, innermost first
    for d in range(nd - 1, -1, -1):
        n = shape[d]
        if n == 1:
            continue
        if n == 0:
            return 0, 1, 0, 0, 0, 0
        da = 0 if d < oa or ash[d - oa] == 1 else sa[d - oa]
        db = 0 if d < ob or bsh[d - ob] == 1 else sb[d - ob]
        if size == 1:
            size, ga, gb = n, da, db
        elif da == ga * size and db == gb * size:
            size *= n
        else:
            groups.append((size, ga, gb))
            size, ga, gb = n, da, db
    if len(groups) > 1:
        return None
    if groups:
        (inner, sa1, sb1), (outer, sa0, sb0) = groups[0], (size, ga, gb)
    else:
        inner, sa1, sb1, outer, sa0, sb0 = size, ga, gb, 1, 0, 0
    return outer, inner, sa0, sa1, sb0, sb1


def _aligned_pair(a, b, layout) -> bool:
    """Both operands 16-byte aligned, every stride a whole 16 bytes."""
    _, _, sa0, sa1, sb0, sb1 = layout
    return not ((a.data_ptr() | b.data_ptr()) & 15
                or (sa0 | sa1 | sb0 | sb1) & 3)


def _launch_addsub(a, b, shape, layout, sub: bool, field: str):
    outer, inner, sa0, sa1, sb0, sb1 = layout
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if outer * inner == 0:
        return out
    rc = _k5()[0](a.data_ptr(), b.data_ptr(), out.data_ptr(), outer, inner,
                  sa0, sa1, sb0, sb1, sub, FIELD_IDS[field], _raw_stream(a))
    _check_launch(rc, "field_addsub")
    launch_counts["field_addsub"] += 1
    _tracing.count("k5")
    return out


def add_sub_cuda(a: torch.Tensor, b: torch.Tensor, sub: bool,
                 field: str) -> torch.Tensor:
    """Launch K5's add (sub=False) or sub on int32 CUDA limbs of
    broadcastable shapes [..., 16]: limbs contiguous, 16-byte aligned, the
    batch axes of each operand a strided [outer, inner] view of it (a half
    view x[:, :h] of a contiguous [I, n, 16], one broadcast [16] element).
    Returns the contiguous [broadcast shape] result."""
    for x, what in ((a, "a"), (b, "b")):
        if not x.is_cuda:
            raise ValueError(f"field_addsub {what}: expected a CUDA tensor, "
                             f"got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"field_addsub {what}: expected int32 limbs, got "
                            f"{x.dtype}")
    if a.get_device() != b.get_device():
        raise ValueError("field_addsub: operands on different devices")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    layout = _batch_layout(shape, a, b)
    if layout is None or not _aligned_pair(a, b, layout):
        raise ValueError(
            f"field_addsub: operands {tuple(a.shape)}, {a.stride()} and "
            f"{tuple(b.shape)}, {b.stride()} are not two strided batch axes "
            f"of 16-byte aligned, contiguous {W}-limb elements")
    return _launch_addsub(a, b, shape, layout, sub, field)


def _sum_layout(x: torch.Tensor):
    """[n, ..., 16] as n rows of m column sets: (n, m, sn, sm) in int32
    strides, or None where the column axes do not collapse to one or the
    limbs are not the contiguous last axis."""
    if x.dim() < 2 or x.shape[-1] != W or x.stride(-1) != 1:
        return None
    n = x.shape[0]
    m, sm = 1, 0
    for d in range(x.dim() - 2, 0, -1):
        size = x.shape[d]
        if size == 1:
            continue
        if size == 0:
            return n, 0, 0, 0
        if m == 1:
            m, sm = size, x.stride(d)
        elif x.stride(d) == sm * m:
            m *= size
        else:
            return None
    return n, m, (x.stride(0) if n > 1 else 0), sm


def _aligned_sum(x, layout) -> bool:
    return not (x.data_ptr() & 15 or (layout[2] | layout[3]) & 3)


def _launch_sum(x, layout):
    n, m, sn, sm = layout
    out = torch.empty(x.shape[1:-1] + (WIDE,), dtype=torch.int64,
                      device=x.device)
    if m == 0:
        return out
    rc = _k5()[1](x.data_ptr(), out.data_ptr(), n, m, sn, sm, _raw_stream(x))
    _check_launch(rc, "field_sum")
    launch_counts["field_sum"] += 1
    _tracing.count("k5")
    return out


def sum_columns_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K5's column sum on int32 CUDA limbs [n, ..., 16]: limbs in
    [0, 2^16), contiguous and 16-byte aligned, the axes between the first
    and the last collapsing to one strided axis.  Returns the plain
    version's int64 wide columns [..., 19], limb for limb."""
    if not x.is_cuda:
        raise ValueError(f"field_sum: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"field_sum: expected int32 limbs, got {x.dtype}")
    layout = _sum_layout(x)
    if layout is None or not _aligned_sum(x, layout):
        raise ValueError(
            f"field_sum: {tuple(x.shape)}, {x.stride()} is not rows of "
            f"column sets of 16-byte aligned, contiguous {W}-limb elements")
    return _launch_sum(x, layout)


def finish_sum_cuda(wide: torch.Tensor, field: str) -> torch.Tensor:
    """Launch K5's finish on contiguous int64 CUDA wide columns [..., w],
    w <= 33, each set's value V < R*p and each column in [0, 2^48): the
    canonical Montgomery limbs [..., 16] of V mod p."""
    if not wide.is_cuda:
        raise ValueError(f"field_finish: expected a CUDA tensor, got "
                         f"{wide.device}")
    if wide.dtype != torch.int64 or not wide.is_contiguous():
        raise ValueError("field_finish: expected contiguous int64 columns")
    width = wide.shape[-1]
    if not 1 <= width <= MAX_WIDE:
        raise ValueError(f"field_finish: {width} columns, not 1 to {MAX_WIDE}")
    out = torch.empty(wide.shape[:-1] + (W,), dtype=torch.int32,
                      device=wide.device)
    m = out.numel() // W
    if m == 0:
        return out
    rc = _k5()[2](wide.data_ptr(), out.data_ptr(), m, width,
                  FIELD_IDS[field], _raw_stream(wide))
    _check_launch(rc, "field_finish")
    launch_counts["field_sum"] += 1
    _tracing.count("k5")
    return out


def _on_cpu(*xs) -> bool:
    devs = {x.device.type for x in xs}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"operands on mixed devices: {sorted(devs)}")


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """Montgomery product of broadcastable [..., 16] limbs: K1 for CUDA
    tensors, the plain version for CPU tensors."""
    if _on_cpu(a, b):
        return mont_mul_plain(a, b, field)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for s in shape[:-1]:
        n *= s

    def operand(x):
        if x.numel() == W:  # a broadcast constant: stride 0 in the kernel
            x = x.reshape(W).contiguous()
        else:
            x = x.expand(shape).contiguous().reshape(n, W)
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return mont_mul_cuda(operand(a), operand(b), field).reshape(shape)


def mont_mul_lm(a: torch.Tensor, b: torch.Tensor, field: str) -> torch.Tensor:
    """Montgomery product of broadcastable limb-major [..., 16, n] limbs:
    K2 for CUDA tensors, the plain version for CPU tensors.  Leading axes
    flatten to K, as in the reference's entry; a single [16, 1] element is
    read with stride 0.  Contiguous operands of one shape go to K2 as views,
    with no copy."""
    if not (a.is_cuda and b.is_cuda) and _on_cpu(a, b):
        return mont_mul_lm_plain(a, b, field)
    shape = a.shape
    if (b.shape == shape and len(shape) >= 3 and shape[-2] == W
            and a.is_contiguous() and b.is_contiguous()):
        if len(shape) == 3:
            return mont_mul_lm_cuda(a, b, field)
        flat = (-1, W, shape[-1])
        return mont_mul_lm_cuda(a.view(flat), b.view(flat), field).view(shape)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    k = 1
    for s in shape[:-2]:
        k *= s
    flat = (k, W, shape[-1])

    def operand(x):
        if x.numel() == W and shape[-1] != 1:  # a broadcast constant
            return x.reshape(W, 1).contiguous()
        return x.expand(shape).contiguous().reshape(flat)

    return mont_mul_lm_cuda(operand(a), operand(b), field).reshape(shape)


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Extended-point sum of broadcastable [..., 4, 16, n] points: K3 for
    CUDA tensors, the plain version for CPU tensors."""
    if _on_cpu(p, q):
        return padd_plain(p, q)
    shape = torch.broadcast_shapes(p.shape, q.shape)
    k = 1
    for s in shape[:-3]:
        k *= s
    flat = (k, 4, W, shape[-1])
    out = padd_cuda(p.expand(shape).contiguous().reshape(flat),
                    q.expand(shape).contiguous().reshape(flat))
    return out.reshape(shape)


def add_sub(a: torch.Tensor, b: torch.Tensor, sub: bool,
            field: str) -> torch.Tensor:
    """(a - b) if sub else (a + b) mod p of broadcastable int CUDA limbs
    [..., 16] through K5.  Strided and broadcast operands go to K5 as
    views; an operand whose batch axes do not collapse to two strided axes,
    or that is not 16-byte aligned, is copied first."""
    if not (a.is_cuda and b.is_cuda) or a.get_device() != b.get_device():
        raise ValueError(f"field_addsub: operands on {a.device} and "
                         f"{b.device}, expected one CUDA device")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        a, b = a.to(torch.int32), b.to(torch.int32)
    shape = a.shape
    if b.shape != shape:
        shape = torch.broadcast_shapes(shape, b.shape)
    layout = _batch_layout(shape, a, b)
    if layout is None or not _aligned_pair(a, b, layout):
        a, b = (x.expand(shape).contiguous() for x in (a, b))
        a, b = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))
        layout = _batch_layout(shape, a, b)
    return _launch_addsub(a, b, shape, layout, sub, field)


def sum_columns(x: torch.Tensor) -> torch.Tensor:
    """Wide int64 columns [..., 19] of the sums over axis 0 of int CUDA
    limbs [n, ..., 16] through K5, read in place where the column axes
    collapse to one strided axis and x is 16-byte aligned, else copied
    first."""
    if not x.is_cuda:
        raise ValueError(f"field_sum: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    layout = _sum_layout(x)
    if layout is None or not _aligned_sum(x, layout):
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        layout = _sum_layout(x)
    return _launch_sum(x, layout)


def finish_sum(wide: torch.Tensor, field: str) -> torch.Tensor:
    """Canonical Montgomery limbs [..., 16] of CUDA wide columns' values
    mod p: K5's REDC and product with R^2, in one launch."""
    return finish_sum_cuda(wide.to(torch.int64).contiguous(), field)
