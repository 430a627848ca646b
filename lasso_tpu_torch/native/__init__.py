"""ctypes bindings for the native host crypto core (native/host_crypto.cpp).

The library is built with g++ on first use into the port's git-ignored
build directory (lasso_tpu_torch/build/), keyed by the source's hash and the
host CPU, since it is compiled with -march=native.  A failed build raises:
this binding never falls back to the pure-Python oracles itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_HERE, "..", "..", "native",
                                    "host_crypto.cpp"))
BUILD_DIR = os.path.abspath(os.path.join(_HERE, "..", "build"))

_lib = None


class NativeBuildError(RuntimeError):
    """The native host library could not be built or loaded."""


def _build_key() -> str:
    """Source content hash + host CPU tag (the build uses -march=native)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(platform.machine().encode())
    h.update(platform.processor().encode())
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    h.update(line)
                    break
    except OSError:
        pass
    return h.hexdigest()[:16]


def _build(so_path: str) -> None:
    """Compile into a temporary file, then rename: concurrent test workers
    may build at once, and a half-written library must never be loaded."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o",
             tmp], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed on {_SRC}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    so_path = os.path.join(BUILD_DIR, f"libhostcrypto-{_build_key()}.so")
    if not os.path.exists(so_path):
        _build(so_path)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {so_path}: {e}") from e

    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.keccak_f1600.argtypes = [u8p]
    lib.keccak_f1600.restype = None
    lib.chacha_block.argtypes = [u32p, ctypes.c_uint64, u32p, ctypes.c_int,
                                 u32p]
    lib.chacha_block.restype = None
    lib.set_curve_ctx.argtypes = [u64p, ctypes.c_uint64, u64p, u64p, u64p]
    lib.set_curve_ctx.restype = None
    lib.point_add.argtypes = [u64p, u64p, u64p]
    lib.point_add.restype = None
    lib.point_mul.argtypes = [u64p, u64p, u64p]
    lib.point_mul.restype = None
    lib.fold_points.argtypes = [u64p, ctypes.c_size_t, u64p, u64p, u64p]
    lib.fold_points.restype = None
    lib.msm.argtypes = [u64p, u64p, ctypes.c_size_t, u64p]
    lib.msm.restype = None

    from lasso_tpu_torch.field import constants as K

    p = K.P
    n0 = (-pow(p, -1, 1 << 64)) % (1 << 64)
    r2 = pow(2, 512, p)
    lib.set_curve_ctx(
        _u64arr(_int_to_u64s(p)), ctypes.c_uint64(n0),
        _u64arr(_int_to_u64s(r2)), _u64arr(_int_to_u64s(K.CURVE_A % p)),
        _u64arr(_int_to_u64s(K.CURVE_D % p)))
    return lib


def _get():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _u64arr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _int_to_u64s(v: int, words: int = 4) -> np.ndarray:
    return np.array([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(words)],
                    dtype=np.uint64)


def _u64s_to_int(a: np.ndarray) -> int:
    return sum(int(w) << (64 * i) for i, w in enumerate(a))


def available() -> bool:
    """True once the library is loaded; raises NativeBuildError otherwise."""
    _get()
    return True


# -- keccak / chacha ---------------------------------------------------------

def keccak_f1600(state: bytearray) -> bool:
    """In-place permutation of a 200-byte state."""
    buf = (ctypes.c_uint8 * 200).from_buffer(state)
    _get().keccak_f1600(buf)
    return True


def chacha_block(key_words, counter: int, nonce_words, rounds: int):
    key = np.asarray(key_words, dtype=np.uint32)
    nonce = np.asarray(list(nonce_words) + [0, 0], dtype=np.uint32)[:2]
    out = np.empty(16, dtype=np.uint32)
    _get().chacha_block(
        key.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_uint64(counter),
        nonce.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int(rounds),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return [int(x) for x in out]


# -- curve -------------------------------------------------------------------

def _pack_points(points) -> np.ndarray:
    out = np.empty((len(points), 16), dtype=np.uint64)
    for i, pt in enumerate(points):
        out[i, 0:4] = _int_to_u64s(pt.x)
        out[i, 4:8] = _int_to_u64s(pt.y)
        out[i, 8:12] = _int_to_u64s(pt.z)
        out[i, 12:16] = _int_to_u64s(pt.t)
    return out


def _unpack_point(a: np.ndarray):
    from lasso_tpu_torch.curve.host import Point

    return Point(_u64s_to_int(a[0:4]), _u64s_to_int(a[4:8]),
                 _u64s_to_int(a[8:12]), _u64s_to_int(a[12:16]))


def point_mul(pt, k: int):
    p = _pack_points([pt])[0]
    kk = _int_to_u64s(k)
    out = np.empty(16, dtype=np.uint64)
    _get().point_mul(_u64arr(p), _u64arr(kk), _u64arr(out))
    return _unpack_point(out)


def msm(points, scalars):
    pts = _pack_points(points)
    sc = np.empty((len(scalars), 4), dtype=np.uint64)
    for i, s in enumerate(scalars):
        sc[i] = _int_to_u64s(s)
    out = np.empty(16, dtype=np.uint64)
    _get().msm(_u64arr(pts), _u64arr(sc), ctypes.c_size_t(len(points)),
               _u64arr(out))
    return _unpack_point(out)


def fold_points(g_points, u: int, u_inv: int):
    """[g_lo | g_hi] -> g_lo*u_inv + g_hi*u elementwise (bullet basis fold)."""
    n_half = len(g_points) // 2
    pts = _pack_points(g_points)
    out = np.empty((n_half, 16), dtype=np.uint64)
    _get().fold_points(_u64arr(pts), ctypes.c_size_t(n_half),
                       _u64arr(_int_to_u64s(u)), _u64arr(_int_to_u64s(u_inv)),
                       _u64arr(out))
    return [_unpack_point(out[i]) for i in range(n_half)]
