"""Batched twisted Edwards curve ops on tensors, limb-major layout (port of
curve/jcurve.py).

Points are int32 tensors [..., 4, W, n]: extended coordinates (X, Y, Z, T)
over the base field, each coordinate W=16 Montgomery limbs, with the batch
of points on the last axis.  This is the JAX package's layout; kernel K3
(ops/field_cuda.py) reads it directly, neighbouring points on neighbouring
addresses.

Because a is a square and d a non-square for ark-curve25519, the unified
hwcd addition law is complete: P+P, P+identity and P+(-P) all go through the
same formula, so bucket accumulation needs no exceptional cases and masking
with the identity point is always safe.

Two configurations, chosen as the reference chooses them
(LASSO_TPU_PALLAS_PADD, read once):
  * fused (the default): one kernel K3 per group op; `pdbl` is `padd(P, P)`;
  * unfused (LASSO_TPU_PALLAS_PADD=0 or off): the reference's stacked-mul
    formulas, three limb-major products (kernel K2) per add, and the
    dedicated dbl-2008-hwcd doubling.
Both give the same group elements; their projective limbs differ for
doublings, so callers compare points canonically.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.field import constants as K
from lasso_tpu_torch.field.host import Fp as HostFp
from lasso_tpu_torch.field.tfield import TFp, W, pack_int
from lasso_tpu_torch.ops import field_cuda

# identity (0 : 1 : 1 : 0) in Montgomery form, limb-major [4, W, 1]
_ONE_M = np.asarray(TFp.mont_one, dtype=np.int32).reshape(W, 1)
_ZERO = np.zeros((W, 1), dtype=np.int32)
IDENTITY = np.stack([_ZERO, _ONE_M, _ONE_M, _ZERO])
# curve constants a and d in Montgomery form, limb-major [W, 1]
_A_M = pack_int(HostFp.to_mont(K.CURVE_A)).astype(np.int32).reshape(W, 1)
_D_M = pack_int(HostFp.to_mont(K.CURVE_D)).astype(np.int32).reshape(W, 1)

_FUSED_PADD: bool | None = None


def _use_fused_padd() -> bool:
    """The fused add (K3) unless LASSO_TPU_PALLAS_PADD is 0 or off, read
    once per process (or after set_fused_padd(None))."""
    global _FUSED_PADD
    if _FUSED_PADD is None:
        env = os.environ.get("LASSO_TPU_PALLAS_PADD", "auto")
        _FUSED_PADD = env not in ("0", "off")
    return _FUSED_PADD


def set_fused_padd(fused: bool | None) -> None:
    """Select the fused (True) or unfused (False) curve path for this
    process; None goes back to reading LASSO_TPU_PALLAS_PADD."""
    global _FUSED_PADD
    _FUSED_PADD = fused


def identity(n=1, lead=(), device="cpu") -> torch.Tensor:
    """Identity points: [*lead, 4, W, n]."""
    return TFp.const(IDENTITY, device).expand(tuple(lead) + (4, W, n))


def padd(p, q) -> torch.Tensor:
    """Unified extended twisted Edwards addition (add-2008-hwcd).  Fused:
    kernel K3 for CUDA tensors, its plain version for CPU tensors;
    unfused: _padd_unfused."""
    if _use_fused_padd():
        return field_cuda.padd(p, q)
    return _padd_unfused(p, q)


def pdbl(p) -> torch.Tensor:
    """Doubling: the complete unified addition (P+P) when fused, the
    dedicated dbl-2008-hwcd formulas (_pdbl_unfused) otherwise."""
    if _use_fused_padd():
        return padd(p, p)
    return _pdbl_unfused(p)


def _coords(p):
    return p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :], p[..., 3, :, :]


def _padd_unfused(p, q) -> torch.Tensor:
    """add-2008-hwcd as three stacked limb-major products (port of
    jcurve._padd_xla): 4 + 3 + 4 field products in three TFp.mul_lm calls."""
    shape = torch.broadcast_shapes(p.shape, q.shape)
    x1, y1, z1, t1 = _coords(p.expand(shape))
    x2, y2, z2, t2 = _coords(q.expand(shape))
    fadd, fsub, fmul = TFp.add_lm, TFp.sub_lm, TFp.mul_lm

    s1 = fadd(x1, y1)
    s2 = fadd(x2, y2)
    a_, b_, tt, s = fmul(torch.stack([x1, y1, t1, s1]),
                         torch.stack([x2, y2, t2, s2]))
    consts = torch.stack([TFp.const(_D_M, p.device).expand(tt.shape),
                          TFp.const(_A_M, p.device).expand(a_.shape), z2])
    c_, a_a, d_ = fmul(torch.stack([tt, a_, z1]), consts)
    e = fsub(fsub(s, a_), b_)
    f = fsub(d_, c_)
    g = fadd(d_, c_)
    h = fsub(b_, a_a)
    w = fmul(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return w.movedim(0, -3)


def _pdbl_unfused(p) -> torch.Tensor:
    """dbl-2008-hwcd (port of jcurve._pdbl_xla): three TFp.mul_lm calls,
    the middle one against the broadcast constant a."""
    x1, y1, z1, _ = _coords(p)
    fadd, fsub, fmul = TFp.add_lm, TFp.sub_lm, TFp.mul_lm

    s1 = fadd(x1, y1)
    u = torch.stack([x1, y1, z1, s1])
    a_, b_, zz, s2 = fmul(u, u)
    a_a = fmul(a_, TFp.const(_A_M, p.device))
    c_ = fadd(zz, zz)
    e = fsub(fsub(s2, a_), b_)
    g = fadd(a_a, b_)
    f = fsub(g, c_)
    h = fsub(a_a, b_)
    w = fmul(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return w.movedim(0, -3)


def pneg(p) -> torch.Tensor:
    x, y, z, t = p.unbind(-3)
    return torch.stack([TFp.neg_lm(x), y, z, TFp.neg_lm(t)], dim=-3)


def pselect(mask, p, q) -> torch.Tensor:
    """mask [..., n] bool -> p where true else q (points [..., 4, W, n])."""
    return torch.where(mask[..., None, None, :], p, q)


def tree_sum(points) -> torch.Tensor:
    """Sum points along the batch axis: [..., 4, W, n] -> [..., 4, W, 1],
    by halving rounds of one padd each (identity-padded to a power of two).
    The grouping differs from the reference's roll-based rounds, which
    changes the projective representative but not the point."""
    n = points.shape[-1]
    lead = points.shape[:-3]
    if n == 0:
        return identity(1, lead, points.device)
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        points = torch.cat(
            [points, identity(pow2 - n, lead, points.device)], dim=-1)
    while points.shape[-1] > 1:
        half = points.shape[-1] // 2
        points = padd(points[..., :half], points[..., half:])
    return points


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def from_host_points(points: list[hostcurve.Point], device) -> torch.Tensor:
    """Host points -> [4, W, n] tensor (normalized to Z=1 first so the
    encode is cheap and T = X*Y)."""
    n = len(points)
    zinvs = HostFp.batch_inv([p.z for p in points])
    flat = []
    for p, zi in zip(points, zinvs):
        x = p.x * zi % HostFp.p
        y = p.y * zi % HostFp.p
        flat.extend((x, y, 1, x * y % HostFp.p))
    enc = TFp.encode_ints(flat, device)  # [4n, W]
    return enc.reshape(n, 4, W).permute(1, 2, 0).contiguous()


def to_host_points(arr) -> list[hostcurve.Point]:
    """[.., 4, W, n] -> host points (leading dims flattened batch-first)."""
    n = arr.shape[-1]
    flat = arr.reshape(-1, 4, W, n).movedim(-1, 1).reshape(-1, W)
    vals = TFp.decode(flat)
    return [hostcurve.Point(vals[i], vals[i + 1], vals[i + 2], vals[i + 3])
            for i in range(0, len(vals), 4)]


def to_host_point(arr) -> hostcurve.Point:
    return to_host_points(arr.reshape(4, W, -1))[0]


# ark serialize_compressed on device --------------------------------------

_HALF_P1 = K.limbs_of((HostFp.p + 1) // 2)


def affine_int_limbs_device(pts):
    """[4, W, n] extended Montgomery points -> (xa, ya) canonical 16-bit
    int limbs [n, W] of the affine coordinates (sync-free Fermat Z-inverse).
    """
    xy_m = pts[:2].movedim(-1, -2)  # [2, n, W] Montgomery
    zinv = TFp.inv_device(pts[2].movedim(-1, -2))
    xa, ya = TFp.to_int_limbs(TFp.mul(xy_m, zinv[None]))  # canonical limbs
    return xa, ya


def compress_affine_bytes_device(xa, ya) -> torch.Tensor:
    """Canonical affine int limbs [n, W] -> [n, 32] int32 compressed bytes,
    byte-exact with host Point.to_compressed_bytes (ark twisted Edwards:
    canonical-LE y with the 'x is negative' flag in the top bit; 'negative'
    means x >= (p+1)/2, evaluated limb-lexicographically)."""
    half = TFp.const(_HALF_P1, xa.device)
    ge = torch.zeros(xa.shape[:-1], dtype=torch.bool, device=xa.device)
    decided = torch.zeros_like(ge)
    for i in range(W - 1, -1, -1):
        gt = xa[..., i] > half[i]
        lt = xa[..., i] < half[i]
        ge = ge | (~decided & gt)
        decided = decided | gt | lt
    ge = ge | ~decided  # x == (p+1)/2 is negative too

    lo = ya & 0xFF
    hi = (ya >> 8) & 0xFF
    by = torch.stack([lo, hi], dim=-1).reshape(ya.shape[:-1] + (32,))
    by[..., 31] |= ge.to(torch.int32) << 7
    return by


def compress_points_device(pts) -> torch.Tensor:
    """[4, W, n] extended Montgomery points -> [n, 32] compressed bytes."""
    return compress_affine_bytes_device(*affine_int_limbs_device(pts))
