"""Multi-scalar multiplication (Pippenger, small-scalar optimized; port of
ops/msm.py).

Same formulation as the JAX package:
  * unsigned digits over fat, equalized windows (window_plan);
  * bucket accumulation without scatter contention: sort each window's
    points by bucket id (torch.sort), then the blocked segmented reduction
    (_segmented_sum_blocked) walks `block` steps with every chunk in
    parallel, one curve add (kernel K3) per step;
  * bucket weighted sum sum_b (b+1)*B_b by the blocked suffix accumulation
    (_bucket_weighted_sum_blocked);
  * windows combined by Horner with c doublings per step;
  * for a fixed basis, the flat MSM over pre-doubled window bases
    (predoubled_windows, _msm_kernel_flat): no Horner and no host sync,
    for the device-transcript route's opening proofs.

Every function takes leading batch axes: the Hyrax row commits run all rows
and all windows through one sequence of curve adds, where the reference
vmaps.  The routing that decides which code computes each result is kept
exactly: MSMs of at most MSM_HOST_MAX points, and row batches of at most
4*MSM_HOST_MAX scalars, run on the native host Pippenger.

Results are group elements: the order of additions differs from the
reference's, so the projective representative may differ, and results are
compared as canonical (compressed) points, never as raw limbs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.curve.tcurve import (from_host_points, identity, padd,
                                          pdbl, pneg, pselect, to_host_point,
                                          to_host_points, tree_sum)
from lasso_tpu_torch.field.tfield import TFr, W, upload
from lasso_tpu_torch.utils.tracing import instrument


def window_plan(n: int, max_bits: int) -> tuple[int, int]:
    """(c, num_windows) for the unsigned-digit kernel: the widest window
    that keeps the bucket array below n, with digit widths equalized."""
    if n < 2:
        return 3, (max_bits + 2) // 3
    c_cap = min(16, max(3, n.bit_length() - 3))
    num_windows = -(-max_bits // c_cap)
    c = -(-max_bits // num_windows)
    return max(c, 3), num_windows


def _extract_digits(scalars, c: int, num_windows: int):
    """Unsigned base-2^c digits of canonical integer limbs [..., n, W].

    Returns bucket_ids [..., k, n] int64: digit-1, with sentinel 2^c - 1 for
    digit 0 (bucket array size 2^c: 2^c - 1 real buckets + sentinel)."""
    mask = (1 << c) - 1
    limb, shift, nxt = _digit_plan(c, num_windows, scalars.device)
    s = scalars.to(torch.int64)
    # window w: bits w*c.. of limb `limb`, then the next limb's low bits
    # (none past the top limb: `nxt` points at a zero column there)
    s = F.pad(s, (0, 1))
    digits = (((s[..., limb] >> shift) | (s[..., nxt] << (16 - shift)))
              & mask).movedim(-1, -2)  # [..., k, n] in [0, 2^c)
    return torch.where(digits == 0, mask, digits - 1)


_DIGIT_PLANS: dict[tuple, tuple] = {}


def _digit_plan(c: int, num_windows: int, device):
    """Per window: its first limb, the bit shift in it, and the limb after
    it (W, a zero column, past the top limb); on `device`, cached."""
    key = (c, num_windows, torch.device(device))
    got = _DIGIT_PLANS.get(key)
    if got is None:
        offs = [w * c for w in range(num_windows)]
        plan = np.array([[o // 16 for o in offs], [o % 16 for o in offs],
                         [min(o // 16 + 1, W) for o in offs]], dtype=np.int64)
        got = tuple(upload(plan, device))
        _DIGIT_PLANS[key] = got
    return got


def _scatter_points(buckets, idx, vals):
    """buckets[..., idx[..., j]] = vals[..., j] along the point axis, in
    place (buckets [..., 4, W, B]; idx [..., m]; vals [..., 4, W, m])."""
    full = idx[..., None, None, :].expand(vals.shape)
    buckets.scatter_(-1, full, vals)


def _segmented_sum_sorted(points, ids, num_buckets: int,
                          fixed: bool = False):
    """points [..., 4, W, n] sorted by ids [..., n]; per-bucket sums
    [..., 4, W, num_buckets+1] (the last slot is the sentinel bucket, to be
    dropped).  Segmented Hillis-Steele scan: rounds stop once no lane has a
    same-bucket partner at the current stride, which the host reads from
    the device each round; `fixed` runs all ceil(log2 n) strides instead
    (the extra ones are masked and change no value), with no host sync.
    The sentinel's run (zero digits, often the longest) is not summed."""
    n = points.shape[-1]
    lead = points.shape[:-3]
    dev = points.device
    idx = torch.arange(n, device=dev)
    stride = 1
    while stride < n:
        same = ((idx >= stride) & (torch.roll(ids, stride, dims=-1) == ids)
                & (ids != num_buckets))
        if not fixed and not bool(same.any()):
            break
        rolled = torch.roll(points, stride, dims=-1)
        points = pselect(same, padd(points, rolled), points)
        stride *= 2
    # the last element of each run holds the run total
    next_ids = torch.cat([ids[..., 1:], torch.full(lead + (1,), -1,
                                                   dtype=ids.dtype,
                                                   device=dev)], dim=-1)
    is_last = ids != next_ids
    scatter_ids = torch.where(is_last, ids, num_buckets)
    vals = pselect(is_last, points, identity(n, lead, dev))
    buckets = identity(num_buckets + 1, lead, dev).clone()
    _scatter_points(buckets, scatter_ids, vals)
    return buckets


def _segmented_sum_blocked(points, ids, num_buckets: int, block: int = 64):
    """Work-efficient segmented reduction of sorted runs.

    points [..., 4, W, n] sorted by ids [..., n]; returns per-bucket sums
    [..., 4, W, num_buckets+1] (last slot = sentinel, to be dropped).

    The array is viewed as G = n/block chunks of `block` consecutive
    elements, and one loop walks the block axis with ALL chunks in parallel
    (one padd per step at width G, n curve adds in total):
      * runs strictly interior to a chunk finish inside the loop and are
        scattered at the step where their id changes -- conflict-free, since
        a bucket is one contiguous run;
      * each chunk's leading and trailing partial runs (the only ones that
        can span chunks) go to a 2G-entry boundary array, still sorted,
        which the Hillis-Steele scan reduces in a few rounds.
    A bucket lands in exactly one of the two arrays, so one padd of the
    identity-padded arrays combines them exactly."""
    n = points.shape[-1]
    if n <= 2 * block:
        return _segmented_sum_sorted(points, ids, num_buckets)
    lead = points.shape[:-3]
    dev = points.device
    g = -(-n // block)
    if g * block != n:
        pad = g * block - n
        points = torch.cat([points, identity(pad, lead, dev)], dim=-1)
        ids = torch.cat([ids, torch.full(lead + (pad,), num_buckets,
                                         dtype=ids.dtype, device=dev)], dim=-1)
    pts4 = points.reshape(lead + (4, W, g, block))
    ids2 = ids.reshape(lead + (g, block))

    buckets = identity(num_buckets + 1, lead, dev).clone()
    ident_g = identity(g, lead, dev)
    acc = pts4[..., 0]
    acc_id = ids2[..., 0]
    pre = ident_g
    pre_id = torch.zeros_like(acc_id)
    have_pre = torch.zeros(acc_id.shape, dtype=torch.bool, device=dev)
    for j in range(1, block):
        cur = pts4[..., j]
        cid = ids2[..., j]
        same = cid == acc_id
        # interior-run emission: the id changed and the leading run was
        # already captured -> acc is a completed interior run
        emit = ~same & have_pre
        _scatter_points(buckets, torch.where(emit, acc_id, num_buckets),
                        pselect(emit, acc, ident_g))
        # capture the leading run at its first id change
        newly = ~same & ~have_pre
        pre = pselect(newly, acc, pre)
        pre_id = torch.where(newly, acc_id, pre_id)
        have_pre = have_pre | newly
        acc = pselect(same, padd(acc, cur), cur)
        acc_id = cid

    # boundary array: per chunk, (leading partial, trailing partial); a
    # single-run chunk contributes (whole sum, identity-with-same-id)
    pre_f = pselect(have_pre, pre, acc)
    pre_id_f = torch.where(have_pre, pre_id, acc_id)
    suf_f = pselect(have_pre, acc, ident_g)
    suf_id_f = torch.where(have_pre, acc_id, pre_id_f)
    boundary = torch.stack([pre_f, suf_f], dim=-1).reshape(
        lead + (4, W, 2 * g))
    bids = torch.stack([pre_id_f, suf_id_f], dim=-1).reshape(lead + (2 * g,))
    bbuckets = _segmented_sum_sorted(boundary, bids, num_buckets)
    return padd(buckets, bbuckets)


def _bucket_weighted_sum(buckets):
    """sum_b (b+1) * buckets[b] via suffix scan + tree sum ([..., 4, W, B])."""
    b = buckets.shape[-1]
    if b == 1:
        return buckets
    idx = torch.arange(b, device=buckets.device)
    x = buckets
    for i in range((b - 1).bit_length()):
        stride = 1 << i
        rolled = torch.roll(x, -stride, dims=-1)
        x = pselect(idx < (b - stride), padd(x, rolled), x)
    # x[i] = sum_{j >= i} buckets[j]; total = sum_i x[i]
    return tree_sum(x)


def _bucket_weighted_sum_blocked(buckets, block: int = 64):
    """sum_b (b+1) * buckets[b] ([..., 4, W, B]) in ~2B curve adds.

    View B as G2 chunks of `block`: one reverse loop computes, for every
    chunk in parallel, S_q = sum_r B_{q,r} and T_q = sum_r (r+1) B_{q,r};
    then total = block * sum_q q*S_q + sum_q T_q, where
    sum_q q*S_q = [weighted sum over the chunk sums] - sum_q S_q."""
    b = buckets.shape[-1]
    if b <= 2 * block or (block & (block - 1)):
        return _bucket_weighted_sum(buckets)
    lead = buckets.shape[:-3]
    dev = buckets.device
    g2 = -(-b // block)
    if g2 * block != b:
        buckets = torch.cat([buckets, identity(g2 * block - b, lead, dev)],
                            dim=-1)
    bk = buckets.reshape(lead + (4, W, g2, block))
    suf = identity(g2, lead, dev)
    tsum = suf
    for i in range(block):
        suf = padd(suf, bk[..., block - 1 - i])
        tsum = padd(tsum, suf)
    w1 = _bucket_weighted_sum(suf)            # sum_q (q+1) S_q
    qs = padd(w1, pneg(tree_sum(suf)))        # sum_q q * S_q
    for _ in range(block.bit_length() - 1):   # * block (a power of two)
        qs = pdbl(qs)
    return padd(qs, tree_sum(tsum))


def _msm_kernel(points, scalars, c: int, num_windows: int):
    """points [4, W, n] (extended, Montgomery limbs); scalars [..., n, W]
    canonical integer limbs.  Returns [..., 4, W, 1]."""
    n = points.shape[-1]
    lead = scalars.shape[:-2]
    num_buckets = (1 << c) - 1

    bucket_ids = _extract_digits(scalars, c, num_windows)  # [..., k, n]
    sorted_ids, order = torch.sort(bucket_ids, dim=-1, stable=True)
    # gather point-major rows ([n, 64] int32: contiguous 256 B per point)
    pts_pm = points.reshape(4 * W, n).t()
    sorted_pm = pts_pm[order.reshape(-1)].reshape(
        lead + (num_windows, n, 4 * W))
    sorted_pts = sorted_pm.movedim(-1, -2).reshape(
        lead + (num_windows, 4, W, n))

    seg = _segmented_sum_blocked(sorted_pts, sorted_ids, num_buckets)
    window_sums = _bucket_weighted_sum_blocked(seg[..., :num_buckets])
    # [..., k, 4, W, 1]; Horner from the top window down
    total = window_sums[..., num_windows - 1, :, :, :]
    for i in range(num_windows - 1):
        for _ in range(c):
            total = pdbl(total)
        total = padd(total, window_sums[..., num_windows - 2 - i, :, :, :])
    return total


# (c, num_windows) of _msm_kernel_flat for 253-bit scalars, whatever the
# number of bases n.  The flat MSM is a chain of curve adds:
# ceil(log2(num_windows * n)) scan steps over num_windows * n points, then
# 2c for the weighted sum of its 2^c - 1 buckets (unblocked up to 127).
# 7-bit windows are the widest that keep the buckets unblocked: 14 adds
# plus the scan of 37 * n points.  (The reference's window_plan gives
# 8-bit windows at n = 1026, whose 255 buckets take ~70 adds blocked;
# 5-bit windows save 4 adds a scan but widen it by 38%.)
FLAT_WINDOW_PLAN = (7, 37)


def predoubled_windows(points, c: int, num_windows: int):
    """[4, W, n] -> [4, W, num_windows * n]: slice w holds 2^(c*w) * P_j.

    Once per fixed basis (the caller caches it): every window's 2^(c*w)
    weight is folded into the basis, so `_msm_kernel_flat` needs no Horner
    combine, whose ~max_bits sequential doublings dominate a small
    full-width MSM."""
    slices = []
    cur = points
    for _ in range(num_windows):
        slices.append(cur)
        for _ in range(c):
            cur = pdbl(cur)
    return torch.cat(slices, dim=-1)


def _msm_kernel_flat(pd_points, scalars, c: int, num_windows: int):
    """MSM over pre-doubled window bases (predoubled_windows), with no host
    sync.  pd_points [4, W, num_windows * n]; scalars [..., n, W] canonical
    integer limbs.  Returns [..., 4, W, 1].

    All windows' (digit, pre-scaled point) pairs form one flat bucket
    problem: sort the num_windows * n pairs by digit, reduce the runs of
    equal digits, weighted-sum the 2^c - 1 buckets.  The runs reduce by the
    segmented scan, each stride one curve add over the whole array: on a
    card all ceil(log2 kn) strides, so the host never waits (at these
    latency-bound sizes 10 to 17 launches, where the blocked reduction
    takes about 70); on the CPU, where reading the result costs nothing,
    it stops at the longest run.  The reference's `_msm_kernel_flat_batch`
    (a vmap over a batch of scalar vectors) is this function with leading
    axes on `scalars`, which every reduction here takes."""
    kn = pd_points.shape[-1]
    n = scalars.shape[-2]
    lead = scalars.shape[:-2]
    assert kn == num_windows * n
    num_buckets = (1 << c) - 1
    ids = _extract_digits(scalars, c, num_windows).reshape(lead + (kn,))
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    pts_pm = pd_points.reshape(4 * W, kn).t()  # point-major rows
    sorted_pts = pts_pm[order.reshape(-1)].reshape(
        lead + (kn, 4 * W)).movedim(-1, -2).reshape(lead + (4, W, kn))
    seg = _segmented_sum_sorted(sorted_pts, sorted_ids, num_buckets,
                                fixed=sorted_pts.is_cuda)
    return _bucket_weighted_sum_blocked(seg[..., :num_buckets])


def _bits_of_col_max(col_max) -> int:
    val = 0
    for i, limb in enumerate(col_max):
        if limb:
            val = max(val, 16 * i + int(limb).bit_length())
    return max(val, 1)


def max_scalar_bits(scalar_int_limbs) -> int:
    """Exact max bit-width across scalars [..., W] (one small device->host
    copy): max_j (16*j + bitlen(max of limb column j))."""
    col_max = scalar_int_limbs.reshape(-1, W).amax(dim=0)
    return _bits_of_col_max(col_max.cpu().tolist())


# MSMs of at most this many points run on the native host Pippenger: they
# are latency bound, and a device pipeline costs more than the arithmetic.
MSM_HOST_MAX = 256

# Verifier C_LZ row combinations (poly/hyrax.py) at or below this many rows
# run on the host Pippenger.
VERIFY_CLZ_HOST_MAX = 8192


@instrument("msm_device")
def msm_device(points, scalars_mont, modulus_bits: int = 253,
               full_width: bool = False):
    """MSM with the reference's window policy.  points [4, W, n];
    `scalars_mont` [n, W] Montgomery Fr.  `full_width=True` skips the
    small-scalar width scan for callers whose scalars are field-sized.
    Returns a point [4, W, 1] on the points' device."""
    n = points.shape[-1]
    assert scalars_mont.shape[0] == n
    if n == 0:
        return identity(1, (), points.device)
    if n <= MSM_HOST_MAX:
        res = hostcurve.msm_host(to_host_points(points),
                                 TFr.decode(scalars_mont))
        return from_host_points([res], points.device)
    scalars_int = TFr.to_int_limbs(scalars_mont)
    max_bits = modulus_bits if full_width else max_scalar_bits(scalars_int)
    if max_bits > 60:
        max_bits = modulus_bits
    c, num_windows = window_plan(n, max_bits)
    return _msm_kernel(points, scalars_int, c, num_windows)


MSM_CHUNK = 1 << 20


@instrument("msm_chunks_device")
def msm_chunks_device(points, scalars_mont, modulus_bits: int = 253):
    """Streaming MSM for huge inputs: 2^20-point chunks through the kernel,
    partial results tree-added."""
    n = points.shape[-1]
    if n <= MSM_CHUNK:
        return msm_device(points, scalars_mont, modulus_bits)
    partials = [msm_device(points[..., start:start + MSM_CHUNK],
                           scalars_mont[start:start + MSM_CHUNK], modulus_bits)
                for start in range(0, n, MSM_CHUNK)]
    return tree_sum(torch.cat(partials, dim=-1))


def msm(points, scalars_mont) -> hostcurve.Point:
    """Device MSM returning a host Point."""
    return to_host_point(msm_chunks_device(points, scalars_mont))


# Column cap for the batched row MSM: wider matrices split into column
# chunks whose per-row partial points are tree-added (Pippenger is additive
# over any column partition, so results are the same group elements).
MSM_BATCH_COL_MAX = 1 << 12


@instrument("msm_batch_device")
def msm_batch_device(points, scalars_mont_rows, modulus_bits: int = 253,
                     row_chunk: int = 128):
    """Many MSMs sharing one basis (the Hyrax row-commit shape).

    points: [4, W, n]; scalars_mont_rows: [rows, n, W] Montgomery Fr.
    Returns [rows, 4, W, 1]."""
    rows, n, _ = scalars_mont_rows.shape
    dev = points.device
    if n == 0 or rows == 0:
        return identity(1, (rows,), dev)
    if n > MSM_BATCH_COL_MAX:
        partials = [
            msm_batch_device(
                points[..., start:start + MSM_BATCH_COL_MAX],
                scalars_mont_rows[:, start:start + MSM_BATCH_COL_MAX],
                modulus_bits, row_chunk)
            for start in range(0, n, MSM_BATCH_COL_MAX)]
        return tree_sum(torch.cat(partials, dim=-1))
    if rows * n <= 4 * MSM_HOST_MAX:
        host_pts = to_host_points(points)
        flat = TFr.decode(scalars_mont_rows.reshape(rows * n, W))
        res = [hostcurve.msm_host(host_pts, flat[i * n:(i + 1) * n])
               for i in range(rows)]
        # [rows, 4, W, 1] to match the device branch
        return from_host_points(res, dev).movedim(-1, 0)[..., None]

    # canonical-limb conversion per row chunk; the width scan reads the
    # per-limb column maxima once
    chunks = [TFr.to_int_limbs(scalars_mont_rows[start: start + row_chunk])
              for start in range(0, rows, row_chunk)]
    col_max = torch.stack([ch.reshape(-1, W).amax(dim=0) for ch in chunks])
    max_bits = _bits_of_col_max(col_max.amax(dim=0).cpu().tolist())
    if max_bits > 60:
        max_bits = modulus_bits
    c, num_windows = window_plan(n, max_bits)
    return torch.cat([_msm_kernel(points, ch, c, num_windows)
                      for ch in chunks], dim=0)
