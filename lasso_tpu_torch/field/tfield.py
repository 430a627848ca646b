"""Batched prime-field arithmetic on PyTorch tensors (port of field/jfield.py).

Field elements are tensors of 16 little-endian 16-bit limbs held in int32,
in Montgomery form (value * 2^256 mod p), canonical (< p): the JAX package's
layout, so any tensor here compares limb for limb with the reference's.
Arithmetic on the torch side runs in int64 (a CPU build of torch has no
uint32 add, shift or comparison).

`mul` is the Montgomery product of ops/field_cuda.py: the hand-written CUDA
kernel K1 for CUDA tensors, its plain PyTorch version for CPU tensors;
`mul_lm` is the same product on limb-major tensors, through kernel K2.
`add`, `sub`, `neg`, `sum_columns` and `finish_sum` take kernel K5 for CUDA
tensors (one launch a call) and the plain PyTorch code here for CPU
tensors (`_add_plain`, `_sub_plain`, `_sum_columns_plain`,
`_finish_sum_plain`), as it is plain XLA in the reference.  The rest
(`canon_wide`, the REDC of the plain product) is plain PyTorch.

Carry and borrow chains use a carry-lookahead over the limb axis instead of
a 16-step ripple: for limbs that each emit at most one carry (or borrow),
"generate" and "propagate" bits are packed into one int64 per element and
the carry into every limb comes out of one integer addition,
C = ((G|P) + G) ^ (G|P) ^ G.  That is ~15 tensor ops per chain instead of
~50, which is what the per-op launch cost on the card pays for.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lasso_tpu_torch.field import constants as K
from lasso_tpu_torch.field.host import Fp as HostFp
from lasso_tpu_torch.field.host import Fr as HostFr
from lasso_tpu_torch.field.host import HostField

W = K.NUM_LIMBS  # 16 limbs
B = K.LIMB_BITS  # 16 bits
MASK = K.LIMB_MASK


# ---------------------------------------------------------------------------
# packing helpers (host <-> limb arrays)
# ---------------------------------------------------------------------------

def pack_int(x: int) -> np.ndarray:
    return np.array(K.limbs_of(x), dtype=np.uint32)


def pack_ints(xs) -> np.ndarray:
    out = np.zeros((len(xs), W), dtype=np.uint32)
    for i, x in enumerate(xs):
        v = int(x)
        for j in range(W):
            out[i, j] = (v >> (B * j)) & MASK
    return out


def pack_u64_array(xs: np.ndarray) -> np.ndarray:
    """Vectorized packing of uint64 values into [n, 16] limb arrays."""
    xs = np.asarray(xs, dtype=np.uint64)
    out = np.zeros(xs.shape + (W,), dtype=np.uint32)
    for j in range(4):
        out[..., j] = (xs >> np.uint64(B * j)).astype(np.uint32) & MASK
    return out


def unpack_ints(arr) -> list[int]:
    """[..., 16] limbs (numpy or tensor) -> Python ints, batch-first."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.ascontiguousarray(np.asarray(arr).reshape(-1, W), dtype="<u2")
    raw = flat.tobytes()
    step = 2 * W
    return [int.from_bytes(raw[i: i + step], "little")
            for i in range(0, len(raw), step)]


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array as a tensor on `device`.  To a card the copy
    goes through pinned memory on the current stream, so the host does not
    wait for it (the device-transcript rounds run without a host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking for
    it without a card raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return device


def _as_tensor(x, device) -> torch.Tensor:
    return upload(np.asarray(x).astype(np.int32), device)


# ---------------------------------------------------------------------------
# limb helpers (int64 on the last axis)
# ---------------------------------------------------------------------------

_POW2: dict[torch.device, torch.Tensor] = {}


def _pow2(device) -> torch.Tensor:
    got = _POW2.get(device)
    if got is None:
        got = torch.tensor([1 << j for j in range(2 * W + 2)],
                           dtype=torch.int64, device=device)
        _POW2[device] = got
    return got


def _lookahead(gen, prop):
    """Carries into each limb of a chain with per-limb generate/propagate
    flags (bool [..., k], mutually exclusive), k <= 34.

    Returns (carry_in [..., k] int64 in {0, 1}, carry_out [...] in {0, 1}).
    The recurrence c_j = g_{j-1} | (p_{j-1} & c_{j-1}) is the carry chain of
    the binary sum (G|P) + G, so the carries are ((G|P) + G) ^ (G|P) ^ G."""
    k = gen.shape[-1]
    w = _pow2(gen.device)[:k]
    g = (gen.to(torch.int64) * w).sum(-1)
    a = g | (prop.to(torch.int64) * w).sum(-1)
    c = (a + g) ^ a ^ g
    carry_in = (c[..., None] >> torch.arange(k, device=gen.device)) & 1
    return carry_in, (c >> k) & 1


def _ripple_add(s):
    """Normalize limbs s in [0, 2^17 - 2] to [0, 2^16): (limbs, carry_out)."""
    cin, cout = _lookahead(s > MASK, s == MASK)
    return (s + cin) & MASK, cout


def _ripple_sub(d):
    """Normalize signed limbs d in [-(2^16 - 1), 2^16 - 1] (a limbwise
    difference) to [0, 2^16): (limbs, borrow_out)."""
    bin_, bout = _lookahead(d < 0, d == 0)
    return (d - bin_) & MASK, bout


def _split_shift(cols):
    """Value-preserving rewrite of non-negative int64 columns with each limb
    below 2^16 + (max column >> 16), one limb wider."""
    return F.pad(cols & MASK, (0, 1)) + F.pad(cols >> B, (1, 0))


def _normalize(cols, width: int):
    """Non-negative int64 columns (each < 2^48) -> canonical 16-bit limbs,
    truncated to `width` limbs (the caller guarantees the value fits)."""
    for _ in range(3):  # < 2^48 -> < 2^32 + 2^16 -> <= 2^17 -> <= 2^16 + 1
        cols = _split_shift(cols)
    limbs, _ = _ripple_add(cols)
    return limbs[..., :width]


def _cond_sub(x, m):
    """x - m if x >= m else x, for canonical int64 limbs x, constant m."""
    d, borrow = _ripple_sub(x - m)
    return torch.where((borrow == 0)[..., None], d, x)


def _add_plain(a, b, c: "_Consts"):
    s, _ = _ripple_add(a.to(torch.int64) + b.to(torch.int64))
    return _cond_sub(s, c.p64).to(torch.int32)


def _sub_plain(a, b, c: "_Consts"):
    d, borrow = _ripple_sub(a.to(torch.int64) - b.to(torch.int64))
    back, _ = _ripple_add(d + c.p64)
    return torch.where((borrow == 1)[..., None], back, d).to(torch.int32)


def _product_columns(a, b):
    """Schoolbook columns of a*b: [..., 2W+1] int64, each < 2^36."""
    prod = a.to(torch.int64)[..., :, None] * b.to(torch.int64)[..., None, :]
    batch = prod.shape[:-2]
    # shear: row i lands at column offset i (pad each row to width 2W+1,
    # flatten, re-view at width 2W)
    padded = F.pad(prod, (0, W + 1)).reshape(batch + (W * (2 * W + 1),))
    cols = padded[..., : W * 2 * W].reshape(batch + (W, 2 * W)).sum(-2)
    return F.pad(cols, (0, 1))


def _mont_redc(col, c: "_Consts"):
    """Montgomery reduction of non-negative int64 columns [..., <= 2W+1]
    (value < R*p, each column < 2^40) -> canonical int64 limbs [..., W]."""
    width = col.shape[-1]
    # columns first, so each step reads and writes whole rows (fewer and
    # cheaper tensor ops on small batches)
    t = F.pad(col.to(torch.int64), (0, 2 * W + 1 - width)).movedim(-1, 0)
    t = t.contiguous()
    p = c.p64.reshape((W,) + (1,) * (t.dim() - 1))
    rows = t.unbind(0)
    for i in range(W):
        m = (rows[i] * c.n0inv) & MASK
        t[i: i + W] += m * p
        # t_i is now a multiple of 2^16: only its carry survives
        rows[i + 1].add_(rows[i] >> B)
    res = _normalize(t[W:].movedim(0, -1), W)  # < 2p < 2^256
    return _cond_sub(res, c.p64)


# at most this many products on the CPU go through Python ints
SMALL_PRODUCTS = 32


def _mont_mul_ints(a, b, c: "_Consts"):
    """a*b*2^-256 mod p over Python ints, product by product."""
    a, b = torch.broadcast_tensors(a, b)
    out = [x * y * c.r_inv % c.p
           for x, y in zip(unpack_ints(a), unpack_ints(b))]
    raw = b"".join(v.to_bytes(2 * W, "little") for v in out)
    limbs = np.frombuffer(raw, dtype="<u2").astype(np.int32)
    return torch.from_numpy(limbs).reshape(a.shape)


def mont_mul_limbs(a, b, c: "_Consts"):
    """Plain Montgomery product a*b*2^-256 mod p of canonical limbs.  A few
    products on the CPU take Python ints: each of the limb arithmetic's
    ~100 tensor ops costs more there than a whole product in ints."""
    if (a.device.type == "cpu" and a.numel() <= SMALL_PRODUCTS * W
            and b.numel() <= SMALL_PRODUCTS * W):
        return _mont_mul_ints(a, b, c)
    return _mont_redc(_product_columns(a, b), c).to(torch.int32)


# ---------------------------------------------------------------------------
# field object
# ---------------------------------------------------------------------------

class _Consts:
    """A field's constants as tensors on one device."""

    def __init__(self, f: "TField", device):
        self.device = device
        self.zero = torch.zeros(W, dtype=torch.int32, device=device)
        self.p64 = torch.tensor(f.p_limbs, dtype=torch.int64, device=device)
        self.p_shifts = [torch.tensor(s, dtype=torch.int64, device=device)
                         for s in f.p_shifts]
        self.n0inv = f.n0inv
        self.p = f.host.p
        self.r_inv = f.host.r_inv
        self.r2 = _as_tensor(f.r2_limbs, device)
        self.one = _as_tensor(f.one_limbs, device)
        self.mont_one = _as_tensor(f.mont_one, device)


def _window_chain(e: int, k: int) -> list[tuple[int, int]]:
    """Left-to-right sliding-window exponentiation of a constant e >= 1:
    steps (squarings, odd digit or 0) that take acc from the top window's
    odd power to x^e, digits below 2^k.  The first step has no squarings."""
    steps = []
    i = e.bit_length() - 1
    pending = 0  # squarings owed before the next digit
    while i >= 0:
        if not (e >> i) & 1:
            pending += 1
            i -= 1
            continue
        j = max(i - k + 1, 0)
        while not (e >> j) & 1:  # the window ends on a set bit
            j += 1
        digit = (e >> j) & ((1 << (i - j + 1)) - 1)
        steps.append((pending + (i - j + 1) if steps else 0, digit))
        pending = 0
        i = j - 1
    if pending:
        steps.append((pending, 0))
    return steps


class TField:
    """Batched field ops over a fixed modulus on [..., 16] int32 tensors."""

    def __init__(self, host: HostField, name: str):
        self.host = host
        self.name = name
        p = host.p
        self.p_limbs = tuple(K.limbs_of(p))
        self.n0inv = (-pow(p, -1, 1 << B)) % (1 << B)
        # shifted moduli for wide canonicalization (value < 2^256 <= 16p)
        self.p_shifts = tuple(tuple(K.limbs_of(p << k)) for k in (3, 2, 1, 0)
                              if (p << k) < (1 << 256))

        self.r2_limbs = pack_int(host.r2)  # R^2 mod p (for encoding)
        # R^3 mod p (reducing a 512-bit challenge on device)
        self.r3_limbs = pack_int(host.r2 * host.r % p)
        self.one_limbs = pack_int(1)  # literal 1 (for decoding)
        self.mont_one = pack_int(host.r % p)  # field one in Montgomery form
        self._consts: dict[torch.device, _Consts] = {}
        self._const_cache: dict[tuple, torch.Tensor] = {}

        # p-2 as a sliding-window chain for Fermat inversion on device
        self._inv_chain = _window_chain(p - 2, 4)

    def consts(self, device) -> _Consts:
        device = torch.device(device)
        got = self._consts.get(device)
        if got is None:
            got = _Consts(self, device)
            self._consts[device] = got
        return got

    def const(self, limbs, device) -> torch.Tensor:
        """A constant limb array (numpy) as an int32 tensor on `device`,
        cached so repeated constants cost no host->device copy."""
        arr = np.asarray(limbs)
        key = (arr.tobytes(), arr.shape, torch.device(device))
        got = self._const_cache.get(key)
        if got is None:
            got = _as_tensor(arr, device)
            self._const_cache[key] = got
        return got

    def _tensor_like(self, x, like: torch.Tensor) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return self.const(x, like.device)

    # -- elementwise ------------------------------------------------------------
    def add(self, a, b) -> torch.Tensor:
        """(a + b) mod p: K5 for CUDA tensors, the plain version for CPU
        tensors."""
        b = self._tensor_like(b, a)
        if a.is_cuda or b.is_cuda:
            from lasso_tpu_torch.ops import field_cuda
            return field_cuda.add_sub(a, b, False, self.name)
        return _add_plain(a, b, self.consts(a.device))

    def sub(self, a, b) -> torch.Tensor:
        """(a - b) mod p: K5 for CUDA tensors, the plain version for CPU
        tensors."""
        b = self._tensor_like(b, a)
        if a.is_cuda or b.is_cuda:
            from lasso_tpu_torch.ops import field_cuda
            return field_cuda.add_sub(a, b, True, self.name)
        return _sub_plain(a, b, self.consts(a.device))

    def neg(self, a) -> torch.Tensor:
        return self.sub(self.consts(a.device).zero, a)

    def mul(self, a, b) -> torch.Tensor:
        """Montgomery product: kernel K1 on CUDA, its plain version on CPU."""
        from lasso_tpu_torch.ops import field_cuda

        b = self._tensor_like(b, a)
        return field_cuda.mont_mul(a, b, self.name)

    def inv_device(self, x) -> torch.Tensor:
        """Fermat inverse x^(p-2) of Montgomery elements [..., W], sync-free:
        a sliding window of 4 bits over the constant exponent, 287 products
        for Fr and 322 for Fp in all (square-and-multiply takes 326 and
        508)."""
        x2 = self.mul(x, x)
        odd = [x]  # x^1, x^3, ..., x^15
        for _ in range(7):
            odd.append(self.mul(odd[-1], x2))
        acc = None
        for squarings, digit in self._inv_chain:
            for _ in range(squarings):
                acc = self.mul(acc, acc)
            if digit:
                d = odd[digit >> 1]
                acc = d if acc is None else self.mul(acc, d)
        return acc

    # -- limb-major ops ([..., W, n]: limbs on axis -2) ---------------------------
    def add_lm(self, a, b) -> torch.Tensor:
        return self.add(a.movedim(-2, -1), b.movedim(-2, -1)).movedim(-1, -2)

    def sub_lm(self, a, b) -> torch.Tensor:
        return self.sub(a.movedim(-2, -1), b.movedim(-2, -1)).movedim(-1, -2)

    def mul_lm(self, a, b) -> torch.Tensor:
        """Limb-major Montgomery product (the unfused curve path): kernel
        K2 on CUDA, its plain version on CPU."""
        from lasso_tpu_torch.ops import field_cuda

        b = self._tensor_like(b, a)
        return field_cuda.mont_mul_lm(a, b, self.name)

    def neg_lm(self, a) -> torch.Tensor:
        return self.sub_lm(torch.zeros_like(a), a)

    # -- constructors -------------------------------------------------------------
    def encode_ints(self, xs, device) -> torch.Tensor:
        """Host ints -> Montgomery limbs [n, W] on `device`."""
        return _as_tensor(
            pack_ints([self.host.to_mont(int(x) % self.host.p) for x in xs]),
            device)

    def encode_scalar(self, x: int, device) -> torch.Tensor:
        return _as_tensor(pack_int(self.host.to_mont(int(x) % self.host.p)),
                          device)

    def encode_u64_array(self, xs: np.ndarray, device) -> torch.Tensor:
        """uint64 values -> Montgomery limbs, with the x*R step on device."""
        packed = _as_tensor(pack_u64_array(xs), device)
        return self.mul(packed, self.consts(device).r2)

    def zeros(self, shape, device) -> torch.Tensor:
        if isinstance(shape, int):
            shape = (shape,)
        return torch.zeros(tuple(shape) + (W,), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        if isinstance(shape, int):
            shape = (shape,)
        return self.consts(device).mont_one.expand(tuple(shape) + (W,))

    # -- converters -----------------------------------------------------------------
    def decode(self, arr) -> list[int]:
        """Montgomery limbs -> host ints (canonical values)."""
        return [self.host.from_mont(v) for v in unpack_ints(arr)]

    def to_int_limbs(self, arr) -> torch.Tensor:
        """Montgomery form -> canonical integer limbs (digit decomposition)."""
        return self.mul(arr, self.consts(arr.device).one)

    # -- reductions -------------------------------------------------------------------
    def sum_columns(self, x) -> torch.Tensor:
        """Lazy column sums along axis 0: [n, ..., W] -> int64 wide columns
        [..., W + 3], value-preserving, each limb <= 2^16 + 1 (n < 2^31).
        K5 for a CUDA tensor, the plain version for a CPU tensor: the same
        columns, limb for limb."""
        if x.is_cuda:
            from lasso_tpu_torch.ops import field_cuda
            return field_cuda.sum_columns(x)
        return _sum_columns_plain(x)

    def finish_sum(self, wide) -> torch.Tensor:
        """Collapse wide columns (value < R*p) to a canonical Montgomery
        element, the value mod p: K5 for a CUDA tensor, the plain version
        for a CPU tensor."""
        if wide.is_cuda:
            from lasso_tpu_torch.ops import field_cuda
            return field_cuda.finish_sum(wide, self.name)
        return _finish_sum_plain(self, wide)

    def sum(self, x) -> torch.Tensor:
        """Sum of field elements along axis 0 of [n, ..., W] -> [..., W]."""
        if x.shape[0] == 0:
            return torch.zeros(x.shape[1:], dtype=torch.int32,
                               device=x.device)
        return self.finish_sum(self.sum_columns(x))

    def canon_wide(self, x) -> torch.Tensor:
        """Reduce canonical-limbed values < 2^256 into [0, p)."""
        y = x.to(torch.int64)
        for m in self.consts(x.device).p_shifts:
            y = _cond_sub(y, m)
        return y.to(torch.int32)


def _sum_columns_plain(x):
    cols = x.to(torch.int64).sum(0)
    for _ in range(3):
        cols = _split_shift(cols)
    return cols


def _finish_sum_plain(f: TField, wide):
    """REDC strips one R factor, a product with R^2 (K1 on CUDA tensors)
    puts it back."""
    c = f.consts(wide.device)
    s = _mont_redc(wide, c).to(torch.int32)
    return f.mul(s, c.r2)


TFr = TField(HostFr, "Fr")
TFp = TField(HostFp, "Fp")
