"""Host-side (Python big-int) twisted Edwards curve: ark-curve25519 semantics.

Exact oracle for the TPU curve kernels and the implementation used for the
small, latency-bound group ops in the verifier (point (de)serialization,
single scalar-muls).  Points use extended twisted Edwards coordinates
(X : Y : Z : T) with x = X/Z, y = Y/Z, T = XY/Z.

The unified addition law is complete for this curve (a QR, d non-QR), so
add(P, P) and add(P, identity) need no special cases -- the same property the
TPU kernels rely on for branch-free bucket accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass

from lasso_tpu_torch.field import constants as K
from lasso_tpu_torch.field.host import Fp, Fr

_P = K.P
_A = K.CURVE_A
_D = K.CURVE_D


@dataclass(frozen=True)
class Point:
    x: int
    y: int
    z: int
    t: int

    # -- constructors --------------------------------------------------------
    @staticmethod
    def identity() -> "Point":
        return Point(0, 1, 1, 0)

    @staticmethod
    def from_affine(x: int, y: int) -> "Point":
        return Point(x % _P, y % _P, 1, x * y % _P)

    # -- predicates -----------------------------------------------------------
    def is_identity(self) -> bool:
        # x == 0 and y == z
        return self.x == 0 and (self.y - self.z) % _P == 0

    def to_affine(self) -> tuple[int, int]:
        zinv = Fp.inv(self.z)
        return self.x * zinv % _P, self.y * zinv % _P

    def is_on_curve(self) -> bool:
        x, y = self.to_affine()
        return (_A * x * x + y * y) % _P == (1 + _D * x * x * y * y) % _P

    # -- group law -------------------------------------------------------------
    def add(self, q: "Point") -> "Point":
        # add-2008-hwcd (unified; complete for a QR, d non-QR)
        a = self.x * q.x % _P
        b = self.y * q.y % _P
        c = _D * self.t % _P * q.t % _P
        d = self.z * q.z % _P
        e = ((self.x + self.y) * (q.x + q.y) - a - b) % _P
        f = (d - c) % _P
        g = (d + c) % _P
        h = (b - _A * a) % _P
        return Point(e * f % _P, g * h % _P, f * g % _P, e * h % _P)

    def double(self) -> "Point":
        # dbl-2008-hwcd
        a = self.x * self.x % _P
        b = self.y * self.y % _P
        c = 2 * self.z * self.z % _P
        d = _A * a % _P
        e = ((self.x + self.y) * (self.x + self.y) - a - b) % _P
        g = (d + b) % _P
        f = (g - c) % _P
        h = (d - b) % _P
        return Point(e * f % _P, g * h % _P, f * g % _P, e * h % _P)

    def neg(self) -> "Point":
        return Point((-self.x) % _P, self.y, self.z, (-self.t) % _P)

    def mul(self, k: int) -> "Point":
        k %= Fr.p
        if _native_curve():
            from lasso_tpu_torch import native
            return native.point_mul(self, k)
        acc = Point.identity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc

    def mul_by_cofactor(self) -> "Point":
        return self.double().double().double()

    def _mul_unreduced(self, k: int) -> "Point":
        """Scalar mul WITHOUT reducing k mod the subgroup order (needed for
        subgroup-membership checks, where mul(Fr.p) must not collapse to
        mul(0))."""
        if _native_curve():
            from lasso_tpu_torch import native
            got = native.point_mul(self, k)
            if got is not None:
                return got
        acc = Point.identity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc

    def is_in_subgroup(self) -> bool:
        """Prime-order-subgroup membership (curve25519 has cofactor 8);
        matches ark's is_in_correct_subgroup_assuming_on_curve
        (validated by default in ark's deserialize_compressed, which the
        reference's proof derives rely on, e.g. src/lasso/surge.rs:61)."""
        return self._mul_unreduced(Fr.p).is_identity()

    def eq(self, q: "Point") -> bool:
        # X1/Z1 == X2/Z2 and Y1/Z1 == Y2/Z2
        return (self.x * q.z - q.x * self.z) % _P == 0 and (
            self.y * q.z - q.y * self.z) % _P == 0

    def __eq__(self, q) -> bool:  # type: ignore[override]
        return isinstance(q, Point) and self.eq(q)

    def __hash__(self):
        return hash(self.to_affine())

    # -- ark-serialize compatible encoding -------------------------------------
    def to_compressed_bytes(self) -> bytes:
        """ark-ec twisted Edwards serialize_compressed: y bytes (LE) with the
        'x is negative' flag (x > -x) in the top bit of the final byte."""
        x, y = self.to_affine()
        buf = bytearray(Fp.to_bytes(y))
        if Fp.is_negative(x):
            buf[-1] |= 0x80
        return bytes(buf)

    @staticmethod
    def from_compressed_bytes(data: bytes, validate: bool = True) -> "Point":
        """ark-ec deserialize_compressed semantics: decompress (on-curve by
        construction) AND, with validate=True (ark's Validate::Yes default),
        check prime-order-subgroup membership so attacker-supplied bytes
        cannot smuggle low-order components into a proof."""
        from lasso_tpu_torch.utils.errors import DecompressionError
        if len(data) != 32:
            raise DecompressionError("bad point encoding length")
        buf = bytearray(data)
        x_neg = bool(buf[-1] & 0x80)
        buf[-1] &= 0x7F
        y = Fp.from_bytes(bytes(buf))
        x = _x_from_y(y, x_neg)
        if x is None:
            raise DecompressionError("point decompression failed")
        pt = Point.from_affine(x, y)
        if validate and not pt.is_in_subgroup():
            raise DecompressionError("point not in prime-order subgroup")
        return pt


def _x_from_y(y: int, want_negative: bool):
    """Recover x from y on a*x^2 + y^2 = 1 + d*x^2*y^2."""
    num = (y * y - 1) % _P
    den = (_D * y * y - _A) % _P
    if den == 0:
        return None
    x2 = num * Fp.inv(den) % _P
    x = Fp.sqrt(x2)
    if x is None:
        return None
    if Fp.is_negative(x) != want_negative:
        x = (-x) % _P
    return x


GENERATOR = Point.from_affine(K.GENERATOR_X, K.GENERATOR_Y)


def rand_point(rng) -> Point:
    """`EdwardsProjective::rand(rng)` as in ark-ec 0.4: sample y and a sign
    bit until (y, x) lands on the curve, then clear the cofactor."""
    while True:
        y = Fp.rand(rng)
        greatest = rng.gen_bool_standard()
        num = (y * y - 1) % _P
        den = (_D * y * y - _A) % _P
        if den == 0:
            continue
        x2 = num * Fp.inv(den) % _P
        x = Fp.sqrt(x2)
        if x is None:
            continue
        # ark returns (x, neg_x) ordered so that x <= neg_x; greatest picks neg_x
        x_min = min(x, _P - x) if x != 0 else 0
        x_max = (_P - x_min) % _P
        chosen = x_max if greatest else x_min
        return Point.from_affine(chosen, y).mul_by_cofactor()


def msm_host_naive(points: list[Point], scalars: list[int]) -> Point:
    """Naive host MSM (oracle for the Pippenger implementations)."""
    assert len(points) == len(scalars)
    acc = Point.identity()
    for pt, s in zip(points, scalars):
        acc = acc.add(pt.mul(s))
    return acc


_NATIVE_CURVE = None


def _native_curve() -> bool:
    global _NATIVE_CURVE
    if _NATIVE_CURVE is None:
        try:
            from lasso_tpu_torch import native
            _NATIVE_CURVE = native.available()
        except Exception:
            _NATIVE_CURVE = False
    return _NATIVE_CURVE


def msm_host(points: list[Point], scalars: list[int]) -> Point:
    """Host Pippenger MSM over Python bigints.

    Used for small/latency-bound MSMs (verifier-side combinations, tail
    rounds of the Bullet reduction) where a TPU kernel launch + compile is
    not worth it; the TPU kernel (ops/msm.py) handles throughput sizes.
    Window sizing mirrors the reference's small-scalar optimization
    (reference: src/msm/mod.rs:96-116): windows cover only the actual max
    scalar bit width.
    """
    import math

    assert len(points) == len(scalars)
    n = len(points)
    if n == 0:
        return Point.identity()
    scalars = [s % Fr.p for s in scalars]
    if _native_curve():
        from lasso_tpu_torch import native
        return native.msm(points, scalars)
    max_bits = max((s.bit_length() for s in scalars), default=1) or 1
    if n < 32:
        c = 3
    else:
        c = min(int(math.log2(n) * 69 / 100) + 2, 16)
    num_windows = (max_bits + c - 1) // c
    mask = (1 << c) - 1

    acc = Point.identity()
    for w in range(num_windows - 1, -1, -1):
        if w != num_windows - 1:
            for _ in range(c):
                acc = acc.double()
        buckets: list[Point | None] = [None] * ((1 << c) - 1)
        shift = w * c
        for pt, s in zip(points, scalars):
            d = (s >> shift) & mask
            if d:
                b = buckets[d - 1]
                buckets[d - 1] = pt if b is None else b.add(pt)
        running = Point.identity()
        window_sum = Point.identity()
        for b in reversed(buckets):
            if b is not None:
                running = running.add(b)
            window_sum = window_sum.add(running)
        acc = acc.add(window_sum)
    return acc
