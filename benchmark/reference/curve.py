"""Field arithmetic over Python integers and the twisted Edwards form of
curve25519 (ark-curve25519), in extended coordinates (X : Y : Z : T).

Points are plain 4-tuples.  The unified addition law add-2008-hwcd is
complete on this curve (a is a square mod p, d is not), so no sum needs a
special case.
"""

from __future__ import annotations

P = 2**255 - 19
FR = 2**252 + 27742317777372353535851937790883648493
CURVE_A = 486664
CURVE_D = 486660
GENERATOR_X = 38213832894368730265794714087330135568483813637251082400757400312561599933396
GENERATOR_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960
MONT_R = 1 << 256

IDENTITY = (0, 1, 1, 0)


def inv(a: int, m: int) -> int:
    if a % m == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, m - 2, m)


def batch_inv(xs: list[int], m: int) -> list[int]:
    prefix = [1]
    for x in xs:
        prefix.append(prefix[-1] * x % m)
    acc = inv(prefix[-1], m)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * acc % m
        acc = acc * xs[i] % m
    return out


def fp_sqrt(a: int):
    """A square root mod p (p = 5 mod 8), or None."""
    a %= P
    if a == 0:
        return 0
    cand = pow(a, (P + 3) // 8, P)
    if cand * cand % P == a:
        return cand
    cand = cand * pow(2, (P - 1) // 4, P) % P
    return cand if cand * cand % P == a else None


def is_negative(a: int) -> bool:
    """ark's sign convention: a is 'negative' iff a > p - a."""
    a %= P
    return a != 0 and a > P - a


def from_affine(x: int, y: int):
    return (x % P, y % P, 1, x * y % P)


def add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = x1 * x2 % P
    b = y1 * y2 % P
    c = CURVE_D * t1 % P * t2 % P
    d = z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f = (d - c) % P
    g = (d + c) % P
    h = (b - CURVE_A * a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    x, y, z, _ = p
    a = x * x % P
    b = y * y % P
    c = 2 * z * z % P
    d = CURVE_A * a % P
    e = ((x + y) * (x + y) - a - b) % P
    g = (d + b) % P
    f = (g - c) % P
    h = (d - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def mul(p, k: int):
    k %= FR
    acc = IDENTITY
    while k:
        if k & 1:
            acc = add(acc, p)
        p = double(p)
        k >>= 1
    return acc


def equal(p, q) -> bool:
    return ((p[0] * q[2] - q[0] * p[2]) % P == 0
            and (p[1] * q[2] - q[1] * p[2]) % P == 0)


def msm(points: list, scalars: list[int]):
    """sum_i scalars[i] * points[i], by Pippenger's bucket method."""
    assert len(points) == len(scalars)
    scalars = [s % FR for s in scalars]
    n = len(points)
    if n == 0:
        return IDENTITY
    bits = max(s.bit_length() for s in scalars) or 1
    c = 3 if n < 32 else min(max(n.bit_length() * 69 // 100 + 2, 4), 16)
    mask = (1 << c) - 1
    acc = IDENTITY
    for w in range((bits + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            acc = double(acc)
        buckets = [None] * (1 << c)
        shift = w * c
        for pt, s in zip(points, scalars):
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = pt if b is None else add(b, pt)
        running = IDENTITY
        total = IDENTITY
        for b in reversed(buckets[1:]):
            if b is not None:
                running = add(running, b)
            total = add(total, running)
        acc = add(acc, total)
    return acc


def compress(p) -> bytes:
    """ark's compressed encoding: y little-endian, x's sign in the top bit."""
    zinv = inv(p[2], P)
    x, y = p[0] * zinv % P, p[1] * zinv % P
    buf = bytearray(y.to_bytes(32, "little"))
    if is_negative(x):
        buf[31] |= 0x80
    return bytes(buf)


def decompress(data: bytes):
    """The point of a compressed encoding; raises ValueError if none."""
    if len(data) != 32:
        raise ValueError("a point is 32 bytes")
    buf = bytearray(data)
    x_neg = bool(buf[31] & 0x80)
    buf[31] &= 0x7F
    y = int.from_bytes(buf, "little")
    if y >= P:
        raise ValueError("non-canonical y")
    den = (CURVE_D * y * y - CURVE_A) % P
    if den == 0:
        raise ValueError("no x for this y")
    x = fp_sqrt((y * y - 1) * inv(den, P))
    if x is None:
        raise ValueError("no x for this y")
    if is_negative(x) != x_neg:
        x = (-x) % P
    return from_affine(x, y)


GENERATOR = from_affine(GENERATOR_X, GENERATOR_Y)
