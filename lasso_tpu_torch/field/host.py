"""Host-side (Python big-int) field arithmetic.

Exact oracle for the TPU limb kernels and the workhorse for the verifier's
scalar math (which is tiny: O(log) field ops per proof component).  Mirrors
the semantics of ark-ff's Fp for curve25519's base and scalar fields.
"""

from __future__ import annotations

from lasso_tpu_torch.field import constants as K


class HostField:
    """A prime field over Python ints, with ark-compatible helpers."""

    def __init__(self, modulus: int, bit_size: int):
        self.p = modulus
        self.bit_size = bit_size
        self.byte_len = (bit_size + 7) // 8  # 32 for both fields here
        self.r = K.R_MONT % modulus
        self.r2 = self.r * self.r % modulus
        self.r_inv = pow(self.r, modulus - 2, modulus)

    # basic ops --------------------------------------------------------------
    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        if a % self.p == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, self.p - 2, self.p)

    def batch_inv(self, xs):
        """Montgomery batch inversion: one modpow + 3(n-1) muls."""
        n = len(xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            if x % self.p == 0:
                raise ZeroDivisionError("field inverse of zero")
            prefix[i + 1] = prefix[i] * x % self.p
        inv_all = self.inv(prefix[n])
        out = [0] * n
        for i in range(n - 1, -1, -1):
            out[i] = prefix[i] * inv_all % self.p
            inv_all = inv_all * xs[i] % self.p
        return out

    def pow(self, a, e):
        return pow(a, e, self.p)

    def legendre(self, a):
        return pow(a % self.p, (self.p - 1) // 2, self.p)

    def sqrt(self, a):
        """Square root, or None. Specialized for p = 5 (mod 8) / p = 3 (mod 4)."""
        a %= self.p
        if a == 0:
            return 0
        if self.p % 8 == 5:
            cand = pow(a, (self.p + 3) // 8, self.p)
            if cand * cand % self.p == a:
                return cand
            cand = cand * pow(2, (self.p - 1) // 4, self.p) % self.p
            if cand * cand % self.p == a:
                return cand
            return None
        if self.p % 4 == 3:
            cand = pow(a, (self.p + 1) // 4, self.p)
            return cand if cand * cand % self.p == a else None
        raise NotImplementedError("general Tonelli-Shanks not needed here")

    # ark-compatible conversions ----------------------------------------------
    def to_mont(self, a: int) -> int:
        return a * self.r % self.p

    def from_mont(self, a: int) -> int:
        return a * self.r_inv % self.p

    def from_le_bytes_mod_order(self, data: bytes) -> int:
        return int.from_bytes(data, "little") % self.p

    def to_bytes(self, a: int) -> bytes:
        """ark serialize_compressed: canonical little-endian bytes."""
        return (a % self.p).to_bytes(self.byte_len, "little")

    def from_bytes(self, data: bytes) -> int:
        v = int.from_bytes(data, "little")
        if v >= self.p:
            raise ValueError("non-canonical field element")
        return v

    def is_negative(self, a: int) -> bool:
        """ark TEFlags convention: 'negative' iff NOT (a <= -a), i.e. a > (p-1)/2."""
        a %= self.p
        return a != 0 and a > self.p - a

    # ark UniformRand replication ----------------------------------------------
    def rand(self, rng) -> int:
        """`F::rand(rng)` as in ark-ff 0.4: sample 4 u64 limbs, mask the top
        bits beyond MODULUS_BIT_SIZE, retry until < p; the sampled value is the
        *Montgomery representation*, so the field value is value * R^{-1}."""
        shave = 256 - self.bit_size
        top_mask = (1 << 64) - 1 if shave == 0 else ((1 << 64) - 1) >> shave
        while True:
            limbs = [rng.next_u64() for _ in range(4)]
            limbs[3] &= top_mask
            v = sum(l << (64 * i) for i, l in enumerate(limbs))
            if v < self.p:
                return self.from_mont(v)


Fp = HostField(K.P, K.P_BITS)
Fr = HostField(K.FR, K.FR_BITS)
