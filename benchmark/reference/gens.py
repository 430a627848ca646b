"""The Pedersen generators of a label, derived as the Lasso reference derives
them (src/poly/commitments.rs): seed = SHAKE256(label || compressed
generator)[0..32], then points sampled from a ChaCha20 stream as ark-ec 0.4's
`EdwardsProjective::rand` samples them, with the cofactor cleared.

A vector commitment over n generators uses the first n points of the stream
as G and point n as the blinding base h; an opening over n generators uses
points 0..n-1 as G_n, point n as G_1 and point n + 1 as h.
"""

from __future__ import annotations

import hashlib

from benchmark.reference import curve

_M32 = 0xFFFFFFFF


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def _chacha20_block(key: list[int], counter: int) -> list[int]:
    st = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *key,
          counter & _M32, (counter >> 32) & _M32, 0, 0]
    x = list(st)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + st[i]) & _M32 for i in range(16)]


class _ChaCha20:
    """rand_chacha's ChaCha20Rng: 64-word buffers, rand_core's BlockRng
    reads (a u64 may straddle two buffers)."""

    def __init__(self, seed: bytes):
        self.key = [int.from_bytes(seed[4 * i: 4 * i + 4], "little")
                    for i in range(8)]
        self.counter = 0
        self.words: list[int] = []
        self.index = 64

    def _refill(self) -> None:
        self.words = []
        for _ in range(4):
            self.words += _chacha20_block(self.key, self.counter)
            self.counter += 1

    def next_u32(self) -> int:
        if self.index >= 64:
            self._refill()
            self.index = 0
        v = self.words[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        if self.index < 63:
            v = self.words[self.index] | (self.words[self.index + 1] << 32)
            self.index += 2
            return v
        if self.index >= 64:
            self._refill()
            self.index = 2
            return self.words[0] | (self.words[1] << 32)
        lo = self.words[63]
        self._refill()
        self.index = 1
        return (self.words[0] << 32) | lo


_R_INV = curve.inv(curve.MONT_R % curve.P, curve.P)


def _rand_point(rng: _ChaCha20):
    p = curve.P
    while True:
        while True:  # ark-ff's Fp::rand: 4 words, top bit shaved, below p
            limbs = [rng.next_u64() for _ in range(4)]
            limbs[3] &= (1 << 63) - 1
            v = sum(limb << (64 * i) for i, limb in enumerate(limbs))
            if v < p:
                break
        y = v * _R_INV % p  # the words are the Montgomery form
        greatest = bool(rng.next_u32() & (1 << 31))
        den = (curve.CURVE_D * y * y - curve.CURVE_A) % p
        if den == 0:
            continue
        x = curve.fp_sqrt((y * y - 1) * curve.inv(den, p))
        if x is None:
            continue
        x_min = min(x, p - x) if x else 0
        x = (p - x_min) % p if greatest else x_min
        pt = curve.from_affine(x, y)
        return curve.double(curve.double(curve.double(pt)))


def generators(label: bytes, count: int) -> list:
    """The first `count` points of the label's generator stream."""
    shake = hashlib.shake_256()
    shake.update(label)
    shake.update(curve.compress(curve.GENERATOR))
    rng = _ChaCha20(shake.digest(32))
    return [_rand_point(rng) for _ in range(count)]
