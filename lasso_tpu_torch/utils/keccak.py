"""Keccak-f[1600] permutation (host side).

Used by the STROBE-128 sponge that backs the merlin Fiat-Shamir transcript
(see transcript/strobe.py).  The transcript handles tiny data (labels,
32/64-byte scalars), so a clean host implementation is the right tool; the
TPU never hashes.

Validated against hashlib's sha3/shake implementations (tests/test_keccak.py).
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rho rotation offsets, indexed [x][y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, n: int) -> int:
    n %= 64
    if n == 0:
        return v
    return ((v << n) | (v >> (64 - n))) & _MASK


_NATIVE = None


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes).

    Routed to the native core (native/host_crypto.cpp) when built; the pure
    Python path below is the oracle and fallback."""
    global _NATIVE
    if _NATIVE is not False:
        try:
            from lasso_tpu_torch import native
            if native.keccak_f1600(state):
                _NATIVE = True
                return
        except Exception:
            pass
        _NATIVE = False
    assert len(state) == 200
    # lanes[x][y]
    lanes = [[int.from_bytes(state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8], "little")
              for y in range(5)] for x in range(5)]
    for rnd in range(24):
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        dd = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= dd[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(lanes[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((b[(x + 1) % 5][y] ^ _MASK) & b[(x + 2) % 5][y])
        # iota
        lanes[0][0] ^= _RC[rnd]

    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = lanes[x][y].to_bytes(8, "little")


class _Sponge:
    """Generic Keccak sponge (for self-tests against hashlib)."""

    def __init__(self, rate_bytes: int, domain_suffix: int):
        self.rate = rate_bytes
        self.suffix = domain_suffix
        self.state = bytearray(200)
        self.pos = 0
        self.squeezing = False

    def absorb(self, data: bytes) -> None:
        assert not self.squeezing
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == self.rate:
                keccak_f1600(self.state)
                self.pos = 0

    def _pad(self) -> None:
        self.state[self.pos] ^= self.suffix
        self.state[self.rate - 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.squeezing = True

    def squeeze(self, n: int) -> bytes:
        if not self.squeezing:
            self._pad()
        out = bytearray()
        while n > 0:
            take = min(n, self.rate - self.pos)
            out += self.state[self.pos: self.pos + take]
            self.pos += take
            n -= take
            if self.pos == self.rate:
                keccak_f1600(self.state)
                self.pos = 0
        return bytes(out)


def shake256(data: bytes, out_len: int) -> bytes:
    """SHAKE256 XOF (matches hashlib.shake_256; kept for no-hashlib fallback)."""
    s = _Sponge(rate_bytes=136, domain_suffix=0x1F)
    s.absorb(data)
    return s.squeeze(out_len)


def sha3_256(data: bytes) -> bytes:
    s = _Sponge(rate_bytes=136, domain_suffix=0x06)
    s.absorb(data)
    return s.squeeze(32)
