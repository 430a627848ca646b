"""The Fiat-Shamir transcript: keccak-f[1600] (FIPS 202), the STROBE-128
subset that the merlin crate uses, merlin's `Transcript`, and Lasso's
conventions over it (scalars and points appended in ark's compressed
encoding, challenges as 64 bytes reduced mod the scalar field).
"""

from __future__ import annotations

from benchmark.reference.curve import FR, compress

_MASK = (1 << 64) - 1
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rho offsets and pi destinations, lane index x + 5 y
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
_PI = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)


def keccak_f1600(state: bytearray) -> None:
    """Keccak-f[1600] in place on a 200-byte state (little-endian lanes)."""
    a = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    rot, pi = _ROT, _PI
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        for x in range(5):
            v = c[(x + 1) % 5]
            d = c[(x - 1) % 5] ^ (((v << 1) | (v >> 63)) & _MASK)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        b = [0] * 25
        for i in range(25):
            v, n = a[i], rot[i]
            b[pi[i]] = (((v << n) | (v >> (64 - n))) & _MASK) if n else v
        for y in range(0, 25, 5):
            b0, b1, b2, b3, b4 = b[y: y + 5]
            a[y] = b0 ^ (~b1 & b2)
            a[y + 1] = b1 ^ (~b2 & b3)
            a[y + 2] = b2 ^ (~b3 & b4)
            a[y + 3] = b3 ^ (~b4 & b0)
            a[y + 4] = b4 ^ (~b0 & b1)
        a[0] ^= rc
    for i in range(25):
        state[8 * i: 8 * i + 8] = (a[i] & _MASK).to_bytes(8, "little")


_R = 166  # STROBE-128: 200 - 128/4 - 2
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_M = 1, 2, 4, 16


class Strobe128:
    """The AD / meta-AD / PRF operations of STROBE-128, as merlin uses
    them."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert flags == self.cur_flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & _FLAG_C and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, False)
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)


class Transcript:
    """merlin's Transcript with Lasso's scalar and point conventions."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_protocol_name(self, name: bytes) -> None:
        self.append_message(b"protocol-name", name)

    def append_scalar(self, label: bytes, x: int) -> None:
        self.append_message(label, (x % FR).to_bytes(32, "little"))

    def append_scalars(self, label: bytes, xs) -> None:
        self.append_message(label, b"begin_append_vector")
        for x in xs:
            self.append_scalar(label, x)
        self.append_message(label, b"end_append_vector")

    def append_point(self, label: bytes, point) -> None:
        """`point` is a 32-byte encoding or a point tuple."""
        data = point if isinstance(point, bytes) else compress(point)
        self.append_message(label, data)

    def challenge_scalar(self, label: bytes) -> int:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad((64).to_bytes(4, "little"), True)
        return int.from_bytes(self.strobe.prf(64), "little") % FR

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]
