"""ChaCha-based RNGs compatible with Rust's `rand_chacha` crate.

The reference derives all deterministic randomness from two RNGs:
  * Pedersen generator sampling: ChaCha20Rng seeded from Shake256
    (reference src/poly/commitments.rs:22-44)
  * test fixtures: `ark_std::test_rng()` = rand 0.8 `StdRng` = ChaCha12Rng
    with a fixed 32-byte seed (reference src/utils/test.rs:11-32)

This module reproduces the rand_core `BlockRng` word-stream semantics exactly
(including u64 reads straddling a 64-word block boundary) so that generator
points and test vectors can match the reference bit-for-bit.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


_NATIVE = None


def chacha_block(key_words, counter: int, nonce_words, rounds: int):
    """One ChaCha block: 16 output u32 words (64-bit LE counter variant).

    Routed to the native core when built; Python below is the oracle."""
    global _NATIVE
    if _NATIVE is not False:
        try:
            from lasso_tpu_torch import native
            out = native.chacha_block(key_words, counter, nonce_words, rounds)
            if out is not None:
                _NATIVE = True
                return out
        except Exception:
            pass
        _NATIVE = False
    st = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & _M32, (counter >> 32) & _M32,
        *nonce_words,
    ]
    x = list(st)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + st[i]) & _M32 for i in range(16)]


class ChaChaRng:
    """rand_chacha-compatible RNG (BlockRng over a ChaCha core).

    Generates 4 blocks (64 u32 words) per refill; `next_u32`/`next_u64`
    replicate rand_core::block::BlockRng semantics.
    """

    BLOCK_WORDS = 64  # 4 ChaCha blocks per BlockRng buffer

    def __init__(self, seed: bytes, rounds: int):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[4 * i: 4 * i + 4], "little") for i in range(8)]
        self.nonce = [0, 0]
        self.rounds = rounds
        self.block_counter = 0  # in ChaCha blocks
        self.results: list[int] = []
        self.index = self.BLOCK_WORDS  # force refill on first use

    @classmethod
    def chacha20(cls, seed: bytes) -> "ChaChaRng":
        return cls(seed, 20)

    @classmethod
    def chacha12(cls, seed: bytes) -> "ChaChaRng":
        return cls(seed, 12)

    def _generate(self) -> None:
        words: list[int] = []
        for _ in range(4):
            words.extend(chacha_block(self.key, self.block_counter, self.nonce, self.rounds))
            self.block_counter += 1
        self.results = words

    def _generate_and_set(self, index: int) -> None:
        self._generate()
        self.index = index

    def next_u32(self) -> int:
        if self.index >= self.BLOCK_WORDS:
            self._generate_and_set(0)
        v = self.results[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        # Faithful to rand_core BlockRng::next_u64
        n = self.BLOCK_WORDS
        idx = self.index
        if idx < n - 1:
            self.index += 2
            return self.results[idx] | (self.results[idx + 1] << 32)
        if idx >= n:
            self._generate_and_set(2)
            return self.results[0] | (self.results[1] << 32)
        # one word remaining
        lo = self.results[n - 1]
        self._generate_and_set(1)
        return (self.results[0] << 32) | lo

    def gen_bool_standard(self) -> bool:
        """rand 0.8 `Standard` distribution for bool: top bit of next_u32."""
        return bool(self.next_u32() & (1 << 31))


TEST_RNG_SEED = bytes([
    1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
])


def test_rng() -> ChaChaRng:
    """`ark_std::test_rng()`: rand 0.8 StdRng (= ChaCha12) with a fixed seed."""
    return ChaChaRng.chacha12(TEST_RNG_SEED)
