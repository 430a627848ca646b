"""The traffic generator: seeded, fresh per pass, and the skewed law's
shape."""

import numpy as np

from benchmark import traffic
from benchmark.reference.curve import FR

JOLT = {"C": 8, "log_M": 16}
SKEWED = {"s": 1 << 16, "law": "operand-bytes", "params": {"operand_bits": 64}}
UNIFORM = {"s": 1 << 12, "law": "uniform", "params": {}}
BIG_SEED = 2**31 + 987654321


def test_same_seed_same_batch_and_fresh_per_pass():
    for wl in (UNIFORM, SKEWED):
        a = traffic.make_batch(wl, JOLT, BIG_SEED, 3)
        b = traffic.make_batch(wl, JOLT, BIG_SEED, 3)
        assert np.array_equal(a.indices, b.indices) and a.r == b.r
        c = traffic.make_batch(wl, JOLT, BIG_SEED, 4)
        d = traffic.make_batch(wl, JOLT, BIG_SEED + 1, 3)
        for other in (c, d):
            assert not np.array_equal(a.indices, other.indices)
            assert a.r != other.r
        assert a.indices.shape == (wl["s"], 8)
        assert a.indices.min() >= 0 and a.indices.max() < 1 << 16
        assert len(a.r) == (wl["s"] - 1).bit_length()
        assert all(0 <= x < FR for x in a.r)


def test_skewed_top_chunk_zero_share():
    # both operands' top byte is 0 iff both bit lengths are at most 56 of
    # 0..64: (57/65)^2; binomial sampling error at s = 2^16 is ~0.0016
    idx = traffic.make_batch(SKEWED, JOLT, BIG_SEED, 1).indices
    share = float(np.mean(idx[:, 7] == 0))
    assert abs(share - (57 / 65) ** 2) < 4 * np.sqrt(0.77 * 0.23 / (1 << 16))
    # the low chunks are rarely 0: an operand's low byte is 0 mostly when
    # the operand is short
    assert float(np.mean(idx[:, 0] == 0)) < 0.05
    # the final count of the top chunk's address 0 reaches ~16 bits
    assert np.bincount(idx[:, 7]).max() >= 1 << 15


def test_skewed_chunks_recompose_the_operands():
    rng = traffic.rng_for(5, 0, 0)
    law = traffic.law("operand-bytes")
    idx = law.sample(rng, 256, 8, 16, {"operand_bits": 64})
    rng = traffic.rng_for(5, 0, 0)
    lengths = rng.integers(0, 65, size=(2, 256), dtype=np.uint64)
    lhs = sum(int(v) << (8 * d) for d, v in enumerate(idx[0] >> 8))
    rhs = sum(int(v) << (8 * d) for d, v in enumerate(idx[0] & 0xFF))
    assert lhs.bit_length() == int(lengths[0, 0])
    assert rhs.bit_length() == int(lengths[1, 0])
