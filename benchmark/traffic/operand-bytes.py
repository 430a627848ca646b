"""Lookups of a bitwise instruction on two operands of `operand_bits` bits
whose bit lengths are uniform over 0..operand_bits: a value of bit length L
is 2^(L-1) plus a uniform value below 2^(L-1) (0 for L = 0).  Chunk d packs
chunk d of each operand, log_M/2 bits each, into one index (lhs in the high
half, as the AND subtable splits its index), so the high chunks of short
operands are 0.
"""

import numpy as np


def sample(rng: np.random.Generator, s: int, c: int, log_m: int,
           params: dict) -> np.ndarray:
    width = params["operand_bits"]
    b = log_m // 2
    if width != c * b or width > 64:
        raise ValueError(f"{c} chunks of {b} bits do not make a {width}-bit "
                         "operand")
    lengths = rng.integers(0, width + 1, size=(2, s), dtype=np.uint64)
    low = rng.integers(0, 1 << 64, size=(2, s), dtype=np.uint64)
    top = np.where(lengths > 0, lengths - 1, 0)
    mask = (np.uint64(1) << top) - np.uint64(1)
    ops = np.where(lengths > 0, (np.uint64(1) << top) | (low & mask), 0)
    chunk = np.uint64((1 << b) - 1)
    out = np.empty((s, c), dtype=np.int64)
    for d in range(c):
        shift = np.uint64(b * d)
        lhs = (ops[0] >> shift) & chunk
        rhs = (ops[1] >> shift) & chunk
        out[:, d] = ((lhs << np.uint64(b)) | rhs).astype(np.int64)
    return out
