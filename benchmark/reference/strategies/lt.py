"""LT (a16z/Lasso src/subtables/lt.rs): two subtables, LT and EQ, on each
of the C chunks, so 2C memories in the order LT_0, EQ_0, ..., LT_{C-1},
EQ_{C-1}: memory k reads chunk k // 2 and subtable k % 2.  An index is
lhs || rhs, log_M/2 bits each; LT[lhs || rhs] = [lhs < rhs] and
EQ[lhs || rhs] = [lhs == rhs].  g = sum_i LT_i prod_{j<i} EQ_j, of degree C:
chunk 0 is the most significant, and a later chunk decides only where every
earlier one is equal."""

from __future__ import annotations

import numpy as np

from benchmark.reference.curve import FR

LT, EQ = 0, 1


def num_memories(c: int) -> int:
    return 2 * c


def memory_to_dimension(k: int, c: int) -> int:
    return k // 2


def memory_to_subtable(k: int, c: int) -> int:
    return k % 2


def subtable_values(sub: int, index: np.ndarray, log_m: int) -> np.ndarray:
    b = log_m // 2
    mask = (1 << b) - 1
    lhs, rhs = (index >> b) & mask, index & mask
    return (lhs < rhs if sub == LT else lhs == rhs).astype(np.int64)


def subtable_mle(sub: int, point: list[int]) -> int:
    """From the top bit down: LT adds (1 - x_i) y_i where every higher bit
    is equal; EQ is the product of the bits' equalities."""
    b = len(point) // 2
    lt, eq = 0, 1
    for x, y in zip(point[:b], point[b:]):
        lt = (lt + (1 - x) * y % FR * eq) % FR
        eq = eq * ((1 - x - y + 2 * x * y) % FR) % FR
    return lt if sub == LT else eq


def combine(vals: list, log_m: int):
    total, eq_prod = 0, 1
    for i in range(len(vals) // 2):
        total = (total + vals[2 * i] * eq_prod) % FR
        eq_prod = eq_prod * vals[2 * i + 1] % FR
    return total


def g_degree(c: int) -> int:
    return c
