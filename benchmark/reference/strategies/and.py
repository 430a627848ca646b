"""AND (a16z/Lasso src/subtables/and.rs): one subtable and C memories,
memory k reading chunk k.  An index is lhs || rhs, log_M/2 bits each, and
T[lhs || rhs] = lhs & rhs; g(T_1..T_C) = sum_i T_i 2^(i log_M/2) recomposes
the C chunks' results, so it has degree 1."""

from __future__ import annotations

import numpy as np

from benchmark.reference.curve import FR


def num_memories(c: int) -> int:
    return c


def memory_to_dimension(k: int, c: int) -> int:
    return k


def memory_to_subtable(k: int, c: int) -> int:
    return 0


def subtable_values(sub: int, index: np.ndarray, log_m: int) -> np.ndarray:
    b = log_m // 2
    mask = (1 << b) - 1
    return (index >> b) & index & mask


def subtable_mle(sub: int, point: list[int]) -> int:
    b = len(point) // 2
    x, y = point[:b], point[b:]
    return sum((1 << i) * x[b - 1 - i] * y[b - 1 - i] for i in range(b)) % FR


def combine(vals: list, log_m: int):
    b = log_m // 2
    return sum(v << (i * b) for i, v in enumerate(vals)) % FR


def g_degree(c: int) -> int:
    return 1
