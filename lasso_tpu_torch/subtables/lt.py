"""LT (less-than) subtable strategy (port of subtables/lt.py;
reference: src/subtables/lt.rs).

Two subtables (LT, EQ), alpha = 2C memories; the collation polynomial
T = sum_i LT[i] * prod_{j<i} EQ[j] has degree C, exercising high-degree
sumcheck rounds.
"""

from __future__ import annotations

import numpy as np

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.subtables.base import (SubtableStrategy, operand_bits,
                                            register_strategy, split_bits)


@register_strategy
class LTSubtableStrategy(SubtableStrategy):
    name = "lt"
    num_subtables = 2

    def materialize_subtables(self) -> np.ndarray:
        idx = np.arange(self.m, dtype=np.uint64)
        lhs, rhs = split_bits(idx, operand_bits(self.m))
        lt = (lhs < rhs).astype(np.uint64)
        eq = (lhs == rhs).astype(np.uint64)
        return np.stack([lt, eq])

    def evaluate_subtable_mle(self, subtable_index: int, point: list[int]) -> int:
        assert len(point) % 2 == 0
        b = len(point) // 2
        x, y = point[:b], point[b:]
        p = Fr.p
        if subtable_index % 2 == 0:
            # LT: sum_i (1 - x_i) y_i eq(x_{<i}, y_{<i}) scanning from the MSB
            result, eq_term = 0, 1
            for i in range(b):
                result = (result + (1 - x[i]) * y[i] % p * eq_term) % p
                eq_term = eq_term * ((1 - x[i] - y[i] + 2 * x[i] * y[i]) % p) % p
            return result
        # EQ
        eq_term = 1
        for i in range(b):
            eq_term = eq_term * ((1 - x[i] - y[i] + 2 * x[i] * y[i]) % p) % p
        return eq_term

    def combine_lookups(self, vals, ops):
        """vals ordered LT[0], EQ[0], ..., LT[C-1], EQ[C-1]."""
        assert len(vals) == self.num_memories
        acc = vals[0]
        eq_prod = None
        for i in range(1, self.c):
            eq_prod = vals[2 * i - 1] if eq_prod is None else ops.mul(eq_prod, vals[2 * i - 1])
            acc = ops.add(acc, ops.mul(vals[2 * i], eq_prod))
        return acc

    def g_poly_degree(self) -> int:
        return self.c
