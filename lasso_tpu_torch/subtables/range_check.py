"""Range-check subtable strategy (port of subtables/range_check.py;
reference: src/subtables/range_check.rs).

Proves lookups fall in [0, 2^LOG_R) against an oversized virtual table by
decomposing into C chunks with three subtables {full, remainder, zeros} and a
bit-budget subtable selection per dimension.
"""

from __future__ import annotations

import numpy as np

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.subtables.base import SubtableStrategy, register_strategy


@register_strategy
class RangeCheckSubtableStrategy(SubtableStrategy):
    name = "range_check"
    num_subtables = 3

    def __init__(self, c: int, m: int, log_r: int = 40):
        super().__init__(c, m)
        self.log_r = log_r

    @property
    def num_memories(self) -> int:
        return self.c

    def materialize_subtables(self) -> np.ndarray:
        idx = np.arange(self.m, dtype=np.uint64)
        full = idx
        cutoff = 1 << (self.log_r % self.log_m)
        remainder = np.where(idx < cutoff, idx, np.uint64(0))
        zeros = np.zeros_like(idx)
        return np.stack([full, remainder, zeros])

    def evaluate_subtable_mle(self, subtable_index: int, point: list[int]) -> int:
        p = Fr.p
        b = len(point)
        if subtable_index == 0:
            return sum((1 << i) * point[b - i - 1] for i in range(b)) % p
        if subtable_index == 1:
            cutoff = self.log_r % self.log_m
            result = 0
            for i in range(b):
                if i < cutoff:
                    result = (result + (1 << i) * point[b - i - 1]) % p
                else:
                    result = result * ((1 - point[b - i - 1]) % p) % p
            return result
        assert subtable_index == 2
        return 0

    def memory_to_subtable_index(self, i: int) -> int:
        if i * self.log_m > self.log_r:
            return 2
        return int((i + 1) * self.log_m > self.log_r)

    def memory_to_dimension_index(self, i: int) -> int:
        return i

    def combine_lookups(self, vals, ops):
        assert len(vals) == self.num_memories
        acc = ops.mul(vals[0], ops.weight(1))
        for i in range(1, len(vals)):
            acc = ops.add(acc, ops.mul(vals[i], ops.weight(1 << (i * self.log_m))))
        return acc

    def g_poly_degree(self) -> int:
        return 1
