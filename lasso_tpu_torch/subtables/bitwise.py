"""AND / OR / XOR subtable strategies
(reference: src/subtables/{and,or,xor}.rs).

Each materializes one M-sized table over split operands (lhs | rhs counting
order) and collates C chunk lookups by base-2^(logM/2) recomposition.
"""

from __future__ import annotations

import numpy as np

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.subtables.base import (SubtableStrategy, operand_bits,
                                      register_strategy, split_bits)


class _BitwiseStrategy(SubtableStrategy):
    num_subtables = 1

    def _op(self, lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _mle_bit(self, x: int, y: int) -> int:
        """MLE of the bit op on single field-valued bits."""
        raise NotImplementedError

    def materialize_subtables(self) -> np.ndarray:
        idx = np.arange(self.m, dtype=np.uint64)
        lhs, rhs = split_bits(idx, operand_bits(self.m))
        return self._op(lhs, rhs)[None, :]

    def evaluate_subtable_mle(self, subtable_index: int, point: list[int]) -> int:
        assert len(point) % 2 == 0
        b = len(point) // 2
        x, y = point[:b], point[b:]
        acc = 0
        for i in range(b):
            acc = (acc + (1 << i) * self._mle_bit(x[b - i - 1], y[b - i - 1])) % Fr.p
        return acc

    def combine_lookups(self, vals, ops):
        assert len(vals) == self.num_memories
        increment = operand_bits(self.m)
        acc = ops.mul(vals[0], ops.weight(1))
        for i in range(1, len(vals)):
            acc = ops.add(acc, ops.mul(vals[i], ops.weight(1 << (i * increment))))
        return acc

    def g_poly_degree(self) -> int:
        return 1


@register_strategy
class AndSubtableStrategy(_BitwiseStrategy):
    name = "and"

    def _op(self, lhs, rhs):
        return lhs & rhs

    def _mle_bit(self, x, y):
        return x * y % Fr.p


@register_strategy
class OrSubtableStrategy(_BitwiseStrategy):
    name = "or"

    def _op(self, lhs, rhs):
        return lhs | rhs

    def _mle_bit(self, x, y):
        # 1 - (1-x)(1-y)
        return (1 - (1 - x) * (1 - y)) % Fr.p


@register_strategy
class XorSubtableStrategy(_BitwiseStrategy):
    name = "xor"

    def _op(self, lhs, rhs):
        return lhs ^ rhs

    def _mle_bit(self, x, y):
        # (1-x)y + x(1-y)
        return ((1 - x) * y + x * (1 - y)) % Fr.p
