"""The reference's subtable strategies, found by name: each subtable's
multilinear extension agrees with its table on the Boolean points, and g
over the C chunks' memories is the instruction on whole operands."""

import numpy as np
import pytest

from benchmark.reference import strategies

LOG_M, C = 4, 3  # 2-bit operand chunks, 6-bit operands
B = LOG_M // 2


def _bits(index: int) -> list[int]:
    return [(index >> (LOG_M - 1 - i)) & 1 for i in range(LOG_M)]


def test_unknown_strategy_raises():
    with pytest.raises(FileNotFoundError):
        strategies.strategy("no-such-strategy")


@pytest.mark.parametrize("name, op", [
    ("and", lambda x, y: x & y),
    ("lt", lambda x, y: int(x < y)),
], ids=["and", "lt"])
def test_strategy_tables_mles_and_collation(name, op):
    strat = strategies.strategy(name)
    index = np.arange(1 << LOG_M, dtype=np.int64)
    subs = sorted({strat.memory_to_subtable(k, C)
                   for k in range(strat.num_memories(C))})
    for sub in subs:
        table = strat.subtable_values(sub, index, LOG_M)
        assert [strat.subtable_mle(sub, _bits(i)) for i in index.tolist()] \
            == table.tolist()

    # chunk d of an operand: AND's chunk 0 is the least significant, LT's
    # the most (a later chunk decides only where the earlier ones are equal)
    rng = np.random.default_rng(7)
    for x, y in rng.integers(0, 1 << (B * C), size=(200, 2)).tolist():
        shifts = [B * d if name == "and" else B * (C - 1 - d) for d in range(C)]
        chunks = [(((x >> sh) & 3) << B) | ((y >> sh) & 3) for sh in shifts]
        vals = [int(strat.subtable_values(
                    strat.memory_to_subtable(k, C),
                    np.array([chunks[strat.memory_to_dimension(k, C)]]),
                    LOG_M)[0])
                for k in range(strat.num_memories(C))]
        assert strat.combine(vals, LOG_M) == op(x, y)
    assert strat.g_degree(C) == (1 if name == "and" else C)
