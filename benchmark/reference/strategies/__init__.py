"""The semantics of each subtable strategy, found by name.

A configuration's `strategy` names the module
`benchmark/reference/strategies/<strategy>.py`, written from a16z/Lasso's
`src/subtables/<strategy>.rs` in plain Python ints and NumPy.  Each gives

  num_memories(c)                     memories a lookup reads, over C chunks
  memory_to_dimension(k, c)           the chunk that memory k reads
  memory_to_subtable(k, c)            the subtable that memory k reads
  subtable_values(sub, index, log_m)  T_sub[index], an int64 array like index
  subtable_mle(sub, point)            T_sub's multilinear extension at a point
                                      of log_m coordinates (point[0] the top
                                      bit), mod Fr
  combine(vals, log_m)                the collation g over num_memories values
                                      (ints, or object arrays of ints), mod Fr
  g_degree(c)                         g's degree

A later change adds a strategy by adding such a file.
"""

from __future__ import annotations

import os

from benchmark import manifest

_HERE = os.path.dirname(os.path.abspath(__file__))


def strategy(name: str):
    """The module of a strategy, found by its file name."""
    return manifest.by_name(_HERE, name, "benchmark.reference.strategies")
