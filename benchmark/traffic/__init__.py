"""The general traffic generator: one batch of lookups and one evaluation
point per (seed, pass index).

A workload file (`benchmark/workloads/<cell>.json`) names a law and its
parameters; the law is the sampler `benchmark/traffic/<law>.py`, whose
`sample(rng, s, c, log_m, params)` returns the [s, C] lookup indices.  The
point r is log2(s) field elements, uniform mod the scalar field.  Every
(seed, pass index) pair has a stream of its own, so no two passes share an
input, and the same seed gives the same batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from benchmark import manifest
from benchmark.reference.curve import FR

_HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Batch:
    indices: np.ndarray  # [s, C] int64, each below M
    r: list[int]


def law(name: str):
    """The sampler module of a law, found by its file name."""
    return manifest.by_name(_HERE, name, "benchmark.traffic")


def rng_for(seed: int, pass_index: int, stream: int) -> np.random.Generator:
    """The generator of one stream of one pass; any integer seed."""
    return np.random.default_rng(np.random.SeedSequence(
        seed % (1 << 64), spawn_key=(pass_index, stream)))


def make_batch(workload: dict, config: dict, seed: int,
               pass_index: int) -> Batch:
    s, c, log_m = workload["s"], config["C"], config["log_M"]
    indices = law(workload["law"]).sample(
        rng_for(seed, pass_index, 0), s, c, log_m, workload.get("params", {}))
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if indices.shape != (s, c) or indices.min() < 0 or indices.max() >= 1 << log_m:
        raise ValueError(f"law {workload['law']} gave indices of shape "
                         f"{indices.shape} outside [0, 2^{log_m})")
    words = rng_for(seed, pass_index, 1).integers(
        0, 1 << 64, size=((s - 1).bit_length(), 4), dtype=np.uint64)
    r = [sum(int(w) << (64 * j) for j, w in enumerate(row)) % FR
         for row in words]
    return Batch(indices, r)
