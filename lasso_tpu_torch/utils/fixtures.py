"""Deterministic test-data generators matching the reference's fixtures
(reference src/utils/test.rs:11-32, src/benches/bench.rs:13-34)."""

from __future__ import annotations

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.utils.chacha import test_rng


def gen_indices(sparsity: int, memory_size: int, c: int) -> list[list[int]]:
    """Random lookup indices; each op uses the same index in all C dimensions
    (as the reference does: `[rng.next_u64() as usize % memory_size; C]`)."""
    rng = test_rng()
    out = []
    for _ in range(sparsity):
        v = rng.next_u64() % memory_size
        out.append([v] * c)
    return out


def gen_random_point(num_bits: int) -> list[int]:
    rng = test_rng()
    return [Fr.rand(rng) for _ in range(num_bits)]


def gen_random_points(num_bits: int, c: int) -> list[list[int]]:
    return [gen_random_point(num_bits) for _ in range(c)]
