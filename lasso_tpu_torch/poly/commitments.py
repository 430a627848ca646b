"""Pedersen commitment generators (reference: src/poly/commitments.rs:14-94).

Generator derivation is byte-compatible with the reference: seed =
Shake256(label || compressed(generator))[0..32], then n+1 points sampled from
ChaCha20Rng.  Deriving generators is host work (one-time per size); the
actual commitments (MSMs) run on TPU via ops/msm.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from lasso_tpu_torch.curve.host import GENERATOR, Point, rand_point
from lasso_tpu_torch.utils.chacha import ChaChaRng

_GENS_CACHE: dict[tuple[int, bytes], "MultiCommitGens"] = {}


@dataclass
class MultiCommitGens:
    n: int
    G: list[Point]
    h: Point

    @staticmethod
    def new(n: int, label: bytes) -> "MultiCommitGens":
        key = (n, bytes(label))
        cached = _GENS_CACHE.get(key)
        if cached is not None:
            return cached
        shake = hashlib.shake_256()
        shake.update(label)
        shake.update(GENERATOR.to_compressed_bytes())
        seed = shake.digest(32)
        rng = ChaChaRng.chacha20(seed)
        gens = [rand_point(rng) for _ in range(n + 1)]
        out = MultiCommitGens(n=n, G=gens[:n], h=gens[n])
        _GENS_CACHE[key] = out
        return out

    def split_at(self, mid: int) -> tuple["MultiCommitGens", "MultiCommitGens"]:
        return (
            MultiCommitGens(n=mid, G=self.G[:mid], h=self.h),
            MultiCommitGens(n=self.n - mid, G=self.G[mid:], h=self.h),
        )


def commit_scalar(value: int, blind: int, gens: MultiCommitGens) -> Point:
    """value * G[0] + blind * h (gens_1 commitment)."""
    assert gens.n == 1
    return gens.G[0].mul(value).add(gens.h.mul(blind))
