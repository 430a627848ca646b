"""Each chunk of each lookup uniform below M, independently."""

import numpy as np


def sample(rng: np.random.Generator, s: int, c: int, log_m: int,
           params: dict) -> np.ndarray:
    return rng.integers(0, 1 << log_m, size=(s, c), dtype=np.int64)
