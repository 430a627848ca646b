"""Subtable strategy framework (port of subtables/base.py; reference:
src/subtables/mod.rs:31-93).

Strategies are runtime-registered objects configured with (C, M); the
collation polynomial `g` (`combine_lookups`) is written once against an ops
backend and runs either on host ints (verifier) or on batched limb tensors
(the sumcheck prover).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, pack_int


class HostOps:
    """Backend: Python ints mod Fr."""

    is_device = False

    @staticmethod
    def add(a, b):
        return (a + b) % Fr.p

    @staticmethod
    def sub(a, b):
        return (a - b) % Fr.p

    @staticmethod
    def mul(a, b):
        return a * b % Fr.p

    @staticmethod
    def weight(w: int):
        return w % Fr.p

    @staticmethod
    def zero(like=None):
        return 0

    @staticmethod
    def one(like=None):
        return 1


class DeviceOps:
    """Backend: [m, W] Montgomery limb tensors."""

    is_device = True
    _weight_cache: dict[int, np.ndarray] = {}

    add = staticmethod(TFr.add)
    sub = staticmethod(TFr.sub)
    mul = staticmethod(TFr.mul)

    @classmethod
    def weight(cls, w: int):
        """Constant w as host limbs; the field ops move it to the operand's
        device (cached there)."""
        got = cls._weight_cache.get(w)
        if got is None:
            got = pack_int(TFr.host.to_mont(w % TFr.host.p))
            cls._weight_cache[w] = got
        return got

    @staticmethod
    def zero(like):
        return torch.zeros_like(like)

    @staticmethod
    def one(like):
        return TFr.ones(like.shape[:-1], like.device)


class SubtableStrategy:
    """Base class. Subclasses set num_subtables and implement the four hooks."""

    name: str = "?"
    num_subtables: int = 1

    def __init__(self, c: int, m: int):
        assert m & (m - 1) == 0, "M must be a power of two"
        self.c = c
        self.m = m
        self.log_m = m.bit_length() - 1
        self._comb_eq_device = None
        self._comb_device = None

    def comb_eq_device(self):
        """Device comb function for the primary sumcheck (cached)."""
        if self._comb_eq_device is None:
            def comb(zs):
                vals = [zs[i] for i in range(zs.shape[0])]
                return self.combine_lookups_eq(vals, DeviceOps)
            self._comb_eq_device = comb
        return self._comb_eq_device

    def comb_device(self):
        """Device collation g over stacked rows [alpha, m, W] (no eq factor)."""
        if self._comb_device is None:
            def comb(zs):
                vals = [zs[i] for i in range(zs.shape[0])]
                return self.combine_lookups(vals, DeviceOps)
            self._comb_device = comb
        return self._comb_device

    # -- hooks ----------------------------------------------------------------
    @property
    def num_memories(self) -> int:
        return self.num_subtables * self.c

    def materialize_subtables(self) -> np.ndarray:
        """[num_subtables, M] uint64 table values."""
        raise NotImplementedError

    def evaluate_subtable_mle(self, subtable_index: int, point: list[int]) -> int:
        """Verifier-side MLE evaluation at an Fr point (host ints)."""
        raise NotImplementedError

    def combine_lookups(self, vals, ops):
        """The collation polynomial g over num_memories operands."""
        raise NotImplementedError

    def g_poly_degree(self) -> int:
        raise NotImplementedError

    # -- defaults ---------------------------------------------------------------
    def combine_lookups_eq(self, vals, ops):
        """g(T_1..T_alpha) * eq, with eq as the last operand."""
        assert len(vals) == self.num_memories + 1
        return ops.mul(self.combine_lookups(vals[:-1], ops), vals[-1])

    def sumcheck_poly_degree(self) -> int:
        return self.g_poly_degree() + 1

    def memory_to_subtable_index(self, i: int) -> int:
        assert i < self.num_memories
        return i % self.num_subtables

    def memory_to_dimension_index(self, i: int) -> int:
        assert i < self.num_memories
        return i // self.num_subtables


_REGISTRY: dict[str, type] = {}


def register_strategy(cls):
    _REGISTRY[cls.name] = cls
    return cls


_INSTANCES: dict[tuple, SubtableStrategy] = {}


def get_strategy(name: str, c: int, m: int, **kwargs) -> SubtableStrategy:
    """Strategy instances are cached per (name, C, M, options)."""
    key = (name, c, m, tuple(sorted(kwargs.items())))
    got = _INSTANCES.get(key)
    if got is None:
        got = _REGISTRY[name](c, m, **kwargs)
        _INSTANCES[key] = got
    return got


def list_strategies() -> list[str]:
    return sorted(_REGISTRY)


def split_bits(idx: np.ndarray, num_bits: int):
    """(high, low) chunks of idx, each num_bits wide (vectorized)."""
    mask = (1 << num_bits) - 1
    return (idx >> num_bits) & mask, idx & mask


def operand_bits(m: int) -> int:
    return int(math.log2(m)) // 2
