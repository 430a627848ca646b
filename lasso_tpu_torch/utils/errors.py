"""Verification errors (reference: src/utils/errors.rs)."""

from __future__ import annotations


class LassoError(Exception):
    """Proof verification failed."""


class InvalidInputLength(LassoError):
    def __init__(self, expected: int, got: int):
        super().__init__(f"invalid input length: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class InputTooLarge(LassoError):
    pass


class DecompressionError(LassoError):
    pass
