"""MLE of the address index (reference: src/poly/identity_poly.rs)."""

from __future__ import annotations

from lasso_tpu_torch.field.host import Fr


def identity_poly_evaluate(r: list[int]) -> int:
    """sum_i 2^(len-1-i) * r_i (verifier-side, host ints)."""
    n = len(r)
    return sum((1 << (n - 1 - i)) * r[i] for i in range(n)) % Fr.p
