"""Gaussian elimination over Fr (reference: src/utils/gaussian_elimination.rs).

The sumcheck verifier/prover interpolate round polynomials from their
evaluations; the reference solves the Vandermonde system by elimination.
Host big-int math -- the systems are (degree+1) x (degree+2), degree <= C+1.
"""

from __future__ import annotations

from lasso_tpu_torch.field.host import Fr


def gaussian_elimination(matrix: list[list[int]]) -> list[int]:
    """Solve an augmented [n, n+1] system in-place, returning the solution."""
    p = Fr.p
    m = [row[:] for row in matrix]
    n = len(m)
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col] % p != 0), None)
        if piv is None:
            raise ZeroDivisionError("singular matrix")
        m[col], m[piv] = m[piv], m[col]
        inv = pow(m[col][col], p - 2, p)
        m[col] = [x * inv % p for x in m[col]]
        for r in range(n):
            if r != col and m[r][col] % p:
                f = m[r][col]
                m[r] = [(x - f * y) % p for x, y in zip(m[r], m[col])]
    return [m[i][n] for i in range(n)]
