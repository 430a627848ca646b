"""Univariate round polynomials (host side).

Round polynomials are tiny (degree <= C+1), so interpolation and evaluation
are exact host big-int math; only their evaluations over the hypercube are
computed on device.  Mirrors the reference's UniPoly/CompressedUniPoly
(src/poly/unipoly.rs): coefficients low-to-high; the compressed form omits
the linear coefficient, recovered from the round hint e = G(0) + G(1).
"""

from __future__ import annotations

from dataclasses import dataclass

from lasso_tpu_torch.field.host import Fr


def _solve_vandermonde(evals: list[int]) -> list[int]:
    """Interpolate coeffs of the unique poly with P(i) = evals[i], i = 0..n-1.

    Uses Lagrange interpolation over the points 0..n-1 (the solution of the
    reference's Gaussian elimination is the same unique polynomial)."""
    n = len(evals)
    p = Fr.p
    coeffs = [0] * n
    for i in range(n):
        # numerator polynomial prod_{j != i} (x - j), denominator prod (i - j)
        denom = 1
        num = [1]  # coefficients low-to-high
        for j in range(n):
            if j == i:
                continue
            denom = denom * (i - j) % p
            # num *= (x - j)
            nxt = [0] * (len(num) + 1)
            for k, c in enumerate(num):
                nxt[k] = (nxt[k] - j * c) % p
                nxt[k + 1] = (nxt[k + 1] + c) % p
            num = nxt
        scale = evals[i] * Fr.inv(denom) % p
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + scale * c) % p
    return coeffs


@dataclass
class UniPoly:
    coeffs: list[int]  # low-to-high

    @staticmethod
    def from_evals(evals: list[int]) -> "UniPoly":
        return UniPoly(_solve_vandermonde([e % Fr.p for e in evals]))

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % Fr.p

    def evaluate(self, r: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * r + c) % Fr.p
        return acc

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly([self.coeffs[0]] + self.coeffs[2:])

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"UniPoly_begin")
        for c in self.coeffs:
            transcript.append_scalar(b"coeff", c)
        transcript.append_message(label, b"UniPoly_end")


@dataclass
class CompressedUniPoly:
    coeffs_except_linear_term: list[int]

    def decompress(self, hint: int) -> UniPoly:
        # linear term from G(0) + G(1) = hint
        linear = (hint - 2 * self.coeffs_except_linear_term[0]
                  - sum(self.coeffs_except_linear_term[1:])) % Fr.p
        coeffs = [self.coeffs_except_linear_term[0], linear] + \
            self.coeffs_except_linear_term[1:]
        return UniPoly(coeffs)
