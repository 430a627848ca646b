"""Sumcheck prover/verifier (port of subprotocols/sumcheck.py, host-
transcript path; reference: src/subprotocols/sumcheck.rs).

Each round evaluates every stacked polynomial at the degree+1 round points
(incremental `prev + (hi - lo)` updates over the half-cube), combines them
with the strategy's g, and reduces each round point to one field element on
the device; the host interpolates the round polynomial, feeds the
Fiat-Shamir transcript, and the device binds all tables to the challenge.

PyTorch runs eagerly, so every round uses exact shapes: the reference's
fixed-size masked buffers (SUMCHECK_FIX) only exist to bound XLA
recompilation, and they give the same field values.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.poly.unipoly import CompressedUniPoly, UniPoly
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.tracing import instrument


def _round_evals(zs, comb, degree: int):
    """zs: [alpha, n, W] -> [degree+1, W] sums of comb over the half-cube."""
    half = zs.shape[1] // 2
    lo = zs[:, :half]
    hi = zs[:, half:]
    evals = [TFr.sum(comb(lo)), TFr.sum(comb(hi))]
    diff = TFr.sub(hi, lo)
    cur = hi
    for _ in range(2, degree + 1):
        cur = TFr.add(cur, diff)
        evals.append(TFr.sum(comb(cur)))
    return torch.stack(evals)


def _bind_top(zs, r):
    """Bind the top variable of every stacked polynomial:
    [a, n, W] -> [a, n/2, W]."""
    half = zs.shape[1] // 2
    lo = zs[:, :half]
    hi = zs[:, half:]
    return TFr.add(lo, TFr.mul(r, TFr.sub(hi, lo)))


def _bind_top_single(z, r):
    half = z.shape[0] // 2
    lo, hi = z[:half], z[half:]
    return TFr.add(lo, TFr.mul(r, TFr.sub(hi, lo)))


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list[CompressedUniPoly]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        """Host-side verification of the round polynomials.

        Returns (final claim e, challenge point r)."""
        e = claim % Fr.p
        r: list[int] = []
        if len(self.compressed_polys) != num_rounds:
            raise LassoError(f"expected {num_rounds} round polys, got {len(self.compressed_polys)}")
        for cp in self.compressed_polys:
            poly = cp.decompress(e)
            if poly.degree() != degree_bound:
                raise LassoError(
                    f"round poly degree {poly.degree()} != bound {degree_bound}")
            if (poly.eval_at_zero() + poly.eval_at_one()) % Fr.p != e:
                raise LassoError("sumcheck round identity G(0)+G(1) != e failed")
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r


@dataclass
class ZKSumcheckInstanceProof:
    """ZK sumcheck: committed round polynomials + dot-product decommitments
    (reference: src/subprotocols/sumcheck.rs:331-448, verify-only like the
    reference -- the non-ZK prover is what Lasso uses)."""

    comm_polys: list  # host Points
    comm_evals: list  # host Points
    proofs: list  # DotProductProof

    def verify(self, comm_claim, num_rounds: int, degree_bound: int,
               gens_1, gens_n, transcript, device="cuda"):
        """Returns (comm_eval_last, r).  `device` is where a decommitment
        wider than the host-MSM threshold runs its MSM."""
        if gens_n.n != degree_bound + 1:
            raise LassoError("ZK sumcheck generator size mismatch")
        if len(self.comm_polys) != num_rounds or len(self.comm_evals) != num_rounds:
            raise LassoError("ZK sumcheck round count mismatch")

        r: list[int] = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            transcript.append_point(b"comm_poly", comm_poly)
            r_i = transcript.challenge_scalar(b"challenge_nextround")

            comm_claim_per_round = comm_claim if i == 0 else self.comm_evals[i - 1]
            comm_eval = self.comm_evals[i]
            transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)

            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
            comm_target = comm_claim_per_round.mul(w[0]).add(comm_eval.mul(w[1]))

            # decommitment vector: w0 * [2,1,..,1] + w1 * [1, r, r^2, ...]
            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1] * (degree_bound + 1)
            for j in range(1, degree_bound + 1):
                a_eval[j] = a_eval[j - 1] * r_i % Fr.p
            a = [(w[0] * x + w[1] * y) % Fr.p for x, y in zip(a_sc, a_eval)]

            self.proofs[i].verify(gens_1, gens_n, transcript, a,
                                  comm_poly, comm_target, device)
            r.append(r_i)

        return self.comm_evals[-1], r


@instrument("Sumcheck.prove")
def prove_arbitrary(polys_stack, comb, degree: int, num_rounds: int, transcript):
    """Arbitrary-degree sumcheck prover over stacked tables [alpha, n, W].

    `comb` maps [alpha, m, W] -> [m, W].  Returns (SumcheckInstanceProof,
    r (host ints), final_evals (host ints), bound stack)."""
    zs = polys_stack
    device = zs.device
    compressed = []
    r_out: list[int] = []
    for _ in range(num_rounds):
        evals = TFr.decode(_round_evals(zs, comb, degree))
        round_poly = UniPoly.from_evals(evals)
        round_poly.append_to_transcript(b"poly", transcript)
        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r_out.append(r_j)
        zs = _bind_top(zs, TFr.encode_scalar(r_j, device))
        compressed.append(round_poly.compress())

    final_evals = TFr.decode(zs[:, 0])
    return SumcheckInstanceProof(compressed), r_out, final_evals, zs


def _cubic_round_evals(a, b, c):
    """Batched cubic round evals at t in {0, 2, 3}.

    a, b: [I, n, W]; c: [n, W] shared.  Returns [3, I, W] sums."""
    half = a.shape[1] // 2
    a_lo, a_hi = a[:, :half], a[:, half:]
    b_lo, b_hi = b[:, :half], b[:, half:]
    c_lo, c_hi = c[:half], c[half:]

    def prod3(x, y, z):
        return TFr.mul(TFr.mul(x, y), z)

    e0 = TFr.sum(prod3(a_lo, b_lo, c_lo[None]).movedim(1, 0))  # [I, W]

    a_d, b_d, c_d = TFr.sub(a_hi, a_lo), TFr.sub(b_hi, b_lo), TFr.sub(c_hi, c_lo)
    a2, b2, c2 = TFr.add(a_hi, a_d), TFr.add(b_hi, b_d), TFr.add(c_hi, c_d)
    e2 = TFr.sum(prod3(a2, b2, c2[None]).movedim(1, 0))

    a3, b3, c3 = TFr.add(a2, a_d), TFr.add(b2, b_d), TFr.add(c2, c_d)
    e3 = TFr.sum(prod3(a3, b3, c3[None]).movedim(1, 0))
    return torch.stack([e0, e2, e3])


@instrument("Sumcheck.prove_batched")
def prove_cubic_batched(claim: int, num_rounds: int, a_stack, b_stack, c_poly,
                        coeffs: list[int], transcript):
    """Batched product-layer sumcheck (reference: sumcheck.rs:27-135).

    a_stack, b_stack: [I, n, W] (left/right inputs per instance);
    c_poly: [n, W] shared eq polynomial; coeffs: host RLC coefficients.

    Returns (proof, r, (claims_A, claims_B, claim_C))."""
    e = claim % Fr.p
    a, b, c = a_stack, b_stack, c_poly
    del a_stack, b_stack, c_poly
    device = a.device
    compressed = []
    r_out: list[int] = []
    num_instances = a.shape[0]

    for _ in range(num_rounds):
        flat = TFr.decode(_cubic_round_evals(a, b, c).reshape(
            3 * num_instances, -1))
        e0 = flat[0:num_instances]
        e2 = flat[num_instances:2 * num_instances]
        e3 = flat[2 * num_instances:]

        comb0 = sum(x * y for x, y in zip(e0, coeffs)) % Fr.p
        comb2 = sum(x * y for x, y in zip(e2, coeffs)) % Fr.p
        comb3 = sum(x * y for x, y in zip(e3, coeffs)) % Fr.p
        evals = [comb0, (e - comb0) % Fr.p, comb2, comb3]
        round_poly = UniPoly.from_evals(evals)
        round_poly.append_to_transcript(b"poly", transcript)

        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r_out.append(r_j)
        r_dev = TFr.encode_scalar(r_j, device)
        a = _bind_top(a, r_dev)
        b = _bind_top(b, r_dev)
        c = _bind_top_single(c, r_dev)
        e = round_poly.evaluate(r_j)
        compressed.append(round_poly.compress())

    claims_a = TFr.decode(a[:, 0])
    claims_b = TFr.decode(b[:, 0])
    claim_c = TFr.decode(c[0][None])[0]
    return SumcheckInstanceProof(compressed), r_out, (claims_a, claims_b, claim_c)
