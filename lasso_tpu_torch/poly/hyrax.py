"""Hyrax-style polynomial commitment (port of poly/hyrax.py; reference:
src/poly/dense_mlpoly.rs:34-401).

Commit: the 2^l evaluation table is viewed as a 2^(l/2) x 2^(l-l/2) matrix
and every row is Pedersen-committed by ONE batched Pippenger MSM with
shared bases (ops/msm.msm_batch_device).

Open (PolyEvalProof): fold the matrix with the factored eq vector L, then
run a log-size inner-product argument on <LZ, R> = Z(r) through
subprotocols/dot_product.DotProductProofLog.
"""

from __future__ import annotations

from dataclasses import dataclass

from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.curve.tcurve import (from_host_points, to_host_point,
                                          to_host_points)
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.ops import msm as _msm
from lasso_tpu_torch.poly.commitments import commit_scalar
from lasso_tpu_torch.poly.dense import (DensePolynomial, eq_evals_host,
                                        factored_lens)
from lasso_tpu_torch.subprotocols.dot_product import (DotProductProofGens,
                                                      DotProductProofLog,
                                                      _gens_device)
from lasso_tpu_torch.utils.tracing import instrument, span


@dataclass
class PolyCommitmentGens:
    gens: DotProductProofGens

    @staticmethod
    def new(num_vars: int, label: bytes) -> "PolyCommitmentGens":
        _, right = factored_lens(num_vars)
        return PolyCommitmentGens(DotProductProofGens.new(1 << right, label))


@dataclass
class PolyCommitment:
    C: list[hostcurve.Point]

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            transcript.append_point(b"poly_commitment_share", c)
        transcript.append_message(label, b"poly_commitment_end")


@instrument("DensePolynomial.commit")
def commit_poly(poly: DensePolynomial, gens: PolyCommitmentGens,
                random_tape=None) -> tuple[PolyCommitment, list[int]]:
    """Hyrax matrix commitment. Returns (commitment, row blinds)."""
    ell = poly.num_vars
    left, right = factored_lens(ell)
    l_size, r_size = 1 << left, 1 << right
    assert l_size * r_size == len(poly)

    if random_tape is not None:
        blinds = random_tape.random_vector(b"poly_blinds", l_size)
    else:
        blinds = [0] * l_size

    gens_n = gens.gens.gens_n
    bases = _gens_device(gens_n, poly.device)[..., :r_size]
    rows = poly.z.reshape(l_size, r_size, -1)
    row_pts = _msm.msm_batch_device(bases, rows)  # [l_size, 4, W, 1]
    # one host transfer for all rows
    points = to_host_points(row_pts.movedim(0, -1))
    if any(b != 0 for b in blinds):
        points = [p.add(gens_n.h.mul(b)) for p, b in zip(points, blinds)]
    return PolyCommitment(points), blinds


@dataclass
class PolyEvalProof:
    proof: DotProductProofLog

    PROTOCOL_NAME = b"polynomial evaluation proof"

    @staticmethod
    def prove(poly: DensePolynomial, blinds, r: list[int], zr: int,
              blind_zr: int, gens: PolyCommitmentGens, transcript, random_tape):
        """Prove Z(r) = zr. blinds/blind_zr may be None (zero blinds).

        Returns (PolyEvalProof, C_Zr)."""
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL_NAME)
        assert poly.num_vars == len(r)

        left, right = factored_lens(len(r))
        l_size = 1 << left
        blinds = blinds if blinds is not None else [0] * l_size
        blind_zr = blind_zr if blind_zr is not None else 0
        assert len(blinds) == l_size
        device = poly.device

        with span("PEP.eq_and_bound"):
            l_ints = eq_evals_host(r[:left])
            r_ints = eq_evals_host(r[left:])

            lz = poly.bound(TFr.encode_ints(l_ints, device))  # [r_size, W]
            lz_blind = sum(b * l for b, l in zip(blinds, l_ints)) % Fr.p

        proof, _c_lr, c_zr = DotProductProofLog.prove(
            gens.gens, transcript, random_tape, lz, lz_blind,
            TFr.encode_ints(r_ints, device), zr, blind_zr, a_host=r_ints)
        return PolyEvalProof(proof), c_zr

    def verify(self, gens: PolyCommitmentGens, transcript, r: list[int],
               c_zr: hostcurve.Point, comm: PolyCommitment, device,
               deferred=None) -> None:
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL_NAME)
        left, _right = factored_lens(len(r))
        l_ints = eq_evals_host(r[:left])
        r_ints = eq_evals_host(r[left:])

        # C_LZ is appended to the transcript (as Cx, inside the dot-product
        # verify), so it must be a concrete point before the challenge
        # stream continues; up to VERIFY_CLZ_HOST_MAX rows it runs on the
        # native host Pippenger.
        if len(comm.C) <= max(_msm.MSM_HOST_MAX, _msm.VERIFY_CLZ_HOST_MAX):
            c_lz = hostcurve.msm_host(comm.C, l_ints)
        else:
            c_dev = from_host_points(comm.C, device)
            c_lz = to_host_point(_msm.msm_device(
                c_dev, TFr.encode_ints(l_ints, device), full_width=True))

        self.proof.verify(len(r_ints), gens.gens, transcript, r_ints, c_lz,
                          c_zr, device, deferred=deferred)

    def verify_plain(self, gens: PolyCommitmentGens, transcript, r: list[int],
                     zr: int, comm: PolyCommitment, device,
                     deferred=None) -> None:
        c_zr = commit_scalar(zr, 0, gens.gens.gens_1)
        self.verify(gens, transcript, r, c_zr, comm, device,
                    deferred=deferred)
