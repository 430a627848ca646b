"""Zero-knowledge Sigma-protocols (port of subprotocols/zk.py; reference:
src/subprotocols/zk.rs).

Dormant in the reference (dead code, kept for the ZK variant of sumcheck)
but part of the component inventory.  These are single-scalar protocols --
pure host group algebra (native-accelerated Point ops), no device work.
"""

from __future__ import annotations

from dataclasses import dataclass

from lasso_tpu_torch.curve.host import Point
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.poly.commitments import MultiCommitGens, commit_scalar
from lasso_tpu_torch.utils.errors import LassoError


@dataclass
class KnowledgeProof:
    """Proves knowledge of (x, r) with C = x*G + r*h."""

    alpha: Point
    z1: int
    z2: int

    PROTOCOL_NAME = b"knowledge proof"

    @staticmethod
    def prove(gens_n: MultiCommitGens, transcript, random_tape, x: int, r: int):
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL_NAME)
        t1 = random_tape.random_scalar(b"t1")
        t2 = random_tape.random_scalar(b"t2")

        c_pt = commit_scalar(x, r, gens_n)
        transcript.append_point(b"C", c_pt)
        alpha = commit_scalar(t1, t2, gens_n)
        transcript.append_point(b"alpha", alpha)

        c = transcript.challenge_scalar(b"c")
        z1 = (x * c + t1) % Fr.p
        z2 = (r * c + t2) % Fr.p
        return KnowledgeProof(alpha, z1, z2), c_pt

    def verify(self, gens_n: MultiCommitGens, transcript, c_pt: Point) -> None:
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL_NAME)
        transcript.append_point(b"C", c_pt)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        lhs = commit_scalar(self.z1, self.z2, gens_n)
        rhs = c_pt.mul(c).add(self.alpha)
        if lhs != rhs:
            raise LassoError("knowledge proof rejected")


@dataclass
class EqualityProof:
    """Proves C1, C2 commit to the same value."""

    alpha: Point
    z: int

    PROTOCOL_NAME = b"equality proof"

    @staticmethod
    def prove(gens_n: MultiCommitGens, transcript, random_tape,
              v1: int, s1: int, v2: int, s2: int):
        transcript.append_protocol_name(EqualityProof.PROTOCOL_NAME)
        r = random_tape.random_scalar(b"r")

        c1 = commit_scalar(v1, s1, gens_n)
        transcript.append_point(b"C1", c1)
        c2 = commit_scalar(v2, s2, gens_n)
        transcript.append_point(b"C2", c2)
        alpha = gens_n.h.mul(r)
        transcript.append_point(b"alpha", alpha)

        c = transcript.challenge_scalar(b"c")
        z = (c * (s1 - s2) + r) % Fr.p
        return EqualityProof(alpha, z), c1, c2

    def verify(self, gens_n: MultiCommitGens, transcript,
               c1: Point, c2: Point) -> None:
        transcript.append_protocol_name(EqualityProof.PROTOCOL_NAME)
        transcript.append_point(b"C1", c1)
        transcript.append_point(b"C2", c2)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        rhs = c1.add(c2.neg()).mul(c).add(self.alpha)
        lhs = gens_n.h.mul(self.z)
        if lhs != rhs:
            raise LassoError("equality proof rejected")


@dataclass
class ProductProof:
    """Proves Z commits to the product of the values in X and Y."""

    alpha: Point
    beta: Point
    delta: Point
    z: list[int]  # 5 scalars

    PROTOCOL_NAME = b"product proof"

    @staticmethod
    def prove(gens_n: MultiCommitGens, transcript, random_tape,
              x: int, r_x: int, y: int, r_y: int, zv: int, r_z: int):
        transcript.append_protocol_name(ProductProof.PROTOCOL_NAME)
        b1 = random_tape.random_scalar(b"b1")
        b2 = random_tape.random_scalar(b"b2")
        b3 = random_tape.random_scalar(b"b3")
        b4 = random_tape.random_scalar(b"b4")
        b5 = random_tape.random_scalar(b"b5")

        x_pt = commit_scalar(x, r_x, gens_n)
        transcript.append_point(b"X", x_pt)
        y_pt = commit_scalar(y, r_y, gens_n)
        transcript.append_point(b"Y", y_pt)
        z_pt = commit_scalar(zv, r_z, gens_n)
        transcript.append_point(b"Z", z_pt)

        alpha = commit_scalar(b1, b2, gens_n)
        transcript.append_point(b"alpha", alpha)
        beta = commit_scalar(b3, b4, gens_n)
        transcript.append_point(b"beta", beta)
        # delta = b3 * X + b5 * h  (commitment under basis (X, h))
        delta = x_pt.mul(b3).add(gens_n.h.mul(b5))
        transcript.append_point(b"delta", delta)

        c = transcript.challenge_scalar(b"c")
        z1 = (b1 + c * x) % Fr.p
        z2 = (b2 + c * r_x) % Fr.p
        z3 = (b3 + c * y) % Fr.p
        z4 = (b4 + c * r_y) % Fr.p
        z5 = (b5 + c * (r_z - r_x * y)) % Fr.p
        return (ProductProof(alpha, beta, delta, [z1, z2, z3, z4, z5]),
                x_pt, y_pt, z_pt)

    @staticmethod
    def _check(p: Point, x_pt: Point, c: int, base_g: Point, base_h: Point,
               z1: int, z2: int) -> bool:
        lhs = p.add(x_pt.mul(c))
        rhs = base_g.mul(z1).add(base_h.mul(z2))
        return lhs == rhs

    def verify(self, gens_n: MultiCommitGens, transcript,
               x_pt: Point, y_pt: Point, z_pt: Point) -> None:
        transcript.append_protocol_name(ProductProof.PROTOCOL_NAME)
        transcript.append_point(b"X", x_pt)
        transcript.append_point(b"Y", y_pt)
        transcript.append_point(b"Z", z_pt)
        transcript.append_point(b"alpha", self.alpha)
        transcript.append_point(b"beta", self.beta)
        transcript.append_point(b"delta", self.delta)

        z1, z2, z3, z4, z5 = self.z
        c = transcript.challenge_scalar(b"c")
        ok = (self._check(self.alpha, x_pt, c, gens_n.G[0], gens_n.h, z1, z2)
              and self._check(self.beta, y_pt, c, gens_n.G[0], gens_n.h, z3, z4)
              and self._check(self.delta, z_pt, c, x_pt, gens_n.h, z3, z5))
        if not ok:
            raise LassoError("product proof rejected")
