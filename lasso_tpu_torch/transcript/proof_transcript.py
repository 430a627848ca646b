"""Group-aware Fiat-Shamir transcript operations.

Mirrors the reference's `ProofTranscript<G>` trait impl for merlin
(reference src/utils/transcript.rs:20-72): scalars/points are appended
in ark-serialize compressed form; challenges are 64 uniform bytes reduced
mod the scalar field.
"""

from __future__ import annotations

from lasso_tpu_torch.curve.host import Point
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.transcript.merlin import Transcript


class ProofTranscript:
    """Wraps a merlin Transcript with the Lasso byte conventions.

    Scalars are host ints in [0, Fr.p); points are host `Point`s.
    """

    def __init__(self, label: bytes):
        self.t = Transcript(label)

    # raw ----------------------------------------------------------------------
    def append_message(self, label: bytes, msg: bytes) -> None:
        self.t.append_message(label, msg)

    def append_u64(self, label: bytes, x: int) -> None:
        self.t.append_u64(label, x)

    def append_protocol_name(self, protocol_name: bytes) -> None:
        self.t.append_message(b"protocol-name", protocol_name)

    # scalars / points ----------------------------------------------------------
    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.t.append_message(label, Fr.to_bytes(scalar))

    def append_scalars(self, label: bytes, scalars) -> None:
        self.t.append_message(label, b"begin_append_vector")
        for s in scalars:
            self.append_scalar(label, s)
        self.t.append_message(label, b"end_append_vector")

    def append_point(self, label: bytes, point: Point) -> None:
        self.t.append_message(label, point.to_compressed_bytes())

    def append_points(self, label: bytes, points) -> None:
        self.t.append_message(label, b"begin_append_vector")
        for p in points:
            self.append_point(label, p)
        self.t.append_message(label, b"end_append_vector")

    # challenges ------------------------------------------------------------------
    def challenge_scalar(self, label: bytes) -> int:
        buf = self.t.challenge_bytes(label, 64)
        return Fr.from_le_bytes_mod_order(buf)

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        return [self.challenge_scalar(label) for _ in range(n)]


class TestTranscript(ProofTranscript):
    """Deterministic-challenge fixture (reference: src/utils/test.rs:35-128).

    Appends still hit the merlin transcript, but challenges come from
    pre-seeded lists, letting tests pin sumcheck evaluation points.
    """

    def __init__(self, scalars=None, vecs=None):
        super().__init__(b"transcript")
        self.scalars = list(scalars or [])
        self.scalar_index = 0
        self.vecs = [list(v) for v in (vecs or [])]
        self.vec_index = 0

    def challenge_scalar(self, label: bytes) -> int:
        assert self.scalar_index < len(self.scalars)
        res = self.scalars[self.scalar_index]
        self.scalar_index += 1
        return res

    def challenge_vector(self, label: bytes, n: int) -> list[int]:
        assert self.vec_index < len(self.vecs)
        res = self.vecs[self.vec_index]
        assert len(res) == n
        self.vec_index += 1
        return res
