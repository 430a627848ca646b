"""merlin-compatible Fiat-Shamir transcript.

Byte-level clone of the merlin crate's `Transcript` (the reference routes all
Fiat-Shamir through it: reference src/utils/transcript.rs:20-72).
"""

from __future__ import annotations

from lasso_tpu_torch.transcript.strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32_le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, int(x).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(n), True)
        return self.strobe.prf(n, False)
