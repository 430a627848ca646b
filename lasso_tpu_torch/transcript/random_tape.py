"""Prover blinding randomness tape (reference: src/utils/random.rs:9-39).

A merlin transcript seeded with one Fr sampled from `test_rng()`; blinds are
then drawn as transcript challenges.
"""

from __future__ import annotations

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.utils.chacha import test_rng


class RandomTape:
    def __init__(self, name: bytes):
        self.tape = ProofTranscript(name)
        self.tape.append_scalar(b"init_randomness", Fr.rand(test_rng()))

    def random_scalar(self, label: bytes) -> int:
        return self.tape.challenge_scalar(label)

    def random_vector(self, label: bytes, n: int) -> list[int]:
        return self.tape.challenge_vector(label, n)
