"""Faults planted in the program from outside, to show that the comparison
with the reference has teeth.  Each is a context manager that patches the
port's public classes or its kernel dispatcher and restores them on exit.

  lowprec     the control: every Montgomery product keeps only its low 128
              bits (limbs 8..15 zeroed), the step below Fr's 253 bits
  stale       densify keeps the first batch it was handed: its state is
              never updated by a later pass
  half_batch  densify leaves out the second half of each batch (those
              lookups read address 0, as padding does)
  altered     the proof's claimed evaluation is off by one where the prover
              produces it

The benchmark's own runs plant none of them: `benchmark.control` runs them
on the card, and `benchmark/tests` on the CPU.  A run has one chip, so the
exchange between chips is not a fault it can have.
"""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.reference.curve import FR

FAULTS = ("lowprec", "stale", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
    from lasso_tpu_torch.ops import field_cuda

    if name == "lowprec":
        orig = field_cuda.mont_mul

        def low(a, b, field):
            out = orig(a, b, field).clone()
            out[..., 8:] = 0
            return out

        field_cuda.mont_mul = low
        try:
            yield
        finally:
            field_cuda.mont_mul = orig
        return

    if name == "altered":
        from lasso_tpu_torch.lasso.surge import SparsePolynomialEvaluationProof

        orig_prove = SparsePolynomialEvaluationProof.prove

        def prove(*args, **kwargs):
            proof = orig_prove(*args, **kwargs)
            ps = proof.primary_sumcheck
            ps.claimed_evaluation = (ps.claimed_evaluation + 1) % FR
            return proof

        SparsePolynomialEvaluationProof.prove = staticmethod(prove)
        try:
            yield
        finally:
            SparsePolynomialEvaluationProof.prove = staticmethod(orig_prove)
        return

    orig_init = DensifiedRepresentation.__init__
    first = []

    def init(self, indices, log_m, c, device="cuda"):
        arr = np.array(indices, dtype=np.int64)
        if name == "stale":
            if not first:
                first.append(arr)
            arr = first[0]
        else:
            arr[arr.shape[0] // 2:] = 0
        orig_init(self, arr, log_m, c, device=device)

    DensifiedRepresentation.__init__ = init
    try:
        yield
    finally:
        DensifiedRepresentation.__init__ = orig_init
