"""Benchmark suites (port of benches/bench.py; reference:
src/benches/bench.rs).

Two suites mirroring the reference grids:
  * jolt_demo:        AND, C=8, M=2^16 (virtual table N=2^128), s in 2^10..2^22
  * halo2_comparison: AND, C=1, M=2^16,                         s in 2^10..2^24

Each config runs the full commit+prove+verify pass under named tracing spans
and verifies the proof (benchmarks double as smoke tests, reference:
bench.rs:67-70).  Every pass runs on `device`, the card unless the caller
asks for the CPU; its times are the spans' wall times, each phase ending in
a device synchronize when the card is in use.
"""

from __future__ import annotations

from dataclasses import dataclass

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
import lasso_tpu_torch.subtables.lt  # noqa: F401
import lasso_tpu_torch.subtables.range_check  # noqa: F401
from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.subtables.base import SubtableStrategy, get_strategy
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.transcript.random_tape import RandomTape
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils.tracing import span, synchronize


@dataclass
class BenchResult:
    name: str
    commit_s: float
    prove_s: float
    verify_s: float


@dataclass
class Instance:
    """One bench configuration's inputs, densified on its device."""

    name: str
    strategy: SubtableStrategy
    dense: DensifiedRepresentation
    gens: SparsePolyCommitmentGens
    r: list[int]


def _log2(n: int) -> int:
    return (n - 1).bit_length()


def _pass_name(strategy_name: str, c: int, m: int, sparsity: int) -> str:
    return (f"Lasso(strategy={strategy_name}, C={c}, M=2^{_log2(m)}, "
            f"s=2^{_log2(sparsity)})")


def make_instance(strategy_name: str, c: int, m: int, sparsity: int,
                  device="cuda", **kwargs) -> Instance:
    """The reference's deterministic lookups and evaluation point for
    (strategy, C, M, s), densified, with their generators."""
    strategy = get_strategy(strategy_name, c, m, **kwargs)
    log_m = _log2(m)
    with span("gen"):
        nz = gen_indices(sparsity, m, c)
        r = gen_random_point(_log2(sparsity))
    dense = DensifiedRepresentation(nz, log_m, c, device=device)
    gens = SparsePolyCommitmentGens.new(
        b"gens_sparse_poly", c, sparsity, strategy.num_memories, log_m,
        device=device)
    return Instance(_pass_name(strategy_name, c, m, sparsity), strategy,
                    dense, gens, r)


def prove(inst: Instance) -> SparsePolynomialEvaluationProof:
    return SparsePolynomialEvaluationProof.prove(
        inst.dense, inst.r, inst.gens, inst.strategy,
        ProofTranscript(b"example"), RandomTape(b"proof"))


def single_pass_lasso(strategy_name: str, c: int, m: int, sparsity: int,
                      device="cuda", **kwargs) -> BenchResult:
    """One full commit+prove+verify pass (reference: single_pass_lasso!
    macro).  Raises if the proof does not verify."""
    def sync():
        if inst.dense.device.type == "cuda":
            synchronize()

    with span(_pass_name(strategy_name, c, m, sparsity)):
        inst = make_instance(strategy_name, c, m, sparsity, device, **kwargs)
        with span("commit") as commit_span:
            commitment = inst.dense.commit(inst.gens)
            sync()
        with span("prove") as prove_span:
            proof = prove(inst)
            sync()
        with span("verify") as verify_span:
            proof.verify(commitment, inst.r, inst.gens,
                         ProofTranscript(b"example"))
            sync()
    return BenchResult(inst.name, commit_span.duration, prove_span.duration,
                       verify_span.duration)


def jolt_demo(s_range=None, device="cuda") -> list[BenchResult]:
    """AND, C=8, M=2^16 => N=2^128 (reference: bench.rs:90-156)."""
    s_range = s_range or [1 << k for k in range(10, 23, 2)]
    return [single_pass_lasso("and", 8, 1 << 16, s, device) for s in s_range]


def halo2_comparison(s_range=None, device="cuda") -> list[BenchResult]:
    """AND, C=1, M=2^16 (reference: bench.rs:158-233)."""
    s_range = s_range or [1 << k for k in range(10, 25, 2)]
    return [single_pass_lasso("and", 1, 1 << 16, s, device) for s in s_range]


SUITES = {
    "jolt-demo": jolt_demo,
    "halo2-comparison": halo2_comparison,
}
