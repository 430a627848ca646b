"""One run of one cell: set-up, the measured window of passes, the traced
pass, and the comparison with the reference.

A pass hands a fresh batch of lookups and a fresh point (made from the seed
and the pass index before its clocks start) to the program, which densifies
and commits, proves and verifies, each on a clock that ends in a device
synchronize: `prover_s` is the commit's and the prove's together (what the
prover pays per batch), `prove_s` the prove's, `verify_s` the verify's.  The window repeats passes until
`seconds` have passed and ends with the last whole pass.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback

import numpy as np

from benchmark import manifest, traffic
from benchmark.reference import check

TRANSCRIPT_LABEL = b"lasso-benchmark"
GENS_LABEL = b"gens_sparse_poly"
TAPE_LABEL = b"proof"
CHECKED_PASSES = 2
# streams of traffic.rng_for beyond the batch's own (0, 1)
_JUDGE_STREAM = 2
_WEIGHTS_STREAM = 3
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lasso_tpu")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (so `lasso_tpu_torch` is not `lasso_tpu`)."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def to_plain(x):
    """A proof or commitment of the program as plain data: dataclasses as
    dicts of their fields, points as compressed bytes, scalars as ints."""
    if hasattr(x, "to_compressed_bytes"):
        return x.to_compressed_bytes()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "strategy"}
    if isinstance(x, (list, tuple)):
        return [to_plain(v) for v in x]
    if isinstance(x, int):
        return int(x)
    raise TypeError(f"cannot hand {type(x).__name__} to the reference")


def plain_spans(roots) -> list[dict]:
    return [{"name": s.name, "start": s.start, "end": s.end,
             "children": plain_spans(s.children)} for s in roots]


@dataclasses.dataclass
class PassRecord:
    index: int
    commit_s: float
    prove_s: float
    verify_s: float
    spans: list
    keccak_launches: int
    # what the reference judges, kept only for the passes drawn to be
    # judged (None for the others)
    tables: list | None  # the two committed tables' limbs, on the host
    commitment: object
    proof: object


class Program:
    """The port's public entry points for one configuration on one device.
    Nothing of the port is imported before this is built."""

    def __init__(self, config: dict, workload: dict, device: str):
        os.environ["LASSO_TPU_PALLAS_PADD"] = (
            "1" if config["curve_path"] == "fused" else "0")
        os.environ["LASSO_TPU_DEVICE_TRANSCRIPT"] = (
            "1" if config["transcript"] == "device" else "0")
        import torch

        # each subtable module registers its strategies
        import lasso_tpu_torch.subtables.bitwise  # noqa: F401
        import lasso_tpu_torch.subtables.lt  # noqa: F401
        import lasso_tpu_torch.subtables.range_check  # noqa: F401
        from lasso_tpu_torch.lasso.densified import DensifiedRepresentation
        from lasso_tpu_torch.lasso.surge import (
            SparsePolyCommitmentGens, SparsePolynomialEvaluationProof)
        from lasso_tpu_torch.ops import field_cuda
        from lasso_tpu_torch.subtables.base import get_strategy
        from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
        from lasso_tpu_torch.transcript.random_tape import RandomTape
        from lasso_tpu_torch.utils import tracing

        self.torch, self.field_cuda, self.tracing = torch, field_cuda, tracing
        self._dense_cls = DensifiedRepresentation
        self._proof_cls = SparsePolynomialEvaluationProof
        self._transcript, self._tape = ProofTranscript, RandomTape
        self.device = device
        self.c, self.log_m = config["C"], config["log_M"]
        self.cuda = device == "cuda"
        t0 = time.perf_counter()
        if self.cuda:
            field_cuda.build()
        t1 = time.perf_counter()
        self.strategy = get_strategy(config["strategy"], self.c, 1 << self.log_m)
        self.gens = SparsePolyCommitmentGens.new(
            GENS_LABEL, self.c, workload["s"], self.strategy.num_memories,
            self.log_m, device=device)
        self.setup_steps = {"build_s": t1 - t0,
                            "generators_s": time.perf_counter() - t1}

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def densify_commit(self, indices):
        dense = self._dense_cls(indices, self.log_m, self.c, device=self.device)
        return dense, dense.commit(self.gens)

    def prove(self, dense, r):
        return self._proof_cls.prove(
            dense, r, self.gens, self.strategy,
            self._transcript(TRANSCRIPT_LABEL), self._tape(TAPE_LABEL))

    def verify(self, proof, commitment, r) -> None:
        proof.verify(commitment, r, self.gens,
                     self._transcript(TRANSCRIPT_LABEL))


def run_pass(prog: Program, batch: traffic.Batch, index: int,
             keep: bool = False) -> PassRecord:
    """One pass; with `keep`, the record holds what the reference judges."""
    tracing, clock = prog.tracing, time.perf_counter
    tracing.reset_spans()
    t0 = clock()
    dense, comm = prog.densify_commit(batch.indices)
    prog.sync()
    t1 = clock()
    tables = ([dense.combined_l_variate_polys.z.cpu(),
               dense.combined_log_m_variate_polys.z.cpu()] if keep else None)
    prog.field_cuda.reset_launch_counts()
    t2 = clock()
    proof = prog.prove(dense, batch.r)
    prog.sync()
    t3 = clock()
    keccak = prog.field_cuda.launch_counts["keccak"]
    del dense
    t4 = clock()
    prog.verify(proof, comm, batch.r)
    prog.sync()
    t5 = clock()
    return PassRecord(index, t1 - t0, t3 - t2, t5 - t4,
                      plain_spans(tracing.span_tree()), keccak, tables,
                      comm if keep else None, proof if keep else None)


class Sample:
    """The passes the reference judges: a uniform sample of CHECKED_PASSES
    of all passes offered, drawn from the seed by reservoir sampling, so it
    is known before each pass whether that pass is kept, and the window
    holds the judged passes' outputs alone."""

    def __init__(self, seed: int):
        self._rng = traffic.rng_for(seed, 0, _JUDGE_STREAM)
        self.kept: list[PassRecord] = []
        self.offered = 0
        self._slot: int | None = None

    def draw(self) -> bool:
        """Whether the next pass is to be kept."""
        self.offered += 1
        if len(self.kept) < CHECKED_PASSES:
            self._slot = len(self.kept)
        else:
            j = int(self._rng.integers(0, self.offered))
            self._slot = j if j < CHECKED_PASSES else None
        return self._slot is not None

    def put(self, rec: PassRecord) -> None:
        """The record of the pass last drawn for."""
        if self._slot is None:
            return
        if self._slot == len(self.kept):
            self.kept.append(rec)
        else:
            self.kept[self._slot] = rec
        self._slot = None


@dataclasses.dataclass
class Window:
    passes: list
    failed: int
    seconds: float


def run_window(prog: Program, cell: manifest.Cell, seed: int, seconds: float,
               first_index: int, sample: Sample, log) -> Window:
    """Passes until `seconds` have passed; the window ends with the last
    whole pass.  A pass that raises ends the window and counts as failed."""
    passes, failed = [], 0
    start = time.perf_counter()
    index = first_index
    while True:
        batch = traffic.make_batch(cell.workload, cell.config, seed, index)
        keep = sample.draw()
        try:
            rec = run_pass(prog, batch, index, keep)
        except Exception:  # the program failed: recorded, the window ends
            failed += 1
            log("pass %d raised:\n%s" % (index, traceback.format_exc()))
            break
        sample.put(rec)
        passes.append(rec)
        log(f"pass {index}: commit_s {rec.commit_s} prove_s {rec.prove_s} "
            f"verify_s {rec.verify_s}")
        index += 1
        if time.perf_counter() - start >= seconds:
            break
    return Window(passes, failed, time.perf_counter() - start)


def judge(cell: manifest.Cell, seed: int, sample: Sample,
          log) -> dict[str, int]:
    """The reference's counts, summed over the sampled passes."""
    totals = dict.fromkeys(check.LIMITS, 0)
    for rec in sample.kept:
        batch = traffic.make_batch(cell.workload, cell.config, seed, rec.index)
        out = {"tables": [np.asarray(t.numpy(), dtype=np.int32)
                          for t in rec.tables],
               "commitment": [to_plain(rec.commitment.l_variate_polys_commitment.C),
                              to_plain(rec.commitment.log_m_variate_polys_commitment.C)],
               "proof": to_plain(rec.proof)}
        notes: list[str] = []
        counts = check.judge(
            batch.indices, batch.r, cell.config["log_M"],
            cell.config["strategy"], out, TRANSCRIPT_LABEL, GENS_LABEL,
            traffic.rng_for(seed, rec.index, _WEIGHTS_STREAM), notes)
        for note in notes:
            log(f"pass {rec.index}: {note}")
        for k, v in counts.items():
            totals[k] += v
    log(f"checked passes {sorted(r.index for r in sample.kept)} of "
        f"{sample.offered}")
    return totals
