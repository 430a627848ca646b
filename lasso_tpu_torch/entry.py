"""Entry points: one primary-sumcheck round, and the multi-device dry run
(port of the JAX package's __graft_entry__.py).

    python -m lasso_tpu_torch.entry --devices 8 --device cpu
    python -m lasso_tpu_torch.entry --devices 4 --device cuda --backend gloo

`entry()` returns the hot per-round step of the Lasso prover on the
flagship strategy: one primary-sumcheck round (round-polynomial
evaluations and the bind) for AND.

`dryrun_multichip(n)` runs the whole sharded prove (prove(..., mesh=):
sharded commit, psum sumcheck rounds, openings, grand products, hash
layer) as n ranks on a tiny instance, holds the ranks' proofs equal, and
verifies the proof with the single-device verifier.

`prove_instances` is the rank function that proves each instance sharded
and returns its bytes, times and kernel launches; the tests and
chip_smoke.py launch it too.  Everything runs on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
import lasso_tpu_torch.subtables.lt  # noqa: F401
import lasso_tpu_torch.subtables.range_check  # noqa: F401
from lasso_tpu_torch.curve import tcurve
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.lasso.densified import (DensifiedRepresentation,
                                             resolve_device)
from lasso_tpu_torch.lasso.surge import (SparsePolyCommitmentGens,
                                         SparsePolynomialEvaluationProof)
from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.parallel.sharded import ShardedDensified
from lasso_tpu_torch.parallel.launch import spawn
from lasso_tpu_torch.subprotocols.sumcheck import _bind_top, _round_evals
from lasso_tpu_torch.subtables.base import get_strategy
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript
from lasso_tpu_torch.transcript.random_tape import RandomTape
from lasso_tpu_torch.utils.fixtures import gen_indices, gen_random_point
from lasso_tpu_torch.utils import tracing
from lasso_tpu_torch.utils.serialize import (serialize_commitment,
                                             serialize_proof)


def entry(device="cuda"):
    """(round_step, (stack, r)): round_step(stack, r) returns the round's
    evaluations [degree+1, W] and the bound stack, for AND, C=4, M=2^16 on
    an [alpha+1, 2^10] stack."""
    device = resolve_device(device)
    strategy = get_strategy("and", 4, 1 << 16)
    degree = strategy.sumcheck_poly_degree()
    comb = strategy.comb_eq_device()
    rng = np.random.default_rng(0)
    stack = TFr.encode_u64_array(rng.integers(
        0, 1 << 16, size=(strategy.num_memories + 1, 1 << 10)).astype(
            np.uint64), device)
    r = TFr.encode_scalar(0x1234567890ABCDEF, device)

    def round_step(zs, r_limb):
        return _round_evals(zs, comb, degree), _bind_top(zs, r_limb)

    return round_step, (stack, r)


@dataclass(frozen=True)
class Spec:
    """One instance: the reference's deterministic lookups (gen_indices)
    and point (gen_random_point) for (strategy, C, M, s)."""

    strategy: str
    c: int
    m: int
    s: int
    options: tuple = ()  # (name, value) pairs for get_strategy
    fused: bool = True  # the fused curve path (K3); False: unfused (K2)


def dryrun_spec(n_devices: int) -> Spec:
    """The dry run's tiny instance: AND, C=2, M=16, s = max(2D, 16)."""
    return Spec("and", 2, 16, max(2 * n_devices, 16))


def _sync(device) -> None:
    if device.type == "cuda":
        tracing.synchronize(device)


def _peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def prove_instances(mesh, specs, repeats: int = 1) -> list[dict]:
    """Rank function: densify, commit and prove each instance sharded over
    the mesh `repeats` times; rank 0 also verifies the proof with the
    single-device verifier.  Per instance: the proof and commitment bytes,
    commit_s, each prove's prove_s, the last prove's kernel launches, and
    two peaks of device memory (None on the CPU): `peak_mem_bytes` from
    the densify on (every rank densifies the whole instance, as in the
    reference), `shard_peak_mem_bytes` from the shard's commit on."""
    out = []
    dev = mesh.device
    for spec in specs:
        tcurve.set_fused_padd(spec.fused)
        try:
            strategy = get_strategy(spec.strategy, spec.c, spec.m,
                                    **dict(spec.options))
            log_m, log_s = (spec.m - 1).bit_length(), (spec.s - 1).bit_length()
            r = gen_random_point(log_s)
            gens = SparsePolyCommitmentGens.new(
                b"gens_sparse_poly", spec.c, spec.s, strategy.num_memories,
                log_m, device=dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            sd = ShardedDensified(mesh, DensifiedRepresentation(
                gen_indices(spec.s, spec.m, spec.c), log_m, spec.c,
                device=dev))
            _sync(dev)
            peak = _peak(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            comm = sd.commit(gens)
            _sync(dev)
            commit_s = time.perf_counter() - t0
            prove_s, first = [], None
            for _ in range(repeats):
                field_cuda.reset_launch_counts()
                t0 = time.perf_counter()
                proof = SparsePolynomialEvaluationProof.prove(
                    sd, r, gens, strategy, ProofTranscript(b"example"),
                    RandomTape(b"proof"), mesh=mesh)
                _sync(dev)
                prove_s.append(time.perf_counter() - t0)
                pb = serialize_proof(proof)
                if first is not None and pb != first:
                    raise RuntimeError(f"{spec}: repeated proves differ")
                first = pb
            launches = dict(field_cuda.launch_counts)
            shard_peak = _peak(dev)
            peak = None if peak is None else max(peak, shard_peak)
            if mesh.rank == 0:
                proof.verify(comm, r, gens, ProofTranscript(b"example"))
        finally:
            tcurve.set_fused_padd(None)
        out.append({"proof": pb, "commitment": serialize_commitment(comm),
                    "verified": mesh.rank == 0, "commit_s": commit_s,
                    "prove_s": prove_s, "launches": launches,
                    "peak_mem_bytes": peak,
                    "shard_peak_mem_bytes": shard_peak})
    return out


def agreed(results: list[list[dict]]) -> list[dict]:
    """Rank 0's results, after checking that every rank returned the same
    proof and commitment bytes for every instance."""
    for rank, res in enumerate(results):
        for i, (got, want) in enumerate(zip(res, results[0])):
            for key in ("proof", "commitment"):
                if got[key] != want[key]:
                    raise RuntimeError(
                        f"instance {i}: rank {rank}'s {key} bytes differ "
                        "from rank 0's")
    return results[0]


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """The whole sharded prove of dryrun_spec(n_devices) as n_devices ranks
    (NCCL on the card, gloo on the CPU, unless `backend` says otherwise),
    verified by the single-device verifier.  Returns rank 0's result."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    results = spawn(prove_instances, n_devices, backend, device,
                    [dryrun_spec(n_devices)])
    res = agreed(results)[0]
    print(f"dryrun_multichip({n_devices}): OK on {backend}/{device}: "
          f"proof_len={len(res['proof'])} verified={res['verified']}",
          flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args()
    dryrun_multichip(args.devices, args.device, args.backend)
    step, (stack, r) = entry(args.device)
    evals, bound = step(stack, r)
    _sync(evals.device)
    print(f"entry: OK evals={tuple(evals.shape)} bound={tuple(bound.shape)}",
          flush=True)


if __name__ == "__main__":
    main()
