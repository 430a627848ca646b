"""The readings that the limits of `benchmark.reference.check` are set
from: sound passes of the program on some seeds and passes with a planted
fault (`benchmark.faults`) on others, all at the cell's own size, in one
process on the card.  The benchmark's own runs do not run this.

    python3 -m benchmark.control --workload <cell> --sound <seeds> \\
        --faulty <seeds> --fault lowprec

Each pass prints one JSON line: the seed, the fault (or null), the
reference's counts, and what the program raised, if anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

from benchmark import faults, harness, manifest, traffic
from benchmark.reference import check


def reading(prog, cell, seed: int, fault: str | None) -> dict:
    batch = traffic.make_batch(cell.workload, cell.config, seed, 1)
    raised = None
    tables = comm = proof = None
    t0 = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        try:
            dense, comm = prog.densify_commit(batch.indices)
            tables = [dense.combined_l_variate_polys.z.cpu(),
                      dense.combined_log_m_variate_polys.z.cpu()]
            proof = prog.prove(dense, batch.r)
            del dense
            prog.verify(proof, comm, batch.r)
        except Exception as e:  # a faulty program may fail anywhere
            raised = f"{type(e).__name__}: {e}"
            print(traceback.format_exc(), file=sys.stderr)
    prog.sync()
    pass_s = time.perf_counter() - t0
    notes: list[str] = []
    if tables is None:
        counts = {k: 1 for k in check.LIMITS}
    else:
        out = {"tables": [t.numpy() for t in tables],
               "commitment": [
                   harness.to_plain(comm.l_variate_polys_commitment.C),
                   harness.to_plain(comm.log_m_variate_polys_commitment.C)],
               "proof": None if proof is None else harness.to_plain(proof)}
        counts = check.judge(batch.indices, batch.r, cell.config["log_M"],
                             cell.config["strategy"], out,
                             harness.TRANSCRIPT_LABEL, harness.GENS_LABEL,
                             traffic.rng_for(seed, 1, 3), notes)
    return {"seed": seed, "fault": fault, **counts, "raised": raised,
            "pass_s": pass_s, "notes": notes[:4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--faulty", default="")
    ap.add_argument("--fault", default="lowprec", choices=faults.FAULTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    import torch

    torch.set_num_threads(1)  # as benchmark.run
    prog = harness.Program(cell.config, cell.workload, args.device)
    seeds = [(int(s), None) for s in args.sound.split(",") if s] + \
            [(int(s), args.fault) for s in args.faulty.split(",") if s]
    for seed, fault in seeds:
        print(json.dumps(reading(prog, cell, seed, fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
