"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the start of this module): build or load
the kernels from the program's build directory inside the checkout, derive
the cell's generators, and prove one warm-up pass on a batch of the cell's
own shape.  Then the window of passes (benchmark/harness.py).  With
`--trace 1`, one more pass is profiled (benchmark/trace.py) and the line
carries the per-layer metrics; with `--trace 0`, the end-to-end ones.
Last, the reference judges a sample of the passes drawn from the seed.

The last line of standard output is one JSON object: `correct`,
`attempted` (passes in the window), `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `compared`, each number the reference
compared beside its limit; the same numbers end standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from benchmark import harness, manifest, traffic  # noqa: E402
from benchmark.reference import check  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float = T0) -> tuple[dict | None, int]:
    """One run; returns (the result, the exit code).  No result when a
    forbidden module was loaded."""
    import torch

    cuda = device == "cuda"
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": 0}
    t_program = time.perf_counter()
    prog = harness.Program(cell.config, cell.workload, device)
    t_warm = time.perf_counter()
    try:
        harness.run_pass(prog, traffic.make_batch(cell.workload, cell.config,
                                                  seed, 0), 0)
    except Exception:  # the program failed in its warm-up pass
        log("warm-up pass raised:\n" + traceback.format_exc())
        return {"correct": False, "attempted": 1, "failed": 1, "metrics": {},
                "device": device_info,
                "compared": {k: {"value": None, "limit": v}
                             for k, v in check.LIMITS.items()}}, 0
    t_gc = time.perf_counter()
    # what set-up left is collected and frozen, so that the collector does
    # not scan it again inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    steps = {"imports_s": t_program - t0,
             "program_s": t_warm - t_program, **prog.setup_steps,
             "warm_up_pass_s": t_gc - t_warm,
             "gc_s": time.perf_counter() - t_gc}
    log(f"setup_s {setup_s} {steps}")

    sample = harness.Sample(seed)
    window = harness.run_window(prog, cell, seed, seconds, 1, sample, log)
    device_info["memory_peak_bytes"] = \
        torch.cuda.max_memory_allocated() if cuda else 0
    n = len(window.passes)
    log(f"window {window.seconds} s, {n} passes, {window.failed} failed")

    result = {"correct": False, "attempted": n + window.failed,
              "failed": window.failed, "metrics": {}, "device": device_info}
    if trace and n and not window.failed:
        from benchmark import roofline
        from benchmark import trace as tr

        index = window.passes[-1].index
        for _ in range(2):  # a profiler session now and then sees
            index += 1  # no device event: once more
            keep = sample.draw()
            rec, p_commit, p_prove = tr.profiled_pass(
                prog, traffic.make_batch(cell.workload, cell.config, seed,
                                         index), index, keep)
            sample.put(rec)
            if not cuda or (p_commit.events and p_prove.events):
                break
            log(f"profiled pass {index} saw no device event")
        peaks = roofline.card_peaks(
            torch.cuda.get_device_properties(0).multi_processor_count) \
            if cuda else roofline.Peaks(roofline.PEAK_BYTES_PER_S, 0.0, "cpu")
        log(f"peaks: {peaks.bytes_per_s} B/s, {peaks.ops_per_s} 32-bit "
            f"multiplies/s; card {peaks.card}")
        ctx = tr.Trace(window.passes, p_commit, p_prove, peaks, log)
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(ctx)
            if value is None:
                log(f"{m['name']}: nothing to read")
            else:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if cuda:
            device_info["busy_s"] = p_commit.busy_s() + p_prove.busy_s()
            device_info["window_s"] = p_commit.wall_s + p_prove.wall_s
            result["breakdown"] = tr.breakdown([p_commit, p_prove])
    elif n:
        means = {"prover_s": sum(p.commit_s + p.prove_s
                                 for p in window.passes) / n,
                 "prove_s": sum(p.prove_s for p in window.passes) / n,
                 "verify_s": sum(p.verify_s for p in window.passes) / n,
                 "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in means:
                result["metrics"][m["name"]] = {"value": means[m["name"]],
                                                "unit": m["unit"]}

    found = harness.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None, 4
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    counts = harness.judge(cell, seed, sample, log)
    log(f"reference {time.perf_counter() - t_check} s")
    result["correct"] = bool(n and not window.failed and all(
        counts[k] <= check.LIMITS[k] for k in check.LIMITS))
    result["compared"] = {k: {"value": counts[k], "limit": check.LIMITS[k]}
                          for k in check.LIMITS}
    return result, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = manifest.cell(args.workload)
    import torch

    # one process with one intra-op thread: idle CPU worker threads would
    # only compete with the host thread that dispatches the launches
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 1
    result, code = run(cell, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return code
    found = harness.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 4
    for k, v in result["compared"].items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
