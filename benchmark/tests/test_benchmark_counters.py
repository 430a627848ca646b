"""A `--trace 1` run on the CPU at a tiny size reads a count for each
per-layer metric that sums the program's span counters
(benchmark/span_counts.py): the profiled pass turns the program's tracing
on, and nothing resets its span tree before the readers run."""

from benchmark import manifest
from benchmark.run import run

SEED = 2**31 + 4343
TINY = {"name": "tiny", "strategy": "and", "C": 2, "log_M": 8,
        "curve_path": "fused", "transcript": "device"}
COUNTERS = ("gp_launches", "opening_launches", "tfield_launches",
            "host_syncs")


def test_traced_run_reads_the_span_counters():
    per_layer = [m for m in manifest.load()["per_layer"]
                 if m["name"] in COUNTERS]
    assert sorted(m["name"] for m in per_layer) == sorted(COUNTERS)
    assert all(m["source"] == "program_counter" and m["unit"] == "count"
               and "workloads" not in m for m in per_layer)
    workload = {"config": "tiny", "s": 16, "law": "uniform", "params": {}}
    cell = manifest.Cell("tiny", 1, TINY, workload, [], per_layer)
    result, code = run(cell, SEED, 0.5, True, device="cpu")
    assert code == 0 and result["correct"], result
    values = {k: result["metrics"][k]["value"] for k in COUNTERS}
    assert all(isinstance(v, int) for v in values.values()), values
    assert values["gp_launches"] > 0 and values["opening_launches"] > 0
    assert values["tfield_launches"] > 0 and values["host_syncs"] >= 0
