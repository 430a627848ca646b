"""A `--trace 1` run on the CPU at a tiny size reads a number for each
metric of the primary sumcheck and the deref commitment
(`primary_sumcheck_ms`, `primary_sumcheck_launches`, `derefs_commit_ms`):
the profiled pass turns the program's tracing on, and nothing resets its
span tree before the readers run.  Without a traced prove or a pass, those
readers give None."""

from benchmark import manifest
from benchmark.run import run
from benchmark.trace import Trace

SEED = 2**31 + 4545
TINY = {"name": "tiny", "strategy": "and", "C": 2, "log_M": 8,
        "curve_path": "fused", "transcript": "device"}
READERS = ("primary_sumcheck_ms", "primary_sumcheck_launches",
           "derefs_commit_ms")


def test_traced_run_reads_the_sumcheck_and_commit_spans():
    per_layer = [m for m in manifest.load()["per_layer"]
                 if m["name"] in READERS + ("gp_launches",)]
    assert sorted(m["name"] for m in per_layer) == \
        sorted(READERS + ("gp_launches",))
    assert all("workloads" not in m and m["moves"] == "prove_s"
               for m in per_layer)
    workload = {"config": "tiny", "s": 16, "law": "uniform", "params": {}}
    cell = manifest.Cell("tiny", 1, TINY, workload, [], per_layer)
    result, code = run(cell, SEED, 0.5, True, device="cpu")
    assert code == 0 and result["correct"], result
    values = {m["name"]: result["metrics"][m["name"]]["value"]
              for m in per_layer}
    assert isinstance(values["primary_sumcheck_launches"], int), values
    assert 0 < values["primary_sumcheck_launches"] < values["gp_launches"]
    assert values["primary_sumcheck_ms"] > 0 and values["derefs_commit_ms"] > 0


def test_readers_give_none_without_a_traced_prove():
    from lasso_tpu_torch.utils import tracing

    tracing.reset_spans()
    trace = Trace([], None, None, None)
    for name in READERS:
        assert manifest.reader(name)(trace) is None, name
