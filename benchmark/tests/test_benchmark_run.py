"""A run end to end on the CPU at a tiny size, for the AND and the LT
strategy, each configuration given as a dict: the reference agrees with the
port, each planted fault and the control make `correct` false, a run
without a card prints no result, and nothing the benchmark runs loads JAX
or the JAX package (the reference loads nothing of the port either)."""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import faults, harness, manifest, traffic
from benchmark.control import reading
from benchmark.reference import check
from benchmark.run import run

ROOT = manifest.ROOT
SEED = 2**31 + 4242
TINY = {"name": "tiny", "strategy": "and", "C": 2, "log_M": 8,
        "curve_path": "fused", "transcript": "device"}
# 2C = 4 memories and a collation of degree C, from a dict and no file
TINY_LT = {**TINY, "name": "tiny-lt", "strategy": "lt"}
E2E = [{"name": n, "unit": "s"} for n in
       ("prover_s", "prove_s", "verify_s", "setup_s")]


def _cell(config=TINY, law="uniform", s=64):
    wl = {"config": config["name"], "s": s, "law": law,
          "params": {"operand_bits": 8}}
    return manifest.Cell(config["name"], 1, config, wl, E2E, [])


def _sub(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module", params=[TINY, TINY_LT],
                ids=lambda c: c["strategy"])
def config(request):
    return request.param


@pytest.fixture(scope="module")
def prog(config):
    return harness.Program(config, _cell(config).workload, "cpu")


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "halo2-s14",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_reference_agrees_with_the_port_on_cpu(config):
    for law in ("uniform", "operand-bytes"):
        result, code = run(_cell(config, law), SEED, 0.5, False, device="cpu")
        assert code == 0 and result["correct"], result
        assert result["attempted"] >= 1 and result["failed"] == 0
        assert set(result["metrics"]) == {m["name"] for m in E2E}
        assert all(v["value"] == 0 for v in result["compared"].values())
        assert list(result)[-1] == "compared"
        # a CPU run never names a device number
        assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_makes_correct_false(fault, config):
    cell = _cell(config)
    with faults.planted(fault):
        result, code = run(cell, SEED, 0.5, False, device="cpu")
    assert code == 0 and result["correct"] is False, result


def test_judged_passes_are_a_seeded_uniform_sample():
    def drawn(seed, n):
        sample = harness.Sample(seed)
        for i in range(n):
            keep = sample.draw()
            sample.put(harness.PassRecord(i, 0, 0, 0, [], 0, None, None, None))
            assert keep == any(r.index == i for r in sample.kept)
        return sorted(r.index for r in sample.kept)

    assert drawn(SEED, 1) == [0]
    assert drawn(SEED, 9) == drawn(SEED, 9)
    assert len(drawn(SEED, 9)) == harness.CHECKED_PASSES
    # every pass of a window of 6 is drawn about as often as another
    counts = np.zeros(6)
    for seed in range(3000):
        counts[drawn(SEED + seed, 6)] += 1
    assert np.all(np.abs(counts / 3000 - 2 / 6) < 0.04), counts


def test_control_readings(prog, config):
    sound = reading(prog, _cell(config), SEED, None)
    assert sound["raised"] is None
    assert all(sound[k] == 0 for k in check.LIMITS)
    low = reading(prog, _cell(config), SEED + 1, "lowprec")
    assert any(low[k] > check.LIMITS[k] for k in check.LIMITS)


def test_judge_catches_an_answer_altered_where_it_is_produced(prog, config):
    cell = _cell(config)
    batch = traffic.make_batch(cell.workload, config, SEED, 7)
    dense, comm = prog.densify_commit(batch.indices)
    tables = [dense.combined_l_variate_polys.z.numpy().copy(),
              dense.combined_log_m_variate_polys.z.numpy().copy()]
    proof = prog.prove(dense, batch.r)
    out = {"tables": tables,
           "commitment": [harness.to_plain(comm.l_variate_polys_commitment.C),
                          harness.to_plain(comm.log_m_variate_polys_commitment.C)],
           "proof": harness.to_plain(proof)}

    def judge(o):
        return check.judge(batch.indices, batch.r, config["log_M"],
                           config["strategy"], o,
                           harness.TRANSCRIPT_LABEL, harness.GENS_LABEL,
                           np.random.default_rng(1), [])

    assert all(v == 0 for v in judge(out).values())
    bad = copy.deepcopy(out)
    bad["tables"][0][5, 0] ^= 1
    assert judge(bad)["densify_mismatch"] == 1
    bad = copy.deepcopy(out)
    bad["commitment"][0][0], bad["commitment"][0][1] = \
        bad["commitment"][0][1], bad["commitment"][0][0]
    assert judge(bad)["commit_mismatch"] == 1
    bad = copy.deepcopy(out)
    bad["proof"]["primary_sumcheck"]["claimed_evaluation"] += 1
    got = judge(bad)
    assert got["claim_mismatch"] == 1 and got["proof_rejected"] == 1
    bad = copy.deepcopy(out)
    layer = bad["proof"]["memory_check"]["proof_prod_layer"]["proof_ops"]["proof"][2]
    layer["claims_prod_left"][0] = (layer["claims_prod_left"][0] + 1) % check.lasso.FR
    assert judge(bad)["proof_rejected"] == 1


FORBIDDEN = "('jax', 'jaxlib', 'flax', 'lasso_tpu')"


def test_benchmark_loads_no_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from benchmark import run, trace, control, faults, harness\n"
        "harness.Program({'strategy': 'and', 'C': 1, 'log_M': 4, "
        "'curve_path': 'fused', 'transcript': 'device'}, {'s': 16}, 'cpu')\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}} & set({FORBIDDEN}))\n"
        "assert 'lasso_tpu_torch' in sys.modules\n"
        "print(bad)\n")
    proc = _sub(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_reference_loads_nothing_of_the_port():
    ref = os.path.join(ROOT, "benchmark", "reference")
    names = sorted(n[:-3] for n in os.listdir(os.path.join(ref, "strategies"))
                   if n.endswith(".py") and n != "__init__.py")
    assert {"and", "lt"} <= set(names)
    code = ("import sys\n"
            "import benchmark.reference.check, benchmark.traffic\n"
            "from benchmark.reference import strategies\n"
            f"for name in {names!r}:\n"
            "    strategies.strategy(name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lasso_tpu_torch', 'lasso_tpu', 'jax', 'torch'}))\n")
    proc = _sub(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for folder, _, files in os.walk(ref):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(folder, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom)
                        else [])
                for mod in mods:
                    top = mod.split(".")[0]
                    assert top not in ("lasso_tpu_torch", "lasso_tpu", "jax"), \
                        (name, mod)
