"""A run end to end on the CPU of `jolt-lt-s16`'s configuration at its own
C = 8, read from its file with 2-bit operand halves (log_M = 4) and s = 64:
16 memories and a degree-9 primary sumcheck, as on the card.  The
reference agrees with the port with all four counts 0, each planted fault
(`altered` among them) makes `correct` false, the `lowprec` control reads
nonzero, and the judge catches outputs altered by hand."""

import copy
import json
import os

import numpy as np
import pytest

from benchmark import faults, harness, manifest, traffic
from benchmark.control import reading
from benchmark.reference import check
from benchmark.run import run

SEED = 2**31 + 4646
with open(os.path.join(manifest.ROOT, "benchmark", "configs",
                       "jolt-lt-c8-m16.json")) as f:
    CONFIG = {**json.load(f), "log_M": 4}
E2E = [{"name": n, "unit": "s"} for n in
       ("prover_s", "prove_s", "verify_s", "setup_s")]


def _cell(law="uniform"):
    bits = CONFIG["C"] * (CONFIG["log_M"] // 2)
    wl = {"config": CONFIG["name"], "s": 64, "law": law,
          "params": {"operand_bits": bits}}
    return manifest.Cell(CONFIG["name"], 1, CONFIG, wl, E2E, [])


def test_configuration_is_lt_at_eight_chunks():
    assert (CONFIG["strategy"], CONFIG["C"]) == ("lt", 8)


@pytest.mark.parametrize("law", ["uniform", "operand-bytes"])
def test_reference_agrees_with_the_port_at_c8(law):
    result, code = run(_cell(law), SEED, 0.5, False, device="cpu")
    assert code == 0 and result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(v["value"] == 0 for v in result["compared"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_makes_correct_false_at_c8(fault):
    with faults.planted(fault):
        result, code = run(_cell(), SEED, 0.5, False, device="cpu")
    assert code == 0 and result["correct"] is False, result


@pytest.fixture(scope="module")
def prog():
    return harness.Program(CONFIG, _cell().workload, "cpu")


def test_control_readings_at_c8(prog):
    cell = _cell()
    sound = reading(prog, cell, SEED, None)
    assert sound["raised"] is None
    assert all(sound[k] == 0 for k in check.LIMITS)
    low = reading(prog, cell, SEED + 1, "lowprec")
    assert any(low[k] > check.LIMITS[k] for k in check.LIMITS)


def test_judge_catches_altered_outputs_at_c8(prog):
    batch = traffic.make_batch(_cell().workload, CONFIG, SEED, 7)
    dense, comm = prog.densify_commit(batch.indices)
    out = {"tables": [dense.combined_l_variate_polys.z.numpy().copy(),
                      dense.combined_log_m_variate_polys.z.numpy().copy()],
           "commitment": [harness.to_plain(comm.l_variate_polys_commitment.C),
                          harness.to_plain(comm.log_m_variate_polys_commitment.C)],
           "proof": harness.to_plain(prog.prove(dense, batch.r))}

    def judge(o):
        return check.judge(batch.indices, batch.r, CONFIG["log_M"],
                           CONFIG["strategy"], o,
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
