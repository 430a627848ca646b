"""The port's bench suites and CLI (lasso_tpu_torch.benches.bench,
lasso_tpu_torch.cli) on the CPU.

The suites' grids are held against the reference's (a16z/Lasso
src/benches/bench.rs:90-233, mirrored in the JAX package's
benches/bench.py), written out here as constants; the passes themselves run
at a tiny shape, because an M=2^16 pass takes minutes on a CPU.
"""

import torch

from lasso_tpu_torch import cli
from lasso_tpu_torch.benches import bench
from lasso_tpu_torch.ops import field_cuda

# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

# (strategy, C, M, s) of every pass of each suite, from bench.rs
JOLT_DEMO = [("and", 8, 1 << 16, 1 << k) for k in (10, 12, 14, 16, 18, 20, 22)]
HALO2_COMPARISON = [("and", 1, 1 << 16, 1 << k)
                    for k in (10, 12, 14, 16, 18, 20, 22, 24)]


def _recorder(monkeypatch):
    calls = []

    def fake(strategy_name, c, m, sparsity, device="cuda", **kwargs):
        calls.append((strategy_name, c, m, sparsity, str(device)))
        return bench.BenchResult(f"{strategy_name}-{c}-{m}-{sparsity}",
                                 0.001, 0.002, 0.003)

    monkeypatch.setattr(bench, "single_pass_lasso", fake)
    return calls


def _check_suite_grids(monkeypatch):
    for name, grid in (("jolt-demo", JOLT_DEMO),
                       ("halo2-comparison", HALO2_COMPARISON)):
        with monkeypatch.context() as mp:
            calls = _recorder(mp)
            results = bench.SUITES[name]()
        assert [c[:4] for c in calls] == grid
        assert all(c[4] == "cuda" for c in calls)  # the card by default
        assert len(results) == len(grid)


def _check_cli_flags(monkeypatch, capsys):
    capsys.readouterr()
    with monkeypatch.context() as mp:
        calls = _recorder(mp)
        assert cli.main(["--name", "jolt-demo", "--s-min", "16",
                         "--s-max", "16", "--device", "cpu"]) == 0
        assert calls == [("and", 8, 1 << 16, 1 << 16, "cpu")]
        calls.clear()
        assert cli.main(["--name", "halo2-comparison", "--s-min", "10",
                         "--s-max", "14"]) == 0
    assert calls == [("and", 1, 1 << 16, 1 << k, "cuda") for k in (10, 12, 14)]
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "and-1-65536-16384: commit 1.0ms  prove 2.0ms  verify 3.0ms"


def _check_single_pass_on_cpu():
    before = dict(field_cuda.launch_counts)
    res = bench.single_pass_lasso("lt", 4, 16, 16, device="cpu")
    assert field_cuda.launch_counts == before  # plain versions on the CPU
    assert res.name == "Lasso(strategy=lt, C=4, M=2^4, s=2^4)"
    assert res.commit_s > 0 and res.prove_s > 0 and res.verify_s > 0


def _check_cli_tiny_pass(monkeypatch, capsys):
    """The CLI end to end with a real pass: the jolt-demo suite with its
    pass cut to AND, C=4, M=16, s=16 (prove, verify, chart)."""
    real = bench.single_pass_lasso

    def tiny(strategy_name, c, m, sparsity, device="cuda", **kwargs):
        return real(strategy_name, 4, 16, 16, device, **kwargs)

    capsys.readouterr()
    with monkeypatch.context() as mp:
        mp.setattr(bench, "single_pass_lasso", tiny)
        assert cli.main(["--name", "jolt-demo", "--s-min", "16",
                         "--s-max", "16", "--device", "cpu", "--chart"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Lasso(strategy=and, C=4, M=2^4, s=2^4): commit ")
    assert "SparsePoly.prove" in out and "SparsePoly.verify" in out


def test_suites_cli_and_single_pass_on_cpu(monkeypatch, capsys):
    """The suites' grids, the CLI's flags, single_pass_lasso on the CPU and
    the CLI end to end with a tiny real pass, as one test item: the tier-1
    suite keeps its item count (ROADMAP.md, ground rules)."""
    _check_suite_grids(monkeypatch)
    _check_cli_flags(monkeypatch, capsys)
    _check_single_pass_on_cpu()
    _check_cli_tiny_pass(monkeypatch, capsys)
