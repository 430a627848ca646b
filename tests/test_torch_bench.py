"""The port's bench suites and CLI (lasso_tpu_torch.benches.bench,
lasso_tpu_torch.cli) and its subtable strategies (port of
tests/test_subtables.py) on the CPU.

The suites' grids are held against the reference's (a16z/Lasso
src/benches/bench.rs:90-233, mirrored in the JAX package's
benches/bench.py), written out here as constants; the passes themselves run
at a tiny shape, because an M=2^16 pass takes minutes on a CPU.  The
strategies are held against their own subtable MLEs, the host combine and
the reference's pinned table entries.
"""

import numpy as np
import torch

import lasso_tpu_torch.subtables.bitwise  # noqa: F401 (register strategies)
import lasso_tpu_torch.subtables.lt  # noqa: F401
import lasso_tpu_torch.subtables.range_check  # noqa: F401
from lasso_tpu_torch import cli
from lasso_tpu_torch.benches import bench
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.poly.dense import eq_table
from lasso_tpu_torch.subtables.base import (HostOps, get_strategy,
                                            list_strategies)
from lasso_tpu_torch.subtables.container import Subtables

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


def _bits(k, n):
    """index -> field bit vector, MSB first (reference: utils/mod.rs:33-46)."""
    return [(k >> (n - 1 - i)) & 1 for i in range(n)]


def _check_materialization_mle_parity():
    """table[i][k] == evaluate_subtable_mle(i, bits(k)) over the whole
    hypercube, for every strategy (the reference's
    materialization_mle_parity_test!, src/subtables/test.rs:15-40)."""
    m, log_m = 64, 6
    for name, kwargs in (("and", {}), ("or", {}), ("xor", {}), ("lt", {}),
                         ("range_check", {"log_r": 10})):
        strategy = get_strategy(name, 2, m, **kwargs)
        tables = strategy.materialize_subtables()
        for i in range(tables.shape[0]):
            for k in range(m):
                got = strategy.evaluate_subtable_mle(i, _bits(k, log_m))
                assert got == int(tables[i][k]) % Fr.p, (name, i, k)


def _check_pinned_tables_and_combines():
    """The reference's pinned entries: AND, OR, XOR and LT tables at M=16
    (and.rs:70-92, lt.rs), the AND and LT collations g (and.rs:94-110,
    lt.rs:85-111) and range check's bit-budget memory maps
    (range_check.rs:62-73)."""
    t = get_strategy("and", 2, 16).materialize_subtables()[0]
    assert (t[0b00_00], t[0b11_11], t[0b11_01], t[0b10_11]) == \
        (0b00, 0b11, 0b01, 0b10)
    t_or = get_strategy("or", 2, 16).materialize_subtables()[0]
    t_xor = get_strategy("xor", 2, 16).materialize_subtables()[0]
    assert t_or[0b10_01] == 0b11 and t_xor[0b10_01] == 0b11
    assert t_or[0b11_01] == 0b11 and t_xor[0b11_01] == 0b10
    lt, eq = get_strategy("lt", 2, 16).materialize_subtables()
    assert lt[0b01_10] == 1 and lt[0b10_01] == 0 and lt[0b01_01] == 0
    assert eq[0b01_01] == 1 and eq[0b01_10] == 0

    strategy = get_strategy("and", 3, 1 << 16)
    assert strategy.combine_lookups([3, 5, 7], HostOps) == \
        (3 + 5 * (1 << 8) + 7 * (1 << 16)) % Fr.p
    lt0, eq0, lt1, eq1, lt2, eq2 = 2, 3, 5, 7, 11, 13
    assert get_strategy("lt", 3, 16).combine_lookups(
        [lt0, eq0, lt1, eq1, lt2, eq2], HostOps) == \
        (lt0 + lt1 * eq0 + lt2 * eq0 * eq1) % Fr.p

    s3 = get_strategy("range_check", 3, 1 << 16, log_r=40)
    assert [s3.memory_to_subtable_index(i) for i in range(3)] == [0, 0, 1]
    assert [s3.memory_to_dimension_index(i) for i in range(3)] == [0, 1, 2]
    s4 = get_strategy("range_check", 4, 1 << 16, log_r=40)
    assert [s4.memory_to_subtable_index(i) for i in range(4)] == [0, 0, 1, 2]


def _check_registry_and_subtables_views():
    """list_strategies names every strategy; Subtables.lookup_polys are the
    gathered table entries E_i = T_sub(i)[nz_dim(i)], and
    combine_eq_device is the primary sumcheck's combine function, equal to
    the host combine of every row times eq."""
    assert list_strategies() == sorted(
        ["and", "lt", "or", "range_check", "xor"])
    rng = np.random.default_rng(43)
    c, m, s = 2, 16, 8
    strategy = get_strategy("lt", c, m)
    nz = torch.as_tensor(rng.integers(0, m, size=(c, s)))
    subtables = Subtables(strategy, nz, s)
    tables = strategy.materialize_subtables()
    polys = subtables.lookup_polys
    assert len(polys) == strategy.num_memories
    rows = []
    for i, poly in enumerate(polys):
        sub = strategy.memory_to_subtable_index(i)
        dim = strategy.memory_to_dimension_index(i)
        rows.append(poly.to_ints())
        assert rows[-1] == [int(tables[sub][k]) for k in nz[dim].tolist()]
    r = [int(v) for v in rng.integers(1, 2**62, size=3)]
    eq = eq_table(r, "cpu")
    zs = subtables.stack_with_eq(eq)
    got = subtables.combine_eq_device(zs)
    assert torch.equal(got, strategy.comb_eq_device()(zs))
    eq_host = TFr.decode(eq)
    assert TFr.decode(got) == [
        strategy.combine_lookups_eq([row[k] for row in rows] + [eq_host[k]],
                                    HostOps) for k in range(s)]
    assert subtables.compute_sumcheck_claim(eq) == sum(TFr.decode(got)) % Fr.p


def test_suites_cli_and_single_pass_on_cpu(monkeypatch, capsys):
    """The suites' grids, the CLI's flags, single_pass_lasso on the CPU, the
    CLI end to end with a tiny real pass, and the subtable strategies, as
    one test item: the tier-1 suite keeps its item count (ROADMAP.md,
    ground rules)."""
    _check_suite_grids(monkeypatch)
    _check_cli_flags(monkeypatch, capsys)
    _check_single_pass_on_cpu()
    _check_cli_tiny_pass(monkeypatch, capsys)
    _check_materialization_mle_parity()
    _check_pinned_tables_and_combines()
    _check_registry_and_subtables_views()
