"""Every entry of BENCHMARK.json resolves to its files, and the manifest
keeps the limits of the manifest format (names, units, bounds, sizes)."""

import json
import os
import re

from benchmark import manifest, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_resolves():
    bench = manifest.load()
    assert set(bench["paths"]) == {"benchmark"}
    for conf in bench["configs"]:
        assert conf["file"].startswith("benchmark/configs/")
        with open(os.path.join(manifest.ROOT, conf["file"])) as f:
            data = json.load(f)
        assert data["name"] == conf["name"]
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"] == []
    used = set()
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], bench)
        used.add(w["config"])
        assert w["traffic"] == w["name"] and w["chips"] == 1
        assert traffic.law(cell.workload["law"]).sample
        e2e = {m["name"] for m in cell.end_to_end}
        assert e2e >= {"setup_s", "prover_s", "prove_s"}
        if w["name"] == "jolt-s16":  # where the verify's clock is steady
            assert "verify_s" in e2e
        assert len(cell.per_layer) >= 6
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(manifest.reader(m["name"]))
    assert used == {c["name"] for c in bench["configs"]}


def test_manifest_shape():
    bench = manifest.load()
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(bench)) < 64 * 1024
