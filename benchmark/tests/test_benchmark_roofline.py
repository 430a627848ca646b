"""The roofline arithmetic, the device-trace reductions and the span
readers, on known counts."""

import pytest

from benchmark import manifest, roofline
from benchmark import trace as tr

PEAKS = roofline.Peaks(3.35e12, 132 * 64 * 1.98e9, "test card")


def test_work_counts():
    # 1000 products of full operands: 3 x 64 B each, 272 multiplies each
    assert roofline.product_work(1000, 1000) == (1000 * 3 * 64, 1000 * 272)
    # a broadcast constant is read once
    assert roofline.product_work(1000, 1) == ((1000 + 1 + 1000) * 64, 1000 * 272)
    # a point addition: 3 x 256 B and 11 products
    assert roofline.point_add_work(10) == (10 * 3 * 256, 10 * 11 * 272)


def test_least_seconds_takes_the_slower_bound_per_call():
    by_bytes = (3.35e12, 1)  # one second of bytes, no operations
    by_ops = (1, PEAKS.ops_per_s * 2)  # two seconds of operations
    assert roofline.least_seconds([by_bytes, by_ops], PEAKS) == pytest.approx(3.0)


def _profile(events, calls, wall_s=1.0):
    return tr.Profile(events=events, wall_s=wall_s, calls=calls)


def test_roofline_pct_on_known_counts():
    work = [roofline.product_work(1 << 20, 1 << 20)] * 4
    least = roofline.least_seconds(work, PEAKS)
    # four launches that each took twice the least time: 50%
    dur = int(least / 4 * 2 * 1e9)
    events = [("mont_mul_kernel(uint4 const*)", i * 10**6, dur) for i in range(4)]
    events.append(("void mont_mul_lm_kernel(int const*)", 5 * 10**6, 1000))
    p = _profile(events, {"mont_mul": work})
    assert tr.roofline_pct(p, "mont_mul", "mont_mul_kernel", PEAKS) == \
        pytest.approx(50.0, rel=1e-4)
    # one launch dropped from the trace: its time is the others' mean
    p = _profile(events[:3], {"mont_mul": work})
    assert tr.roofline_pct(p, "mont_mul", "mont_mul_kernel", PEAKS) == \
        pytest.approx(50.0, rel=1e-4)
    # launches far from the counted calls give no share
    p = _profile(events[:2], {"mont_mul": work})
    assert tr.roofline_pct(p, "mont_mul", "mont_mul_kernel", PEAKS) is None
    # no kernel, no share (never a 0)
    assert tr.roofline_pct(_profile([], {"mont_mul": work}), "mont_mul",
                           "mont_mul_kernel", PEAKS) is None


def test_busy_idle_and_gap_labels():
    spans = [{"name": "SparsePoly.prove", "start": 1.0, "end": 2.0,
              "children": [{"name": "Sumcheck.prove", "start": 1.2,
                            "end": 1.5, "children": []}]}]
    # device events on a clock 5 s ahead of the host's
    off = 5 * 10**9
    ev = [("k", int(1.1e9) + off, int(0.05e9)),       # 1.10-1.15
          ("k", int(1.12e9) + off, int(0.08e9)),      # overlaps: to 1.20
          ("Memcpy HtoD", int(1.6e9) + off, int(0.1e9))]  # 1.6-1.7
    p = tr.Profile(events=ev, wall_s=1.0, spans=spans, offset_ns=off,
                   host_start_ns=10**9, host_end_ns=2 * 10**9)
    assert p.busy_s() == pytest.approx(0.2)
    assert len(p.kernels()) == 2
    idle = tr.idle_by_span(p)
    # 1.0-1.1 and 1.5-1.6... : gaps 1.0-1.1 (prove), 1.2-1.6 (mid 1.4:
    # Sumcheck), 1.7-2.0 (prove)
    assert idle["SparsePoly.prove"] == pytest.approx(0.4)
    assert idle["Sumcheck.prove"] == pytest.approx(0.4)
    assert sum(idle.values()) == pytest.approx(0.8)
    bd = tr.breakdown([p])
    assert bd["device_ops"][0] == ["k", pytest.approx(0.13)]
    assert len(bd["idle_gaps"]) <= 10


def test_span_ms_per_pass():
    class Rec:
        def __init__(self, spans):
            self.spans = spans

    def sp(name, a, b, kids=()):
        return {"name": name, "start": a, "end": b, "children": list(kids)}

    passes = [Rec([sp("Densify", 0.0, 0.010), sp("SparsePoly.prove", 0.02, 1.0,
                   [sp("DotProductProofLog.prove", 0.1, 0.2),
                    sp("DotProductProofLog.prove", 0.3, 0.35)])]),
              Rec([sp("Densify", 0.0, 0.030)])]
    assert tr.span_ms_per_pass(passes, "Densify") == pytest.approx(20.0)
    assert tr.span_ms_per_pass(passes, "DotProductProofLog.prove") == \
        pytest.approx(75.0)
    assert tr.span_ms_per_pass(passes, "Nope") is None


def test_device_idle_pct_reads_the_untraced_wall():
    class Rec:
        def __init__(self, prove_s):
            self.prove_s = prove_s

    prove = tr.Profile(events=[("k", 0, int(0.5e9))], wall_s=15.0)
    t = tr.Trace([Rec(9.0), Rec(11.0)], None, prove, PEAKS, log=lambda m: None)
    # 0.5 s busy over the window's mean prove of 10 s, not the traced 15 s
    assert manifest.reader("device_idle_pct")(t) == pytest.approx(95.0)
    empty = tr.Profile(events=[], wall_s=15.0)
    assert manifest.reader("device_idle_pct")(
        tr.Trace([Rec(9.0)], None, empty, PEAKS)) is None
