"""The traced pass: one more pass after the window, its densify and commit
and its prove each under torch.profiler (device activity only), with the
calls into K1 and K3 counted at their call boundary.  From the trace: the
device's busy time, the operations that took it, and the idle gaps, each
labelled with the innermost program span open on the host at the time.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

from benchmark import roofline
from benchmark.harness import PassRecord, Program, plain_spans
from benchmark.traffic import Batch

OUTSIDE = "(no span)"


@dataclass
class Profile:
    events: list  # (name, start_ns, duration_ns) of device operations
    wall_s: float
    calls: dict = field(default_factory=lambda: defaultdict(list))
    spans: list = field(default_factory=list)
    offset_ns: int = 0  # device clock minus host perf_counter, in ns
    host_start_ns: int = 0
    host_end_ns: int = 0

    def kernels(self, name: str | None = None) -> list:
        """Kernel events (not copies or fills of memory), by name part."""
        return [e for e in self.events
                if not e[0].startswith(("Memcpy", "Memset"))
                and (name is None or name in e[0])]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        busy, end = 0, None
        for _, start, dur in self.events:
            stop = start + dur
            if end is None or start >= end:
                busy += dur
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy / 1e9


@dataclass
class Trace:
    passes: list  # the window's PassRecords
    commit: Profile
    prove: Profile
    peaks: roofline.Peaks
    log: object = print


def _device_events(prof) -> list:
    """(name, start_ns, duration_ns) of every device event, by start."""
    try:
        raw = prof.profiler.kineto_results.events()
        out = [(e.name(), e.start_ns(), e.duration_ns()) for e in raw
               if "CUDA" in str(e.device_type())]
    except AttributeError:  # an older profiler: its parsed events
        out = [(e.name, int(e.time_range.start * 1000),
                int(e.time_range.elapsed_us() * 1000)) for e in prof.events()
               if "CUDA" in str(e.device_type)]
    return sorted(out, key=lambda e: e[1])


def _profiled(prog: Program, run, calls):
    """run() under the profiler; returns (its result, Profile).  A small
    fill launched right after a synchronize marks the host clock on the
    device's, so host spans and device events share one time line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=prog.device)
    prog.sync()
    # on the CPU (the tests) the trace holds no device event
    activity = ProfilerActivity.CUDA if prog.cuda else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        prog.sync()
        mark_ns = time.perf_counter_ns()
        marker.fill_(1.0)
        start_ns = time.perf_counter_ns()
        result = run()
        prog.sync()
        end_ns = time.perf_counter_ns()
    events = _device_events(prof)
    offset = events[0][1] - mark_ns if events else 0
    return result, Profile(events[1:], (end_ns - start_ns) / 1e9, calls,
                           offset_ns=offset, host_start_ns=start_ns,
                           host_end_ns=end_ns)


def profiled_pass(prog: Program, batch: Batch, index: int,
                  keep: bool = False):
    """One pass with its commit and its prove profiled; returns (the
    PassRecord, which with `keep` holds what the reference judges, the
    commit Profile, the prove Profile)."""
    fc = prog.field_cuda
    calls = {"commit": defaultdict(list), "prove": defaultdict(list)}
    phase = ["commit"]
    orig_mm, orig_pa = fc.mont_mul_cuda, fc.padd_cuda

    def counted_mm(a, b, field_name):
        calls[phase[0]]["mont_mul"].append(
            roofline.product_work(a.numel() // 16, b.numel() // 16))
        return orig_mm(a, b, field_name)

    def counted_pa(p, q):
        calls[phase[0]]["padd"].append(
            roofline.point_add_work(p.shape[0] * p.shape[3]))
        return orig_pa(p, q)

    prog.tracing.reset_spans()
    fc.mont_mul_cuda, fc.padd_cuda = counted_mm, counted_pa
    try:
        (dense, comm), p_commit = _profiled(
            prog, lambda: prog.densify_commit(batch.indices), calls["commit"])
        tables = ([dense.combined_l_variate_polys.z.cpu(),
                   dense.combined_log_m_variate_polys.z.cpu()]
                  if keep else None)
        phase[0] = "prove"
        fc.reset_launch_counts()
        proof, p_prove = _profiled(prog, lambda: prog.prove(dense, batch.r),
                                   calls["prove"])
        keccak = fc.launch_counts["keccak"]
    finally:
        fc.mont_mul_cuda, fc.padd_cuda = orig_mm, orig_pa
    del dense
    t0 = time.perf_counter()
    prog.verify(proof, comm, batch.r)
    prog.sync()
    verify_s = time.perf_counter() - t0
    spans = plain_spans(prog.tracing.span_tree())
    p_commit.spans = p_prove.spans = spans
    rec = PassRecord(index, p_commit.wall_s, p_prove.wall_s, verify_s, spans,
                     keccak, tables, comm if keep else None,
                     proof if keep else None)
    return rec, p_commit, p_prove


def _segments(spans: list) -> tuple[list[int], list[str]]:
    """Boundaries (host ns) where the innermost open span changes, and the
    innermost span's name from each boundary on."""
    bounds, labels = [], []

    def walk(sp, outer):
        start, end = int(sp["start"] * 1e9), int(sp["end"] * 1e9)
        bounds.append(start)
        labels.append(sp["name"])
        for ch in sp["children"]:
            walk(ch, sp["name"])
        bounds.append(end)
        labels.append(outer)

    for sp in spans:
        walk(sp, OUTSIDE)
    return bounds, labels


def idle_by_span(profile: Profile) -> dict[str, float]:
    """Idle device seconds inside the profiled wall, by the innermost
    program span open on the host in the middle of each gap."""
    bounds, labels = _segments(profile.spans)
    lo = profile.host_start_ns + profile.offset_ns
    hi = profile.host_end_ns + profile.offset_ns
    out: dict[str, float] = defaultdict(float)
    cursor = lo
    for _, start, dur in profile.events + [("end", hi, 0)]:
        start = min(max(start, lo), hi)
        if start > cursor:
            mid = (cursor + start) // 2 - profile.offset_ns
            k = bisect.bisect_right(bounds, mid) - 1
            out[labels[k] if k >= 0 else OUTSIDE] += (start - cursor) / 1e9
        cursor = max(cursor, min(start + dur, hi))
    return dict(out)


def _short(name: str) -> str:
    return name.removeprefix("void ")[:100]


def breakdown(profiles: list[Profile]) -> dict:
    """The ten device operations that took most time, and the ten spans
    under which the device stood idle longest, over the traced pass."""
    ops: dict[str, float] = defaultdict(float)
    idle: dict[str, float] = defaultdict(float)
    for p in profiles:
        for name, _, dur in p.events:
            ops[_short(name)] += dur / 1e9
        for name, sec in idle_by_span(p).items():
            idle[name] += sec

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def span_ms_per_pass(passes: list[PassRecord], name: str):
    """Mean over passes of the inclusive milliseconds of the spans `name`
    (the outermost of nested ones), or None if no pass has one."""
    def total(spans):
        return sum((sp["end"] - sp["start"]) * 1e3 if sp["name"] == name
                   else total(sp["children"]) for sp in spans)

    def has(spans):
        return any(sp["name"] == name or has(sp["children"]) for sp in spans)

    if not passes or not any(has(p.spans) for p in passes):
        return None
    return sum(total(p.spans) for p in passes) / len(passes)


def roofline_pct(profile: Profile, call: str, kernel: str,
                 peaks: roofline.Peaks, log=None):
    """100 x the least time of the counted calls over the kernel's device
    time, or None if the trace holds no such kernel.  The profiler now and
    then drops an event of a few hundred thousand: the device time is then
    scaled by counted calls over traced launches, up to a thousandth (at
    least one launch) off; further off, there is no share."""
    work = profile.calls.get(call, [])
    kern = profile.kernels(kernel)
    if not work or not kern:
        return None
    device_s = sum(e[2] for e in kern) / 1e9
    if len(work) != len(kern):
        off = abs(len(work) - len(kern))
        if log:
            log(f"{kernel}: {len(kern)} launches in the trace, {len(work)} "
                "counted calls")
        if off > max(1, len(work) // 1000):
            return None
        device_s *= len(work) / len(kern)
    return 100.0 * roofline.least_seconds(work, peaks) / device_s
