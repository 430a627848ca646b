"""The share of a prove's wall time in which no operation ran on the card,
in percent (layer: device, one H100); moves prove_s.  The busy time is the
traced prove's; the wall is the mean prove_s of the window's untraced
passes, since the profiler stretches the traced prove's own wall."""


def read(trace):
    if not trace.passes or not trace.prove.events:
        return None
    busy_s = trace.prove.busy_s()
    wall_s = sum(p.prove_s for p in trace.passes) / len(trace.passes)
    trace.log(f"device_idle_pct: busy {busy_s} s; over the window's mean "
              f"prove_s {wall_s} s, not the traced prove's "
              f"{trace.prove.wall_s} s")
    return 100.0 * (1.0 - busy_s / wall_s)
