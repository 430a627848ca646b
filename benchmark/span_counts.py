"""Sums of the program's span counters over the traced prove.

The port counts, per span, the ops it dispatches on the device by calling
module, the launches of its hand-written kernels (`k1`..`k4`) and the
host's waits on the device (`syncs`), while tracing is on
(lasso_tpu_torch/utils/tracing.py); the traced pass runs under the
profiler, which turns tracing on.  After that pass, nothing resets the
span tree before the readers run, so `span_tree()` still holds the pass's
`SparsePoly.prove` root.  A program whose spans carry no counts, or whose
prove counted nothing, gives None.
"""

from __future__ import annotations

PROVE_ROOT = "SparsePoly.prove"
KERNELS = ("k1", "k2", "k3", "k4")


def _walk(s):
    yield s
    for c in s.children:
        yield from _walk(c)


def _counted(s) -> bool:
    return any(getattr(x, "counts", None) for x in _walk(s))


def prove_root():
    """The traced prove's root span, or None."""
    from lasso_tpu_torch.utils import tracing

    roots = [s for s in tracing.span_tree() if s.name == PROVE_ROOT]
    return roots[-1] if roots and _counted(roots[-1]) else None


def launches(counts: dict) -> int:
    """Device ops and hand-written kernel launches of one span's counts."""
    return sum(counts.get("ops", {}).values()) + sum(
        counts.get(k, 0) for k in KERNELS)


def _under(s, name: str):
    """The spans of s's subtree at or below a span called `name`."""
    if s.name == name:
        yield from _walk(s)
    else:
        for c in s.children:
            yield from _under(c, name)


def total(value, inside: str | None = None):
    """Sum of value(counts) over the traced prove's spans; with `inside`,
    over those at or below the spans of that name.  None without a traced
    prove."""
    root = prove_root()
    if root is None:
        return None
    spans = _walk(root) if inside is None else _under(root, inside)
    return sum(value(s.counts) for s in spans)
