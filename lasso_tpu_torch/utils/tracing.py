"""Phase tracing (reference: tracing spans, SURVEY.md section 5.1).

The reference instruments every expensive phase with `tracing` spans and
prints span-close wall times or a texray gantt chart.  Here: a nested span
stack with host times on `time.perf_counter_ns()`, the clock the benchmark
aligns with the device trace.

Usage:
    with span("SparsePoly.prove"):
        ...
    print_span_tree()     # texray-style chart, same-named siblings merged

Off (the default), a span records its host interval and nothing else: two
clock reads, two flag reads and two list appends.  It does not wait for
the device.  Only a span opened with `sync=True` synchronizes the device
before it closes, so that its time covers the kernels it queued; those are
the spans whose time a per-layer metric reads from untraced passes
(`Densify`, `Subtables.commit`, `Sumcheck.prove`,
`BatchedGrandProductArgument.prove`, `DotProductProofLog.prove`), and they
synchronize whether tracing is on or off.

Tracing is on while `LASSO_TPU_TRACE` is set to anything but `0` (read
when a root span opens; it also echoes each span's close to stderr) or
while a torch profiler records.  Tracing changes what is recorded, never
what the program queues or waits for.  The outermost span that opens with
tracing on enters one TorchDispatchMode, left when that span closes; while
it is active, each span's `counts` gathers what happened while the span
was the innermost open one, its children's share excluded:
  * `ops`: {module: n}, the non-view aten ops that run on the program's
    device (CUDA once it is initialized, else the CPU), less those that
    launch no kernel (_NO_KERNEL) and copies between devices, keyed by the
    innermost `lasso_tpu_torch` module on the Python stack
    (e.g. `field.tfield`, `curve.tcurve`, `ops.msm`);
  * `k1`..`k5`: launches of the hand-written kernels (ops/field_cuda.py
    calls `count`), which ctypes hides from the mode;
  * `syncs`: waits of the host on the device: the ops in _SYNC_OPS on a
    device tensor, blocking copies from the device to the CPU, and the
    program's own `synchronize()` calls.
Off, no mode is entered and every `counts` stays empty.  While a profiler
records, each span also opens a `record_function` range of its name.

`span_tree()` holds the root spans since the last `reset_spans()`, at most
MAX_ROOTS of them: past that, the oldest are dropped.
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode

MAX_ROOTS = 256
_PACKAGE = "lasso_tpu_torch."


_aten = torch.ops.aten
# ops that only allocate or describe memory: no kernel on the device
_NO_KERNEL = frozenset({
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.resize_.default,
    _aten._unsafe_view.default})
# ops that bring device data to the host, and so wait for the device
_SYNC_OPS = frozenset({
    _aten._local_scalar_dense.default, _aten.nonzero.default,
    _aten.masked_select.default, _aten._unique2.default,
    _aten.unique_consecutive.default, _aten.unique_dim.default,
    _aten.repeat_interleave.Tensor, _aten.equal.default})
_SCALAR = _aten._local_scalar_dense.default
_TO_COPY = _aten._to_copy.default
_COPY = _aten.copy_.default


class Span:
    """One timed phase; a context manager (`span(name)` builds one)."""

    __slots__ = ("name", "sync", "start_ns", "end_ns", "children", "counts",
                 "_range", "_owns_counter")

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync
        self.start_ns = 0
        self.end_ns: int | None = None
        self.children: list[Span] = []
        self.counts: dict = {}
        self._range = None
        self._owns_counter = False

    @property
    def start(self) -> float:
        return self.start_ns / 1e9

    @property
    def end(self) -> float | None:
        return None if self.end_ns is None else self.end_ns / 1e9

    @property
    def duration(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        global _ENV
        if _STACK:
            _STACK[-1].children.append(self)
        else:
            _ENV = os.environ.get("LASSO_TPU_TRACE", "") not in ("", "0")
            _ROOTS.append(self)
        _STACK.append(self)
        if _ENV or _profiler._is_profiler_enabled:
            self._trace_open()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync and torch.cuda.is_initialized():
            synchronize()
        self.end_ns = time.perf_counter_ns()
        _STACK.pop()
        if self._owns_counter or self._range is not None:
            self._trace_close()
        if _ENV:
            print(f"{'  ' * len(_STACK)}close {self.name}: "
                  f"{self.duration * 1e3:.1f}ms", file=sys.stderr)

    def _trace_open(self) -> None:
        global _COUNTER
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        if _COUNTER is None:
            _COUNTER = _Counter()
            _COUNTER.__enter__()
            self._owns_counter = True

    def _trace_close(self) -> None:
        global _COUNTER
        if self._owns_counter:
            _COUNTER.__exit__(None, None, None)
            _COUNTER = None
            self._owns_counter = False
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


_ROOTS: deque[Span] = deque(maxlen=MAX_ROOTS)
_STACK: list[Span] = []
_ENV = False  # LASSO_TPU_TRACE, as read when the last root span opened
_COUNTER: "_Counter | None" = None  # the dispatch mode of a traced tree


def _first_tensor(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x
    return None


def _caller_module() -> str:
    """The innermost module of the package on the Python stack, less the
    package's name."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith(_PACKAGE) and mod != __name__:
            return mod[len(_PACKAGE):]
        f = f.f_back
    return "(outside)"


class _Counter(TorchDispatchMode):
    """Counts the ops of the traced tree into the innermost open span."""

    def __init__(self):
        super().__init__()
        self.device = "cuda" if torch.cuda.is_initialized() else "cpu"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _STACK or getattr(func, "is_view", False) or func in _NO_KERNEL:
            return out
        counts = _STACK[-1].counts
        dev = self.device
        if func is _TO_COPY or func is _COPY:
            src, dst = ((args[0], out) if func is _TO_COPY
                        else (args[1], args[0]))
            if src.device.type != dst.device.type:  # a copy, no kernel
                blocking = not kwargs.get(
                    "non_blocking", len(args) > 2 and args[2])
                if src.device.type == dev != "cpu" and blocking:
                    counts["syncs"] = counts.get("syncs", 0) + 1
                return out
        src = _first_tensor(args)
        if func in _SYNC_OPS:
            if src is not None and src.device.type == dev:
                counts["syncs"] = counts.get("syncs", 0) + 1
            if func is _SCALAR:  # a copy of one value, no kernel
                return out
        t = out if isinstance(out, torch.Tensor) else (
            _first_tensor(out) if isinstance(out, (tuple, list)) else None)
        if t is None:
            t = src
        if t is not None and t.device.type == dev:
            ops = counts.setdefault("ops", {})
            mod = _caller_module()
            ops[mod] = ops.get(mod, 0) + 1
        return out


def count(key: str, n: int = 1) -> None:
    """Add n to `key` of the innermost open span's counts, while tracing
    counts; the hand-written kernels' wrappers call it per launch."""
    if _COUNTER is not None and _STACK:
        counts = _STACK[-1].counts
        counts[key] = counts.get(key, 0) + n


def synchronize(device=None) -> None:
    """torch.cuda.synchronize(), counted as a host sync."""
    count("syncs")
    torch.cuda.synchronize(device)


def span(name: str, sync: bool = False) -> Span:
    """A span of `name`; with `sync`, it synchronizes the device (when
    CUDA is initialized) before it closes."""
    return Span(name, sync)


def instrument(name: str | None = None, sync: bool = False):
    """Decorator equivalent of #[tracing::instrument(name=...)]."""

    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with Span(label, sync):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


def reset_spans() -> None:
    _ROOTS.clear()
    _STACK.clear()


def span_tree() -> list[Span]:
    return list(_ROOTS)


def inclusive_counts(s: Span) -> dict:
    """A span's counts with its descendants', `ops` summed over modules."""
    out: dict = {}
    for key, v in s.counts.items():
        out[key] = out.get(key, 0) + (sum(v.values()) if key == "ops" else v)
    for c in s.children:
        for key, v in inclusive_counts(c).items():
            out[key] = out.get(key, 0) + v
    return out


_CHART_KEYS = ("ops", "k1", "k2", "k3", "k4", "k5", "syncs")


def print_span_tree(file=None, min_ms: float = 0.0) -> None:
    """texray-style nested duration chart.  Same-named siblings share one
    line with their repeat count and summed time; where tracing counted,
    each line ends with its inclusive ops, kernel launches and syncs."""
    file = file or sys.stderr
    total = sum(s.duration for s in _ROOTS) or 1e-12

    def walk(spans: list[Span], depth: int):
        groups: dict[str, list[Span]] = {}
        for s in spans:
            groups.setdefault(s.name, []).append(s)
        for name, group in groups.items():
            dur = sum(s.duration for s in group)
            if dur * 1e3 < min_ms:
                continue
            label = name if len(group) == 1 else f"{name} x{len(group)}"
            counts: dict = {}
            for s in group:
                for key, v in inclusive_counts(s).items():
                    counts[key] = counts.get(key, 0) + v
            tail = " ".join(f"{k}={counts[k]}" for k in _CHART_KEYS
                            if counts.get(k))
            bar = "#" * max(1, int(40 * dur / total))
            print(f"{dur * 1e3:10.1f}ms {'  ' * depth}{label:<40} {bar}"
                  + (f"  {tail}" if tail else ""), file=file)
            walk([c for s in group for c in s.children], depth + 1)

    walk(list(_ROOTS), 0)
