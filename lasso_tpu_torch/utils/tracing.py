"""Phase tracing (reference: tracing spans, SURVEY.md section 5.1).

The reference instruments every expensive phase with `tracing` spans and
prints span-close wall times or a texray gantt chart.  Here: a nested span
stack with wall-clock timing.  When CUDA is in use, a span synchronizes the
device before it closes, so its wall time covers the kernels it queued.

Usage:
    with span("SparsePoly.prove"):
        ...
    print_span_tree()     # or texray()-style summary

Spans are cheap (two perf_counter calls) and always collected; printing is
opt-in (LASSO_TPU_TRACE=1 enables stderr close-events like the reference's
fmt subscriber).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    name: str
    start: float
    end: float | None = None
    children: list["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.perf_counter()) - self.start


_ROOTS: list[Span] = []
_STACK: list[Span] = []
_ECHO = os.environ.get("LASSO_TPU_TRACE", "") not in ("", "0")


@contextlib.contextmanager
def span(name: str):
    s = Span(name, time.perf_counter())
    (_STACK[-1].children if _STACK else _ROOTS).append(s)
    _STACK.append(s)
    try:
        yield s
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        s.end = time.perf_counter()
        _STACK.pop()
        if _ECHO:
            depth = len(_STACK)
            print(f"{'  ' * depth}close {name}: {s.duration * 1e3:.1f}ms",
                  file=sys.stderr)


def instrument(name: str | None = None):
    """Decorator equivalent of #[tracing::instrument(name=...)]."""

    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with span(label):
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


def print_span_tree(file=None, min_ms: float = 0.0) -> None:
    """texray-style nested duration chart."""
    file = file or sys.stderr
    total = sum(s.duration for s in _ROOTS) or 1e-12

    def walk(s: Span, depth: int):
        ms = s.duration * 1e3
        if ms < min_ms:
            return
        bar = "#" * max(1, int(40 * s.duration / total))
        print(f"{ms:10.1f}ms {'  ' * depth}{s.name:<40} {bar}", file=file)
        for c in s.children:
            walk(c, depth + 1)

    for s in _ROOTS:
        walk(s, 0)
