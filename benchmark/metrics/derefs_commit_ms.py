"""Inclusive milliseconds of the program's `Subtables.commit` span per
pass: the Hyrax commitment of the dereferenced lookups, num_memories x s
entries (layer: openings, lasso_tpu_torch/subtables/container.py); moves
prove_s.  The span synchronizes before it closes, so its time covers the
MSMs it queued."""

from benchmark.trace import span_ms_per_pass


def read(trace):
    return span_ms_per_pass(trace.passes, "Subtables.commit")
