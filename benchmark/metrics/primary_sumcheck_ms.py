"""Inclusive milliseconds of the program's `Sumcheck.prove` span per prove:
the primary sumcheck over the memories' lookups and the eq table, of degree
g's + 1 (layer: protocol, lasso_tpu_torch/subprotocols/sumcheck.py); moves
prove_s.  The span synchronizes before it closes, so its time covers the
rounds it queued."""

from benchmark.trace import span_ms_per_pass


def read(trace):
    return span_ms_per_pass(trace.passes, "Sumcheck.prove")
