"""Inclusive milliseconds of the program's `DotProductProofLog.prove` spans
per prove: the three Hyrax openings (layer: openings,
lasso_tpu_torch/subprotocols/dot_product.py); moves prove_s."""

from benchmark.trace import span_ms_per_pass


def read(trace):
    return span_ms_per_pass(trace.passes, "DotProductProofLog.prove")
