"""Inclusive milliseconds of the program's
`BatchedGrandProductArgument.prove` spans per prove (layer: protocol,
lasso_tpu_torch/subprotocols/grand_product.py); moves prove_s."""

from benchmark.trace import span_ms_per_pass


def read(trace):
    return span_ms_per_pass(trace.passes, "BatchedGrandProductArgument.prove")
