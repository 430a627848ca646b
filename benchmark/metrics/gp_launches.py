"""Device ops and hand-written kernel launches inside the traced prove's
`BatchedGrandProductArgument.prove` spans, inclusive, as the program
counts them (layer: protocol, lasso_tpu_torch/subprotocols/grand_product.py
and sumcheck.py); moves prove_s."""

from benchmark.span_counts import launches, total


def read(trace):
    return total(launches, inside="BatchedGrandProductArgument.prove")
