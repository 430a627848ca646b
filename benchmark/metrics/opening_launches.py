"""Device ops and hand-written kernel launches inside the traced prove's
`DotProductProofLog.prove` spans, inclusive, as the program counts them
(layer: openings, lasso_tpu_torch/subprotocols/dot_product.py and
bullet.py); moves prove_s."""

from benchmark.span_counts import launches, total


def read(trace):
    return total(launches, inside="DotProductProofLog.prove")
