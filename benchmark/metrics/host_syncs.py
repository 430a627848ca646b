"""Waits of the host on the device over the traced prove, as the program
counts them: values and blocking copies brought to the host, and its own
synchronizes (layer: entry, lasso_tpu_torch/lasso/surge.py); moves
prove_s."""

from benchmark.span_counts import total


def read(trace):
    return total(lambda c: c.get("syncs", 0))
