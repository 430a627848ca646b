"""Inclusive milliseconds of the program's `Densify` span per pass (layer:
densify, lasso_tpu_torch/lasso/densified.py); moves prover_s."""

from benchmark.trace import span_ms_per_pass


def read(trace):
    return span_ms_per_pass(trace.passes, "Densify")
