"""K5 (`csrc/field_arith.cu`: the field layer's add, sub, column sums and
their finish) launches over the traced prove, as the program counts them
per span (`k5`; layer: field and curve dispatch,
lasso_tpu_torch/field/tfield.py and ops/field_cuda.py); moves prove_s.  A
program without K5 counts none: nothing to read."""

from benchmark.span_counts import total


def read(trace):
    return total(lambda c: c.get("k5", 0)) or None
