"""Device kernels the profiler saw over the traced prove (layer: field and
curve dispatch, lasso_tpu_torch/field/tfield.py and curve/tcurve.py); moves
prove_s."""


def read(trace):
    kernels = trace.prove.kernels()
    return len(kernels) if kernels else None
