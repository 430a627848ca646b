"""K1 (`mont_mul_kernel`, csrc/mont_mul.cu) over the traced prove: the
least time of the Montgomery products counted at its call boundary, over
its device time, in percent (layer: kernels); moves prove_s."""

from benchmark.trace import roofline_pct


def read(trace):
    return roofline_pct(trace.prove, "mont_mul", "mont_mul_kernel",
                        trace.peaks, trace.log)
