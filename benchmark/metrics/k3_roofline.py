"""K3 (`padd_kernel`, csrc/padd.cu) over the traced pass's densify and
commit: the least time of the point additions counted at its call
boundary, over its device time, in percent (layer: kernels); moves
prover_s."""

from benchmark.trace import roofline_pct


def read(trace):
    return roofline_pct(trace.commit, "padd", "padd_kernel", trace.peaks,
                        trace.log)
