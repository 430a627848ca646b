"""Device ops and hand-written kernel launches (K1..K5) inside the traced
prove's `Sumcheck.prove` span, inclusive, as the program counts them
(layer: protocol, lasso_tpu_torch/subprotocols/sumcheck.py); moves
prove_s.  K5 is added here while benchmark/span_counts.py's `KERNELS`
stops at K4, and only then, so that K5 is counted once when `KERNELS`
lists it; a program whose prove counted nothing there gives None."""

from benchmark.span_counts import KERNELS, launches, total

_EXTRA = () if "k5" in KERNELS else ("k5",)


def read(trace):
    return total(lambda c: launches(c) + sum(c.get(k, 0) for k in _EXTRA),
                 inside="Sumcheck.prove") or None
