"""Device ops dispatched from `field/tfield.py` over the traced prove, as the
program counts them by calling module (layer: field and curve dispatch);
moves prove_s."""

from benchmark.span_counts import total


def read(trace):
    return total(lambda c: c.get("ops", {}).get("field.tfield", 0))
