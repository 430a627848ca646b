"""Per-layer metrics, one reader each: `<metric>.py` defines `read(trace)`,
which returns the metric from a `benchmark.trace.Trace`, or None when the
run gave it nothing to read (the harness then leaves the metric out)."""
