"""K4 (keccak-f[1600]) launches per prove, as the program counts them in
`ops/field_cuda.launch_counts` (layer: transcript,
lasso_tpu_torch/transcript/device_strobe.py); moves prove_s."""


def read(trace):
    total = sum(p.keccak_launches for p in trace.passes)
    # the host transcript launches no K4: nothing to read
    return total / len(trace.passes) if total else None
