"""The benchmark of the PyTorch and CUDA port (`lasso_tpu_torch`): cells of
`BENCHMARK.json` run by `python3 -m benchmark.run`."""
