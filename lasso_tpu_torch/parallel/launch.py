"""Run one function on every rank of a mesh: one process per rank.

    results = spawn(fn, world_size, backend, device, *args)

calls `fn(mesh, *args)` in `world_size` processes started with the `spawn`
method (a forked child cannot use CUDA), each joined to one process group
through a file rendezvous in a temporary directory (no TCP port, so
concurrent launches never collide), and returns the ranks' results in rank
order.  `fn` must be a module-level function of an importable module:
`spawn` pickles it by name.  A rank's exception ends the others and is
raised here; nothing is caught.  For a CUDA device the kernels are built
here, once, before the ranks start, so that they do not each run nvcc.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lasso_tpu_torch.ops import field_cuda
from lasso_tpu_torch.parallel.mesh import check_mesh, make_mesh


def spawn(fn, world_size: int, backend: str, device, *args) -> list:
    device = check_mesh(world_size, backend, device)
    if device.type == "cuda":
        field_cuda.build()
    with tempfile.TemporaryDirectory(prefix="lasso-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(
            _run_rank, args=(fn, world_size, backend, str(device), init, tmp,
                             args),
            nprocs=world_size, join=True, start_method="spawn")
        results = []
        for rank in range(world_size):
            with open(_result_path(tmp, rank), "rb") as f:
                results.append(pickle.load(f))
    return results


def _result_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"result-{rank}.pkl")


def _run_rank(rank, fn, size, backend, device, init, tmp, args) -> None:
    mesh = make_mesh(rank, size, init, backend, device)
    if mesh.device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    try:
        result = fn(mesh, *args)
    finally:
        dist.destroy_process_group()
    with open(_result_path(tmp, rank), "wb") as f:
        pickle.dump(result, f)
