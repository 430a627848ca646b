"""A 1-D mesh of ranks for multi-device Lasso proving (port of
parallel/mesh.py).

The reference drives a `jax.sharding.Mesh` from one process.  The port is
SPMD, PyTorch's idiom: one process per rank, every rank running the same
prover code on its own shard, the collectives in `torch.distributed`.  The
hypercube (s / lookup) axis is the shard axis everywhere, cyclically:
global index k = j*D + d lives on rank d at local offset j, so rank d's
shard of x is x[d::D].  The sumcheck bind pairs k with k + n/2, which lie
on one rank, so binds, product-tree layers, lookups and fingerprints are
the single-device functions applied to the shard; the provers take the
mesh as an argument and reach the other ranks only through its methods
(parallel/sharded.py holds the sharded data).

Collectives, one code path for NCCL and gloo (gloo takes only `broadcast`
and `all_reduce` on CUDA tensors):
  * `psum`: all_reduce(SUM), on int64 lazy limb columns (each limb below
    2^17 per shard, so the sum cannot overflow);
  * `all_gather`: all_reduce(SUM) of a zeroed [D, ...] buffer in which each
    rank fills its own slot, exact on integer limbs;
  * `pmax`: all_reduce(MAX).
Field addition is exactly associative and commutative, so any reduction
order gives the same canonical values on every rank.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.lasso.densified import resolve_device
from lasso_tpu_torch.poly.dense import eq_evals_device

# A collective that waits this long for a rank fails instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class Mesh:
    """This process's view of the mesh: it is rank `rank` of `size`, its
    shards live on `device`, and its collectives run over `group` (an
    initialised process group)."""

    rank: int
    size: int
    device: torch.device
    group: dist.ProcessGroup

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the ranks, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[...] on every rank -> [D, ...]: rank d's tensor in slot d."""
        buf = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[self.rank] = x
        return self.psum(buf)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The whole cyclic-sharded array in natural order on every rank
        (the hand-off to the replicated tails: the last sumcheck rounds,
        the top product trees, the Bullet reductions)."""
        g = self.all_gather(x).movedim(0, axis + 1)  # [..., m, D, ...]
        return g.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])

    def eq(self, r: list[int]) -> torch.Tensor:
        """This rank's cyclic shard of eq(r, .) over 2^len(r) entries.

        The rank bits are the low index bits (k = j*D + d), which belong to
        the last log D challenges (index MSB <-> r[0]): rank d builds
        eq(r_hi, .) and scales it by the scalar eq(r_lo, bits(d))."""
        log_d = (self.size - 1).bit_length()
        assert len(r) >= log_d
        hi, lo = r[: len(r) - log_d], r[len(r) - log_d:]
        scale = 1
        for i, ri in enumerate(lo):
            bit = (self.rank >> (log_d - 1 - i)) & 1
            scale = scale * (ri if bit else 1 - ri) % Fr.p
        dev = self.device
        e = eq_evals_device([TFr.encode_scalar(x, dev) for x in hi], dev)
        return TFr.mul(e, TFr.encode_scalar(scale, dev))


def check_mesh(size: int, backend: str, device) -> torch.device:
    """The device a mesh of `size` ranks on `backend` runs on.  Raises
    without a card for a CUDA device, and for more NCCL ranks than cards:
    nothing falls back to the CPU or to fewer ranks."""
    device = resolve_device(device)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if device.type != "cuda" or size > cards:
            raise ValueError(
                f"NCCL needs one card per rank: {size} ranks on {device}, "
                f"{cards} cards")
    return device


def make_mesh(rank: int, size: int, init_method: str, backend: str = "nccl",
              device="cuda") -> Mesh:
    """Join the process group as `rank` of `size` and return its mesh.

    `device` "cuda" without an index puts rank d on card d mod #cards (all
    ranks share a single card); an explicit device is taken as given."""
    device = check_mesh(size, backend, device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank, timeout=TIMEOUT)
    return Mesh(rank, size, device, dist.group.WORLD)
