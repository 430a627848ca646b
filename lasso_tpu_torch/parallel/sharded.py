"""The sharded data of a multi-device Lasso prove (port of the data half of
parallel/eprover.py and of the commit primitives of parallel/ops.py).

The provers themselves are the single-device ones, given the mesh
(SparsePolynomialEvaluationProof.prove(..., mesh=)): this module holds only
what each rank keeps of the instance.

  * every s- or M-sized multilinear lives cyclic-sharded over the ranks
    (parallel/mesh.py): rank d holds x[d::D];
  * merged (Hyrax matrix) polynomials keep the cyclic layout
    column-aligned (rank d owns the matrix columns congruent to d mod D),
    so the L-fold is local along rows and the row-MSM commit is one
    per-rank MSM and one all_gather of partial points.

Bytes: field arithmetic is exact, so any reduction order gives the same
canonical values; curve addition is associative, so the gathered partial
points sum to the same commitment points.  Divisibility: D | s, D | M and
D | r_size of every Hyrax matrix (the asserts below, as the reference's).
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.curve.tcurve import to_host_points, tree_sum
from lasso_tpu_torch.field.tfield import TFr, W
from lasso_tpu_torch.lasso.densified import SparsePolynomialCommitment
from lasso_tpu_torch.ops.msm import _bits_of_col_max, _msm_kernel, window_plan
from lasso_tpu_torch.parallel.mesh import Mesh
from lasso_tpu_torch.poly.dense import _bound_fold, factored_lens
from lasso_tpu_torch.poly.hyrax import PolyCommitment
from lasso_tpu_torch.subprotocols.dot_product import _gens_device
from lasso_tpu_torch.subtables.container import (CombinedTableCommitment,
                                                 Subtables)
from lasso_tpu_torch.utils.tracing import instrument


def _log2(n: int) -> int:
    return (n - 1).bit_length()


def local_shard(mesh: Mesh, x, axis: int = 0):
    """This rank's cyclic shard x[rank::D] along `axis`, contiguous, on the
    mesh's device."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(mesh.rank, None, mesh.size)
    return x[tuple(idx)].to(mesh.device).contiguous()


# ---------------------------------------------------------------------------
# sharded Hyrax: merged-cyclic polynomial + row-MSM commit
# ---------------------------------------------------------------------------

class ShardedPoly:
    """A merged multilinear of n entries, this rank's cyclic shard z
    [n/D, W].  PolyEvalProof.prove takes it by num_vars, device and bound:
    the L-fold runs on the shard, and the folded sqrt(n)-sized LZ is
    gathered for the replicated Bullet reduction."""

    def __init__(self, mesh: Mesh, z, n: int):
        self.mesh = mesh
        self.z = z
        self.n = n

    def __len__(self) -> int:
        return self.n

    @property
    def num_vars(self) -> int:
        return _log2(self.n)

    @property
    def device(self) -> torch.device:
        return self.z.device

    def bound(self, l_vec):
        """L @ mat(Z) ([r_size, W], natural order, on every rank)."""
        assert (self.n // l_vec.shape[0]) % self.mesh.size == 0
        return self.mesh.gather(_bound_fold(self.z, l_vec))


def _commit_rows(mesh: Mesh, z, bases, l_size: int, row_chunk: int = 128):
    """Hyrax row commitments of a merged-cyclic polynomial.

    z: [l_size*r_size/D, W] this rank's shard (Montgomery); bases
    [4, W, r_size/D] the generators of its columns col = c*D + rank.  With
    D | r_size, global element (row, col) lives on rank col mod D at local
    (row, col div D), so each rank runs one batched-row MSM over its column
    subset; the per-rank row points are gathered and tree-summed.  The
    window plan is the same on every rank: the scalars' bit width is a
    maximum over the ranks, and more than 60 bits take the full 253, as in
    ops/msm.msm_device.  Returns [l_size, 4, W, 1] on every rank."""
    ints = TFr.to_int_limbs(z).reshape(l_size, -1, W)
    col_max = ints.reshape(-1, W).amax(dim=0).to(torch.int64)
    max_bits = _bits_of_col_max(mesh.pmax(col_max).cpu().tolist())
    c, k = window_plan(max(ints.shape[1], 2), 253 if max_bits > 60 else max_bits)
    local = torch.cat([_msm_kernel(bases, ints[i: i + row_chunk], c, k)
                       for i in range(0, l_size, row_chunk)])
    partials = mesh.all_gather(local[..., 0])  # [D, l_size, 4, W]
    return tree_sum(partials.movedim(0, -1))


@instrument("sharded.commit_poly")
def sharded_commit(poly: ShardedPoly, gens) -> PolyCommitment:
    """Hyrax matrix commitment of a merged-cyclic polynomial (no blinds:
    the Lasso prove never blinds commits), the points of
    poly/hyrax.commit_poly."""
    mesh = poly.mesh
    left, right = factored_lens(poly.num_vars)
    l_size, r_size = 1 << left, 1 << right
    assert r_size % mesh.size == 0 and r_size >= mesh.size
    bases = _gens_device(gens.gens.gens_n, mesh.device)[..., :r_size]
    rows = _commit_rows(mesh, poly.z, local_shard(mesh, bases, axis=-1),
                        l_size)
    return PolyCommitment(to_host_points(rows.movedim(0, -1)))


# ---------------------------------------------------------------------------
# sharded densified representation + subtables
# ---------------------------------------------------------------------------

class ShardedDensified:
    """This rank's cyclic shards of a DensifiedRepresentation, with its
    attributes.

    Densify itself (the timestamp sort) is input preparation and stays
    global on every rank; what the prover touches afterwards -- the dim
    indices, the two merged polynomials and their commits -- is sharded."""

    def __init__(self, mesh: Mesh, dense):
        d = mesh.size
        assert dense.s % d == 0, "s must be divisible by the mesh size"
        assert dense.m % d == 0, "M must be divisible by the mesh size"
        self.mesh = mesh
        self.device = mesh.device
        self.c, self.s, self.m, self.log_m = dense.c, dense.s, dense.m, dense.log_m
        self.dim_usize = local_shard(mesh, dense.dim_usize, axis=1)  # [C, s/D]
        # merged index k = i*s + t has k mod D = t mod D (D | s): a merged
        # shard is the per-polynomial shards one after the other
        self.combined_l_variate_polys = ShardedPoly(
            mesh, local_shard(mesh, dense.combined_l_variate_polys.z),
            len(dense.combined_l_variate_polys))
        self.combined_log_m_variate_polys = ShardedPoly(
            mesh, local_shard(mesh, dense.combined_log_m_variate_polys.z),
            len(dense.combined_log_m_variate_polys))

    @instrument("sharded.DensifiedRepresentation.commit")
    def commit(self, gens) -> SparsePolynomialCommitment:
        return SparsePolynomialCommitment(
            l_variate_polys_commitment=sharded_commit(
                self.combined_l_variate_polys, gens.gens_combined_l_variate),
            log_m_variate_polys_commitment=sharded_commit(
                self.combined_log_m_variate_polys,
                gens.gens_combined_log_m_variate),
            s=self.s, log_m=self.log_m, m=self.m)


class ShardedSubtables(Subtables):
    """Subtables over this rank's lookup indices nz [C, s/D]: the merged
    lookup polynomial is its cyclic shard, column-aligned for the commit
    and the openings."""

    def __init__(self, mesh: Mesh, strategy, nz, s: int):
        self.mesh = mesh
        super().__init__(strategy, nz, s)

    def _poly(self, flat, n: int):
        return ShardedPoly(self.mesh, flat, n)

    @instrument("sharded.Subtables.commit")
    def commit(self, gens) -> CombinedTableCommitment:
        return CombinedTableCommitment(sharded_commit(self.combined_poly, gens))
