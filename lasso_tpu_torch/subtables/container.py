"""Runtime subtable container + combined-table commitment/eval proof (port
of subtables/container.py; reference: src/subtables/mod.rs:95-394).

Materialized subtables live on the proof's device as Montgomery limb
tensors; the dereferenced lookup polynomials E_i = T_i[nz_i] are one
batched gather into a single flat merged array, and the primary-sumcheck
claim sum_k eq[k] * g(E(k)) is one combine plus a field reduction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch.field.tfield import TFr, W
from lasso_tpu_torch.poly.dense import (DensePolynomial, bound_var_bot_host,
                                        finish_columns)
from lasso_tpu_torch.poly.hyrax import (PolyCommitment, PolyCommitmentGens,
                                        PolyEvalProof, commit_poly)
from lasso_tpu_torch.subtables.base import SubtableStrategy
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.tracing import instrument


def _gather_flat(table_vals, nz, sub_of: tuple, dim_of: tuple, pad: int):
    """E_i = T_{sub(i)}[nz_{dim(i)}] for all memories, MERGED into one flat
    [next_pow2(alpha*s), W] array (rows are contiguous slices)."""
    rows = [table_vals[k][nz[d]] for k, d in zip(sub_of, dim_of)]
    if pad:
        rows.append(TFr.zeros(pad, table_vals.device))
    return torch.cat(rows, dim=0)


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def _rows_view(flat, alpha: int, s: int):
    """The first alpha*s rows of a flat merged array as [alpha, s, W]."""
    return flat[: alpha * s].reshape(alpha, s, W)


def _claim_kernel(flat, eq_table, comb, alpha: int, mesh=None):
    """sum_k eq[k] * g(E(k)) from the flat merged lookups (rows of
    eq_table's length; with a mesh, this rank's shards, summed over the
    ranks)."""
    rows = _rows_view(flat, alpha, eq_table.shape[0])
    return finish_columns(TFr.sum_columns(TFr.mul(comb(rows), eq_table)), mesh)


def weighted_evals(flat, chis, rows: int, mesh=None):
    """[rows, W]: the first `rows` rows (of chis' length) of a flat merged
    array, each evaluated at the point whose eq table is `chis`; with a
    mesh, both are this rank's shards and the sums run over the ranks."""
    prods = TFr.mul(_rows_view(flat, rows, chis.shape[0]), chis[None])
    return finish_columns(TFr.sum_columns(prods.movedim(1, 0)), mesh)


class Subtables:
    """Materialized subtables + lookup polynomials for one proof instance,
    stored as ONE flat merged array (`combined_poly.z`).  With a mesh
    (parallel/sharded.ShardedSubtables), nz and the merged array are this
    rank's cyclic shards."""

    mesh = None

    @instrument("Subtables.construct")
    def __init__(self, strategy: SubtableStrategy, nz: torch.Tensor, s: int):
        """nz: [C, s/D] int64 lookup indices on the proof's device (D = 1
        without a mesh)."""
        d = 1 if self.mesh is None else self.mesh.size
        assert tuple(nz.shape) == (strategy.c, s // d)
        self.strategy = strategy
        self.s = s
        device = nz.device

        tables_u64 = strategy.materialize_subtables()  # [NS, M] uint64
        self.table_vals = TFr.encode_u64_array(tables_u64, device)  # [NS, M, W]

        alpha = strategy.num_memories
        sub_of = tuple(strategy.memory_to_subtable_index(i)
                       for i in range(alpha))
        dim_of = tuple(strategy.memory_to_dimension_index(i)
                       for i in range(alpha))
        n = _next_pow2(alpha * s)
        flat = _gather_flat(self.table_vals, nz, sub_of, dim_of,
                            (n - alpha * s) // d)
        self.lookup_stack = _rows_view(flat, alpha, s // d)
        self.combined_poly = self._poly(flat, n)

    def _poly(self, flat, n: int):
        return DensePolynomial(flat)

    @property
    def lookup_polys(self) -> list[DensePolynomial]:
        return [DensePolynomial(self.lookup_stack[i])
                for i in range(self.strategy.num_memories)]

    def combine_eq_device(self, zs):
        """The primary sumcheck's combine function over zs [alpha+1, m, W]:
        the one that prove hands to prove_arbitrary."""
        return self.strategy.comb_eq_device()(zs)

    def stack_with_eq(self, eq_table: torch.Tensor) -> torch.Tensor:
        """[E_1..E_alpha, eq]: the primary sumcheck's stack."""
        return torch.cat([self.lookup_stack, eq_table[None]], dim=0)

    @instrument("Subtables.compute_sumcheck_claim")
    def compute_sumcheck_claim(self, eq_table: torch.Tensor) -> int:
        """sum_k eq[k] * g(E_1[k] .. E_alpha[k]) (reference: mod.rs:186-216)."""
        total = _claim_kernel(
            self.combined_poly.z, eq_table, self.strategy.comb_device(),
            self.strategy.num_memories, self.mesh)
        return TFr.decode(total[None])[0]

    def evaluate_lookups_at(self, chis: torch.Tensor) -> list[int]:
        """All E_i evaluated at a point given its eq table ([n, W])."""
        return TFr.decode(weighted_evals(
            self.combined_poly.z, chis, self.strategy.num_memories,
            self.mesh))

    @instrument("Subtables.commit", sync=True)
    def commit(self, gens: PolyCommitmentGens) -> "CombinedTableCommitment":
        comm, _ = commit_poly(self.combined_poly, gens)
        return CombinedTableCommitment(comm)


@dataclass
class CombinedTableCommitment:
    comm_ops_val: PolyCommitment

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(
            b"subtable_evals_commitment", b"begin_subtable_evals_commitment")
        self.comm_ops_val.append_to_transcript(label, transcript)
        transcript.append_message(
            b"subtable_evals_commitment", b"end_subtable_evals_commitment")


@dataclass
class CombinedTableEvalProof:
    """n-to-1 reduction + one joint opening (reference: mod.rs:229-380)."""

    proof_table_eval: PolyEvalProof

    PROTOCOL_NAME = b"Lasso CombinedTableEvalProof"

    @staticmethod
    @instrument("CombinedEval.prove")
    def prove(combined_poly: DensePolynomial, evals: list[int], r: list[int],
              gens: PolyCommitmentGens, transcript, random_tape
              ) -> "CombinedTableEvalProof":
        transcript.append_protocol_name(CombinedTableEvalProof.PROTOCOL_NAME)
        evals = list(evals) + [0] * (_next_pow2(len(evals)) - len(evals))

        transcript.append_scalars(b"evals_ops_val", evals)
        num_ch = (len(evals) - 1).bit_length()
        challenges = transcript.challenge_vector(
            b"challenge_combine_n_to_one", num_ch)

        vals = evals
        for c in reversed(challenges):
            vals = bound_var_bot_host(vals, c)
        assert len(vals) == 1
        joint_eval = vals[0]
        r_joint = challenges + list(r)
        transcript.append_scalar(b"joint_claim_eval", joint_eval)

        proof, _ = PolyEvalProof.prove(
            combined_poly, None, r_joint, joint_eval, None, gens,
            transcript, random_tape)
        return CombinedTableEvalProof(proof)

    def verify(self, r: list[int], evals: list[int], gens: PolyCommitmentGens,
               comm: CombinedTableCommitment, transcript, device,
               deferred=None) -> None:
        transcript.append_protocol_name(CombinedTableEvalProof.PROTOCOL_NAME)
        evals = list(evals) + [0] * (_next_pow2(len(evals)) - len(evals))

        transcript.append_scalars(b"evals_ops_val", evals)
        num_ch = (len(evals) - 1).bit_length()
        challenges = transcript.challenge_vector(
            b"challenge_combine_n_to_one", num_ch)
        vals = evals
        for c in reversed(challenges):
            vals = bound_var_bot_host(vals, c)
        if len(vals) != 1:
            raise LassoError("combined-eval fold did not reduce to one claim")
        joint_eval = vals[0]
        r_joint = challenges + list(r)
        transcript.append_scalar(b"joint_claim_eval", joint_eval)

        self.proof_table_eval.verify_plain(
            gens, transcript, r_joint, joint_eval, comm.comm_ops_val, device,
            deferred=deferred)
