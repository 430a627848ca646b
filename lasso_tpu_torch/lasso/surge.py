"""Top-level Lasso prover/verifier: SparsePolynomialEvaluationProof (port of
lasso/surge.py; reference: src/lasso/surge.rs).

Flow (prove): commit lookups E_i -> primary sumcheck over
sum_k eq(r,k) * g(E_1[k]..E_alpha[k]) -> combined opening of E_i(r_z) ->
memory checking.  The hypercube-sized stages run on the dense
representation's device (the card unless the caller asked for the CPU);
the Fiat-Shamir transcript runs on the host.  With a mesh, the same prove
runs sharded over its ranks (parallel/), with the same proof bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.lasso.densified import (DensifiedRepresentation,
                                             SparsePolynomialCommitment,
                                             resolve_device)
from lasso_tpu_torch.lasso.memory_checking import MemoryCheckingProof
from lasso_tpu_torch.poly.deferred import DeferredOpeningChecks
from lasso_tpu_torch.poly.dense import eq_evaluate_host, eq_table
from lasso_tpu_torch.poly.hyrax import PolyCommitmentGens
from lasso_tpu_torch.subprotocols.sumcheck import (SumcheckInstanceProof,
                                                   prove_arbitrary)
from lasso_tpu_torch.subtables.base import HostOps, SubtableStrategy
from lasso_tpu_torch.subtables.container import (CombinedTableCommitment,
                                                 CombinedTableEvalProof,
                                                 Subtables)
from lasso_tpu_torch.utils.errors import InvalidInputLength, LassoError
from lasso_tpu_torch.utils.tracing import instrument


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def _log2(n: int) -> int:
    return (n - 1).bit_length()


@dataclass
class SparsePolyCommitmentGens:
    gens_combined_l_variate: PolyCommitmentGens
    gens_combined_log_m_variate: PolyCommitmentGens
    gens_derefs: PolyCommitmentGens
    device: torch.device

    @staticmethod
    def new(label: bytes, c: int, s: int, num_memories: int, log_m: int,
            device="cuda") -> "SparsePolyCommitmentGens":
        """Generators for (C, s, M); `device` is where their bases live for
        the device MSMs (the card by default)."""
        device = resolve_device(device)
        num_vars_l = _log2(_next_pow2(2 * c * s))
        num_vars_m = _log2(_next_pow2(c)) + log_m
        num_vars_derefs = _log2(_next_pow2(num_memories * s))
        return SparsePolyCommitmentGens(
            gens_combined_l_variate=PolyCommitmentGens.new(num_vars_l, label),
            gens_combined_log_m_variate=PolyCommitmentGens.new(num_vars_m, label),
            gens_derefs=PolyCommitmentGens.new(num_vars_derefs, label),
            device=device,
        )


@dataclass
class PrimarySumcheck:
    proof: SumcheckInstanceProof
    claimed_evaluation: int
    eval_derefs: list[int]
    proof_derefs: CombinedTableEvalProof


@dataclass
class SparsePolynomialEvaluationProof:
    comm_derefs: CombinedTableCommitment
    primary_sumcheck: PrimarySumcheck
    memory_check: MemoryCheckingProof
    strategy: SubtableStrategy

    PROTOCOL_NAME = b"Lasso SparsePolynomialEvaluationProof"

    @staticmethod
    @instrument("SparsePoly.prove")
    def prove(dense: DensifiedRepresentation, r: list[int],
              gens: SparsePolyCommitmentGens, strategy: SubtableStrategy,
              transcript, random_tape, mesh=None
              ) -> "SparsePolynomialEvaluationProof":
        """Prove on the dense representation's device; with `mesh`, as one
        rank of the multi-device prover (parallel/), whose proof bytes are
        the same: every s- or M-sized table is this rank's cyclic shard,
        and `dense` may be given as the rank's ShardedDensified."""
        transcript.append_protocol_name(
            SparsePolynomialEvaluationProof.PROTOCOL_NAME)
        assert len(r) == _log2(dense.s)
        if mesh is None:
            subtables = Subtables(strategy, dense.dim_usize, dense.s)
        else:
            from lasso_tpu_torch.parallel.sharded import (ShardedDensified,
                                                          ShardedSubtables)
            if not isinstance(dense, ShardedDensified):
                dense = ShardedDensified(mesh, dense)
            subtables = ShardedSubtables(mesh, strategy, dense.dim_usize,
                                         dense.s)
        device = dense.device

        comm_derefs = subtables.commit(gens.gens_derefs)
        comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val", transcript)

        eq = eq_table(r, device, mesh)
        claimed_eval = subtables.compute_sumcheck_claim(eq)
        transcript.append_scalar(b"claim_eval_scalar_product", claimed_eval)

        stack = subtables.stack_with_eq(eq)
        del eq
        sc_proof, r_z, _final_evals, _ = prove_arbitrary(
            stack, strategy.comb_eq_device(), strategy.sumcheck_poly_degree(),
            _log2(dense.s), transcript, mesh)
        del stack

        chis_z = eq_table(r_z, device, mesh)
        eval_derefs = subtables.evaluate_lookups_at(chis_z)
        del chis_z
        proof_derefs = CombinedTableEvalProof.prove(
            subtables.combined_poly, eval_derefs, r_z, gens.gens_derefs,
            transcript, random_tape)

        r_hash_params = transcript.challenge_vector(b"challenge_r_hash", 2)
        memory_check = MemoryCheckingProof.prove(
            dense, (r_hash_params[0], r_hash_params[1]), subtables, gens,
            transcript, random_tape, mesh)

        return SparsePolynomialEvaluationProof(
            comm_derefs=comm_derefs,
            primary_sumcheck=PrimarySumcheck(
                proof=sc_proof, claimed_evaluation=claimed_eval,
                eval_derefs=eval_derefs, proof_derefs=proof_derefs),
            memory_check=memory_check,
            strategy=strategy)

    @instrument("SparsePoly.verify")
    def verify(self, commitment: SparsePolynomialCommitment,
               eq_randomness: list[int], gens: SparsePolyCommitmentGens,
               transcript) -> None:
        """Verify; its device MSMs (if any) run on the generators' device."""
        transcript.append_protocol_name(
            SparsePolynomialEvaluationProof.PROTOCOL_NAME)
        if len(eq_randomness) != _log2(commitment.s):
            raise InvalidInputLength(_log2(commitment.s), len(eq_randomness))
        device = gens.device

        self.comm_derefs.append_to_transcript(
            b"comm_poly_row_col_ops_val", transcript)
        transcript.append_scalar(
            b"claim_eval_scalar_product", self.primary_sumcheck.claimed_evaluation)

        claim_last, r_z = self.primary_sumcheck.proof.verify(
            self.primary_sumcheck.claimed_evaluation, _log2(commitment.s),
            self.strategy.sumcheck_poly_degree(), transcript)

        eq_eval = eq_evaluate_host(eq_randomness, r_z)
        g_eval = self.strategy.combine_lookups(
            self.primary_sumcheck.eval_derefs, HostOps)
        if eq_eval * g_eval % Fr.p != claim_last:
            raise LassoError("primary sumcheck final check failed")

        # one accumulator collects every opening's final check; resolve()
        # runs them as a single randomly-weighted batched check
        deferred = DeferredOpeningChecks(device)

        self.primary_sumcheck.proof_derefs.verify(
            r_z, self.primary_sumcheck.eval_derefs, gens.gens_derefs,
            self.comm_derefs, transcript, device, deferred=deferred)

        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        self.memory_check.verify(
            commitment, self.comm_derefs, gens,
            (r_mem_check[0], r_mem_check[1]), commitment.s, self.strategy,
            transcript, device, deferred=deferred)

        deferred.resolve()
