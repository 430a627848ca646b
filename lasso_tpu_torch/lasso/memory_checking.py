"""Offline memory checking (port of lasso/memory_checking.py; reference:
src/lasso/memory_checking.rs).

Proves the lookup polynomials E_i are well-formed via Reed-Solomon multiset
fingerprints  h(a,v,t) = t*gamma^2 + v*gamma + a - tau  and batched grand
product arguments over the (init, read, write, final) sets: all alpha
memories' fingerprints are built by one vectorized expression per set, and
the 4*alpha product trees run as two batched circuits (read/write over the
s-cube, init/final over the M-cube).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.poly.dense import bound_var_bot_host, eq_table
from lasso_tpu_torch.poly.hyrax import PolyEvalProof
from lasso_tpu_torch.poly.identity import identity_poly_evaluate
from lasso_tpu_torch.subprotocols.grand_product import (
    BatchedGrandProductArgument, BatchedGrandProductCircuit,
    ShardedBatchedGPCircuit)
from lasso_tpu_torch.subtables.container import (CombinedTableEvalProof,
                                                 _rows_view, weighted_evals)
from lasso_tpu_torch.utils.errors import LassoError
from lasso_tpu_torch.utils.tracing import instrument, span

# Read/write leaf sets of at least this many field elements are recomputed
# by the grand-product circuit on demand instead of staying resident.
GP_RECOMPUTE_MIN = 1 << 23


def _fingerprint(a, v, t, gamma, gamma_sq, tau):
    """h(a, v, t) = t*gamma^2 + v*gamma + a - tau over any batch."""
    return TFr.sub(TFr.add(TFr.add(TFr.mul(t, gamma_sq), TFr.mul(v, gamma)), a), tau)


def _interleave(x, y):
    """[x_0, y_0, x_1, y_1, ...] along a new instance axis."""
    stacked = torch.stack([x, y], dim=1)  # [alpha, 2, n, W]
    return stacked.reshape(2 * x.shape[0], x.shape[1], x.shape[2])


def _rw_leaves_kernel(flat_l, flat_e, g, g2, t, dim_of: tuple, c: int,
                      s: int, half=None):
    """Read/write fingerprint leaves [2*alpha, s, W] from the flat merged
    polynomials; `half` = 0/1 computes only the left/right column half."""
    alpha = len(dim_of)
    lo, hi = {None: (0, s), 0: (0, s // 2), 1: (s // 2, s)}[half]
    dim_read = _rows_view(flat_l, 2 * c, s)[:, lo:hi]
    dim, read = dim_read[:c], dim_read[c:]
    dim_stack = torch.stack([dim[d] for d in dim_of])
    read_stack = torch.stack([read[d] for d in dim_of])
    v_ops = _rows_view(flat_e, alpha, s)[:, lo:hi]
    one = TFr.ones(hi - lo, flat_l.device)
    read_f = _fingerprint(dim_stack, v_ops, read_stack, g, g2, t)
    write_f = _fingerprint(dim_stack, v_ops, TFr.add(read_stack, one[None]),
                           g, g2, t)
    return _interleave(read_f, write_f)


def _if_leaves_kernel(flat_m, table_vals, addr, g, g2, t, dim_of: tuple,
                      sub_of: tuple, c: int, m: int):
    """Init/final fingerprint leaves [2*alpha, M, W] (M-sized: small)."""
    final = _rows_view(flat_m, c, m)
    final_stack = torch.stack([final[d] for d in dim_of])
    v_mem = torch.stack([table_vals[k] for k in sub_of])
    zero = torch.zeros_like(addr)
    init_f = _fingerprint(addr[None], v_mem, zero[None], g, g2, t)
    final_f = _fingerprint(addr[None], v_mem, final_stack, g, g2, t)
    return _interleave(init_f, final_f)


def build_grand_product_batches(dense, subtables, r_mem_check, mesh=None):
    """Fingerprint inputs for all memories.

    Returns (read_write_circuits, init_final_circuits): batched circuits with
    instances interleaved [read_0, write_0, read_1, ...] and
    [init_0, final_0, init_1, ...] (reference: memory_checking.rs:707-722).
    With a mesh, the leaves are this rank's cyclic shards (D | s and D | M,
    so a merged shard is the per-polynomial shards one after the other) and
    the circuits ShardedBatchedGPCircuits.
    """
    strategy = subtables.strategy
    device = dense.device
    d, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    s, m = dense.s // d, dense.m // d  # this rank's extents
    gamma, tau = r_mem_check
    g = TFr.encode_scalar(gamma, device)
    g2 = TFr.encode_scalar(gamma * gamma % Fr.p, device)
    t = TFr.encode_scalar(tau, device)

    alpha = strategy.num_memories
    dim_of = tuple(strategy.memory_to_dimension_index(i) for i in range(alpha))
    sub_of = tuple(strategy.memory_to_subtable_index(i) for i in range(alpha))

    addr = TFr.encode_u64_array(
        np.arange(rank, dense.m, d, dtype=np.uint64), device)  # [M/D, W]
    table_vals = subtables.table_vals[:, rank::d]

    def rw_leaves(half=None):
        return _rw_leaves_kernel(
            dense.combined_l_variate_polys.z, subtables.combined_poly.z,
            g, g2, t, dim_of, dense.c, s, half)

    if_leaves = _if_leaves_kernel(
        dense.combined_log_m_variate_polys.z, table_vals, addr,
        g, g2, t, dim_of, sub_of, dense.c, m)

    if mesh is not None:
        return (ShardedBatchedGPCircuit(mesh, rw_leaves()),
                ShardedBatchedGPCircuit(mesh, if_leaves))
    if 2 * alpha * dense.s >= GP_RECOMPUTE_MIN:
        rw = BatchedGrandProductCircuit(
            leaves_fn=rw_leaves, shape=(2 * alpha, dense.s))
    else:
        rw = BatchedGrandProductCircuit(rw_leaves(None))
    inf = BatchedGrandProductCircuit(if_leaves)
    return rw, inf


@dataclass
class ProductLayerProof:
    grand_product_evals: list[tuple]  # (init, read, write, final) per memory
    proof_mem: BatchedGrandProductArgument
    proof_ops: BatchedGrandProductArgument

    PROTOCOL_NAME = b"Lasso ProductLayerProof"

    @staticmethod
    @instrument("MemoryChecking.ProductLayer.prove")
    def prove(rw_circuits, if_circuits, transcript):
        """Returns (proof, rand_mem, rand_ops)."""
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL_NAME)

        rw_roots = rw_circuits.evaluate()  # [read_0, write_0, ...]
        if_roots = if_circuits.evaluate()  # [init_0, final_0, ...]
        alpha = len(rw_roots) // 2

        grand_product_evals = []
        for i in range(alpha):
            h_init, h_final = if_roots[2 * i], if_roots[2 * i + 1]
            h_read, h_write = rw_roots[2 * i], rw_roots[2 * i + 1]
            assert h_init * h_write % Fr.p == h_read * h_final % Fr.p, \
                "multiset hash identity failed (prover bug)"
            transcript.append_scalar(b"claim_hash_init", h_init)
            transcript.append_scalar(b"claim_hash_read", h_read)
            transcript.append_scalar(b"claim_hash_write", h_write)
            transcript.append_scalar(b"claim_hash_final", h_final)
            grand_product_evals.append((h_init, h_read, h_write, h_final))

        proof_ops, rand_ops = BatchedGrandProductArgument.prove(
            rw_circuits, transcript)
        rw_circuits.release()
        proof_mem, rand_mem = BatchedGrandProductArgument.prove(
            if_circuits, transcript)
        if_circuits.release()

        return (ProductLayerProof(grand_product_evals, proof_mem, proof_ops),
                rand_mem, rand_ops)

    def verify(self, num_ops: int, num_cells: int, transcript):
        """Returns (claims_mem, rand_mem, claims_ops, rand_ops)."""
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL_NAME)

        for (h_init, h_read, h_write, h_final) in self.grand_product_evals:
            if h_init * h_write % Fr.p != h_read * h_final % Fr.p:
                raise LassoError("multiset hash identity failed")
            transcript.append_scalar(b"claim_hash_init", h_init)
            transcript.append_scalar(b"claim_hash_read", h_read)
            transcript.append_scalar(b"claim_hash_write", h_write)
            transcript.append_scalar(b"claim_hash_final", h_final)

        read_write_claims = []
        for (_, h_read, h_write, _) in self.grand_product_evals:
            read_write_claims += [h_read, h_write]
        claims_ops, rand_ops = self.proof_ops.verify(
            read_write_claims, num_ops, transcript)

        init_final_claims = []
        for (h_init, _, _, h_final) in self.grand_product_evals:
            init_final_claims += [h_init, h_final]
        claims_mem, rand_mem = self.proof_mem.verify(
            init_final_claims, num_cells, transcript)

        return claims_mem, rand_mem, claims_ops, rand_ops


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


@dataclass
class HashLayerProof:
    eval_dim: list[int]
    eval_read: list[int]
    eval_final: list[int]
    eval_derefs: list[int]
    proof_ops: PolyEvalProof
    proof_mem: PolyEvalProof
    proof_derefs: CombinedTableEvalProof

    PROTOCOL_NAME = b"Lasso HashLayerProof"

    @staticmethod
    @instrument("MemoryChecking.HashLayer.prove")
    def prove(rand_mem, rand_ops, dense, subtables, gens, transcript,
              random_tape, mesh=None):
        transcript.append_protocol_name(HashLayerProof.PROTOCOL_NAME)
        device = dense.device

        with span("HashLayer.eq_tables"):
            chis_ops = eq_table(rand_ops, device, mesh)
            chis_mem = eq_table(rand_mem, device, mesh)

        # decommit E_i at rand_ops
        with span("HashLayer.eval_derefs"):
            eval_derefs = subtables.evaluate_lookups_at(chis_ops)
        proof_derefs = CombinedTableEvalProof.prove(
            subtables.combined_poly, eval_derefs, rand_ops,
            gens.gens_derefs, transcript, random_tape)

        c = dense.c
        with span("HashLayer.stack_evals"):
            dim_read_evals = TFr.decode(weighted_evals(
                dense.combined_l_variate_polys.z, chis_ops, 2 * c, mesh))
            eval_dim, eval_read = dim_read_evals[:c], dim_read_evals[c:]
            eval_final = TFr.decode(weighted_evals(
                dense.combined_log_m_variate_polys.z, chis_mem, c, mesh))
            del chis_ops, chis_mem

        with span("HashLayer.fold_ops"):
            evals_ops = eval_dim + eval_read
            evals_ops += [0] * (_next_pow2(len(evals_ops)) - len(evals_ops))
            transcript.append_scalars(b"claim_evals_ops", evals_ops)
            challenges_ops = transcript.challenge_vector(
                b"challenge_combine_n_to_one", (len(evals_ops) - 1).bit_length())

            vals = evals_ops
            for ch in reversed(challenges_ops):
                vals = bound_var_bot_host(vals, ch)
            joint_claim_eval_ops = vals[0]
            r_joint_ops = challenges_ops + list(rand_ops)
            transcript.append_scalar(b"joint_claim_eval_ops", joint_claim_eval_ops)
        with span("HashLayer.open_ops"):
            proof_ops, _ = PolyEvalProof.prove(
                dense.combined_l_variate_polys, None, r_joint_ops,
                joint_claim_eval_ops, None, gens.gens_combined_l_variate,
                transcript, random_tape)

        transcript.append_scalars(b"claim_evals_mem", eval_final)
        challenges_mem = transcript.challenge_vector(
            b"challenge_combine_two_to_one", (len(eval_final) - 1).bit_length())
        vals = eval_final + [0] * (_next_pow2(len(eval_final)) - len(eval_final))
        for ch in reversed(challenges_mem):
            vals = bound_var_bot_host(vals, ch)
        joint_claim_eval_mem = vals[0]
        r_joint_mem = challenges_mem + list(rand_mem)
        transcript.append_scalar(b"joint_claim_eval_mem", joint_claim_eval_mem)
        proof_mem, _ = PolyEvalProof.prove(
            dense.combined_log_m_variate_polys, None, r_joint_mem,
            joint_claim_eval_mem, None, gens.gens_combined_log_m_variate,
            transcript, random_tape)

        return HashLayerProof(
            eval_dim=eval_dim, eval_read=eval_read, eval_final=eval_final,
            eval_derefs=eval_derefs, proof_ops=proof_ops, proof_mem=proof_mem,
            proof_derefs=proof_derefs)

    @staticmethod
    def _check_fingerprints(claims, eval_deref, eval_dim, eval_read, eval_final,
                            init_addr, init_memory, gamma, tau):
        """Verify the grand-product leaf claims against the fingerprint form
        (reference: memory_checking.rs:477-523)."""
        p = Fr.p
        g2 = gamma * gamma % p

        def hash_func(a, v, t):
            return (t * g2 + v * gamma + a - tau) % p

        claim_init, claim_read, claim_write, claim_final = claims
        if hash_func(init_addr, init_memory, 0) != claim_init:
            raise LassoError("init fingerprint mismatch")
        if hash_func(eval_dim, eval_deref, eval_read) != claim_read:
            raise LassoError("read fingerprint mismatch")
        if hash_func(eval_dim, eval_deref, (eval_read + 1) % p) != claim_write:
            raise LassoError("write fingerprint mismatch")
        if hash_func(init_addr, init_memory, eval_final) != claim_final:
            raise LassoError("final fingerprint mismatch")

    def verify(self, rand_mem, rand_ops, grand_product_claims, comm, gens,
               comm_derefs, r_hash, r_multiset_check, strategy, transcript,
               device, deferred=None):
        transcript.append_protocol_name(HashLayerProof.PROTOCOL_NAME)

        self.proof_derefs.verify(
            rand_ops, self.eval_derefs, gens.gens_derefs, comm_derefs,
            transcript, device, deferred=deferred)

        evals_ops = list(self.eval_dim) + list(self.eval_read)
        evals_ops += [0] * (_next_pow2(len(evals_ops)) - len(evals_ops))
        transcript.append_scalars(b"claim_evals_ops", evals_ops)
        challenges_ops = transcript.challenge_vector(
            b"challenge_combine_n_to_one", (len(evals_ops) - 1).bit_length())
        vals = evals_ops
        for ch in reversed(challenges_ops):
            vals = bound_var_bot_host(vals, ch)
        joint_claim_eval_ops = vals[0]
        r_joint_ops = challenges_ops + list(rand_ops)
        transcript.append_scalar(b"joint_claim_eval_ops", joint_claim_eval_ops)
        self.proof_ops.verify_plain(
            gens.gens_combined_l_variate, transcript, r_joint_ops,
            joint_claim_eval_ops, comm.l_variate_polys_commitment, device,
            deferred=deferred)

        transcript.append_scalars(b"claim_evals_mem", self.eval_final)
        challenges_mem = transcript.challenge_vector(
            b"challenge_combine_two_to_one", (len(self.eval_final) - 1).bit_length())
        vals = list(self.eval_final)
        vals += [0] * (_next_pow2(len(vals)) - len(vals))
        for ch in reversed(challenges_mem):
            vals = bound_var_bot_host(vals, ch)
        joint_claim_eval_mem = vals[0]
        r_joint_mem = challenges_mem + list(rand_mem)
        transcript.append_scalar(b"joint_claim_eval_mem", joint_claim_eval_mem)
        self.proof_mem.verify_plain(
            gens.gens_combined_log_m_variate, transcript, r_joint_mem,
            joint_claim_eval_mem, comm.log_m_variate_polys_commitment, device,
            deferred=deferred)

        init_addr = identity_poly_evaluate(rand_mem)
        for i, claims in enumerate(grand_product_claims):
            j = strategy.memory_to_dimension_index(i)
            k = strategy.memory_to_subtable_index(i)
            HashLayerProof._check_fingerprints(
                claims, self.eval_derefs[i], self.eval_dim[j],
                self.eval_read[j], self.eval_final[j], init_addr,
                strategy.evaluate_subtable_mle(k, rand_mem),
                r_hash, r_multiset_check)


@dataclass
class MemoryCheckingProof:
    proof_prod_layer: ProductLayerProof
    proof_hash_layer: HashLayerProof

    PROTOCOL_NAME = b"Lasso MemoryCheckingProof"

    @staticmethod
    @instrument("MemoryChecking.prove")
    def prove(dense, r_mem_check, subtables, gens, transcript, random_tape,
              mesh=None):
        """With a mesh, dense and subtables are this rank's shards
        (parallel/sharded.py); the proof is the same."""
        transcript.append_protocol_name(MemoryCheckingProof.PROTOCOL_NAME)

        rw, inf = build_grand_product_batches(dense, subtables, r_mem_check,
                                              mesh)
        proof_prod_layer, rand_mem, rand_ops = ProductLayerProof.prove(
            rw, inf, transcript)

        proof_hash_layer = HashLayerProof.prove(
            rand_mem, rand_ops, dense, subtables, gens, transcript,
            random_tape, mesh)

        return MemoryCheckingProof(proof_prod_layer, proof_hash_layer)

    def verify(self, comm, comm_derefs, gens, r_mem_check, s, strategy,
               transcript, device, deferred=None) -> None:
        transcript.append_protocol_name(MemoryCheckingProof.PROTOCOL_NAME)

        r_hash, r_multiset_check = r_mem_check
        num_ops = _next_pow2(s)
        num_cells = comm.m

        claims_mem, rand_mem, claims_ops, rand_ops = \
            self.proof_prod_layer.verify(num_ops, num_cells, transcript)

        alpha = strategy.num_memories
        claims = [
            (claims_mem[2 * i], claims_ops[2 * i],
             claims_ops[2 * i + 1], claims_mem[2 * i + 1])
            for i in range(alpha)
        ]

        self.proof_hash_layer.verify(
            rand_mem, rand_ops, claims, comm, gens, comm_derefs,
            r_hash, r_multiset_check, strategy, transcript, device,
            deferred=deferred)
