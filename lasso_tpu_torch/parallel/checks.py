"""A rank function for the tests: it runs the provers' mesh-aware pieces on
this rank's shards of given inputs and returns what they give, so that the
caller can hold them against the single-device functions on the same
inputs (tests/test_torch_msm.py does, as gloo ranks on the CPU).  It lives
in the package because `spawn` pickles a rank function by module name.

    results = launch.spawn(primitives_rank, 8, "gloo", "cpu", inputs)

`inputs` (numpy, the same on every rank): "zs" [alpha, n, W] and "r" [W]
Montgomery Fr; "eq_r" a list of Fr ints; "sc_zs" [3, 64, W] for the
sumcheck over comb = z0*z1*z2; "leaves" [I, n, W] for a grand-product
argument; "commit_z" [2^k, W] for a Hyrax commitment.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.parallel.sharded import (ShardedPoly, local_shard,
                                              sharded_commit)
from lasso_tpu_torch.poly.hyrax import PolyCommitmentGens
from lasso_tpu_torch.subprotocols.grand_product import (
    BatchedGrandProductArgument, ShardedBatchedGPCircuit)
from lasso_tpu_torch.subprotocols.sumcheck import (_bind_top, _round_evals,
                                                   prove_arbitrary)
from lasso_tpu_torch.transcript.proof_transcript import ProofTranscript


def product_comb(z):
    """comb(z) = z_0 * z_1 * ... over the stacked tables [alpha, m, W]."""
    out = z[0]
    for row in z[1:]:
        out = TFr.mul(out, row)
    return out


def primitives_rank(mesh, inputs: dict) -> dict:
    def shard(name, axis=0):
        return local_shard(mesh, torch.as_tensor(inputs[name]), axis)

    def dec(x):
        return TFr.decode(x.reshape(-1, x.shape[-1]))

    zs = shard("zs", axis=1)
    r = torch.as_tensor(inputs["r"]).to(mesh.device)
    proof, r_sc, finals, _ = prove_arbitrary(
        shard("sc_zs", axis=1), product_comb, 3, 6, ProofTranscript(b"dist"),
        mesh)
    gp, gp_rand = BatchedGrandProductArgument.prove(
        ShardedBatchedGPCircuit(mesh, shard("leaves", axis=1)),
        ProofTranscript(b"dist"))
    z = torch.as_tensor(inputs["commit_z"])
    comm = sharded_commit(
        ShardedPoly(mesh, local_shard(mesh, z), z.shape[0]),
        PolyCommitmentGens.new((z.shape[0] - 1).bit_length(), b"dist"))
    return {
        "round_evals": dec(_round_evals(zs, product_comb, zs.shape[0], mesh)),
        "bound": dec(mesh.gather(_bind_top(zs, r), axis=1)),
        "eq": dec(mesh.gather(mesh.eq(list(inputs["eq_r"])))),
        "sumcheck": ([p.coeffs_except_linear_term
                      for p in proof.compressed_polys], r_sc, finals),
        "grand_product": ([([p.coeffs_except_linear_term
                             for p in layer.proof.compressed_polys],
                            layer.claims_prod_left, layer.claims_prod_right)
                           for layer in gp.proof], gp_rand),
        "commitment": [p.to_compressed_bytes() for p in comm.C],
    }
