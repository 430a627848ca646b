"""Proof (de)serialization (reference: CanonicalSerialize/Deserialize derives
on every proof struct, e.g. surge.rs:61-92, sumcheck.rs:263, bullet.rs,
grand_product.rs:94).

Primitive encodings are ark-serialize compatible (compressed mode):
scalars = 32-byte LE canonical; points = 32-byte compressed Edwards
(y || sign-of-x bit); vectors = u64 LE length prefix + elements; struct
fields in declaration order.  This is the natural persistence boundary for
proofs -- the protocol has no other checkpoint/resume state (SURVEY.md 5.4).
"""

from __future__ import annotations

import io

from lasso_tpu_torch.curve.host import Point
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.utils.errors import DecompressionError


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def scalar(self, x: int):
        self.buf.write(Fr.to_bytes(x % Fr.p))

    def point(self, p: Point):
        self.buf.write(p.to_compressed_bytes())

    def u64(self, x: int):
        self.buf.write(int(x).to_bytes(8, "little"))

    def scalar_vec(self, xs):
        self.u64(len(xs))
        for x in xs:
            self.scalar(x)

    def point_vec(self, ps):
        self.u64(len(ps))
        for p in ps:
            self.point(p)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    def _take(self, n: int) -> bytes:
        b = self.buf.read(n)
        if len(b) != n:
            raise DecompressionError("truncated proof bytes")
        return b

    def scalar(self) -> int:
        try:
            return Fr.from_bytes(self._take(32))
        except ValueError as e:  # non-canonical scalar encoding
            raise DecompressionError(str(e)) from e

    def point(self) -> Point:
        return Point.from_compressed_bytes(self._take(32))

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def scalar_vec(self) -> list[int]:
        return [self.scalar() for _ in range(self.u64())]

    def point_vec(self) -> list[Point]:
        return [self.point() for _ in range(self.u64())]

    def done(self) -> bool:
        return self.buf.read(1) == b""


# ---------------------------------------------------------------------------
# per-structure encoders (struct fields in declaration order)
# ---------------------------------------------------------------------------

def _w_compressed_unipoly(w: Writer, cp) -> None:
    w.scalar_vec(cp.coeffs_except_linear_term)


def _r_compressed_unipoly(r: Reader):
    from lasso_tpu_torch.poly.unipoly import CompressedUniPoly

    return CompressedUniPoly(r.scalar_vec())


def _w_sumcheck(w: Writer, proof) -> None:
    w.u64(len(proof.compressed_polys))
    for cp in proof.compressed_polys:
        _w_compressed_unipoly(w, cp)


def _r_sumcheck(r: Reader):
    from lasso_tpu_torch.subprotocols.sumcheck import SumcheckInstanceProof

    n = r.u64()
    return SumcheckInstanceProof([_r_compressed_unipoly(r) for _ in range(n)])


def _w_bullet(w: Writer, proof) -> None:
    w.point_vec(proof.L_vec)
    w.point_vec(proof.R_vec)


def _r_bullet(r: Reader):
    from lasso_tpu_torch.subprotocols.bullet import BulletReductionProof

    return BulletReductionProof(r.point_vec(), r.point_vec())


def _w_dot_log(w: Writer, proof) -> None:
    _w_bullet(w, proof.bullet_reduction_proof)
    w.point(proof.delta)
    w.point(proof.beta)
    w.scalar(proof.z1)
    w.scalar(proof.z2)


def _r_dot_log(r: Reader):
    from lasso_tpu_torch.subprotocols.dot_product import DotProductProofLog

    return DotProductProofLog(_r_bullet(r), r.point(), r.point(),
                              r.scalar(), r.scalar())


def _w_poly_eval(w: Writer, proof) -> None:
    _w_dot_log(w, proof.proof)


def _r_poly_eval(r: Reader):
    from lasso_tpu_torch.poly.hyrax import PolyEvalProof

    return PolyEvalProof(_r_dot_log(r))


def _w_poly_commitment(w: Writer, comm) -> None:
    w.point_vec(comm.C)


def _r_poly_commitment(r: Reader):
    from lasso_tpu_torch.poly.hyrax import PolyCommitment

    return PolyCommitment(r.point_vec())


def _w_combined_eval(w: Writer, proof) -> None:
    _w_poly_eval(w, proof.proof_table_eval)


def _r_combined_eval(r: Reader):
    from lasso_tpu_torch.subtables.container import CombinedTableEvalProof

    return CombinedTableEvalProof(_r_poly_eval(r))


def _w_layer(w: Writer, layer) -> None:
    _w_sumcheck(w, layer.proof)
    w.scalar_vec(layer.claims_prod_left)
    w.scalar_vec(layer.claims_prod_right)


def _r_layer(r: Reader):
    from lasso_tpu_torch.subprotocols.grand_product import LayerProofBatched

    return LayerProofBatched(_r_sumcheck(r), r.scalar_vec(), r.scalar_vec())


def _w_batched_gp(w: Writer, arg) -> None:
    w.u64(len(arg.proof))
    for layer in arg.proof:
        _w_layer(w, layer)


def _r_batched_gp(r: Reader):
    from lasso_tpu_torch.subprotocols.grand_product import BatchedGrandProductArgument

    n = r.u64()
    return BatchedGrandProductArgument([_r_layer(r) for _ in range(n)])


def serialize_proof(proof) -> bytes:
    """SparsePolynomialEvaluationProof -> bytes."""
    w = Writer()
    # comm_derefs
    _w_poly_commitment(w, proof.comm_derefs.comm_ops_val)
    # primary sumcheck
    ps = proof.primary_sumcheck
    _w_sumcheck(w, ps.proof)
    w.scalar(ps.claimed_evaluation)
    w.scalar_vec(ps.eval_derefs)
    _w_combined_eval(w, ps.proof_derefs)
    # memory check: product layer
    pl = proof.memory_check.proof_prod_layer
    w.u64(len(pl.grand_product_evals))
    for (h_init, h_read, h_write, h_final) in pl.grand_product_evals:
        w.scalar(h_init)
        w.scalar(h_read)
        w.scalar(h_write)
        w.scalar(h_final)
    _w_batched_gp(w, pl.proof_mem)
    _w_batched_gp(w, pl.proof_ops)
    # memory check: hash layer
    hl = proof.memory_check.proof_hash_layer
    w.scalar_vec(hl.eval_dim)
    w.scalar_vec(hl.eval_read)
    w.scalar_vec(hl.eval_final)
    w.scalar_vec(hl.eval_derefs)
    _w_poly_eval(w, hl.proof_ops)
    _w_poly_eval(w, hl.proof_mem)
    _w_combined_eval(w, hl.proof_derefs)
    return w.getvalue()


def deserialize_proof(data: bytes, strategy):
    """bytes -> SparsePolynomialEvaluationProof (strategy supplied by the
    caller, as in the reference where it is a type parameter)."""
    from lasso_tpu_torch.lasso.memory_checking import (HashLayerProof,
                                                 MemoryCheckingProof,
                                                 ProductLayerProof)
    from lasso_tpu_torch.lasso.surge import (PrimarySumcheck,
                                       SparsePolynomialEvaluationProof)
    from lasso_tpu_torch.subtables.container import CombinedTableCommitment

    r = Reader(data)
    comm_derefs = CombinedTableCommitment(_r_poly_commitment(r))
    primary = PrimarySumcheck(
        proof=_r_sumcheck(r), claimed_evaluation=r.scalar(),
        eval_derefs=r.scalar_vec(), proof_derefs=_r_combined_eval(r))
    n = r.u64()
    gpe = [(r.scalar(), r.scalar(), r.scalar(), r.scalar()) for _ in range(n)]
    prod_layer = ProductLayerProof(gpe, _r_batched_gp(r), _r_batched_gp(r))
    hash_layer = HashLayerProof(
        eval_dim=r.scalar_vec(), eval_read=r.scalar_vec(),
        eval_final=r.scalar_vec(), eval_derefs=r.scalar_vec(),
        proof_ops=_r_poly_eval(r), proof_mem=_r_poly_eval(r),
        proof_derefs=_r_combined_eval(r))
    if not r.done():
        raise DecompressionError("trailing bytes after proof")
    return SparsePolynomialEvaluationProof(
        comm_derefs=comm_derefs, primary_sumcheck=primary,
        memory_check=MemoryCheckingProof(prod_layer, hash_layer),
        strategy=strategy)


def serialize_commitment(comm) -> bytes:
    w = Writer()
    _w_poly_commitment(w, comm.l_variate_polys_commitment)
    _w_poly_commitment(w, comm.log_m_variate_polys_commitment)
    w.u64(comm.s)
    w.u64(comm.log_m)
    w.u64(comm.m)
    return w.getvalue()


def deserialize_commitment(data: bytes):
    from lasso_tpu_torch.lasso.densified import SparsePolynomialCommitment

    r = Reader(data)
    out = SparsePolynomialCommitment(
        l_variate_polys_commitment=_r_poly_commitment(r),
        log_m_variate_polys_commitment=_r_poly_commitment(r),
        s=r.u64(), log_m=r.u64(), m=r.u64())
    if not r.done():
        raise DecompressionError("trailing bytes after commitment")
    return out
