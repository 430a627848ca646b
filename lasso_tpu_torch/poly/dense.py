"""Dense multilinear polynomials on tensors (port of poly/dense.py).

The evaluation table is an [n, 16] Montgomery limb tensor over Fr on the
proof's device.  Index convention matches the reference: index bit 0 (LSB)
is the LAST variable; `bound_var_top` binds the most significant variable
(splits the table in halves), `bound_var_bot` the least significant
(even/odd interleave).  The sumcheck binds its tables with the same
`_bind_top_single`; the Hyrax opening needs the L-fold here.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, W, resolve_device


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _bind_top_single(z, r):
    """Bind the top variable of one table: [n, W] -> [n/2, W]."""
    half = z.shape[0] // 2
    lo, hi = z[:half], z[half:]
    return TFr.add(lo, TFr.mul(r, TFr.sub(hi, lo)))


def _bound_fold(z, l_vec):
    """L-fold L @ Z over the [L, R] matrix view."""
    l_size = l_vec.shape[0]
    zmat = z.reshape(l_size, -1, W)
    return TFr.sum(TFr.mul(zmat, l_vec[:, None, :]))


def eq_evals_device(r_list, device) -> torch.Tensor:
    """eq(r, .) table over {0,1}^len(r): [2^l, W]; index MSB <-> r[0]
    (reference: src/poly/eq_poly.rs:21-38)."""
    e = TFr.ones(1, device)
    for r in r_list:
        t = TFr.mul(e, r)  # e * r_j
        rest = TFr.sub(e, t)  # e * (1 - r_j)
        e = torch.stack([rest, t], dim=1).reshape(-1, W)
    return e


def eq_table(r: list[int], device, mesh=None) -> torch.Tensor:
    """eq(r, .) over {0,1}^len(r) for host challenges r, on `device`; with a
    mesh (parallel/mesh.py), this rank's cyclic shard of it."""
    if mesh is not None:
        return mesh.eq(r)
    return eq_evals_device([TFr.encode_scalar(x, device) for x in r], device)


def finish_columns(cols, mesh=None) -> torch.Tensor:
    """Lazy column sums (TFr.sum_columns) -> canonical Montgomery elements;
    with a mesh, the ranks' partial columns are summed first."""
    return TFr.finish_sum(cols if mesh is None else mesh.psum(cols.contiguous()))


class DensePolynomial:
    """Evaluations over the boolean hypercube, on a device."""

    def __init__(self, z: torch.Tensor):
        assert z.ndim == 2 and z.shape[1] == W
        assert _is_pow2(z.shape[0]), "dense MLE length must be a power of two"
        self.z = z

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_ints(cls, vals, device="cuda") -> "DensePolynomial":
        return cls(TFr.encode_ints(vals, resolve_device(device)))

    @classmethod
    def from_u64(cls, vals, device="cuda") -> "DensePolynomial":
        """From small non-negative ints (e.g. indices/counters), padded to pow2."""
        vals = np.asarray(vals, dtype=np.uint64)
        n = len(vals)
        pow2 = 1 << max((n - 1).bit_length(), 0) if n else 1
        if pow2 != n:
            vals = np.concatenate([vals, np.zeros(pow2 - n, dtype=np.uint64)])
        return cls(TFr.encode_u64_array(vals, resolve_device(device)))

    @classmethod
    def merge(cls, polys) -> "DensePolynomial":
        """Concatenate several polynomials, zero-padded to the next pow2
        (reference: dense_mlpoly.rs:251-261)."""
        zs = [p.z for p in polys]
        total = sum(z.shape[0] for z in zs)
        pow2 = 1 << (total - 1).bit_length()
        if pow2 != total:
            zs.append(TFr.zeros(pow2 - total, zs[0].device))
        return cls(torch.cat(zs, dim=0))

    # -- metadata -------------------------------------------------------
    def __len__(self) -> int:
        return self.z.shape[0]

    @property
    def num_vars(self) -> int:
        return (len(self) - 1).bit_length()

    @property
    def device(self) -> torch.device:
        return self.z.device

    def clone(self) -> "DensePolynomial":
        return DensePolynomial(self.z)

    def split(self, idx: int):
        return DensePolynomial(self.z[:idx]), DensePolynomial(self.z[idx: 2 * idx])

    # -- core ops -------------------------------------------------------
    def bound_var_top(self, r) -> "DensePolynomial":
        """Bind the top variable to scalar r ([W] Montgomery limbs)."""
        return DensePolynomial(_bind_top_single(self.z, r))

    def bound_var_bot(self, r) -> "DensePolynomial":
        """Bind the bottom variable (the even/odd interleave) to r."""
        lo, hi = self.z[0::2], self.z[1::2]
        return DensePolynomial(TFr.add(lo, TFr.mul(r, TFr.sub(hi, lo))))

    def bound(self, l_vec: torch.Tensor) -> torch.Tensor:
        """L-fold for Hyrax: view Z as an [L, R] matrix, return L @ Z ([R, W])."""
        return _bound_fold(self.z, l_vec)

    def evaluate_device(self, r_list) -> torch.Tensor:
        """Z(r) as a [W] scalar on the polynomial's device."""
        chis = eq_evals_device(r_list, self.device)
        assert chis.shape[0] == len(self)
        return TFr.sum(TFr.mul(self.z, chis))

    def evaluate(self, r_ints: list[int]) -> int:
        """Z(r) as a host int (r given as host field ints)."""
        rs = [TFr.encode_scalar(x, self.device) for x in r_ints]
        return TFr.decode(self.evaluate_device(rs)[None])[0]

    def to_ints(self) -> list[int]:
        return TFr.decode(self.z)

    def __getitem__(self, i: int) -> int:
        return TFr.decode(self.z[i][None])[0]


# ---------------------------------------------------------------------------
# host-side helpers for tiny polynomials (n-to-1 reductions over <=32 values)
# ---------------------------------------------------------------------------

def bound_var_bot_host(vals: list[int], r: int) -> list[int]:
    return [(vals[2 * i] + r * (vals[2 * i + 1] - vals[2 * i])) % Fr.p
            for i in range(len(vals) // 2)]


def evaluate_host(vals: list[int], r: list[int]) -> int:
    """MLE evaluation with host ints (verifier-side tiny cases)."""
    assert len(vals) == 1 << len(r)
    chis = eq_evals_host(r)
    return sum(v * c for v, c in zip(vals, chis)) % Fr.p


def eq_evals_host(r: list[int]) -> list[int]:
    evals = [1]
    for rj in r:
        nxt = []
        for e in evals:
            t = e * rj % Fr.p
            nxt.append((e - t) % Fr.p)
            nxt.append(t)
        evals = nxt
    return evals


def eq_evaluate_host(r: list[int], rx: list[int]) -> int:
    """eq(r, rx) (reference: src/poly/eq_poly.rs:14-19)."""
    assert len(r) == len(rx)
    acc = 1
    for a, b in zip(r, rx):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % Fr.p) % Fr.p
    return acc


def factored_lens(ell: int) -> tuple[int, int]:
    return ell // 2, ell - ell // 2
