"""Batched resolution of the opening proofs' final Sigma-protocol checks
(port of poly/deferred.py).

Every Hyrax opening verify ends in ONE equality that is affine in values the
Fiat-Shamir transcript never sees: the bullet basis combination
g_hat = <G, s> and a handful of proof points with transcript-derived
coefficients.  The challenge stream is closed when these MSMs run, so the
verifier draws a uniformly random weight w_k per check and tests

    sum_k  w_k * (lhs_k - rhs_k)  ==  identity

with a single multi-scalar multiplication (standard batch verification; a
cheat in any single check survives with probability <= 2^-128 over the
weights).  The per-check relations match the reference's sequential checks
(reference: src/nizk/mod.rs DotProductProofLog::verify, src/nizk/bullet.rs
BulletReductionProof::verification_scalars).

Segments over the same generator basis are merged scalar-wise, so the
device MSM is at most one segment per distinct basis.
"""

from __future__ import annotations

import secrets

import torch

from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.utils.errors import LassoError


class DeferredOpeningChecks:
    """Accumulates weighted affine point relations; resolve() checks the
    random linear combination with one (batched) MSM on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._first = True
        self._host_pts: list[hostcurve.Point] = []
        self._host_sc: list[int] = []
        # keyed by (id(gens), n): merged scalar list over gens.G[:n]
        self._segments: dict[tuple[int, int], tuple[object, int, list[int]]] = {}
        self._n_checks = 0

    def weight(self) -> int:
        """Fresh random weight for one check (1 for the first: a single
        check needs no randomization)."""
        self._n_checks += 1
        if self._first:
            self._first = False
            return 1
        return secrets.randbits(128) | 1

    def add_terms(self, points: list[hostcurve.Point], scalars: list[int]):
        """Queue host-point terms sum_i scalars_i * points_i (weights must
        already be folded into `scalars` by the caller)."""
        assert len(points) == len(scalars)
        self._host_pts.extend(points)
        self._host_sc.extend(s % Fr.p for s in scalars)

    def add_gens_msm(self, gens, n: int, scalars: list[int], coeff: int):
        """Queue coeff * <gens.G[:n], scalars>.  Segments sharing the same
        basis object and extent are merged elementwise."""
        assert len(scalars) == n and len(gens.G) >= n
        coeff %= Fr.p
        key = (id(gens), n)
        seg = self._segments.get(key)
        if seg is None:
            self._segments[key] = (
                gens, n, [coeff * s % Fr.p for s in scalars])
        else:
            merged = seg[2]
            for i, s in enumerate(scalars):
                merged[i] = (merged[i] + coeff * s) % Fr.p

    def resolve(self) -> None:
        """Run the single batched check; raises LassoError on failure.

        Basis segments above MSM_HOST_MAX fuse into ONE device MSM over the
        cached generator tensors; small segments and the proof-point terms
        run on the native host Pippenger."""
        if not self._n_checks:
            return
        from lasso_tpu_torch.ops import msm as _msm

        host_pts = list(self._host_pts)
        host_sc = list(self._host_sc)
        device_segs = []
        for gens, n, scalars in self._segments.values():
            if n <= _msm.MSM_HOST_MAX:
                host_pts.extend(gens.G[:n])
                host_sc.extend(scalars)
            else:
                device_segs.append((gens, n, scalars))

        total = hostcurve.msm_host(host_pts, host_sc) if host_pts \
            else hostcurve.Point.identity()

        if device_segs:
            from lasso_tpu_torch.curve.tcurve import to_host_point
            from lasso_tpu_torch.field.tfield import TFr
            from lasso_tpu_torch.subprotocols.dot_product import _gens_device

            bases = torch.cat(
                [_gens_device(g, self.device)[..., :n]
                 for g, n, _ in device_segs], dim=-1)
            flat: list[int] = []
            for _, _, scalars in device_segs:
                flat.extend(scalars)
            dev = to_host_point(_msm.msm_device(
                bases, TFr.encode_ints(flat, self.device), full_width=True))
            total = total.add(dev)

        if not total.is_identity():
            raise LassoError(
                "batched opening verification failed "
                f"({self._n_checks} checks combined)")
