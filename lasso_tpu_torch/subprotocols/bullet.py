"""Bulletproofs-style inner-product reduction (port of
subprotocols/bullet.py; reference: src/subprotocols/bullet.rs).

While the half-length is above MSM_HOST_MAX, each round issues two device
MSMs (L and R) and folds the scalar vectors with field ops and the basis
with a batched double-and-add (`_fold_points`); the small tail rounds run
on the host, the basis fold on the native core.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch import native
from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.curve.tcurve import (from_host_points, identity, padd,
                                          pdbl, to_host_point, to_host_points)
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr
from lasso_tpu_torch.ops import msm as _msm
from lasso_tpu_torch.utils.errors import InputTooLarge, InvalidInputLength


def scalar_mul_batch(points, scalar: int):
    """All points [..., 4, W, n] times one host scalar, by a 256-step
    double-and-add over its bits (LSB first)."""
    acc = identity(points.shape[-1], points.shape[:-3], points.device)
    base = points
    for j in range(256):
        if (scalar >> j) & 1:
            acc = padd(acc, base)
        base = pdbl(base)
    return acc


def _fold_points(g_lo, g_hi, u_inv: int, u: int):
    return padd(scalar_mul_batch(g_lo, u_inv), scalar_mul_batch(g_hi, u))


def _dot(a, b):
    return TFr.sum(TFr.mul(a, b))


@dataclass
class BulletReductionProof:
    L_vec: list[hostcurve.Point]
    R_vec: list[hostcurve.Point]

    @staticmethod
    def prove(transcript, q_point: hostcurve.Point, g_dev, h_point: hostcurve.Point,
              a_vec, b_vec, blind: int, blinds_vec: list[tuple[int, int]]):
        """a_vec, b_vec: [n, W] Fr tensors; g_dev: [4, W, n] bases.

        Returns (proof, Gamma_hat, a_final, b_final, g_final (host Point),
        blind_fin)."""
        n = a_vec.shape[0]
        assert n & (n - 1) == 0
        lg_n = (n - 1).bit_length()
        assert len(blinds_vec) == 2 * lg_n
        device = a_vec.device

        qh_dev = from_host_points([q_point, h_point], device)
        l_points: list[hostcurve.Point] = []
        r_points: list[hostcurve.Point] = []
        blind_fin = blind % Fr.p
        a, b, g = a_vec, b_vec, g_dev
        blinds_iter = iter(blinds_vec)

        # small tail rounds run entirely on host: they are latency bound
        host_mode = False

        while n != 1:
            n //= 2
            if not host_mode and n <= _msm.MSM_HOST_MAX:
                host_mode = True
                a = TFr.decode(a)
                b = TFr.decode(b)
                g = to_host_points(g)

            blind_l, blind_r = next(blinds_iter)
            if host_mode:
                a_lo, a_hi = a[:n], a[n:]
                b_lo, b_hi = b[:n], b[n:]
                g_lo, g_hi = g[:n], g[n:]
                c_l = sum(x * y for x, y in zip(a_lo, b_hi)) % Fr.p
                c_r = sum(x * y for x, y in zip(a_hi, b_lo)) % Fr.p
                l_pt = hostcurve.msm_host(
                    g_hi + [q_point, h_point], a_lo + [c_l, blind_l])
                r_pt = hostcurve.msm_host(
                    g_lo + [q_point, h_point], a_hi + [c_r, blind_r])
            else:
                a_lo, a_hi = a[:n], a[n:]
                b_lo, b_hi = b[:n], b[n:]
                g_lo, g_hi = g[..., :n], g[..., n:]
                c_l = TFr.decode(_dot(a_lo, b_hi)[None])[0]
                c_r = TFr.decode(_dot(a_hi, b_lo)[None])[0]
                l_scalars = torch.cat(
                    [a_lo, TFr.encode_ints([c_l, blind_l], device)], dim=0)
                l_bases = torch.cat([g_hi, qh_dev], dim=-1)
                l_pt = to_host_point(_msm.msm_device(l_bases, l_scalars,
                                                     full_width=True))
                r_scalars = torch.cat(
                    [a_hi, TFr.encode_ints([c_r, blind_r], device)], dim=0)
                r_bases = torch.cat([g_lo, qh_dev], dim=-1)
                r_pt = to_host_point(_msm.msm_device(r_bases, r_scalars,
                                                     full_width=True))

            transcript.append_point(b"L", l_pt)
            transcript.append_point(b"R", r_pt)
            u = transcript.challenge_scalar(b"u")
            u_inv = Fr.inv(u)

            if host_mode:
                a = [(x * u + y * u_inv) % Fr.p for x, y in zip(a_lo, a_hi)]
                b = [(x * u_inv + y * u) % Fr.p for x, y in zip(b_lo, b_hi)]
                g = native.fold_points(g_lo + g_hi, u, u_inv)
            else:
                u_dev = TFr.encode_scalar(u, device)
                u_inv_dev = TFr.encode_scalar(u_inv, device)
                a = TFr.add(TFr.mul(a_lo, u_dev), TFr.mul(a_hi, u_inv_dev))
                b = TFr.add(TFr.mul(b_lo, u_inv_dev), TFr.mul(b_hi, u_dev))
                g = _fold_points(g_lo, g_hi, u_inv, u)

            blind_fin = (blind_fin + blind_l * u * u + blind_r * u_inv * u_inv) % Fr.p
            l_points.append(l_pt)
            r_points.append(r_pt)

        if host_mode:
            a_fin, b_fin, g_fin = a[0], b[0], g[0]
        else:
            a_fin = TFr.decode(a)[0]
            b_fin = TFr.decode(b)[0]
            g_fin = to_host_point(g[..., :1])
        gamma_hat = g_fin.mul(a_fin).add(
            q_point.mul(a_fin * b_fin % Fr.p)).add(h_point.mul(blind_fin))

        return (BulletReductionProof(l_points, r_points),
                gamma_hat, a_fin, b_fin, g_fin, blind_fin)

    def verification_scalars(self, n: int, transcript):
        """(u_sq, u_inv_sq, s) for the combined verification MSM."""
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise InputTooLarge("bullet proof too large")
        if n != (1 << lg_n):
            raise InvalidInputLength(1 << lg_n, n)

        challenges = []
        for l_pt, r_pt in zip(self.L_vec, self.R_vec):
            transcript.append_point(b"L", l_pt)
            transcript.append_point(b"R", r_pt)
            challenges.append(transcript.challenge_scalar(b"u"))

        challenges_inv = Fr.batch_inv(challenges)
        all_inv = 1
        for c in challenges_inv:
            all_inv = all_inv * c % Fr.p

        u_sq = [c * c % Fr.p for c in challenges]
        u_inv_sq = [c * c % Fr.p for c in challenges_inv]

        s = [all_inv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            u_lg_i_sq = u_sq[(lg_n - 1) - lg_i]
            s.append(s[i - k] * u_lg_i_sq % Fr.p)

        return u_sq, u_inv_sq, s

    def verify(self, n: int, a: list[int], transcript, gamma: hostcurve.Point,
               g_host: list[hostcurve.Point], device, gens_n=None):
        """Returns (g_hat, gamma_hat, a_hat).  g_host: basis points (host);
        gens_n: the MultiCommitGens they came from, whose cached device
        bases serve the device MSM when n is above MSM_HOST_MAX."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)

        if n <= _msm.MSM_HOST_MAX:
            g_hat = hostcurve.msm_host(g_host, s)
        else:
            if gens_n is not None and len(gens_n.G) >= n:
                from lasso_tpu_torch.subprotocols.dot_product import _gens_device
                bases = _gens_device(gens_n, device)[..., :n]
            else:
                bases = from_host_points(g_host, device)
            g_hat = to_host_point(_msm.msm_device(
                bases, TFr.encode_ints(s, device), full_width=True))
        a_hat = sum(x * y for x, y in zip(a, s)) % Fr.p

        gamma_hat = hostcurve.msm_host(
            self.L_vec + self.R_vec + [gamma], u_sq + u_inv_sq + [1])
        return g_hat, gamma_hat, a_hat
