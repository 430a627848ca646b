"""Bulletproofs-style inner-product reduction (port of
subprotocols/bullet.py; reference: src/subprotocols/bullet.rs).

With the host transcript: while the half-length is above MSM_HOST_MAX,
each round issues two device MSMs (L and R) and folds the scalar vectors
with field ops and the basis with a batched double-and-add
(`_fold_points`); the small tail rounds run on the host, the basis fold on
the native core.

With the transcript on the device, `_device_dppl` runs a whole
DotProductProofLog -- the Cx commitment, every absorb and challenge, all
Bullet rounds and the closing sigma protocol -- on the device, and one
download carries every proof component and the final strobe state:
  * the basis fold is carried on the scalars ("delayed fold"): original
    basis G_j sits at position j mod m of round k's folded basis with
    weight w_j, the product over earlier rounds of u (where j is in the
    upper half there) or u^-1, so L_k = MSM(G, s) with
    s_j = w_j * a_lo[(j mod m) - m/2] for j in the upper half, and R_k
    likewise: no point is ever folded;
  * every MSM runs over pre-doubled window bases of G ++ q ++ h
    (ops/msm._msm_kernel_flat), and each round's L and R are one MSM
    with a batch of 2;
  * delta = g_hat*d + h*r_delta becomes one MSM over the same bases with
    scalars (d*w, 0, r_delta).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lasso_tpu_torch import native
from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.curve.tcurve import (affine_int_limbs_device,
                                          compress_affine_bytes_device,
                                          from_host_points, identity, padd,
                                          pdbl, to_host_point, to_host_points)
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, W
from lasso_tpu_torch.ops import msm as _msm
from lasso_tpu_torch.transcript.device_strobe import _post_challenge_meta
from lasso_tpu_torch.utils.errors import InputTooLarge, InvalidInputLength
from lasso_tpu_torch.utils.tracing import span


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


def _flat_msm_affine(pd_bases, scalars_mont, c_w: int, n_w: int):
    """MSMs of [..., n+2, W] Montgomery scalars over the pre-doubled bases
    -> canonical affine int limbs (xa, ya) [B, W] and compressed bytes
    [B, 32] of the B = prod(...) results."""
    pts = _msm._msm_kernel_flat(pd_bases, TFr.to_int_limbs(scalars_mont),
                               c_w, n_w)  # [..., 4, W, 1]
    pts = pts.reshape(-1, 4, W).movedim(0, -1)  # [4, W, B]
    xa, ya = affine_int_limbs_device(pts)
    return xa, ya, compress_affine_bytes_device(xa, ya)


def _device_dppl(dt, x0, b0, pd_bases, cy_bytes, beta_bytes, blind_x,
                 blinds_l, blinds_r, d_mont, r_delta_mont, r_beta_mont,
                 blind_gamma, num_rounds: int, c_w: int, n_w: int):
    """DotProductProofLog on the device, with the transcript `dt` there;
    no host sync.

    x0 (secret), b0 (public): [n, W] Montgomery, n = 2^num_rounds;
    pd_bases: [4, W, n_w * (n+2)] pre-doubled window bases of G ++ q ++ h
    under the window plan (c_w, n_w); cy_bytes, beta_bytes: [32] bytes of
    the host-known points; blind_x, blind_gamma, d, r_delta, r_beta: [W]
    Montgomery; blinds_l, blinds_r: [>= num_rounds, W] Montgomery.

    Returns limbs [2 * (2 * num_rounds + 2) + 2, W]: the canonical affine x
    then y coordinates of [Cx, L_0..L_{k-1}, R_0..R_{k-1}, delta], then
    z1, z2 as canonical integer limbs."""
    n = x0.shape[0]
    assert n == 1 << num_rounds
    assert pd_bases.shape[-1] == n_w * (n + 2)
    device = x0.device
    zero = torch.zeros((1, W), dtype=torch.int32, device=device)

    # Cx = <x, G> + blind_x * h (the q slot gets a zero scalar)
    cx_xa, cx_ya, cx_bytes = _flat_msm_affine(
        pd_bases, torch.cat([x0, zero, blind_x[None]]), c_w, n_w)
    dt.append_point_bytes(b"Cx", cx_bytes[0])
    dt.append_point_bytes(b"Cy", cy_bytes)
    dt.append_scalars(b"a", b0)

    idx = torch.arange(n, device=device)
    a, b = x0, b0
    w = TFr.ones(n, device)
    bf = blind_gamma  # the blinds' running sum
    lr_xa, lr_ya = [], []
    for k in range(num_rounds):
        with span("Bullet.round"):
            m = n >> k
            half = m >> 1
            a_lo, a_hi, b_lo, b_hi = a[:half], a[half:], b[:half], b[half:]
            c_lr = TFr.finish_sum(TFr.sum_columns(TFr.mul(
                torch.stack([a_lo, a_hi], dim=1),
                torch.stack([b_hi, b_lo], dim=1))))  # [2, W]: <a_lo,b_hi>, <a_hi,b_lo>

            # the delayed fold: basis j sits at position pj of this round's
            # folded basis, in its upper half where hi
            pj = idx & (m - 1)
            hi = pj >= half
            s_l = torch.where(hi[:, None], TFr.mul(w, a_lo[torch.where(
                hi, pj - half, 0)]), 0)
            s_r = torch.where(hi[:, None], 0, TFr.mul(w, a_hi[torch.where(
                hi, 0, pj)]))
            scalars = torch.stack([
                torch.cat([s_l, c_lr[:1], blinds_l[k][None]]),
                torch.cat([s_r, c_lr[1:], blinds_r[k][None]])])  # [2, n+2, W]
            xa, ya, lr_bytes = _flat_msm_affine(pd_bases, scalars, c_w, n_w)
            lr_xa.append(xa)
            lr_ya.append(ya)

            dt.append_point_bytes(b"L", lr_bytes[0])
            dt.append_point_bytes(b"R", lr_bytes[1])
            u = dt.challenge_scalar(b"u")
            assert dt.meta() == _post_challenge_meta(), \
                "bullet round exit not canonical"
            with span("Bullet.inv_device"):
                u_inv = TFr.inv_device(u)
            uu = TFr.mul(torch.stack([u, u_inv]), torch.stack([u, u_inv]))

            a = TFr.add(TFr.mul(a_lo, u), TFr.mul(a_hi, u_inv))
            b = TFr.add(TFr.mul(b_lo, u_inv), TFr.mul(b_hi, u))
            w = TFr.mul(w, torch.where(hi[:, None], u, u_inv))
            # blind_fin += blind_l * u^2 + blind_r * u^-2
            blr = TFr.mul(torch.stack([blinds_l[k], blinds_r[k]]), uu)
            bf = TFr.add(bf, TFr.add(blr[0], blr[1]))

    # delta = g_hat*d + h*r_delta with g_hat = MSM(G, w): one MSM over
    # (G ++ q ++ h) with scalars (d*w, 0, r_delta)
    d_xa, d_ya, d_bytes = _flat_msm_affine(
        pd_bases, torch.cat([TFr.mul(w, d_mont), zero, r_delta_mont[None]]),
        c_w, n_w)
    dt.append_point_bytes(b"delta", d_bytes[0])
    dt.append_point_bytes(b"beta", beta_bytes)
    c = dt.challenge_scalar(b"c")

    x_hat, a_hat = a[0], b[0]
    z1 = TFr.add(d_mont, TFr.mul(c, TFr.mul(x_hat, a_hat)))
    z2 = TFr.add(TFr.mul(a_hat, TFr.add(TFr.mul(c, bf), r_beta_mont)),
                 r_delta_mont)
    xs = [cx_xa] + [v[:1] for v in lr_xa] + [v[1:] for v in lr_xa] + [d_xa]
    ys = [cx_ya] + [v[:1] for v in lr_ya] + [v[1:] for v in lr_ya] + [d_ya]
    return torch.cat(xs + ys + [TFr.to_int_limbs(torch.stack([z1, z2]))])


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
