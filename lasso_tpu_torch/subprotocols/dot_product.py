"""Sigma-protocol dot-product proofs (port of subprotocols/dot_product.py;
reference: src/subprotocols/dot_product.rs).

`DotProductProof` is the linear-size variant; `DotProductProofLog` wraps the
bullet reduction for log-size proofs.  Vector math runs on the proof's
device; the few per-proof scalar commitments are host group ops.  With the
transcript on the device, `DotProductProofLog` runs as one device program
(bullet._device_dppl) over cached pre-doubled bases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lasso_tpu_torch.curve import host as hostcurve
from lasso_tpu_torch.curve.tcurve import from_host_points, to_host_point
from lasso_tpu_torch.field.host import Fr
from lasso_tpu_torch.field.tfield import TFr, unpack_ints, upload
from lasso_tpu_torch.ops import msm as _msm
from lasso_tpu_torch.poly.commitments import MultiCommitGens, commit_scalar
from lasso_tpu_torch.subprotocols.bullet import (BulletReductionProof,
                                                 _device_dppl)
from lasso_tpu_torch.subprotocols.sumcheck import _device_sumcheck_supported
from lasso_tpu_torch.transcript.device_strobe import DeviceTranscript
from lasso_tpu_torch.utils.errors import InvalidInputLength, LassoError
from lasso_tpu_torch.utils.tracing import instrument, span


def _gens_device(gens: MultiCommitGens, device) -> torch.Tensor:
    """Bases [4, W, n+1] (generators + h) on `device`, cached on the gens."""
    device = torch.device(device)
    cache = gens.__dict__.setdefault("_device_cache", {})
    dev = cache.get(device)
    if dev is None or dev.shape[-1] != gens.n + 1:
        dev = from_host_points(gens.G + [gens.h], device)
        cache[device] = dev
    return dev


def _predoubled_gens(gens: "DotProductProofGens", device):
    """Pre-doubled window bases of G ++ q ++ h (ops/msm.predoubled_windows)
    for the fused opening proof, once per gens and device.

    Returns (pd_bases [4, W, n_w * (n+2)], c_w, n_w)."""
    device = torch.device(device)
    cache = gens.__dict__.setdefault("_pd_cache", {})
    got = cache.get(device)
    if got is None:
        g_dev = _gens_device(gens.gens_n, device)  # G ++ h
        bases = torch.cat([g_dev[..., : gens.n],
                           from_host_points([gens.gens_1.G[0]], device),
                           g_dev[..., gens.n:]], dim=-1)
        c_w, n_w = _msm.FLAT_WINDOW_PLAN
        got = (_msm.predoubled_windows(bases, c_w, n_w), c_w, n_w)
        cache[device] = got
    return got


def batch_commit(values_dev, blind: int, gens: MultiCommitGens,
                 full_width: bool = False) -> hostcurve.Point:
    """MSM commitment <values, G> + blind * h (values: [n, W] Fr tensor)."""
    n = values_dev.shape[0]
    assert gens.n == n, f"gens size {gens.n} != {n}"
    device = values_dev.device
    pts = _gens_device(gens, device)
    scalars = torch.cat([values_dev, TFr.encode_ints([blind], device)], dim=0)
    return to_host_point(_msm.msm_device(pts, scalars, full_width=full_width))


@dataclass
class DotProductProofGens:
    n: int
    gens_n: MultiCommitGens
    gens_1: MultiCommitGens

    @staticmethod
    def new(n: int, label: bytes) -> "DotProductProofGens":
        """The generators for (n, label), one object per pair, like
        MultiCommitGens.new: the device bases and the pre-doubled windows
        cached on it serve every proof over the same generators."""
        key = (n, bytes(label))
        got = _DPP_GENS_CACHE.get(key)
        if got is None:
            gens_n, gens_1 = MultiCommitGens.new(n + 1, label).split_at(n)
            got = DotProductProofGens(n, gens_n, gens_1)
            _DPP_GENS_CACHE[key] = got
        return got


# one DotProductProofGens per (n, label) for the life of the process, as
# poly/commitments.py keeps its MultiCommitGens: nothing clears it, and a
# prover holds one entry per opening size it uses (a handful).  Each entry
# keeps its device bases and pre-doubled windows, 37 * (n + 2) points
# (256 bytes each) per device it was used on.
_DPP_GENS_CACHE: dict[tuple[int, bytes], DotProductProofGens] = {}


@dataclass
class DotProductProof:
    delta: hostcurve.Point
    beta: hostcurve.Point
    z: list[int]
    z_delta: int
    z_beta: int

    PROTOCOL_NAME = b"dot product proof"

    @staticmethod
    def prove(gens_1, gens_n, transcript, random_tape,
              x_vec: list[int], blind_x: int, a_vec: list[int], y: int,
              blind_y: int, device):
        transcript.append_protocol_name(DotProductProof.PROTOCOL_NAME)
        n = len(x_vec)
        assert n == len(a_vec) and gens_n.n == n and gens_1.n == 1

        d_vec = random_tape.random_vector(b"d_vec", n)
        r_delta = random_tape.random_scalar(b"r_delta")
        r_beta = random_tape.random_scalar(b"r_beta")

        cx = batch_commit(TFr.encode_ints(x_vec, device), blind_x, gens_n)
        transcript.append_point(b"Cx", cx)
        cy = commit_scalar(y, blind_y, gens_1)
        transcript.append_point(b"Cy", cy)
        transcript.append_scalars(b"a", a_vec)

        delta = batch_commit(TFr.encode_ints(d_vec, device), r_delta, gens_n)
        transcript.append_point(b"delta", delta)

        dot_a_d = sum(a * d for a, d in zip(a_vec, d_vec)) % Fr.p
        beta = commit_scalar(dot_a_d, r_beta, gens_1)
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")

        z = [(c * x + d) % Fr.p for x, d in zip(x_vec, d_vec)]
        z_delta = (c * blind_x + r_delta) % Fr.p
        z_beta = (c * blind_y + r_beta) % Fr.p
        return DotProductProof(delta, beta, z, z_delta, z_beta), cx, cy

    def verify(self, gens_1, gens_n, transcript, a: list[int],
               cx: hostcurve.Point, cy: hostcurve.Point, device) -> None:
        if len(a) != gens_n.n:
            raise InvalidInputLength(gens_n.n, len(a))
        if gens_1.n != 1:
            raise InvalidInputLength(1, gens_1.n)

        transcript.append_protocol_name(DotProductProof.PROTOCOL_NAME)
        transcript.append_point(b"Cx", cx)
        transcript.append_point(b"Cy", cy)
        transcript.append_scalars(b"a", a)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)

        c = transcript.challenge_scalar(b"c")

        lhs1 = cx.mul(c).add(self.delta)
        if gens_n.n + 1 <= _msm.MSM_HOST_MAX:
            rhs1 = hostcurve.msm_host(
                gens_n.G + [gens_n.h], list(self.z) + [self.z_delta])
        else:
            rhs1 = batch_commit(TFr.encode_ints(self.z, device), self.z_delta,
                                gens_n)
        ok = lhs1 == rhs1

        dot_z_a = sum(zi * ai for zi, ai in zip(self.z, a)) % Fr.p
        lhs2 = cy.mul(c).add(self.beta)
        rhs2 = commit_scalar(dot_z_a, self.z_beta, gens_1)
        ok = ok and lhs2 == rhs2
        if not ok:
            raise LassoError("dot product proof rejected")


@dataclass
class DotProductProofLog:
    bullet_reduction_proof: BulletReductionProof
    delta: hostcurve.Point
    beta: hostcurve.Point
    z1: int
    z2: int

    PROTOCOL_NAME = b"dot product proof (log)"

    @staticmethod
    def _prove_fused(gens: DotProductProofGens, transcript, random_tape,
                     x_dev, blind_x: int, a_dev, y: int, blind_y: int):
        """The whole protocol (Cx, absorbs, Bullet rounds, delta, c, z1,
        z2) in bullet._device_dppl with the transcript on the device; one
        download carries every proof component and the strobe state."""
        device = x_dev.device
        n = x_dev.shape[0]
        lg_n = (n - 1).bit_length()

        d = random_tape.random_scalar(b"d")
        r_delta = random_tape.random_scalar(b"r_delta")
        r_beta = random_tape.random_scalar(b"r_delta")
        v1 = random_tape.random_vector(b"blinds_vec_1", 2 * lg_n)
        v2 = random_tape.random_vector(b"blinds_vec_2", 2 * lg_n)

        cy = commit_scalar(y % Fr.p, blind_y, gens.gens_1)
        beta = commit_scalar(d, r_beta, gens.gens_1)
        cy_beta = upload(np.frombuffer(
            cy.to_compressed_bytes() + beta.to_compressed_bytes(),
            np.uint8).astype(np.int32), device)
        pd_bases, c_w, n_w = _predoubled_gens(gens, device)
        enc = TFr.encode_ints(
            [blind_x, d, r_delta, r_beta, blind_x + blind_y] + v1 + v2,
            device)

        dt = DeviceTranscript.from_host(transcript, device)
        limbs = _device_dppl(
            dt, x_dev, a_dev, pd_bases, cy_beta[:32], cy_beta[32:], enc[0],
            enc[5: 5 + 2 * lg_n], enc[5 + 2 * lg_n:], enc[1], enc[2], enc[3],
            enc[4], lg_n, c_w, n_w)
        vals = unpack_ints(dt.finish(transcript, limbs))

        k = 2 * lg_n + 2
        pts = [hostcurve.Point.from_affine(x, yv)
               for x, yv in zip(vals[:k], vals[k: 2 * k])]
        z1, z2 = vals[2 * k:]
        proof = DotProductProofLog(
            BulletReductionProof(pts[1: 1 + lg_n], pts[1 + lg_n: k - 1]),
            pts[k - 1], beta, z1, z2)
        return proof, pts[0], cy

    @staticmethod
    @instrument("DotProductProofLog.prove", sync=True)
    def prove(gens: DotProductProofGens, transcript, random_tape,
              x_dev, blind_x: int, a_dev, y: int, blind_y: int,
              a_host=None):
        """x_dev, a_dev: [n, W] Fr tensors; a_host optionally carries the
        same `a` as host ints (public vector) to skip a decode.

        Returns (proof, Cx, Cy)."""
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL_NAME)
        n = x_dev.shape[0]
        assert gens.n == n
        lg_n = (n - 1).bit_length()
        if n > 1 and _device_sumcheck_supported(transcript, x_dev.device):
            return DotProductProofLog._prove_fused(
                gens, transcript, random_tape, x_dev, blind_x, a_dev, y,
                blind_y)

        d = random_tape.random_scalar(b"d")
        r_delta = random_tape.random_scalar(b"r_delta")
        # (reference quirk kept: r_beta drawn under the same label "r_delta")
        r_beta = random_tape.random_scalar(b"r_delta")
        v1 = random_tape.random_vector(b"blinds_vec_1", 2 * lg_n)
        v2 = random_tape.random_vector(b"blinds_vec_2", 2 * lg_n)
        blinds_vec = list(zip(v1, v2))

        with span("DPPL.commit_x"):
            cx = batch_commit(x_dev, blind_x, gens.gens_n, full_width=True)
        transcript.append_point(b"Cx", cx)
        y_val = y % Fr.p
        cy = commit_scalar(y_val, blind_y, gens.gens_1)
        transcript.append_point(b"Cy", cy)
        with span("DPPL.append_a"):
            a_ints = a_host if a_host is not None else TFr.decode(a_dev)
            transcript.append_scalars(b"a", a_ints)

        blind_gamma = (blind_x + blind_y) % Fr.p
        g_dev = _gens_device(gens.gens_n, x_dev.device)[..., : gens.n]
        with span("DPPL.bullet"):
            (bullet_proof, _gamma_hat, x_hat, a_hat, g_hat, rhat_gamma) = \
                BulletReductionProof.prove(
                    transcript, gens.gens_1.G[0], g_dev, gens.gens_n.h,
                    x_dev, a_dev, blind_gamma, blinds_vec)

        y_hat = x_hat * a_hat % Fr.p

        delta = g_hat.mul(d).add(gens.gens_1.h.mul(r_delta))
        transcript.append_point(b"delta", delta)
        beta = commit_scalar(d, r_beta, gens.gens_1)
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")

        z1 = (d + c * y_hat) % Fr.p
        z2 = (a_hat * ((c * rhat_gamma + r_beta) % Fr.p) + r_delta) % Fr.p

        return DotProductProofLog(bullet_proof, delta, beta, z1, z2), cx, cy

    def verify(self, n: int, gens: DotProductProofGens, transcript,
               a: list[int], cx: hostcurve.Point, cy: hostcurve.Point,
               device, deferred=None) -> None:
        if gens.n != n:
            raise InvalidInputLength(gens.n, n)
        if len(a) != n:
            raise InvalidInputLength(n, len(a))

        transcript.append_protocol_name(DotProductProofLog.PROTOCOL_NAME)
        transcript.append_point(b"Cx", cx)
        transcript.append_point(b"Cy", cy)
        transcript.append_scalars(b"a", a)

        gamma = cx.add(cy)
        if deferred is None:
            g_hat, gamma_hat, a_hat = self.bullet_reduction_proof.verify(
                n, a, transcript, gamma, gens.gens_n.G[: gens.n], device,
                gens_n=gens.gens_n)

            transcript.append_point(b"delta", self.delta)
            transcript.append_point(b"beta", self.beta)
            c = transcript.challenge_scalar(b"c")

            lhs = gamma_hat.mul(c).add(self.beta).mul(a_hat).add(self.delta)
            rhs = g_hat.add(gens.gens_1.G[0].mul(a_hat)).mul(self.z1).add(
                gens.gens_1.h.mul(self.z2))
            if not lhs == rhs:
                raise LassoError("log dot product proof rejected")
            return

        # Deferred batch path (poly/deferred.py): nothing below this point
        # feeds the transcript except proof data, so the final check
        #   gamma_hat*(c*a_hat) + beta*a_hat + delta
        #     - g_hat*z1 - G1*(a_hat*z1) - h*z2 == 0
        # (gamma_hat expanded as <L,u_sq> + <R,u_inv_sq> + gamma) is queued
        # with a random weight and the g_hat basis MSM left unevaluated.
        p = Fr.p
        u_sq, u_inv_sq, s = self.bullet_reduction_proof.verification_scalars(
            n, transcript)
        a_hat = 0
        for x, y in zip(a, s):
            a_hat += x * y
        a_hat %= p

        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")

        w = deferred.weight()
        ca = c * a_hat % p
        bp = self.bullet_reduction_proof
        pts = (list(bp.L_vec) + list(bp.R_vec)
               + [cx, cy, self.beta, self.delta,
                  gens.gens_1.G[0], gens.gens_1.h])
        sc = ([u * ca % p for u in u_sq]
              + [u * ca % p for u in u_inv_sq]
              + [ca, ca, a_hat, 1,
                 (p - a_hat * self.z1 % p) % p, (p - self.z2 % p) % p])
        deferred.add_terms(pts, [w * x % p for x in sc])
        deferred.add_gens_msm(
            gens.gens_n, n, s, w * (p - self.z1 % p) % p)
