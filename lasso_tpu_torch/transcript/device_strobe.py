"""The merlin/STROBE Fiat-Shamir transcript held on the proof's device (port
of transcript/device_strobe.py).

With the transcript on the host, every sumcheck round, grand-product layer
and Bullet round copies its evaluations to the host and its challenge back.
Here the sponge state stays on the device, byte for byte the host
transcript's, so a whole sumcheck, grand-product argument or opening proof
downloads once, at its end:

  * keccak-f[1600] on a [200]-byte state held as int32: kernel K4
    (csrc/keccak.cu, one warp per state) for a CUDA tensor, the plain
    version `keccak_f1600_plain` (25 (lo, hi) 32-bit lane halves in int64)
    for a CPU tensor;
  * STROBE-128 with the state as a [200] int32 byte tensor.  The sponge's
    control flow (positions, flag bytes, when the permutation runs) depends
    only on byte counts, so it is plain Python bookkeeping; only the values
    of appended scalars and points live on the device.  Consecutive static
    bytes (labels, framing, padding) fold into one constant XOR, whose mask
    is uploaded once and cached.

Scalars in and out are [16] Montgomery limb tensors over Fr.  Every
challenge ends in a PRF whose C flag runs the permutation first, so after
any `challenge_scalar` the sponge is at `_post_challenge_meta()`, whatever
came before: the callers assert that at the end of every round.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.field.tfield import TFr, W, upload
from lasso_tpu_torch.transcript.strobe import (FLAG_A, FLAG_C, FLAG_I, FLAG_K,
                                               FLAG_M, STROBE_R)

# the port's own copies of the reference's keccak tables
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_MASK32 = 0xFFFFFFFF

# rho rotation offsets, indexed [x][y]; flat lane l = x + 5*y
_ROT_XY = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_ROT_FLAT = [_ROT_XY[lane % 5][lane // 5] for lane in range(25)]

# pi: B[y][(2x+3y) % 5] = rot(A[x][y]); dest lane y + 5*((2x+3y) % 5)
# takes source lane x + 5*y
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


class _KeccakConsts:
    """The plain version's tables as int64 tensors on one device."""

    def __init__(self, device):
        def t(vals):
            return torch.tensor(vals, dtype=torch.int64, device=device)

        self.rc_lo = t([rc & _MASK32 for rc in _RC])
        self.rc_hi = t([rc >> 32 for rc in _RC])
        self.swap = t([r >= 32 for r in _ROT_FLAT]).bool()
        self.rot = t([r % 32 for r in _ROT_FLAT])  # 0..31 after the swap
        self.pi = t(_PI_SRC)
        self.byte_shift = t([0, 8, 16, 24])


_KCONSTS: dict[torch.device, _KeccakConsts] = {}


def _kconsts(device) -> _KeccakConsts:
    got = _KCONSTS.get(device)
    if got is None:
        got = _KeccakConsts(device)
        _KCONSTS[device] = got
    return got


def _rot64(lo, hi, k: _KeccakConsts):
    """Rotate the 25 (lo, hi) lanes [..., 25] left by their rho offsets.
    An offset of 32 or more swaps the halves and rotates by the rest; the
    halves are below 2^32, so a right shift by 32 gives 0 and an offset of
    0 needs no case of its own."""
    l1 = torch.where(k.swap, hi, lo)
    h1 = torch.where(k.swap, lo, hi)
    lo_r = ((l1 << k.rot) | (h1 >> (32 - k.rot))) & _MASK32
    hi_r = ((h1 << k.rot) | (l1 >> (32 - k.rot))) & _MASK32
    return lo_r, hi_r


def _roll_x(v, shift: int):
    """v [..., 5 (y), 5 (x)] -> v[..., y, (x + shift) % 5]."""
    return torch.roll(v, -shift, dims=-1)


def keccak_f1600_plain(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] of [..., 200] int32 byte states (little-endian lanes,
    lane l = x + 5*y), in plain PyTorch on 32-bit lane halves held in
    int64.  Returns new states."""
    k = _kconsts(state.device)
    b = state.to(torch.int64).reshape(state.shape[:-1] + (25, 2, 4))
    halves = ((b & 0xFF) << k.byte_shift).sum(-1)  # [..., 25, 2]
    lo, hi = halves[..., 0], halves[..., 1]
    lead = lo.shape[:-1]
    for rnd in range(24):
        a_lo = lo.reshape(lead + (5, 5))  # [y][x]
        a_hi = hi.reshape(lead + (5, 5))
        # theta: c[x] = xor over y; d[x] = c[x-1] ^ rol(c[x+1], 1)
        c_lo = a_lo[..., 0, :] ^ a_lo[..., 1, :] ^ a_lo[..., 2, :] \
            ^ a_lo[..., 3, :] ^ a_lo[..., 4, :]
        c_hi = a_hi[..., 0, :] ^ a_hi[..., 1, :] ^ a_hi[..., 2, :] \
            ^ a_hi[..., 3, :] ^ a_hi[..., 4, :]
        n_lo, n_hi = _roll_x(c_lo, 1), _roll_x(c_hi, 1)
        d_lo = _roll_x(c_lo, -1) ^ (((n_lo << 1) | (n_hi >> 31)) & _MASK32)
        d_hi = _roll_x(c_hi, -1) ^ (((n_hi << 1) | (n_lo >> 31)) & _MASK32)
        lo = (a_lo ^ d_lo[..., None, :]).reshape(lead + (25,))
        hi = (a_hi ^ d_hi[..., None, :]).reshape(lead + (25,))
        # rho, pi
        lo, hi = _rot64(lo, hi, k)
        lo, hi = lo[..., k.pi], hi[..., k.pi]
        # chi: A[x][y] = B[x][y] ^ (~B[x+1][y] & B[x+2][y])
        b_lo = lo.reshape(lead + (5, 5))
        b_hi = hi.reshape(lead + (5, 5))
        lo = (b_lo ^ (~_roll_x(b_lo, 1) & _roll_x(b_lo, 2))).reshape(
            lead + (25,))
        hi = (b_hi ^ (~_roll_x(b_hi, 1) & _roll_x(b_hi, 2))).reshape(
            lead + (25,))
        # iota
        lo = torch.cat([lo[..., :1] ^ k.rc_lo[rnd], lo[..., 1:]], dim=-1)
        hi = torch.cat([hi[..., :1] ^ k.rc_hi[rnd], hi[..., 1:]], dim=-1)
    halves = torch.stack([lo, hi], dim=-1)[..., None]  # [..., 25, 2, 1]
    out = (halves >> k.byte_shift) & 0xFF
    return out.reshape(state.shape).to(torch.int32)


def keccak_f1600_state(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] of [..., 200] int32 byte states: kernel K4 in place
    for a CUDA tensor (it raises if the kernel cannot take the tensor), the
    plain version for a CPU tensor."""
    if state.device.type == "cpu":
        return keccak_f1600_plain(state)
    from lasso_tpu_torch.ops import field_cuda

    return field_cuda.keccak_cuda(state)


def _post_challenge_meta() -> tuple[int, int, int]:
    """(pos, pos_begin, cur_flags) after any challenge: the C-flagged PRF
    runs the permutation (pos and pos_begin back to 0), then its begin-op
    absorbs two bytes and it squeezes 64."""
    return (64, 0, FLAG_I | FLAG_A | FLAG_C)


# static XOR masks, uploaded once per (bytes, device).  A prover's static
# absorbs (labels, lengths, flags) give a few hundred distinct masks; the
# cache empties itself whole at _MASKS_MAX entries, so a process that runs
# many protocols keeps at most that many [200] tensors.
_MASKS: dict[tuple, torch.Tensor] = {}
_MASKS_MAX = 1 << 14


def _mask_tensor(acc: np.ndarray, device) -> torch.Tensor:
    key = (acc.tobytes(), device)
    got = _MASKS.get(key)
    if got is None:
        if len(_MASKS) >= _MASKS_MAX:
            _MASKS.clear()
        got = upload(acc, device)
        _MASKS[key] = got
    return got


class DeviceStrobe:
    """STROBE-128 with a [200] int32 byte state on a device; mirrors
    transcript/strobe.py operation for operation."""

    def __init__(self, state: torch.Tensor, pos: int, pos_begin: int,
                 cur_flags: int):
        self.state = state
        self.pos = pos
        self.pos_begin = pos_begin
        self.cur_flags = cur_flags
        self._static_acc = np.zeros(200, dtype=np.int32)
        self._static_dirty = False

    def meta(self) -> tuple[int, int, int]:
        return (self.pos, self.pos_begin, self.cur_flags)

    # -- static-byte batching ---------------------------------------------------
    def flush(self) -> None:
        if self._static_dirty:
            self.state = self.state ^ _mask_tensor(self._static_acc,
                                                   self.state.device)
            self._static_acc = np.zeros(200, dtype=np.int32)
            self._static_dirty = False

    def _run_f(self) -> None:
        self._static_acc[self.pos] ^= self.pos_begin
        self._static_acc[self.pos + 1] ^= 0x04
        self._static_acc[STROBE_R + 1] ^= 0x80
        self._static_dirty = True
        self.flush()
        self.state = keccak_f1600_state(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb_static(self, data: bytes) -> None:
        for byte in data:
            self._static_acc[self.pos] ^= byte
            self._static_dirty = True
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _absorb_dynamic(self, byte_vec: torch.Tensor) -> None:
        """byte_vec: [k] int32 bytes on the state's device."""
        k = int(byte_vec.shape[0])
        off = 0
        while k > 0:
            take = min(k, STROBE_R - self.pos)
            self.flush()
            self.state[self.pos: self.pos + take] ^= byte_vec[off: off + take]
            self.pos += take
            off += take
            k -= take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> torch.Tensor:
        out = []
        while n > 0:
            take = min(n, STROBE_R - self.pos)
            self.flush()
            out.append(self.state[self.pos: self.pos + take].clone())
            self.state[self.pos: self.pos + take] = 0
            self.pos += take
            n -= take
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(out) if len(out) > 1 else out[0]

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert flags == self.cur_flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb_static(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- merlin subset -------------------------------------------------------------
    def meta_ad_static(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb_static(data)

    def ad_static(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb_static(data)

    def ad_dynamic(self, byte_vec: torch.Tensor, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb_dynamic(byte_vec)

    def prf(self, n: int, more: bool = False) -> torch.Tensor:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


def _u32_le(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def scalar_bytes(scalars_mont: torch.Tensor) -> torch.Tensor:
    """[k, W] Montgomery Fr -> [k, 32] int32 bytes of the canonical values,
    little-endian (one K1 product for all k)."""
    canonical = TFr.to_int_limbs(scalars_mont)
    k = canonical.shape[0]
    return torch.stack([canonical & 0xFF, canonical >> 8], dim=-1).reshape(
        k, 2 * W)


class DeviceTranscript:
    """merlin framing and the Lasso byte conventions on a device; mirrors
    transcript/proof_transcript.ProofTranscript for what the provers'
    device paths use."""

    def __init__(self, strobe: DeviceStrobe):
        self.s = strobe

    @staticmethod
    def from_host(transcript, device) -> "DeviceTranscript":
        """A host ProofTranscript's strobe state, copied onto `device`."""
        st = transcript.t.strobe
        state = upload(np.frombuffer(bytes(st.state), dtype=np.uint8)
                       .astype(np.int32), device)
        return DeviceTranscript(
            DeviceStrobe(state, st.pos, st.pos_begin, st.cur_flags))

    @property
    def state(self) -> torch.Tensor:
        """The [200] byte state with every pending static byte applied."""
        self.s.flush()
        return self.s.state

    def meta(self) -> tuple[int, int, int]:
        return self.s.meta()

    def restore_to_host(self, transcript, state_value) -> None:
        """Write a downloaded state ([200] bytes) and this object's
        bookkeeping back into a host ProofTranscript."""
        st = transcript.t.strobe
        st.state = bytearray(int(x) & 0xFF for x in state_value)
        st.pos, st.pos_begin, st.cur_flags = self.s.meta()

    def finish(self, transcript, limbs: torch.Tensor) -> np.ndarray:
        """The one download of a device-transcript path: `limbs` [k, W] and
        the strobe state in one copy.  Restores the host transcript and
        returns the limbs as a numpy array [k, W]."""
        state = self.state
        flat = torch.cat([limbs.reshape(-1), state]).cpu().numpy()
        self.restore_to_host(transcript, flat[-state.shape[0]:])
        return flat[:-state.shape[0]].reshape(-1, W)

    # -- merlin framing ----------------------------------------------------------
    def append_message_static(self, label: bytes, message: bytes) -> None:
        self.s.meta_ad_static(label, False)
        self.s.meta_ad_static(_u32_le(len(message)), True)
        self.s.ad_static(message, False)

    def append_message_dynamic(self, label: bytes, byte_vec) -> None:
        """Device message bytes ([k] int32) under a static label."""
        self.s.meta_ad_static(label, False)
        self.s.meta_ad_static(_u32_le(int(byte_vec.shape[0])), True)
        self.s.ad_dynamic(byte_vec, False)

    def append_point_bytes(self, label: bytes, compressed32) -> None:
        """The host append_point of a point compressed on the device
        ([32] int32 bytes, curve/tcurve.compress_affine_bytes_device)."""
        self.append_message_dynamic(label, compressed32)

    def append_scalar(self, label: bytes, scalar_mont) -> None:
        """scalar_mont: [W] Montgomery limbs -> its canonical 32 bytes."""
        self.append_message_dynamic(label, scalar_bytes(scalar_mont[None])[0])

    def append_scalar_rows(self, label: bytes, rows32) -> None:
        """One append_scalar per row of [k, 32] scalar bytes."""
        for i in range(rows32.shape[0]):
            self.append_message_dynamic(label, rows32[i])

    def append_scalars(self, label: bytes, scalars_mont) -> None:
        """The host append_scalars framing (begin/end markers, one message
        per scalar) of [k, W] Montgomery scalars."""
        self.append_message_static(label, b"begin_append_vector")
        self.append_scalar_rows(label, scalar_bytes(scalars_mont))
        self.append_message_static(label, b"end_append_vector")

    def challenge_scalar(self, label: bytes) -> torch.Tensor:
        """64-byte PRF reduced mod Fr -> [W] Montgomery limbs."""
        self.s.meta_ad_static(label, False)
        self.s.meta_ad_static(_u32_le(64), True)
        raw = self.s.prf(64)  # [64] bytes, little-endian value
        limbs = (raw[0::2] | (raw[1::2] << 8)).reshape(2, W)  # lo, hi
        # v = lo + hi * 2^256; mont_mul(lo, R^2) = lo * R and
        # mont_mul(hi, R^3) = hi * 2^256 * R, in one K1 launch
        rr = TFr.const(np.stack([TFr.r2_limbs, TFr.r3_limbs]), raw.device)
        enc = TFr.mul(limbs, rr)
        return TFr.add(enc[0], enc[1])
