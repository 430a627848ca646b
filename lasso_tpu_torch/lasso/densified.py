"""Densified representation of the sparse lookup polynomial (port of
lasso/densified.py; reference: src/lasso/densified.rs).

The read/final timestamp counters come from a sort + rank formulation
(read_ts[j] = number of earlier ops touching the same address):

  order      = stable sort of the addresses
  run starts = positions where the sorted address changes
  rank       = index - cummax(run-start index)     (occurrence number)
  read_ts    = rank scattered back through `order`
  final_ts   = (last rank + 1) scattered to the address
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lasso_tpu_torch.field.tfield import TFr, resolve_device
from lasso_tpu_torch.poly.dense import DensePolynomial
from lasso_tpu_torch.poly.hyrax import PolyCommitment, commit_poly
from lasso_tpu_torch.utils.tracing import instrument


def _timestamps(addrs, m: int):
    """addrs: [s] int64. Returns (read_ts [s], final_ts [m]) as int64."""
    s = addrs.shape[0]
    sorted_addrs, order = torch.sort(addrs, stable=True)
    idx = torch.arange(s, device=addrs.device)
    is_start = torch.ones(s, dtype=torch.bool, device=addrs.device)
    is_start[1:] = sorted_addrs[1:] != sorted_addrs[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - start_idx
    read_ts = torch.zeros(s, dtype=torch.int64, device=addrs.device)
    read_ts[order] = rank

    is_end = torch.ones(s, dtype=torch.bool, device=addrs.device)
    is_end[:-1] = sorted_addrs[1:] != sorted_addrs[:-1]
    # (last rank + 1) at each touched address; untouched addresses stay 0
    final_ts = torch.zeros(m, dtype=torch.int64, device=addrs.device)
    final_ts[sorted_addrs[is_end]] = rank[is_end] + 1
    return read_ts, final_ts


@dataclass
class SparsePolynomialCommitment:
    l_variate_polys_commitment: PolyCommitment
    log_m_variate_polys_commitment: PolyCommitment
    s: int
    log_m: int
    m: int

    def append_to_transcript(self, label: bytes, transcript) -> None:
        self.l_variate_polys_commitment.append_to_transcript(
            b"l_variate_polys_commitment", transcript)
        self.log_m_variate_polys_commitment.append_to_transcript(
            b"log_m_variate_polys_commitment", transcript)
        transcript.append_u64(b"s", self.s)
        transcript.append_u64(b"log_m", self.log_m)
        transcript.append_u64(b"m", self.m)


def _merged_flat(rows: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate counter rows, zero-padded to the next power of two."""
    flat = torch.cat(rows)
    total = flat.shape[0]
    pow2 = 1 << (total - 1).bit_length()
    return torch.nn.functional.pad(flat, (0, pow2 - total))


class DensifiedRepresentation:
    """dim/read/final counter polynomials + merged commitments."""

    @instrument("Densify", sync=True)
    def __init__(self, indices, log_m: int, c: int, device="cuda"):
        """indices: [s_raw][C] lookup indices (host ints or numpy)."""
        device = resolve_device(device)
        arr = np.asarray(indices, dtype=np.int64)
        assert arr.ndim == 2 and arr.shape[1] == c
        s_raw = arr.shape[0]
        s = 1 << max((s_raw - 1).bit_length(), 0)
        m = 1 << log_m
        assert int(arr.max(initial=0)) < m

        # pad with address-0 accesses, as the reference does (densified.rs:37)
        padded = np.zeros((s, c), dtype=np.int64)
        padded[:s_raw] = arr
        self.c = c
        self.s = s
        self.log_m = log_m
        self.m = m
        self.device = device

        self.dim_usize = torch.as_tensor(padded.T.copy(), device=device)  # [C, s]
        read_list, final_list = [], []
        for i in range(c):
            read_ts, final_ts = _timestamps(self.dim_usize[i], m)
            read_list.append(read_ts)
            final_list.append(final_ts)

        # one encode per merged polynomial; the per-dimension polys are
        # slice views (properties below).  Counters are < 2^63, so their
        # int64 bits are the uint64 values the encoder packs.
        dims = [self.dim_usize[i] for i in range(c)]
        self.combined_l_variate_polys = DensePolynomial(self._encode(
            _merged_flat(dims + read_list)))
        self.combined_log_m_variate_polys = DensePolynomial(self._encode(
            _merged_flat(final_list)))

    def _encode(self, vals: torch.Tensor) -> torch.Tensor:
        """Non-negative int64 counters -> Montgomery Fr limbs on device."""
        limbs = torch.stack([(vals >> (16 * j)) & 0xFFFF for j in range(4)],
                            dim=-1).to(torch.int32)
        limbs = torch.nn.functional.pad(limbs, (0, 12))
        return TFr.mul(limbs, TFr.consts(vals.device).r2)

    @property
    def dim(self) -> list[DensePolynomial]:
        z = self.combined_l_variate_polys.z
        return [DensePolynomial(z[i * self.s: (i + 1) * self.s])
                for i in range(self.c)]

    @property
    def read(self) -> list[DensePolynomial]:
        z = self.combined_l_variate_polys.z
        return [DensePolynomial(z[(self.c + i) * self.s: (self.c + i + 1) * self.s])
                for i in range(self.c)]

    @property
    def final(self) -> list[DensePolynomial]:
        z = self.combined_log_m_variate_polys.z
        return [DensePolynomial(z[i * self.m: (i + 1) * self.m])
                for i in range(self.c)]

    @instrument("DensifiedRepresentation.commit")
    def commit(self, gens) -> SparsePolynomialCommitment:
        l_comm, _ = commit_poly(
            self.combined_l_variate_polys, gens.gens_combined_l_variate)
        m_comm, _ = commit_poly(
            self.combined_log_m_variate_polys, gens.gens_combined_log_m_variate)
        return SparsePolynomialCommitment(
            l_variate_polys_commitment=l_comm,
            log_m_variate_polys_commitment=m_comm,
            s=self.s, log_m=self.log_m, m=self.m)
