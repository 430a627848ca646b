"""The card's peaks and the work of a kernel call, counted from the logical
operation at its call boundary, so the count is the same whatever
implements it: each input read once and each output written once, as the
tensor contract holds them (a field element is 16 limbs in int32, 64 B; a
point 4 elements, 256 B), and the 32-bit multiplies the operation needs.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

# published memory rate of an H100 SXM (HBM3; NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer multiplies issue at 64 per clock per SM on compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput); the rate is this times the SM count times the maximum SM
# clock (132 x 64 x 1980 MHz = 16.7e12/s on an H100 SXM)
INT_MUL_PER_CLOCK_PER_SM = 64
ELEMENT_BYTES = 16 * 4
POINT_BYTES = 4 * ELEMENT_BYTES
# 32-bit multiply instructions of one 256-bit Montgomery product (8x8
# words, CIOS: 2*8*8 + 8 wide products, two instructions each), and of one
# extended Edwards addition (add-2008-hwcd: 9 general and 2 constant
# products)
PRODUCT_OPS = 2 * (2 * 8 * 8 + 8)
POINT_ADD_OPS = 11 * PRODUCT_OPS


@dataclass
class Peaks:
    bytes_per_s: float
    ops_per_s: float
    card: str  # name and power limit, as nvidia-smi reads them


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0].strip()


def card_peaks(sm_count: int) -> Peaks:
    clock_hz = float(_smi("clocks.max.sm")) * 1e6
    return Peaks(PEAK_BYTES_PER_S, sm_count * INT_MUL_PER_CLOCK_PER_SM * clock_hz,
                 _smi("name,power.limit"))


def product_work(a_elems: int, b_elems: int) -> tuple[int, int]:
    """(bytes, operations) of max(a, b) Montgomery products over a and b
    elements (one side may be a single broadcast element)."""
    n = max(a_elems, b_elems)
    return (a_elems + b_elems + n) * ELEMENT_BYTES, n * PRODUCT_OPS


def point_add_work(points: int) -> tuple[int, int]:
    """(bytes, operations) of `points` point additions."""
    return 3 * points * POINT_BYTES, points * POINT_ADD_OPS


def least_seconds(work: list[tuple[int, int]], peaks: Peaks) -> float:
    """The least time of a sequence of calls: each call bound by its bytes
    or its operations, whichever takes longer at the peak rates."""
    return sum(max(b / peaks.bytes_per_s, o / peaks.ops_per_s)
               for b, o in work)
