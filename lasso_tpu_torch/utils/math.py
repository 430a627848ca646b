"""Math/bit utilities (reference: src/utils/math.rs, src/utils/mod.rs)."""

from __future__ import annotations

from lasso_tpu_torch.field.host import Fr


def log_2(n: int) -> int:
    """Exact log2 of a power of two (reference: math.rs `log_2`)."""
    assert n > 0 and n & (n - 1) == 0, f"{n} is not a power of two"
    return n.bit_length() - 1


def pow_2(e: int) -> int:
    return 1 << e


def square_root(n: int) -> int:
    """Integer square root of a perfect-square power of two."""
    r = 1 << (log_2(n) // 2)
    assert r * r == n
    return r


def get_bits(n: int, num: int) -> list[bool]:
    """MSB-first bit vector of the low `num` bits (reference: math.rs:24-36)."""
    return [bool((n >> (num - 1 - i)) & 1) for i in range(num)]


def index_to_field_bitvector(value: int, bits: int) -> list[int]:
    """Field bit vector, MSB first (reference: utils/mod.rs:33-46)."""
    return [(value >> (bits - 1 - i)) & 1 for i in range(bits)]


def split_bits(item: int, num_bits: int) -> tuple[int, int]:
    """(high, low) chunks, each num_bits wide (reference: utils/mod.rs:82-89)."""
    mask = (1 << num_bits) - 1
    return (item >> num_bits) & mask, item & mask


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def compute_dotproduct(a: list[int], b: list[int]) -> int:
    """<a, b> mod Fr (reference: utils/mod.rs:63-73; hot paths use the
    device/sharded variants in poly/ and parallel/)."""
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % Fr.p
