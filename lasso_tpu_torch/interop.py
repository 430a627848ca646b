"""Carrying state across from the JAX package (lasso_tpu) as plain numpy.

The JAX package holds field elements as uint32 arrays [..., 16] of 16-bit
limbs in Montgomery form (or limb-major, [..., 16, n], on the curve path),
and points as [..., 4, 16, n] limb-major extended coordinates; the port
holds the same limbs in int32 tensors.  These helpers convert between the
two without importing the JAX package, so tests can hand both packages
identical inputs and compare their outputs limb for limb.

The system's only parameters are the Pedersen/Hyrax generators, derived from
a label with Shake256 and ChaCha20; `generators_match` checks the port's
against the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.field.tfield import W


def _limb_array(a: np.ndarray) -> np.ndarray:
    arr = np.asarray(a)
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
        raise ValueError("limbs must lie in [0, 2^16)")
    return arr.astype(np.int32)


def limbs_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """JAX-package field elements (uint32 [..., 16]) -> int32 tensor."""
    arr = _limb_array(a)
    if arr.shape[-1] != W:
        raise ValueError(f"field elements need limbs on the last axis, "
                         f"got {arr.shape}")
    return torch.as_tensor(arr, device=device)


def limb_major_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """JAX-package limb-major field elements (uint32 [..., 16, n], the
    operands of JField.mul_lm) -> int32 tensor."""
    arr = _limb_array(a)
    if arr.ndim < 2 or arr.shape[-2] != W:
        raise ValueError(f"limb-major elements need limbs on axis -2, "
                         f"got {arr.shape}")
    return torch.as_tensor(arr, device=device)


def points_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """JAX-package points (uint32 [..., 4, 16, n]) -> int32 tensor."""
    arr = _limb_array(a)
    if arr.ndim < 3 or arr.shape[-3:-1] != (4, W):
        raise ValueError(f"points need shape [..., 4, {W}, n], got {arr.shape}")
    return torch.as_tensor(arr, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Port tensor -> uint32 numpy, the JAX package's dtype."""
    return t.detach().cpu().numpy().astype(np.uint32)


def generator_bases(n: int, label: bytes, device="cpu") -> torch.Tensor:
    """The port's n Pedersen generators plus the blinding generator h for
    `label`, as [4, 16, n+1] points (the layout of the JAX package's
    subprotocols.dot_product._gens_device)."""
    from lasso_tpu_torch.poly.commitments import MultiCommitGens
    from lasso_tpu_torch.subprotocols.dot_product import _gens_device

    return _gens_device(MultiCommitGens.new(n, label), device)


def generators_match(n: int, label: bytes, reference: np.ndarray) -> bool:
    """True when the port's generators for (n, label) equal `reference`,
    the JAX package's device bases [4, 16, n+1] for the same (n, label),
    byte for byte (both normalize to Z=1, so the limbs are canonical)."""
    ours = to_numpy(generator_bases(n, label))
    ref = np.asarray(reference)
    return ours.shape == ref.shape and np.array_equal(ours, ref.astype(np.uint32))
