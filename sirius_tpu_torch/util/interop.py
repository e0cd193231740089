"""State carried across the two packages.

The JAX package stores a field element as (..., 16) uint32 16-bit limbs;
this port as (..., 8) int64 32-bit words.  Both are little-endian and in the
same Montgomery domain (R = 2^256), so conversion is pure repacking.  Data
crosses as numpy arrays: the port never imports jax or `sirius_tpu`, and the
tests hand `np.asarray(jax_array)` in and take `.numpy()` out.  Host objects
(affine points, curve specs) cross by value: `affine_from` rebuilds any
affine point with `.curve.name`, `.x` and `.y` as the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.jpoint import Points, curve_for
from ..fields import gold
from ..fields.jfield import WORDS
from .device import resolve


def limbs_to_words(limbs) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) int64 32-bit words."""
    a = np.asarray(limbs).astype(np.int64)
    return a[..., 0::2] | (a[..., 1::2] << 16)


def words_to_limbs(words) -> np.ndarray:
    """(..., 8) 32-bit words (numpy or torch) -> (..., 16) uint32 limbs."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.asarray(words).astype(np.int64)
    out = np.stack([w & 0xFFFF, w >> 16], axis=-1)
    return out.reshape(w.shape[:-1] + (2 * WORDS,)).astype(np.uint32)


def to_torch(limbs, device=None) -> torch.Tensor:
    """JAX-layout limb array -> port word tensor on `device`."""
    return torch.from_numpy(limbs_to_words(limbs)).to(resolve(device))


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """Port word tensor -> JAX-layout (..., 16) uint32 limb array."""
    return words_to_limbs(words)


def key_from_numpy(curve_spec, x, y, device=None) -> Points:
    """Affine Montgomery key coordinates in either layout ((n, 16) limbs or
    (n, 8) words) -> the port's Jacobian key points (z = 1)."""
    curve = curve_for(curve_spec)
    device = resolve(device)

    def conv(a):
        a = np.asarray(a)
        return torch.from_numpy(limbs_to_words(a) if a.shape[-1] == 2 * WORDS else a.astype(np.int64))

    px, py = conv(x).to(device), conv(y).to(device)
    return Points(px, py, curve.fb.ones(px.shape[:-1], device))


def witness_to_torch(arrays, device=None) -> list[torch.Tensor]:
    """Per-round witness arrays of a JAX `PlonkWitness` / `RelaxedPlonkWitness`
    (list of (size, 16) limb arrays) -> list of port word tensors."""
    device = resolve(device)
    return [to_torch(np.asarray(a), device) for a in arrays]


def witness_to_numpy(tensors) -> list[np.ndarray]:
    """Inverse of `witness_to_torch`."""
    return [to_numpy(t) for t in tensors]


def affine_from(pt) -> gold.AffinePoint:
    """An affine point of either package -> the port's `gold.AffinePoint`
    (by curve name and coordinates; the identity stays the identity)."""
    spec = curve_for(pt.curve).spec
    return gold.identity(spec) if pt.is_identity else gold.AffinePoint(spec, pt.x, pt.y)
