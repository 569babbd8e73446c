"""Morton (Z-order) codes: host (numpy) and device (torch) versions.

The uploader orders small scenes' triangles into spatially coherent
clusters with the host codes (scene/loader/uploader.py); the ray
coherence sort (ops/compaction.py) keys rays on the device codes. Both
give the JAX package's 30-bit codes (10 bits per axis) bit for bit.
`sort_by_morton` sorts codes and payloads on the device, in the order
of the JAX package's stable `jnp.argsort`.
"""

from __future__ import annotations

import numpy as np
import torch


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (u32)."""
    v = v.astype(np.uint32) & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def morton3d_np(points: np.ndarray, bounds_min, bounds_max) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points within the given AABB."""
    ext = np.maximum(np.asarray(bounds_max) - np.asarray(bounds_min), 1e-9)
    q = np.clip((points - bounds_min) / ext, 0.0, 1.0 - 1e-7)
    cells = (q * 1024.0).astype(np.uint32)
    return (
        (_expand_bits_np(cells[:, 0]) << 2)
        | (_expand_bits_np(cells[:, 1]) << 1)
        | _expand_bits_np(cells[:, 2])
    )


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit, in int64 with the uint32 masks
    (torch's uint32 has few operations on the CPU)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(points: torch.Tensor, bounds_min, bounds_max) -> torch.Tensor:
    """30-bit Morton codes for (N, 3) float32 points, as (N,) int64."""
    ext = torch.clamp(bounds_max - bounds_min, min=1e-9)
    q = torch.clamp((points - bounds_min) / ext, 0.0, 1.0 - 1e-7)
    cells = (q * 1024.0).to(torch.int64)
    return (
        (_expand_bits(cells[:, 0]) << 2)
        | (_expand_bits(cells[:, 1]) << 1)
        | _expand_bits(cells[:, 2])
    )


def sort_by_morton(codes: torch.Tensor, *payloads):
    """(sorted codes, the payloads permuted alike): a stable ascending
    sort, so equal codes keep their input order as jnp.argsort keeps
    it."""
    order = torch.argsort(codes, stable=True)
    return (codes[order],) + tuple(p[order] for p in payloads)
