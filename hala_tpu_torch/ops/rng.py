"""Counter-based per-pixel RNG, bit-exact with the JAX package.

PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020): stateless, one stream per (pixel, frame, bounce, seed), so a
render is a pure function of (seed, frame_index) and independent of
tiling. torch has no full uint32 arithmetic, so every value lives in
int64 holding a uint32, and every multiply and add is reduced mod 2^32.
Products are formed from 16-bit halves so no int64 intermediate ever
overflows.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_INV_U24 = 1.0 / (1 << 24)  # exact in f32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors (or ints) holding uint32."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _MASK


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash. v: (..., 4) int64 holding uint32 -> same."""
    v = (_mul32(v, 1664525) + 1013904223) & _MASK
    x = (v[..., 0] + _mul32(v[..., 1], v[..., 3])) & _MASK
    y = (v[..., 1] + _mul32(v[..., 2], x)) & _MASK
    z = (v[..., 2] + _mul32(x, y)) & _MASK
    w = (v[..., 3] + _mul32(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return torch.stack([x, y, z, w], dim=-1)


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """int/tensor -> int64 tensor on like's device, reduced mod 2^32
    (the uint32 cast of the JAX package)."""
    t = torch.as_tensor(x, device=like.device).to(torch.int64)
    return torch.broadcast_to(t & _MASK, like.shape)


def sample4(
    pixel_index: torch.Tensor, frame_index, bounce, seed=0
) -> torch.Tensor:
    """Four uniform floats in [0, 1) per pixel for one (frame, bounce).

    pixel_index: (...,) integer tensor (linear pixel id). frame_index,
    bounce and seed are ints or integer tensors broadcastable to it.
    """
    pix = pixel_index.to(torch.int64) & _MASK
    ctr = torch.stack(
        [pix, _u32(frame_index, pix), _u32(bounce, pix), _u32(seed, pix)],
        dim=-1,
    )
    bits = pcg4d(ctr)
    # top 24 bits convert to f32 exactly: uniform on [0, 1), never 1.0
    return (bits >> 8).to(torch.float32) * _INV_U24


def bn_sample4(
    blue_noise: torch.Tensor, px, py, frame_index, bounce, seed=0
) -> torch.Tensor:
    """Blue-noise-seeded four-dimensional sample, as the JAX package's
    `bn_sample4` (the reference binds its blue-noise texture as the
    per-pixel low-discrepancy source of all shader sampling,
    rt_renderer.rs:1117-1156).

    Cranley-Patterson construction: the texture supplies the per-pixel
    value (so estimation error is blue-distributed in screen space),
    while PCG4D supplies a per-(frame, bounce, stream) rotation shared
    by all pixels and a per-(bounce, stream) toroidal texture shift, so
    distinct sampling dimensions read decorrelated regions.

    px/py are global screen coordinates (integer tensors), so the output
    does not depend on tiling. blue_noise: (H, W, 4) float32 in [0, 1).
    """
    bh, bw = blue_noise.shape[0], blue_noise.shape[1]
    ss = torch.stack([
        _u32(bounce, px.new_zeros(())), _u32(seed, px.new_zeros(())),
        _u32(0x9E3779B9, px.new_zeros(())), _u32(0x85EBCA6B, px.new_zeros(())),
    ], dim=-1)
    hsh = pcg4d(ss)
    tx = (px.to(torch.int64) + hsh[..., 0] % bw) % bw
    ty = (py.to(torch.int64) + hsh[..., 1] % bh) % bh
    texel = blue_noise[ty, tx, :4]
    # the rotation's pixel counter is fixed at 0 (shared by all pixels);
    # frame_index may be per ray (spp > 1 virtual frames)
    rot = sample4(torch.zeros_like(px), frame_index, bounce, seed)
    return torch.remainder(texel + rot, 1.0)
