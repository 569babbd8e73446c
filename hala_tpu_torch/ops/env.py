"""Environment lighting: procedural sky gradient + HDR envmap sampling.

Role parity: the reference's miss shader consuming the global uniform's
env fields (rt_renderer.rs:44-65), as in the JAX package's `ops/env.py`:
env_type SKY(0) blends ground/sky colors, MAP(1) samples the equirect
HDR with the precomputed inverted-CDF tables (envmap.py) and applies
`env_rotation` (already normalized by /360) and `env_intensity`.

Direction <-> equirect convention (self-consistent across eval/sample/
pdf): u = (atan2(d.z, d.x)/(2 pi) + 0.5 + rotation) mod 1,
v = acos(d.y)/pi (v=0 at +Y).

The JAX package reads packed 2x2-neighbourhood and per-texel tables to
save TPU row gathers; here the four corners, the nearest texel and the
sampled texel are plain indexed reads of the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-6
TWO_PI = float(np.float32(2.0 * np.pi))


def sky_radiance(d: torch.Tensor, ground_color, sky_color) -> torch.Tensor:
    """SKY env type: vertical gradient between ground and sky colors."""
    t = torch.clamp(0.5 * (d[..., 2:3] * 0.0 + d[..., 1:2] + 1.0), 0.0, 1.0)
    return ground_color * (1.0 - t) + sky_color * t


def dir_to_uv(d: torch.Tensor, rotation):
    u = torch.atan2(d[..., 2], d[..., 0]) / TWO_PI + 0.5 + rotation
    u = u - torch.floor(u)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_dir(u: torch.Tensor, v: torch.Tensor, rotation) -> torch.Tensor:
    phi = (u - 0.5 - rotation) * TWO_PI
    theta = v * math.pi
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1
    )


def _bilinear(img: torch.Tensor, u, v):
    """Bilinear fetch from (H, W, C) with wrap in u, clamp in v."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = img[y0i, x0i]
    c01 = img[y0i, x1i]
    c10 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _texel_pdf(env, lum, sin_t):
    """Solid-angle pdf of a texel of luminance `lum`:
    p(texel) = lum / total_lum (the per-row normalization cancels, see
    envmap.rs:277-308); pdf_sw = p * W*H / (2 pi^2 sin(theta))."""
    p_texel = lum / torch.clamp(env.total_luminance, min=_EPS)
    return p_texel * (env.width * env.height) / (2.0 * math.pi * math.pi * sin_t)


def _nearest_luminance(env, u, v):
    h, w = env.height, env.width
    xi = torch.clamp((u * w).long(), 0, w - 1)
    yi = torch.clamp((v * h).long(), 0, h - 1)
    return env.luminance[yi, xi]


def env_radiance(env, d: torch.Tensor, rotation, intensity) -> torch.Tensor:
    """Bilinear equirect lookup of emitted radiance along d."""
    u, v = dir_to_uv(d, rotation)
    return _bilinear(env.image, u, v) * intensity


def env_pdf(env, d: torch.Tensor, rotation) -> torch.Tensor:
    """Solid-angle pdf of env_sample for direction d (MIS weighting)."""
    u, v = dir_to_uv(d, rotation)
    sin_t = torch.clamp(torch.sin(v * math.pi), min=_EPS)
    return _texel_pdf(env, _nearest_luminance(env, u, v), sin_t)


def env_eval(env, d: torch.Tensor, rotation, intensity):
    """Miss-path evaluation: emitted radiance and the MIS pdf from one
    direction -> equirect transform (the same values as env_radiance
    and env_pdf)."""
    u, v = dir_to_uv(d, rotation)
    radiance = _bilinear(env.image, u, v) * intensity
    sin_t = torch.clamp(torch.sin(v * math.pi), min=_EPS)
    return radiance, _texel_pdf(env, _nearest_luminance(env, u, v), sin_t)


def env_sample(env, rnd: torch.Tensor, rotation, intensity):
    """Importance-sample the envmap with the 2-fetch inverted CDF tables.

    rnd: (N, 2) uniforms. Returns (wi (N,3), radiance (N,3), pdf (N,)).
    Mirrors the shader-side lookup the reference precomputes for
    (envmap.rs:311-331): v' = marginal[floor(u1*H)],
    u' = conditional[v'][floor(u2*W)]. The tables only emit texel-grid
    (u', v'), so the direction comes from the per-row and per-column
    trig tables at rotation 0, and env_rotation, a pure Y-rotation, is
    applied as a 2x2 rotation of its x and z."""
    h, w = env.height, env.width
    vi = torch.clamp((rnd[:, 0] * h).long(), 0, h - 1)
    ui = torch.clamp((rnd[:, 1] * w).long(), 0, w - 1)
    v = env.marginal[vi]  # quantized to texel grid
    yi = torch.clamp((v * h).long(), 0, h - 1)
    u = env.conditional[yi, ui]
    xi = torch.clamp((u * w).long(), 0, w - 1)
    sin_t = env.sin_theta[yi]
    x0 = sin_t * env.cos_phi[xi]
    y0 = env.cos_theta[yi]
    z0 = sin_t * env.sin_phi[xi]
    delta = rotation * TWO_PI
    c, s = torch.cos(delta), torch.sin(delta)
    wi = torch.stack([x0 * c + z0 * s, y0, z0 * c - x0 * s], dim=-1)
    radiance = env.image[yi, xi] * intensity
    pdf = _texel_pdf(env, env.luminance[yi, xi], torch.clamp(sin_t, min=_EPS))
    return wi, radiance, pdf
