"""HDR environment map with 2-D CDF importance-sampling tables.

Counterpart of the JAX package's envmap.py (reference src/envmap.rs):

* decodes float RGB(A) images only and validates every texel against
  NaN/Inf (envmap.rs:57-71);
* builds per-row PDF/CDF and a 1-D column CDF with BT.709 luminance
  weights (envmap.rs:249-308), then inverts both CDFs into lookup
  tables, so sampling is two fetches instead of a binary search
  (envmap.rs:311-331): `marginal[v] = lower_bound(cdf_1d, (v+1)/H) / H`
  and `conditional[v][u] = lower_bound(cdf_2d[v], (u+1)/W) / W`;
* disk-caches the tables at ./out/{name}.dist_cache as a raw f32 LE
  stream [total_sum, marginal[H], conditional[H*W]] (envmap.rs:90-142),
  the same binary layout, so caches interoperate.

The tables are built on the host with numpy and wrapped as tensors. The
JAX package's `quad`, `stab` and `sstab` tables pack several fetches
into one row for the TPU's gather unit; the port indexes `image`,
`marginal`, `conditional` and `luminance` directly. What it keeps of
`stab` is its content that is not a fetch: the inverted CDFs only ever
emit texel-grid coordinates, so a sampled direction is a per-row and
per-column constant, made here in numpy exactly as `stab` makes it
(`sin_theta`, `cos_theta` (H,), `cos_phi`, `sin_phi` (W,)).

The sampling-side code (two-fetch sample, pdf for MIS) is ops/env.py.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from .error import HalaRendererError
from .scene.cpu.image_data import ImageData, ImageFormat
from .scene.gpu.scene import TensorTables, resolve_device

logger = logging.getLogger("hala_tpu_torch.envmap")

# BT.709 luminance weights (envmap.rs:249-251).
_LUMA = np.array([0.212671, 0.715160, 0.072169], np.float32)


@dataclasses.dataclass
class EnvMap(TensorTables):
    """Equirectangular HDR environment + inverted-CDF tables."""

    image: torch.Tensor            # (H, W, 3) f32 radiance
    marginal: torch.Tensor         # (H,) f32: inverted 1-D CDF lookup
    conditional: torch.Tensor      # (H, W) f32: inverted per-row CDF lookup
    luminance: torch.Tensor        # (H, W) f32: texel luminance (pdf eval)
    total_luminance: torch.Tensor  # () f32
    sin_theta: torch.Tensor        # (H,) f32: of the texel row v = y / H
    cos_theta: torch.Tensor        # (H,)
    cos_phi: torch.Tensor          # (W,) f32: of the texel column u = x / W
    sin_phi: torch.Tensor          # (W,)
    width: int = 0
    height: int = 0
    name: str = "envmap"

    @staticmethod
    def load(path: str, cache_dir: str = "./out", device="cuda") -> "EnvMap":
        img = ImageData.load(path)
        if img.format != ImageFormat.R32G32B32A32_SFLOAT:
            raise HalaRendererError(
                "Environment map must be a float image (envmap.rs:57-60)."
            )
        rgb = img.pixels[..., :3].astype(np.float32)
        if not np.isfinite(rgb).all():
            raise HalaRendererError(
                "Environment map contains NaN/Inf texels (envmap.rs:63-71)."
            )
        name = os.path.splitext(os.path.basename(path))[0]
        h, w = rgb.shape[:2]

        cache_path = os.path.join(cache_dir, f"{name}.dist_cache")
        total = marginal = conditional = None
        if os.path.exists(cache_path):
            try:
                raw = np.fromfile(cache_path, "<f4")
                if raw.size == 1 + h + h * w:
                    total = float(raw[0])
                    marginal = raw[1 : 1 + h].copy()
                    conditional = raw[1 + h :].reshape(h, w).copy()
                    logger.info("Loaded envmap distribution cache %s", cache_path)
            except OSError:
                pass
        if marginal is None:
            total, marginal, conditional = build_distribution_maps(rgb)
            try:
                os.makedirs(cache_dir, exist_ok=True)
                stream = np.concatenate(
                    [[np.float32(total)], marginal.ravel(), conditional.ravel()]
                ).astype("<f4")
                stream.tofile(cache_path)
            except OSError:  # cache write failure is non-fatal
                logger.warning("Could not write envmap cache %s", cache_path)
        return EnvMap.from_numpy(
            dict(image=rgb, marginal=marginal, conditional=conditional,
                 luminance=(rgb * _LUMA).sum(-1), total_luminance=total),
            device, name=name,
        )

    @staticmethod
    def from_array(rgb: np.ndarray, name: str = "envmap", device="cuda") -> "EnvMap":
        """Build directly from an (H, W, 3) float array (tests/procedural)."""
        rgb = np.asarray(rgb, np.float32)
        total, marginal, conditional = build_distribution_maps(rgb)
        return EnvMap.from_numpy(
            dict(image=rgb, marginal=marginal, conditional=conditional,
                 luminance=(rgb * _LUMA).sum(-1), total_luminance=total),
            device, name=name,
        )

    @staticmethod
    def from_numpy(tables, device="cuda", name: str | None = None) -> "EnvMap":
        """Wrap finished tables: a dict or any object (the JAX package's
        EnvMap) with `image`, `marginal`, `conditional`, `luminance` and
        `total_luminance` that convert with `np.asarray`."""
        dev = resolve_device(device)

        def get(key):
            v = tables[key] if isinstance(tables, dict) else getattr(tables, key)
            return np.asarray(v, np.float32)

        image = get("image")
        h, w = image.shape[:2]
        if name is None:
            name = getattr(tables, "name", "envmap")
        sin_t, cos_t, cos_p, sin_p = _texel_trig(h, w)

        def t(x):
            return torch.from_numpy(np.array(x, np.float32, copy=True)).to(dev)

        return EnvMap(
            image=t(image), marginal=t(get("marginal")),
            conditional=t(get("conditional")), luminance=t(get("luminance")),
            total_luminance=t(get("total_luminance")),
            sin_theta=t(sin_t), cos_theta=t(cos_t), cos_phi=t(cos_p),
            sin_phi=t(sin_p), width=w, height=h, name=name,
        )


def _texel_trig(h: int, w: int):
    """sin/cos of theta = (y / H) pi per row and of phi = (x / W - 0.5)
    2 pi per column, in f32 numpy: ops.env.uv_to_dir at rotation 0 on
    the texel grid, as the JAX package's sample table holds it."""
    u = np.arange(w, dtype=np.float32) / np.float32(w)
    v = np.arange(h, dtype=np.float32) / np.float32(h)
    phi = ((u - np.float32(0.5)) * np.float32(2.0 * np.pi)).astype(np.float32)
    theta = (v * np.float32(np.pi)).astype(np.float32)
    return (np.sin(theta).astype(np.float32), np.cos(theta).astype(np.float32),
            np.cos(phi).astype(np.float32), np.sin(phi).astype(np.float32))


def build_distribution_maps(rgb: np.ndarray):
    """(total_sum, marginal (H,), conditional (H, W)) per envmap.rs:239-388.

    Vectorized re-expression of the reference's row loop: identical
    outputs (same lower_bound-on-CDF inversion), no per-texel Python.
    """
    h, w = rgb.shape[:2]
    weight = (rgb[..., :3] * _LUMA).sum(-1).astype(np.float32)  # (H, W)
    total_sum = float(np.cumsum(weight.ravel(), dtype=np.float32)[-1])

    # Sequential cumsum; the row normalizer must be the cumsum's own last
    # element (not a pairwise .sum()) to reproduce the reference's
    # accumulate-then-divide float semantics exactly.
    cdf_2d_raw = np.cumsum(weight, axis=1, dtype=np.float32)
    row_sum = cdf_2d_raw[:, -1]
    safe_row = np.where(row_sum > 0, row_sum, 1.0)
    cdf_2d = cdf_2d_raw / safe_row[:, None]

    col_cdf = np.cumsum(row_sum, dtype=np.float32)
    col_total = col_cdf[-1] if col_cdf[-1] > 0 else 1.0
    cdf_1d = (col_cdf / col_total).astype(np.float32)

    # Invert: marginal[v] = lower_bound(cdf_1d, (v+1)/H) / H.
    targets_v = (np.arange(1, h + 1, dtype=np.float32)) / np.float32(h)
    rows = np.searchsorted(cdf_1d, targets_v, side="left")
    marginal = rows.astype(np.float32) / np.float32(h)

    # conditional[v][u] = lower_bound(cdf_2d[v], (u+1)/W) / W.
    targets_u = (np.arange(1, w + 1, dtype=np.float32)) / np.float32(w)
    cols = np.empty((h, w), np.int64)
    for v in range(h):
        cols[v] = np.searchsorted(cdf_2d[v], targets_u, side="left")
    conditional = cols.astype(np.float32) / np.float32(w)

    return total_sum, marginal, conditional
