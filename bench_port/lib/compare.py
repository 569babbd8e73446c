"""The comparison that decides `correct`.

The timed frames' output at pixels drawn from the seed (the path
tracer's accumulated film: radiance, albedo and normal with their weight
channels; the rasterizer's post-processed colour, albedo and normal) is
held against the plain reference's values at the same pixels, computed
after the program is freed. A pixel is off where some channel differs
from the reference by more than TOLERANCE of the reference's magnitude
(at least 0.05), or is not finite. The number compared is the share of
sampled pixels that are off, in percent, against the cell's limit in
bench_port/checks/<cell>.json.

Where the program and the reference find the same hits every channel
agrees bit for bit, so a sound run is off only on pixels whose rays met
a graze or an exact tie that the two resolve differently; a precision
lower than float32 moves nearly every pixel by more than TOLERANCE.
"""

from __future__ import annotations

import json
import os
import time

import torch

from . import refraster, reftrace
from .refscene import RefScene

TOLERANCE = 1e-4
CHECKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checks")


def reference_settings(config: dict) -> dict:
    rend, env = config["renderer"], config["environment"]
    return dict(max_depth=rend["max_depth"], rr_depth=rend["rr_depth"],
                shadow_t_scale=(1.0 - 1e-4) if rend["shadow_rays"] == "any_hit" else 1.0,
                ground_color=env["ground_color"], sky_color=env["sky_color"],
                env_intensity=env["intensity"])


def reference_values(config, traffic, host, pixels, frames, device, dtype=torch.float32,
                     camera=0):
    """The reference's values at `pixels`, laid out as `run.film_values`,
    seen from the scene's camera `camera` (the pose of the last frame)."""
    rs = RefScene(host, device, dtype, camera)
    w, h = traffic["width"], traffic["height"]
    if traffic["renderer"] == "trace":
        vals = reftrace.render_pixels(rs, pixels, frames, w, h, reference_settings(config))
        return vals.float().cpu(), None
    vals = refraster.render_pixels(rs, pixels, w, h).float().cpu()
    return vals[:, :9], vals[:, 9] > 0


def pixels_off(got, ref, covered=None):
    """Per pixel: True where some channel is off (see the module doc).
    Albedo and normal of pixels no triangle covers are not compared."""
    diff = (got - ref).abs()
    if covered is not None:
        diff[~covered, 3:] = 0.0
    gap = diff / torch.clamp(ref.abs(), min=0.05)
    gap = torch.where(torch.isfinite(got) & torch.isfinite(ref), gap, torch.inf)
    return gap.amax(dim=1) > TOLERANCE


def limits(cell: str) -> dict:
    with open(os.path.join(CHECKS, cell + ".json")) as f:
        return json.load(f)


def check(cell, config, traffic, host, pixels, got, frames, device, log=print,
          camera=0) -> dict:
    """The checks of one run: each number compared with its limit."""
    t0 = time.perf_counter()
    ref, covered = reference_values(config, traffic, host, pixels, frames, device,
                                    camera=camera)
    off = pixels_off(got, ref, covered)
    log(f"info: reference {time.perf_counter() - t0:.2f} s, {int(off.sum())} of "
        f"{off.numel()} pixels off")
    return {"pixels_off_pct": {"value": 100.0 * float(off.float().mean()),
                               "limit": limits(cell)["pixels_off_pct"]}}
