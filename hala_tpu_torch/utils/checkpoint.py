"""Render-state checkpoint / resume.

Counterpart of the JAX package's utils/checkpoint.py, with its npz keys
and format version, so a checkpoint that either package writes loads in
the other. The film (accum and AOVs), the frame index and the sampler
seed round-trip through one .npz, so a progressive render survives a
process restart.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..error import HalaRendererError
from ..models.integrator import Film
from ..scene.gpu.scene import resolve_device

_FORMAT_VERSION = 1


def save_render_state(
    path: str, film: Film, frame_index: int, seed: int = 0, extra: dict | None = None
) -> None:
    """Write film + progress to `path` (.npz), through a temporary file
    renamed into place."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "accum": film.accum.cpu().numpy(),
        "albedo": film.albedo.cpu().numpy(),
        "normal": film.normal.cpu().numpy(),
        "frame_index": np.int64(frame_index),
        "seed": np.int64(seed),
    }
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(tmp, **payload)  # np.savez appends .npz to a name without it
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_render_state(path: str, device="cuda") -> tuple[Film, int, int, dict]:
    """Read (film on `device`, frame_index, seed, extra) back; extra
    values stay numpy arrays."""
    dev = resolve_device(device)
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise HalaRendererError(
                f"Unsupported render-state version {int(z['version'])}."
            )
        film = Film(**{k: torch.from_numpy(z[k]).to(dev)
                       for k in ("accum", "albedo", "normal")})
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        return film, int(z["frame_index"]), int(z["seed"]), extra
