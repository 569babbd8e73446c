"""Progressive path-tracing renderer (the flagship).

Parity: reference src/rt_renderer.rs (HalaRenderer, exported as
HalaRayTracingRenderer), as in the JAX package's `models/rt_renderer.py`:

* constructor parameters (rt_renderer.rs:650-660): name, resolution,
  max_depth, rr_depth, enable_tonemap, enable_aces, use_simple_aces,
  max_frames (0 = unlimited), plus `device` — "cuda" by default; a host
  without CUDA raises rather than running on the CPU, so CPU runs pass
  device="cpu" explicitly;
* `set_scene` uploads the scene to the device (rt_renderer.rs:1161-1178);
* the lighting-environment knobs set_envmap / set_ground_color /
  set_sky_color / set_env_intensity / set_exposure_value
  (rt_renderer.rs:1184-1219);
* `load_blue_noise_texture` (rt_renderer.rs:1117-1156): the texture
  becomes the per-pixel low-discrepancy source of every sampling
  dimension (ops/rng.py `bn_sample4`);
* `update` skips once the max_frames progressive budget is reached
  (rt_renderer.rs:393-396) and seeds sampling with the frame index;
* `save_images` writes {name}_color/albedo/normal .pfm with the selected
  tonemap applied to color only (rt_renderer.rs:1224-1352);
* `push_general_kernel` / `push_hit_kernels` register pushed kernels in
  the process KernelCache (rt.raygen, rt.miss, rt.callable,
  rt.closest_hit, rt.any_hit, rt.intersection); `commit` resolves them
  into the frame's `KernelHooks` (rt_renderer.rs:925-1112).

`staged=` is accepted and does nothing: the port has one frame loop.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import time

import numpy as np
import torch

from ..envmap import EnvMap
from ..error import HalaRendererError
from ..ops.tonemap import apply_tonemap
from ..scene.cpu.image_data import ImageData
from ..scene.cpu.scene import Scene
from ..scene.gpu.scene import resolve_device
from ..scene.loader.uploader import SceneUploader
from ..utils.pfm import write_pfm
from .integrator import (
    ENV_MAP,
    ENV_SKY,
    Film,
    KernelHooks,
    RenderSettings,
    Uniforms,
    render_frame,
    render_frames,
)
from .renderer import BaseRenderer

logger = logging.getLogger("hala_tpu_torch.rt")


class EnvType(enum.IntEnum):
    """rt_renderer.rs:23-41."""

    SKY = ENV_SKY
    MAP = ENV_MAP


class RayTracingRenderer(BaseRenderer):
    def __init__(
        self,
        name: str,
        width: int,
        height: int,
        max_depth: int = 4,
        rr_depth: int = 2,
        enable_tonemap: bool = True,
        enable_aces: bool = False,
        use_simple_aces: bool = False,
        max_frames: int = 0,
        tile_size: int = 1 << 20,
        intersector: str = "auto",
        spp: int = 1,
        staged: bool = False,
        shadow_intersector: str = "auto",
        extend_intersector: str = "auto",
        device="cuda",
    ):
        super().__init__(name, width, height, resolve_device(device))
        del staged  # one frame loop: nothing to stage
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.enable_tonemap = enable_tonemap
        self.enable_aces = enable_aces
        self.use_simple_aces = use_simple_aces
        self.max_frames = max_frames if max_frames > 0 else (1 << 62)
        self._tile_size = tile_size
        self._spp = spp
        self._intersector = intersector
        self._shadow_intersector = shadow_intersector
        self._extend_intersector = extend_intersector

        self.scene = None          # DeviceScene
        self._host_scene: Scene | None = None
        self.env: EnvMap | None = None
        self.env_type = EnvType.SKY
        self.blue_noise: torch.Tensor | None = None
        self.uniforms = Uniforms.default(self.device)
        self.film = Film.create(width, height, self.device)
        self.settings: RenderSettings | None = None
        self.hooks: KernelHooks | None = None
        self._frame_index = 0
        self._ui_fn = None
        self.total_rays = 0.0

    # -- scene / environment API ----------------------------------------

    def set_scene(self, scene: Scene) -> None:
        """rt_renderer.rs:1161-1178."""
        self._host_scene = scene
        self.scene = SceneUploader.upload(scene, device=self.device)

    def set_envmap(self, env: "EnvMap | str", rotation: float = 0.0) -> None:
        """rt_renderer.rs:1184-1192; rotation in degrees, normalized by
        /360 into the uniform (rt_renderer.rs:420). `env` is an EnvMap
        or the path of a float image."""
        if isinstance(env, str):
            env = EnvMap.load(env, device=self.device)
        self.env = env.to(self.device)
        self.env_type = EnvType.MAP
        self.uniforms.env_rotation = self._f32(rotation / 360.0)
        self.settings = None  # the env type is part of the settings

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def set_ground_color(self, color) -> None:
        self.uniforms.ground_color = self._f32(color)

    def set_sky_color(self, color) -> None:
        self.uniforms.sky_color = self._f32(color)

    def set_env_intensity(self, intensity: float) -> None:
        self.uniforms.env_intensity = self._f32(intensity)

    def set_exposure_value(self, ev: float) -> None:
        self.uniforms.exposure_value = self._f32(ev)

    def set_camera_index(self, index: int) -> None:
        self.uniforms.camera_index = int(index)

    # -- kernel push API (shader push parity) -----------------------------

    def push_general_kernel(self, kind: str, fn_or_path) -> None:
        """Register a raygen, miss or callable stage kernel
        (rt_renderer.rs:925-1012 push_general_shader rejects other
        stages) in the process KernelCache under rt.<kind>; `commit`
        binds it. A callable runs at the post-shade seam."""
        if kind not in ("raygen", "miss", "callable"):
            raise HalaRendererError(
                f"Only raygen/miss/callable stages accepted, got {kind!r}."
            )
        self._push_kernel(f"rt.{kind}", fn_or_path)

    def push_hit_kernels(self, closest_hit, any_hit=None, intersection=None) -> None:
        """Register a hit-group kernel tuple (rt_renderer.rs:1020-1112
        push_hit_shaders)."""
        self._push_kernel("rt.closest_hit", closest_hit)
        if any_hit is not None:
            self._push_kernel("rt.any_hit", any_hit)
        if intersection is not None:
            self._push_kernel("rt.intersection", intersection)

    def _push_kernel(self, name: str, fn_or_path) -> None:
        """A callable, or a "module:function" path the cache resolves."""
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        fn = cache.load(fn_or_path) if isinstance(fn_or_path, str) else fn_or_path
        cache.from_memory(name, fn)

    def load_blue_noise_texture(self, path: str) -> None:
        """rt_renderer.rs:1117-1156: the texture becomes the per-pixel
        low-discrepancy source of every sampling dimension."""
        self.blue_noise = self._f32(ImageData.load(path).as_float_rgba())

    # -- frame loop ------------------------------------------------------

    def commit(self) -> None:
        """Freeze the settings (rt_renderer.rs:136-379 role)."""
        if self.scene is None:
            raise HalaRendererError("commit() before set_scene().")
        self.settings = RenderSettings(
            width=self.info.width,
            height=self.info.height,
            max_depth=self.max_depth,
            rr_depth=self.rr_depth,
            env_type=int(self.env_type),
            tile_size=self._tile_size,
            intersector=self._intersector,
            spp=self._spp,
            shadow_intersector=self._shadow_intersector,
            extend_intersector=self._extend_intersector,
        )
        # the pushed kernels become the frame's dispatch table (the SBT
        # build of the reference's commit); stages not pushed keep the
        # built-in integrator's
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        hooks = KernelHooks(
            raygen=cache.get("rt.raygen"),
            miss=cache.get("rt.miss"),
            post_shade=cache.get("rt.callable"),
            closest_hit=cache.get("rt.closest_hit"),
            any_hit=cache.get("rt.any_hit"),
            intersection=cache.get("rt.intersection"),
        )
        pushed = any(getattr(hooks, f.name) is not None
                     for f in dataclasses.fields(hooks))
        self.hooks = hooks if pushed else None

    def update(self, delta_time: float = 0.0, ui_fn=None) -> None:
        """Dispatch one progressive frame (rt_renderer.rs:387-471).

        `ui_fn`: an optional `(color (H, W, 3) tensor) -> tensor` overlay
        applied to the display image after tonemapping (never to the
        accumulator) in `get_final_image`; None clears it."""
        self._ui_fn = ui_fn
        if self.settings is None:
            self.commit()
        self.check_and_restore_device()
        if self._frame_index >= self.max_frames:
            return  # progressive budget reached (rt_renderer.rs:393-396)
        t0 = time.monotonic()
        _, rays = render_frame(
            self.scene, self.env, self.uniforms, self.film, self._frame_index,
            self.settings, blue_noise=self.blue_noise, hooks=self.hooks,
        )
        self._pending = True
        self._last_rays = rays
        self._frame_index += 1
        self._last_cpu_time = time.monotonic() - t0

    def render(self) -> None:
        super().render()
        if self._last_rays is not None and not self.is_device_lost:
            self.total_rays += float(self._last_rays)
            self._last_rays = None

    def render_loop(
        self, frames: int, pipelined: bool = True,
        frames_per_dispatch: int = 1,
    ) -> None:
        """Convenience progressive loop (the external app's window loop).

        `pipelined=True` (default) dispatches every frame without host
        synchronization and waits once at the end; `pipelined=False`
        matches the reference's per-frame update/render cadence with
        live statistics. `frames_per_dispatch=K` runs frames in chunks
        of K through `render_frames` (the same bits as K single frames).
        Statistics after a pipelined loop spread the aggregate wall time
        uniformly over its frames (`synthetic_per_frame`)."""
        if not pipelined:
            for _ in range(frames):
                self.update()
                self.render()
            return
        if self.settings is None:
            self.commit()
        self.check_and_restore_device()
        t0 = time.monotonic()
        rays_acc = []
        left = min(frames, self.max_frames - self._frame_index)
        k_max = max(1, frames_per_dispatch)
        while left > 0:
            k = min(k_max, left)
            _, rays = render_frames(
                self.scene, self.env, self.uniforms, self.film,
                self._frame_index, k, self.settings,
                blue_noise=self.blue_noise, hooks=self.hooks,
            )
            rays_acc.append(rays)
            self._frame_index += k
            left -= k
        self._pending = True
        self.wait_idle()
        dt = max(time.monotonic() - t0, 1e-9)
        total = float(sum(float(r) for r in rays_acc))
        self.total_rays += total
        n = max(frames, 1)
        for _ in range(frames):
            self.statistics.record_frame(dt / n, dt / n, total / n)
        self.statistics.last_metrics = {
            "fps": n / dt,
            "gpu_ms": 1000.0 * dt / n,
            "cpu_ms": 1000.0 * dt / n,
            "mrays_per_s": total / dt / 1e6,
            "total_frames": self.statistics.total_frames,
            "synthetic_per_frame": True,
        }

    # -- output ----------------------------------------------------------

    def _tonemapped(self, color: torch.Tensor) -> torch.Tensor:
        return apply_tonemap(
            color, self.enable_tonemap, self.enable_aces, self.use_simple_aces
        )

    @torch.inference_mode()
    def get_final_image(self) -> np.ndarray:
        """Display path: exposure * accum through the tonemap chain,
        then the ui_fn overlay."""
        self.wait_idle()
        img = self._tonemapped(
            self.film.accum[..., :3] * self.uniforms.exposure_value
        )
        if self._ui_fn is not None:
            img = self._ui_fn(img)
        return img.cpu().numpy()

    @torch.inference_mode()
    def save_images(self, path: str) -> None:
        """PFM export (rt_renderer.rs:1224-1352): color gets the tonemap
        operator chain, albedo/normal are raw."""
        if self.is_device_lost:
            logger.warning(
                "The device is lost! Please wait to reset the device and "
                "try again."
            )
            return
        self.wait_idle()
        stem, _ = os.path.splitext(path)
        color = self.film.accum.clone()
        color[..., :3] = self._tonemapped(color[..., :3])
        write_pfm(f"{stem}_color.pfm", color.cpu().numpy())
        logger.info("Save the color image to file: %s_color.pfm", stem)
        write_pfm(f"{stem}_albedo.pfm", self.film.albedo.cpu().numpy())
        logger.info("Save the albedo image to file: %s_albedo.pfm", stem)
        write_pfm(f"{stem}_normal.pfm", self.film.normal.cpu().numpy())
        logger.info("Save the normal image to file: %s_normal.pfm", stem)

    def reset_accumulation(self) -> None:
        """Restart progressive accumulation (fresh film + frame 0)."""
        self.wait_idle()
        self.film = Film.create(self.info.width, self.info.height, self.device)
        self._frame_index = 0

    # -- device restore ---------------------------------------------------

    def _restore_device_state(self) -> None:
        """rt_renderer.rs:508-563: recreate storage images + re-upload."""
        self.film = Film.create(self.info.width, self.info.height, self.device)
        self._frame_index = 0
        if self._host_scene is not None:
            self.set_scene(self._host_scene)
