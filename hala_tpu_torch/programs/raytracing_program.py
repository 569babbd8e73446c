"""Ray-tracing program: JSON desc -> configured integrator.

Parity: reference src/raytracing_program.rs (HalaRayTracingProgram{Desc}),
as the JAX package's `programs/raytracing_program.py`: a desc with
raygen/miss/hit/callable shader path lists and ray_recursion_depth
(default 1, raytracing_program.rs:49-57). The stages name kernels in
the KernelCache (`builtin:*` keeps the integrator's own stage: camera
raygen, environment miss, surface shading); `trace_rays(width, height)`
runs one progressive frame of `models.integrator.render_frame` with
max_depth = ray_recursion_depth and the stages as its `KernelHooks`.
The desc itself plays the SBT's role (the stage dispatch table).
"""

from __future__ import annotations

import dataclasses
import json

import torch

from ..models.integrator import (
    ENV_SKY,
    Film,
    KernelHooks,
    RenderSettings,
    Uniforms,
    render_frame,
)
from .shader_cache import KernelCache


@dataclasses.dataclass
class RayTracingProgramDesc:
    """raytracing_program.rs:25-47 JSON shape (serde defaults kept)."""

    ray_gen_shader_file_path: str = "builtin:raygen"
    miss_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:miss_env"]
    )
    hit_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:closest_hit"]
    )
    callable_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:bsdf"]
    )
    push_constant_size: int = 0
    ray_recursion_depth: int = 1   # serde default (raytracing_program.rs:49-57)
    rr_depth: int = 2
    env_type: int = ENV_SKY

    @staticmethod
    def from_json(text: str) -> "RayTracingProgramDesc":
        d = json.loads(text)
        out = RayTracingProgramDesc()
        for f in dataclasses.fields(out):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class RayTracingProgram:
    def __init__(self, desc: RayTracingProgramDesc, scene, env=None):
        self.desc = desc
        self.scene = scene
        self.env = env

    def trace_rays(
        self,
        film: Film,
        width: int,
        height: int,
        frame_index: int = 0,
        uniforms: Uniforms | None = None,
    ):
        """raytracing_program.rs:330-340 trace_rays: one frame into `film`
        (in place). Returns (film, rays traced)."""
        settings = RenderSettings(
            width=width,
            height=height,
            max_depth=self.desc.ray_recursion_depth,
            rr_depth=self.desc.rr_depth,
            env_type=self.desc.env_type,
        )
        return render_frame(
            self.scene,
            self.env,
            uniforms or Uniforms.default(film.accum.device),
            film,
            frame_index,
            settings,
            hooks=self._resolve_hooks(),
        )

    def trace_rays_indirect(
        self,
        film: Film,
        pixel_count,
        width: int,
        height: int,
        frame_index: int = 0,
        uniforms: Uniforms | None = None,
    ):
        """raytracing_program.rs:330-340 trace_rays_indirect: the trace
        size comes from a device buffer (VkTraceRaysIndirectCommand). The
        whole grid is traced into a copy of the film, and `pixel_count`,
        an integer tensor never read on the host, masks which pixels
        commit (the row-major prefix a {width, count / width} command
        covers). Returns (film, rays traced)."""
        traced = Film(accum=film.accum.clone(), albedo=film.albedo.clone(),
                      normal=film.normal.clone())
        _, rays = self.trace_rays(traced, width, height, frame_index, uniforms)
        dev = film.accum.device
        pid = torch.arange(height * width, dtype=torch.int32, device=dev).reshape(
            height, width, 1)
        keep = pid < torch.as_tensor(pixel_count, dtype=torch.int32, device=dev)
        for dst, src in ((film.accum, traced.accum), (film.albedo, traced.albedo),
                         (film.normal, traced.normal)):
            dst.copy_(torch.where(keep, src, dst))
        return film, rays

    def _resolve_hooks(self) -> KernelHooks | None:
        """The desc's shader paths as the frame's dispatch table (the SBT
        role): `builtin:*` keeps the integrator's stage, anything else
        loads through the KernelCache by import path. The raygen path
        takes the sample-jitter seam, the first miss path the escape
        radiance, the first callable the post-shade seam; the hit group
        is [closest_hit, any_hit, intersection], trailing entries
        optional (rt_renderer.rs:1020-1112)."""
        cache = KernelCache.get_instance()

        def resolve(paths, i):
            path = paths[i] if len(paths) > i else None
            if not path or path.startswith("builtin:"):
                return None
            return cache.load(path)

        d = self.desc
        hit = d.hit_shader_file_paths
        hooks = KernelHooks(
            raygen=resolve([d.ray_gen_shader_file_path], 0),
            miss=resolve(d.miss_shader_file_paths, 0),
            post_shade=resolve(d.callable_shader_file_paths, 0),
            closest_hit=resolve(hit, 0),
            any_hit=resolve(hit, 1),
            intersection=resolve(hit, 2),
        )
        if any(getattr(hooks, f.name) is not None for f in dataclasses.fields(hooks)):
            return hooks
        return None
