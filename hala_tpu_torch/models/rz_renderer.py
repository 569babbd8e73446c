"""Rasterization renderer: forward and deferred paths.

Parity: reference src/rz_renderer.rs (HalaRenderer, exported as
HalaRasterizationRenderer), as in the JAX package's
`models/rz_renderer.py`:

* the view-projection is taken from the camera table and geometry is
  already world-space, so only VP is applied per frame
  (rz_renderer.rs:25-53);
* reverse-Z depth (CompareOp::GREATER, rz_renderer.rs:494) with clear
  color {25, 118, 210}/255 (rz_renderer.rs:1053);
* forward path: rasterize + shade (record_forward_command_buffer,
  rz_renderer.rs:978-1103);
* deferred path: a visibility/G-buffer pass, then a fullscreen lighting
  pass on the cached fragments, which `relight()` re-runs without
  re-rasterizing (rz_renderer.rs:1110-1446, 1455-1570);
* MSAA as supersampled rasterization with an average resolve
  (enable_multisample, rz_renderer.rs:1586-1622);
* transparency as depth peeling composited with the blend operator;
* `set_scene` uploads with use_mesh_shader, without global meshlets or
  ray tracing (rz_renderer.rs:1936-1954).

Every pass runs eagerly on the scene's device ("cuda" by default; a
host without CUDA raises, so CPU runs pass device="cpu"). Large meshes
go through the K3 segment kernel (ops/raster_kernel.py).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time

import numpy as np
import torch

from ..error import HalaRendererError
from ..ops.bsdf import bsdf_eval, gather_materials
from ..ops.raster import (
    clip_to_screen,
    rasterize,
    rasterize_meshlet_binned,
    rasterize_tiled,
    transform_vertices,
)
from ..ops.sampling import build_basis, cross, dot, normalize, to_local
from ..ops.texture import sample_texture
from ..ops.tonemap import apply_tonemap
from ..scene.cpu.scene import Scene
from ..scene.gpu.scene import resolve_device
from ..scene.loader.uploader import SceneUploader
from ..utils import profiling
from ..utils.pfm import write_pfm
from .renderer import BaseRenderer

logger = logging.getLogger("hala_tpu_torch.rz")

# rz_renderer.rs:1053 clear color.
CLEAR_COLOR = (25.0 / 255.0, 118.0 / 255.0, 210.0 / 255.0)

_BLENDS = ("over", "additive", "premultiplied", "none")


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    width: int
    height: int
    deferred: bool = False
    msaa: int = 1  # supersampling factor per axis (1 = off)
    chunk: int = 512
    binned: bool = False   # tile-binned rasterization
    tile: int = 64
    bin_k_max: int = 256
    mesh_shader: bool = False  # meshlet-binned draw path (rz.task/rz.mesh)
    # Transparency layers (depth peeling: the K nearest transparent
    # layers composited back to front over the opaque result; the
    # reference blends in draw order, rz_renderer.rs:490). 0 draws
    # everything opaque. Active only when a material has opacity < 1.
    peel_layers: int = 4
    # Blend operator from the graphics pipeline's blend state
    # (graphics_program.rs:62-65): "over" is SRC_ALPHA/ONE_MINUS_SRC_ALPHA
    # (rz_renderer.rs:490), "additive" ONE/ONE, "premultiplied"
    # ONE/ONE_MINUS_SRC_ALPHA; "none" draws transparent materials opaque.
    blend: str = "over"


@dataclasses.dataclass(frozen=True)
class RasterHooks:
    """Pushed rz.* kernel dispatch table (the shader-push parity of
    rz_renderer.rs:1829-1931). Stages not pushed keep the built-in
    behavior:

    - vertex(corners (T,3,3)) -> corners: pre-transform world-space
      triangle corners (also the mesh stage's transform when no rz.mesh
      kernel is pushed).
    - task(meshlets, eye (3,)) -> (M,) bool: meshlet visibility (default:
      cone culling).
    - mesh(corners (T,3,3)) -> corners: the mesh-shader vertex seam
      (mesh-shader mode only).
    - fragment(color (N,3), albedo (N,3), normal (N,3)) -> same triple,
      applied after the built-in lighting.
    """

    vertex: object = None
    task: object = None
    mesh: object = None
    fragment: object = None


def _shade(scene, frag, view_pos):
    """Material-aware direct lighting shared by forward shading and the
    deferred lighting pass (rz_renderer.rs:597-665, 429-461): the
    path tracer's BSDFs shade each fragment against every light in the
    table, with per-type radiance (POINT/SPOT falloff cones, QUAD area
    lights at their center with the light-side cosine, SPHERE by
    subtended solid angle). No shadows, as in the reference's raster
    lighting. Returns (color, albedo, shading normal, position)."""
    geom = scene.geometry
    tid = torch.clamp(frag.tri, min=0).long()
    u, v = frag.u, frag.v
    w0 = 1.0 - u - v
    st = geom.shade_table[tid]
    ns = normalize(
        w0[:, None] * st[:, 0:3] + u[:, None] * st[:, 3:6] + v[:, None] * st[:, 6:9]
    )
    pos = geom.tri_v0[tid] + u[:, None] * geom.tri_e1[tid] + v[:, None] * geom.tri_e2[tid]
    # Two-sided shading: orient the normal toward the viewer (the raster
    # pipeline draws both windings).
    to_view = view_pos[None, :] - pos
    ns = torch.where(dot(ns, to_view)[:, None] < 0, -ns, ns)
    uv = (
        w0[:, None] * st[:, 9:11] + u[:, None] * st[:, 11:13] + v[:, None] * st[:, 13:15]
    )
    mp = gather_materials(scene.materials, st[:, 18].to(torch.int32))
    if scene.textures is not None:
        mp = mp._replace(
            base_color=mp.base_color
            * sample_texture(scene.textures, mp.base_color_map, uv)[:, :3]
        )
    albedo = mp.base_color

    w_disney = bool(scene.materials.has_disney)
    w_trans = bool(scene.materials.has_transmission)
    t_b, b_b = build_basis(ns)
    wo = normalize(to_view)
    wo_l = to_local(wo, t_b, b_b, ns)
    wo_l = torch.cat([wo_l[:, :2], torch.clamp(wo_l[:, 2:3], min=1e-5)], dim=1)

    lights = scene.lights
    color = mp.emission
    nl = lights.num_lights
    for li in range(nl):
        lt = lights.ltype[li]
        lpos = lights.position[li]
        inten = lights.intensity[li]
        lu = lights.u[li]
        lv = lights.v[li]
        area = lights.area[li]
        radius = lights.radius[li]

        is_dir = lt == 1
        is_spot = lt == 2
        is_quad = lt == 3
        is_sphere = lt == 4
        # QUAD: shade toward the patch center, not the corner record
        lcenter = torch.where(is_quad, lpos + 0.5 * (lu + lv), lpos)
        to_l = lcenter[None, :] - pos
        d2 = torch.clamp(dot(to_l, to_l), min=1e-6)
        wi = torch.where(is_dir, -lu[None, :], to_l / torch.sqrt(d2)[:, None])
        rad = inten[None, :] / d2[:, None]                      # point
        cos_s = -dot(wi, lu[None, :])
        spot_t = torch.clamp(
            (cos_s - lv[1]) / torch.clamp(lv[0] - lv[1], min=1e-6), 0.0, 1.0
        )
        spot_f = spot_t * spot_t * (3.0 - 2.0 * spot_t)
        rad = torch.where(is_spot, rad * spot_f[:, None], rad)
        rad = torch.where(is_dir, inten[None, :], rad)
        n_q = normalize(cross(lu, lv))
        cos_l = torch.clamp(-dot(wi, n_q[None, :]), min=0.0)  # single-sided
        rad = torch.where(
            is_quad, inten[None, :] * (area * cos_l / d2)[:, None], rad
        )
        rad = torch.where(
            is_sphere,
            inten[None, :]
            * torch.clamp(radius * radius / d2, max=1.0)[:, None]
            * math.pi,
            rad,
        )

        wi_l = to_local(wi, t_b, b_b, ns)
        f, _ = bsdf_eval(mp, wo_l, wi_l, w_disney, w_trans)
        cos_i = torch.clamp(wi_l[:, 2], min=0.0)
        color = color + f * rad * cos_i[:, None]
    if nl == 0:
        # headlight fallback so untextured scenes are visible
        ndv = torch.abs(dot(ns, wo))
        color = color + albedo * ndv[:, None]

    background = frag.tri < 0
    clear = torch.tensor(CLEAR_COLOR, dtype=torch.float32, device=color.device)
    color = torch.where(background[:, None], clear[None, :], color)
    return color, albedo, ns, pos


def _raster_setup(scene, camera_index: int, settings: RasterSettings,
                  hooks: RasterHooks | None = None, prim_count=None):
    """Vertex transform + primitive validity shared by the opaque pass
    and the transparency peel passes. Returns (screen, depth, inv_w,
    valid, visible)."""
    profiling.count("raster.triangles", scene.geometry.tri_v0.shape[0])
    ss = settings.msaa
    rw, rh = settings.width * ss, settings.height * ss
    geom = scene.geometry

    view = scene.cameras.view_matrix[camera_index]
    proj = scene.cameras.proj_matrix[camera_index]
    vp = proj @ view

    v0 = geom.tri_v0
    corners = torch.stack([v0, v0 + geom.tri_e1, v0 + geom.tri_e2], dim=1)
    if hooks is not None:
        # pushed vertex/mesh kernel: pre-transform the world-space
        # corners (rz.mesh takes precedence in mesh mode)
        vtx_fn = (
            hooks.mesh
            if (settings.mesh_shader and hooks.mesh is not None)
            else hooks.vertex
        )
        if vtx_fn is not None:
            corners = vtx_fn(corners)
    clip = transform_vertices(corners.reshape(-1, 3), vp).reshape(-1, 3, 4)
    screen, depth, inv_w = clip_to_screen(clip, rw, rh)
    valid = (geom.tri_mat >= 0) & torch.all(clip[..., 3] > 1e-6, dim=-1)
    if prim_count is not None:
        # Indirect work sizing (draw_indirect role,
        # graphics_program.rs:469-643): a device-side count masks
        # primitive validity, with no host read.
        valid = valid & (
            torch.arange(valid.shape[0], device=valid.device) < prim_count
        )

    # Task-shader role: a meshlet is culled when the camera lies inside
    # its backfacing cone (meshopt cone test); a pushed rz.task kernel
    # replaces the test.
    visible = None
    if scene.meshlets is not None:
        ml = scene.meshlets
        eye = scene.cameras.position[camera_index]
        if hooks is not None and hooks.task is not None:
            visible = hooks.task(ml, eye)
        else:
            to_c = ml.center - eye[None, :]
            dist = torch.sqrt(torch.sum(to_c * to_c, dim=-1))
            facing_away = torch.sum(to_c * ml.cone_axis, dim=-1) >= (
                ml.cone_cutoff * dist + ml.radius
            )
            visible = ~facing_away
        vis_ext = torch.cat(
            [visible, torch.ones(1, dtype=torch.bool, device=visible.device)]
        )
        tri_vis = vis_ext[
            torch.where(ml.tri_meshlet >= 0, ml.tri_meshlet, visible.shape[0]).long()
        ]
        valid = valid & tri_vis
    return screen, depth, inv_w, valid, visible


def _transparent_tris(scene):
    """(T,) bool — real triangles whose material has opacity < 1."""
    geom = scene.geometry
    opac = scene.materials.opacity[torch.clamp(geom.tri_mat, min=0).long()]
    return (geom.tri_mat >= 0) & (opac < 1.0)


def _pixel_centres(rw: int, rh: int, device):
    pix = torch.arange(rw * rh, dtype=torch.int32, device=device)
    px = (pix % rw).to(torch.float32) + 0.5
    py = (pix // rw).to(torch.float32) + 0.5
    return px, py


def _peel(settings: RasterSettings, scene) -> bool:
    return (
        scene.materials.has_alpha and settings.peel_layers > 0
        and settings.blend != "none"
    )


@torch.inference_mode()
def gbuffer_pass(scene, camera_index: int, settings: RasterSettings,
                 hooks: RasterHooks | None = None, prim_count=None,
                 tri_mask=None):
    """Visibility pass (deferred first subpass, rz_renderer.rs:1149-1247,
    1455-1570). Returns the FragmentBuffer over the (supersampled)
    image. `tri_mask` restricts the pass to a primitive subset (the
    opaque pass under depth peeling)."""
    ss = settings.msaa
    rw, rh = settings.width * ss, settings.height * ss
    with profiling.span("hala.raster.setup"):
        screen, depth, inv_w, valid, visible = _raster_setup(
            scene, camera_index, settings, hooks, prim_count
        )
    if tri_mask is not None:
        valid = valid & tri_mask

    if (
        settings.mesh_shader
        and scene.meshlets is not None
        and scene.meshlets.tri_ids is not None
    ):
        # meshlets are the binning/draw granularity (draw_mesh_tasks
        # role, rz_renderer.rs:957-962)
        frag, _overflow = rasterize_meshlet_binned(
            screen, depth, inv_w, valid,
            scene.meshlets.tri_ids, visible, rw, rh, tile=settings.tile,
        )
        return frag
    if settings.binned:
        frag, _overflow = rasterize_tiled(
            screen, depth, inv_w, valid, rw, rh,
            tile=settings.tile, k_max=settings.bin_k_max,
        )
        return frag
    px, py = _pixel_centres(rw, rh, screen.device)
    return rasterize(screen, depth, inv_w, valid, px, py, chunk=settings.chunk)


@torch.inference_mode()
def peel_layers_pass(scene, camera_index: int, settings: RasterSettings,
                     hooks: RasterHooks | None = None, prim_count=None):
    """Extract the K nearest transparent layers front to back (depth
    peeling): each pass accepts only fragments strictly farther than the
    last layer. Returns a tuple of K FragmentBuffers (visibility only,
    so relight() re-shades them without re-peeling)."""
    ss = settings.msaa
    rw, rh = settings.width * ss, settings.height * ss
    with profiling.span("hala.raster.setup"):
        screen, dpt, inv_w, valid, _ = _raster_setup(
            scene, camera_index, settings, hooks, prim_count
        )
    t_valid = valid & _transparent_tris(scene)
    px, py = _pixel_centres(rw, rh, screen.device)
    layers = []
    bound = None
    for _ in range(settings.peel_layers):
        fr = rasterize(
            screen, dpt, inv_w, t_valid, px, py,
            chunk=settings.chunk, depth_bound=bound, seam_dedup=True,
        )
        layers.append(fr)
        # Relative margin: along a coplanar quad's diagonal both
        # triangles cover nearby pixel centres with depths an ulp apart;
        # surfaces closer than 1e-5 relative reverse-Z depth merge.
        bound = fr.depth * (1.0 - 1e-5)
    return tuple(layers)


@torch.inference_mode()
def peel_composite_pass(scene, layers, color, opaque_depth, camera_index: int,
                        settings: RasterSettings,
                        hooks: RasterHooks | None = None):
    """Composite peeled transparent layers back to front over the opaque
    color (flat (N,3)) with settings.blend: "over" a*src + (1-a)*dst
    (rz_renderer.rs:490), "additive" src + dst, "premultiplied"
    src + (1-a)*dst; layers not strictly nearer than the opaque depth
    are occluded. Pushed rz.fragment kernels apply to each layer."""
    cam_pos = scene.cameras.position[camera_index]
    geom = scene.geometry
    if settings.blend not in ("over", "additive", "premultiplied"):
        raise HalaRendererError(
            f"unsupported blend operator {settings.blend!r} "
            "(over | additive | premultiplied | none)"
        )
    for fr in reversed(layers):
        lc, la, ln, _ = _shade(scene, fr, cam_pos)
        if hooks is not None and hooks.fragment is not None:
            lc, la, ln = hooks.fragment(lc, la, ln)
        mat = torch.clamp(geom.tri_mat[torch.clamp(fr.tri, min=0).long()], min=0)
        a = scene.materials.opacity[mat.long()][:, None]
        over = ((fr.tri >= 0) & (fr.depth > opaque_depth))[:, None]
        if settings.blend == "additive":
            blended = lc + color
        elif settings.blend == "premultiplied":
            blended = lc + (1.0 - a) * color
        else:
            blended = a * lc + (1.0 - a) * color
        color = torch.where(over, blended, color)
    return color


@torch.inference_mode()
def raster_frame(scene, camera_index: int, settings: RasterSettings,
                 hooks: RasterHooks | None = None, prim_count=None):
    """Forward path: rasterize + shade one frame. Returns (color
    (H,W,3), gbuffer dict with albedo/normal/depth). The deferred path
    (RasterizationRenderer.update) runs gbuffer_pass and lighting_pass
    separately with the same result."""
    h, w = settings.height, settings.width
    ss = settings.msaa
    rw, rh = w * ss, h * ss
    peel = _peel(settings, scene)
    frag = gbuffer_pass(
        scene, camera_index, settings, hooks, prim_count,
        tri_mask=~_transparent_tris(scene) if peel else None,
    )
    cam_pos = scene.cameras.position[camera_index]
    with profiling.span("hala.raster.shade"):
        color, albedo, normal, _ = _shade(scene, frag, cam_pos)
        if hooks is not None and hooks.fragment is not None:
            color, albedo, normal = hooks.fragment(color, albedo, normal)
    if peel:
        layers = peel_layers_pass(scene, camera_index, settings, hooks, prim_count)
        color = peel_composite_pass(
            scene, layers, color, frag.depth, camera_index, settings, hooks,
        )

    def resolve(img_flat, ch):
        img = img_flat.reshape(rh, rw, ch)
        if ss == 1:
            return img
        return img.reshape(h, ss, w, ss, ch).mean(dim=(1, 3))

    with profiling.span("hala.raster.post"):
        gbuffer = {
            "albedo": resolve(albedo, 3),
            "normal": resolve(normal, 3),
            "depth": resolve(frag.depth[:, None], 1)[..., 0],
        }
        return resolve(color, 3), gbuffer


@torch.inference_mode()
def lighting_pass(scene, frag, camera_index: int, settings: RasterSettings,
                  hooks: RasterHooks | None = None):
    """Fullscreen lighting from the cached visibility buffer (deferred
    second subpass, rz_renderer.rs:1249-1338)."""
    h, w = settings.height, settings.width
    cam_pos = scene.cameras.position[camera_index]
    with profiling.span("hala.raster.shade"):
        color, albedo, normal, _ = _shade(scene, frag, cam_pos)
        if hooks is not None and hooks.fragment is not None:
            color, albedo, normal = hooks.fragment(color, albedo, normal)
    return (
        color.reshape(h, w, 3),
        {
            "albedo": albedo.reshape(h, w, 3),
            "normal": normal.reshape(h, w, 3),
            "depth": frag.depth.reshape(h, w),
        },
    )


class RasterizationRenderer(BaseRenderer):
    def __init__(
        self,
        name: str,
        width: int,
        height: int,
        use_mesh_shader: bool = False,
        use_deferred: bool = False,
        msaa: int = 1,
        enable_tonemap: bool = False,
        chunk: int = 512,
        binned: bool = False,
        tile: int = 64,
        bin_k_max: int = 256,
        peel_layers: int = 4,
        blend: str = "over",
        post_program=None,
        device="cuda",
    ):
        super().__init__(name, width, height, resolve_device(device))
        if use_deferred and msaa > 1:
            # rz_renderer.rs:1590: MSAA and deferred are mutually exclusive
            raise HalaRendererError(
                "Multisampling is not supported in deferred rendering."
            )
        if blend not in _BLENDS:
            raise HalaRendererError(
                f"unsupported blend operator {blend!r} "
                "(over | additive | premultiplied | none)"
            )
        self.use_mesh_shader = use_mesh_shader
        self.use_deferred = use_deferred
        self.msaa = msaa
        self.enable_tonemap = enable_tonemap
        self.scene = None
        self._host_scene: Scene | None = None
        self.settings: RasterSettings | None = None
        self._chunk = chunk
        self._binned = binned
        self._tile = tile
        self._bin_k_max = bin_k_max
        self._peel_layers = peel_layers
        self._blend = blend
        # Optional ComputeProgram applied to the shaded color image (the
        # compute post pass).
        self.post_program = post_program
        self.hooks: RasterHooks | None = None
        self.color: torch.Tensor | None = None
        self.gbuffer: dict | None = None
        self.camera_index = 0
        self._frame_count = 0  # frames dispatched, the spans' frame index
        self._frag = None
        self._peel = None

    # -- kernel push API (shader push parity) -----------------------------

    def push_traditional_kernels(self, vertex, fragment) -> None:
        """VS+FS pair (rz_renderer.rs:1829-1860: not in mesh-shader mode)."""
        if self.use_mesh_shader:
            raise HalaRendererError(
                "Traditional shaders require use_mesh_shader=False."
            )
        self._push_kernel("rz.vertex", vertex)
        self._push_kernel("rz.fragment", fragment)

    def push_kernels(self, mesh, fragment, task=None) -> None:
        """task?+mesh+FS set (rz_renderer.rs:1862-1905: mesh-shader mode)."""
        if not self.use_mesh_shader:
            raise HalaRendererError(
                "Mesh-shader kernels require use_mesh_shader=True."
            )
        if task is not None:
            self._push_kernel("rz.task", task)
        self._push_kernel("rz.mesh", mesh)
        self._push_kernel("rz.fragment", fragment)

    def push_compute_kernels(self, fn_or_path) -> None:
        """rz_renderer.rs:1907-1931 push_compute_shaders."""
        self._push_kernel("rz.compute", fn_or_path)

    def _push_kernel(self, name: str, fn_or_path) -> None:
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        if isinstance(fn_or_path, str):
            cache.from_memory(name, cache.load(fn_or_path))
        else:
            cache.from_memory(name, fn_or_path)

    def set_scene(self, scene: Scene) -> None:
        """rz_renderer.rs:1936-1954."""
        self._host_scene = scene
        self.scene = SceneUploader.upload(
            scene,
            use_mesh_shader=self.use_mesh_shader,
            use_global_meshlets=False,
            use_ray_tracing=False,
            device=self.device,
        )
        self._node_world.clear()  # every node at its host transform again

    def commit(self) -> None:
        if self.scene is None:
            raise HalaRendererError("commit() before set_scene().")
        self.settings = RasterSettings(
            width=self.info.width,
            height=self.info.height,
            deferred=self.use_deferred,
            msaa=self.msaa,
            chunk=self._chunk,
            binned=self._binned,
            tile=self._tile,
            bin_k_max=self._bin_k_max,
            mesh_shader=self.use_mesh_shader,
            peel_layers=self._peel_layers,
            blend=self._blend,
        )
        # Resolve pushed rz.* kernels into the frame dispatch table (the
        # pipeline-build step of the reference's commit).
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        hooks = RasterHooks(
            vertex=cache.get("rz.vertex"),
            task=cache.get("rz.task"),
            mesh=cache.get("rz.mesh"),
            fragment=cache.get("rz.fragment"),
        )
        self.hooks = (
            hooks
            if (hooks.vertex or hooks.task or hooks.mesh or hooks.fragment)
            else None
        )

    @torch.inference_mode()
    def update(self, delta_time: float = 0.0, ui_fn=None) -> None:
        """One frame. `ui_fn` is the reference's per-frame UI callback
        (rz_renderer.rs update(..., ui_fn)): a (H, W, 3) -> (H, W, 3)
        tensor function applied after the post pass."""
        if self.settings is None:
            self.commit()
        self.check_and_restore_device()
        t0 = time.monotonic()
        with profiling.span("hala.frame", frame=self._frame_count, renderer="raster"):
            cam = self.camera_index
            if self.settings.deferred:
                # Two-pass deferred pipeline: the visibility buffer is cached
                # so lighting can re-run without re-rasterizing (relight()).
                # Transparent materials stay out of the G-buffer (it cannot
                # blend) and composite from cached peel layers after lighting.
                peel = _peel(self.settings, self.scene)
                self._frag = gbuffer_pass(
                    self.scene, cam, self.settings, self.hooks,
                    tri_mask=~_transparent_tris(self.scene) if peel else None,
                )
                self._peel = (
                    peel_layers_pass(self.scene, cam, self.settings, self.hooks)
                    if peel else None
                )
                color, gbuffer = lighting_pass(
                    self.scene, self._frag, cam, self.settings, self.hooks,
                )
                color = self._composite_peel(color)
            else:
                color, gbuffer = raster_frame(
                    self.scene, cam, self.settings, self.hooks,
                )
            self._finish(color, gbuffer, ui_fn)
        self._pending_frame = self._frame_count
        self._frame_count += 1
        self._last_cpu_time = time.monotonic() - t0

    def _finish(self, color, gbuffer, ui_fn=None) -> None:
        with profiling.span("hala.raster.post"):
            if self.post_program is not None:
                color = self.post_program.dispatch(color)
            if ui_fn is not None:
                color = ui_fn(color)
        self._pending = True
        self.color = color
        self.gbuffer = gbuffer

    @torch.inference_mode()
    def relight(self) -> None:
        """Deferred-only: re-run the lighting pass on the cached
        visibility buffer without re-rasterizing (e.g. light changes
        with static geometry)."""
        if not (self.settings and self.settings.deferred):
            raise HalaRendererError("relight() requires deferred mode.")
        if self._frag is None:
            raise HalaRendererError("relight() before update().")
        color, gbuffer = lighting_pass(
            self.scene, self._frag, self.camera_index, self.settings,
            self.hooks,
        )
        self._finish(self._composite_peel(color), gbuffer)

    def _composite_peel(self, color):
        """Blend the cached transparency layers (deferred path) over the
        lit color."""
        if self._peel is None:
            return color
        h, w, _ = color.shape
        flat = peel_composite_pass(
            self.scene, self._peel, color.reshape(-1, 3), self._frag.depth,
            self.camera_index, self.settings, self.hooks,
        )
        return flat.reshape(h, w, 3)

    @torch.inference_mode()
    def get_final_image(self) -> np.ndarray:
        self.wait_idle()
        img = self.color
        if self.enable_tonemap:
            img = apply_tonemap(img, True, True, True)
        return img.cpu().numpy()

    def save_image(self, path: str) -> None:
        if self.is_device_lost:
            logger.warning(
                "The device is lost! Please wait to reset the device and "
                "try again."
            )
            return
        write_pfm(path, self.get_final_image())

    def _restore_device_state(self) -> None:
        """Re-upload the scene after a device error and re-apply the node
        moves (see RayTracingRenderer._restore_device_state)."""
        self._frag = None
        self._peel = None
        if self._host_scene is not None:
            self._upload_moved()
