"""Path-tracing integrator core: the port of the JAX package's
`models/integrator.py` to plain functions on tensors.

Honored algorithm parameters (SURVEY.md section 2.2): max bounce depth
and Russian-roulette start depth (rt_renderer.rs:572-573),
frame-index-seeded progressive accumulation (rt_renderer.rs:408-427),
NEE over the analytic lights and the HDR environment map with MIS,
blue-noise sampling, DOF camera, two-sided shading
with Oren-Nayar / Disney BSDF dispatch (textures, normal maps, UV
transforms, transmission), alpha any-hit surfaces, absorbing,
scattering and emissive media, and albedo/normal AOVs on first hit.

Rays are flat (N,) SoA batches. The film is traced in tiles of
`settings.tile_size` rays; the JAX package's `lax.scan` over tiles and
`fori_loop` over bounces are Python loops here, and the film is updated
in place. Every pixel's samples come from PCG4D keyed on its global
pixel id, so results do not depend on tiling.

Procedural spheres (ops/prims.py) join every closest-hit and any-hit
query after the triangle backend. Pushed kernels (`KernelHooks`) override
the integrator's seams. Not ported yet (each raises HalaRendererError
when requested): the geometry-sharded `scene_axis` mode and the "bvh"
engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..error import HalaRendererError
from ..ops import rng
from ..ops.bsdf import bsdf_eval, bsdf_sample, gather_materials
from ..ops.camera import generate_rays
from ..ops.cluster import intersect_clustered
from ..ops.compaction import order_by, permute
from ..ops.env import env_eval, env_sample, sky_radiance
from ..ops.intersect import (
    T_MAX,
    Hit,
    full_t_max,
    intersect_bruteforce,
    occluded_bruteforce,
)
from ..ops.lights import intersect_lights, sample_one_light
from ..ops.pallas.intersect_kernel import intersect_pallas, occluded_pallas
from ..ops.prims import PROC_BASE, merge_procedural, occluded_spheres
from ..ops.sampling import (
    build_basis,
    cross,
    dot,
    normalize,
    power_heuristic,
    sample_henyey_greenstein,
    to_local,
    to_world,
)
from ..ops.texture import sample_textures_packed
from ..ops.cull import _ID_MASK as _CULL_ID_MASK
from ..ops.traverse import (
    MATRIX_MAX_CLUSTERS,
    _coherence_key,
    intersect_grouped,
    intersect_matrix,
    intersect_traversed,
    matrix_query,
)
from ..ops.wavefront import intersect_wavefront
from ..scene.gpu.scene import TensorTables, resolve_device

ENV_SKY = 0  # rt_renderer.rs:23-41 HalaEnvType
ENV_MAP = 1

_RAY_EPS = 1e-4
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Integrator configuration.

    `intersector` selects the visibility backend; "auto" resolves per
    scene in `_backend`. Explicit values: "pallas" (the brute-force
    kernel, csrc/intersect_bruteforce.cu), "matrix" (the cluster
    traversal kernel, csrc/matrix_traverse.cu), "grouped" (per-group
    candidate lists walked by csrc/grouped_walk.cu), "wavefront" (the
    cull csrc/cull_topk.cu and merged per-group lists walked by
    csrc/wavefront_walk.cu; both fall back to the matrix kernel for
    rays their lists truncate), "traverse" (the cull, the candidate
    walk csrc/traverse_candidates.cu and the exact fallback
    csrc/cluster_stream.cu), "cluster" (csrc/cluster_stream.cu alone)
    and "bruteforce" (the chunked plain PyTorch scan, the ground truth).
    "auto" never picks "grouped" or "wavefront". "bvh" is not ported
    yet and raises.

    `sort_rays` runs every large-scene query under a coherence sort
    (`matrix_query` for the matrix family, ops/compaction.py for
    "traverse" and "cluster"). `traverse_k` bounds the "traverse"
    candidate lists, `wavefront_k` the wavefront's per-ray lists (both
    at most 16) and `wavefront_m` its per-group merged lists (at most
    32).

    On a matrix-family backend, `shadow_intersector="wavefront"` sends
    the shadow rays' any-hit query to the wavefront with
    `shadow_wavefront_k` candidates per ray, and
    `extend_intersector="wavefront"` the bounce rays' closest-hit query
    with `extend_wavefront_k` (where the shadow rays have a query of
    their own, that is without alpha materials); "auto" and "matrix"
    leave both with the backend.

    `tile_size` defaults to 2^20 rays (the JAX package: 65536): on the
    GPU a tile's time is dominated by per-operation launch cost well
    below that size, and 2^20 rays keep peak memory near 1 GB.
    """

    width: int
    height: int
    max_depth: int = 4
    rr_depth: int = 2
    env_type: int = ENV_SKY
    tile_size: int = 1 << 20
    chunk: int = 2048  # brute-force triangle chunk
    intersector: str = "auto"
    # Max alpha-tested surfaces a shadow ray may stochastically pass.
    shadow_surfaces: int = 3
    # Samples per progressive frame, sample-adjacent; sample s of frame
    # f uses virtual RNG frame f*spp+s.
    spp: int = 1
    # Geometry-sharded rendering: not ported yet (must stay None).
    scene_axis: str | None = None
    sort_rays: bool = True
    traverse_k: int = 12
    wavefront_k: int = 16
    wavefront_m: int = 32
    shadow_intersector: str = "auto"
    shadow_wavefront_k: int = 8
    extend_intersector: str = "auto"
    extend_wavefront_k: int = 8


@dataclasses.dataclass
class Uniforms(TensorTables):
    """Per-frame values (HalaGlobalUniform parity, rt_renderer.rs:44-65),
    as tensors on the render device. env_rotation is pre-normalized by
    /360 (rt_renderer.rs:420)."""

    ground_color: torch.Tensor    # (3,)
    sky_color: torch.Tensor       # (3,)
    env_intensity: torch.Tensor   # ()
    env_rotation: torch.Tensor    # ()
    exposure_value: torch.Tensor  # ()
    camera_index: int = 0

    @staticmethod
    def default(device="cuda") -> "Uniforms":
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        return Uniforms(
            ground_color=f32([0.5, 0.5, 0.5]),
            sky_color=f32([0.5, 0.7, 0.9]),
            env_intensity=f32(1.0),
            env_rotation=f32(0.0),
            exposure_value=f32(1.0),
        )


@dataclasses.dataclass
class Film(TensorTables):
    """Accumulation + AOV images (the storage images of
    rt_renderer.rs:818-917). `render_frame` updates them in place."""

    accum: torch.Tensor   # (H, W, 4) running mean radiance
    albedo: torch.Tensor  # (H, W, 4)
    normal: torch.Tensor  # (H, W, 4)

    @staticmethod
    def create(width: int, height: int, device="cuda") -> "Film":
        dev = resolve_device(device)

        def z():
            return torch.zeros((height, width, 4), dtype=torch.float32, device=dev)

        return Film(accum=z(), albedo=z(), normal=z())


@dataclasses.dataclass(frozen=True)
class KernelHooks:
    """Pushed kernels, each overriding one seam of the integrator (the
    JAX package's KernelHooks; rt_renderer.rs:925-1112 shader push).
    Each is a plain callable on tensors of the shapes the built-in stage
    uses; None keeps the built-in stage:

    - raygen(gpix, frame_index, r_jit) -> (N, 4): the per-pixel sample
      jitter (pixel xy in [:, :2], lens uv in [:, 2:]) before camera ray
      generation;
    - miss(d, uniforms, default_radiance) -> (N, 3): radiance of rays
      that leave the scene;
    - post_shade(radiance, albedo, normal) -> the same triple: a traced
      tile's outputs before film accumulation;
    - closest_hit(ctx, mp) -> mp: the resolved material parameters at
      the shading point (ctx: dict of p, ns, ng, uv, wo, t, tri, mat,
      on_surface), before every BSDF and NEE consumer;
    - any_hit(ctx, mp, r, default_pass) -> (N,) bool: the stochastic
      pass-through decision (True ignores the hit) given the lane's
      random draw and the built-in alpha test;
    - intersection(o, d, lhit) -> lhit: custom primitives merged into
      the analytic light-set hit (fields t, radiance, pdf); a closer
      such hit ends the path with its radiance.
    """

    raygen: object = None
    miss: object = None
    post_shade: object = None
    closest_hit: object = None
    any_hit: object = None
    intersection: object = None


_BACKENDS = ("auto", "pallas", "matrix", "grouped", "wavefront", "traverse",
             "cluster", "bruteforce")
_MATRIX_FAMILY = ("wavefront", "matrix", "grouped")
_NOT_PORTED = ("bvh", "legacy")


def _backend(settings: RenderSettings, scene) -> str:
    """Resolve the visibility backend. "auto": scenes of at most 4096
    triangles on the prefix (Morton) layout go to the brute-force
    kernel, larger ones of at most MATRIX_MAX_CLUSTERS clusters to the
    cluster traversal, and larger still (the 13-bit key width of K2) to
    the candidate traversal. The same rule holds on every device: for
    CPU tensors the kernels' wrappers run their plain versions."""
    sel = settings.intersector
    if sel in _NOT_PORTED:
        raise HalaRendererError(f"intersector {sel!r} is not yet ported")
    if sel not in _BACKENDS:
        raise ValueError(
            f"Unknown intersector {sel!r}; expected one of {_BACKENDS}"
        )
    if sel != "auto":
        return sel
    g = scene.geometry
    if g.num_triangles <= 4096 and g.prefix_layout:
        return "pallas"
    if g.tri_packed.shape[0] <= MATRIX_MAX_CLUSTERS:
        return "matrix"
    return "traverse"


def _num_real(g) -> int:
    # The prefix trim is valid only for the Morton tail-padded layout;
    # the SAH layout has interior padding, so every slot is scanned.
    return g.num_triangles if g.prefix_layout else g.tri_v0.shape[0]


def _sorted_dispatch(scene, o, d, t_max, query) -> Hit:
    """Run `query(o, d, t_max) -> Hit` under the coherence sort
    (ops/compaction.py) and undo the permutation."""
    g = scene.geometry
    tm = full_t_max(t_max, o.shape[0], o.device)
    order, inverse = order_by(
        _coherence_key(o, d, tm, g.cluster_min, g.cluster_max))
    hit = query(*permute(order, o, d, tm))
    return Hit(*(permute(inverse, x) for x in hit))


def _wavefront_route(settings: RenderSettings, scene, choice: str) -> bool:
    """A ray class routes to the wavefront only on an explicit
    "wavefront" for it, a matrix-family backend and a cluster count
    inside the cull's key width; "auto" never does."""
    return (
        choice == "wavefront"
        and _backend(settings, scene) in _MATRIX_FAMILY
        and scene.geometry.tri_packed.shape[0] < _CULL_ID_MASK
    )


def _shadow_wavefront_route(settings: RenderSettings, scene) -> bool:
    """True iff shadow-class queries route to the any-hit wavefront."""
    return _wavefront_route(settings, scene, settings.shadow_intersector)


def _extend_wavefront_route(settings: RenderSettings, scene) -> bool:
    """True iff extend-class (closest-hit bounce ray) queries route to
    the wavefront."""
    return _wavefront_route(settings, scene, settings.extend_intersector)


def _matrix_family(scene, o, d, t_max, any_hit: bool,
                   settings: RenderSettings) -> Hit:
    """One query of a matrix-family backend: under `matrix_query`'s
    coherence sort, or the engine alone with sort_rays off."""
    g = scene.geometry
    backend = _backend(settings, scene)
    if settings.sort_rays:
        return matrix_query(
            o, d, g, t_max=t_max, any_hit=any_hit, kernel=backend,
            wavefront_k=settings.wavefront_k, wavefront_m=settings.wavefront_m,
        )
    if backend == "wavefront":
        return intersect_wavefront(
            o, d, g, t_max=t_max, any_hit=any_hit,
            k_per_ray=settings.wavefront_k, m_group=settings.wavefront_m,
        )
    if backend == "grouped":
        return intersect_grouped(o, d, g, t_max=t_max, any_hit=any_hit)
    return intersect_matrix(o, d, g, t_max=t_max, any_hit=any_hit)


def _merge_proc(scene, o, d, hit: Hit, t_max) -> Hit:
    """Fold the procedural spheres' hits into a triangle Hit (ops/prims.py;
    ids at tri >= PROC_BASE)."""
    if scene.procedural is None:
        return hit
    return merge_procedural(scene.procedural, o, d, hit, t_max)


def _intersect(scene, o, d, settings: RenderSettings, t_max=None,
               extend: bool = False) -> Hit:
    """Closest-hit dispatch: the triangle backend's query, then the
    procedural spheres. `extend` marks a bounce rays' query, which
    `extend_intersector` may send to the wavefront."""
    return _merge_proc(scene, o, d, _intersect_local(scene, o, d, settings, t_max,
                                                     extend), t_max)


def _intersect_local(scene, o, d, settings: RenderSettings, t_max=None,
                     extend: bool = False) -> Hit:
    """The triangle backend's closest-hit query."""
    g = scene.geometry
    backend = _backend(settings, scene)
    o, d = o.contiguous(), d.contiguous()
    if backend in _MATRIX_FAMILY:
        if extend and _extend_wavefront_route(settings, scene):
            return intersect_wavefront(
                o, d, g, t_max=t_max, k_per_ray=settings.extend_wavefront_k,
                m_group=settings.wavefront_m,
            )
        return _matrix_family(scene, o, d, t_max, False, settings)
    if backend in ("traverse", "cluster"):
        if backend == "traverse":
            def query(o_q, d_q, t_q):
                return intersect_traversed(o_q, d_q, g, t_max=t_q,
                                           k_per_ray=settings.traverse_k)
        else:
            def query(o_q, d_q, t_q):
                return intersect_clustered(o_q, d_q, g, t_max=t_q)
        if settings.sort_rays:
            return _sorted_dispatch(scene, o, d, t_max, query)
        return query(o, d, full_t_max(t_max, o.shape[0], o.device))
    if backend == "pallas":
        return intersect_pallas(
            o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=t_max,
            num_real=_num_real(g),
        )
    return intersect_bruteforce(
        o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=t_max, chunk=settings.chunk
    )


def _occluded(scene, o, d, t_far, settings: RenderSettings) -> torch.Tensor:
    """Any-hit dispatch: True where a triangle lies in
    (1e-4, t_far * (1 - 1e-4)) or a procedural sphere in (1e-4, t_far)."""
    occ = _occluded_local(scene, o, d, t_far, settings)
    if scene.procedural is not None:
        occ = occ | occluded_spheres(scene.procedural, o, d, t_far)
    return occ


def _occluded_local(scene, o, d, t_far, settings: RenderSettings) -> torch.Tensor:
    """The triangle backend's any-hit query."""
    g = scene.geometry
    backend = _backend(settings, scene)
    o, d = o.contiguous(), d.contiguous()
    if backend in _MATRIX_FAMILY:
        tf = t_far * (1.0 - 1e-4)
        if _shadow_wavefront_route(settings, scene) or (
                backend == "wavefront" and not settings.sort_rays):
            # shadow segments are short: their own, smaller K
            return intersect_wavefront(
                o, d, g, t_max=tf, any_hit=True,
                k_per_ray=settings.shadow_wavefront_k,
                m_group=settings.wavefront_m,
            ).tri >= 0
        return _matrix_family(scene, o, d, tf, True, settings).tri >= 0
    if backend in ("traverse", "cluster"):
        return _intersect_local(scene, o, d, settings,
                                t_max=t_far * (1.0 - 1e-4)).tri >= 0
    if backend == "pallas":
        return occluded_pallas(
            o, d, t_far, g.tri_v0, g.tri_e1, g.tri_e2, num_real=_num_real(g)
        )
    return occluded_bruteforce(
        o, d, t_far, g.tri_v0, g.tri_e1, g.tri_e2, chunk=settings.chunk
    )


def _check_ported(settings: RenderSettings) -> None:
    if settings.scene_axis is not None:
        raise HalaRendererError("geometry-sharded rendering is not yet ported")


def _path_context(
    scene,
    env,
    uniforms: Uniforms,
    pixel_idx: torch.Tensor,
    frame_index,
    settings: RenderSettings,
    full_height: int | None = None,
    blue_noise=None,
    hooks: KernelHooks | None = None,
):
    """Build the per-trace path-tracing closures.

    Returns (init_state, bounce_body): `bounce_body(bounce, state)`
    runs one bounce — shading at the current hit, NEE, BSDF sampling,
    Russian roulette, then ONE batched visibility query for the next
    extension ray (and, unless split into an any-hit query, the shadow
    rays) — exactly as the JAX package's bounce_pre/bounce_post pair.
    """
    geom = scene.geometry
    has_env_map = settings.env_type == ENV_MAP and env is not None

    if blue_noise is None:
        def s4(bounce, seed):
            return rng.sample4(pixel_idx, frame_index, bounce, seed=seed)
    else:
        # Blue-noise sampling for every dimension: a per-pixel texel
        # plus a per-(frame, bounce, stream) Cranley-Patterson rotation.
        # Screen coordinates come from the global pixel id.
        bn_px = pixel_idx % settings.width
        bn_py = pixel_idx // settings.width

        def s4(bounce, seed):
            return rng.bn_sample4(blue_noise, bn_px, bn_py, frame_index,
                                  bounce, seed)

    # Scene capability specialization: unused BSDF lobes are skipped.
    w_disney = bool(scene.materials.has_disney)
    w_trans = bool(scene.materials.has_transmission)
    w_scatter = bool(scene.materials.has_scatter_medium)
    # Large scenes split the shadow rays into an ANY-HIT query when no
    # alpha material needs stochastic pass-through.
    split_shadow = (
        not scene.materials.has_alpha
        and _backend(settings, scene) in _MATRIX_FAMILY
    )

    # Per-pixel cone angle for mip LOD (texture footprint ~ dist * angle).
    cam_yfov = scene.cameras.yfov[uniforms.camera_index]
    fh = full_height if full_height is not None else settings.height
    pixel_angle = 2.0 * torch.tan(0.5 * torch.clamp(cam_yfov, min=1e-3)) / fh

    def init_state(o, d, hit0):
        zeros3 = torch.zeros_like(o)
        zeros = zeros3[:, 0]
        return dict(
            o=o,
            d=d,
            hit_t=hit0.t,
            hit_tri=hit0.tri,
            hit_u=hit0.u,
            hit_v=hit0.v,
            throughput=zeros3 + 1.0,
            radiance=zeros3,
            active=zeros < 1.0,
            prev_pdf=zeros,  # 0 => previous bounce was camera/delta
            albedo=zeros3,
            normal=zeros3,
            rays=zeros + 1.0,  # the primary ray
            path_dist=zeros,   # accumulated path length (mip LOD cone)
            med_density=zeros,     # >0 while inside a SCATTER medium
            med_g=zeros,           # phase anisotropy of the current medium
            med_color=zeros3,      # single-scatter albedo
        )

    def bounce_pre(bounce, st):
        o, d = st["o"], st["d"]
        zeros3 = torch.zeros_like(o)
        zeros = zeros3[:, 0]
        active = st["active"]
        throughput = st["throughput"]
        radiance = st["radiance"]
        prev_pdf = st["prev_pdf"]
        rays = st["rays"]

        hit = Hit(t=st["hit_t"], tri=st["hit_tri"], u=st["hit_u"], v=st["hit_v"])
        lhit = intersect_lights(scene.lights, o, d)
        if hooks is not None and hooks.intersection is not None:
            # intersection seam: custom primitives join the light-set hit
            lhit = hooks.intersection(o, d, lhit)

        # --- SCATTER media: free-flight distance sampling ----------------
        if w_scatter:
            r_med = s4(bounce, 29)
            med_density = st["med_density"]
            t_free = -torch.log(torch.clamp(1.0 - r_med[:, 0], min=1e-7)) / (
                torch.clamp(med_density, min=1e-7)
            )
            scatter = active & (med_density > 0.0) & (t_free < hit.t)
            effective_t = torch.where(scatter, t_free, hit.t)
        else:
            scatter = zeros > 1.0
            effective_t = hit.t

        light_first = lhit.t < effective_t
        # --- emissive light hit (MIS vs the NEE strategy) ---------------
        w_light = torch.where(
            prev_pdf > 0.0, power_heuristic(prev_pdf, lhit.pdf), 1.0
        )
        radiance = radiance + torch.where(
            (active & light_first)[:, None],
            throughput * lhit.radiance * w_light[:, None],
            0.0,
        )

        # --- miss: environment (not if the ray scattered first) ----------
        miss = (hit.tri < 0) & ~scatter
        if has_env_map:
            # one direction -> equirect transform for radiance and pdf
            env_rad, pdf_e = env_eval(
                env, d, uniforms.env_rotation, uniforms.env_intensity
            )
            w_env = torch.where(
                prev_pdf > 0.0, power_heuristic(prev_pdf, pdf_e), 1.0
            )
        else:
            env_rad = (
                sky_radiance(
                    d, uniforms.ground_color[None, :], uniforms.sky_color[None, :]
                )
                * uniforms.env_intensity
            )
            w_env = torch.ones_like(zeros)
        if hooks is not None and hooks.miss is not None:
            env_rad = hooks.miss(d, uniforms, env_rad)
        radiance = radiance + torch.where(
            (active & miss & ~light_first)[:, None],
            throughput * env_rad * w_env[:, None],
            0.0,
        )

        active = active & ~miss & ~light_first
        on_surface = active & ~scatter

        # --- shading point ----------------------------------------------
        # procedural ids clip to the last row (overridden below): on the
        # card an out-of-range gather is a device assert
        tid = torch.clamp(hit.tri, 0, geom.shade_table.shape[0] - 1).long()
        u, v = hit.u, hit.v
        w0 = 1.0 - u - v
        rows = geom.shade_table[tid]
        ns = normalize(
            w0[:, None] * rows[:, 0:3]
            + u[:, None] * rows[:, 3:6]
            + v[:, None] * rows[:, 6:9]
        )
        uv = (
            w0[:, None] * rows[:, 9:11]
            + u[:, None] * rows[:, 11:13]
            + v[:, None] * rows[:, 13:15]
        )
        ng = rows[:, 15:18]
        # orient geometric normal along shading normal
        ng = torch.where((dot(ng, ns) < 0)[:, None], -ng, ng)
        hit_p = o + hit.t[:, None] * d

        mat_idx = rows[:, 18].to(torch.int32)
        # Procedural sphere hits (tri >= PROC_BASE, ops/prims.py): the
        # analytic attributes replace the clipped triangle row's; hit.u/v
        # carry the spherical uv.
        is_proc = prow = None
        if scene.procedural is not None:
            is_proc = hit.tri >= PROC_BASE
            pid = torch.clamp(hit.tri - PROC_BASE, 0,
                              scene.procedural.center.shape[0] - 1).long()
            prow = scene.procedural.packed[pid]
            ns_p = normalize(hit_p - prow[:, 0:3])
            ns = torch.where(is_proc[:, None], ns_p, ns)
            ng = torch.where(is_proc[:, None], ns_p, ng)
            uv = torch.where(is_proc[:, None], torch.stack([u, v], dim=1), uv)
            mat_idx = torch.where(is_proc, prow[:, 4].to(torch.int32), mat_idx)
        mp = gather_materials(scene.materials, mat_idx)
        # Vertex colors (COLOR_0) widen the shade row to 48 columns.
        if rows.shape[1] > 32:
            vcol = (
                w0[:, None] * rows[:, 32:35]
                + u[:, None] * rows[:, 35:38]
                + v[:, None] * rows[:, 38:41]
            )
            if is_proc is not None:
                vcol = torch.where(is_proc[:, None], 1.0, vcol)
            mp = mp._replace(base_color=mp.base_color * vcol)
        # KHR_texture_transform: uv' = offset + R(rot) @ (scale * uv).
        if scene.materials.has_uv_transform:
            uvt = scene.materials.uv_transform[torch.clamp(mat_idx, min=0).long()]
            su = uv[:, 0] * uvt[:, 3]
            sv = uv[:, 1] * uvt[:, 4]
            cr = torch.cos(uvt[:, 2])
            sr = torch.sin(uvt[:, 2])
            uv = torch.stack(
                [uvt[:, 0] + cr * su + sr * sv, uvt[:, 1] - sr * su + cr * sv],
                dim=1,
            )
        path_dist = st["path_dist"] + effective_t * active.to(torch.float32)

        # Interpolated tangent, Gram-Schmidt-orthonormalized against ns.
        tan_raw = (
            w0[:, None] * rows[:, 20:23]
            + u[:, None] * rows[:, 23:26]
            + v[:, None] * rows[:, 26:29]
        )
        if is_proc is not None:
            # spheres carry no tangents: zero takes the fallback basis
            tan_raw = torch.where(is_proc[:, None], 0.0, tan_raw)
        tan_proj = tan_raw - ns * dot(tan_raw, ns)[:, None]
        tan_len = torch.sqrt(dot(tan_proj, tan_proj))[:, None]
        has_tan = tan_len[:, 0] > 1e-4

        # Material maps: base/mr/emission at the trilinear lod, plus the
        # normal map at level 0 when present.
        base_t = mr_t = em_t = n_tex = None
        if scene.textures is not None:
            uv_dens = rows[:, 29]
            if is_proc is not None:
                # ~1 / (2 pi r) texels per world unit at the equator
                uv_dens = torch.where(
                    is_proc, 1.0 / torch.clamp(2.0 * np.pi * prow[:, 3], min=1e-6),
                    uv_dens)
            lod_uv = torch.log2(
                torch.clamp(path_dist * pixel_angle * uv_dens, 1e-6, 1e6)
            )
            maps = [
                mp.base_color_map, mp.metallic_roughness_map, mp.emission_map,
            ]
            map_lods = [lod_uv, lod_uv, lod_uv]
            if scene.materials.has_normal_map:
                maps.append(mp.normal_map)
                map_lods.append(None)
            fetched = sample_textures_packed(
                scene.textures, maps, uv, lods=map_lods
            )
            base_t, mr_t, em_t = fetched[:3]
            if scene.materials.has_normal_map:
                n_tex = fetched[3]

        # Normal mapping (material normal_map, tangent-space +Z up).
        if scene.textures is not None and scene.materials.has_normal_map:
            n_t = n_tex[:, :3]
            n_ts = normalize(n_t * 2.0 - 1.0)
            tb0 = torch.where(
                has_tan[:, None], tan_proj / torch.clamp(tan_len, min=1e-12), 0.0
            )
            bt0 = cross(ns, tb0)
            mapped = normalize(
                n_ts[:, 0:1] * tb0 + n_ts[:, 1:2] * bt0 + n_ts[:, 2:3] * ns
            )
            use_map = has_tan & (mp.normal_map >= 0)
            ns = torch.where(use_map[:, None], mapped, ns)

        entering = dot(ns, -d) >= 0.0
        ns_f = torch.where(entering[:, None], ns, -ns)  # two-sided frame
        ng_f = torch.where(entering[:, None], ng, -ng)
        # UV-aligned tangent frame where a valid tangent exists;
        # branchless fallback basis otherwise.
        t_fb, b_fb = build_basis(ns_f)
        tan_f = tan_raw - ns_f * dot(tan_raw, ns_f)[:, None]
        tan_fl = torch.sqrt(dot(tan_f, tan_f))[:, None]
        has_tan_f = tan_fl[:, 0] > 1e-4
        t_b = torch.where(
            has_tan_f[:, None], tan_f / torch.clamp(tan_fl, min=1e-12), t_fb
        )
        b_b = torch.where(has_tan_f[:, None], cross(ns_f, t_b), b_fb)
        wo_l = to_local(-d, t_b, b_b, ns_f)
        wo_l = torch.cat(
            [wo_l[:, :2], torch.clamp(wo_l[:, 2:3], min=1e-5)], dim=1
        )
        if scene.textures is not None:
            mr_map = mp.metallic_roughness_map
            new_rough_raw = mr_t[:, 1]  # glTF: G=roughness, B=metallic
            new_metal = mp.metallic * mr_t[:, 2]
            # re-apply the Disney alpha precompute for textured roughness
            has_mr = mr_map >= 0
            alpha = torch.clamp(new_rough_raw ** 2, 1e-4, 1.0)
            mp = mp._replace(
                base_color=mp.base_color * base_t[:, :3],
                emission=mp.emission * em_t[:, :3],
                metallic=torch.where(has_mr, new_metal, mp.metallic),
                roughness=torch.where(has_mr, alpha, mp.roughness),
                ax=torch.where(has_mr, torch.clamp(alpha, min=1e-3), mp.ax),
                ay=torch.where(has_mr, torch.clamp(alpha, min=1e-3), mp.ay),
            )
        # refraction relative ior: entering -> ior, exiting -> 1/ior
        mp = mp._replace(
            ior=torch.where(
                entering, mp.ior, 1.0 / torch.clamp(mp.ior, min=1e-3)
            )
        )

        hit_ctx = None
        if hooks is not None and (
            hooks.closest_hit is not None or hooks.any_hit is not None
        ):
            hit_ctx = dict(p=hit_p, ns=ns_f, ng=ng_f, uv=uv, wo=-d, t=hit.t,
                           tri=hit.tri, mat=mat_idx, on_surface=on_surface)
        if hooks is not None and hooks.closest_hit is not None:
            # closest-hit seam: the material parameters every BSDF and
            # NEE consumer below reads
            mp = hooks.closest_hit(hit_ctx, mp)

        # Beer-Lambert absorption: a backface hit means the segment just
        # traversed was interior.
        if scene.materials.has_absorb_medium:
            interior = (~entering) & on_surface
            atten = torch.exp(-mp.medium_sigma * hit.t[:, None])
            throughput = torch.where(
                interior[:, None], throughput * atten, throughput
            )

        # EMISSIVE medium: L += throughput * color * density * length
        # along interior segments (optically thin).
        safe_mat = torch.clamp(mat_idx, min=0).long()
        if scene.materials.has_emissive_medium:
            em_medium = scene.materials.medium_type[safe_mat] == 3
            em_color = scene.materials.medium_color[safe_mat]
            em_density = scene.materials.medium_density[safe_mat]
            interior_e = (~entering) & on_surface & em_medium
            radiance = radiance + torch.where(
                interior_e[:, None],
                throughput * em_color * (em_density * hit.t)[:, None],
                0.0,
            )

        # --- AOVs on first hit ------------------------------------------
        if bounce == 0:
            st_albedo = torch.where(
                on_surface[:, None], mp.base_color, st["albedo"]
            )
            st_normal = torch.where(on_surface[:, None], ns, st["normal"])
        else:
            st_albedo, st_normal = st["albedo"], st["normal"]

        # --- surface emission (no NEE over emissive triangles) ----------
        radiance = radiance + torch.where(
            on_surface[:, None], throughput * mp.emission, 0.0
        )

        # --- opacity stochastic pass-through ----------------------------
        # One RNG call serves the alpha test ([0]) and Russian roulette
        # ([1]); [2]/[3] seed the shadow transmittance.
        r_alpha = s4(bounce, 11)
        default_pass = r_alpha[:, 0] > mp.opacity
        if hooks is not None and hooks.any_hit is not None:
            # any-hit seam: True ignores this hit and continues the ray
            default_pass = hooks.any_hit(hit_ctx, mp, r_alpha[:, 0], default_pass)
        pass_through = on_surface & default_pass

        # --- NEE: analytic lights (occlusion deferred to the batched
        # visibility query) -----------------------------------------------
        r_nee = s4(bounce, 13)
        shadow_o = hit_p + ng_f * _RAY_EPS
        if scene.lights.num_lights > 0:
            ls = sample_one_light(scene.lights, hit_p, r_nee[:, :3])
            wi_l = to_local(ls.wi, t_b, b_b, ns_f)
            f_l, pdf_b = bsdf_eval(mp, wo_l, wi_l, w_disney, w_trans)
            cos_l = torch.abs(wi_l[:, 2])
            candidate = (
                on_surface & ~pass_through & (ls.pdf > 0) & (cos_l > 1e-6)
            )
            w_mis = torch.where(
                ls.is_delta, 1.0, power_heuristic(ls.pdf, pdf_b)
            )
            nee_contrib = (
                throughput
                * f_l
                * (cos_l / torch.clamp(ls.pdf, min=1e-12) * w_mis)[:, None]
                * ls.radiance
            )
            nee_dir = ls.wi
            nee_tmax = torch.where(candidate, ls.dist * (1.0 - 1e-4), 0.0)
        else:
            candidate = zeros > 1.0
            nee_contrib = zeros3
            nee_dir = ns_f
            nee_tmax = zeros

        # --- NEE: environment map (occlusion deferred likewise) ---------
        env_carry = {}
        if has_env_map:
            r_env = s4(bounce, 17)
            wi_e, rad_e, pdf_e = env_sample(
                env, r_env[:, :2], uniforms.env_rotation, uniforms.env_intensity
            )
            wi_el = to_local(wi_e, t_b, b_b, ns_f)
            f_e, pdf_be = bsdf_eval(mp, wo_l, wi_el, w_disney, w_trans)
            cos_e = torch.abs(wi_el[:, 2])
            cand_e = on_surface & ~pass_through & (pdf_e > 0) & (cos_e > 1e-6)
            w_mis_e = power_heuristic(pdf_e, pdf_be)
            env_contrib = (
                throughput
                * f_e
                * (cos_e / torch.clamp(pdf_e, min=1e-12) * w_mis_e)[:, None]
                * rad_e
            )
            env_carry = dict(
                cand_e=cand_e, env_contrib=env_contrib, wi_e=wi_e,
                env_tmax=torch.where(cand_e, 1.0e7, 0.0),
            )

        # --- BSDF sampling / continuation -------------------------------
        r_bsdf = s4(bounce, 19)
        wi_s, f_s, pdf_s = bsdf_sample(mp, wo_l, r_bsdf, w_disney, w_trans)
        wi_w = to_world(wi_s, t_b, b_b, ns_f)
        cos_s = torch.abs(wi_s[:, 2])
        valid_s = pdf_s > 1e-9
        new_tp = throughput * f_s * (cos_s / torch.clamp(pdf_s, min=1e-9))[:, None]

        # pass-through overrides the BSDF continuation
        next_d = torch.where(pass_through[:, None], d, wi_w)
        offset_n = torch.where((dot(next_d, ng_f) >= 0)[:, None], ng_f, -ng_f)
        next_o = hit_p + offset_n * _RAY_EPS + next_d * _RAY_EPS
        next_tp = torch.where(pass_through[:, None], throughput, new_tp)
        next_pdf = torch.where(pass_through, torch.zeros_like(pdf_s), pdf_s)
        active = active & (pass_through | valid_s | scatter)

        # --- SCATTER continuation + medium boundary tracking -------------
        if w_scatter:
            wi_hg, _ = sample_henyey_greenstein(
                d, st["med_g"], r_med[:, 1], r_med[:, 2]
            )
            scat_o = o + effective_t[:, None] * d + wi_hg * _RAY_EPS
            next_d = torch.where(scatter[:, None], wi_hg, next_d)
            next_o = torch.where(scatter[:, None], scat_o, next_o)
            next_tp = torch.where(
                scatter[:, None], throughput * st["med_color"], next_tp
            )
            # no NEE from scatter vertices: the next emissive hit carries
            # full weight (pdf 0 = delta/unmatched for the heuristic)
            next_pdf = torch.where(scatter, 0.0, next_pdf)

            # a transmitted surface ray enters or exits the medium
            mats = scene.materials
            mm_type = mats.medium_type[safe_mat]
            mm_density = mats.medium_density[safe_mat]
            mm_g = mats.medium_anisotropy[safe_mat]
            mm_color = mats.medium_color[safe_mat]
            crossed = on_surface & ~pass_through & (dot(next_d, ng_f) < 0)
            enter_med = crossed & entering & (mm_type == 2) & (mm_density > 0)
            exit_med = crossed & ~entering
            new_density = torch.where(
                enter_med, mm_density,
                torch.where(exit_med, 0.0, st["med_density"]),
            )
            new_g = torch.where(
                enter_med, mm_g, torch.where(exit_med, 0.0, st["med_g"])
            )
            new_color = torch.where(
                enter_med[:, None], mm_color,
                torch.where(exit_med[:, None], 0.0, st["med_color"]),
            )
        else:
            new_density = st["med_density"]
            new_g = st["med_g"]
            new_color = st["med_color"]

        # --- Russian roulette (from rr_depth, rt_renderer.rs:572-573) ---
        if bounce >= settings.rr_depth:
            q = torch.clamp(torch.amax(next_tp, dim=-1), 0.05, 0.95)
            next_tp = next_tp / q[:, None]
            active = active & (r_alpha[:, 1] < q)

        ext_tmax = torch.where(active, T_MAX, 0.0)
        return dict(
            next_o=next_o, next_d=next_d, ext_tmax=ext_tmax,
            radiance=radiance, active=active, next_tp=next_tp,
            next_pdf=next_pdf, st_albedo=st_albedo, st_normal=st_normal,
            rays=rays, path_dist=path_dist, new_density=new_density,
            new_g=new_g, new_color=new_color,
            candidate=candidate, nee_contrib=nee_contrib,
            shadow_o=shadow_o, nee_dir=nee_dir, nee_tmax=nee_tmax,
            r_alpha=r_alpha, **env_carry,
        )

    def bounce_post(c, qhit, blocked, blocked_e):
        n = c["active"].shape[0]
        active = c["active"]
        radiance = c["radiance"] + torch.where(
            (c["candidate"] & ~blocked)[:, None], c["nee_contrib"], 0.0
        )
        rays = c["rays"] + c["candidate"].to(torch.float32)
        if has_env_map:
            radiance = radiance + torch.where(
                (c["cand_e"] & ~blocked_e)[:, None], c["env_contrib"], 0.0
            )
            rays = rays + c["cand_e"].to(torch.float32)
        return dict(
            o=c["next_o"],
            d=c["next_d"],
            hit_t=qhit.t[:n],
            hit_tri=torch.where(active, qhit.tri[:n], -1),
            hit_u=qhit.u[:n],
            hit_v=qhit.v[:n],
            throughput=c["next_tp"],
            radiance=radiance,
            active=active,
            prev_pdf=c["next_pdf"],
            albedo=c["st_albedo"],
            normal=c["st_normal"],
            rays=rays + active.to(torch.float32),
            path_dist=c["path_dist"],
            med_density=c["new_density"],
            med_g=c["new_g"],
            med_color=c["new_color"],
        )

    def opacity_of(tri):
        m = geom.tri_mat[torch.clamp(tri, 0, geom.tri_mat.shape[0] - 1).long()]
        if scene.procedural is not None:
            # procedural blockers take their own material row
            pid = torch.clamp(tri - PROC_BASE, 0, scene.procedural.center.shape[0] - 1)
            m = torch.where(tri >= PROC_BASE,
                            scene.procedural.packed[pid.long(), 4].to(m.dtype), m)
        return scene.materials.packed[:, 3][torch.clamp(m, min=0).long()]

    def transmit(bounce, c, tri0, t0, dir_s, tmax_s, r_first, seed0):
        """Stochastic transparent shadow transmittance: pass each
        alpha-tested blocker with probability 1 - opacity, continuing
        past up to settings.shadow_surfaces stacked surfaces (one more
        batched closest-hit query each, t_max 0 for settled lanes). A
        blocker passed on the last budgeted surface counts as visible.
        Returns the blocked mask."""
        blocked0 = tri0 >= 0
        if not scene.materials.has_alpha:
            return blocked0
        shadow_o = c["shadow_o"]
        passed = blocked0 & (r_first >= opacity_of(tri0))
        blocked_acc = blocked0 & ~passed
        t_base = t0
        for k in range(settings.shadow_surfaces - 1):
            o_k = shadow_o + dir_s * (t_base + _RAY_EPS)[:, None]
            tm_k = torch.where(
                passed, torch.clamp(tmax_s - t_base - _RAY_EPS, min=0.0), 0.0
            )
            qh_k = _intersect(scene, o_k, dir_s, settings, t_max=tm_k)
            hit_k = passed & (qh_k.tri >= 0)
            r_k = s4(bounce, seed0 + k)[:, 0]
            pass_k = hit_k & (r_k >= opacity_of(qh_k.tri))
            blocked_acc = blocked_acc | (hit_k & ~pass_k)
            t_base = t_base + torch.where(passed, qh_k.t + _RAY_EPS, 0.0)
            passed = pass_k
        return blocked_acc

    def bounce_body(bounce, st):
        c = bounce_pre(bounce, st)
        n = c["active"].shape[0]
        q_o = [c["shadow_o"]]
        q_d = [c["nee_dir"]]
        q_t = [c["nee_tmax"]]
        if has_env_map:
            q_o.append(c["shadow_o"])
            q_d.append(c["wi_e"])
            q_t.append(c["env_tmax"])
        if split_shadow:
            qhit = _intersect(
                scene, c["next_o"], c["next_d"], settings, t_max=c["ext_tmax"],
                extend=True,
            )
            occ = _occluded(
                scene, torch.cat(q_o), torch.cat(q_d), torch.cat(q_t), settings
            )
            blocked_e = occ[n:2 * n] if has_env_map else None
            return bounce_post(c, qhit, occ[:n], blocked_e)
        qhit = _intersect(
            scene,
            torch.cat([c["next_o"], *q_o]),
            torch.cat([c["next_d"], *q_d]),
            settings,
            t_max=torch.cat([c["ext_tmax"], *q_t]),
        )
        blocked = transmit(
            bounce, c, qhit.tri[n:2 * n], qhit.t[n:2 * n], c["nee_dir"],
            c["nee_tmax"], c["r_alpha"][:, 2], 37,
        )
        blocked_e = (
            transmit(
                bounce, c, qhit.tri[2 * n:3 * n], qhit.t[2 * n:3 * n],
                c["wi_e"], c["env_tmax"], c["r_alpha"][:, 3], 53,
            )
            if has_env_map
            else None
        )
        return bounce_post(c, qhit, blocked, blocked_e)

    return init_state, bounce_body


def trace_paths(
    scene,
    env,
    uniforms: Uniforms,
    o: torch.Tensor,
    d: torch.Tensor,
    pixel_idx: torch.Tensor,
    frame_index,
    settings: RenderSettings,
    full_height: int | None = None,
    blue_noise=None,
    hooks: KernelHooks | None = None,
):
    """Trace full paths for a flat ray batch.

    Returns (radiance (N,3), albedo_aov (N,3), normal_aov (N,3),
    rays_traced (N,) f32 — extension + shadow rays, for Mrays/s).
    """
    init_state, bounce_body = _path_context(
        scene, env, uniforms, pixel_idx, frame_index, settings, full_height,
        blue_noise, hooks,
    )
    # Prologue: closest hit for the camera rays; every later bounce folds
    # its extension ray into the batched end-of-bounce query.
    state = init_state(o, d, _intersect(scene, o, d, settings))
    for bounce in range(settings.max_depth):
        state = bounce_body(bounce, state)
    return state["radiance"], state["albedo"], state["normal"], state["rays"]


def _tile_raygen(scene, uniforms, blue_noise, hooks, fidx, start, w, cam_h,
                 row_offset, spp, tile, swizzle, device):
    """Camera rays for one film tile: ray r is sample r % spp of pixel
    start + r // spp, running as virtual RNG frame fidx*spp + s.
    Returns (o, d, gpix, fidx_r)."""
    ridx = torch.arange(tile, dtype=torch.int64, device=device)
    pix = start + ridx // spp
    if spp == 1:
        fidx_r = fidx
    else:
        fidx_r = (fidx * spp + ridx % spp) & _U32
    if swizzle:
        # blocked index -> pixel coords (32x32 blocks, row-major)
        blk = pix // 1024
        within = pix % 1024
        bx = blk % (w // 32)
        by = blk // (w // 32)
        px_i = bx * 32 + within % 32
        py_i = by * 32 + within // 32
    else:
        px_i = pix % w
        py_i = pix // w
    py_i = py_i + row_offset
    gpix = py_i * w + px_i  # globally unique pixel id
    if blue_noise is not None:
        # pixel jitter and lens sample through the same construction
        # the path context uses
        r_jit = rng.bn_sample4(blue_noise, gpix % w, gpix // w, fidx_r, 0, seed=1)
    else:
        r_jit = rng.sample4(gpix, fidx_r, 0, seed=1)
    if hooks is not None and hooks.raygen is not None:
        r_jit = hooks.raygen(gpix, fidx_r, r_jit)
    o, d = generate_rays(
        scene.cameras, uniforms.camera_index,
        px_i.to(torch.float32), py_i.to(torch.float32), w, cam_h,
        r_jit[:, :2], r_jit[:, 2:],
    )
    return o, d, gpix, fidx_r


def _render_frame_impl(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index: int,
    settings: RenderSettings,
    row_offset: int = 0,
    full_height: int | None = None,
    blue_noise=None,
    hooks=None,
) -> torch.Tensor:
    """One progressive frame (settings.spp samples per pixel) added to
    `film` in place; returns the traced-ray count (0-d f32 tensor)."""
    _check_ported(settings)
    h, w = settings.height, settings.width
    dev = film.accum.device
    cam_h = full_height if full_height is not None else h
    spp = max(1, settings.spp)

    def to_blocked(a):
        return (
            a.reshape(h // 32, 32, w // 32, 32, a.shape[-1])
            .permute(0, 2, 1, 3, 4)
            .reshape(h * w, a.shape[-1])
        )

    def from_blocked(a):
        return (
            a.reshape(h // 32, w // 32, 32, 32, a.shape[-1])
            .permute(0, 2, 1, 3, 4)
            .reshape(h * w, a.shape[-1])
        )

    n_pix = h * w
    n_rays = n_pix * spp
    tile = min(settings.tile_size, n_rays)
    tile = max(spp, tile - tile % spp)  # whole pixels per ray tile
    pp = tile // spp                    # pixels per tile
    n_tiles = -(-n_rays // tile)
    n_pad = n_tiles * pp
    # 32x32 pixel swizzle: consecutive 1024-ray groups cover square
    # pixel blocks (coherent rays); RNG is keyed on the global pixel id,
    # so the image is the same either way.
    swizzle = h % 32 == 0 and w % 32 == 0 and pp % 1024 == 0

    bufs = [film.accum.reshape(-1, 4), film.albedo.reshape(-1, 4),
            film.normal.reshape(-1, 4)]
    if swizzle:
        bufs = [to_blocked(b) for b in bufs]
    if n_pad != n_pix:
        bufs = [torch.nn.functional.pad(b, (0, 0, 0, n_pad - n_pix)) for b in bufs]
    else:
        bufs = [b.clone() for b in bufs]
    accum, albedo, normal = bufs

    fidx = int(frame_index) & _U32
    inv_n1 = float(np.float32(1.0) / (np.float32(frame_index) + np.float32(1.0)))
    ones = torch.ones((pp, 1), dtype=torch.float32, device=dev)
    rays_total = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(n_tiles):
        start = t * pp
        o, d, gpix, fidx_r = _tile_raygen(
            scene, uniforms, blue_noise, hooks, fidx, start, w, cam_h, row_offset,
            spp, tile, swizzle, dev,
        )
        L, alb, nrm, rays = trace_paths(
            scene, env, uniforms, o, d, gpix, fidx_r, settings,
            full_height=cam_h, blue_noise=blue_noise, hooks=hooks,
        )
        if hooks is not None and hooks.post_shade is not None:
            L, alb, nrm = hooks.post_shade(L, alb, nrm)
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        if spp > 1:
            # pixel mean over the sample-adjacent lanes
            L = L.reshape(pp, spp, 3).mean(dim=1)
            alb = alb.reshape(pp, spp, 3).mean(dim=1)
            nrm = nrm.reshape(pp, spp, 3).mean(dim=1)
        sl = slice(start, start + pp)
        for buf, val in ((accum, L), (albedo, alb), (normal, nrm)):
            old = buf[sl]
            buf[sl] = old + (torch.cat([val, ones], dim=-1) - old) * inv_n1
        rays_total = rays_total + torch.sum(rays)

    for buf, dst in ((accum, film.accum), (albedo, film.albedo),
                     (normal, film.normal)):
        buf = buf[:n_pix]
        if swizzle:
            buf = from_blocked(buf)
        dst.copy_(buf.reshape(h, w, 4))
    return rays_total


@torch.inference_mode()
def render_frame(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index: int,
    settings: RenderSettings,
    row_offset: int = 0,
    full_height: int | None = None,
    blue_noise=None,
    hooks=None,
):
    """One progressive frame: rt_renderer.rs update() parity.

    The film's tensors are updated IN PLACE (the JAX package returns a
    new film); the same `film` object is returned for symmetry. Returns
    (film, rays_traced) with rays_traced a 0-d f32 tensor on the film's
    device (no host synchronization).

    `row_offset`/`full_height` place this film as a row band of a taller
    image (camera NDC and RNG use the global pixel ids).
    """
    rays = _render_frame_impl(
        scene, env, uniforms, film, frame_index, settings, row_offset,
        full_height, blue_noise, hooks,
    )
    return film, rays


@torch.inference_mode()
def render_frames(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index: int,
    k_frames: int,
    settings: RenderSettings,
    row_offset: int = 0,
    full_height: int | None = None,
    blue_noise=None,
    hooks=None,
):
    """K progressive frames, frames frame_index .. frame_index+K-1, into
    `film` in place: the same computation as K `render_frame` calls, bit
    for bit. Returns (film, total_rays) with the rays summed over K."""
    rays = torch.zeros((), dtype=torch.float32, device=film.accum.device)
    for i in range(k_frames):
        rays = rays + _render_frame_impl(
            scene, env, uniforms, film, frame_index + i, settings,
            row_offset, full_height, blue_noise, hooks,
        )
    return film, rays
