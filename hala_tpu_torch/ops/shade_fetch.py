"""The shading point's surface fetch: K9 and its plain version.

At each bounce the path tracer reads, for every hit, the triangle's
shade row (interpolated normal, uv, tangent, vertex colour), the
material row, the uv transform and the material maps' texels at the
ray's mip LOD. `shade_fetch_plain` is that code as the integrator has
always run it, in PyTorch; `shade_fetch` launches K9
(`csrc/shade_fetch.cu`), which computes the same outputs in one pass,
bit for bit. Both return a `SurfaceFetch`.

`shade_fetch` is the one router: K9 for every hit on the card, the
plain version for hits on the CPU (`fetch_route`). Both take the shade
rows from the scene's table at the clamped hit ids, or, where a caller
passes them, rows already fetched a lane (a geometry sharded across
ranks brings its rows back through a collective), and both put a
procedural sphere's analytic attributes in place of the row's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from . import cuda_lib
from .bsdf import MatParams, gather_materials
from .gathers import take_rows
from .prims import PROC_BASE
from .sampling import dot, normalize
from .texture import sample_textures_packed


class SurfaceFetch(NamedTuple):
    """The shading point's attributes, (N, ...) per hit."""

    ns: torch.Tensor        # (N, 3) normalized shading normal
    uv: torch.Tensor        # (N, 2) after the uv transform
    ng: torch.Tensor        # (N, 3) geometric normal oriented along ns
    tan_raw: torch.Tensor   # (N, 3) interpolated tangent
    mat_idx: torch.Tensor   # (N,) i32
    mp: MatParams           # base colour times the vertex colour
    base_t: torch.Tensor | None = None   # (N, 4) texels, None without textures
    mr_t: torch.Tensor | None = None
    em_t: torch.Tensor | None = None
    n_tex: torch.Tensor | None = None    # None without normal maps


def fetch_route(device: torch.device) -> str:
    """"kernel" (K9) for hits on the card, "plain" elsewhere."""
    return "kernel" if device.type == "cuda" else "plain"


def shade_fetch_plain(scene, rows, hit, hit_p, path_dist, pixel_angle) -> SurfaceFetch:
    """The fetch in PyTorch. `rows` are the shade rows at the hits
    (clamped ids), `hit_p` the hit points (read by procedural spheres),
    `path_dist` the path lengths and `pixel_angle` the pixel's cone
    angle (both for the mip LOD)."""
    u, v = hit.u, hit.v
    w0 = 1.0 - u - v
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

    # Interpolated tangent (Gram-Schmidt-orthonormalized against ns by
    # the caller).
    tan_raw = (
        w0[:, None] * rows[:, 20:23]
        + u[:, None] * rows[:, 23:26]
        + v[:, None] * rows[:, 26:29]
    )
    if is_proc is not None:
        # spheres carry no tangents: zero takes the fallback basis
        tan_raw = torch.where(is_proc[:, None], 0.0, tan_raw)

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
    return SurfaceFetch(ns, uv, ng, tan_raw, mat_idx, mp, base_t, mr_t, em_t, n_tex)


# K9's output buffer: segments of N x width float32 in this order (the
# kSeg* offsets of csrc/shade_fetch.cu); "i" marks int32 segments, read
# through an int32 view. The texel segments follow, 4 wide, one a map.
SEGMENTS = (
    ("ns", 3), ("uv", 2), ("ng", 3), ("tan_raw", 3), ("mat_idx", 1, "i"),
    ("base_color", 3), ("emission", 3), ("opacity", 1), ("metallic", 1),
    ("roughness", 1), ("subsurface", 1), ("specular_tint", 1), ("sheen", 1),
    ("sheen_tint", 1), ("clearcoat", 1), ("clearcoat_roughness", 1),
    ("clearcoat_tint", 3), ("specular_transmission", 1), ("ior", 1), ("ax", 1),
    ("ay", 1), ("mat_type", 1, "i"), ("medium_sigma", 3),
    ("base_color_map", 1, "i"), ("metallic_roughness_map", 1, "i"),
    ("emission_map", 1, "i"), ("normal_map", 1, "i"),
)
TEXELS = ("base_t", "mr_t", "em_t", "n_tex")
_WIDTH = sum(s[1] for s in SEGMENTS)


def _views(out: torch.Tensor, n: int, n_maps: int) -> SurfaceFetch:
    outi = out.view(torch.int32)
    seg, off = {}, 0
    for name, width, *kind in SEGMENTS + tuple((t, 4) for t in TEXELS[:n_maps]):
        src = outi if kind else out
        part = src[off * n:(off + width) * n]
        seg[name] = part.view(n, width) if width > 1 else part
        off += width
    mp = MatParams(**{f: seg[f] for f in MatParams._fields})
    return SurfaceFetch(mp=mp, **{f: seg.get(f) for f in SurfaceFetch._fields if f != "mp"})


def shade_fetch(scene, hit, hit_p, path_dist, pixel_angle, rows=None) -> SurfaceFetch:
    """The fetch at `hit`, inside the span `hala.shade.fetch` and counted
    by `shade.fetch`, both labelled with the route. `rows`, where given,
    are the shade rows lane by lane; else each lane reads the scene's
    table at its clamped hit id."""
    route = fetch_route(hit.tri.device)
    profiling.count("shade.fetch", route=route)
    with profiling.span("hala.shade.fetch", route=route):
        if route == "kernel":
            return _k9(scene, hit, hit_p, path_dist, pixel_angle, rows)
        if rows is None:
            table = scene.geometry.shade_table
            rows = take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))
        return shade_fetch_plain(scene, rows, hit, hit_p, path_dist, pixel_angle)


def _k9(scene, hit, hit_p, path_dist, pixel_angle, rows) -> SurfaceFetch:
    """One K9 launch, one output buffer, the `SurfaceFetch` its views."""
    g, mats, stack, proc = scene.geometry, scene.materials, scene.textures, scene.procedural
    dev = hit.tri.device
    tri, u, v = hit.tri.contiguous(), hit.u.contiguous(), hit.v.contiguous()
    path_dist = path_dist.contiguous()
    pixel_angle = torch.as_tensor(pixel_angle, dtype=torch.float32, device=dev)
    n = tri.shape[0]
    per_lane = rows is not None
    table = rows.contiguous() if per_lane else g.shade_table
    n_rows, cols = table.shape
    tensors = dict(tri=tri, u=u, v=v, path_dist=path_dist, pixel_angle=pixel_angle,
                   shade_table=table, packed=mats.packed)
    if mats.has_uv_transform:
        tensors["uv_transform"] = mats.uv_transform
    n_maps = 0
    if stack is not None:
        n_maps = 4 if mats.has_normal_map else 3
        tensors.update(texels=stack.data, sizes=stack.sizes)
    if proc is not None:
        hit_p = hit_p.contiguous()
        tensors.update(hit_p=hit_p, proc=proc.packed)
    cuda_lib.check_cuda("shade_fetch", tensors,
                        dict(tri=torch.int32, sizes=torch.int32), dev)
    if tri.shape != (n,) or u.shape != (n,) or v.shape != (n,) or path_dist.shape != (n,):
        raise ValueError("shade_fetch: tri, u, v, path_dist must be (N,)")
    if (cols not in (32, 48) or mats.packed.shape[1] != 32 or pixel_angle.dim() != 0
            or (per_lane and n_rows != n)):
        raise ValueError(
            f"shade_fetch: shade rows {tuple(table.shape)} for {n} lanes, materials "
            f"{tuple(mats.packed.shape)}, pixel_angle {tuple(pixel_angle.shape)}")
    if proc is not None and (hit_p.shape != (n, 3) or proc.packed.dim() != 2
                             or proc.packed.shape[1] != 8 or proc.packed.shape[0] < 1):
        raise ValueError(f"shade_fetch: hit points {tuple(hit_p.shape)}, spheres "
                         f"{tuple(proc.packed.shape)}")
    for key in ("shade_table", "packed", "texels", "proc"):
        if key in tensors and tensors[key].data_ptr() % 16:
            raise ValueError(f"shade_fetch: {key} is not 16-byte aligned")
    if stack is not None and (stack.data.dim() != 4 or stack.data.shape[3] != 4):
        raise ValueError(f"shade_fetch: texture stack {tuple(stack.data.shape)}")
    out = torch.empty((_WIDTH + 4 * n_maps) * n, dtype=torch.float32, device=dev)
    P = cuda_lib.ptr
    none = ctypes.c_void_p(None)
    cuda_lib.SHADE_FETCH(
        P(tri), P(u), P(v), P(path_dist), P(pixel_angle), P(table), n_rows, cols,
        int(per_lane), P(mats.packed), mats.packed.shape[0],
        P(mats.uv_transform) if mats.has_uv_transform else none,
        P(stack.data) if stack is not None else none,
        P(stack.sizes) if stack is not None else none,
        *((stack.data.shape[0], stack.data.shape[1], stack.data.shape[2],
           stack.num_levels) if stack is not None else (0, 0, 0, 0)),
        n_maps,
        P(hit_p) if proc is not None else none,
        P(proc.packed) if proc is not None else none,
        proc.packed.shape[0] if proc is not None else 0,
        n, P(out), cuda_lib.stream_ptr(dev),
    )
    return _views(out, n, n_maps)
