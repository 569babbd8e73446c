"""A bounce's shading after the surface fetch: K10 and its route.

At each bounce the path tracer shades every lane of a tile: the
light-set hit with MIS, the sky or environment map on a miss, the
tangent frame and normal map, the textured material, media, the AOVs,
the alpha test, next-event estimation over the lights and the
environment map, the BSDF sample and Russian roulette.
models/integrator.py `bounce_pre` runs that in PyTorch, ~1,000
elementwise launches a bounce and tile: the plain version, and K10's
reference. On the card `shade` launches K10 (`csrc/shade_bounce.cu`),
which computes the same outputs in one pass, bit for bit, from the
bounce state and the surface fetch, into one packed buffer whose views
are `bounce_pre`'s dict.

The fetch (K9) reads the path length for its mip LOD and, for sphere
hits, the hit point, and the path length depends on the light hit and
a scattering medium's free flight. `front` is K10's pass before the
fetch that computes the two (`hala_shade_bounce_pre`); a scene K9
reads neither of (no textures, no spheres) skips it.

A pushed intersection, miss, closest-hit or any-hit kernel (a Python
callable, models/integrator.py KernelHooks) cannot run inside K10, so
K10 stops at its seam: a seam pass (`ray_seams` before the fetch,
`hit_seams` after it) writes what the pushed kernel reads, the
integrator calls it, and the passes after read its result in place of
their own (`Seams`).

`bounce_route` is the one rule: K10 on the card, the plain version on
the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import cuda_lib

# K10's output buffer, in the order of the kernel's `Seg` enum: (name,
# floats a lane; "q" scales by the query rows a lane). A segment starts
# on a 16-byte boundary; `masks` holds bytes: active, candidate and,
# with the environment map, cand_e, n each. The first bounce's albedo
# and normal are a (2, n, 3) buffer of their own: the tile's film reads
# them after its last bounce, and views of the main buffer would keep
# all of it alive that long.
SEGMENTS = (
    ("q_o", "3q"), ("q_d", "3q"), ("q_t", "q"), ("radiance", 3), ("next_tp", 3),
    ("next_pdf", 1), ("path_dist", 1), ("nee_contrib", 3), ("r_alpha", 4),
    ("new_density", 1), ("new_g", 1), ("new_color", 3), ("env_contrib", 3),
    ("masks", "m"),
)
_NUM_SEGS = 14

# The kernel's `BounceArgs`, field for field.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STATE = ("o", "d", "hit_t", "hit_tri", "throughput", "radiance", "active", "prev_pdf",
          "path_dist", "med_density", "med_g", "med_color", "albedo", "normal", "pixel",
          "frame")
_FETCH = ("ns", "ng", "tan", "mat_idx", "base_color", "emission", "opacity", "metallic",
          "roughness", "subsurface", "specular_tint", "sheen", "sheen_tint", "clearcoat",
          "clearcoat_roughness", "clearcoat_tint", "specular_transmission", "ior", "ax",
          "ay", "mat_type", "medium_sigma", "mr_map", "normal_map", "base_t", "mr_t",
          "em_t", "n_tex")
_FETCH_WIDTH = dict(ns=3, ng=3, tan=3, base_color=3, emission=3, clearcoat_tint=3,
                    medium_sigma=3, base_t=4, mr_t=4, em_t=4, n_tex=4)
_FETCH_INTS = ("mat_idx", "mat_type", "mr_map", "normal_map")
_FIELDS = (
    [(k, _P) for k in _STATE] + [("frame0", _L)] + [(k, _P) for k in _FETCH]
    + [(k, _P) for k in ("l_intensity", "l_position", "l_u", "l_v", "l_radius", "l_area",
                         "l_type")]
    + [("n_lights", _I), ("light_div", _F), ("light_sel", _F)]
    + [(k, _P) for k in ("medium_type", "medium_color", "medium_density",
                         "medium_anisotropy")]
    + [("n_mats", _I)]
    + [(k, _P) for k in ("env_image", "env_marginal", "env_conditional", "env_luminance",
                         "env_total", "env_sin_theta", "env_cos_theta", "env_cos_phi",
                         "env_sin_phi")]
    + [("env_w", _I), ("env_h", _I)]
    + [(k, _P) for k in ("ground", "sky", "env_intensity", "env_rotation", "bn")]
    + [(k, _I) for k in ("bn_h", "bn_w", "bn_c", "width", "n", "bounce", "rr", "aov",
                         "scatter", "absorb", "emissive", "textures", "normal_maps", "q")]
    + [("off", _L * _NUM_SEGS), ("out", _P), ("aov_out", _P), ("pre_path_dist", _P),
       ("pre_hit_p", _P)]
    + [(k, _P) for k in ("lh_t", "lh_rad", "lh_pdf", "env_in", "pass_in")]
    + [("mat_final", _I), ("seam_out", _P)]
)

# The seam passes' output, in the order of the kernel's `SeamSeg`: (name,
# floats a lane; "m" a byte). Before the fetch: the light-set hit and the
# radiance of a ray that leaves the scene. After it: the closest-hit and
# any-hit kernels' context, the textured material and the alpha test's
# draw.
RAY_SEAMS = (("t", 1), ("pdf", 1), ("radiance", 3), ("env_rad", 3))
HIT_SEAMS = (("p", 3), ("ns", 3), ("ng", 3), ("base_color", 3), ("emission", 3),
             ("metallic", 1), ("roughness", 1), ("ax", 1), ("ay", 1), ("ior", 1),
             ("r_alpha", 4), ("on_surface", "m"))


class BounceArgs(ctypes.Structure):
    _fields_ = _FIELDS


def bounce_route(device: torch.device) -> str:
    """"kernel" (K10) on the card, "plain" elsewhere."""
    return "kernel" if device.type == "cuda" else "plain"


@dataclasses.dataclass
class Seams:
    """What pushed kernels gave at K10's seams, each None where K10
    computes its own: the light-set hit (an ops/lights.py LightHit), the
    radiance of a ray that leaves the scene, the material (a
    MaterialParams, final: no maps, no ior flip) and the pass-through
    decision."""
    lhit: object = None
    env_rad: torch.Tensor | None = None
    mp: object = None
    pass_through: torch.Tensor | None = None


def seam_views(buf: torch.Tensor, n: int, segments) -> dict:
    """The fields of a seam pass's buffer, by the names of `segments`."""
    out, at = {}, 0
    for name, width in segments:
        if width == "m":
            out[name] = buf.view(torch.uint8)[4 * at * n:4 * at * n + n].view(torch.bool)
            at += 1
            continue
        t = buf[at * n:(at + width) * n]
        out[name] = t.view(n, width) if width > 1 else t
        at += width
    return out


def _seam_size(segments) -> int:
    return sum(1 if w == "m" else w for _, w in segments)


def _lane(t, n: int, width: int, dtype) -> torch.Tensor:
    """A pushed kernel's tensor as K10 reads it: (n,) or (n, width),
    `dtype`, contiguous (a broadcast or expanded result is made whole)."""
    t = torch.as_tensor(t)
    return torch.broadcast_to(t, (n, width) if width > 1 else (n,)).to(dtype).contiguous()


def instance(disney: bool, transmission: bool, env_map: bool) -> tuple[int, int, int]:
    """The kernel instance a scene takes: (Disney, its transmission lobe,
    the environment map); transmission only with Disney."""
    disney = bool(disney)
    return int(disney), int(disney and bool(transmission)), int(bool(env_map))


def layout(n: int, env_map: bool, scatter: bool) -> tuple[list[int], int]:
    """Offsets (in floats; -1 for a segment this bounce does not write)
    of `SEGMENTS` for n lanes, and the buffer's length in floats."""
    q = 3 if env_map else 2
    skip = set()
    if not scatter:
        skip |= {"new_density", "new_g", "new_color"}
    if not env_map:
        skip.add("env_contrib")
    offs, at = [], 0
    for name, width in SEGMENTS:
        if name in skip:
            offs.append(-1)
            continue
        if width == "m":
            size = -(-q * n // 4)
        elif isinstance(width, str):
            size = (3 * q if width == "3q" else q) * n
        else:
            size = width * n
        offs.append(at)
        at += -(-size // 4) * 4
    return offs, at


def views(out: torch.Tensor, aov, n: int, offs: list[int], env_map: bool, st: dict) -> dict:
    """`bounce_pre`'s dict as views of K10's buffer and of `aov`, the
    first bounce's albedo and normal (the state's own tensors where this
    bounce leaves them as they are), and `query`, the rows of the batched
    visibility query."""
    q = 3 if env_map else 2
    seg = dict(zip((s[0] for s in SEGMENTS), offs))

    def part(name, width):
        o = seg[name]
        t = out[o:o + width * n]
        return t.view(n, width) if width > 1 else t

    qo = out[seg["q_o"]:seg["q_o"] + 3 * q * n].view(q * n, 3)
    qd = out[seg["q_d"]:seg["q_d"] + 3 * q * n].view(q * n, 3)
    qt = out[seg["q_t"]:seg["q_t"] + q * n]
    masks = out.view(torch.uint8)[4 * seg["masks"]:4 * seg["masks"] + q * n].view(torch.bool)
    c = dict(
        next_o=qo[:n], next_d=qd[:n], ext_tmax=qt[:n],
        radiance=part("radiance", 3), active=masks[:n], next_tp=part("next_tp", 3),
        next_pdf=part("next_pdf", 1),
        st_albedo=aov[0] if aov is not None else st["albedo"],
        st_normal=aov[1] if aov is not None else st["normal"],
        rays=st["rays"], path_dist=part("path_dist", 1),
        new_density=part("new_density", 1) if seg["new_density"] >= 0 else st["med_density"],
        new_g=part("new_g", 1) if seg["new_g"] >= 0 else st["med_g"],
        new_color=part("new_color", 3) if seg["new_color"] >= 0 else st["med_color"],
        candidate=masks[n:2 * n], nee_contrib=part("nee_contrib", 3),
        shadow_o=qo[n:2 * n], nee_dir=qd[n:2 * n], nee_tmax=qt[n:2 * n],
        r_alpha=part("r_alpha", 4),
    )
    if env_map:
        c.update(cand_e=masks[2 * n:], env_contrib=part("env_contrib", 3),
                 wi_e=qd[2 * n:], env_tmax=qt[2 * n:])
    c["query"] = (qo, qd, qt)
    return c


def _f32(x) -> float:
    return float(np.float32(x))


class Context:
    """K10's tables for one tile: the scene's lights and media, the
    environment map or the sky, the blue-noise texture, the pixel ids
    and frame index, resolved once, and the scene's capabilities."""

    def __init__(self, scene, env, uniforms, pixel_idx, frame_index, blue_noise,
                 width: int, rr_depth: int):
        dev = pixel_idx.device
        mats, lights = scene.materials, scene.lights
        self.device = dev
        self.rr_depth = rr_depth
        self.disney, self.transmission, self.env_map = instance(
            mats.has_disney, mats.has_transmission, env is not None)
        self.scatter = bool(mats.has_scatter_medium)
        self.textures = scene.textures is not None
        self.spheres = scene.procedural is not None
        self.tables = []  # the tensors the pointers below point into
        a = BounceArgs()
        a.pixel = self._ptr(pixel_idx, torch.int64)
        if isinstance(frame_index, torch.Tensor) and frame_index.dim() > 0:
            a.frame = self._ptr(frame_index, torch.int64)
        else:
            a.frame0 = int(frame_index) & 0xFFFFFFFF
        nl = int(lights.num_lights)
        a.n_lights = nl
        if nl > 0:
            for key, name, dt in (("l_intensity", "intensity", torch.float32),
                                  ("l_position", "position", torch.float32),
                                  ("l_u", "u", torch.float32), ("l_v", "v", torch.float32),
                                  ("l_radius", "radius", torch.float32),
                                  ("l_area", "area", torch.float32),
                                  ("l_type", "ltype", torch.int32)):
                setattr(a, key, self._ptr(getattr(lights, name), dt))
            # x / float(nl) on the card: x times the float reciprocal;
            # x * (1.0 / nl): the double rounded to float
            a.light_div = _f32(np.float32(1.0) / np.float32(nl))
            a.light_sel = _f32(1.0 / nl)
        a.n_mats = int(mats.packed.shape[0])
        for key, name, dt in (("medium_type", "medium_type", torch.int32),
                              ("medium_color", "medium_color", torch.float32),
                              ("medium_density", "medium_density", torch.float32),
                              ("medium_anisotropy", "medium_anisotropy", torch.float32)):
            setattr(a, key, self._ptr(getattr(mats, name), dt))
        if env is not None:
            for key, name in (("env_image", "image"), ("env_marginal", "marginal"),
                              ("env_conditional", "conditional"),
                              ("env_luminance", "luminance"), ("env_total", "total_luminance"),
                              ("env_sin_theta", "sin_theta"), ("env_cos_theta", "cos_theta"),
                              ("env_cos_phi", "cos_phi"), ("env_sin_phi", "sin_phi")):
                setattr(a, key, self._ptr(getattr(env, name), torch.float32))
            a.env_w, a.env_h = int(env.width), int(env.height)
            if tuple(env.image.shape) != (env.height, env.width, 3):
                raise ValueError(f"shade_bounce: env image {tuple(env.image.shape)}")
        for key, t in (("ground", uniforms.ground_color), ("sky", uniforms.sky_color),
                       ("env_intensity", uniforms.env_intensity),
                       ("env_rotation", uniforms.env_rotation)):
            setattr(a, key, self._ptr(t, torch.float32))
        if blue_noise is not None:
            if blue_noise.dim() != 3 or blue_noise.shape[2] < 4:
                raise ValueError(f"shade_bounce: blue noise {tuple(blue_noise.shape)}")
            a.bn = self._ptr(blue_noise, torch.float32)
            a.bn_h, a.bn_w, a.bn_c = (int(s) for s in blue_noise.shape)
        a.width = int(width)
        a.scatter = int(self.scatter)
        a.absorb = int(bool(mats.has_absorb_medium))
        a.emissive = int(bool(mats.has_emissive_medium))
        a.textures = int(self.textures)
        a.normal_maps = int(self.textures and bool(mats.has_normal_map))
        a.q = 3 if self.env_map else 2
        a.n = int(pixel_idx.shape[0])
        self.args = a

    def _ptr(self, t, dtype) -> int:
        """The address of a table, checked and kept alive with the context."""
        t = torch.as_tensor(t)
        if t.device != self.device or t.dtype != dtype:
            raise ValueError(f"shade_bounce: a table is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {self.device}")
        t = t.contiguous()
        self.tables.append(t)
        return t.data_ptr()


def _state_args(ctx: Context, bounce: int, st: dict, refs: list,
                seams: Seams | None = None) -> BounceArgs:
    """The context's arguments with this bounce's state and the pushed
    kernels' light-set hit and miss radiance; `refs` keeps the tensors
    pointed to until the launch."""
    a = BounceArgs.from_buffer_copy(ctx.args)
    n = a.n
    for key, dt, shape in (("o", torch.float32, (n, 3)), ("d", torch.float32, (n, 3)),
                           ("hit_t", torch.float32, (n,)), ("hit_tri", torch.int32, (n,)),
                           ("throughput", torch.float32, (n, 3)),
                           ("radiance", torch.float32, (n, 3)), ("active", torch.bool, (n,)),
                           ("prev_pdf", torch.float32, (n,)), ("path_dist", torch.float32, (n,)),
                           ("med_density", torch.float32, (n,)), ("med_g", torch.float32, (n,)),
                           ("med_color", torch.float32, (n, 3)),
                           ("albedo", torch.float32, (n, 3)), ("normal", torch.float32, (n, 3))):
        t = st[key]
        if t.device != ctx.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"shade_bounce: state {key} {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        t = t.contiguous()
        refs.append(t)
        setattr(a, key, t.data_ptr())
    a.bounce = int(bounce)
    a.rr = int(bounce >= ctx.rr_depth)
    a.aov = int(bounce == 0)
    if seams is not None and seams.lhit is not None:
        for key, t, width in (("lh_t", seams.lhit.t, 1), ("lh_rad", seams.lhit.radiance, 3),
                              ("lh_pdf", seams.lhit.pdf, 1)):
            t = _lane(t, n, width, torch.float32)
            refs.append(t)
            setattr(a, key, t.data_ptr())
    if seams is not None and seams.env_rad is not None:
        t = _lane(seams.env_rad, n, 3, torch.float32)
        refs.append(t)
        a.env_in = t.data_ptr()
    return a


def ray_seams(ctx: Context, bounce: int, st: dict):
    """K10's light-set hit (an ops/lights.py LightHit) and the radiance
    of a ray that leaves the scene, for pushed intersection and miss
    kernels: one seam pass."""
    from .lights import LightHit

    refs = []
    a = _state_args(ctx, bounce, st, refs)
    n = a.n
    buf = torch.empty(_seam_size(RAY_SEAMS) * n, dtype=torch.float32, device=ctx.device)
    a.seam_out = buf.data_ptr()
    cuda_lib.SHADE_BOUNCE_SEAM(ctypes.addressof(a), 0, cuda_lib.stream_ptr(ctx.device))
    v = seam_views(buf, n, RAY_SEAMS)
    return LightHit(t=v["t"], radiance=v["radiance"], pdf=v["pdf"]), v["env_rad"]


def front(ctx: Context, bounce: int, st: dict, seams: Seams | None = None):
    """The path lengths and hit points the fetch reads, (path_dist,
    hit_p), from K10's pass before it; where the fetch reads neither (no
    textures, no spheres), the state's path lengths and no hit points."""
    if not (ctx.textures or ctx.spheres):
        return st["path_dist"], None
    refs = []
    a = _state_args(ctx, bounce, st, refs, seams)
    n = a.n
    path_dist = torch.empty(n, dtype=torch.float32, device=ctx.device)
    hit_p = torch.empty((n, 3), dtype=torch.float32, device=ctx.device)
    a.pre_path_dist = path_dist.data_ptr()
    a.pre_hit_p = hit_p.data_ptr()
    cuda_lib.SHADE_BOUNCE_PRE(ctypes.addressof(a), cuda_lib.stream_ptr(ctx.device))
    return path_dist, hit_p


def _fetch_args(ctx: Context, a: BounceArgs, fetch, mp, refs: list) -> None:
    """Point `a` at the surface fetch `fetch` with the material `mp`
    (the fetch's, or a pushed closest-hit kernel's; the normal map's
    index is the fetch's, as the normal map is applied before it)."""
    n = a.n
    tensors = dict(ns=fetch.ns, ng=fetch.ng, tan=fetch.tan_raw, mat_idx=fetch.mat_idx,
                   base_color=mp.base_color, emission=mp.emission, opacity=mp.opacity,
                   metallic=mp.metallic, roughness=mp.roughness, subsurface=mp.subsurface,
                   specular_tint=mp.specular_tint, sheen=mp.sheen, sheen_tint=mp.sheen_tint,
                   clearcoat=mp.clearcoat, clearcoat_roughness=mp.clearcoat_roughness,
                   clearcoat_tint=mp.clearcoat_tint,
                   specular_transmission=mp.specular_transmission, ior=mp.ior, ax=mp.ax,
                   ay=mp.ay, mat_type=mp.mat_type, medium_sigma=mp.medium_sigma,
                   mr_map=fetch.mp.metallic_roughness_map, normal_map=fetch.mp.normal_map)
    if ctx.textures:
        tensors.update(base_t=fetch.base_t, mr_t=fetch.mr_t, em_t=fetch.em_t)
        if a.normal_maps:
            tensors["n_tex"] = fetch.n_tex
    for key, t in tensors.items():
        width = _FETCH_WIDTH.get(key, 1)
        want = (n, width) if width > 1 else (n,)
        dt = torch.int32 if key in _FETCH_INTS else torch.float32
        if mp is not fetch.mp:
            t = _lane(t, n, width, dt)  # a pushed kernel's fields as K10 reads them
        if t.device != ctx.device or t.dtype != dt or tuple(t.shape) != want:
            raise ValueError(f"shade_bounce: fetch {key} {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        t = t.contiguous()
        refs.append(t)
        setattr(a, key, t.data_ptr())


def hit_seams(ctx: Context, bounce: int, st: dict, fetch, seams: Seams):
    """What pushed closest-hit and any-hit kernels read, from one seam
    pass: (the hit's context without its uv, wo, t, tri and mat; the
    material, textured and with its relative ior, as a MaterialParams;
    the alpha test's draws, (n, 4))."""
    refs = []
    a = _state_args(ctx, bounce, st, refs, seams)
    n = a.n
    _fetch_args(ctx, a, fetch, fetch.mp, refs)
    buf = torch.empty(_seam_size(HIT_SEAMS) * n, dtype=torch.float32, device=ctx.device)
    a.seam_out = buf.data_ptr()
    cuda_lib.SHADE_BOUNCE_SEAM(ctypes.addressof(a), 1, cuda_lib.stream_ptr(ctx.device))
    v = seam_views(buf, n, HIT_SEAMS)
    mp = fetch.mp._replace(**{k: v[k] for k in ("base_color", "emission", "metallic",
                                                "roughness", "ax", "ay", "ior")})
    return dict(p=v["p"], ns=v["ns"], ng=v["ng"], on_surface=v["on_surface"]), mp, v["r_alpha"]


def shade(ctx: Context, bounce: int, st: dict, fetch, seams: Seams | None = None) -> dict:
    """One K10 launch: `bounce_pre`'s dict from the state `st`, the
    surface fetch `fetch` (a SurfaceFetch) and what pushed kernels gave
    at its seams."""
    refs = []
    a = _state_args(ctx, bounce, st, refs, seams)
    n = a.n
    mp = fetch.mp
    if seams is not None and seams.mp is not None:
        mp = seams.mp
        a.mat_final = 1
    _fetch_args(ctx, a, fetch, mp, refs)
    if seams is not None and seams.pass_through is not None:
        t = _lane(seams.pass_through, n, 1, torch.bool)
        refs.append(t)
        a.pass_in = t.data_ptr()
    offs, size = layout(n, ctx.env_map, ctx.scatter)
    out = torch.empty(size, dtype=torch.float32, device=ctx.device)
    aov = torch.empty((2, n, 3), dtype=torch.float32, device=ctx.device) if a.aov else None
    a.off[:] = offs
    a.out = out.data_ptr()
    a.aov_out = aov.data_ptr() if aov is not None else None
    cuda_lib.SHADE_BOUNCE(ctypes.addressof(a), ctx.disney, ctx.transmission, ctx.env_map,
                          cuda_lib.stream_ptr(ctx.device))
    return views(out, aov, n, offs, ctx.env_map, st)
