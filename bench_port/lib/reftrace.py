"""Plain path tracer: the reference of the path-traced cells.

It renders chosen pixels of chosen progressive frames of a `RefScene`
with the estimator the renderer documents: PCG4D random numbers keyed on
(global pixel, frame, bounce, stream), a pinhole camera with sub-pixel
jitter, closest hits by a brute-force Moller-Trumbore scan over every
triangle and then the procedural spheres, emission from quad lights hit
by BSDF rays weighted by the power heuristic, the sky gradient on a
miss, one light sampled per vertex for next-event estimation with a
shadow ray, Oren-Nayar diffuse shading with cosine-weighted
continuation, trilinear base-colour maps at the ray-cone LOD, Russian
roulette from `rr_depth`, the first-hit albedo and normal, and the
running-mean film. Every expression is written out
in the order the renderer evaluates it, so on one device the two agree
bit for bit wherever they find the same hits; a ray whose hit differs
(a graze that one side's intersection test accepts and the other
rejects, or two triangles at exactly the same distance) takes another
path, and that pixel differs.

Procedural spheres follow the renderer's documented rules: the nearest
root above 1e-4 (and below the query's t_max) is the sphere's hit; a
sphere is taken only where it is strictly nearer than the triangles, so
one at exactly a triangle's t keeps the triangle, and the first of
spheres at one t wins; a shadow ray is blocked by a sphere in (1e-4,
t_far) for the t_far the renderer passes, whatever shortening its
triangle query applies. A sphere hit shades with the unit normal from
the centre to the hit point, the spherical uv, no tangent, and its own
material row. Sphere k's hit id is the number of triangles plus k.

All floating-point work runs in `rs.dtype`: float32 is the reference,
bfloat16 its control. Nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T_MAX = 3.0e38
T_MIN = 1.0e-4
EPS = 1.0e-7
RAY_EPS = 1e-4
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
_MASK = 0xFFFFFFFF
_INV_U24 = 1.0 / (1 << 24)
_ON_EPS = 1e-6
_LIGHT_EPS = 1e-6
SPHERE_EPS = 1e-4
TRI_CHUNK = 2048
RAY_CHUNK = 1 << 15


# --- PCG4D ---------------------------------------------------------------


def _mul32(a, b):
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & _MASK


def pcg4d(v):
    v = (_mul32(v, 1664525) + 1013904223) & _MASK
    x = (v[..., 0] + _mul32(v[..., 1], v[..., 3])) & _MASK
    y = (v[..., 1] + _mul32(v[..., 2], x)) & _MASK
    z = (v[..., 2] + _mul32(x, y)) & _MASK
    w = (v[..., 3] + _mul32(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return torch.stack([x, y, z, w], dim=-1)


def sample4(pix, frame, bounce: int, seed: int):
    """Four uniforms in [0, 1) per lane: pix and frame are int64 tensors."""
    ctr = torch.stack([pix & _MASK, frame & _MASK, torch.full_like(pix, bounce & _MASK),
                       torch.full_like(pix, seed & _MASK)], dim=-1)
    return (pcg4d(ctr) >> 8).to(torch.float32) * _INV_U24


# --- vector helpers --------------------------------------------------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(v, eps: float = 1e-12):
    return v / torch.clamp(torch.sqrt(dot(v, v)), min=eps)[..., None]


def build_basis(n):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(local, t, b, n):
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def to_local(world, t, b, n):
    return torch.stack([dot(world, t), dot(world, b), dot(world, n)], dim=-1)


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-12)


# --- visibility -------------------------------------------------------------


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore of rays (N, 3) against triangles (C, 3): t (N, C)
    with T_MAX where there is no hit in (T_MIN, inf), and u, v."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    ok_det = torch.abs(det) > EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(valid, t, T_MAX), u, v


def _sphere_root(o, d, center, radius):
    """(t, ok) of rays (N, 3) against one sphere: the nearest root above
    SPHERE_EPS, from |o + t d - c|^2 = r^2 with d of unit length."""
    oc = o - center[None, :]
    b = dot(oc, d)
    cq = dot(oc, oc) - radius * radius
    disc = b * b - cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > SPHERE_EPS, t0, t1)
    return t, (disc > 0.0) & (t > SPHERE_EPS)


def _fold_spheres(rs, o, d, t_best, tri, u_best, v_best):
    """The spheres after the triangles' closest hit: sphere k is taken
    where its root is strictly below the best t so far (t_max where
    nothing was hit). u, v of a sphere hit: longitude around +y from
    +x towards +z, and latitude, both in [0, 1]."""
    sph = torch.full_like(tri, -1)
    for k in range(rs.num_spheres):
        t, ok = _sphere_root(o, d, rs.sph_center[k], rs.sph_radius[k])
        take = ok & (t < t_best)
        t_best = torch.where(take, t, t_best)
        sph = torch.where(take, k, sph)
    hit = sph >= 0
    k = torch.clamp(sph, min=0)
    p = o + t_best[:, None] * d
    nrm = (p - rs.sph_center[k]) / torch.clamp(rs.sph_radius[k], min=1e-12)[:, None]
    su = 0.5 + torch.atan2(nrm[:, 2], nrm[:, 0]) / TWO_PI
    sv = 0.5 - torch.asin(torch.clamp(nrm[:, 1], -1.0, 1.0)) / math.pi
    return (t_best, torch.where(hit, rs.num_triangles + k, tri),
            torch.where(hit, su, u_best), torch.where(hit, sv, v_best))


def closest_hit(rs, o, d, t_max):
    """Closest hit in (T_MIN, t_max) over every triangle, then every
    sphere; ties between triangles go to the first in scene order.
    Returns t, tri (-1 on a miss; spheres after the triangles), u, v."""
    n = o.shape[0]
    t_best = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    u_best = torch.zeros(n, dtype=o.dtype, device=o.device)
    v_best = torch.zeros(n, dtype=o.dtype, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        rsl = slice(r0, r0 + RAY_CHUNK)
        oo, dd = o[rsl], d[rsl]
        rows = torch.arange(oo.shape[0], device=o.device)
        for c0 in range(0, rs.num_triangles, TRI_CHUNK):
            sl = slice(c0, c0 + TRI_CHUNK)
            t, u, v = _mt(oo, dd, rs.v0[sl], rs.e1[sl], rs.e2[sl])
            t_min, arg = torch.min(t, dim=1)
            better = t_min < t_best[rsl]
            t_best[rsl] = torch.where(better, t_min, t_best[rsl])
            tri[rsl] = torch.where(better, c0 + arg, tri[rsl])
            u_best[rsl] = torch.where(better, u[rows, arg], u_best[rsl])
            v_best[rsl] = torch.where(better, v[rows, arg], v_best[rsl])
    if rs.num_spheres:
        return _fold_spheres(rs, o, d, t_best, tri, u_best, v_best)
    return t_best, tri, u_best, v_best


def occluded(rs, o, d, t_far, tri_scale: float):
    """True where some triangle lies in (T_MIN, t_far * tri_scale) or
    some sphere in (SPHERE_EPS, t_far)."""
    n = o.shape[0]
    limit = t_far * tri_scale
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    for r0 in range(0, n, RAY_CHUNK):
        rsl = slice(r0, r0 + RAY_CHUNK)
        lim = limit[rsl, None]
        for c0 in range(0, rs.num_triangles, TRI_CHUNK):
            sl = slice(c0, c0 + TRI_CHUNK)
            t, _, _ = _mt(o[rsl], d[rsl], rs.v0[sl], rs.e1[sl], rs.e2[sl])
            blocked[rsl] |= torch.any(t < lim, dim=1)
    for k in range(rs.num_spheres):
        t, ok = _sphere_root(o, d, rs.sph_center[k], rs.sph_radius[k])
        blocked |= ok & (t < t_far)
    return blocked


# --- camera, lights, shading ------------------------------------------------


def camera_rays(rs, px, py, width: int, height: int, jitter):
    """Pinhole rays through pixel (px, py) + jitter, y down."""
    dt = rs.dtype
    pos, right, up, fwd = rs.cam_pos, rs.cam_right, rs.cam_up, rs.cam_forward
    aspect = (torch.tensor(width, dtype=torch.float32)
              / torch.tensor(height, dtype=torch.float32)).to(px.device, dt)
    ndc_x = ((px + jitter[:, 0]) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((py + jitter[:, 1]) / height) * 2.0
    tan_half = torch.tan(0.5 * rs.cam_yfov)
    dir_p = (fwd[None, :] + (ndc_x * tan_half * aspect)[:, None] * right[None, :]
             + (ndc_y * tan_half)[:, None] * up[None, :])
    dir_p = dir_p / torch.sqrt(dot(dir_p, dir_p))[:, None]
    # the thin lens at aperture 0: the origin is the camera position and
    # the direction runs to the focus point
    lens = torch.zeros_like(px)
    cos_theta = dot(dir_p, fwd[None, :])
    ft = rs.cam_focal / torch.clamp(cos_theta, min=1e-6)
    focus_p = pos[None, :] + dir_p * ft[:, None]
    lens_off = lens[:, None] * right[None, :] + lens[:, None] * up[None, :]
    o = pos[None, :] + lens_off
    d = focus_p - o
    d = d / torch.sqrt(dot(d, d))[:, None]
    return o, d


def ray_quads(rs, o, d):
    """Ray against every quad light's emitting face: t (N, L)."""
    corner, eu, ev = rs.light_corner, rs.light_u, rs.light_v
    n = cross(eu, ev)
    denom = dot(d[:, None, :], n[None, :, :])
    safe = torch.abs(denom) > EPS
    t = dot(corner[None, :, :] - o[:, None, :], n[None, :, :]) / torch.where(safe, denom, 1.0)
    p = o[:, None, :] + t[..., None] * d[:, None, :] - corner[None, :, :]
    uu = dot(eu, eu)[None, :]
    vv = dot(ev, ev)[None, :]
    a = dot(p, eu[None, :, :]) / torch.clamp(uu, min=EPS)
    b = dot(p, ev[None, :, :]) / torch.clamp(vv, min=EPS)
    valid = safe & (t > T_MIN) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    t = torch.where(valid, t, T_MAX)
    n_q = normalize(n)
    facing = -dot(d[:, None, :], n_q[None, :, :]) > 0.0
    return torch.where(facing, t, T_MAX), n_q


def light_hit(rs, o, d):
    """(t, radiance, pdf) of the closest quad light hit along each ray."""
    nl = rs.num_lights
    t_q, n_q = ray_quads(rs, o, d)
    t_best, li = torch.min(t_q, dim=1)
    hit = t_best < T_MAX
    cos_l = torch.abs(dot(n_q[li], d))
    area = rs.light_area[li]
    pdf = (t_best * t_best) / torch.clamp(area * torch.clamp(cos_l, min=_LIGHT_EPS), min=_LIGHT_EPS)
    pdf = pdf / float(nl)
    return (torch.where(hit, t_best, T_MAX), torch.where(hit[:, None], rs.light_rad[li], 0.0),
            torch.where(hit, pdf, 0.0))


def sample_light(rs, p, rnd):
    """One quad light picked uniformly and a point on it uniformly:
    (wi, dist, radiance, pdf with the pick's 1 / lights)."""
    nl = rs.num_lights
    li = torch.clamp((rnd[:, 0] * nl).to(torch.int64), max=nl - 1)
    pos, u, v = rs.light_corner[li], rs.light_u[li], rs.light_v[li]
    sample_q = pos + u * rnd[:, 1][:, None] + v * rnd[:, 2][:, None]
    n_q = normalize(cross(u, v))
    to_q = sample_q - p
    d2_q = torch.clamp(dot(to_q, to_q), min=_LIGHT_EPS)
    dist_q = torch.sqrt(d2_q)
    wi_q = to_q / dist_q[:, None]
    cos_l = dot(n_q, -wi_q)
    pdf_q = d2_q / torch.clamp(rs.light_area[li] * torch.clamp(cos_l, min=0.0), min=_LIGHT_EPS)
    rad_q = torch.where((cos_l > 0)[:, None], rs.light_rad[li], 0.0)
    return wi_q, dist_q, rad_q, pdf_q * (1.0 / nl)


def oren_nayar(base, a_on, b_on, wo, wi):
    """Oren-Nayar f and the cosine pdf in the local frame."""
    cos_o, cos_i = torch.abs(wo[..., 2]), torch.abs(wi[..., 2])
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    denom = torch.clamp(sin_o * sin_i, min=_ON_EPS)
    cos_dphi = torch.clamp((wo[..., 0] * wi[..., 0] + wo[..., 1] * wi[..., 1]) / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(sin_o, sin_i)
    tan_beta = torch.minimum(sin_o, sin_i) / torch.clamp(torch.minimum(cos_o, cos_i), min=_ON_EPS)
    f_scalar = INV_PI * (a_on + b_on * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta)
    f = base * f_scalar[..., None]
    pdf = cos_i * INV_PI
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def cosine_sample(u1, u2):
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)


def _bilinear(level, uv):
    lh, lw = level.shape[0], level.shape[1]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * lw - 0.5
    y = v * lh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def wrap(c, m):
        return torch.remainder(c.to(torch.int64), m)

    x0i, x1i = wrap(x0, lw), wrap(x0 + 1, lw)
    y0i, y1i = wrap(y0, lh), wrap(y0 + 1, lh)
    return (level[y0i, x0i] * (1 - fx) * (1 - fy) + level[y0i, x1i] * fx * (1 - fy)
            + level[y1i, x0i] * (1 - fx) * fy + level[y1i, x1i] * fx * fy)


def sample_map(rs, tex_idx, uv, lod_uv=None):
    """Texel of map `tex_idx` (-1: white) at uv, trilinear at lod_uv
    (log2 of the footprint in uv units) or bilinear at level 0."""
    out = torch.ones((uv.shape[0], 4), dtype=uv.dtype, device=uv.device)
    if rs.textures is None:
        return out
    for k, levels in enumerate(rs.textures):
        sel = torch.nonzero(tex_idx == k, as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        uv_k = uv[sel]
        if lod_uv is None or rs.num_levels == 1:
            out[sel] = _bilinear(levels[0], uv_k)
            continue
        w0 = torch.tensor(float(levels[0].shape[1]), dtype=torch.float32, device=uv.device)
        lod = torch.clamp(lod_uv[sel] + torch.log2(torch.clamp(w0, min=1.0)).to(uv.dtype), 0.0,
                          float(rs.num_levels - 1))
        l0 = torch.floor(lod).to(torch.int64)
        l1 = torch.clamp(l0 + 1, max=rs.num_levels - 1)
        fl = (lod - l0.to(lod.dtype))[:, None]
        t0 = torch.zeros((sel.numel(), 4), dtype=uv.dtype, device=uv.device)
        t1 = torch.zeros_like(t0)
        for lvl in range(rs.num_levels):
            m0 = l0 == lvl
            m1 = l1 == lvl
            if bool(m0.any()):
                t0[m0] = _bilinear(levels[lvl], uv_k[m0])
            if bool(m1.any()):
                t1[m1] = _bilinear(levels[lvl], uv_k[m1])
        out[sel] = t0 * (1.0 - fl) + t1 * fl
    return out


def sky(d, ground, sky_color):
    t = torch.clamp(0.5 * (d[..., 2:3] * 0.0 + d[..., 1:2] + 1.0), 0.0, 1.0)
    return ground * (1.0 - t) + sky_color * t


# --- the estimator ----------------------------------------------------------


def trace(rs, pix, frame, width: int, height: int, settings: dict):
    """One path per lane: pix (global pixel id) and frame, int64 (N,).
    Returns radiance, albedo and normal, each (N, 3) in rs.dtype."""
    dt = rs.dtype
    dev = rs.device
    depth, rr_depth = settings["max_depth"], settings["rr_depth"]
    shadow_scale = settings["shadow_t_scale"]
    ground = torch.tensor(settings["ground_color"], dtype=torch.float32).to(dev, dt)
    sky_c = torch.tensor(settings["sky_color"], dtype=torch.float32).to(dev, dt)
    env_int = torch.tensor(settings["env_intensity"], dtype=torch.float32).to(dev, dt)

    def s4(bounce, seed):
        return sample4(pix, frame, bounce, seed).to(dt)

    px = (pix % width).to(torch.float32).to(dt)
    py = (pix // width).to(torch.float32).to(dt)
    o, d = camera_rays(rs, px, py, width, height, s4(0, 1))
    n = o.shape[0]
    t_all = torch.full((n,), T_MAX, dtype=dt, device=dev)
    hit_t, hit_tri, hit_u, hit_v = closest_hit(rs, o, d, t_all)

    zeros3 = torch.zeros_like(o)
    zeros = zeros3[:, 0]
    throughput = zeros3 + 1.0
    radiance = zeros3
    active = zeros < 1.0
    prev_pdf = zeros
    albedo = zeros3
    normal = zeros3
    path_dist = zeros
    yfov = torch.clamp(rs.cam_yfov, min=1e-3)
    pixel_angle = 2.0 * torch.tan(0.5 * yfov) / height
    for bounce in range(depth):
        l_t, l_rad, l_pdf = light_hit(rs, o, d)
        light_first = l_t < hit_t
        w_light = torch.where(prev_pdf > 0.0, power_heuristic(prev_pdf, l_pdf), 1.0)
        radiance = radiance + torch.where((active & light_first)[:, None],
                                          throughput * l_rad * w_light[:, None], 0.0)
        miss = hit_tri < 0
        env_rad = sky(d, ground[None, :], sky_c[None, :]) * env_int
        w_env = torch.ones_like(zeros)
        radiance = radiance + torch.where((active & miss & ~light_first)[:, None],
                                          throughput * env_rad * w_env[:, None], 0.0)
        active = active & ~miss & ~light_first
        on_surface = active

        tid = torch.clamp(hit_tri, min=0)
        if rs.num_spheres:
            on_sphere = hit_tri >= rs.num_triangles
            sid = torch.clamp(hit_tri - rs.num_triangles, 0, rs.num_spheres - 1)
            tid = torch.clamp(tid, max=rs.num_triangles - 1)
        u, v = hit_u, hit_v
        w0 = 1.0 - u - v
        nrm = rs.normals[tid]
        ns = normalize(w0[:, None] * nrm[:, 0] + u[:, None] * nrm[:, 1] + v[:, None] * nrm[:, 2])
        uvs = rs.uvs[tid]
        uv = w0[:, None] * uvs[:, 0] + u[:, None] * uvs[:, 1] + v[:, None] * uvs[:, 2]
        ng = rs.ng[tid]
        ng = torch.where((dot(ng, ns) < 0)[:, None], -ng, ng)
        hit_p = o + hit_t[:, None] * d
        mat = torch.clamp(rs.tri_mat[tid], min=0)
        if rs.num_spheres:
            ns_s = normalize(hit_p - rs.sph_center[sid])
            ns = torch.where(on_sphere[:, None], ns_s, ns)
            ng = torch.where(on_sphere[:, None], ns_s, ng)
            uv = torch.where(on_sphere[:, None], torch.stack([u, v], dim=1), uv)
            mat = torch.where(on_sphere, rs.sph_mat[sid], mat)
        base = rs.mat_base[mat]
        a_on, b_on = rs.mat_a[mat], rs.mat_b[mat]
        path_dist = path_dist + hit_t * active.to(dt)
        tans = rs.tangents[tid]
        tan_raw = w0[:, None] * tans[:, 0] + u[:, None] * tans[:, 1] + v[:, None] * tans[:, 2]
        if rs.num_spheres:
            tan_raw = torch.where(on_sphere[:, None], 0.0, tan_raw)
        if rs.textures is not None:
            # a sphere's material has no map (RefScene.check), so its
            # texel is white whatever the LOD
            lod_uv = torch.log2(torch.clamp(path_dist * pixel_angle * rs.uv_density[tid], 1e-6, 1e6))
            base = base * sample_map(rs, rs.mat_map[mat], uv, lod_uv)[:, :3]

        entering = dot(ns, -d) >= 0.0
        ns_f = torch.where(entering[:, None], ns, -ns)
        ng_f = torch.where(entering[:, None], ng, -ng)
        t_fb, b_fb = build_basis(ns_f)
        tan_f = tan_raw - ns_f * dot(tan_raw, ns_f)[:, None]
        tan_fl = torch.sqrt(dot(tan_f, tan_f))[:, None]
        has_tan_f = tan_fl[:, 0] > 1e-4
        t_b = torch.where(has_tan_f[:, None], tan_f / torch.clamp(tan_fl, min=1e-12), t_fb)
        b_b = torch.where(has_tan_f[:, None], cross(ns_f, t_b), b_fb)
        wo_l = to_local(-d, t_b, b_b, ns_f)
        wo_l = torch.cat([wo_l[:, :2], torch.clamp(wo_l[:, 2:3], min=1e-5)], dim=1)

        if bounce == 0:
            albedo = torch.where(on_surface[:, None], base, albedo)
            normal = torch.where(on_surface[:, None], ns, normal)

        r_alpha = s4(bounce, 11)
        r_nee = s4(bounce, 13)
        shadow_o = hit_p + ng_f * RAY_EPS
        wi_l, dist_l, rad_l, pdf_l = sample_light(rs, hit_p, r_nee[:, :3])
        wi_ll = to_local(wi_l, t_b, b_b, ns_f)
        f_l, pdf_b = oren_nayar(base, a_on, b_on, wo_l, wi_ll)
        cos_l = torch.abs(wi_ll[:, 2])
        candidate = on_surface & (pdf_l > 0) & (cos_l > 1e-6)
        w_mis = power_heuristic(pdf_l, pdf_b)
        nee = throughput * f_l * (cos_l / torch.clamp(pdf_l, min=1e-12) * w_mis)[:, None] * rad_l
        nee_tmax = torch.where(candidate, dist_l * (1.0 - 1e-4), 0.0)

        r_bsdf = s4(bounce, 19)
        wi_s = cosine_sample(r_bsdf[..., 1], r_bsdf[..., 2])
        f_s, pdf_s = oren_nayar(base, a_on, b_on, wo_l, wi_s)
        wi_w = to_world(wi_s, t_b, b_b, ns_f)
        cos_s = torch.abs(wi_s[:, 2])
        valid_s = pdf_s > 1e-9
        next_tp = throughput * f_s * (cos_s / torch.clamp(pdf_s, min=1e-9))[:, None]
        next_d = wi_w
        offset_n = torch.where((dot(next_d, ng_f) >= 0)[:, None], ng_f, -ng_f)
        next_o = hit_p + offset_n * RAY_EPS + next_d * RAY_EPS
        active = active & valid_s
        if bounce >= rr_depth:
            q = torch.clamp(torch.amax(next_tp, dim=-1), 0.05, 0.95)
            next_tp = next_tp / q[:, None]
            active = active & (r_alpha[:, 1] < q)
        ext_tmax = torch.where(active, T_MAX, 0.0).to(dt)

        q_t, q_tri, q_u, q_v = closest_hit(rs, next_o, next_d, ext_tmax)
        blocked = occluded(rs, shadow_o, wi_l, nee_tmax, shadow_scale)
        radiance = radiance + torch.where((candidate & ~blocked)[:, None], nee, 0.0)
        o, d = next_o, next_d
        hit_t, hit_tri, hit_u, hit_v = q_t, torch.where(active, q_tri, -1), q_u, q_v
        throughput = next_tp
        prev_pdf = pdf_s
    return radiance, albedo, normal


def render_pixels(rs, pixels, frames: int, width: int, height: int, settings: dict,
                  max_lanes: int = 1 << 17):
    """Film values (P, 12: running-mean radiance, albedo and normal,
    each with its weight channel) of `pixels` after frames 0..frames-1,
    accumulated as the renderer's film accumulates."""
    dt = rs.dtype
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=rs.device)
    p = pix.numel()
    acc = [torch.zeros((p, 4), dtype=dt, device=rs.device) for _ in range(3)]
    ones = torch.ones((p, 1), dtype=dt, device=rs.device)
    per = max(1, max_lanes // p)
    for f0 in range(0, frames, per):
        nf = min(per, frames - f0)
        lane_pix = pix.repeat(nf)
        lane_frame = torch.arange(f0, f0 + nf, device=rs.device).repeat_interleave(p)
        rad, alb, nrm = trace(rs, lane_pix, lane_frame, width, height, settings)
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        for k in range(nf):
            f = f0 + k
            inv_n1 = float(np.float32(1.0) / (np.float32(f) + np.float32(1.0)))
            sl = slice(k * p, (k + 1) * p)
            for i, val in enumerate((rad[sl], alb[sl], nrm[sl])):
                old = acc[i]
                acc[i] = old + (torch.cat([val, ones], dim=-1) - old) * inv_n1
    return torch.cat(acc, dim=1)
