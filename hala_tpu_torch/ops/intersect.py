"""Ray-primitive intersection in plain PyTorch.

The chunked brute force here is the ground truth every intersector is
held to, formula for formula the JAX package's `ops/intersect.py`.
Moller-Trumbore is written out component by component, with each
three-term dot product summed left to right, in exactly the order of
the CUDA kernels in csrc/ (compiled with --fmad=false), so a plain
version and its kernel give the same bits on the card.

Also analytic ray-vs-light intersection (quad and sphere lights), so
emissive lights are visible to BSDF rays (needed for MIS).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import cross, dot

T_MAX = 3.0e38
EPS = 1.0e-7
T_MIN = 1.0e-4


class Hit(NamedTuple):
    """Best hit per ray (SoA)."""

    t: torch.Tensor        # (N,) f32, t_max (T_MAX by default) if miss
    tri: torch.Tensor      # (N,) i32 triangle slot, -1 if miss
    u: torch.Tensor        # (N,) f32 barycentric
    v: torch.Tensor        # (N,) f32 barycentric


def full_t_max(t_max, n: int, device) -> torch.Tensor:
    """(n,) f32 t_max: T_MAX when None, broadcast otherwise."""
    if t_max is None:
        return torch.full((n,), T_MAX, dtype=torch.float32, device=device)
    t = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    return torch.broadcast_to(t, (n,)).contiguous()


def ray_triangle(o, d, v0, e1, e2, t_min: float = T_MIN):
    """Moller-Trumbore of rays o, d (N, 3) against v0, e1, e2 (C, 3).
    Returns (t, u, v), each (N, C), with t = T_MAX where invalid."""
    t, u, v, valid = mt_components(
        (o[:, 0:1], o[:, 1:2], o[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
        [a[None, :, i] for a in (v0, e1, e2) for i in range(3)], t_min,
    )
    return torch.where(valid, t, T_MAX), u, v


def mt_components(o3, d3, tri9, t_min: float = T_MIN):
    """Moller-Trumbore on broadcastable components: o3 = (ox, oy, oz),
    d3 = (dx, dy, dz), tri9 = (v0x, v0y, v0z, e1x, ..., e2z). Returns
    (t, u, v, valid) with t as computed (not masked)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    # pvec = d x e2
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
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, u, v, valid


def canonical_hit(o, d, tri_v0, tri_e1, tri_e2, hit: Hit) -> Hit:
    """Re-evaluate (t, u, v) for each ray's winning triangle with the
    same formulas as `ray_triangle`, so the reported bits are a pure
    function of (ray, winning triangle)."""
    tid = torch.clamp(hit.tri, min=0).long()
    v0 = tri_v0[tid]
    e1 = tri_e1[tid]
    e2 = tri_e2[tid]
    pvec = cross(d, e2)
    det = dot(pvec, e1)
    inv_det = torch.where(torch.abs(det) > EPS, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = hit.tri >= 0
    return Hit(
        t=torch.where(ok, t, hit.t),
        tri=hit.tri,
        u=torch.where(ok, u, hit.u),
        v=torch.where(ok, v, hit.v),
    )


def intersect_bruteforce(
    o: torch.Tensor,
    d: torch.Tensor,
    tri_v0: torch.Tensor,
    tri_e1: torch.Tensor,
    tri_e2: torch.Tensor,
    t_max=None,
    chunk: int = 2048,
) -> Hit:
    """Closest hit over all triangles, scanning chunks of `chunk` tris
    (the last may be shorter). Ties go to the lowest slot (first argmin
    within a chunk, strict < across chunks), so chunking never changes
    the result."""
    n = o.shape[0]
    num_tris = tri_v0.shape[0]
    t_best = full_t_max(t_max, n, o.device)
    tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros(n, dtype=torch.float32, device=o.device)
    v_best = torch.zeros(n, dtype=torch.float32, device=o.device)
    rows = torch.arange(n, device=o.device)
    for start in range(0, num_tris, chunk):
        sl = slice(start, start + chunk)
        t, u, v = ray_triangle(o, d, tri_v0[sl], tri_e1[sl], tri_e2[sl])
        t_min, arg = torch.min(t, dim=1)
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        tri = torch.where(better, (start + arg).to(torch.int32), tri)
        u_best = torch.where(better, u[rows, arg], u_best)
        v_best = torch.where(better, v[rows, arg], v_best)
    return Hit(t=t_best, tri=tri, u=u_best, v=v_best)


def occluded_bruteforce(
    o, d, t_far, tri_v0, tri_e1, tri_e2, chunk: int = 2048
) -> torch.Tensor:
    """Any-hit shadow query: True where something lies in
    (T_MIN, t_far * (1 - 1e-4))."""
    num_tris = tri_v0.shape[0]
    lim = full_t_max(t_far, o.shape[0], o.device)[:, None] * (1.0 - 1e-4)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for start in range(0, num_tris, chunk):
        sl = slice(start, start + chunk)
        t, _, _ = ray_triangle(o, d, tri_v0[sl], tri_e1[sl], tri_e2[sl])
        blocked = blocked | torch.any(t < lim, dim=1)
    return blocked


def ray_sphere(o, d, center, radius, t_min: float = T_MIN):
    """Ray-sphere: o,d (N,3); center (L,3); radius (L,). -> t (N,L)."""
    oc = o[:, None, :] - center[None, :, :]
    b = dot(oc, d[:, None, :])
    c = dot(oc, oc) - radius[None, :] ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min, t0, t1)
    valid = (disc > 0.0) & (t > t_min)
    return torch.where(valid, t, T_MAX)


def ray_quad(o, d, corner, edge_u, edge_v, t_min: float = T_MIN):
    """Ray-parallelogram: corner + a*edge_u + b*edge_v, a,b in [0,1].

    corner/edge_u/edge_v: (L,3). Returns t (N,L), T_MAX on miss.
    """
    n = cross(edge_u, edge_v)  # (L,3), unnormalized
    denom = dot(d[:, None, :], n[None, :, :])
    safe = torch.abs(denom) > EPS
    t = dot(corner[None, :, :] - o[:, None, :], n[None, :, :]) / torch.where(
        safe, denom, 1.0
    )
    p = o[:, None, :] + t[..., None] * d[:, None, :] - corner[None, :, :]
    uu = dot(edge_u, edge_u)[None, :]
    vv = dot(edge_v, edge_v)[None, :]
    a = dot(p, edge_u[None, :, :]) / torch.clamp(uu, min=EPS)
    b = dot(p, edge_v[None, :, :]) / torch.clamp(vv, min=EPS)
    valid = safe & (t > t_min) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    return torch.where(valid, t, T_MAX)
