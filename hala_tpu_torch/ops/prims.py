"""Procedural (non-triangle) primitives: analytic spheres.

Counterpart of the JAX package's ops/prims.py. Spheres are a small SoA
table intersected analytically after every closest-hit and any-hit
query of the triangle backends, and a merged hit encodes a sphere as
`tri >= PROC_BASE`, so the Hit plumbing stays the triangles'. The
shading (models/integrator.py) overrides the triangle attributes where
`tri >= PROC_BASE`: the normal from the centre, the spherical uv in
`Hit.u/v`, the material from `packed`.

Plain torch on (N, P) tensors: the JAX package computes these outside
any Pallas kernel, so they have no kernel here either. The rules are
the reference's: the first sphere wins a tie, a miss is t = T_MAX with
tri = -1, and a sphere t exactly equal to the triangle's keeps the
triangle.
"""

from __future__ import annotations

import math

import torch

from ..scene.gpu.scene import DeviceProcedural
from .intersect import T_MAX, Hit
from .sampling import dot

# Procedural ids live above every triangle slot id.
PROC_BASE = 1 << 24

# Self-intersection epsilon along the ray: the origin can sit exactly on
# the surface after a bounce off the sphere itself.
_T_EPS = 1e-4


__all__ = ["PROC_BASE", "DeviceProcedural", "intersect_spheres", "occluded_spheres",
           "merge_procedural"]


def _sphere_roots(proc: DeviceProcedural, o, d):
    """(t, ok) per (ray, sphere): the nearest root above the epsilon."""
    oc = o[:, None, :] - proc.center[None, :, :]          # (N, P, 3)
    b = dot(oc, d[:, None, :])                            # (N, P)
    cq = dot(oc, oc) - (proc.radius * proc.radius)[None, :]
    disc = b * b - cq
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > _T_EPS, t0, t1)
    return t, ok & (t > _T_EPS)


def _range(t_max, n: int, device):
    return torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=device), (n,))


def intersect_spheres(proc: DeviceProcedural, o, d, t_max=None) -> Hit:
    """Closest sphere hit per ray: tri = PROC_BASE + sphere index (or
    -1), t = T_MAX on a miss, u/v the spherical parameterization (u from
    atan2 around +Y, v from the latitude)."""
    n = o.shape[0]
    t, ok = _sphere_roots(proc, o, d)
    if t_max is not None:
        ok = ok & (t < _range(t_max, n, o.device)[:, None])
    t_m = torch.where(ok, t, T_MAX)
    # the first minimum on ties, on every device
    t_b = torch.amin(t_m, dim=1)
    idx = torch.arange(t_m.shape[1], device=o.device)
    best = torch.where(t_m == t_b[:, None], idx, t_m.shape[1]).amin(dim=1)
    best = torch.clamp(best, max=t_m.shape[1] - 1)
    hit_any = t_b < T_MAX
    c_b = proc.center[best]
    r_b = proc.radius[best]
    p = o + t_b[:, None] * d
    nrm = (p - c_b) / torch.clamp(r_b, min=1e-12)[:, None]
    u = 0.5 + torch.atan2(nrm[:, 2], nrm[:, 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(nrm[:, 1], -1.0, 1.0)) / math.pi
    tri = torch.where(hit_any, PROC_BASE + best.to(torch.int32), -1).to(torch.int32)
    return Hit(t=t_b, tri=tri, u=torch.where(hit_any, u, 0.0),
               v=torch.where(hit_any, v, 0.0))


def occluded_spheres(proc: DeviceProcedural, o, d, t_far) -> torch.Tensor:
    """(N,) bool: a sphere lies in (eps, t_far)."""
    t, ok = _sphere_roots(proc, o, d)
    tf = _range(t_far, o.shape[0], o.device)
    return torch.any(ok & (t < tf[:, None]), dim=1)


def merge_procedural(proc: DeviceProcedural, o, d, hit: Hit, t_max=None) -> Hit:
    """Fold the closest sphere hit into a triangle Hit; an exactly equal
    t keeps the triangle."""
    ph = intersect_spheres(proc, o, d, t_max)
    closer = (ph.t < hit.t) & (ph.tri >= 0)
    return Hit(
        t=torch.where(closer, ph.t, hit.t),
        tri=torch.where(closer, ph.tri, hit.tri),
        u=torch.where(closer, ph.u, hit.u),
        v=torch.where(closer, ph.v, hit.v),
    )
