"""Cluster streaming: the CUDA kernel csrc/cluster_stream.cu, its wrapper,
and its plain version.

Counterpart of the JAX package's ops/cluster.py: `intersect_clustered`
is the exact closest hit over clusters of 128 triangle slots with
per-cluster AABBs (`cluster_min`/`cluster_max`, (C, 3)) and the packed
slot blocks `tri_packed` (C, 16, 128) whose rows 0-8 hold v0/e1/e2. It
serves `intersector="cluster"` and the exact fallback of the candidate
traversal (ops/traverse.py `intersect_traversed`). No cap on C.

The kernel gives each ray whose t_max is above t_min a warp, drawn
from a device queue (`live_queue`): the lanes split the union boxes of
16 consecutive clusters (`stream_unions`, kept per geometry), then the
members of each union entered (the conservative padded slab test,
csrc/cluster_walk.cuh explains each case; the TPU kernel's safety net,
a 1024-ray block's union of slab hits, does not exist for one ray
alone), and share Moller-Trumbore over the slots of each cluster
entered, keeping the lexicographic (t, slot) minimum over the
admissible pairs (below). The plain version walks the clusters in
ascending order with a strict `<`, brute force's tie order. K2 (ops/traverse.py, capped at MATRIX_MAX_CLUSTERS)
walks the clusters front to back and returns the same hits, so
`stream_plain` is the plain version of both.

The admissibility rule. The walks over clusters (K2, K5, K6 and their
plain versions; K7 and K8 on their factored test) accept a (ray, slot)
pair only where it is *admissible*: Moller-Trumbore accepts it with t in
(1e-4, t_max), the ray enters the padded box of the slot's cluster at
an entry distance tn_c <= t (`slab_entry`), and it enters the padded
box of the slot's 16-slot span (`span_boxes`, row 9) at tn_s <= t. The
closest hit is the lexicographic (t, slot) minimum over the admissible
pairs, the any hit whether one exists. The rule reads no running best
t, so it does not rest on the order in which a walk meets the clusters,
and every skip of a box entered beyond the best t is exact: each
admissible pair in it has t above the best. It is needed because no
fixed padding covers the classic test's slack: for a ray nearly in a
triangle's plane, det can be as small as 1e-7 and the rounding of u, v
grows with |o - v0| / |det|, so Moller-Trumbore alone accepts noise
hits outside the triangle's box (and outside the padded boxes). The
brute force K1 has no boxes and accepts them: it differs from the
cluster walks only on pairs the rule rejects.

The JAX module's `subchunk_aabb_row`, `cull_clusters`,
`build_cluster_tables_device` and `refit_clusters` are not ported: no
path of the port calls them yet.

The wrappers run the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from .cull import CULL_GROUP, FAR_COORD, box_unions, cached_on
from .intersect import T_MAX, T_MIN, Hit, full_t_max, ray_triangle

TRI_CHUNK = 128  # == scene/gpu TRI_PAD
# tri_packed row 9 holds the [min.xyz | max.xyz] boxes of 8 spans of 16
# slots (lanes 0-47), the pretest of K2 and K5 (scene/loader/uploader.py)
PRETEST_TRIS = 16
PRETEST_PER_CHUNK = TRI_CHUNK // PRETEST_TRIS
# clusters per step of the plain walk: (N, 16 * 128) temporaries
_PLAIN_GROUP = 16

# Slab-test constants, as float32 values identical to the kernels'.
_PAD_REL = float(np.float32(1e-5))
_PAD_ABS = float(np.float32(1e-6))
_TINY_DIR = float(np.float32(1e-20))
_WIDEN_UP = float(np.float32(1.0) + np.float32(1e-6))
_WIDEN_DOWN = float(np.float32(1.0) - np.float32(1e-6))


def slab_entry(o, d, lo3, hi3):
    """Conservative slab test of rays against boxes, broadcast over the
    leading dims of o, d (..., 3) and the box corners lo3, hi3 (..., 3):
    (tn, enters), the widened-down entry distance and True where the
    ray enters the padded box at all. Same operations, in the same
    order, as csrc/cluster_walk.cuh `slab_entry`."""
    tn = tf = None
    inside = None
    for ax in range(3):
        lo = lo3[..., ax]
        hi = hi3[..., ax]
        pad = _PAD_REL * (torch.abs(lo) + torch.abs(hi)) + _PAD_ABS
        lo_p = lo - pad
        hi_p = hi + pad
        oa = o[..., ax]
        da = d[..., ax]
        inv = 1.0 / da
        t0 = (lo_p - oa) * inv
        t1 = (hi_p - oa) * inv
        par = torch.abs(da) < _TINY_DIR
        tn_a = torch.where(par, -torch.inf, torch.minimum(t0, t1))
        tf_a = torch.where(par, torch.inf, torch.maximum(t0, t1))
        in_a = ~par | ((lo_p <= oa) & (oa <= hi_p))
        tn = tn_a if tn is None else torch.maximum(tn, tn_a)
        tf = tf_a if tf is None else torch.minimum(tf, tf_a)
        inside = in_a if inside is None else inside & in_a
    tn = torch.where(tn < 0.0, tn * _WIDEN_UP, tn * _WIDEN_DOWN)
    tf = torch.where(tf > 0.0, tf * _WIDEN_UP, tf * _WIDEN_DOWN)
    return tn, inside & (tn <= tf) & (tf > 0.0)


def slab_live(o, d, cmin, cmax, t_cur):
    """Conservative slab test of rays (N, 3) against boxes (G, 3):
    (N, G) bool, True where a hit in the box could still beat t_cur
    (csrc/cluster_walk.cuh `slab_live`)."""
    tn, enters = slab_entry(o[:, None, :], d[:, None, :], cmin[None], cmax[None])
    return enters & (tn < t_cur[:, None])


FAR_BOX = 3.0e37    # the point box of a span without triangles
WHOLE_BOX = 1.0e38  # the box of a span with a non-finite corner


def real_slots(tri_packed):
    """(C, 128) bool: the slots of blocks (C, 16, 128) with a nonzero
    edge (padding slots have both edges zero)."""
    return ((tri_packed[:, 3:6] != 0) | (tri_packed[:, 6:9] != 0)).any(dim=1)


def span_boxes(tri_packed, real):
    """The boxes (lo, hi), each (C, 8, 3), of the 8 spans of 16 slots of
    blocks (C, 16, 128), over the slots `real` (C, 128) marks: per slot
    the min and max of v0, v0 + e1, v0 + e2, NaN coordinates left out,
    reduced over the span. A span without a real slot gets the far
    point box at 3e37, a span with a non-finite corner the box +-1e38,
    which every live ray enters (so no pretest drops a finite triangle
    beside it). Row 9 of `tri_packed` (the uploader, `with_pretest_row`)
    and the walks' span mask (ops/traverse.py `mm_span_mask`,
    csrc/mm_chunk_test.cuh `mm_stage`) are these boxes."""
    c = tri_packed.shape[0]
    v0, e1, e2 = tri_packed[:, 0:3], tri_packed[:, 3:6], tri_packed[:, 6:9]
    v1, v2 = v0 + e1, v0 + e2
    real = real[:, None, :]
    lo = torch.fmin(torch.fmin(v0, v1), v2)
    hi = torch.fmax(torch.fmax(v0, v1), v2)
    lo = torch.where(real & ~torch.isnan(lo), lo, torch.inf)
    hi = torch.where(real & ~torch.isnan(hi), hi, -torch.inf)
    spans = (c, 3, PRETEST_PER_CHUNK, PRETEST_TRIS)
    lo = lo.view(spans).amin(dim=-1).permute(0, 2, 1)
    hi = hi.view(spans).amax(dim=-1).permute(0, 2, 1)
    empty = ~real.view(c, PRETEST_PER_CHUNK, PRETEST_TRIS).any(dim=-1)[..., None]
    whole = ~(torch.isfinite(lo).all(dim=-1) & torch.isfinite(hi).all(dim=-1))[..., None]
    lo = torch.where(empty, FAR_BOX, torch.where(whole, -WHOLE_BOX, lo))
    hi = torch.where(empty, FAR_BOX, torch.where(whole, WHOLE_BOX, hi))
    return lo.contiguous(), hi.contiguous()


def with_pretest_row(tri_packed):
    """A copy of hand-built slot blocks (C, 16, 128) with row 9 (lanes
    0-47) filled as the uploader fills it: the [lo.xyz | hi.xyz]
    `span_boxes` of the real slots, span by span."""
    lo, hi = span_boxes(tri_packed, real_slots(tri_packed))
    out = tri_packed.clone()
    out[:, 9, :6 * PRETEST_PER_CHUNK] = torch.cat([lo, hi], dim=2).reshape(lo.shape[0], -1)
    return out


def _slot_table(tri_packed):
    """(C, 16, 128) blocks -> v0, e1, e2 as (C * 128, 3) in slot order."""
    rows = tri_packed[:, 0:9, :].permute(0, 2, 1).reshape(-1, 9)
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]


def pretest_boxes(tri_packed):
    """Row 9 of slot blocks (C, 16, 128) as the span boxes (lo, hi),
    each (C, 8, 3)."""
    b = tri_packed[:, 9, :6 * PRETEST_PER_CHUNK].reshape(-1, PRETEST_PER_CHUNK, 6)
    return b[..., :3], b[..., 3:]


def entry_or_inf(o, d, lo3, hi3):
    """`slab_entry`'s entry distance where the ray enters the padded box,
    +inf where it does not: a pair at t in the box is admissible only
    where this is <= t."""
    tn, enters = slab_entry(o, d, lo3, hi3)
    return torch.where(enters, tn, torch.inf)


def admissible_limit(o, d, cmin, cmax, lo, hi):
    """The least t at which a pair may be admissible, per (ray, span):
    max(tn_c, tn_s) of the cluster's and the span's padded boxes, +inf
    where the ray enters either not at all. o, d (..., 3) and the boxes
    cmin, cmax (..., 3), lo, hi (..., 8, 3) broadcast; (..., 8)."""
    tn_c = entry_or_inf(o, d, cmin, cmax)
    tn_s = entry_or_inf(o[..., None, :], d[..., None, :], lo, hi)
    return torch.maximum(tn_c[..., None], tn_s)


def stream_plain(o, d, tm, cmin, cmax, tri_packed) -> Hit:
    """The plain ascending cluster walk of K6, and K2's plain version
    (the same hits): clusters in ascending groups; each (ray, cluster)
    pair runs Moller-Trumbore only where the slab test passes against
    the ray's best t at the start of the group, and keeps the admissible
    pairs (the module's rule, with the span boxes of row 9; first argmin
    inside a group, strict `<` across groups: brute force's tie order).
    The kernels test each cluster and span against the current best t,
    which only prunes boxes that hold no admissible pair that could
    win."""
    n = o.shape[0]
    c = cmin.shape[0]
    v0, e1, e2 = _slot_table(tri_packed)
    lo, hi = pretest_boxes(tri_packed)
    t_best = tm.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros(n, dtype=torch.float32, device=o.device)
    v_best = torch.zeros(n, dtype=torch.float32, device=o.device)
    for g0 in range(0, c, _PLAIN_GROUP):
        g1 = min(g0 + _PLAIN_GROUP, c)
        live = slab_live(o, d, cmin[g0:g1], cmax[g0:g1], t_best)
        rows = torch.nonzero(live.any(dim=1)).squeeze(1)
        if rows.numel() == 0:
            continue
        o_r, d_r = o[rows, None, :], d[rows, None, :]
        limit = admissible_limit(o_r, d_r, cmin[None, g0:g1], cmax[None, g0:g1],
                                 lo[None, g0:g1], hi[None, g0:g1])
        limit = torch.where(live[rows][..., None], limit, torch.inf)
        sl = slice(g0 * TRI_CHUNK, g1 * TRI_CHUNK)
        t, u, v = ray_triangle(o[rows], d[rows], v0[sl], e1[sl], e2[sl])
        limit = limit.reshape(rows.numel(), -1).repeat_interleave(PRETEST_TRIS, dim=1)
        t = torch.where(limit <= t, t, T_MAX)
        t_min, arg = torch.min(t, dim=1)
        better = t_min < t_best[rows]
        r = torch.arange(rows.numel(), device=o.device)
        t_best[rows] = torch.where(better, t_min, t_best[rows])
        tri[rows] = torch.where(
            better, (g0 * TRI_CHUNK + arg).to(torch.int32), tri[rows]
        )
        u_best[rows] = torch.where(better, u[r, arg], u_best[rows])
        v_best[rows] = torch.where(better, v[r, arg], v_best[rows])
    return Hit(t=t_best, tri=tri, u=u_best, v=v_best)


def check_stream_inputs(name, o, d, tm, cmin, cmax, tri_packed) -> None:
    """Raise unless the walk's inputs are contiguous float32 tensors on
    one CUDA device with the shapes the kernels read."""
    n = o.shape[0]
    c = cmin.shape[0]
    cuda_lib.check_cuda(
        name,
        dict(o=o, d=d, t_max=tm, cluster_min=cmin, cluster_max=cmax,
             tri_packed=tri_packed),
        {}, o.device,
    )
    if o.shape != (n, 3) or d.shape != (n, 3) or tm.shape != (n,):
        raise ValueError(f"{name}: o, d must be (N, 3), t_max (N,)")
    if cmax.shape != (c, 3) or cmin.shape != (c, 3):
        raise ValueError(f"{name}: cluster AABBs must be (C, 3)")
    if tri_packed.shape != (c, 16, TRI_CHUNK):
        raise ValueError(
            f"{name}: tri_packed has shape {tuple(tri_packed.shape)}"
        )


def live_queue(tm):
    """K6's work queue, built on tm's device without a host sync: int32
    (N + 3,) = [count, 0, the ids of the rays with t_max > 1e-4 in
    ascending order, then unspecified]. queue[0] is the count, queue[1]
    the pop counter the kernel advances."""
    n = tm.shape[0]
    live = tm > T_MIN
    pos = torch.cumsum(live, 0, dtype=torch.int32)  # inclusive
    queue = torch.zeros(n + 3, dtype=torch.int32, device=tm.device)
    if n:
        queue[0:1] = pos[-1:]
    # live ray i goes to 2 + pos[i] - 1; the others to the spare last slot
    dst = torch.where(live, pos + 1, n + 2).long()
    queue.scatter_(0, dst, torch.arange(n, dtype=torch.int32, device=tm.device))
    return queue


def stream_unions(cluster_min, cluster_max):
    """K6's union boxes: `cull.box_unions` of the clusters' padded boxes
    (`slab_entry`'s padding, the operations of csrc/cluster_walk.cuh
    `pad_axis`). Near members have every corner coordinate below
    FAR_COORD in magnitude; the others (NaN, infinite or 3e37 corners)
    are far and tested on their own: the padded test drops a NaN
    (fminf / fmaxf), so it may enter a box with a NaN corner."""
    pad = _PAD_REL * (torch.abs(cluster_min) + torch.abs(cluster_max)) + _PAD_ABS
    lo_p = cluster_min - pad
    hi_p = cluster_max + pad
    near = (torch.abs(torch.cat([cluster_min, cluster_max], dim=1)) < FAR_COORD).all(dim=1)
    return box_unions(torch.minimum(lo_p, hi_p), torch.maximum(lo_p, hi_p), near, ~near)


def check_aligned(name, tri_packed) -> None:
    """Raise unless the slot blocks start on 16 bytes: K2 copies them
    with 16-byte cp.async, K5 and K6 read them as float4."""
    if tri_packed.data_ptr() % 16:
        raise ValueError(f"{name}: tri_packed is not 16-byte aligned")


def _launch(o, d, tm, cmin, cmax, tri_packed, unions) -> Hit:
    dev = o.device
    n = o.shape[0]
    check_stream_inputs("intersect_clustered", o, d, tm, cmin, cmax, tri_packed)
    check_aligned("intersect_clustered", tri_packed)
    cuda_lib.check_cuda("intersect_clustered", dict(unions=unions), {}, dev)
    if unions.shape != (-(-cmin.shape[0] // CULL_GROUP), 8) or unions.data_ptr() % 16:
        raise ValueError("intersect_clustered: unions must be (G, 8), 16-byte aligned")
    queue = live_queue(tm)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.CLUSTER_STREAM(
        P(o), P(d), P(tm), P(cmin), P(cmax), P(unions), P(tri_packed), P(queue),
        n, cmin.shape[0],
        P(t_out), P(tri_out), P(u_out), P(v_out), cuda_lib.stream_ptr(dev),
    )
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


def intersect_clustered_plain(o, d, geometry, t_max=None) -> Hit:
    """The plain version of `intersect_clustered`, on any device."""
    tm = full_t_max(t_max, o.shape[0], o.device)
    return stream_plain(o, d, tm, geometry.cluster_min, geometry.cluster_max,
                        geometry.tri_packed)


def intersect_clustered(o, d, geometry, t_max=None) -> Hit:
    """Exact closest hit in (1e-4, t_max) streaming every cluster. Rays
    with t_max at or below 1e-4 (-inf included) keep t_max and miss."""
    if o.device.type == "cpu":
        return intersect_clustered_plain(o, d, geometry, t_max)
    tm = full_t_max(t_max, o.shape[0], o.device)
    cmin, cmax = geometry.cluster_min, geometry.cluster_max
    unions = cached_on(geometry, "_stream_unions", lambda: stream_unions(cmin, cmax))
    return _launch(o, d, tm, cmin, cmax, geometry.tri_packed, unions)

