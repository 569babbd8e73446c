"""The skip-link BVH engine ("bvh"): a host build and a stackless
traversal in plain PyTorch.

Counterpart of the JAX package's ops/bvh.py. The node table is flat, in
depth-first pre-order, with skip links: on a box hit a ray descends to
`node + 1`, on a miss (or after a leaf) it jumps to `skip[node]`, so the
traversal needs one node pointer per ray and no stack. `build_bvh` is
the reference's median-split build on the host, in numpy, making the
same numpy calls in the same order, so on one host its node table
equals the JAX package's bit for bit.

The traversal is the reference's while loop as a Python loop: each step
tests every ray still walking (pointer below the node count) against
its node, runs the leaf's Moller-Trumbore where the box is hit, and
moves the pointer. The loop asks the device once a step how many rays
still walk, and gathers them into a smaller batch whenever fewer than
half are left, so late steps cost little; every ray's result is the
full loop's. No kernel runs here: the JAX package reaches no Pallas
kernel on this path either and keeps it for debugging (DESIGN.md
measures it gather-bound on the TPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.gpu.scene import TensorTables
from .intersect import EPS, T_MIN, Hit, full_t_max
from .sampling import cross, dot

LEAF_SIZE = 4


@dataclasses.dataclass
class BVH(TensorTables):
    """Flat skip-link BVH over the DeviceGeometry triangle soup."""

    node_min: torch.Tensor   # (M, 3) f32
    node_max: torch.Tensor   # (M, 3) f32
    skip: torch.Tensor       # (M,) i32, the next node on a miss / after a leaf
    first_tri: torch.Tensor  # (M,) i32, index into tri_order; -1 = internal
    tri_count: torch.Tensor  # (M,) i32
    tri_order: torch.Tensor  # (T_real + LEAF_SIZE,) i32 leaf-contiguous slots
    num_nodes: int = 0


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def subtree_sizes(spans) -> np.ndarray:
    """Subtree sizes of nodes in pre-order from their (start, end) spans
    (a child's span is a strict sub-range of its parent's, siblings'
    spans are disjoint), in one pass: a stack of open ancestors; each
    node closes the ancestors whose spans do not contain it, adding
    their sizes to their parents'. The JAX build adds one to every open
    ancestor of every node instead (O(nodes x depth)); both give the
    same sizes."""
    m = len(spans)
    sizes = np.ones(m, np.int64)
    stack: list[int] = []

    def close():
        j = stack.pop()
        if stack:
            sizes[stack[-1]] += sizes[j]

    for i in range(m):
        s, e = spans[i]
        while stack and not (spans[stack[-1]][0] <= s and e <= spans[stack[-1]][1]):
            close()
        stack.append(i)
    while stack:
        close()
    return sizes


def build_bvh(geometry) -> BVH:
    """Median-split build on the host over world-space triangles, on the
    geometry's device.

    Real triangles are selected by mask (padding slots may be interior
    under the SAH cluster layout, ops/sahbuild.py); `tri_order` carries
    device-slot indices so leaf gathers hit the right geometry rows."""
    slot = np.nonzero(_np(geometry.tri_mat) >= 0)[0].astype(np.int32)
    v0 = _np(geometry.tri_v0)[slot]
    e1 = _np(geometry.tri_e1)[slot]
    e2 = _np(geometry.tri_e2)[slot]
    n = v0.shape[0]
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = (tmin + tmax) * 0.5

    order = np.arange(n, dtype=np.int32)
    # Each stack entry: a (start, end) range of `order`; nodes are
    # emitted in depth-first pre-order.
    node_min, node_max, first, count = [], [], [], []
    stack = [(0, n)]
    spans = []  # (start, end) per node, for the skip links
    while stack:
        start, end = stack.pop()
        ids = order[start:end]
        bmin = tmin[ids].min(axis=0)
        bmax = tmax[ids].max(axis=0)
        node_min.append(bmin)
        node_max.append(bmax)
        spans.append((start, end))
        if end - start <= LEAF_SIZE:
            first.append(start)
            count.append(end - start)
            continue
        first.append(-1)
        count.append(0)
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (end - start) // 2
        part = np.argpartition(c[:, axis], mid)
        order[start:end] = ids[part]
        # Push the right child first so the left is processed next.
        stack.append((start + mid, end))
        stack.append((start, start + mid))

    m = len(node_min)
    # skip[i] = the first node after i's subtree, which occupies the
    # contiguous block [i, i + size_i) of the pre-order.
    skip = (np.arange(m) + subtree_sizes(spans)).astype(np.int32)
    # device slots, padded so leaf gathers of LEAF_SIZE stay in bounds
    order_pad = np.concatenate([slot[order], np.zeros(LEAF_SIZE, np.int32)])
    dev = geometry.tri_v0.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return BVH(
        node_min=t(np.stack(node_min)),
        node_max=t(np.stack(node_max)),
        skip=t(skip),
        first_tri=t(np.array(first, np.int32)),
        tri_count=t(np.array(count, np.int32)),
        tri_order=t(order_pad.astype(np.int32)),
        num_nodes=m,
    )


def _ray_aabb(o, inv_d, bmin, bmax, t_best):
    """Slab test, all (N, 3) / (N,): the hit mask (N,)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar) & (tfar > 0.0) & (tnear < t_best)


def _leaf_intersect(o, d, bvh, geometry, first, count, t_best, tri, u_best, v_best):
    """Moller-Trumbore of each ray against the up to LEAF_SIZE triangles
    of its leaf (`count` 0 where no leaf is to be tested), keeping the
    first strictly closer hit in slot order."""
    for k in range(LEAF_SIZE):
        tid = bvh.tri_order[(first + k).long()]
        valid = k < count
        tl = tid.long()
        te1 = geometry.tri_e1[tl]
        te2 = geometry.tri_e2[tl]
        pvec = cross(d, te2)
        det = dot(pvec, te1)
        ok_det = torch.abs(det) > EPS
        inv_det = torch.where(ok_det, 1.0 / det, 0.0)
        tvec = o - geometry.tri_v0[tl]
        u = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, te1)
        v = dot(qvec, d) * inv_det
        t = dot(qvec, te2) * inv_det
        ok = (valid & ok_det & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t > T_MIN) & (t < t_best))
        t_best = torch.where(ok, t, t_best)
        tri = torch.where(ok, tid, tri)
        u_best = torch.where(ok, u, u_best)
        v_best = torch.where(ok, v, v_best)
    return t_best, tri, u_best, v_best


class WalkStats:
    """The loop steps of the last `intersect_bvh` call (its longest
    ray's walk), for the records."""

    steps = 0


walk_stats = WalkStats()


def intersect_bvh(bvh: BVH, geometry, o, d, t_max=None) -> Hit:
    """Closest hit in (1e-4, t_max) via the skip-link traversal."""
    n = o.shape[0]
    m = bvh.num_nodes
    dev = o.device
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t_out = full_t_max(t_max, n, dev).clone()  # written below: never the caller's
    tri_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    # the walking rays' state, gathered into a smaller batch as rays end
    idx = torch.arange(n, device=dev)
    o_a, d_a, inv_a = o, d, inv_d
    ptr = torch.zeros(n, dtype=torch.int32, device=dev)
    t_a, tri_a, u_a, v_a = t_out.clone(), tri_out.clone(), u_out.clone(), v_out.clone()
    steps = 0
    while True:
        active = ptr < m
        left = int(active.sum())
        if left == 0:
            break
        if left * 2 <= idx.shape[0]:
            # retire the finished rays, keep walking the others
            done = ~active
            for out, a in ((t_out, t_a), (tri_out, tri_a), (u_out, u_a), (v_out, v_a)):
                out[idx[done]] = a[done]
            keep = torch.nonzero(active).squeeze(1)
            idx, o_a, d_a, inv_a, ptr = idx[keep], o_a[keep], d_a[keep], inv_a[keep], ptr[keep]
            t_a, tri_a, u_a, v_a = t_a[keep], tri_a[keep], u_a[keep], v_a[keep]
            active = torch.ones_like(ptr, dtype=torch.bool)
        steps += 1
        p = torch.clamp(ptr, max=m - 1).long()
        first = bvh.first_tri[p]
        box_hit = _ray_aabb(o_a, inv_a, bvh.node_min[p], bvh.node_max[p], t_a) & active
        is_leaf = first >= 0
        do_leaf = box_hit & is_leaf
        t_a, tri_a, u_a, v_a = _leaf_intersect(
            o_a, d_a, bvh, geometry, torch.clamp(first, min=0),
            torch.where(do_leaf, bvh.tri_count[p], 0), t_a, tri_a, u_a, v_a)
        # descend on an internal hit, otherwise take the skip link
        nxt = torch.where(box_hit & ~is_leaf, ptr + 1, bvh.skip[p])
        ptr = torch.where(active, nxt, ptr)
    for out, a in ((t_out, t_a), (tri_out, tri_a), (u_out, u_a), (v_out, v_a)):
        out[idx] = a
    walk_stats.steps = steps
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


def occluded_bvh(bvh: BVH, geometry, o, d, t_far) -> torch.Tensor:
    """Any-hit query: True where a triangle lies in (1e-4, t_far * (1 - 1e-4))."""
    t_far = full_t_max(t_far, o.shape[0], o.device)
    return intersect_bvh(bvh, geometry, o, d, t_max=t_far * (1.0 - 1e-4)).tri >= 0
