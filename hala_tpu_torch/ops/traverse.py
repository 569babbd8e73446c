"""Cluster traversals of the binned-SAH layout: the CUDA kernels
csrc/matrix_traverse.cu (K2), csrc/traverse_candidates.cu (K5) and
csrc/grouped_walk.cu (K8), their wrappers, and their plain versions.

All are counterparts of the JAX package's ops/traverse.py and work on
clusters of 128 triangle slots with per-cluster AABBs
(`cluster_min`/`cluster_max`, (C, 3)) and the packed slot blocks
`tri_packed` (C, 16, 128) whose rows 0-8 hold v0/e1/e2.

- `intersect_matrix` / `occluded_matrix` (K2): the exact closest (or
  any) hit. Each block of MATRIX_BLOCK_RAYS consecutive rays walks the
  clusters its rays enter front to back (the conservative slab test of
  ops/cluster.py, then the row-9 pretest) and stops once no ray could
  still improve. Up to MATRIX_MAX_CLUSTERS clusters, as in the JAX
  package. `stream_plain` is its plain version (the same hits);
  `matrix_walk_runs_plain` models its schedule, clusters visited per
  block included (`matrix_walk_runs`).
- `matrix_query`: the matrix family's sorted query (ops/query.py). It sorts
  the rays by a coherence key (octant and origin Morton cell, or the
  candidate signature), runs K2, the grouped engine or the wavefront
  engine (ops/wavefront.py) on the sorted batch, and undoes the sort.
- `intersect_grouped` / `occluded_grouped` (K8): each 128-ray group
  walks its nearest `k_cap` candidate clusters, ordered by the group's
  entry distance, testing each ray against the 16-slot spans of each
  cluster that it enters (`mm_span_mask`) by the factored
  Moller-Trumbore `mm_chunk_test_plain` / csrc/mm_chunk_test.cuh; rays
  whose hit lies beyond a truncated list rerun through K2 with t_max
  preset to their best. Winners are re-evaluated with `canonical_hit`.
- `intersect_traversed` (K5): the large-scene engine.
  The cull (`cull_candidates`, K4 per superchunk of CULL_MAX_CLUSTERS)
  lists each ray's K nearest slab-entered clusters; K5 walks them
  nearest first with early exit; rays whose list was truncated and
  whose hit lies beyond the K-th entry distance are "unresolved" and
  rerun through K6 (ops/cluster.py) with t_max just above their best
  (`fallback_t_max`), while resolved rays get t_max = -inf and cost K6
  nothing (`exact=False` skips K6). No cap on C. `traverse_query` runs
  it on the rays sorted by their nearest candidate cluster. Its stages
  are the spans `hala.query.cull` (the K4 launches), `hala.query.merge`
  (the superchunk merge, where there are two or more), `hala.query.walk`
  (K5) and `hala.query.fallback` (K6 and the merge of the two hits); the
  cull span's attr `superchunks` counts the K4 launches.

Results are the lexicographic (t, slot) minimum over the admissible
pairs (ops/cluster.py), the brute force over all slots but where the
classic test accepts a pair outside its padded boxes, except where the
reference's unpadded cull slab test misses a grazing cluster ("traverse";
kept for parity with the JAX package).

The wrappers run the kernels for CUDA tensors and the plain PyTorch
versions for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cluster import (  # noqa: F401  (slab_live, PRETEST_PER_CHUNK: K2's API)
    PRETEST_PER_CHUNK,
    PRETEST_TRIS,
    TRI_CHUNK,
    admissible_limit,
    check_aligned,
    check_stream_inputs,
    intersect_clustered,
    pretest_boxes,
    real_slots,
    slab_entry,
    slab_live,
    span_boxes,
    stream_plain,
)
from .cull import _ID_MASK, CULL_MAX_CLUSTERS, INF_KEY, cull_topk, geometry_unions
from .intersect import EPS, T_MIN, Hit, canonical_hit, full_t_max, mt_components
from .compaction import order_by, query_coherence_key, sorted_query
from ..utils import profiling

MATRIX_MAX_CLUSTERS = (1 << 13) - 1
MATRIX_BLOCK_RAYS = 128  # rays sharing one K2 walk (csrc/matrix_traverse.cu)
MATRIX_WARP_RAYS = 32    # rays sharing one K2 queue of (ray, span) pairs
BIG_CLUSTER = 0x3FFFFFFF  # "no candidate" id
_INF = 3.0e38             # "no candidate" entry distance
# rays per step of the plain K5 walk: (R, 9, 128) gathered slot blocks
_PLAIN_ROWS = 1 << 15
# (ray, cluster) pairs per step of `cull_ordered` and `_group_candidates`
_ORDERED_PAIRS = 1 << 22
GROUP = 128  # rays per group of the grouped and wavefront walks
# groups per step of the plain walks: (R, 128, 128) temporaries
_PLAIN_GROUPS = 256


# --- K2: the front-to-back walk per block of rays ---------------------------


def _launch_matrix(o, d, tm, cmin, cmax, tri_packed, any_hit: bool,
                   with_runs: bool = False):
    dev = o.device
    n = o.shape[0]
    c = cmin.shape[0]
    check_stream_inputs("intersect_matrix", o, d, tm, cmin, cmax, tri_packed)
    check_aligned("intersect_matrix", tri_packed)
    if c > MATRIX_MAX_CLUSTERS:
        raise ValueError(f"intersect_matrix: {c} clusters > {MATRIX_MAX_CLUSTERS}")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    blocks = -(-n // MATRIX_BLOCK_RAYS)
    runs = torch.empty(blocks, dtype=torch.int32, device=dev) if with_runs else None
    work = torch.zeros((blocks, 2), dtype=torch.int32, device=dev) if with_runs else None
    P = cuda_lib.ptr
    cuda_lib.MATRIX_TRAVERSE(
        P(o), P(d), P(tm), P(cmin), P(cmax), P(tri_packed),
        n, c, int(any_hit),
        P(t_out), P(tri_out), P(u_out), P(v_out),
        P(runs) if with_runs else None, P(work) if with_runs else None,
        cuda_lib.stream_ptr(dev),
    )
    hit = Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)
    return (hit, runs, work) if with_runs else hit


def intersect_matrix_plain(o, d, geometry, t_max=None) -> Hit:
    """The plain version of `intersect_matrix`, on any device. It
    returns the closest hit, which also answers any-hit queries."""
    tm = full_t_max(t_max, o.shape[0], o.device)
    return stream_plain(o, d, tm, geometry.cluster_min, geometry.cluster_max,
                        geometry.tri_packed)


def intersect_matrix(
    o: torch.Tensor,
    d: torch.Tensor,
    geometry,
    t_max=None,
    any_hit: bool = False,
) -> Hit:
    """Exact closest hit in (1e-4, t_max) over the cluster layout.

    With `any_hit` only `tri >= 0` is meaningful: the kernel stops a ray
    at its first hit, so t/u/v may belong to any hit in range."""
    if o.device.type == "cpu":
        return intersect_matrix_plain(o, d, geometry, t_max)
    tm = full_t_max(t_max, o.shape[0], o.device)
    return _launch_matrix(o, d, tm, geometry.cluster_min, geometry.cluster_max,
                          geometry.tri_packed, any_hit)


def occluded_matrix(o, d, t_far, geometry) -> torch.Tensor:
    """Any-hit shadow query: True where something lies in (1e-4, t_far)."""
    return intersect_matrix(o, d, geometry, t_max=t_far, any_hit=True).tri >= 0


def matrix_walk_runs(o, d, geometry, t_max=None, any_hit: bool = False):
    """K2 with its schedule: (Hit, runs, work), runs (ceil(N / 128),)
    int32 the clusters each block of MATRIX_BLOCK_RAYS rays visited, work
    (ceil(N / 128), 2) int32 its (ray, span) pairs queued and its packed
    Moller-Trumbore steps (`packed_share`). CPU tensors take
    `matrix_walk_runs_plain`."""
    g = geometry
    tm = full_t_max(t_max, o.shape[0], o.device)
    if o.device.type == "cpu":
        return matrix_walk_runs_plain(o, d, tm, g.cluster_min, g.cluster_max,
                                      g.tri_packed, any_hit)
    return _launch_matrix(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed,
                          any_hit, with_runs=True)


def _block_keys(o, d, tm, cmin, cmax, block: int):
    """Per block of `block` rays and cluster, the least packed key
    (max(tn, 0) bits & ~0x1FFF) | id over the block's live rays (t_max >
    1e-4) that enter the padded box before t_max, INF_KEY where none
    does: (G, C) int32, made in steps of whole blocks."""
    n, c = o.shape[0], cmin.shape[0]
    ids = torch.arange(c, dtype=torch.int32, device=o.device)
    keys = torch.empty((n // block, c), dtype=torch.int32, device=o.device)
    rows = max(block, _ORDERED_PAIRS // max(c, 1) // block * block)
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        tn, enters = slab_entry(o[sl, None, :], d[sl, None, :], cmin[None], cmax[None])
        t = tm[sl, None]
        enters = enters & (tn < t) & (t > T_MIN)
        bits = torch.where(tn > 0.0, tn, 0.0).view(torch.int32) & ~_ID_MASK | ids
        key = torch.where(enters, bits, INF_KEY)
        keys[r0 // block:(r0 + rows) // block] = key.view(-1, block, c).amin(dim=1)
    return keys


def matrix_walk_runs_plain(o, d, tm, cluster_min, cluster_max, tri_packed,
                           any_hit: bool = False):
    """The plain model of K2's schedule, vectorised over blocks of
    MATRIX_BLOCK_RAYS consecutive rays: the
    keys of `_block_keys` in ascending order; a block stops at the first
    key whose entry distance (the key's bits above the id) exceeds the
    best t of every ray still walking (live, and with any_hit not yet
    hit); each walking ray runs its slab test of the cluster and the
    eight row-9 sub-boxes against its best t at the visit's start (tn <=
    t), and Moller-Trumbore on the spans that pass, keeping the
    admissible pairs (ops/cluster.py). Closest hit: the lexicographic (t,
    slot) minimum; any hit: the lowest admissible slot of the first
    cluster with one. Each warp of MATRIX_WARP_RAYS rays queues its (ray,
    span) pairs a visit and runs them two a step. Returns (Hit, runs (G,)
    int32 the clusters each block visited, work (G, 2) int32 the pairs
    queued and the steps)."""
    n = o.shape[0]
    dev = o.device
    block = MATRIX_BLOCK_RAYS
    pad = -n % block
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
        tm = torch.nn.functional.pad(tm, (0, pad))
    keys = torch.sort(_block_keys(o, d, tm, cluster_min, cluster_max, block),
                      dim=1).values
    g_total = keys.shape[0]
    live = tm > T_MIN
    t_best = tm.clone()
    tri = torch.full_like(tm, -1, dtype=torch.int32)
    u_best = torch.zeros_like(tm)
    v_best = torch.zeros_like(tm)
    done = torch.zeros_like(live)
    runs = torch.zeros(g_total, dtype=torch.int32, device=dev)
    work = torch.zeros((g_total, 2), dtype=torch.int64, device=dev)
    warps = block // MATRIX_WARP_RAYS
    walking = torch.ones(g_total, dtype=torch.bool, device=dev)
    span = torch.arange(TRI_CHUNK, device=dev) // PRETEST_TRIS
    slot_k = torch.arange(TRI_CHUNK, dtype=torch.int32, device=dev)
    lo, hi = pretest_boxes(tri_packed)
    for j in range(keys.shape[1]):
        key = keys[:, j]
        key_tn = (key & ~_ID_MASK).view(torch.float32).repeat_interleave(block)
        want = live & ~done & (key_tn <= t_best)
        walking = walking & (key != INF_KEY) & want.view(g_total, block).any(dim=1)
        if not bool(walking.any()):
            break
        runs += walking.to(torch.int32)
        r = torch.nonzero(want & walking.repeat_interleave(block)).squeeze(1)
        c = (key & _ID_MASK)[r // block].long()
        tb = t_best[r]
        tn, enters = slab_entry(o[r], d[r], cluster_min[c], cluster_max[c])
        keep = enters & (tn <= tb)
        r, c, tb, tn_c = r[keep], c[keep], tb[keep], tn[keep]
        tn, enters = slab_entry(o[r, None, :], d[r, None, :], lo[c], hi[c])
        passed = enters & (tn <= tb[:, None])
        queued = torch.zeros(g_total * warps, dtype=torch.int64, device=dev).index_add_(
            0, r // MATRIX_WARP_RAYS, passed.sum(dim=1))
        work[:, 0] += queued.view(g_total, warps).sum(dim=1)
        work[:, 1] += ((queued + 1) // 2).view(g_total, warps).sum(dim=1)
        tested = passed[:, span]
        limit = torch.maximum(tn_c[:, None], tn)[:, span]
        blk = tri_packed[c, 0:9, :]
        o_r, d_r = o[r], d[r]
        t, u, v, valid = mt_components(
            (o_r[:, 0:1], o_r[:, 1:2], o_r[:, 2:3]),
            (d_r[:, 0:1], d_r[:, 1:2], d_r[:, 2:3]),
            [blk[:, q, :] for q in range(9)],
        )
        valid = valid & tested & (limit <= t)
        best = tri[r]
        if any_hit:
            valid = valid & (t < tb[:, None])
            arg = torch.where(valid, slot_k, TRI_CHUNK).amin(dim=1)
        else:
            t_min = torch.where(valid, t, torch.inf).amin(dim=1)
            arg = torch.where(valid & (t == t_min[:, None]), slot_k,
                              TRI_CHUNK).amin(dim=1)
        found = arg < TRI_CHUNK
        at = torch.clamp(arg, max=TRI_CHUNK - 1).long()[:, None]
        t_new = torch.gather(t, 1, at)[:, 0]
        slot = c.to(torch.int32) * TRI_CHUNK + arg
        better = found & ((t_new < tb) | ((t_new == tb) & (best >= 0) & (slot < best)))
        t_best[r] = torch.where(better, t_new, tb)
        tri[r] = torch.where(better, slot, best)
        u_best[r] = torch.where(better, torch.gather(u, 1, at)[:, 0], u_best[r])
        v_best[r] = torch.where(better, torch.gather(v, 1, at)[:, 0], v_best[r])
        if any_hit:
            done[r] = done[r] | better
    hit = Hit(t=t_best[:n], tri=tri[:n], u=u_best[:n], v=v_best[:n])
    return hit, runs, work.to(torch.int32)


def packed_share(work) -> float:
    """How full K2's packed Moller-Trumbore steps run: pairs x 16 slots
    over steps x 32 lanes, for a `work` of `matrix_walk_runs`."""
    pairs, steps = (int(x) for x in work.sum(dim=0, dtype=torch.int64))
    return pairs * PRETEST_TRIS / (steps * MATRIX_WARP_RAYS) if steps else 0.0


# --- candidate lists --------------------------------------------------------


def _ieee_min(a, b):
    """jnp.minimum: NaN-propagating, and -0 below +0."""
    return torch.where(a == b, torch.where(torch.signbit(a), a, b),
                       torch.minimum(a, b))


def _ieee_max(a, b):
    """jnp.maximum: NaN-propagating, and +0 above -0."""
    return torch.where(a == b, torch.where(torch.signbit(a), b, a),
                       torch.maximum(a, b))


def cull_ordered(o, d, t_max, cluster_min, cluster_max, k_per_ray: int):
    """Per-ray candidates ordered by slab entry distance, exact (no key
    rounding): the JAX package's plain `cull_ordered`.

    Returns (ids (N, K) int32 BIG_CLUSTER-padded, tn (N, K) f32
    3e38-padded, overflow (N,) bool: the ray had more than K candidate
    clusters). Candidate k holds the k-th smallest tn; ties go to the
    lowest index (a stable sort, as lax.top_k), so the result does not
    depend on the row chunking."""
    n = o.shape[0]
    c = cluster_min.shape[0]
    k = min(k_per_ray, c)
    safe_d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    inv_d = 1.0 / safe_d
    ids = torch.empty((n, k), dtype=torch.int32, device=o.device)
    tns = torch.empty((n, k), dtype=torch.float32, device=o.device)
    ovf = torch.empty(n, dtype=torch.bool, device=o.device)
    rows = max(1, _ORDERED_PAIRS // max(c, 1))
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        oc, ic, tc = o[sl], inv_d[sl], t_max[sl]
        t0 = (cluster_min[None, :, :] - oc[:, None, :]) * ic[:, None, :]
        t1 = (cluster_max[None, :, :] - oc[:, None, :]) * ic[:, None, :]
        lo = _ieee_min(t0, t1)
        hi = _ieee_max(t0, t1)
        tn = _ieee_max(_ieee_max(lo[..., 0], lo[..., 1]), lo[..., 2])
        tf = _ieee_min(_ieee_min(hi[..., 0], hi[..., 1]), hi[..., 2])
        hit = (tn <= tf) & (tf > 0.0) & (tn < tc[:, None])
        key = torch.where(hit, tn, _INF)
        srt, idx = torch.sort(key, dim=1, stable=True)
        valid = srt[:, :k] < _INF
        ids[sl] = torch.where(valid, idx[:, :k].to(torch.int32), BIG_CLUSTER)
        tns[sl] = torch.where(valid, srt[:, :k], _INF)
        ovf[sl] = hit.sum(dim=1) > k
    return ids, tns, ovf


def cull_candidates(o, d, t_max, cluster_min, cluster_max, k_per_ray: int,
                    superchunk: int | None = None, unions=None):
    """Per-ray K nearest candidate clusters in unpacked (ids, tns) form,
    from K4 (`cull_topk`, its plain version on the CPU) run once per
    superchunk of at most CULL_MAX_CLUSTERS clusters.

    Superchunk lists merge by (tn, global id), as jax.lax.sort with two
    keys: exact, because a candidate outside its own superchunk's top K
    is farther than K candidates of that superchunk. So the id width is
    unbounded and this serves scenes beyond MATRIX_MAX_CLUSTERS.
    `superchunk` forces a smaller split, for tests of the merge. The tns
    are the keys' rounded-down entry distances (lower bounds). `unions`:
    K4's union boxes per superchunk (`cull.geometry_unions`), built per
    launch when not given.

    Returns (ids (N, K) int32 BIG_CLUSTER-padded, tns (N, K) f32
    3e38-padded ascending, overflow (N,) bool)."""
    c = cluster_min.shape[0]
    k = min(k_per_ray, c)
    sc = CULL_MAX_CLUSTERS if superchunk is None else superchunk
    ids_all, tns_all, cnt = [], [], None
    with profiling.span("hala.query.cull", superchunks=-(-c // sc)):
        for j, lo in enumerate(range(0, c, sc)):
            pk, cnt_i = cull_topk(
                o, d, t_max, cluster_min[lo:lo + sc], cluster_max[lo:lo + sc], k=k,
                unions=None if unions is None else unions[j],
            )
            valid = pk != INF_KEY
            ids_all.append(torch.where(valid, (pk & _ID_MASK) + lo, BIG_CLUSTER))
            tns_all.append(torch.where(
                valid, (pk & ~_ID_MASK).view(torch.float32), _INF
            ))
            cnt = cnt_i if cnt is None else cnt + cnt_i
    if len(ids_all) == 1:
        return ids_all[0], tns_all[0], cnt > k
    with profiling.span("hala.query.merge"):
        # tns are >= 0, so their bits order as integers; ids < 2^30
        tns = torch.cat(tns_all, dim=1)
        ids = torch.cat(ids_all, dim=1)
        key = (tns.view(torch.int32).to(torch.int64) << 31) | ids.to(torch.int64)
        key = torch.sort(key, dim=1).values[:, :k]
        tns = (key >> 31).to(torch.int32).view(torch.float32)
        ids = (key & ((1 << 31) - 1)).to(torch.int32)
        return ids, tns, cnt > k


# --- K5: the candidate walk -------------------------------------------------


def _traverse_plain(o, d, tm, ids, tns, ovf, cluster_min, cluster_max, tri_packed):
    """The plain version of K5: each ray walks its list in order, stops
    at the padding or once the next entry distance exceeds its best t,
    and keeps the lexicographic (t, slot) minimum over the admissible
    pairs (ops/cluster.py) of the clusters it visits. Returns (Hit,
    unres int32, runs int32)."""
    n, k = ids.shape
    dev = o.device
    lo, hi = pretest_boxes(tri_packed)
    span = torch.arange(TRI_CHUNK, device=dev) // PRETEST_TRIS
    t_best = tm.clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    runs = torch.zeros(n, dtype=torch.int32, device=dev)
    walking = torch.ones(n, dtype=torch.bool, device=dev)
    slot_k = torch.arange(TRI_CHUNK, dtype=torch.int32, device=dev)
    for j in range(k):
        cid = ids[:, j]
        walking = walking & (cid != BIG_CLUSTER) & ~(tns[:, j] > t_best)
        active = torch.nonzero(walking).squeeze(1)
        if active.numel() == 0:
            break
        runs[active] += 1
        for a0 in range(0, active.numel(), _PLAIN_ROWS):
            r = active[a0:a0 + _PLAIN_ROWS]
            c = cid[r]
            blk = tri_packed[c.long(), 0:9, :]  # (R, 9, 128)
            o_r, d_r = o[r], d[r]
            t, u, v, valid = mt_components(
                (o_r[:, 0:1], o_r[:, 1:2], o_r[:, 2:3]),
                (d_r[:, 0:1], d_r[:, 1:2], d_r[:, 2:3]),
                [blk[:, q, :] for q in range(9)],
            )
            cl = c.long()
            limit = admissible_limit(o_r, d_r, cluster_min[cl], cluster_max[cl],
                                     lo[cl], hi[cl])
            valid = valid & (limit[:, span] <= t)
            t_min, arg = torch.min(torch.where(valid, t, torch.inf), dim=1)
            found = valid.any(dim=1)
            slot = c * TRI_CHUNK + slot_k[arg]
            tb, best = t_best[r], tri[r]
            better = found & (
                (t_min < tb) | ((t_min == tb) & (best >= 0) & (slot < best))
            )
            rr = torch.arange(r.numel(), device=dev)
            t_best[r] = torch.where(better, t_min, tb)
            tri[r] = torch.where(better, slot, best)
            u_best[r] = torch.where(better, u[rr, arg], u_best[r])
            v_best[r] = torch.where(better, v[rr, arg], v_best[r])
    unres = (ovf & (t_best > tns[:, k - 1])).to(torch.int32)
    return Hit(t=t_best, tri=tri, u=u_best, v=v_best), unres, runs


def _launch_traverse(o, d, tm, ids, tns, ovf, cluster_min, cluster_max, tri_packed):
    dev = o.device
    n, k = ids.shape
    cuda_lib.check_cuda(
        "traverse_candidates",
        dict(o=o, d=d, t_max=tm, ids=ids, tns=tns, ovf=ovf, cluster_min=cluster_min,
             cluster_max=cluster_max, tri_packed=tri_packed),
        dict(ids=torch.int32, ovf=torch.bool), dev,
    )
    if o.shape != (n, 3) or d.shape != (n, 3) or tm.shape != (n,):
        raise ValueError("traverse_candidates: o, d must be (N, 3), t_max (N,)")
    if tns.shape != (n, k) or ovf.shape != (n,) or k < 1:
        raise ValueError("traverse_candidates: ids, tns must be (N, K), ovf (N,)")
    if tri_packed.dim() != 3 or tri_packed.shape[1:] != (16, TRI_CHUNK):
        raise ValueError(
            f"traverse_candidates: tri_packed has shape {tuple(tri_packed.shape)}"
        )
    if cluster_min.shape != (tri_packed.shape[0], 3) or cluster_max.shape != cluster_min.shape:
        raise ValueError("traverse_candidates: cluster AABBs must be (C, 3)")
    check_aligned("traverse_candidates", tri_packed)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    unres = torch.empty(n, dtype=torch.int32, device=dev)
    runs = torch.empty(n, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.TRAVERSE_CANDIDATES(
        P(o), P(d), P(tm), P(ids), P(tns), P(ovf), P(cluster_min), P(cluster_max),
        P(tri_packed), n, k,
        P(t_out), P(tri_out), P(u_out), P(v_out), P(unres), P(runs),
        cuda_lib.stream_ptr(dev),
    )
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out), unres, runs


def traverse_candidates_plain(o, d, tm, ids, tns, ovf, cluster_min, cluster_max,
                              tri_packed):
    """The plain version of `traverse_candidates`, on any device."""
    return _traverse_plain(o, d, tm, ids, tns, ovf, cluster_min, cluster_max,
                           tri_packed)


def traverse_candidates(o, d, tm, ids, tns, ovf, cluster_min, cluster_max,
                        tri_packed):
    """K5: the closest hit over the admissible pairs of each ray's
    candidate clusters.

    ids (N, K) int32 ascending by entry distance, BIG_CLUSTER-padded;
    tns (N, K) f32 lower bounds of the entry distances; ovf (N,) bool,
    the list was truncated; cluster_min, cluster_max (C, 3) the boxes
    of the rule's cluster clause. Returns (Hit, unres (N,) int32 = ovf
    and t > tns[:, K-1], runs (N,) int32 = clusters visited)."""
    args = (o, d, tm, ids, tns, ovf, cluster_min, cluster_max, tri_packed)
    if o.device.type == "cpu":
        return _traverse_plain(*args)
    return _launch_traverse(*args)


class TraverseStats:
    """Opt-in counts of the traverse engine, summed on the device (no
    host sync) over every query while `enabled`: live rays (t_max > 0),
    rays K5 left unresolved, and clusters K5 visited."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.queries = 0
        self.live = self.unresolved = self.visits = 0

    def record(self, tm, unres, runs) -> None:
        if not self.enabled:
            return
        self.queries += 1
        self.live = self.live + (tm > 0.0).sum()
        self.unresolved = self.unresolved + unres.sum(dtype=torch.int64)
        self.visits = self.visits + runs.sum(dtype=torch.int64)

    def summary(self) -> dict:
        live = max(int(self.live), 1)
        return dict(queries=self.queries, live_rays=int(self.live),
                    unresolved_share=int(self.unresolved) / live,
                    visits_per_ray=int(self.visits) / live)


stats = TraverseStats()


def fallback_t_max(hit: Hit, unres) -> torch.Tensor:
    """K6's t_max for the exact fallback. Resolved rays get -inf, not 0:
    a ray whose origin lies inside a cluster box has a negative entry
    distance, so 0 would still send it through that cluster's leaf.
    Unresolved rays with a hit get the next float above its t, so K6
    also finds a lower slot at exactly the same t (brute force's tie
    order); those without one keep their t_max."""
    above = torch.nextafter(hit.t, torch.full_like(hit.t, torch.inf))
    t_hit = torch.where(hit.tri >= 0, above, hit.t)
    return torch.where(unres != 0, t_hit, -torch.inf)


def _traverse_core(o, d, geometry, tm, ids, tns, ovf, exact: bool = True) -> Hit:
    """K5 over the candidate lists, then K6 for the unresolved rays,
    launched for every query without a host sync. `exact=False` returns
    K5's hits as they stand (unresolved rays may miss a closer hit)."""
    with profiling.span("hala.query.walk"):
        hit, unres, runs = traverse_candidates(o, d, tm, ids, tns, ovf,
                                               geometry.cluster_min,
                                               geometry.cluster_max, geometry.tri_packed)
        stats.record(tm, unres, runs)
    if not exact:
        return hit
    with profiling.span("hala.query.fallback"):
        fb = intersect_clustered(o, d, geometry, t_max=fallback_t_max(hit, unres))
        # the lexicographic (t, slot) minimum of the two
        better = (fb.tri >= 0) & (
            (fb.t < hit.t) | ((fb.t == hit.t) & (hit.tri >= 0) & (fb.tri < hit.tri))
        )
        return Hit(
            t=torch.where(better, fb.t, hit.t),
            tri=torch.where(better, fb.tri, hit.tri),
            u=torch.where(better, fb.u, hit.u),
            v=torch.where(better, fb.v, hit.v),
        )


def intersect_traversed(
    o: torch.Tensor,
    d: torch.Tensor,
    geometry,
    t_max=None,
    k_per_ray: int = 12,
    superchunk: int | None = None,
    exact: bool = True,
) -> Hit:
    """Closest hit via per-ray ordered candidate traversal (K4, K5) and,
    with `exact` (the default), the K6 fallback for unresolved rays, so
    the result does not depend on K. `k_per_ray` bounds the candidate
    list (capped at C)."""
    n = o.shape[0]
    tm = full_t_max(t_max, n, o.device)
    ids, tns, ovf = _candidates(o, d, geometry, tm, k_per_ray, superchunk)
    return _traverse_core(o, d, geometry, tm, ids, tns, ovf, exact=exact)


def _candidates(o, d, geometry, tm, k_per_ray: int, superchunk: int | None):
    """`cull_candidates` at K = min(k_per_ray, C) with the geometry's
    union boxes."""
    k = min(k_per_ray, geometry.cluster_min.shape[0])
    sc = CULL_MAX_CLUSTERS if superchunk is None else superchunk
    return cull_candidates(
        o, d, tm, geometry.cluster_min, geometry.cluster_max, k,
        superchunk=sc, unions=geometry_unions(geometry, sc),
    )


def traverse_query(o, d, geometry, t_max=None, k_per_ray: int = 12,
                   exact: bool = True) -> Hit:
    """`intersect_traversed` on the rays sorted by their nearest
    candidate cluster and direction octant, key (ids[:, 0] << 3) |
    octant as the JAX package's uint32 (rays without a candidate last),
    under a stable sort, so rays that fetch the same slot blocks sit
    side by side; the sort is undone. The cull runs once, in the input
    order."""
    n = o.shape[0]
    tm = full_t_max(t_max, n, o.device)
    ids, tns, ovf = _candidates(o, d, geometry, tm, k_per_ray, None)
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    key = ((ids[:, 0].to(torch.int64) << 3) | octant) & 0xFFFFFFFF
    order, inverse = order_by(key)
    hit = _traverse_core(o[order], d[order], geometry, tm[order], ids[order],
                         tns[order], ovf[order], exact=exact)
    return Hit(*(x[inverse] for x in hit))



# --- the factored Moller-Trumbore of the grouped and wavefront walks ------------


def mm_coefficients(tri_packed, cluster_min, cluster_max):
    """Per-slot coefficients (C, 16, 128) of the factored
    Moller-Trumbore, rows [n(3), c1(3), c2(3), e1(3), e2(3), c0], and
    the cluster centres cc = 0.5 * (cmin + cmax), (C, 3), the triangles
    are re-centred on: v0' = v0 - cc, n = e1 x e2, c0 = v0'.n,
    c1 = e2 x v0', c2 = v0' x e1. Written out operation for operation
    as csrc/mm_chunk_test.cuh `mm_stage` forms them (the kernels build
    them in shared memory and read no table). Padding slots (zero
    edges) give n = 0, so det = 0 and they never hit."""
    cc = 0.5 * (cluster_min + cluster_max)
    v0x, v0y, v0z = (tri_packed[:, q, :] - cc[:, q, None] for q in range(3))
    e1x, e1y, e1z = (tri_packed[:, q, :] for q in (3, 4, 5))
    e2x, e2y, e2z = (tri_packed[:, q, :] for q in (6, 7, 8))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    c0 = v0x * nx + v0y * ny + v0z * nz
    coef = torch.stack([
        nx, ny, nz,
        e2y * v0z - e2z * v0y, e2z * v0x - e2x * v0z, e2x * v0y - e2y * v0x,
        v0y * e1z - v0z * e1y, v0z * e1x - v0x * e1z, v0x * e1y - v0y * e1x,
        e1x, e1y, e1z, e2x, e2y, e2z, c0,
    ], dim=1)
    return coef, cc


def mm_span_mask(o, d, tm, t_cur, lo, hi, cmin, cmax):
    """(R, 128, 8) f32: per ray and span of a group's entry, the least t
    at which a pair may be admissible (ops/cluster.py
    `admissible_limit`: max(tn_c, tn_s) of the cluster's and the span's
    padded boxes), +inf where the span is out. o, d (R, 128, 3), tm and
    t_cur (R, 128), the entry's span boxes lo, hi (R, 8, 3) and cluster
    box cmin, cmax (R, 3). A span is out where the ray's range is dead
    (t_max <= 1e-4) or the limit exceeds t_cur (the ray's best t at the
    start of the entry, its t_max while it has no hit and always for
    any-hit): every admissible pair there lies beyond t_cur. A pair at
    t is accepted where limit <= t."""
    limit = admissible_limit(o, d, cmin[:, None], cmax[:, None], lo[:, None], hi[:, None])
    keep = (limit <= t_cur[..., None]) & (tm > T_MIN)[..., None]
    return torch.where(keep, limit, torch.inf)


def mm_terms(coef, cc, o, d):
    """The four sums of the factored Moller-Trumbore, (det, u_num,
    v_num, t_num), each (R, 128 rays, 128 slots): coef (R, 16, 128) and
    cc (R, 3) of R clusters, o, d (R, 128, 3). det = -(d.n),
    u_num = w'.e2 - d.c1, v_num = -(w'.e1 + d.c2), t_num = o'.n - c0
    with o' = o - cc and w' = o x d - cc x d, each three-term dot
    product summed left to right: the order of csrc/mm_chunk_test.cuh,
    which rounds alike."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ccx, ccy, ccz = cc[:, 0:1], cc[:, 1:2], cc[:, 2:3]
    opx, opy, opz = ox - ccx, oy - ccy, oz - ccz
    wpx = (oy * dz - oz * dy) - (ccy * dz - ccz * dy)
    wpy = (oz * dx - ox * dz) - (ccz * dx - ccx * dz)
    wpz = (ox * dy - oy * dx) - (ccx * dy - ccy * dx)

    def ray(a):  # (R, 128 rays, 1)
        return a[:, :, None]

    def tri(q):  # (R, 1, 128 slots)
        return coef[:, q, None, :]

    dx, dy, dz = ray(dx), ray(dy), ray(dz)
    wpx, wpy, wpz = ray(wpx), ray(wpy), ray(wpz)
    det = -(dx * tri(0) + dy * tri(1) + dz * tri(2))
    un = (wpx * tri(12) + wpy * tri(13) + wpz * tri(14)) - (
        dx * tri(3) + dy * tri(4) + dz * tri(5))
    vn = -((wpx * tri(9) + wpy * tri(10) + wpz * tri(11)) + (
        dx * tri(6) + dy * tri(7) + dz * tri(8)))
    tn = (ray(opx) * tri(0) + ray(opy) * tri(1) + ray(opz) * tri(2)) - tri(15)
    return det, un, vn, tn


def mm_barycentric_pass(det, un, vn):
    """The division-free half of the test: |det| > eps and both
    barycentric numerators, signed by det, in the triangle. The kernels
    form t_num, the reciprocal and the range test only where it passes."""
    sg = torch.where(det >= 0.0, 1.0, -1.0)
    adet = det * sg
    us = un * sg
    vs = vn * sg
    return (adet > EPS) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= adet)


def mm_chunk_test_plain(coef, cc, cid, o, d, tm, any_hit: bool, span):
    """R groups of 128 rays, each against the 128 slots of one cluster:
    the JAX package's `_mm_chunk_test` with a pair at t accepted only
    where t >= its span's limit `span` (R, 128, 8) (`mm_span_mask`).
    coef (R, 16, 128)
    and cc (R, 3) of the clusters cid (R,); o, d (R, 128, 3); tm
    (R, 128). Returns (t, tri, u, v), each (R, 128): per ray the hit of
    lowest t in (1e-4, t_max), the lowest slot among equal t, or
    (3e38, -1, 0, 0); with any_hit (0, cid * 128, 0, 0) where any slot
    is hit. The sums are `mm_terms`'; the kernels divide only where
    `mm_barycentric_pass` holds, which gives the same bits."""
    det, un, vn, tn = mm_terms(coef, cc, o, d)
    inv_det = 1.0 / torch.where(torch.abs(det) > EPS, det, 1.0)
    tt = tn * inv_det
    valid = (mm_barycentric_pass(det, un, vn) & (tt > T_MIN) & (tt < tm[:, :, None])
             & (span.repeat_interleave(PRETEST_TRIS, dim=2) <= tt))
    base = (cid * TRI_CHUNK).to(torch.int32)[:, None]
    if any_hit:
        blocked = valid.any(dim=2)
        zeros = torch.zeros_like(tm)
        return (torch.where(blocked, 0.0, _INF),
                torch.where(blocked, base, -1), zeros, zeros)
    t_new, win = torch.min(torch.where(valid, tt, _INF), dim=2)
    # torch.min returns the first index among equal values on the CPU
    # only; take the lowest slot among the minima explicitly
    slots = torch.arange(TRI_CHUNK, dtype=torch.int32, device=o.device)
    cand = valid & (tt == t_new[:, :, None])
    win = torch.where(cand, slots, TRI_CHUNK).amin(dim=2)
    found = t_new < _INF
    at = torch.clamp(win, max=TRI_CHUNK - 1).long()[:, :, None]
    u_new = torch.gather(un * inv_det, 2, at)[:, :, 0]
    v_new = torch.gather(vn * inv_det, 2, at)[:, :, 0]
    return (t_new, torch.where(found, base + win, -1),
            torch.where(found, u_new, 0.0), torch.where(found, v_new, 0.0))


def mm_merge(acc, new):
    """The lexicographic (t, slot) minimum of two (t, tri, u, v) tuples."""
    t_a, tri_a, _, _ = acc
    t_n, tri_n, _, _ = new
    take = (t_n < t_a) | (
        (t_n == t_a) & (tri_n >= 0) & ((tri_n < tri_a) | (tri_a < 0)))
    return tuple(torch.where(take, y, x) for x, y in zip(acc, new))


def walk_groups_plain(o, d, tm, tri_packed, cluster_min, cluster_max,
                      entries: int, step, any_hit: bool):
    """The group walk both plain versions share. `step(j, t_bits)` gives
    for entry j the groups still walking (G,) bool (a group that stops
    stays stopped), those that test it (G,) bool and its cluster per
    group (G,) int. Returns (t, tri, u, v) as (N,) tensors, and per
    group the walked and the tested entries. A tested entry accepts a
    ray's pairs only by the admissibility rule (`mm_span_mask`)."""
    dev = o.device
    g_total = o.shape[0] // GROUP
    coef, cc = mm_coefficients(tri_packed, cluster_min, cluster_max)
    lo, hi = span_boxes(tri_packed, real_slots(tri_packed))
    o_g, d_g = o.view(g_total, GROUP, 3), d.view(g_total, GROUP, 3)
    tm_g = tm.view(g_total, GROUP)
    acc = (
        torch.full((g_total, GROUP), _INF, dtype=torch.float32, device=dev),
        torch.full((g_total, GROUP), -1, dtype=torch.int32, device=dev),
        torch.zeros((g_total, GROUP), dtype=torch.float32, device=dev),
        torch.zeros((g_total, GROUP), dtype=torch.float32, device=dev),
    )
    walking = torch.ones(g_total, dtype=torch.bool, device=dev)
    walked = torch.zeros(g_total, dtype=torch.int32, device=dev)
    tested = torch.zeros(g_total, dtype=torch.int32, device=dev)
    for j in range(entries):
        alive, needed, cid = step(j, acc[0].view(torch.int32))
        walking = walking & alive
        if not bool(walking.any()):
            break
        walked += walking.to(torch.int32)
        run = walking & needed
        tested += run.to(torch.int32)
        rows = torch.nonzero(run).squeeze(1)
        for r0 in range(0, rows.numel(), _PLAIN_GROUPS):
            r = rows[r0:r0 + _PLAIN_GROUPS]
            c = cid[r].long()
            t_cur = tm_g[r] if any_hit else torch.where(acc[1][r] >= 0, acc[0][r], tm_g[r])
            span = mm_span_mask(o_g[r], d_g[r], tm_g[r], t_cur, lo[c], hi[c],
                                cluster_min[c], cluster_max[c])
            new = mm_chunk_test_plain(coef[c], cc[c], c, o_g[r], d_g[r],
                                      tm_g[r], any_hit, span)
            merged = mm_merge(tuple(a[r] for a in acc), new)
            for a, m in zip(acc, merged):
                a[r] = m
    return tuple(a.reshape(-1) for a in acc), walked, tested


# --- K8: the grouped walk -------------------------------------------------------


def grouped_walk_plain(o, d, tm, counts, ids, tnb, tri_packed, cluster_min,
                       cluster_max, any_hit: bool = False):
    """The plain version of `grouped_walk`, on any device."""
    k = ids.shape[1]

    def step(j, t_bits):
        alive = (j < counts) & (t_bits > tnb[:, j:j + 1]).any(dim=1)
        return alive, alive, ids[:, j]

    (t, tri, u, v), walked, _ = walk_groups_plain(
        o, d, tm, tri_packed, cluster_min, cluster_max, k, step, any_hit)
    return t, tri, u, v, walked


def check_walk_inputs(name, o, d, tm, tri_packed, cluster_min, cluster_max):
    """Raise unless the rays come in whole groups and the cluster tables
    have the shapes the walk kernels read (dtype, device and contiguity
    are checked by `cuda_lib.check_cuda`)."""
    n = o.shape[0]
    c = cluster_min.shape[0]
    if n % GROUP or o.shape != (n, 3) or d.shape != (n, 3) or tm.shape != (n,):
        raise ValueError(f"{name}: o, d must be (N, 3), t_max (N,), "
                         f"N a multiple of {GROUP}")
    if cluster_min.shape != (c, 3) or cluster_max.shape != (c, 3):
        raise ValueError(f"{name}: cluster AABBs must be (C, 3)")
    if tri_packed.shape != (c, 16, TRI_CHUNK):
        raise ValueError(f"{name}: tri_packed has shape {tuple(tri_packed.shape)}")


def _launch_grouped(o, d, tm, counts, ids, tnb, tri_packed, cmin, cmax,
                    any_hit: bool):
    dev = o.device
    n = o.shape[0]
    g_total = n // GROUP
    cuda_lib.check_cuda(
        "grouped_walk",
        dict(o=o, d=d, t_max=tm, counts=counts, ids=ids, tnb=tnb,
             tri_packed=tri_packed, cluster_min=cmin, cluster_max=cmax),
        dict(counts=torch.int32, ids=torch.int32, tnb=torch.int32), dev,
    )
    check_walk_inputs("grouped_walk", o, d, tm, tri_packed, cmin, cmax)
    k = ids.shape[-1]
    if counts.shape != (g_total,) or ids.shape != (g_total, k) or (
            tnb.shape != (g_total, k)) or k < 1:
        raise ValueError("grouped_walk: counts must be (G,), ids and tnb (G, K)")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    walked = torch.empty(g_total, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.GROUPED_WALK(
        P(o), P(d), P(tm), P(counts), P(ids), P(tnb), P(cmin), P(cmax),
        P(tri_packed), g_total, k, int(any_hit),
        P(t_out), P(tri_out), P(u_out), P(v_out), P(walked),
        cuda_lib.stream_ptr(dev),
    )
    return t_out, tri_out, u_out, v_out, walked


def grouped_walk(o, d, tm, counts, ids, tnb, tri_packed, cluster_min,
                 cluster_max, any_hit: bool = False):
    """K8: every group of 128 consecutive rays walks its candidate list.

    o, d (N, 3) and tm (N,) with N a multiple of 128; counts (G,) int32
    entries to walk; ids (G, K) int32 cluster ids in [0, C); tnb (G, K)
    int32, the bits of the ascending entry distances (lower bounds).
    Returns (t, tri, u, v, walked): per ray the lexicographic (t, slot)
    minimum in (1e-4, t_max) over the walked clusters' spans it enters
    (`mm_span_mask`), t = 3e38 and
    tri = -1 where there is none (with any_hit: t = 0 and tri = the
    cluster's first slot where blocked), and per group the entries
    walked before every ray's t was at or inside the next distance."""
    if o.device.type == "cpu":
        return grouped_walk_plain(o, d, tm, counts, ids, tnb, tri_packed,
                                  cluster_min, cluster_max, any_hit)
    return _launch_grouped(o, d, tm, counts, ids, tnb, tri_packed,
                           cluster_min, cluster_max, any_hit)


def _group_candidates(o, d, tm, cluster_min, cluster_max, k: int):
    """Per-group candidate clusters ordered by entry distance.

    Returns (ids (G, K) int32 with C as the empty-slot sentinel, tns
    (G, K) f32 kept entry distances ascending (3e38-padded), usz (G,)
    int32, the size of the group's whole union). The group entry
    distance is the minimum over the group's rays of the per-ray slab
    entry distance, so every cluster the group does not test lies at or
    beyond the last kept distance for every ray of the group. Equal
    distances keep the lower cluster id first (lax.top_k's order); the
    (G, C) distances are made in steps of whole groups."""
    n = o.shape[0]
    c = cluster_min.shape[0]
    g_total = n // GROUP
    safe_d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    inv = 1.0 / safe_d
    tn_g = torch.empty((g_total, c), dtype=torch.float32, device=o.device)
    pairs = _ORDERED_PAIRS * (4 if o.is_cuda else 1)
    groups = max(1, pairs // (GROUP * max(c, 1)))
    for g0 in range(0, g_total, groups):
        sl = slice(g0 * GROUP, (g0 + groups) * GROUP)
        oc, ic, tc = o[sl], inv[sl], tm[sl, None]
        t0 = (cluster_min[None] - oc[:, None]) * ic[:, None]
        t1 = (cluster_max[None] - oc[:, None]) * ic[:, None]
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tn <= tf) & (tf > 0.0) & (tn < tc) & (tc > 0.0)
        # max(tn, 0) with +0 for tn = -0, as jnp.maximum gives it
        key = torch.where(hit, torch.where(tn > 0.0, tn, 0.0), _INF)
        tn_g[g0:g0 + groups] = key.view(-1, GROUP, c).amin(dim=1)
    usz = (tn_g < _INF).sum(dim=1, dtype=torch.int32)
    # distances are >= +0, so their bits order as integers; the cluster
    # id in the low bits breaks ties to the lower id
    key = (tn_g.view(torch.int32).to(torch.int64) << 16) | torch.arange(
        c, device=o.device)
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    tns = (key >> 16).to(torch.int32).view(torch.float32)
    valid = tns < _INF
    ids = torch.where(valid, (key & 0xFFFF).to(torch.int32), c)
    return ids, torch.where(valid, tns, _INF), usz


class WalkStats:
    """Opt-in counts of the grouped and wavefront engines, summed on the
    device (no host sync) over every query while `enabled`: groups,
    walked and tested list entries, live rays (t_max > 0) and rays sent
    to the exact fallback."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.queries = 0
        self.groups = 0
        self.walked = self.tested = self.live = self.need = 0

    def record(self, tm, walked, tested, need) -> None:
        if not self.enabled:
            return
        self.queries += 1
        self.groups += walked.shape[0]
        self.walked = self.walked + walked.sum(dtype=torch.int64)
        self.tested = self.tested + tested.sum(dtype=torch.int64)
        self.live = self.live + (tm > 0.0).sum()
        self.need = self.need + need.sum()

    def summary(self) -> dict:
        groups = max(self.groups, 1)
        return dict(queries=self.queries, groups=self.groups,
                    walked_per_group=int(self.walked) / groups,
                    tested_per_group=int(self.tested) / groups,
                    need_share=int(self.need) / max(int(self.live), 1))


walk_stats = WalkStats()


def pad_to_groups(o, d, tm):
    """Pad a ray batch to a multiple of GROUP with dead rays (d = 1,
    t_max = 0), as the JAX package does."""
    n = o.shape[0]
    pad = -n % GROUP
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, pad))
        d = torch.nn.functional.pad(d, (0, 0, 0, pad), value=1.0)
        tm = torch.nn.functional.pad(tm, (0, pad))
    return o.contiguous(), d.contiguous(), tm.contiguous()


def merge_fallback(o, d, geometry, kern: Hit, fb: Hit, need, canonical: bool) -> Hit:
    """Merge a walk's hits with the exact fallback's on the `need` rays;
    exact ties go to the lower triangle id. With `canonical` both are
    first re-evaluated with `canonical_hit`, so the reported bits depend
    on (ray, winning triangle) alone."""
    if canonical:
        g = geometry
        kern = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, kern)
        fbc = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, fb)
        fb = Hit(t=torch.where(fb.tri >= 0, fbc.t, fb.t), tri=fb.tri,
                 u=fbc.u, v=fbc.v)
    closer = need & (fb.tri >= 0) & (
        (fb.t < kern.t)
        | ((fb.t == kern.t) & ((fb.tri < kern.tri) | (kern.tri < 0)))
    )
    return Hit(*(torch.where(closer, y, x) for x, y in zip(kern, fb)))


def intersect_grouped(
    o: torch.Tensor,
    d: torch.Tensor,
    geometry,
    t_max=None,
    any_hit: bool = False,
    k_cap: int = 32,
) -> Hit:
    """Exact closest (or any) hit via the grouped walk (K8).

    `k_cap` bounds each group's candidate list. Rays of a truncated
    group whose best t lies beyond the last kept entry distance rerun
    through K2 (`intersect_matrix`) with t_max preset to their best;
    every other ray gets t_max 0 there and does no work, so K2 is
    launched for every query and nothing waits on the host."""
    n = o.shape[0]
    g = geometry
    c = g.tri_packed.shape[0]
    k = min(k_cap, c)
    o_p, d_p, tm_p = pad_to_groups(o, d, full_t_max(t_max, n, o.device))
    ids, tns, usz = _group_candidates(o_p, d_p, tm_p, g.cluster_min,
                                      g.cluster_max, k)
    counts = torch.clamp(usz, max=k)
    t_acc, tri, u, v, walked = grouped_walk(
        o_p, d_p, tm_p, counts, torch.clamp(ids, max=c - 1).contiguous(),
        tns.view(torch.int32), g.tri_packed, g.cluster_min, g.cluster_max,
        any_hit,
    )
    t_fin = torch.where(t_acc < _INF, t_acc, tm_p)
    bound = torch.where(usz > k, tns[:, -1], _INF)
    need = t_fin > bound.repeat_interleave(GROUP)
    walk_stats.record(tm_p, walked, walked, need)
    fb = intersect_matrix(o_p, d_p, g, t_max=torch.where(need, t_fin, 0.0),
                          any_hit=any_hit)
    hit = merge_fallback(o_p, d_p, g, Hit(t_fin, tri, u, v), fb, need, not any_hit)
    return Hit(*(x[:n] for x in hit))


def occluded_grouped(o, d, t_far, geometry) -> torch.Tensor:
    """Any-hit wrapper over `intersect_grouped` (shadow rays)."""
    return intersect_grouped(o, d, geometry, t_max=t_far, any_hit=True).tri >= 0


# --- the coherence-sorted entry of the matrix family -----------------------------


def matrix_query(
    o, d, geometry, t_max=None, any_hit: bool = False,
    kernel: str = "matrix", wavefront_k: int = 16, wavefront_m: int = 32,
    sort_key: str = "morton",
) -> Hit:
    """The matrix family's sorted query: the query runs on the rays
    sorted by a coherence key (`compaction.sorted_query`) and the sort
    is undone.

    `kernel` picks the walker: "matrix" (K2), "grouped" (K8: the sort is
    what makes its 128-ray groups tight) or "wavefront" (K4 + K7,
    ops/wavefront.py, which sorts by candidate signature itself and is
    handed the whole query). `sort_key` "morton" keys rays by octant and
    origin Morton cell; "signature" by their candidate signature
    (`wavefront.signature_key` of K4's four nearest clusters, one more
    cull launch), so rays that want the same clusters sit side by side.
    The sort is stable, as the JAX package's; every walker is exact
    under any order, so the key changes the time, not the hits."""
    if kernel not in ("matrix", "grouped", "wavefront"):
        raise ValueError(f"matrix_query: unknown kernel {kernel!r}")
    if sort_key not in ("morton", "signature"):
        raise ValueError(f"matrix_query: unknown sort_key {sort_key!r}")
    g = geometry
    tm = full_t_max(t_max, o.shape[0], o.device)
    if kernel == "wavefront":
        from .wavefront import intersect_wavefront

        return intersect_wavefront(o, d, g, t_max=tm, any_hit=any_hit,
                                   k_per_ray=wavefront_k, m_group=wavefront_m)
    if sort_key == "signature":
        from .wavefront import signature_key

        def key(o, d, tm):
            pk, _ = cull_topk(o, d, tm, g.cluster_min, g.cluster_max, k=4,
                              unions=geometry_unions(g)[0])
            return signature_key(pk)
    else:
        def key(o, d, tm):
            return query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max)
    walk = intersect_grouped if kernel == "grouped" else intersect_matrix
    return sorted_query(
        key, lambda o, d, tm: walk(o, d, g, t_max=tm, any_hit=any_hit), o, d, tm)
