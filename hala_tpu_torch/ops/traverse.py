"""Cluster traversals of the binned-SAH layout: the CUDA kernels
csrc/matrix_traverse.cu (K2) and csrc/traverse_candidates.cu (K5), their
wrappers, and their plain versions.

Both are counterparts of the JAX package's ops/traverse.py and work on
clusters of 128 triangle slots with per-cluster AABBs
(`cluster_min`/`cluster_max`, (C, 3)) and the packed slot blocks
`tri_packed` (C, 16, 128) whose rows 0-8 hold v0/e1/e2.

- `intersect_matrix` / `occluded_matrix` / `matrix_query` (K2): the
  exact closest (or any) hit, an ascending walk over every cluster with
  the conservative slab test of ops/cluster.py. Up to
  MATRIX_MAX_CLUSTERS clusters, as in the JAX package. `matrix_query`
  runs without the JAX package's coherence sort, which changes no
  output; sorting is left to later performance work.
- `intersect_traversed` (K5): the large-scene engine.
  The cull (`cull_candidates`, K4 per superchunk of CULL_MAX_CLUSTERS)
  lists each ray's K nearest slab-entered clusters; K5 walks them
  nearest first with early exit; rays whose list was truncated and
  whose hit lies beyond the K-th entry distance are "unresolved" and
  rerun through K6 (ops/cluster.py) with t_max just above their best
  (`fallback_t_max`), while resolved rays get t_max = -inf and cost K6
  nothing. No cap on C.

Results equal the brute force over all slots, ties to the lowest slot,
except where the reference's unpadded cull slab test misses a grazing
cluster (kept for parity with the JAX package).

The wrappers run the kernels for CUDA tensors and the plain PyTorch
versions for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cluster import (  # noqa: F401  (slab_live, TRI_CHUNK: K2's API)
    TRI_CHUNK,
    check_stream_inputs,
    intersect_clustered,
    slab_live,
    stream_plain,
)
from .cull import _ID_MASK, CULL_MAX_CLUSTERS, INF_KEY, cull_topk
from .intersect import Hit, full_t_max, mt_components

MATRIX_MAX_CLUSTERS = (1 << 13) - 1
BIG_CLUSTER = 0x3FFFFFFF  # "no candidate" id
_INF = 3.0e38             # "no candidate" entry distance
# rays per step of the plain K5 walk: (R, 9, 128) gathered slot blocks
_PLAIN_ROWS = 1 << 15
# (ray, cluster) pairs per step of `cull_ordered`
_ORDERED_PAIRS = 1 << 22


# --- K2: the ascending walk over every cluster --------------------------------


def _launch_matrix(o, d, tm, cmin, cmax, tri_packed, any_hit: bool) -> Hit:
    dev = o.device
    n = o.shape[0]
    c = cmin.shape[0]
    check_stream_inputs("intersect_matrix", o, d, tm, cmin, cmax, tri_packed)
    if c > MATRIX_MAX_CLUSTERS:
        raise ValueError(f"intersect_matrix: {c} clusters > {MATRIX_MAX_CLUSTERS}")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.MATRIX_TRAVERSE(
        P(o), P(d), P(tm), P(cmin), P(cmax), P(tri_packed),
        n, c, int(any_hit),
        P(t_out), P(tri_out), P(u_out), P(v_out), cuda_lib.stream_ptr(dev),
    )
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


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


def matrix_query(o, d, geometry, t_max=None, any_hit: bool = False) -> Hit:
    """The integrator's entry to the cluster traversal (the JAX
    package's coherence-sorted `matrix_query`; unsorted here)."""
    return intersect_matrix(o, d, geometry, t_max=t_max, any_hit=any_hit)


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
                    superchunk: int | None = None):
    """Per-ray K nearest candidate clusters in unpacked (ids, tns) form,
    from K4 (`cull_topk`, its plain version on the CPU) run once per
    superchunk of at most CULL_MAX_CLUSTERS clusters.

    Superchunk lists merge by (tn, global id), as jax.lax.sort with two
    keys: exact, because a candidate outside its own superchunk's top K
    is farther than K candidates of that superchunk. So the id width is
    unbounded and this serves scenes beyond MATRIX_MAX_CLUSTERS.
    `superchunk` forces a smaller split, for tests of the merge. The tns
    are the keys' rounded-down entry distances (lower bounds).

    Returns (ids (N, K) int32 BIG_CLUSTER-padded, tns (N, K) f32
    3e38-padded ascending, overflow (N,) bool)."""
    c = cluster_min.shape[0]
    k = min(k_per_ray, c)
    sc = CULL_MAX_CLUSTERS if superchunk is None else superchunk
    ids_all, tns_all, cnt = [], [], None
    for lo in range(0, c, sc):
        pk, cnt_i = cull_topk(
            o, d, t_max, cluster_min[lo:lo + sc], cluster_max[lo:lo + sc], k=k
        )
        valid = pk != INF_KEY
        ids_all.append(torch.where(valid, (pk & _ID_MASK) + lo, BIG_CLUSTER))
        tns_all.append(torch.where(
            valid, (pk & ~_ID_MASK).view(torch.float32), _INF
        ))
        cnt = cnt_i if cnt is None else cnt + cnt_i
    if len(ids_all) == 1:
        ids, tns = ids_all[0], tns_all[0]
    else:
        # tns are >= 0, so their bits order as integers; ids < 2^30
        tns = torch.cat(tns_all, dim=1)
        ids = torch.cat(ids_all, dim=1)
        key = (tns.view(torch.int32).to(torch.int64) << 31) | ids.to(torch.int64)
        key = torch.sort(key, dim=1).values[:, :k]
        tns = (key >> 31).to(torch.int32).view(torch.float32)
        ids = (key & ((1 << 31) - 1)).to(torch.int32)
    return ids, tns, cnt > k


# --- K5: the candidate walk -------------------------------------------------


def _traverse_plain(o, d, tm, ids, tns, ovf, tri_packed):
    """The plain version of K5: each ray walks its list in order, stops
    at the padding or once the next entry distance exceeds its best t,
    and keeps the lexicographic (t, slot) minimum over the slots of the
    clusters it visits. Returns (Hit, unres int32, runs int32)."""
    n, k = ids.shape
    dev = o.device
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


def _launch_traverse(o, d, tm, ids, tns, ovf, tri_packed):
    dev = o.device
    n, k = ids.shape
    cuda_lib.check_cuda(
        "traverse_candidates",
        dict(o=o, d=d, t_max=tm, ids=ids, tns=tns, ovf=ovf,
             tri_packed=tri_packed),
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
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    unres = torch.empty(n, dtype=torch.int32, device=dev)
    runs = torch.empty(n, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.TRAVERSE_CANDIDATES(
        P(o), P(d), P(tm), P(ids), P(tns), P(ovf), P(tri_packed), n, k,
        P(t_out), P(tri_out), P(u_out), P(v_out), P(unres), P(runs),
        cuda_lib.stream_ptr(dev),
    )
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out), unres, runs


def traverse_candidates_plain(o, d, tm, ids, tns, ovf, tri_packed):
    """The plain version of `traverse_candidates`, on any device."""
    return _traverse_plain(o, d, tm, ids, tns, ovf, tri_packed)


def traverse_candidates(o, d, tm, ids, tns, ovf, tri_packed):
    """K5: the closest hit over each ray's candidate clusters.

    ids (N, K) int32 ascending by entry distance, BIG_CLUSTER-padded;
    tns (N, K) f32 lower bounds of the entry distances; ovf (N,) bool,
    the list was truncated. Returns (Hit, unres (N,) int32 = ovf and
    t > tns[:, K-1], runs (N,) int32 = clusters visited)."""
    if o.device.type == "cpu":
        return _traverse_plain(o, d, tm, ids, tns, ovf, tri_packed)
    return _launch_traverse(o, d, tm, ids, tns, ovf, tri_packed)


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


def _traverse_core(o, d, geometry, tm, ids, tns, ovf) -> Hit:
    """K5 over the candidate lists, then K6 for the unresolved rays,
    launched for every query without a host sync."""
    hit, unres, runs = traverse_candidates(o, d, tm, ids, tns, ovf,
                                           geometry.tri_packed)
    stats.record(tm, unres, runs)
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
) -> Hit:
    """Exact closest hit via per-ray ordered candidate traversal (K4,
    K5) and the K6 fallback for unresolved rays. `k_per_ray` bounds the
    candidate list (capped at C)."""
    n = o.shape[0]
    c = geometry.cluster_min.shape[0]
    k = min(k_per_ray, c)
    tm = full_t_max(t_max, n, o.device)
    ids, tns, ovf = cull_candidates(
        o, d, tm, geometry.cluster_min, geometry.cluster_max, k,
        superchunk=superchunk,
    )
    return _traverse_core(o, d, geometry, tm, ids, tns, ovf)

