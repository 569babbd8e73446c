"""The dense engine: each ray's K nearest clusters from the cull (K4),
tested pair by pair in plain PyTorch, with K2 for truncated lists.

Counterpart of the JAX package's ops/dense.py, which the integrator runs
for the split shadow query when `RenderSettings.shadow_dense_k` > 0:

1. `cull_topk` (K4, ops/cull.py) gives each ray its K nearest candidate
   clusters in entry order and its total candidate count;
2. every (ray, candidate) pair gathers the cluster's rows 0-8 (v0, e1,
   e2 of its 128 slots) and runs Moller-Trumbore on all 128 slots (the
   arithmetic of `intersect.mt_components`, that of K2 and of its plain
   version), keeping each ray's least packed key
   (t bits & ~slot_mask) | slot, slot = rank * 128 + lane;
3. the winner is re-evaluated by `canonical_hit`, so the reported bits
   are a function of (ray, winning triangle);
4. rays whose list truncated and whose best t lies beyond the K-th
   entry's distance (a lower bound of every untested cluster's) rerun
   through K2 (`intersect_matrix`) with t_max preset to it and merge by
   the (t, triangle) rule of `traverse.merge_fallback`.

Three decisions of the port:

- The admissibility rule (ops/cluster.py). The dense test is a cluster
  walk over the cull's candidates and its fallback is K2, which applies
  the rule, so the dense test applies it too: a pair at t counts only
  where the ray enters the padded box of the slot's cluster and of its
  16-slot span (row 9) at or before t. Then `occluded_dense` equals K2's
  any-hit mask wherever the cull enters the cluster of K2's blocker (the
  reference's unpadded slab test can miss a grazing cluster; ROADMAP
  Queue 3), and a dense-shadow film equals the "matrix" film. The JAX
  engine has no rule; the two differ only on pairs the rule rejects.
- Memory. The JAX engine gathers one (N, 9, 128) block per rank; at the
  port's 2^20-ray tiles that is 4.8 GB. Here only the pairs with a
  candidate are tested, DENSE_CHUNK_PAIRS at a time, so a query's peak
  stays near 0.6 GB whatever N. The chunks' keys meet in a
  scatter-min, so the result does not depend on the chunking.
- K. K4 keeps each ray's list in registers and takes K <= CULL_MAX_K
  (16); the JAX cull takes any K. A larger K raises.

The packed key rounds t down to 2^slot_bits ulps (slot_bits 10 at K 8),
so among hits whose t share that granule the lower slot wins, as in the
JAX engine: a winner may differ from K2's exact (t, slot) minimum at
such near-ties, and only there.
"""

from __future__ import annotations

import torch

from .cluster import PRETEST_TRIS, TRI_CHUNK, admissible_limit, pretest_boxes
from .cull import _ID_MASK, CULL_MAX_CLUSTERS, CULL_MAX_K, INF_KEY, cull_topk, geometry_unions
from .intersect import Hit, canonical_hit, full_t_max, mt_components
from .traverse import intersect_matrix, merge_fallback

DENSE_MAX_CLUSTERS = CULL_MAX_CLUSTERS
# (ray, candidate) pairs tested at a time: (P, 9, 128) gathered rows and
# (P, 128) temporaries, about 0.6 GB at 2^15
DENSE_CHUNK_PAIRS = 1 << 15
_INF = 3.0e38


def _unpack_tn(pk):
    """The entry-distance lower bound of a packed cull key (the id bits
    round tn down)."""
    return (pk & ~_ID_MASK).view(torch.float32)


def _dense_keys(o, d, tm, geometry, ids, valid, slot_bits: int):
    """Per ray the least packed key (t bits & ~slot_mask) | slot over the
    admissible pairs in (1e-4, t_max) of its valid candidates, INF_KEY
    where there is none: (N,) int32."""
    g = geometry
    n, k = ids.shape
    dev = o.device
    slot_mask = (1 << slot_bits) - 1
    lo, hi = pretest_boxes(g.tri_packed)
    lane = torch.arange(TRI_CHUNK, dtype=torch.int32, device=dev)
    best = torch.full((n,), INF_KEY, dtype=torch.int32, device=dev)
    pairs = torch.nonzero(valid)  # (P, 2): ray, rank
    for p0 in range(0, pairs.shape[0], DENSE_CHUNK_PAIRS):
        r, kk = pairs[p0:p0 + DENSE_CHUNK_PAIRS].unbind(1)
        c = ids[r, kk].long()
        blk = g.tri_packed[c, 0:9, :]  # (P, 9, 128)
        o_r, d_r = o[r], d[r]
        t, _, _, ok = mt_components(
            (o_r[:, 0:1], o_r[:, 1:2], o_r[:, 2:3]),
            (d_r[:, 0:1], d_r[:, 1:2], d_r[:, 2:3]),
            [blk[:, q, :] for q in range(9)],
        )
        limit = admissible_limit(o_r, d_r, g.cluster_min[c], g.cluster_max[c], lo[c], hi[c])
        ok = ok & (t < tm[r, None]) & (limit.repeat_interleave(PRETEST_TRIS, dim=1) <= t)
        slot = (kk.to(torch.int32) * TRI_CHUNK)[:, None] + lane
        key = (torch.clamp(t, min=0.0).view(torch.int32) & ~slot_mask) | slot
        key = torch.where(ok, key, INF_KEY).amin(dim=1)
        best.scatter_reduce_(0, r, key, reduce="amin")
    return best


def intersect_dense(
    o: torch.Tensor,
    d: torch.Tensor,
    geometry,
    t_max=None,
    k: int = 8,
    any_hit: bool = False,
    fallback: bool = True,
) -> Hit:
    """Closest (or, with any_hit, any) hit in (1e-4, t_max) over each
    ray's K nearest candidate clusters, exact through the K2 fallback
    unless `fallback` is off. With any_hit only `tri >= 0` is meaningful."""
    g = geometry
    c = g.tri_packed.shape[0]
    if c > DENSE_MAX_CLUSTERS:
        raise ValueError(f"intersect_dense: {c} clusters exceed the cull's "
                         f"{DENSE_MAX_CLUSTERS}-id key width")
    if not 1 <= k <= CULL_MAX_K:
        raise ValueError(
            f"intersect_dense: k = {k} outside [1, {CULL_MAX_K}]: the cull "
            f"kernel (csrc/cull_topk.cu) keeps each ray's list in registers")
    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    tm = full_t_max(t_max, n, o.device)
    pk, cnt = cull_topk(o, d, tm, g.cluster_min, g.cluster_max, k=k,
                        unions=geometry_unions(g)[0])
    valid = pk != INF_KEY
    ids = torch.where(valid, pk & _ID_MASK, 0)
    slot_bits = max((k * TRI_CHUNK - 1).bit_length(), 1)
    best = _dense_keys(o, d, tm, g, ids, valid, slot_bits)
    found = best != INF_KEY
    slot = best & ((1 << slot_bits) - 1)
    win_k = torch.where(found, slot // TRI_CHUNK, 0).long()
    tri = torch.where(found, torch.gather(ids, 1, win_k[:, None])[:, 0] * TRI_CHUNK
                      + slot % TRI_CHUNK, -1)
    zeros = torch.zeros_like(tm)
    kern = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2,
                         Hit(t=tm, tri=tri, u=zeros, v=zeros))
    if not fallback:
        return kern
    # every untested cluster lies at entry distance >= the K-th kept one
    bound = torch.where(cnt > k, _unpack_tn(pk[:, k - 1]), _INF)
    need = kern.t > bound
    fb = intersect_matrix(o, d, g, t_max=torch.where(need, kern.t, 0.0), any_hit=any_hit)
    return merge_fallback(o, d, g, kern, fb, need, canonical=True)


def occluded_dense(o, d, t_far, geometry, k: int = 8) -> torch.Tensor:
    """Any-hit shadow query over the dense engine: True where an
    admissible pair lies in (1e-4, t_far)."""
    return intersect_dense(o, d, geometry, t_max=t_far, k=k, any_hit=True).tri >= 0
