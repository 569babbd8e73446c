"""Rank-iteration wavefront traversal: the CUDA kernel
csrc/wavefront_walk.cu (K7), its wrapper, its plain version and the
engine around them.

Counterpart of the JAX package's ops/wavefront.py. Every ray gets its
own K nearest candidate clusters from the cull (K4, ops/cull.py); the
batch is sorted by candidate signature so that a 128-ray group's rays
share most candidates; each group's work list is the deduplicated merge
of its rays' lists, ascending in entry distance and capped at `m`
entries (`_group_lists`); K7 walks it with a per-ray exit bound and a
per-entry want mask, testing clusters by the factored Moller-Trumbore
shared with the grouped walk (ops/traverse.py `mm_chunk_test_plain`,
csrc/mm_chunk_test.cuh).

Exactness: a ray is resolved when its best t lies at or inside both its
own K-th kept entry distance (the cull's truncation) and its own first
candidate the group cap dropped. Unresolved rays rerun through the
sorted `matrix_query` (K2) with t_max preset to their best; the others
get t_max 0 there and do no work, so the fallback is launched for every
query and nothing waits on the host. Winners are re-evaluated with
`canonical_hit`, so the reported bits do not depend on which engine
found the hit.

The integer glue (lists, want mask, bounds, sort order) equals the JAX
package's array for array. The want mask travels as one 32-bit word per
ray (bit j: entry j of the group's list is among the ray's own
candidates), which is why `m` is at most 32.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .compaction import order_by
from .cull import (
    _ID_BITS, _ID_MASK, CULL_MAX_CLUSTERS, CULL_MAX_K, INF_KEY, cull_topk, geometry_unions,
)
from .intersect import Hit, full_t_max
from .traverse import (
    _INF,
    GROUP,
    check_walk_inputs,
    matrix_query,
    merge_fallback,
    pad_to_groups,
    walk_groups_plain,
    walk_stats,
)

M_GROUP = 32      # default cap of a group's merged list
M_GROUP_MAX = 32  # bits of the per-ray want word


def signature_key(pk) -> torch.Tensor:
    """A ray's candidate signature from its ascending packed keys (N, K):
    the ids of its two nearest candidate clusters and the top 5 bits of
    the third, (id0 << 18) | (id1 << 5) | (id2 >> 8). Rays without
    candidates (0x1FFF ids) key last."""
    k = pk.shape[1]
    id0 = pk[:, 0] & _ID_MASK
    id1 = pk[:, min(1, k - 1)] & _ID_MASK
    id2 = pk[:, min(2, k - 1)] & _ID_MASK
    return (id0 << 18) | (id1 << 5) | (id2 >> 8)


def _group_lists(pk, g_total: int, k: int, m: int):
    """Merge per-ray packed top-K lists into per-group work lists.

    pk (G * 128, K) int32 packed keys ascending (INF_KEY-padded).
    Returns (tnb (G, m) int32 packed (tn|id) keys ascending, INF_KEY-
    padded: the cluster id rides the low bits, so this is the work list;
    grp_bound (G,) int32, the first dropped entry's key, INF_KEY if
    nothing was dropped).

    Two sorts along the last axis. The first is on the key with the id
    bits swapped above the entry distance bits, so all occurrences of a
    cluster are adjacent with the group's nearest first; the swap is a
    bijection on 31-bit keys, so the sorted packed keys are rebuilt from
    it. A neighbour compare keeps each cluster's first occurrence, and
    the second sort brings the survivors to the front in entry-distance
    order."""
    tn_bits = 31 - _ID_BITS
    pkg = pk.reshape(g_total, GROUP * k)
    dkey = ((pkg & _ID_MASK) << tn_bits) | (pkg >> _ID_BITS)
    dkey = torch.sort(dkey, dim=1).values
    pk_s = ((dkey & ((1 << tn_bits) - 1)) << _ID_BITS) | (dkey >> tn_bits)
    sid = pk_s & _ID_MASK
    first = pk_s != INF_KEY
    first[:, 1:] &= sid[:, 1:] != sid[:, :-1]
    pk_front = torch.sort(torch.where(first, pk_s, INF_KEY), dim=1).values
    total = first.sum(dim=1)
    tnb = pk_front[:, :m].contiguous()
    grp_bound = torch.where(total > m, pk_front[:, m], INF_KEY)
    return tnb, grp_bound


def want_mask(tnb, pk_s, k: int) -> torch.Tensor:
    """(G, 128, m) bool: entry j of group g is wanted by lane l iff the
    entry's cluster id is among that lane's own candidates."""
    g_total, m = tnb.shape
    eid = torch.where(tnb != INF_KEY, tnb & _ID_MASK, -2)[:, None, :]
    cand = torch.where(pk_s != INF_KEY, pk_s & _ID_MASK, -1)
    cand = cand.reshape(g_total, GROUP, k)
    want = cand[:, :, 0:1] == eid
    for q in range(1, k):  # K steps of (G, 128, m), not one of (G, 128, K, m)
        want |= cand[:, :, q:q + 1] == eid
    return want


def pack_want(want) -> torch.Tensor:
    """(G, 128, m) bool -> (G * 128,) int32, bit j = want[..., j]."""
    m = want.shape[-1]
    # bit 31 as int32 is the sign bit: -2^31
    weights = torch.tensor([(1 << j) - ((1 << 32) if j == 31 else 0) for j in range(m)],
                           dtype=torch.int32, device=want.device)
    return (want.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32).reshape(-1)


def own_last_key(pk_s) -> torch.Tensor:
    """Per ray its last own candidate key (the walk's exit bound), -1
    when it has no candidates."""
    return torch.where(pk_s != INF_KEY, pk_s, -1).amax(dim=1)


def wavefront_walk_plain(o, d, tm, pkl, want, own_last, tri_packed,
                         cluster_min, cluster_max, any_hit: bool = False):
    """The plain version of `wavefront_walk`, on any device."""
    g_total, m = pkl.shape
    c = cluster_min.shape[0]
    want_g = want.view(g_total, GROUP)
    last_g = own_last.view(g_total, GROUP)

    def step(j, t_bits):
        kj = pkl[:, j:j + 1]
        beyond = t_bits > kj
        alive = (beyond & (last_g >= kj)).any(dim=1)
        needed = (beyond & (((want_g >> j) & 1) != 0)).any(dim=1)
        return alive, needed, torch.clamp(pkl[:, j] & _ID_MASK, max=c - 1)

    (t, tri, u, v), walked, tested = walk_groups_plain(
        o, d, tm, tri_packed, cluster_min, cluster_max, m, step, any_hit)
    return t, tri, u, v, torch.stack([walked, tested], dim=1)


def _launch(o, d, tm, pkl, want, own_last, tri_packed, cmin, cmax, any_hit):
    dev = o.device
    n = o.shape[0]
    g_total = n // GROUP
    cuda_lib.check_cuda(
        "wavefront_walk",
        dict(o=o, d=d, t_max=tm, pkl=pkl, want=want, own_last=own_last,
             tri_packed=tri_packed, cluster_min=cmin, cluster_max=cmax),
        dict(pkl=torch.int32, want=torch.int32, own_last=torch.int32), dev,
    )
    check_walk_inputs("wavefront_walk", o, d, tm, tri_packed, cmin, cmax)
    m = pkl.shape[-1]
    if pkl.shape != (g_total, m) or not 1 <= m <= M_GROUP_MAX:
        raise ValueError(f"wavefront_walk: pkl must be (G, m), m <= {M_GROUP_MAX}")
    if want.shape != (n,) or own_last.shape != (n,):
        raise ValueError("wavefront_walk: want and own_last must be (N,)")
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    stats = torch.empty((g_total, 2), dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.WAVEFRONT_WALK(
        P(o), P(d), P(tm), P(pkl), P(want), P(own_last), P(cmin), P(cmax),
        P(tri_packed), g_total, m, cmin.shape[0], _ID_MASK, int(any_hit),
        P(t_out), P(tri_out), P(u_out), P(v_out), P(stats),
        cuda_lib.stream_ptr(dev),
    )
    return t_out, tri_out, u_out, v_out, stats


def wavefront_walk(o, d, tm, pkl, want, own_last, tri_packed, cluster_min,
                   cluster_max, any_hit: bool = False):
    """K7: every group of 128 consecutive rays walks its merged list.

    o, d (N, 3) and tm (N,) with N a multiple of 128; pkl (G, m) int32
    ascending packed (tn|id) keys, INF_KEY-padded, m <= 32; want (N,)
    int32, bit j set iff entry j is among the ray's own candidates;
    own_last (N,) int32, the ray's last own candidate key. The walk of a
    group goes on while some ray has its best t's bits beyond the entry
    key and own_last at or beyond it; an entry is tested (each ray
    against the cluster's slots in the spans it enters, `mm_span_mask`)
    only if some ray wanting it still has its best t beyond the key.
    Returns (t, tri, u, v, stats): per ray the lexicographic (t, slot)
    minimum in (1e-4, t_max) over the tested clusters' spans it enters,
    t = 3e38 and tri = -1 where there is none (with
    any_hit: t = 0 and tri = the cluster's first slot where blocked),
    and stats (G, 2) int32, the walked and the tested entries."""
    if o.device.type == "cpu":
        return wavefront_walk_plain(o, d, tm, pkl, want, own_last, tri_packed,
                                    cluster_min, cluster_max, any_hit)
    return _launch(o, d, tm, pkl, want, own_last, tri_packed, cluster_min,
                   cluster_max, any_hit)


def fallback_bound(pk_s, cnt_s, grp_bound, k: int) -> torch.Tensor:
    """Per ray the packed key beyond which its hit is not proven: its own
    K-th kept key if the cull truncated its list, or its own first
    candidate that the group cap dropped, whichever is nearer (INF_KEY
    when neither). Keys are lower bounds of entry distances, so an int32
    compare of a hit's t bits against it never misses an unresolved ray."""
    ray_bound = torch.where(cnt_s > k, pk_s[:, k - 1], INF_KEY)
    gb_lane = grp_bound.repeat_interleave(GROUP)
    own_dropped = torch.where(pk_s >= gb_lane[:, None], pk_s, INF_KEY).amin(dim=1)
    return torch.minimum(ray_bound, own_dropped)


class WavefrontLists(NamedTuple):
    """A padded batch in signature order with everything K7 reads."""

    inverse: torch.Tensor    # (N,) int64: padded lane -> sorted position
    o: torch.Tensor          # (N, 3), d (N, 3), t_max (N,): the sorted rays
    d: torch.Tensor
    t_max: torch.Tensor
    pk: torch.Tensor         # (N, K) int32 the rays' own packed keys
    cnt: torch.Tensor        # (N,) int32 their total candidate counts
    tnb: torch.Tensor        # (G, m) int32 the groups' merged lists
    grp_bound: torch.Tensor  # (G,) int32 first dropped key per group
    want: torch.Tensor       # (N,) int32 want words
    own_last: torch.Tensor   # (N,) int32


def wavefront_lists(o_p, d_p, tm_p, geometry, k: int, m: int) -> WavefrontLists:
    """The cull (K4), the signature sort and the per-group lists for a
    batch already padded to whole groups."""
    g = geometry
    pk, cnt = cull_topk(o_p, d_p, tm_p, g.cluster_min, g.cluster_max, k=k,
                        unions=geometry_unions(g)[0])
    # stable: the lane index breaks signature ties, a total order
    lane_s, inverse = order_by(signature_key(pk))
    pk_s = pk[lane_s]
    tnb, grp_bound = _group_lists(pk_s, o_p.shape[0] // GROUP, k, m)
    return WavefrontLists(
        inverse=inverse, o=o_p[lane_s], d=d_p[lane_s], t_max=tm_p[lane_s], pk=pk_s,
        cnt=cnt[lane_s], tnb=tnb, grp_bound=grp_bound,
        want=pack_want(want_mask(tnb, pk_s, k)), own_last=own_last_key(pk_s),
    )


def intersect_wavefront(
    o: torch.Tensor,
    d: torch.Tensor,
    geometry,
    t_max=None,
    k_per_ray: int = 16,
    m_group: int = M_GROUP,
    any_hit: bool = False,
) -> Hit:
    """Exact closest (or any) hit via the rank-iteration wavefront.

    `k_per_ray` bounds each ray's candidate list (at most 16, the cull's
    register list), `m_group` each group's merged list (rounded up to a
    multiple of 8 as in the JAX package, at most 32)."""
    n = o.shape[0]
    g = geometry
    c = g.tri_packed.shape[0]
    # c < _ID_MASK keeps a real id from aliasing INF_KEY's low bits
    if not (c < _ID_MASK and c <= CULL_MAX_CLUSTERS):
        raise ValueError(f"intersect_wavefront: {c} clusters exceed the key width")
    k = min(k_per_ray, c)
    if k > CULL_MAX_K:
        raise ValueError(f"intersect_wavefront: k_per_ray {k} > {CULL_MAX_K}")
    m = -(-min(m_group, max(c, 1)) // 8) * 8
    if m > M_GROUP_MAX:
        raise ValueError(f"intersect_wavefront: m_group {m_group} > {M_GROUP_MAX}")
    o_p, d_p, tm_p = pad_to_groups(o, d, full_t_max(t_max, n, o.device))
    w = wavefront_lists(o_p, d_p, tm_p, g, k, m)
    t_acc, tri, u, v, stats = wavefront_walk(
        w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, g.tri_packed,
        g.cluster_min, g.cluster_max, any_hit,
    )
    t_fin = torch.where(t_acc < _INF, t_acc, w.t_max)
    bound = fallback_bound(w.pk, w.cnt, w.grp_bound, k)
    need = torch.clamp(t_fin, min=0.0).view(torch.int32) > bound
    walk_stats.record(w.t_max, stats[:, 0], stats[:, 1], need)
    # the sorted query: this batch is in signature order, and the
    # coherence sort sinks the t_max = 0 rays to the tail
    fb = matrix_query(w.o, w.d, g, t_max=torch.where(need, t_fin, 0.0),
                      any_hit=any_hit)
    hit = merge_fallback(w.o, w.d, g, Hit(t_fin, tri, u, v), fb, need, any_hit)
    return Hit(*(x[w.inverse[:n]] for x in hit))


def occluded_wavefront(o, d, t_far, geometry) -> torch.Tensor:
    """Any-hit wrapper (shadow rays)."""
    return intersect_wavefront(o, d, geometry, t_max=t_far, any_hit=True).tri >= 0
