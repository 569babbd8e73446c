"""Per-ray ordered top-K cluster cull: the CUDA kernel csrc/cull_topk.cu,
its wrapper, and its plain version.

Counterpart of the JAX package's `cull_topk` (ops/cull.py there): for
each ray, the K nearest cluster AABBs its slab test enters, as ascending
packed keys `(bits(max(tn, 0)) & ~_ID_MASK) | id` (INF_KEY-padded), plus
the ray's total candidate count, so `count > K` means the list was
truncated. Positive float bits order as int32, so one int32 compare
orders by entry distance and breaks ties to the smaller id; the 13
sacrificed mantissa bits round each tn DOWN, which every consumer
tolerates (ordering is only for speed; the truncation bound compares a
hit t with a lower bound of the entry distance).

The slab test is the reference's own, unpadded (csrc/cull_topk.cu
lists it), so the keys equal the JAX kernel's bit for bit. The JAX
package's `chunk` argument is gone: it split the clusters for the TPU's
VMEM budget, and its merge is exact.

The kernel skips, a warp at a time, every group of CULL_GROUP
consecutive boxes whose union box no lane of the warp enters
(`group_unions` builds the unions on the device; csrc/cull_topk.cu
says why the skip never changes pk or cnt). `geometry_unions` keeps
one set per geometry and superchunk.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch

from . import cuda_lib

INF_KEY = 0x7FFFFFFF  # no-candidate sentinel (> any packed real key)
_ID_BITS = 13
_ID_MASK = (1 << _ID_BITS) - 1
CULL_MAX_CLUSTERS = 1 << _ID_BITS
CULL_MAX_K = 16  # the kernel keeps its list in registers
CULL_GROUP = 16  # consecutive boxes under one union box (csrc/cull_topk.cu)
# A box with a coordinate at or beyond this magnitude (the 3e37 point
# boxes of empty clusters, infinities) stays out of its group's union
# and is tested on its own.
FAR_COORD = 1.0e30
# (ray, cluster) pairs per step of the plain version
_PLAIN_PAIRS = 1 << 22


def slab_keys(o, d, t_max, cluster_min, cluster_max):
    """(N, C) int32 packed keys, INF_KEY where the ray misses the box,
    and the (N, C) bool hit mask: the reference's slab test, with its
    NaN-propagating min/max (torch.minimum/maximum) and its rounding."""
    inv = torch.where(torch.abs(d) < 1e-12, 1e12, 1.0 / d)
    t0 = (cluster_min[None, :, :] - o[:, None, :]) * inv[:, None, :]
    t1 = (cluster_max[None, :, :] - o[:, None, :]) * inv[:, None, :]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    tm = t_max[:, None]
    hit = (tn <= tf) & (tf > 0.0) & (tn < tm) & (tm > 0.0)
    # max(tn, 0) as jnp.maximum gives it (+0 for tn = -0; NaN never hits)
    bits = torch.where(tn > 0.0, tn, 0.0).view(torch.int32)
    cid = torch.arange(cluster_min.shape[0], dtype=torch.int32, device=o.device)
    key = torch.where(hit, (bits & ~_ID_MASK) | cid, INF_KEY)
    return key, hit


def cull_topk_plain(o, d, t_max, cluster_min, cluster_max, k: int = 16):
    """The plain version of `cull_topk`, on any device."""
    n = o.shape[0]
    c = cluster_min.shape[0]
    pk = torch.full((n, k), INF_KEY, dtype=torch.int32, device=o.device)
    cnt = torch.zeros(n, dtype=torch.int32, device=o.device)
    if c == 0:
        return pk, cnt
    rows = max(1, _PLAIN_PAIRS // c)
    kk = min(k, c)
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        key, hit = slab_keys(o[sl], d[sl], t_max[sl], cluster_min, cluster_max)
        pk[sl, :kk] = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
        cnt[sl] = hit.sum(dim=1, dtype=torch.int32)
    return pk, cnt


def box_unions(lo, hi, near, far):
    """(G, 8) float32 unions of CULL_GROUP consecutive boxes (C, 3)
    lo / hi, G = ceil(C / CULL_GROUP), the last group ragged: per group
    [lo.xyz, far, hi.xyz, 0], the least lo and the greatest hi of its
    `near` members (a NaN box, which no slab test enters, where it has
    none) and, as int32 bits, the mask of its `far` members, which the
    kernels test on their own. Built on the boxes' device, no host sync."""
    c = lo.shape[0]
    g = -(-c // CULL_GROUP)
    pad = g * CULL_GROUP - c
    lo = torch.nn.functional.pad(torch.where(near[:, None], lo, torch.inf),
                                 (0, 0, 0, pad), value=torch.inf)
    hi = torch.nn.functional.pad(torch.where(near[:, None], hi, -torch.inf),
                                 (0, 0, 0, pad), value=-torch.inf)
    lo = lo.view(g, CULL_GROUP, 3).amin(dim=1)
    hi = hi.view(g, CULL_GROUP, 3).amax(dim=1)
    empty = (torch.nn.functional.pad(near, (0, pad)).view(g, CULL_GROUP)
             .any(dim=1, keepdim=True).logical_not())
    lo = torch.where(empty, torch.nan, lo)
    hi = torch.where(empty, torch.nan, hi)
    bits = 1 << torch.arange(CULL_GROUP, dtype=torch.int32, device=far.device)
    mask = (torch.nn.functional.pad(far, (0, pad)).view(g, CULL_GROUP).int()
            * bits).sum(dim=1, dtype=torch.int32)
    return torch.cat([lo, mask.view(torch.float32)[:, None], hi,
                      torch.zeros_like(hi[:, :1])], dim=1).contiguous()


def group_unions(cluster_min, cluster_max):
    """K4's `box_unions` of the cluster boxes: near members have every
    corner coordinate below FAR_COORD in magnitude, far members a
    NaN-free coordinate at or beyond it (the 3e37 point boxes of empty
    clusters, infinities). Members with a NaN coordinate are in neither:
    the reference's slab test never enters them."""
    corners = torch.cat([cluster_min, cluster_max], dim=1)  # (C, 6)
    nan = torch.isnan(corners).any(dim=1)
    near = ~nan & (torch.abs(corners) < FAR_COORD).all(dim=1)
    return box_unions(torch.minimum(cluster_min, cluster_max),
                      torch.maximum(cluster_min, cluster_max), near, ~nan & ~near)


def cached_on(geometry, name: str, build):
    """build() once per geometry, kept on it as attribute `name`, and
    built again when its cluster boxes are replaced or edited in place."""
    cmin, cmax = geometry.cluster_min, geometry.cluster_max
    key = (cmin.data_ptr(), cmax.data_ptr(), cmin._version, cmax._version)
    cached = getattr(geometry, name, None)
    if cached is None or cached[0] != key:
        cached = (key, build())
        setattr(geometry, name, cached)
    return cached[1]


def geometry_unions(geometry, superchunk: int = CULL_MAX_CLUSTERS):
    """`group_unions` of each slice of `superchunk` clusters of the
    geometry, as `cull_candidates` launches K4, kept on the geometry."""
    cmin, cmax = geometry.cluster_min, geometry.cluster_max
    return cached_on(geometry, f"_cull_unions_{superchunk}", lambda: [
        group_unions(cmin[lo:lo + superchunk], cmax[lo:lo + superchunk])
        for lo in range(0, cmin.shape[0], superchunk)])


def _launch(o, d, t_max, cluster_min, cluster_max, k: int, unions):
    dev = o.device
    n = o.shape[0]
    c = cluster_min.shape[0]
    cuda_lib.check_cuda(
        "cull_topk",
        dict(o=o, d=d, t_max=t_max, cluster_min=cluster_min,
             cluster_max=cluster_max, unions=unions),
        {}, dev,
    )
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,):
        raise ValueError("cull_topk: o, d must be (N, 3), t_max (N,)")
    if cluster_min.shape != (c, 3) or cluster_max.shape != (c, 3):
        raise ValueError("cull_topk: cluster AABBs must be (C, 3)")
    if unions.shape != (-(-c // CULL_GROUP), 8):
        raise ValueError(f"cull_topk: unions has shape {tuple(unions.shape)}")
    if unions.data_ptr() % 16:
        raise ValueError("cull_topk: unions is not 16-byte aligned")
    pk = torch.empty((n, k), dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.CULL_TOPK(
        P(o), P(d), P(t_max), P(cluster_min), P(cluster_max), P(unions), n, c,
        k, P(pk), P(cnt), cuda_lib.stream_ptr(dev),
    )
    return pk, cnt


def cull_topk(o, d, t_max, cluster_min, cluster_max, k: int = 16, unions=None):
    """Per-ray K nearest candidate clusters, packed-key form.

    Returns (pk (N, K) int32 packed keys ascending, INF_KEY-padded;
    count (N,) int32, the ray's TOTAL candidate count). Unpack with
    id = pk & _ID_MASK and tn lower bound = bits(pk & ~_ID_MASK). At
    most CULL_MAX_CLUSTERS clusters (the id width) and K <= CULL_MAX_K.
    `unions`: `group_unions` of these boxes, built here when not given.
    """
    c = cluster_min.shape[0]
    if c > CULL_MAX_CLUSTERS:
        raise ValueError(f"cull_topk: {c} clusters exceed the key width")
    if not 1 <= k <= CULL_MAX_K:
        raise ValueError(f"cull_topk: k = {k} outside [1, {CULL_MAX_K}]")
    if o.device.type == "cpu":
        return cull_topk_plain(o, d, t_max, cluster_min, cluster_max, k)
    if unions is None:
        unions = group_unions(cluster_min, cluster_max)
    return _launch(o, d, t_max, cluster_min, cluster_max, k, unions)
