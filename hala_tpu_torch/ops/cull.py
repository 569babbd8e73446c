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


def _launch(o, d, t_max, cluster_min, cluster_max, k: int):
    dev = o.device
    n = o.shape[0]
    c = cluster_min.shape[0]
    cuda_lib.check_cuda(
        "cull_topk",
        dict(o=o, d=d, t_max=t_max, cluster_min=cluster_min,
             cluster_max=cluster_max),
        {}, dev,
    )
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,):
        raise ValueError("cull_topk: o, d must be (N, 3), t_max (N,)")
    if cluster_min.shape != (c, 3) or cluster_max.shape != (c, 3):
        raise ValueError("cull_topk: cluster AABBs must be (C, 3)")
    pk = torch.empty((n, k), dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.CULL_TOPK(
        P(o), P(d), P(t_max), P(cluster_min), P(cluster_max), n, c, k,
        P(pk), P(cnt), cuda_lib.stream_ptr(dev),
    )
    return pk, cnt


def cull_topk(o, d, t_max, cluster_min, cluster_max, k: int = 16):
    """Per-ray K nearest candidate clusters, packed-key form.

    Returns (pk (N, K) int32 packed keys ascending, INF_KEY-padded;
    count (N,) int32, the ray's TOTAL candidate count). Unpack with
    id = pk & _ID_MASK and tn lower bound = bits(pk & ~_ID_MASK). At
    most CULL_MAX_CLUSTERS clusters (the id width) and K <= CULL_MAX_K.
    """
    c = cluster_min.shape[0]
    if c > CULL_MAX_CLUSTERS:
        raise ValueError(f"cull_topk: {c} clusters exceed the key width")
    if not 1 <= k <= CULL_MAX_K:
        raise ValueError(f"cull_topk: k = {k} outside [1, {CULL_MAX_K}]")
    if o.device.type == "cpu":
        return cull_topk_plain(o, d, t_max, cluster_min, cluster_max, k)
    return _launch(o, d, t_max, cluster_min, cluster_max, k)
