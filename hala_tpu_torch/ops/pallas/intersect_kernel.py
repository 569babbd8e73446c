"""Brute-force closest-hit / any-hit intersection: the CUDA kernel
csrc/intersect_bruteforce.cu, its wrapper, and its plain version.

Counterpart of the JAX package's Pallas kernel of the same module path
(`intersect_pallas` / `occluded_pallas`). Same contract: Moller-Trumbore
with det eps 1e-7, hits in (1e-4, t_max), strict `<` so the lowest slot
wins ties; `num_real` skips the tail padding of the prefix (Morton)
layout and is valid only there. Any-hit is the closest hit under
t_max = t_far * (1 - 1e-4), read as `tri >= 0`; the kernel may stop a
ray at its first hit, which gives the same boolean.

The wrappers run the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import weakref

import torch

from .. import cuda_lib
from ..intersect import Hit, full_t_max, intersect_bruteforce

TRI_CHUNK = 128  # triangles per chunk of the plain version
# csrc/intersect_bruteforce.cu: a block of 1024 threads carries 2 rays a
# thread, and stages up to STAGE_MAX triangles (48 bytes each) at once in
# the shared memory the rays' o and d passed through.
BLOCK_THREADS = 1024
RAYS_PER_THREAD = 2
BLOCK_RAYS = BLOCK_THREADS * RAYS_PER_THREAD
STAGE_MAX = 4096
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


def prefix_slots(geometry) -> int:
    """The slots to scan: the real triangles on the prefix (Morton)
    layout, whose padding is its tail; every slot of the SAH layout,
    which has interior padding."""
    g = geometry
    return g.num_triangles if g.prefix_layout else g.tri_v0.shape[0]


def pack_triangles(tri_v0, tri_e1, tri_e2, num_real: int) -> torch.Tensor:
    """The kernel's table: (num_real, 12) f32 rows v0, e1, e2, each
    padded with a zero to a float4."""
    k = num_real
    pad = torch.zeros((k, 1), dtype=torch.float32, device=tri_v0.device)
    return torch.cat([tri_v0[:k], pad, tri_e1[:k], pad, tri_e2[:k], pad],
                     dim=1).contiguous()


_PACKED: dict = {}  # (ids of the three tensors, num_real) -> (refs, versions, table)


def packed_triangles(tri_v0, tri_e1, tri_e2, num_real: int) -> torch.Tensor:
    """`pack_triangles`, kept while the three tensors live unchanged
    (same objects, same version counters): the geometry of a scene is
    packed once, not once a query."""
    srcs = (tri_v0, tri_e1, tri_e2)
    key = (*map(id, srcs), num_real)
    versions = tuple(t._version for t in srcs)
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is t for r, t in zip(hit[0], srcs)):
        return hit[2]
    table = pack_triangles(tri_v0, tri_e1, tri_e2, num_real)
    if len(_PACKED) >= 8:
        _PACKED.clear()
    _PACKED[key] = (tuple(weakref.ref(t) for t in srcs), versions, table)
    return table


def stage_triangles(num_real: int) -> int:
    """Triangles a block stages at once: the whole table up to
    STAGE_MAX (192 KB of dynamic shared memory)."""
    return max(1, min(num_real, STAGE_MAX))


def smem_bytes(stage: int) -> int:
    """Dynamic shared memory of one block: the rays' o and d, then the
    staged triangles in the same bytes."""
    return max(6 * 4 * BLOCK_RAYS, 48 * stage)


def ray_slots(n: int) -> torch.Tensor:
    """(blocks, RAYS_PER_THREAD, BLOCK_THREADS) i64: the ray that thread
    t of block b carries in its slot r, -1 past n. Each slot of a warp
    holds 32 consecutive rays (coalesced t_max loads and stores)."""
    blocks = -(-n // BLOCK_RAYS)
    ids = torch.arange(blocks * BLOCK_RAYS).reshape(
        blocks, RAYS_PER_THREAD, BLOCK_THREADS)
    return torch.where(ids < n, ids, -1)


def _launch(o, d, tri_v0, tri_e1, tri_e2, tm, num_real: int,
            any_hit: bool) -> Hit:
    dev = o.device
    n = o.shape[0]
    t_count = tri_v0.shape[0]
    cuda_lib.check_cuda(
        "intersect_pallas",
        dict(o=o, d=d, t_max=tm, tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2),
        {}, dev,
    )
    for name, a, rows in (("o", o, n), ("d", d, n), ("tri_v0", tri_v0, t_count),
                          ("tri_e1", tri_e1, t_count), ("tri_e2", tri_e2, t_count)):
        if a.shape != (rows, 3):
            raise ValueError(f"intersect_pallas: {name} has shape {tuple(a.shape)}")
    if not 0 <= num_real <= t_count:
        raise ValueError(f"intersect_pallas: num_real {num_real} not in [0, {t_count}]")
    tris = packed_triangles(tri_v0, tri_e1, tri_e2, num_real)
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    tri_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.empty(n, dtype=torch.float32, device=dev)
    v_out = torch.empty(n, dtype=torch.float32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.INTERSECT_BRUTEFORCE(
        P(o), P(d), P(tm), P(tris), n, num_real, stage_triangles(num_real),
        int(any_hit), P(t_out), P(tri_out), P(u_out), P(v_out),
        cuda_lib.stream_ptr(dev),
    )
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


def intersect_pallas_plain(
    o, d, tri_v0, tri_e1, tri_e2, t_max=None, num_real: int | None = None,
) -> Hit:
    """The plain version of `intersect_pallas`, on any device: the brute
    force over slots [0, num_real) in the kernel's 128-triangle chunks."""
    k = tri_v0.shape[0] if num_real is None else num_real
    return intersect_bruteforce(
        o, d, tri_v0[:k], tri_e1[:k], tri_e2[:k], t_max=t_max, chunk=TRI_CHUNK
    )


def occluded_pallas_plain(
    o, d, t_far, tri_v0, tri_e1, tri_e2, num_real: int | None = None,
) -> torch.Tensor:
    """The plain version of `occluded_pallas`, on any device."""
    return intersect_pallas_plain(
        o, d, tri_v0, tri_e1, tri_e2,
        full_t_max(t_far, o.shape[0], o.device) * (1.0 - 1e-4), num_real,
    ).tri >= 0


def intersect_pallas(
    o: torch.Tensor,
    d: torch.Tensor,
    tri_v0: torch.Tensor,
    tri_e1: torch.Tensor,
    tri_e2: torch.Tensor,
    t_max=None,
    num_real: int | None = None,
) -> Hit:
    """Closest hit over slots [0, num_real) (all slots by default).
    o, d: (N, 3) f32; tri_*: (T, 3) f32; t_max: None, scalar or (N,)."""
    if o.device.type == "cpu":
        return intersect_pallas_plain(
            o, d, tri_v0, tri_e1, tri_e2, t_max, num_real
        )
    if num_real is None:
        num_real = tri_v0.shape[0]
    tm = full_t_max(t_max, o.shape[0], o.device)
    return _launch(o, d, tri_v0, tri_e1, tri_e2, tm, num_real, any_hit=False)


def occluded_pallas(
    o, d, t_far, tri_v0, tri_e1, tri_e2, num_real: int | None = None,
) -> torch.Tensor:
    """Any-hit: True where a triangle lies in (1e-4, t_far * (1 - 1e-4))."""
    if o.device.type == "cpu":
        return occluded_pallas_plain(
            o, d, t_far, tri_v0, tri_e1, tri_e2, num_real
        )
    if num_real is None:
        num_real = tri_v0.shape[0]
    lim = full_t_max(t_far, o.shape[0], o.device) * (1.0 - 1e-4)
    return _launch(o, d, tri_v0, tri_e1, tri_e2, lim, num_real,
                   any_hit=True).tri >= 0
