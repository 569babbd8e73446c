"""Exact tile-segment rasterization: the glue of `rasterize_tiled_exact`,
the CUDA kernel csrc/raster_tiled.cu (K3), its wrapper and its plain
version.

Counterpart of the JAX package's `ops/raster_kernel.py`. Binning is
exact and per-tile work is proportional to the tile's real candidate
count:

1. one sort of fused (cell << 20 | triangle id) keys builds
   variable-length per-tile candidate segments, id-ordered within a
   tile: small triangles (<= 2x2 tiles) are replicated 4 ways, a
   selected subset of mid-size ones (<= 8x8 tiles, the lowest `mid_max`
   ids) 64 ways with coverage masks, and the lowest `huge_max` ids of
   the huge ones enumerate their (tile, triangle) overlap pairs, so no
   per-tile cap exists anywhere;
2. per-candidate data is packed once into a row-major (N, 16) table in
   segment order (`ops/raster.pack_candidates`; 64 bytes a row, so a
   block's loads are coalesced);
3. K3 walks each tile's segment in id order with the full scan's
   arithmetic, so the result equals `ops/raster.rasterize` bit for bit.
   Its unit of work is a 16x16 sub-tile (`SUB_TILE`), walked by one
   warp, longest segments first; a warp passes over the candidates
   whose skip box (`skip_boxes`) lies beyond its sub-tile's pixel
   centres (`subtile_skip` gives that decision on tensors).

Overflow fires only on the three static selection bounds: more than
`mid_max` mid-size triangles, more than `huge_max` huge ones, or more
than `cand_cap` (tile, candidate) pairs. Nothing on the CUDA path waits
on the host: the segment starts and the real pair count stay on the
device. The wrapper launches K3 for CUDA tensors and runs the plain
version for CPU tensors; there is no other fallback.

`ops/raster.rasterize_tiled` sends here every mesh K3 can lay out
(`lays_out`), with bounds that cannot bind (`unbounded`) up to 4096
triangles, and the JAX package's bounds above, where it routes too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from . import cuda_lib
from .raster import (
    ROW_WIDTH,
    FragmentBuffer,
    chunk_step,
    edge,
    empty_planes,
    pack_candidates,
    resolve,
    signed_area,
    tile_pixels,
    tile_span,
    untile,
    _BLOCK_ELEMS,
    _SGN,
    _X0,
    _X1,
    _X2,
    _Y0,
    _Y1,
    _Y2,
)

CAND_CHUNK = 128          # candidates per step (kernel: per shared-memory stage)
SUB_TILE = 16             # K3's unit of work: a SUB_TILE x SUB_TILE sub-tile
_ID_BITS = 20             # fused key layout: cell << 20 | triangle id
_ID_MASK = (1 << _ID_BITS) - 1
_MID_SPAN = 8             # mid class covers <= 8x8 tiles (64 copies)


class Segments(NamedTuple):
    """Per-tile candidate segments of one frame."""

    starts: torch.Tensor   # (n_tiles + 1,) i32, segment t = [starts[t], starts[t+1])
    data: torch.Tensor     # (cap_pad, ROW_WIDTH) f32 packed candidates
    n_real: torch.Tensor   # () i64, (tile, candidate) pairs before the cap
    over: torch.Tensor     # () f32, 1.0 if a static bound overflowed
    tw: int
    th: int
    tile: int


def lays_out(t: int, tile: int, n_tiles: int) -> bool:
    """Whether `build_segments` can lay out `t` triangle slots on
    `n_tiles` tiles of `tile` x `tile` pixels: ids fit the fused key's
    20 bits, cell << 20 fits 31, and tile*tile is a multiple of 128
    (so `tile` is a multiple of SUB_TILE)."""
    return (t < (1 << _ID_BITS) and (n_tiles << _ID_BITS) < (1 << 31)
            and (tile * tile) % 128 == 0)


def unbounded(t: int, n_tiles: int) -> dict:
    """`build_segments` bounds at which none of the three static bounds
    can bind for `t` slots on `n_tiles` tiles: every mid and huge
    triangle enumerated, and a table that holds every key (4 a small
    triangle, _MID_SPAN^2 a mid one, one a tile a huge one)."""
    return dict(mid_max=t, huge_max=t,
                cand_cap=t * (4 + _MID_SPAN * _MID_SPAN + n_tiles))


def build_segments(
    tri_screen: torch.Tensor,   # (T, 3, 2)
    tri_depth: torch.Tensor,    # (T, 3)
    tri_inv_w: torch.Tensor,    # (T, 3)
    tri_valid: torch.Tensor,    # (T,)
    width: int,
    height: int,
    tile: int = 64,
    mid_max: int = 4096,
    huge_max: int = 512,
    cand_cap: int = 0,
) -> Segments:
    """Classification, fused-key sort, segment starts and the packed
    candidate table (raster_kernel.py:171-303 of the JAX package)."""
    t = tri_screen.shape[0]
    dev = tri_screen.device
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    assert lays_out(t, tile, n_tiles), (
        f"{t} slots on {n_tiles} tiles of {tile}: ids must be < 2^20, "
        "cell << 20 < 2^31 and tile*tile lane-divisible")
    mid_max = min(mid_max, t)
    huge_max = min(huge_max, t)

    # --- classification (screen AABB -> covered tile span) ---
    smin = torch.amin(tri_screen, dim=1)
    smax = torch.amax(tri_screen, dim=1)
    area = signed_area(tri_screen)
    onscreen = (
        tri_valid
        & (torch.abs(area) > 1e-12)   # degenerate tris can never win
        & (smax[:, 0] >= 0.0) & (smin[:, 0] <= width)
        & (smax[:, 1] >= 0.0) & (smin[:, 1] <= height)
    )
    bx0, bx1, by0, by1 = tile_span(smin, smax, tile, tw, th)
    spanx = bx1 - bx0
    spany = by1 - by0
    small = onscreen & (spanx <= 1) & (spany <= 1)
    mid = onscreen & ~small & (spanx < _MID_SPAN) & (spany < _MID_SPAN)
    huge = onscreen & ~small & ~mid

    ids = torch.arange(t, dtype=torch.int32, device=dev)
    sent = n_tiles << _ID_BITS

    def fused(ok, cell, tid_):
        return torch.where(ok, cell * (1 << _ID_BITS) + tid_, sent + tid_)

    keys = []
    # small: each covers at most 2x2 tiles
    for dx in (0, 1):
        for dy in (0, 1):
            ok = small & (spanx >= dx) & (spany >= dy)
            keys.append(fused(ok, (by0 + dy) * tw + (bx0 + dx), ids))
    # mid: the lowest mid_max ids, 64 coverage-masked copies
    m_ids = torch.argsort((~mid).to(torch.int8), stable=True)[:mid_max]
    m_ok = mid[m_ids]
    m_bx0, m_by0 = bx0[m_ids], by0[m_ids]
    m_spx, m_spy = spanx[m_ids], spany[m_ids]
    m_ids = m_ids.to(torch.int32)
    for dx in range(_MID_SPAN):
        for dy in range(_MID_SPAN):
            ok = m_ok & (m_spx >= dx) & (m_spy >= dy)
            keys.append(fused(ok, (m_by0 + dy) * tw + (m_bx0 + dx), m_ids))
    m_over = mid.sum() > mid_max
    # huge: the lowest huge_max ids enumerate (tile, candidate) pairs
    h_ids = torch.argsort((~huge).to(torch.int8), stable=True)[:huge_max]
    h_ok = huge[h_ids]
    cells = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tcols = (cells % tw)[:, None]
    trows = (cells // tw)[:, None]
    ov = (
        h_ok[None, :]
        & (tcols >= bx0[h_ids][None, :])
        & (tcols <= bx1[h_ids][None, :])
        & (trows >= by0[h_ids][None, :])
        & (trows <= by1[h_ids][None, :])
    )
    keys.append(
        fused(ov, cells[:, None], h_ids.to(torch.int32)[None, :]).reshape(-1)
    )
    h_over = huge.sum() > huge_max

    key_all = torch.cat(keys)
    n_all = key_all.shape[0]
    if cand_cap <= 0:
        cand_cap = min(n_all, max(131072, 2 * t))
    cand_cap = min(cand_cap, n_all)
    cap_pad = -(-cand_cap // CAND_CHUNK) * CAND_CHUNK

    fused_s = torch.sort(key_all).values
    n_real = torch.searchsorted(
        fused_s, torch.tensor([sent], dtype=torch.int32, device=dev)
    )[0]
    cap_over = n_real > cand_cap
    bounds = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) << _ID_BITS
    starts = torch.clamp(
        torch.searchsorted(fused_s, bounds), max=cand_cap
    ).to(torch.int32)

    # --- packed candidate table, one row take in segment order ---
    packed = pack_candidates(tri_screen, tri_depth, tri_inv_w, ids, area)
    id_head = (fused_s[:cand_cap] & _ID_MASK).long()
    data = torch.zeros((cap_pad, ROW_WIDTH), dtype=torch.float32, device=dev)
    data[:cand_cap] = packed[id_head]
    over = (m_over | h_over | cap_over).to(torch.float32)
    return Segments(starts=starts, data=data, n_real=n_real, over=over,
                    tw=tw, th=th, tile=tile)


def raster_segments_plain(starts, data, tw: int, tile: int):
    """The plain version of K3, on any device: all tiles' segments in
    lockstep, CAND_CHUNK candidates at a time with masks, in the
    kernel's arithmetic (`ops/raster.chunk_step`). Returns the (depth,
    tri, uw, vw, iw) planes, each (n_tiles, tile*tile). The loop bounds
    are read on the host."""
    n_tiles = starts.shape[0] - 1
    n_pix = tile * tile
    dev = data.device
    planes = empty_planes((n_tiles, n_pix), dev)
    seg0 = starts[:-1].long()
    seg_len = (starts[1:] - starts[:-1]).long()
    px, py = tile_pixels(n_tiles, tw, tile, dev)
    j = torch.arange(CAND_CHUNK, device=dev)
    last = max(data.shape[0] - 1, 0)
    step = max(1, _BLOCK_ELEMS // (n_pix * CAND_CHUNK))
    for b0 in range(0, n_tiles, step):
        b1 = min(n_tiles, b0 + step)
        length = int(seg_len[b0:b1].max()) if b1 > b0 else 0
        cur = tuple(p[b0:b1] for p in planes)
        for k0 in range(0, length, CAND_CHUNK):
            col = k0 + j[None]  # (B, C)
            ok = col < seg_len[b0:b1, None]
            rows = data[torch.clamp(seg0[b0:b1, None] + col, max=last)]
            cur = chunk_step(cur, px[b0:b1], py[b0:b1], rows, ok)
        for dst, src in zip(planes, cur):
            dst[b0:b1] = src
    return planes


# csrc/raster_tiled.cu `skip_box`: a candidate is skipped only where its
# box, widened by W * 2^-9 + 1 (W its larger extent), misses a
# sub-tile's pixel centres, and only where the margin provably covers
# the rounding of the edge functions: sign +-1 agreeing with the area,
# no sliver (|area| >= 2^-10 W^2), 2^-16 <= W, corners within 2^22.
_MAX_COORD = 2.0 ** 22
_MIN_EXTENT = 2.0 ** -16
_SLIVER = 2.0 ** -10
_MARGIN_SCALE = 2.0 ** -9


def skip_boxes(data: torch.Tensor) -> torch.Tensor:
    """(N, 4) f32 skip boxes (x_lo, x_hi, y_lo, y_hi) of the table's
    rows, as K3 computes them when it stages a chunk: infinite where
    the skip is not proven safe (slivers, NaN or infinite corners)."""
    x = data[:, [_X0, _X1, _X2]]
    y = data[:, [_Y0, _Y1, _Y2]]
    # fminf / fmaxf: NaN corners are dropped (the area catches them)
    xmin = torch.fmin(torch.fmin(x[:, 0], x[:, 1]), x[:, 2])
    xmax = torch.fmax(torch.fmax(x[:, 0], x[:, 1]), x[:, 2])
    ymin = torch.fmin(torch.fmin(y[:, 0], y[:, 1]), y[:, 2])
    ymax = torch.fmax(torch.fmax(y[:, 0], y[:, 1]), y[:, 2])
    w = torch.fmax(xmax - xmin, ymax - ymin)
    area = edge(x[:, 1] - x[:, 0], y[:, 1] - y[:, 0],
                x[:, 2] - x[:, 0], y[:, 2] - y[:, 0])
    sgn = data[:, _SGN]
    ok = (((sgn == 1.0) | (sgn == -1.0))
          & (xmin >= -_MAX_COORD) & (xmax <= _MAX_COORD)
          & (ymin >= -_MAX_COORD) & (ymax <= _MAX_COORD)
          & (w >= _MIN_EXTENT) & (sgn * area >= (w * w) * _SLIVER))
    m = w * _MARGIN_SCALE + 1.0
    inf = torch.full_like(w, torch.inf)
    return torch.stack([torch.where(ok, xmin - m, -inf),
                        torch.where(ok, xmax + m, inf),
                        torch.where(ok, ymin - m, -inf),
                        torch.where(ok, ymax + m, inf)], dim=1)


def subtile_origins(n_tiles: int, tw: int, tile: int, device):
    """(n_tiles, (tile / SUB_TILE)^2) x and y of each sub-tile's first
    pixel, in K3's unit order within a tile (row-major)."""
    spt = tile // SUB_TILE
    t = torch.arange(n_tiles, device=device)[:, None]
    s = torch.arange(spt * spt, device=device)[None]
    return t % tw * tile + s % spt * SUB_TILE, t // tw * tile + s // spt * SUB_TILE


def subtile_skip(starts, data, tw: int, tile: int) -> torch.Tensor:
    """K3's decision for every (table row, sub-tile of the row's tile):
    (N, (tile / SUB_TILE)^2) bool, True where the warp of that sub-tile
    passes over the row. Rows outside every segment are never walked
    and read True."""
    n_tiles = starts.shape[0] - 1
    rows = torch.arange(data.shape[0], device=data.device)
    tile_of = torch.searchsorted(starts.long(), rows, right=True) - 1
    walked = (tile_of >= 0) & (tile_of < n_tiles) & (rows < starts[-1])
    tile_of = torch.clamp(tile_of, 0, max(n_tiles - 1, 0))
    sx, sy = subtile_origins(n_tiles, tw, tile, data.device)
    sx, sy = sx[tile_of], sy[tile_of]
    cx0 = sx.to(torch.float32) + 0.5
    cx1 = (sx + SUB_TILE - 1).to(torch.float32) + 0.5
    cy0 = sy.to(torch.float32) + 0.5
    cy1 = (sy + SUB_TILE - 1).to(torch.float32) + 0.5
    b = skip_boxes(data)[:, :, None]
    skip = (b[:, 1] < cx0) | (b[:, 0] > cx1) | (b[:, 3] < cy0) | (b[:, 2] > cy1)
    return skip | ~walked[:, None]


def _launch(starts, data, tw: int, tile: int):
    dev = data.device
    n_tiles = starts.shape[0] - 1
    cuda_lib.check_cuda(
        "raster_tiled", dict(starts=starts, data=data),
        {"starts": torch.int32}, dev,
    )
    if data.dim() != 2 or data.shape[1] != ROW_WIDTH:
        raise ValueError(f"raster_tiled: data has shape {tuple(data.shape)}")
    if data.data_ptr() % 16:
        raise ValueError("raster_tiled: data is not 16-byte aligned")
    if n_tiles < 0 or tile <= 0 or tw <= 0 or tile % SUB_TILE:
        raise ValueError("raster_tiled: bad tile layout")
    n_pix = tile * tile
    depth = torch.empty((n_tiles, n_pix), dtype=torch.float32, device=dev)
    tri = torch.empty((n_tiles, n_pix), dtype=torch.int32, device=dev)
    uw = torch.empty_like(depth)
    vw = torch.empty_like(depth)
    iw = torch.empty_like(depth)
    order = torch.empty(max(n_tiles, 1) + 1, dtype=torch.int32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.RASTER_TILED(
        P(starts), P(data), n_tiles, tw, tile,
        P(depth), P(tri), P(uw), P(vw), P(iw), P(order[1:]), P(order),
        cuda_lib.stream_ptr(dev),
    )
    return depth, tri, uw, vw, iw


def raster_segments(starts, data, tw: int, tile: int):
    """K3: the (depth, tri, uw, vw, iw) planes of every tile, each
    (n_tiles, tile*tile). CUDA tensors launch csrc/raster_tiled.cu; CPU
    tensors run the plain version."""
    if data.device.type == "cpu":
        return raster_segments_plain(starts, data, tw, tile)
    return _launch(starts, data, tw, tile)


def segments_to_fragments(planes, seg: Segments, width: int,
                          height: int) -> FragmentBuffer:
    """Per-tile planes -> FragmentBuffer flat over the image, with the
    perspective divide uw / max(iw, 1e-12)."""
    return resolve(*(untile(p, seg.tw, seg.th, seg.tile, width, height)
                     for p in planes))


def rasterize_tiled_exact(
    tri_screen: torch.Tensor,   # (T, 3, 2)
    tri_depth: torch.Tensor,    # (T, 3)
    tri_inv_w: torch.Tensor,    # (T, 3)
    tri_valid: torch.Tensor,    # (T,)
    width: int,
    height: int,
    tile: int = 64,
    mid_max: int = 4096,
    huge_max: int = 512,
    cand_cap: int = 0,
) -> tuple[FragmentBuffer, torch.Tensor]:
    """Exact tile-binned rasterization (no per-tile candidate caps).

    Returns (FragmentBuffer flat over pixels, overflow flag in {0.0,
    1.0}). Overflow fires only on the three static selection bounds;
    per-tile counts are never capped."""
    with profiling.span("hala.raster.bin"):
        seg = build_segments(tri_screen, tri_depth, tri_inv_w, tri_valid,
                             width, height, tile, mid_max, huge_max, cand_cap)
    with profiling.span("hala.raster.visibility", path="k3"):
        planes = raster_segments(seg.starts, seg.data, seg.tw, seg.tile)
        return segments_to_fragments(planes, seg, width, height), seg.over
