"""Software rasterization: vertex transform + edge-function coverage.

Counterpart of the JAX package's `ops/raster.py`. Role parity: the
reference's rasterization pipelines (rz_renderer.rs:429-505): reverse-Z
depth test with CompareOp::GREATER (rz_renderer.rs:494) and the
negative-viewport y-flip (rz_renderer.rs:861-869). The fixed-function
rasterizer becomes a chunked scan: every pixel tests triangle chunks
with edge functions and keeps the reverse-Z max depth. Tile binning
restricts each tile's candidate list. `rasterize_tiled` routes every
mesh that the exact segment kernel of `ops/raster_kernel.py` (K3) can
lay out to it, on the card and on the CPU alike (`tiled_route`).

Perspective-correct interpolation uses 1/w-weighted barycentrics.

The JAX `vmap` over tiles is a tile dimension here and its `lax.scan`
over chunks a Python loop. Every scan is blocked over pixels and tiles
so that a (pixels, candidates) temporary holds at most _BLOCK_ELEMS
elements; pixels are independent, so blocking changes no result. The
winner rule is the JAX package's, exactly: within a chunk the first
column reaching the reverse-Z max, across chunks a strict `>` against
the carried depth, and the perspective divide `uw / max(iw, 1e-12)` of
the winner's weights only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling

# Elements of one (pixels, candidates) temporary: 4M float32 = 16 MB; a
# chunk step keeps about twenty of them alive.
_BLOCK_ELEMS = 1 << 22

# Columns of a packed candidate row (the layout of the K3 table,
# ops/raster_kernel.py): corners' screen xy, depths, 1/w, the winding
# sign, 1/area and the triangle id as a float (exact below 2^24).
ROW_WIDTH = 16
_X0, _Y0, _X1, _Y1, _X2, _Y2 = range(6)
_Z0, _Z1, _Z2, _IW0, _IW1, _IW2, _SGN, _INV_AREA, _ID = range(6, 15)


class FragmentBuffer(NamedTuple):
    """Per-pixel visibility result (flat over pixels)."""

    depth: torch.Tensor  # (N,) reverse-Z depth (0 = far plane/clear)
    tri: torch.Tensor    # (N,) i32 triangle id, -1 = background
    u: torch.Tensor      # (N,) perspective-correct barycentric of v1
    v: torch.Tensor      # (N,) of v2


def transform_vertices(positions: torch.Tensor, view_proj: torch.Tensor):
    """World -> clip space. positions (V, 3), view_proj (4, 4) -> (V, 4)."""
    homo = torch.cat([positions, torch.ones_like(positions[..., :1])], dim=-1)
    return homo @ view_proj.T


def clip_to_screen(clip: torch.Tensor, width: int, height: int):
    """Clip -> (screen xy, reverse-Z depth, inv_w). Y-flip parity with the
    reference's negative-height viewport."""
    w = clip[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return torch.stack([sx, sy], dim=-1), ndc[..., 2], inv_w


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors with one rounding (a fused
    multiply-add, CUDA's __fmaf_rn), on any device.

    The product is exact in float64; the float64 sum is rounded to odd
    (TwoSum gives its error, and an inexact even result moves one ulp
    toward it), after which rounding to float32 is correctly rounded:
    53 >= 24 + 2 bits."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# The JAX package's full scan, as XLA compiles it for the CPU (where
# the raster goldens were made), rounds its edge functions and
# three-term sums with fused multiply-adds in fixed places. The port
# rounds the same way, here and in csrc/raster_tiled.cu: on a pixel
# centre exactly on an edge shared by two triangles that rounding
# decides coverage, and between surfaces an ulp apart, the winner.


def edge(dx, dy, rx, ry):
    """Edge function dx * ry - dy * rx (rx, ry: the pixel relative to
    the edge's first corner) as fma(dx, ry, -(dy * rx))."""
    return fma32(dx, ry, -(dy * rx))


def sum3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1 * b1))."""
    return fma32(a2, b2, fma32(a0, b0, a1 * b1))


def signed_area(tri_screen: torch.Tensor) -> torch.Tensor:
    """(T, 3, 2) -> (T,) twice the signed screen area, as the full scan
    computes it (one edge function)."""
    a, b, c = tri_screen[:, 0], tri_screen[:, 1], tri_screen[:, 2]
    return edge(b[:, 0] - a[:, 0], b[:, 1] - a[:, 1],
                c[:, 0] - a[:, 0], c[:, 1] - a[:, 1])


def pack_candidates(tri_screen, tri_depth, tri_inv_w, ids, area=None):
    """(T, ROW_WIDTH) rows: xy of the 3 corners, 3 depths, 3 1/w, the
    winding sign, 1/area (1 for degenerate triangles) and `ids` as
    float; the last column is padding."""
    t = tri_screen.shape[0]
    if area is None:
        area = signed_area(tri_screen)
    sgn = torch.where(area >= 0, 1.0, -1.0)
    inv_area = 1.0 / torch.where(torch.abs(area) > 1e-12, area, 1.0)
    return torch.cat(
        [
            tri_screen.reshape(t, 6),
            tri_depth,
            tri_inv_w,
            sgn[:, None],
            inv_area[:, None],
            ids.to(torch.float32)[:, None],
            torch.zeros((t, 1), dtype=torch.float32, device=tri_screen.device),
        ],
        dim=1,
    )


def empty_planes(shape, device):
    """(depth, tri, uw, vw, iw) in their cleared state."""
    return (
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.full(shape, -1, dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _accept(w, ex, ey, sgn):
    """Top-left-style fill rule for a pixel centre exactly on an edge:
    only the "down or leftward-horizontal" oriented edge keeps it."""
    dx = ex * sgn
    dy = ey * sgn
    tl = (dy > 0) | ((dy == 0) & (dx < 0))
    ws = w * sgn
    return (ws > 0) | ((ws == 0) & tl)


def chunk_step(planes, px, py, rows, ok, depth_bound=None, seam_dedup=False):
    """One chunk of candidates against a batch of pixel sets.

    planes: (depth, tri, uw, vw, iw), each (B, N); px, py: (B, N);
    rows: (B, C, ROW_WIDTH) packed candidates; ok: (B, C) bool. Returns
    the planes after the chunk: the first column reaching the chunk's
    reverse-Z max wins the chunk, and replaces the carried winner only
    where its depth is strictly greater."""
    depth, tri, uw, vw, iw = planes
    c = rows.shape[1]
    px = px[..., None]
    py = py[..., None]
    col = [rows[:, None, :, k] for k in range(_ID)]  # each (B, 1, C)
    x0, y0, x1, y1, x2, y2 = col[_X0:_Y2 + 1]
    sgn, inv_area = col[_SGN], col[_INV_AREA]
    ex0, ey0 = x2 - x1, y2 - y1
    ex1, ey1 = x0 - x2, y0 - y2
    ex2, ey2 = x1 - x0, y1 - y0
    w0 = edge(ex0, ey0, px - x1, py - y1)
    w1 = edge(ex1, ey1, px - x2, py - y2)
    w2 = edge(ex2, ey2, px - x0, py - y0)
    if seam_dedup:
        cover = (_accept(w0, ex0, ey0, sgn) & _accept(w1, ex1, ey1, sgn)
                 & _accept(w2, ex2, ey2, sgn))
    else:
        cover = (w0 * sgn >= 0.0) & (w1 * sgn >= 0.0) & (w2 * sgn >= 0.0)
    inside = cover & ok[:, None, :]
    l0 = w0 * inv_area
    l1 = w1 * inv_area
    l2 = w2 * inv_area
    z = sum3(l0, col[_Z0], l1, col[_Z1], l2, col[_Z2])
    z = torch.where(inside, z, -1.0)
    if depth_bound is not None:
        z = torch.where(z < depth_bound[..., None], z, -1.0)
    z_best = torch.amax(z, dim=-1)
    cols = torch.arange(c, device=rows.device)
    first = torch.where((z == z_best[..., None]) & inside, cols, c)
    loc = torch.clamp(torch.amin(first, dim=-1), max=c - 1)  # (B, N)

    def at(a):  # (B, N, C) -> (B, N), the winner column
        return torch.gather(a, 2, loc[..., None])[..., 0]

    def cand(k):  # row column k of the winner, (B, N)
        return torch.gather(rows[..., k], 1, loc)

    l0w, l1w, l2w = at(l0), at(l1), at(l2)
    iw0w, iw1w, iw2w = cand(_IW0), cand(_IW1), cand(_IW2)
    uw_c = l1w * iw1w
    vw_c = l2w * iw2w
    iw_c = fma32(l2w, iw2w, fma32(l0w, iw0w, uw_c))  # sum3, uw_c reused
    tri_c = cand(_ID).to(torch.int32)
    better = z_best > depth  # reverse-Z GREATER
    return (
        torch.where(better, z_best, depth),
        torch.where(better, tri_c, tri),
        torch.where(better, uw_c, uw),
        torch.where(better, vw_c, vw),
        torch.where(better, iw_c, iw),
    )


def scan(rows, ok, px, py, chunk, depth_bound=None, seam_dedup=False):
    """Batched chunked scan: rows (B, K, ROW_WIDTH) and ok (B, K) are
    each batch entry's candidates in order, px/py (B, N) its pixels.
    Returns the (depth, tri, uw, vw, iw) planes, each (B, N)."""
    b, k = ok.shape
    n = px.shape[1]
    planes = empty_planes((b, n), px.device)
    nb = max(1, min(n, _BLOCK_ELEMS // chunk))
    bb = max(1, _BLOCK_ELEMS // (nb * chunk))
    for b0 in range(0, b, bb):
        b1 = min(b, b0 + bb)
        for p0 in range(0, n, nb):
            p1 = min(n, p0 + nb)
            cur = tuple(p[b0:b1, p0:p1] for p in planes)
            bound = None if depth_bound is None else depth_bound[b0:b1, p0:p1]
            for c0 in range(0, k, chunk):
                cur = chunk_step(
                    cur, px[b0:b1, p0:p1], py[b0:b1, p0:p1],
                    rows[b0:b1, c0:c0 + chunk], ok[b0:b1, c0:c0 + chunk],
                    bound, seam_dedup,
                )
            for dst, src in zip(planes, cur):
                dst[b0:b1, p0:p1] = src
    return planes


def resolve(depth, tri, uw, vw, iw) -> FragmentBuffer:
    """Perspective divide of the winner's weights."""
    den = torch.clamp(iw, min=1e-12)
    return FragmentBuffer(depth=depth, tri=tri, u=uw / den, v=vw / den)


def rasterize(
    tri_screen: torch.Tensor,   # (T, 3, 2) screen xy per corner
    tri_depth: torch.Tensor,    # (T, 3) reverse-Z depth per corner
    tri_inv_w: torch.Tensor,    # (T, 3) 1/w per corner
    tri_valid: torch.Tensor,    # (T,) bool (in front of near plane etc.)
    px: torch.Tensor,           # (N,) pixel centers x
    py: torch.Tensor,           # (N,)
    chunk: int = 512,
    tri_ids: torch.Tensor | None = None,  # (T,) i32 global ids (>= 0)
    depth_bound: torch.Tensor | None = None,  # (N,) exclusive reverse-Z cap
    seam_dedup: bool = False,
) -> FragmentBuffer:
    """Full visibility: every pixel vs every triangle chunk, keeping the
    reverse-Z GREATER winner (rz_renderer.rs:494).

    With `tri_ids`, `tri` carries the global id of the winner. With
    `depth_bound`, a pixel only accepts fragments strictly farther than
    its bound (depth < bound in reverse-Z): the depth-peeling primitive.
    `seam_dedup` applies a top-left-style fill rule, so a pixel centre
    exactly on an edge shared by two triangles belongs to one of them.
    Ids travel as float32 and must stay below 2^24."""
    with profiling.span("hala.raster.visibility", path="scan"):
        t = tri_screen.shape[0]
        chunk = min(chunk, t)
        assert t % chunk == 0, "triangle buffers must be chunk-padded"
        assert t < (1 << 24), "ids travel as float32"
        area = signed_area(tri_screen)
        ids = (torch.arange(t, dtype=torch.int32, device=tri_screen.device)
               if tri_ids is None else tri_ids)
        rows = pack_candidates(tri_screen, tri_depth, tri_inv_w, ids, area)
        ok = (torch.abs(area) > 1e-12) & tri_valid
        bound = None if depth_bound is None else depth_bound[None]
        planes = scan(rows[None], ok[None], px[None], py[None], chunk,
                      bound, seam_dedup)
        return resolve(*(p[0] for p in planes))


def tile_pixels(n_tiles: int, tw: int, tile: int, device):
    """Pixel centres of every tile, (n_tiles, tile*tile) each."""
    tid = torch.arange(n_tiles, dtype=torch.int32, device=device)
    pix = torch.arange(tile * tile, dtype=torch.int32, device=device)
    px = (pix[None] % tile + (tid % tw * tile)[:, None]).to(torch.float32) + 0.5
    py = (pix[None] // tile + (tid // tw * tile)[:, None]).to(torch.float32) + 0.5
    return px, py


def untile(a: torch.Tensor, tw: int, th: int, tile: int, width: int,
           height: int) -> torch.Tensor:
    """(n_tiles, tile*tile) per-tile planes -> flat (height*width,)."""
    a = a.reshape(th, tw, tile, tile).permute(0, 2, 1, 3)
    return a.reshape(th * tile, tw * tile)[:height, :width].reshape(-1)


def _raster_tiles(tri_screen, tri_depth, tri_inv_w, ids, sel, tw, th, tile,
                  width, height, chunk):
    """Each tile's candidate triangles `ids` (n_tiles, K), selected where
    `sel`, scanned in order in chunks -> FragmentBuffer over the image,
    with global triangle ids."""
    with profiling.span("hala.raster.visibility", path="plain"):
        t = tri_screen.shape[0]
        area = signed_area(tri_screen)
        packed = pack_candidates(
            tri_screen, tri_depth, tri_inv_w,
            torch.arange(t, dtype=torch.int32, device=tri_screen.device), area,
        )
        ok = sel & (torch.abs(area) > 1e-12)[ids]
        px, py = tile_pixels(tw * th, tw, tile, tri_screen.device)
        planes = scan(packed[ids], ok, px, py, chunk)
        return resolve(*(untile(p, tw, th, tile, width, height) for p in planes))


def _stable_first(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise indices of the True entries first, each group in
    ascending order (a stable argsort of ~mask), cut to k columns."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    return order[..., :k].to(torch.int32)


def _tile_origins(n_tiles: int, tw: int, tile: int, device):
    tid = torch.arange(n_tiles, dtype=torch.int32, device=device)
    return ((tid % tw) * tile).to(torch.float32), ((tid // tw) * tile).to(torch.float32)


def rasterize_meshlet_binned(
    tri_screen: torch.Tensor,   # (T, 3, 2)
    tri_depth: torch.Tensor,    # (T, 3)
    tri_inv_w: torch.Tensor,    # (T, 3)
    tri_valid: torch.Tensor,    # (T,)
    ml_tri: torch.Tensor,       # (M, 128) meshlet -> triangle slots, -1 pad
    ml_visible: torch.Tensor,   # (M,) bool (task-stage cull result)
    width: int,
    height: int,
    tile: int = 64,
    km_max: int = 16,
) -> tuple[FragmentBuffer, torch.Tensor]:
    """Mesh-shader-style rasterization: meshlets are the binning and
    draw granularity (draw_mesh_tasks role, rz_renderer.rs:957-962).
    Each surviving meshlet's screen AABB is the union of its triangles'
    AABBs, tiles collect up to km_max candidate meshlets, and the depth
    test runs over the candidates' triangle lists. Returns (fragments,
    overflow fraction of tiles whose meshlet list clipped)."""
    m = ml_tri.shape[0]
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    km_max = min(km_max, m)
    dev = tri_screen.device

    with profiling.span("hala.raster.bin"):
        smin_t = torch.amin(tri_screen, dim=1)  # (T, 2)
        smax_t = torch.amax(tri_screen, dim=1)
        member = torch.clamp(ml_tri, min=0).long()
        mvalid = (ml_tri >= 0) & tri_valid[member]  # (M, 128)
        big = 1e9
        ml_min = torch.amin(
            torch.where(mvalid[..., None], smin_t[member], big), dim=1
        )  # (M, 2)
        ml_max = torch.amax(
            torch.where(mvalid[..., None], smax_t[member], -big), dim=1
        )
        ml_live = ml_visible & torch.any(mvalid, dim=1)

        x0, y0 = _tile_origins(n_tiles, tw, tile, dev)
        overlap = (
            ml_live[None]
            & (ml_max[None, :, 0] >= x0[:, None])
            & (ml_min[None, :, 0] <= x0[:, None] + tile)
            & (ml_max[None, :, 1] >= y0[:, None])
            & (ml_min[None, :, 1] <= y0[:, None] + tile)
        )  # (n_tiles, M)
        count = overlap.sum(dim=1)
        mids = _stable_first(overlap, km_max).long()  # (n_tiles, km)
        msel = torch.arange(km_max, device=dev)[None] < count[:, None]

        # mesh stage: expand candidate meshlets to their triangle lists
        tris = ml_tri[mids]                            # (n_tiles, km, 128)
        tsel = msel[..., None] & (tris >= 0)
        ids = torch.clamp(tris, min=0).reshape(n_tiles, -1).long()
        sel = tsel.reshape(n_tiles, -1) & tri_valid[ids]
    frag = _raster_tiles(tri_screen, tri_depth, tri_inv_w, ids, sel, tw, th,
                         tile, width, height, 128)
    return frag, (count > km_max).to(torch.float32).mean()


def _rasterize_tiled_scatter(
    tri_screen: torch.Tensor,   # (T, 3, 2)
    tri_depth: torch.Tensor,    # (T, 3)
    tri_inv_w: torch.Tensor,    # (T, 3)
    tri_valid: torch.Tensor,    # (T,)
    width: int,
    height: int,
    tile: int,
    k_max: int,
    large_max: int = 256,
) -> tuple[FragmentBuffer, torch.Tensor]:
    """Scatter-table binning (capped): each small triangle (tile-span
    <= 2x2) is replicated into its <= 4 covered tiles' buckets by one
    global sort of (cell, triangle) pairs and a positional scatter into
    a dense (tiles, k_max) table; larger triangles go to a shared capped
    list every tile tests. Overflow reports the fraction of tiles whose
    bucket (or the shared large list) clipped. Within a bucket, and in
    the large list, triangles stay in ascending id order."""
    t = tri_screen.shape[0]
    dev = tri_screen.device
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    kb = min(k_max, t)
    lmax = min(large_max, t)

    with profiling.span("hala.raster.bin"):
        smin = torch.amin(tri_screen, dim=1)  # (T, 2)
        smax = torch.amax(tri_screen, dim=1)
        onscreen = (
            tri_valid
            & (smax[:, 0] >= 0.0) & (smin[:, 0] <= width)
            & (smax[:, 1] >= 0.0) & (smin[:, 1] <= height)
        )
        bx0, bx1, by0, by1 = tile_span(smin, smax, tile, tw, th)
        spanx = bx1 - bx0
        spany = by1 - by0
        small = onscreen & (spanx <= 1) & (spany <= 1)

        ids = torch.arange(t, dtype=torch.int32, device=dev)
        sent = n_tiles
        keys = []
        for dx in (0, 1):
            for dy in (0, 1):
                ok = small & (spanx >= dx) & (spany >= dy)
                cell = (by0 + dy) * tw + (bx0 + dx)
                keys.append(torch.where(ok, cell, sent))
        key4 = torch.cat(keys)
        id4 = torch.cat([ids] * 4)
        k_s, order = torch.sort(key4, stable=True)
        p_s = id4[order]
        # rank within bucket: index minus the bucket's first sorted index
        iota = torch.arange(4 * t, device=dev)
        is_start = torch.ones_like(k_s, dtype=torch.bool)
        is_start[1:] = k_s[1:] != k_s[:-1]
        pos = iota - torch.cummax(torch.where(is_start, iota, 0), dim=0).values
        slot = torch.where((k_s < sent) & (pos < kb), k_s * kb + pos, n_tiles * kb)
        tbl = torch.full((n_tiles * kb + 1,), -1, dtype=torch.int32, device=dev)
        tbl[slot] = p_s  # unique slots, but for the dropped overflow slot
        tbl = tbl[:n_tiles * kb].reshape(n_tiles, kb)
        cnt = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev).scatter_reduce(
            0, torch.clamp(k_s, max=sent).long(), pos + 1, reduce="amax"
        )
        tile_over = cnt[:n_tiles] > kb

        big = onscreen & ~small
        l_ids = _stable_first(big, lmax).long()
        sel_big = big[l_ids]
        big_over = big.sum() > lmax

        ids_tbl = torch.cat(
            [torch.clamp(tbl, min=0).long(), l_ids[None].expand(n_tiles, -1)], dim=1
        )
        sel = torch.cat([tbl >= 0, sel_big[None].expand(n_tiles, -1)], dim=1)
    frag = _raster_tiles(tri_screen, tri_depth, tri_inv_w, ids_tbl, sel, tw,
                         th, tile, width, height, kb + lmax)
    return frag, (tile_over | big_over).to(torch.float32).mean()


def tile_span(smin, smax, tile: int, tw: int, th: int):
    """Covered tile range (bx0, bx1, by0, by1), i32, of screen AABBs.
    Clamped in float before the integer cast, so off-screen or
    non-finite boxes give in-range (and masked) values."""
    inv_t = 1.0 / tile

    def span(v, hi):
        return torch.clamp(torch.floor(v * inv_t), 0, hi - 1).to(torch.int32)

    return (span(smin[:, 0], tw), span(smax[:, 0], tw),
            span(smin[:, 1], th), span(smax[:, 1], th))


def tiled_route(t: int, tile: int, n_tiles: int) -> str:
    """The path `rasterize_tiled(scatter=None)` takes for `t` triangle
    slots on `n_tiles` tiles of `tile` x `tile` pixels: "k3" (the exact
    segment path) wherever `raster_kernel.lays_out` accepts the layout,
    else "plain" (the capped per-tile scan, which on the card emulates
    each fused multiply-add in float64). The JAX package sends only
    meshes of more than 4096 triangles to its segment kernel; both
    paths give the full scan's image (`rasterize`) bit for bit wherever
    no tile's candidate list clips at k_max."""
    from .raster_kernel import lays_out

    return "k3" if lays_out(t, tile, n_tiles) else "plain"


def rasterize_tiled(
    tri_screen: torch.Tensor,   # (T, 3, 2)
    tri_depth: torch.Tensor,    # (T, 3)
    tri_inv_w: torch.Tensor,    # (T, 3)
    tri_valid: torch.Tensor,    # (T,)
    width: int,
    height: int,
    tile: int = 64,
    k_max: int = 256,
    scatter: bool | str | None = None,
) -> tuple[FragmentBuffer, torch.Tensor]:
    """Tile-binned rasterization: triangles are binned to screen tiles
    by their screen AABB; each tile tests only its candidate list.

    Returns (FragmentBuffer flat over pixels, overflow). `scatter=None`
    routes by `tiled_route`: every mesh K3 can lay out goes to the exact
    segment kernel (ops/raster_kernel.py, no per-tile cap; overflow is
    its 0/1 flag of a static bound, sized by `unbounded` up to 4096
    triangles so that it reads 0), the rest to the capped
    per-tile-overlap path (overflow is the fraction of tiles whose
    candidate list clipped at k_max). `scatter="exact"` forces the exact
    path with the JAX package's bounds, `scatter=True` the capped
    scatter table, `scatter=False` the capped per-tile-overlap path.
    The counter `raster.path` counts the path taken."""
    t = tri_screen.shape[0]
    dev = tri_screen.device
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    bounds = {}
    if scatter is None:
        scatter = "exact" if tiled_route(t, tile, n_tiles) == "k3" else False
        if scatter and t <= 4096:
            from .raster_kernel import unbounded

            # a table of every key: at most 4096 x (68 + 2047) rows of
            # 64 B; above 4096 triangles, the JAX package's bounds
            bounds = unbounded(t, n_tiles)
    if scatter == "exact":
        from .raster_kernel import rasterize_tiled_exact

        profiling.count("raster.path", path="k3")
        return rasterize_tiled_exact(
            tri_screen, tri_depth, tri_inv_w, tri_valid,
            width, height, tile=tile, **bounds,
        )
    if scatter:
        profiling.count("raster.path", path="scatter")
        return _rasterize_tiled_scatter(
            tri_screen, tri_depth, tri_inv_w, tri_valid,
            width, height, tile, k_max,
        )
    profiling.count("raster.path", path="plain")
    k_max = min(k_max, t)

    with profiling.span("hala.raster.bin"):
        smin = torch.amin(tri_screen, dim=1)  # (T, 2)
        smax = torch.amax(tri_screen, dim=1)
        x0, y0 = _tile_origins(n_tiles, tw, tile, dev)
        # (tiles, T) overlap and its stable sort, in blocks of tiles
        ids = torch.empty((n_tiles, k_max), dtype=torch.int64, device=dev)
        count = torch.empty((n_tiles,), dtype=torch.int64, device=dev)
        step = max(1, _BLOCK_ELEMS // t)
        for b0 in range(0, n_tiles, step):
            b1 = min(n_tiles, b0 + step)
            bx, by = x0[b0:b1, None], y0[b0:b1, None]
            overlap = (
                tri_valid[None]
                & (smax[None, :, 0] >= bx)
                & (smin[None, :, 0] <= bx + tile)
                & (smax[None, :, 1] >= by)
                & (smin[None, :, 1] <= by + tile)
            )
            count[b0:b1] = overlap.sum(dim=1)
            ids[b0:b1] = _stable_first(overlap, k_max).long()
        sel = torch.arange(k_max, device=dev)[None] < count[:, None]
    frag = _raster_tiles(tri_screen, tri_depth, tri_inv_w, ids, sel, tw, th,
                         tile, width, height, k_max)
    return frag, (count > k_max).to(torch.float32).mean()
