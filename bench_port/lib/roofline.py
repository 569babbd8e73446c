"""The yardstick of the kernels' roofline shares.

A share is the least time the card could take for the work the
function needs on the inputs of one launch, over the time the launch
took. The least time is the larger of the operations over the fp32 rate
and the bytes (each input read once, each output written once) over the
memory rate, at the published peaks of one H100 SXM (67 TFLOP/s fp32
outside the tensor cores, 3.35 TB/s). The work is counted by a fixed
rule on the launch's inputs, the same whatever implementation answers
them:

- K1 (brute-force closest or any hit over a table of triangles): every
  live ray (t_max above 1e-4) against every real triangle, 45 operations
  a Moller-Trumbore pair. A brute force has no structure to skip with.
- K2 (closest or any hit over the cluster layout): `k2_work`, the
  operations the walk over the layout's own boxes needs with each ray's
  answer known: one slab test of each 16-box group's union, the member
  tests of the groups where the ray enters a member before its end, the
  eight span boxes of each cluster it so enters, and Moller-Trumbore on
  the real triangles of the spans it enters before its end. For an
  any-hit launch a ray's end is its limit where nothing blocks it, and a
  blocked ray is counted as one Moller-Trumbore pair.
- K3 (tile-binned rasterization of the segment table): every (candidate,
  pixel) pair whose pixel centre the candidate covers, 26 operations
  each (edge functions, signs, barycentrics and depth); an exact
  rasterizer resolves at least those. Bytes: the segment table read once
  and the five per-pixel planes written once.

The operation counts per pair are read off the kernels as the port's
measurement script reads them: 44 for classic Moller-Trumbore plus the
reciprocal, 32 for a padded slab test, 18 for a raster pair's edge
functions and signs and 8 more inside. None depends on the program.
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_MT = 45
OPS_SLAB = 32
OPS_RASTER_EDGE = 18
OPS_RASTER_INSIDE = 8

# the cluster layout the K2 launch reads: 128-slot clusters of 16-slot
# spans, whose boxes are row 9 of each cluster's packed block; K2 walks
# blocks of 128 consecutive rays
CLUSTER_SLOTS = 128
SPAN_SLOTS = 16
SPANS = CLUSTER_SLOTS // SPAN_SLOTS
BLOCK_RAYS = 128
GROUP = 16

# the padded slab test of the cluster walks
_PAD_REL = float(np.float32(1e-5))
_PAD_ABS = float(np.float32(1e-6))
_TINY_DIR = float(np.float32(1e-20))
_WIDEN_UP = float(np.float32(1.0) + np.float32(1e-6))
_WIDEN_DOWN = float(np.float32(1.0) - np.float32(1e-6))


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds for `ops` fp32 operations and `nbytes` bytes,
    and which of the two bounds it."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def slab_entry(o, d, lo3, hi3):
    """Entry distance into the padded box (widened down) and whether
    the ray enters it at all, broadcast over leading dims."""
    tn = tf = inside = None
    for ax in range(3):
        lo = lo3[..., ax]
        hi = hi3[..., ax]
        pad = _PAD_REL * (torch.abs(lo) + torch.abs(hi)) + _PAD_ABS
        lo_p = lo - pad
        hi_p = hi + pad
        oa = o[..., ax]
        da = d[..., ax]
        inv = 1.0 / da
        t0 = (lo_p - oa) * inv
        t1 = (hi_p - oa) * inv
        par = torch.abs(da) < _TINY_DIR
        tn_a = torch.where(par, -torch.inf, torch.minimum(t0, t1))
        tf_a = torch.where(par, torch.inf, torch.maximum(t0, t1))
        in_a = ~par | ((lo_p <= oa) & (oa <= hi_p))
        tn = tn_a if tn is None else torch.maximum(tn, tn_a)
        tf = tf_a if tf is None else torch.minimum(tf, tf_a)
        inside = in_a if inside is None else inside & in_a
    tn = torch.where(tn < 0.0, tn * _WIDEN_UP, tn * _WIDEN_DOWN)
    tf = torch.where(tf > 0.0, tf * _WIDEN_UP, tf * _WIDEN_DOWN)
    return tn, inside & (tn <= tf) & (tf > 0.0)


def span_work(tri_packed, tri_real, o, d, r, c, t_end) -> int:
    """Moller-Trumbore pairs of the (ray r, cluster c) pairs given: the
    real triangles of the spans whose row-9 box the ray enters at or
    before t_end."""
    real = tri_real.view(-1, SPANS, SPAN_SLOTS).sum(dim=2)
    count = 0
    for p0 in range(0, r.numel(), 1 << 20):
        rr, cc = r[p0:p0 + (1 << 20)], c[p0:p0 + (1 << 20)]
        boxes = tri_packed[cc, 9, :6 * SPANS].view(-1, SPANS, 6)
        tn, enters = slab_entry(o[rr, None, :], d[rr, None, :], boxes[..., :3], boxes[..., 3:])
        passed = enters & (tn <= t_end[rr, None])
        count += int((passed.long() * real[cc]).sum())
    return count


def k2_work(launch) -> tuple[float, str, dict]:
    """Bound of one K2 launch from its inputs and answers: a dict with
    o, d, tm, cmin, cmax, tri_packed, any_hit, and the answers t and
    tri. Padding slots hold their first corner at 3e37."""
    o, d, tm = launch["o"], launch["d"], launch["tm"]
    cmin, cmax, packed = launch["cmin"], launch["cmax"], launch["tri_packed"]
    tri_real = (packed[:, 0, :].abs() < 1e37).reshape(-1)
    n, c = o.shape[0], cmin.shape[0]
    sizes = torch.full((-(-c // GROUP),), GROUP, device=o.device)
    sizes[-1] = c - GROUP * (sizes.numel() - 1)
    blocked = launch["tri"] >= 0
    if launch["any_hit"]:
        t_end = tm
        live = (tm > 1e-4) & ~blocked
    else:
        t_end = torch.where(blocked, launch["t"], tm)
        live = tm > 1e-4
    w = dict(live_rays=int(live.sum()), groups=sizes.numel(), member_tests=0, pairs=0,
             mt_pairs=int((blocked & (tm > 1e-4)).sum()) if launch["any_hit"] else 0)
    rows, cols = 1 << 16, 256
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        for c0 in range(0, c, cols):
            tn, enters = slab_entry(o[sl, None, :], d[sl, None, :],
                                    cmin[None, c0:c0 + cols], cmax[None, c0:c0 + cols])
            m = enters & (tn <= t_end[sl, None]) & live[sl, None]
            m_g = torch.nn.functional.pad(m, (0, -m.shape[1] % GROUP))
            m_g = m_g.view(m.shape[0], -1, GROUP).any(dim=2)
            g0 = c0 // GROUP
            w["member_tests"] += int((m_g.long() * sizes[None, g0:g0 + m_g.shape[1]]).sum())
            rr, cc = torch.nonzero(m, as_tuple=True)
            w["pairs"] += rr.numel()
            w["mt_pairs"] += span_work(packed, tri_real, o, d, rr + r0, cc + c0, t_end)
    ops = ((w["live_rays"] * w["groups"] + w["member_tests"] + w["pairs"] * SPANS) * OPS_SLAB
           + w["mt_pairs"] * OPS_MT)
    ms, by = bound_ms(ops, n * 44 + c * 24 + packed.numel() * 4)
    return ms, by, w


def k1_work(launch) -> tuple[float, str, dict]:
    """Bound of one K1 launch: live rays x real triangles pairs."""
    tm = launch["tm"]
    n = tm.shape[0]
    live = int((tm > 1e-4).sum())
    real = int(launch["num_real"])
    ops = live * real * OPS_MT
    ms, by = bound_ms(ops, n * 44 + real * 36)
    return ms, by, dict(live_rays=live, triangles=real)


def k3_work(launch) -> tuple[float, str, dict]:
    """Bound of one K3 launch from its segment table: (starts, data)
    with the packed rows (x0, y0, x1, y1, x2, y2, ...) of each tile's
    candidates, the tiles' row count `tw` and side `tile`. Counts the
    (candidate, pixel) pairs whose pixel centre lies inside the
    candidate (either winding, edges included)."""
    starts, data = launch["starts"].long(), launch["data"]
    tw, tile = launch["tw"], launch["tile"]
    n_tiles = starts.numel() - 1
    seg_len = starts[1:] - starts[:-1]
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=data.device), seg_len)
    rows = data[starts[0]:starts[-1]]
    tx0 = ((tile_of % tw) * tile).to(torch.float64)
    ty0 = ((tile_of // tw) * tile).to(torch.float64)
    xy = rows[:, :6].to(torch.float64).view(-1, 3, 2)
    # pixel-centre span of each candidate's box, clipped to its tile
    lo = torch.floor(xy.amin(dim=1) - 0.5)
    hi = torch.ceil(xy.amax(dim=1) - 0.5)
    x_lo = torch.clamp(lo[:, 0], min=tx0) - tx0
    x_hi = torch.clamp(hi[:, 0], max=tx0 + tile - 1) - tx0
    y_lo = torch.clamp(lo[:, 1], min=ty0) - ty0
    y_hi = torch.clamp(hi[:, 1], max=ty0 + tile - 1) - ty0
    inside = 0
    k = torch.arange(tile, device=data.device, dtype=torch.float64)
    for r0 in range(0, rows.shape[0], 1 << 12):
        sl = slice(r0, r0 + (1 << 12))
        pxs = tx0[sl, None] + k[None, :] + 0.5
        pys = ty0[sl, None] + k[None, :] + 0.5
        okx = (k[None, :] >= x_lo[sl, None]) & (k[None, :] <= x_hi[sl, None])
        oky = (k[None, :] >= y_lo[sl, None]) & (k[None, :] <= y_hi[sl, None])
        p = xy[sl]
        px = pxs[:, None, :]
        py = pys[:, :, None]
        ws = []
        for a, b in ((1, 2), (2, 0), (0, 1)):
            ex = p[:, b, 0] - p[:, a, 0]
            ey = p[:, b, 1] - p[:, a, 1]
            ws.append(ex[:, None, None] * (py - p[:, a, 1, None, None])
                      - ey[:, None, None] * (px - p[:, a, 0, None, None]))
        pos = (ws[0] >= 0) & (ws[1] >= 0) & (ws[2] >= 0)
        neg = (ws[0] <= 0) & (ws[1] <= 0) & (ws[2] <= 0)
        box = oky[:, :, None] & okx[:, None, :]
        inside += int(((pos | neg) & box).sum())
    ops = inside * (OPS_RASTER_EDGE + OPS_RASTER_INSIDE)
    nbytes = data.numel() * 4 + starts.numel() * 4 + n_tiles * tile * tile * 20
    ms, by = bound_ms(ops, nbytes)
    return ms, by, dict(inside_pairs=inside, candidates=int(rows.shape[0]))
