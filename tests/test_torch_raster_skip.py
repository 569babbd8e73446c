"""The pieces of the redesigned K3 and K1 that run on the CPU.

- `raster_kernel.skip_boxes` / `subtile_skip`, K3's sub-tile skip
  (csrc/raster_tiled.cu): on chip_smoke.py's `skip_breaking_triangles`
  (slivers whose rounded edge functions accept pixel centres outside
  their boxes, huge triangles, NaN and infinite corners, a dense tile)
  no skipped (candidate, sub-tile) holds a pixel that the inside test
  accepts, and a plain model of the kernel (each sub-tile walks its
  tile's segment in the plain version's chunks, minus the skipped rows)
  equals `raster_segments_plain`, the full scan `rasterize` and the JAX
  package's `rasterize_tiled_exact` in interpret mode.
- The chunk rule K3 follows: a NaN depth of a covering candidate
  cancels its 128-candidate chunk for that pixel in the plain version.
- chip_smoke.py's `subtile_pairs`, the count behind K3's sub-tile bound.
- K1's table repack (`pack_triangles`), its stage size and shared
  memory, and its ray slots (`ray_slots`).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops import raster_kernel as jk
from hala_tpu_torch.ops import raster as tr
from hala_tpu_torch.ops import raster_kernel as tk
from hala_tpu_torch.ops.pallas import intersect_kernel as k1

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the skip-breaking table, subtile_pairs)

FLOAT_TOL = 1e-6  # JAX vs the port: one ulp of platform rounding (test_torch_raster.py)
S = tk.SUB_TILE


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _segments(size, tile, n_dense, seed=21, finite=False):
    arrays = chip_smoke.skip_breaking_triangles(size, n_dense, seed, finite)
    args = [torch.from_numpy(a) for a in arrays]
    return arrays, args, tk.build_segments(*args, size, size, tile, huge_max=1024)


def _accepted_counts(seg, skip):
    """Over every walked row and every pixel of every sub-tile of its
    tile, by the kernel's inside test: (pairs accepted where `skip`
    holds, pairs accepted at a pixel centre outside the row's box)."""
    n = int(seg.starts[-1])
    tile_of = torch.searchsorted(seg.starts.long(), torch.arange(n), right=True) - 1
    sx, sy = tk.subtile_origins(seg.starts.shape[0] - 1, seg.tw, seg.tile, "cpu")
    d = torch.arange(S * S)
    dropped = outside = 0
    for r0 in range(0, n, 64):
        r1 = min(n, r0 + 64)
        rows = seg.data[r0:r1]
        t = tile_of[r0:r1]
        px = (sx[t][..., None] + d % S).float() + 0.5   # (rows, units, S*S)
        py = (sy[t][..., None] + d // S).float() + 0.5
        x0, y0, x1, y1, x2, y2 = (rows[:, k, None, None] for k in range(6))
        sgn = rows[:, 12, None, None]
        w0 = tr.edge(x2 - x1, y2 - y1, px - x1, py - y1)
        w1 = tr.edge(x0 - x2, y0 - y2, px - x2, py - y2)
        w2 = tr.edge(x1 - x0, y1 - y0, px - x0, py - y0)
        inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
        box_out = ((px < torch.fmin(torch.fmin(x0, x1), x2))
                   | (px > torch.fmax(torch.fmax(x0, x1), x2))
                   | (py < torch.fmin(torch.fmin(y0, y1), y2))
                   | (py > torch.fmax(torch.fmax(y0, y1), y2)))
        dropped += int((inside & skip[r0:r1, :, None]).sum())
        outside += int((inside & box_out).sum())
    return dropped, outside


def _skip_model(seg):
    """K3 as the kernel walks it, on tensors: each (tile, sub-tile)
    takes its tile's segment in CAND_CHUNK chunks from the start, minus
    the rows its warp skips, through the plain version's chunk step.
    Returns the (depth, tri, uw, vw, iw) planes, (n_tiles, tile*tile)."""
    starts, data, tw, tile = seg.starts, seg.data, seg.tw, seg.tile
    n_tiles = starts.shape[0] - 1
    upt = (tile // S) ** 2
    skip = tk.subtile_skip(starts, data, tw, tile)
    sx, sy = tk.subtile_origins(n_tiles, tw, tile, "cpu")
    d = torch.arange(S * S)
    px = (sx.reshape(-1, 1) + d % S).float() + 0.5   # (units, S*S)
    py = (sy.reshape(-1, 1) + d // S).float() + 0.5
    unit_tile = torch.arange(n_tiles * upt) // upt
    unit_sub = torch.arange(n_tiles * upt) % upt
    seg0 = starts[:-1].long()[unit_tile]
    seg_len = (starts[1:] - starts[:-1]).long()[unit_tile]
    planes = tr.empty_planes((n_tiles * upt, S * S), "cpu")
    j = torch.arange(tk.CAND_CHUNK)
    last = data.shape[0] - 1
    for k0 in range(0, int(seg_len.max()), tk.CAND_CHUNK):
        idx = torch.clamp(seg0[:, None] + k0 + j, max=last)
        ok = (k0 + j < seg_len[:, None]) & ~skip[idx, unit_sub[:, None]]
        planes = tr.chunk_step(planes, px, py, data[idx], ok)
    # back to each tile's row-major pixels
    lx = (sx.reshape(-1, 1) - unit_tile[:, None] % tw * tile) + d % S
    ly = (sy.reshape(-1, 1) - unit_tile[:, None] // tw * tile) + d // S
    dst = (unit_tile[:, None] * tile * tile + ly * tile + lx).reshape(-1)
    out = []
    for p in planes:
        flat = torch.empty(n_tiles * tile * tile, dtype=p.dtype)
        flat[dst] = p.reshape(-1)
        out.append(flat.reshape(n_tiles, tile * tile))
    return out


def _equal_planes(a, b):
    for x, y in zip(a, b):
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def test_skip_boxes_are_infinite_where_unproven():
    rows = tr.pack_candidates(
        torch.tensor([
            [[10.0, 10.0], [20.0, 10.0], [10.0, 20.0]],          # proven
            [[10.0, 10.0], [40.0, 10.0], [25.0, 10.0 + 1e-3]],   # sliver
            [[np.inf, 5.0], [0.0, 0.0], [0.0, 10.0]],            # infinite corner
            [[np.nan, 5.0], [3.0, 0.0], [3.0, 40.0]],            # NaN corner
            [[-1e7, -1e7], [2e7, -5e6], [0.0, 2e7]],             # past 2^22
            [[10.0, 10.0], [10.0 + 2e-6, 10.0], [10.0, 10.0 + 2e-6]],  # below 2^-16
        ], dtype=torch.float32),
        torch.zeros(6, 3), torch.ones(6, 3), torch.arange(6, dtype=torch.int32))
    b = tk.skip_boxes(rows)
    m = 10.0 * 2.0 ** -9 + 1.0
    assert b[0].tolist() == pytest.approx([10.0 - m, 20.0 + m, 10.0 - m, 20.0 + m])
    assert torch.isfinite(b[0]).all()
    for r in range(1, 6):
        assert b[r].tolist() == [-np.inf, np.inf, -np.inf, np.inf], r
    # a flipped sign that disagrees with the area is not proven either
    bad = rows[:1].clone()
    bad[0, 12] = -1.0
    assert not torch.isfinite(tk.skip_boxes(bad)).any()


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_no_skipped_pair_is_accepted(tile):
    """No (row, sub-tile) that K3 skips holds a pixel centre that the
    rounded inside test accepts, on a table whose slivers are accepted
    at pixel centres outside their boxes (so a skip without the margin
    would drop pairs the full scan writes)."""
    _, _, seg = _segments(128, tile, 400)
    n = int(seg.starts[-1])
    skip = tk.subtile_skip(seg.starts, seg.data, seg.tw, seg.tile)
    dropped, outside = _accepted_counts(seg, skip)
    assert dropped == 0
    assert outside > 0   # the table breaks a skip without the margin
    # at tile 16 the unit is the tile, which every binned row reaches
    assert float(skip[:n].float().mean()) >= {16: 0.0, 32: 0.1}.get(tile, 0.3)
    assert skip[n:].all()   # rows past the segments are never walked


@pytest.mark.parametrize("tile", [32, 64])
def test_skip_model_matches_plain(tile):
    """The skip model equals the plain version bit for bit, non-finite
    rows included, and the dense tile holds the longest segment."""
    _, _, seg = _segments(128, tile, 300)
    ref = tk.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    _equal_planes(_skip_model(seg), ref)
    lengths = seg.starts[1:] - seg.starts[:-1]
    assert int(lengths.max()) > 300 * (tile / 64) ** 2 and float(seg.over) == 0.0


def test_skip_model_matches_jax_interpret_and_full_scan():
    """On the finite table, the skip model's fragments equal the plain
    version's bit for bit and the JAX package's Pallas kernel in
    interpret mode (ids equal, depth and barycentrics to FLOAT_TOL). The
    infinite rows stay out: there the JAX kernel walks a segment one
    candidate at a time, where the port follows its chunk rule (next
    test). Against the full scan `rasterize` they differ only where the
    full scan's winner is a sliver whose rounded edge functions accept a
    pixel centre outside its box: the binning of both packages is by
    box, so such a pixel in another tile never sees it."""
    size, tile = 64, 32
    arrays, args, seg = _segments(size, tile, 120, seed=5, finite=True)
    planes = _skip_model(seg)
    frag = tk.segments_to_fragments(planes, seg, size, size)
    ref = tk.segments_to_fragments(
        tk.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile), seg, size, size)
    for k in ("depth", "tri", "u", "v"):
        assert torch.equal(getattr(frag, k), getattr(ref, k)), k
    jf, jo = jk.rasterize_tiled_exact(*[jnp.asarray(a) for a in arrays], size, size,
                                      tile=tile, huge_max=1024, interpret=True)
    assert float(jo) == 0.0
    np.testing.assert_array_equal(np.asarray(jf.tri), frag.tri.numpy())
    for k in ("depth", "u", "v"):
        np.testing.assert_allclose(getattr(frag, k).numpy(), np.asarray(getattr(jf, k)),
                                   rtol=0, atol=FLOAT_TOL, err_msg=k)
    pix = np.arange(size * size)
    px = (pix % size).astype(np.float32) + 0.5
    py = (pix // size).astype(np.float32) + 0.5
    t = args[0].shape[0]
    full = tr.rasterize(*args, torch.from_numpy(px), torch.from_numpy(py), chunk=t)
    diff = ((full.tri != frag.tri)
            | (full.depth.view(torch.int32) != frag.depth.view(torch.int32))).numpy()
    corners = arrays[0][full.tri.numpy()[diff]]
    outside = ((px[diff] < corners[:, :, 0].min(1)) | (px[diff] > corners[:, :, 0].max(1))
               | (py[diff] < corners[:, :, 1].min(1)) | (py[diff] > corners[:, :, 1].max(1)))
    assert diff.sum() > 0 and outside.all()
    same = ~diff
    for k in ("u", "v"):
        x, y = getattr(full, k).numpy()[same], getattr(frag, k).numpy()[same]
        assert np.array_equal(x.view(np.int32), y.view(np.int32)), k


def test_nan_depth_cancels_its_chunk():
    """A triangle with an infinite corner covers pixels with NaN depth
    (inf * 0 barycentrics); in the plain version, which K3 follows, that
    cancels its chunk's winner there, so the finite triangle behind it
    in the same chunk does not win those pixels. The skip never drops
    the infinite row."""
    scr = torch.tensor([[[np.inf, 5.0], [0.0, 0.0], [0.0, 10.0]],
                        [[0.0, 0.0], [16.0, 0.0], [0.0, 16.0]]], dtype=torch.float32)
    seg = tk.build_segments(scr, torch.tensor([[0.5] * 3, [0.3] * 3]),
                            torch.ones(2, 3), torch.ones(2, dtype=torch.bool), 16, 16, 16)
    planes = tk.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    _equal_planes(_skip_model(seg), planes)
    tri = planes[1].reshape(16, 16)
    assert (tri[5:10, :4] == -1).all()    # covered by both, cancelled
    assert (tri[:5, :4] == 1).all() and (tri[10:12, :4] == 1).all()
    assert not tk.subtile_skip(seg.starts, seg.data, seg.tw, seg.tile)[:2].any()


def test_subtile_pairs_by_hand():
    """Two triangles in a 64x64 tile: a 3x3 one inside sub-tile (1, 1)
    and a 40x40 one over sub-tiles (0..2, 0..2)."""
    scr = torch.tensor([[[20.0, 20.0], [23.0, 20.0], [20.0, 23.0]],
                        [[2.0, 2.0], [42.0, 2.0], [2.0, 42.0]]], dtype=torch.float32)
    seg = tk.build_segments(scr, torch.full((2, 3), 0.5), torch.ones(2, 3),
                            torch.ones(2, dtype=torch.bool), 64, 64, 64)
    skip = tk.subtile_skip(seg.starts, seg.data, seg.tw, seg.tile)
    assert (~skip[0]).nonzero().squeeze(1).tolist() == [5]
    assert (~skip[1]).nonzero().squeeze(1).tolist() == [0, 1, 2, 4, 5, 6, 8, 9, 10]
    assert chip_smoke.subtile_pairs(seg) == 10 * S * S


def test_k1_pack_triangles():
    rs = np.random.RandomState(3)
    v0, e1, e2 = (torch.from_numpy(rs.normal(size=(50, 3)).astype(np.float32))
                  for _ in range(3))
    packed = k1.pack_triangles(v0, e1, e2, 37)
    assert packed.shape == (37, 12) and packed.is_contiguous()
    rows = packed.reshape(37, 3, 4)
    for q, src in enumerate((v0, e1, e2)):
        assert torch.equal(rows[:, q, :3], src[:37])
        assert (rows[:, q, 3] == 0).all()
    assert k1.pack_triangles(v0, e1, e2, 0).shape == (0, 12)


@pytest.mark.parametrize("num_real", [0, 34, 4096, 6000])
def test_k1_stage_fits_shared_memory(num_real):
    stage = k1.stage_triangles(num_real)
    assert 1 <= stage <= k1.STAGE_MAX and stage >= min(num_real, k1.STAGE_MAX)
    assert k1.smem_bytes(stage) <= k1.SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 1024, 5013])
def test_k1_ray_slots(n):
    """Every ray sits in one slot; each warp's slot reads 32 consecutive
    rays; slots past n are -1."""
    slots = k1.ray_slots(n)
    assert slots.shape[1:] == (k1.RAYS_PER_THREAD, k1.BLOCK_THREADS)
    got = slots[slots >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(n))
    assert int((slots < 0).sum()) == slots.numel() - n
    warps = slots.reshape(-1, k1.RAYS_PER_THREAD, k1.BLOCK_THREADS // 32, 32)
    live = warps[..., 0] >= 0
    step = warps[..., 1:] - warps[..., :-1]
    assert (step[live & (warps[..., -1] >= 0)] == 1).all()


def test_k1_packed_table_is_kept_while_unchanged():
    """The wrapper packs a geometry once: the same three tensors, unchanged,
    give the same table; an in-place change repacks."""
    rs = np.random.RandomState(4)
    v0, e1, e2 = (torch.from_numpy(rs.normal(size=(40, 3)).astype(np.float32))
                  for _ in range(3))
    first = k1.packed_triangles(v0, e1, e2, 40)
    assert k1.packed_triangles(v0, e1, e2, 40) is first
    assert k1.packed_triangles(v0, e1, e2, 30).shape == (30, 12)
    e1.mul_(2.0)
    again = k1.packed_triangles(v0, e1, e2, 40)
    assert again is not first
    assert torch.equal(again, k1.pack_triangles(v0, e1, e2, 40))
