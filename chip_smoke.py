#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (hala_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit) and torch/CUDA/nvcc versions;
  2. build the CUDA kernels from hala_tpu_torch/csrc, one nvcc per
     source started together (timed);
  3. each kernel against its plain PyTorch version on the card — the
     brute-force kernel (K1), bit for bit, closest and any-hit, on the
     Cornell box, on a 300-triangle soup with a ragged ray count and on
     a 4096-triangle soup with 524,288 live rays (timed on the Cornell
     box and the 4096-triangle soup), the cluster-traversal kernel
     (K2) on assets/atrium_big.glb's mixed batches of 65,536 and 2^21
     rays, unsorted and in matrix_query's coherence order, against its
     plain version bit for bit (closest, and the any-hit mask) and
     against K1 (closest, and the any-hit mask), its schedule (clusters
     visited per 128-ray block) against the plain model
     `matrix_walk_runs_plain`, timed on all four batches, the tile-segment raster kernel (K3) on
     atrium_big at 1920x1088 (tile 64, bench camera) against its plain
     version and at 256x256 against the full-scan `rasterize`, bit for
     bit (timed, with the pairs its sub-tile skip leaves), and on a
     synthetic table built to break the skip (`skip_breaking_triangles`:
     slivers along sub-tile borders, huge and non-finite rows, a tile of
     more than 5000 candidates) against its plain version; the large-scene engines on atrium_big: the cull (K4, a warp
     skipping 16-box groups no lane enters) at K 4, 12 and 16 unsorted
     and sorted and through a forced superchunk merge, the candidate
     walk (K5, half a warp a ray, unsorted and sorted) and the cluster
     stream (K6, a warp a queued ray) at K 12 and 4, on the full range
     and with every ray resolved, each bit for bit against its plain
     version, `intersect_traversed` and K6 against K2, the three
     kernels again at the main path's 2^21-ray queries (timed there on
     both orders, K4 and K6 with their recounted bounds, `k4_work` and
     `k2_work`); then five instances of atrium_big side by side
     (`instanced_scene`, uploaded through the SAH build: above 8191
     clusters, so two cull superchunks) with `intersect_traversed`
     against K1 over all slots, and K4 (both superchunks, both orders)
     and K6 (the fallback) against their plain versions bit for bit at
     2^21 rays, timed, with the cost of the superchunk merge; the grouped walk (K8) and
     the wavefront walk (K7) against their plain versions, bit for bit,
     closest and any-hit, on a table built to break their span mask
     (`span_breaking_walls`), on 65,536 coherence-sorted mixed rays at
     tight caps (k_cap 2; k_per_ray 3, m_group 8: lists truncate, the
     fallback runs) and at the defaults, both engines there against
     K2's canonical hits, and again at 2^21 sorted rays (timed there,
     with the walked and tested entries per group, the span pairs each
     ray enters and the spans some lane of each warp enters, the bound
     from them and the old one, and the share of rays sent to the
     fallback); the admissibility rule of the cluster walks
     (ops/cluster.py) on `grazing_beside_span`, seeds 1-5: K2, K5 and K6
     equal `stream_plain` bit for bit (K2 also its schedule model), K7
     and K8 their plain versions, and the rays K1 hits through pairs
     the rule rejects are counted — then the golden renders (path tracer, with the
     environment-map golden, and rasterizer) held against
     tests/fixtures (RMSE < 1e-3);
  4. Cornell 512x512, depth 4, 16 frames through RayTracingRenderer
     (must go through K1 only);
  5. atrium_big at 1920x1088, depth 4, 1 spp, 4 frames (must use K2
     and none of K4-K6) and a torch.profiler window over one more of
     its frames, then the same through intersector="traverse"
     (must launch K4, K5 and K6 and not K2; its relative RMSE to the K2
     film is printed), a torch.profiler window over one traverse frame
     and one more frame for the engine's counts (unresolved share,
     clusters visited), then one frame through intersector="cluster"
     (K6 only), which must match the traverse render's frame 0 within
     relative RMSE 2e-3; then the witness for the K2 distance: rows
     480-607 of frame 0 through K1 ("pallas", shadow rays batched as
     the traverse engine's) must match the traverse frame 0 there within
     2e-3, and the K2 frame 0's distance to them is printed; then the
     five instances at 1920x1088 through intersector="auto" (must take
     "traverse": two K4 launches a query, K5 and K6, no K2 and no K1;
     rays above 1.2x camera rays; a torch.profiler window over one more
     frame), whose frame 0 must match one "cluster" frame and rows
     480-607 of frame 0 through "pallas" (K1) within relative RMSE
     2e-3; each
     renderer first runs one untimed warm-up frame on a film it then
     discards (frame 0 is kept for the comparisons), except the cluster
     frame, whose kernels are already loaded; then the K2 render again
     without and with matrix_query's coherence sort, in turns (the films
     must be equal bit for bit); atrium_big through
     intersector="grouped" (K8 + K2 as its fallback), "wavefront" (K4 +
     K7 + K2) and "matrix" with shadow_intersector and
     extend_intersector "wavefront" (K 8), each within relative RMSE
     2e-3 of the K2 film of the same frames, with the engines' counts
     from one more frame, and a torch.profiler window over one
     wavefront frame; bench.py's envmap configuration (Cornell box
     without its light under a seeded 64x128 map, 512x512, 16 frames;
     K1 only) and a short Cornell render with a seeded blue-noise
     texture; examples/render_procedural.py's scene (the Cornell box
     and three procedural spheres, 512x512, depth 6, rr 2; K1 only), two
     warm-up frames then 16 timed frames, whose film mean must lie in
     PROCEDURAL_MEAN's band and whose frame 0 must equal frame 0 through
     the plain brute force within relative RMSE 2e-3, with a
     torch.profiler window over one more frame; atrium_big with three
     spheres on the camera's view axis (at least 1 % of the primary
     hits) through "auto" (K2, sorted) and "traverse" (K4, K5, K6),
     whose frame 0 must match one "cluster" frame; the Cornell box at
     512x512 through RayTracingProgram with identity kernels on every
     seam (the hookless film bit for bit), then with a constant miss
     kernel and a closest-hit kernel forcing the albedo (the film and
     the albedo AOV change as set), timed with and without hooks;
  6. bench.py's raster cells through RasterizationRenderer with the
     ACES post program: raster_atrium (atrium_big 1920x1088, binned,
     tile 64; must launch K3) and raster (Cornell 1920x1088, binned; the
     plain per-tile path, no K3), each one warm-up frame then timed
     frames, and a torch.profiler window over raster_atrium frames;
  7. save_images and a finiteness check of the PFMs.
Phases 4-6 are the main path: launch counts are zeroed just before each
render and read just after. bench.py's invariants (film or image mean
band; for the path tracer, rays above 1.2x camera rays) must hold for
every render.

The second-to-last stdout line is the per-kernel JSON record; the last
is {"ok": true, "device": {...}}. Without CUDA the script exits 2
before printing any result. It imports neither jax nor hala_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_TOL = 1e-5  # rtol for t/u/v and the near-tie band for triangle ids
# Published H100 SXM peaks: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations (an FMA counts two) per pair, read off the kernels:
# Moller-Trumbore ray x triangle (csrc/intersect_bruteforce.cu) 44 plus
# the reciprocal; the conservative slab test of a ray x cluster box
# (csrc/matrix_traverse.cu) 3 axes x 8 plus 8 to combine and widen;
# a raster candidate x pixel (csrc/raster_tiled.cu): the three edge
# functions 15 and their sign products 3 on every pair, then the
# barycentrics 3 and the depth 5 only where the pixel is inside; the
# reference's slab test of a ray x cluster box in the cull
# (csrc/cull_topk.cu): 6 differences, 6 products, 10 min/max and 4
# compares.
OPS_MT = 45
OPS_SLAB = 32
OPS_RASTER_EDGE = 18
OPS_RASTER_INSIDE = 8
OPS_CULL = 26
# the factored Moller-Trumbore of csrc/mm_chunk_test.cuh per (ray, slot)
# pair: on every pair the division-free test, det (3 products, 2 adds,
# the negation), u_num and v_num (6 products, 5 adds each, and v_num's
# negation), the sign select of the three (4) and us + vs with its 4
# compares; only where that passes t_num (3 products, 3 adds), the
# reciprocal, t and the 2 range compares
OPS_MM_REJECT = 38
OPS_MM_PASS = 10
TRAVERSE_K = 12  # RenderSettings.traverse_k, the main path's K
# copies of atrium_big side by side: the scene "auto" sends to K4-K6
INSTANCES = 5
# traverse frame 0 vs the cluster frame and vs the brute-force band
REL_RMSE_TOL = 2e-3
# the witness band of frame 0: first row and row count of 1920x1088
BAND_ROWS = (480, 128)
# The film mean of the procedural phase (frames 0-15 of
# examples/render_procedural.py's scene at 512x512, depth 6, rr 2): the
# JAX package on the CPU read 0.7778406143188477, with 5.680 rays per
# camera ray (tools/jax_procedural_band.py, "bruteforce", 62 s on a
# shared x86 host); the port must land within PROCEDURAL_BAND of it
# (relative; side-by-side films agree to ~1e-3 relative RMSE, so their
# means far closer).
PROCEDURAL_MEAN = 0.7778406143188477
PROCEDURAL_BAND = 5e-3
SPHERE_SHARE_MIN = 0.01  # primary hits on the spheres added to atrium_big
RASTER_FRAMES = {"raster_atrium": 10, "raster": 10}
JAX_TPU_REFERENCE = {  # (film mean, rays per primary) of the JAX package
    "cornell": (0.6949, 5.46),
    "sponza": (0.4850, 6.49),
    "envmap": (0.0352, 7.92),
}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for `ops` fp32 operations and `nbytes` bytes on
    the published peaks, and which of the two bounds it."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs after a warm-up
    of at least 50 ms (the card's clocks ramp up from idle)."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < 0.05:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# ray batches
# ---------------------------------------------------------------------------


def camera_rays(dev_scene, width: int, height: int, seed: int):
    """Jittered camera rays of the scene's first camera."""
    import torch

    from hala_tpu_torch.ops.camera import generate_rays

    dev = dev_scene.geometry.tri_v0.device
    rs = np.random.RandomState(seed)
    n = width * height
    pix = torch.arange(n, device=dev)
    jit = torch.from_numpy(rs.uniform(0, 1, (n, 4)).astype(np.float32)).to(dev)
    return generate_rays(
        dev_scene.cameras, 0, (pix % width).float(), (pix // width).float(),
        width, height, jit[:, :2], jit[:, 2:],
    )


def random_rays(dev_scene, n: int, seed: int):
    """Origins inside the scene's bounds, uniform directions."""
    import torch

    g = dev_scene.geometry
    real = g.tri_mat >= 0
    v0 = g.tri_v0[real]
    lo = v0.amin(dim=0).cpu().numpy()
    hi = v0.amax(dim=0).cpu().numpy()
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dev = g.tri_v0.device
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def mixed_batch(dev_scene, n_cam_w: int, n_cam_h: int, n_rand: int, seed: int):
    """Camera + random rays with a t_max column: mostly unbounded, a
    quarter bounded at random distances, and a few dead (t_max = 0)."""
    import torch

    from hala_tpu_torch.ops.intersect import T_MAX

    oc, dc = camera_rays(dev_scene, n_cam_w, n_cam_h, seed)
    orr, drr = random_rays(dev_scene, n_rand, seed + 1)
    o = torch.cat([oc, orr]).contiguous()
    d = torch.cat([dc, drr]).contiguous()
    n = o.shape[0]
    rs = np.random.RandomState(seed + 2)
    tm = np.full(n, T_MAX, np.float32)
    bounded = rs.uniform(0, 1, n) < 0.25
    tm[bounded] = rs.uniform(0.05, 8.0, bounded.sum()).astype(np.float32)
    tm[rs.uniform(0, 1, n) < 0.01] = 0.0
    return o, d, torch.from_numpy(tm).to(o.device)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def compare_hits(name: str, a, b, o, d, g) -> float:
    """Raise unless hits a and b agree: equal triangle ids except at
    near-ties (both canonical t within T_TOL * t), t/u/v within rtol
    T_TOL where the ids agree. Returns the max abs difference of
    t, u, v over agreeing hits."""
    import torch

    from hala_tpu_torch.ops.intersect import Hit, canonical_hit

    tri_a, tri_b = a.tri, b.tri
    diff = torch.nonzero(tri_a != tri_b).squeeze(1)
    if diff.numel():
        ca = canonical_hit(o[diff], d[diff], g.tri_v0, g.tri_e1, g.tri_e2,
                           Hit(a.t[diff], tri_a[diff], a.u[diff], a.v[diff]))
        cb = canonical_hit(o[diff], d[diff], g.tri_v0, g.tri_e1, g.tri_e2,
                           Hit(b.t[diff], tri_b[diff], b.u[diff], b.v[diff]))
        both = (tri_a[diff] >= 0) & (tri_b[diff] >= 0)
        gap = torch.abs(ca.t - cb.t)
        tie = both & (gap <= T_TOL * torch.maximum(ca.t, cb.t))
        listed = [
            (int(i), int(x), int(y), float(p), float(q))
            for i, x, y, p, q in zip(
                diff[:8].tolist(), tri_a[diff][:8].tolist(),
                tri_b[diff][:8].tolist(), ca.t[:8].tolist(), cb.t[:8].tolist(),
            )
        ]
        log(f"  {name}: {diff.numel()} id mismatches "
            f"({int(tie.sum())} near-ties); first (ray, tri_a, tri_b, t_a, t_b): "
            f"{listed}")
        if not bool(tie.all()):
            raise AssertionError(f"{name}: triangle ids disagree beyond near-ties")
    same = (tri_a == tri_b) & (tri_a >= 0)
    err = 0.0
    for fa, fb in ((a.t, b.t), (a.u, b.u), (a.v, b.v)):
        x, y = fa[same], fb[same]
        if x.numel():
            if not torch.allclose(x, y, rtol=T_TOL, atol=T_TOL):
                raise AssertionError(f"{name}: t/u/v disagree beyond rtol {T_TOL}")
            err = max(err, float(torch.max(torch.abs(x - y))))
    miss = tri_a < 0
    if not torch.equal(a.t[miss & (tri_b < 0)], b.t[miss & (tri_b < 0)]):
        raise AssertionError(f"{name}: miss t differs")
    log(f"  {name}: ids agree, max |dt,du,dv| = {err:.3g}")
    return err


def check_k1(dev_scene, soup_scene, big_soup, n_rays: int, ragged: int, reps: int):
    """K1 (csrc/intersect_bruteforce.cu) vs its plain version, bit for
    bit, closest and any-hit: the Cornell box's mixed batch (timed), a
    300-triangle soup with a ragged ray count, and a 4096-triangle soup
    (the top of "auto"'s brute-force range) with n_rays live rays
    (timed)."""
    import torch

    from hala_tpu_torch.ops.pallas import intersect_kernel as k1

    rec = {}
    for label, ds, cam in (("cornell", dev_scene, True), ("soup", soup_scene, False),
                           ("soup4096", big_soup, False)):
        g = ds.geometry
        num_real = g.num_triangles
        side = int(np.sqrt(n_rays // 2))
        if cam:
            o, d, tm = mixed_batch(ds, side, side, n_rays - side * side, 11)
        else:
            n = n_rays + (ragged if label == "soup" else 0)
            o, d = random_rays(ds, n, 12)
            tm = torch.full((o.shape[0],), 3.0e38, device=o.device)
        args = (o, d, g.tri_v0, g.tri_e1, g.tri_e2)
        hk = k1.intersect_pallas(*args, t_max=tm, num_real=num_real)
        hp = k1.intersect_pallas_plain(*args, t_max=tm, num_real=num_real)
        torch.cuda.synchronize()
        equal_tensors(f"K1 {label} closest", hk, hp, ("t", "tri", "u", "v"))
        ok = k1.occluded_pallas(o, d, tm, *args[2:], num_real=num_real)
        op = k1.occluded_pallas_plain(o, d, tm, *args[2:], num_real=num_real)
        if not torch.equal(ok, op):
            raise AssertionError(f"K1 {label}: any-hit disagrees "
                                 f"({int((ok != op).sum())} rays)")
        log(f"  K1 {label} (N={o.shape[0]}, {num_real} triangles): closest "
            f"t, tri, u, v and any-hit equal bit for bit "
            f"({int((hk.tri >= 0).sum())} hits, {int(ok.sum())} blocked)")
        if label == "soup":
            continue
        live = int((tm > 1e-4).sum())
        n = o.shape[0]
        b_ms, b_by = bound(live * num_real * OPS_MT, n * 44 + num_real * 36)
        r = dict(
            bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_diff(hk, hp),
            ms=cuda_ms(lambda: k1.intersect_pallas(
                *args, t_max=tm, num_real=num_real), reps),
            anyhit_ms=cuda_ms(lambda: k1.occluded_pallas(
                o, d, tm, *args[2:], num_real=num_real), reps),
            plain_ms=cuda_ms(lambda: k1.intersect_pallas_plain(
                *args, t_max=tm, num_real=num_real),
                max(1, reps // 4) if cam else 1),
            rays=n, triangles=num_real,
        )
        log(f"  K1 {label} N={n} x {num_real}: kernel {r['ms']:.3f} ms "
            f"(any-hit {r['anyhit_ms']:.3f}), plain {r['plain_ms']:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if cam:
            rec = r
        else:
            rec.update({f"{k}_soup4096": v for k, v in r.items()})
    return rec


def coherent_order(dev_scene, batch):
    """The batch in matrix_query's coherence order (octant and origin
    Morton cell, dead rays last), and the inverse permutation."""
    from hala_tpu_torch.ops import traverse as k2
    from hala_tpu_torch.ops.compaction import order_by

    g = dev_scene.geometry
    o, d, tm = batch
    order, inverse = order_by(k2._coherence_key(o, d, tm, g.cluster_min, g.cluster_max))
    return tuple(x[order].contiguous() for x in batch), inverse


def span_work(g, o, d, r, c, t_end):
    """Moller-Trumbore pairs of the (ray r, cluster c) pairs given: the
    real triangles of the 16-slot spans whose padded row-9 sub-box the
    ray enters at or before t_end (the pretest, as the kernels and
    `matrix_walk_runs_plain` run it). Returns that count."""
    import torch

    from hala_tpu_torch.ops import traverse as k2

    spans = k2.PRETEST_PER_CHUNK
    real = (g.tri_mat >= 0).view(-1, spans, k2.PRETEST_TRIS).sum(dim=2)
    count = 0
    for p0 in range(0, r.numel(), 1 << 20):
        rr, cc = r[p0:p0 + (1 << 20)], c[p0:p0 + (1 << 20)]
        boxes = g.tri_packed[cc, 9, :6 * spans].view(-1, spans, 6)
        tn, enters = k2.slab_entry(o[rr, None, :], d[rr, None, :], boxes[..., :3],
                                   boxes[..., 3:])
        passed = enters & (tn <= t_end[rr, None])
        count += int((passed.long() * real[cc]).sum())
    return count


def k2_work(g, o, d, tm, hit):
    """The work K2's function needs on these rays, as its plain model
    `matrix_walk_runs_plain` does it with each ray's closest hit known:
    for every live ray (t_max > 1e-4) one slab test of each group of 16
    consecutive cluster boxes (their union), the member tests of the
    groups where it enters some member's box at or before its hit (fewer
    than the groups whose union it enters), the eight sub-box tests of
    each cluster it enters so, and Moller-Trumbore on the real
    triangles of the 16-slot spans it enters so (`span_work`). Also the
    clusters some ray of a block of 128 consecutive rays enters before
    its hit, summed over blocks: the fewest visits a block walk can
    make. Returns (bound ms, by, a dict of the counts)."""
    import torch

    from hala_tpu_torch.ops import traverse as k2

    n, c = o.shape[0], g.cluster_min.shape[0]
    group = 16
    sizes = torch.full((-(-c // group),), group, device=o.device)
    sizes[-1] = c - group * (sizes.numel() - 1)
    t_end = torch.where(hit.tri >= 0, hit.t, tm)
    live = tm > 1e-4
    w = dict(live_rays=int(live.sum()), groups=sizes.numel(), member_tests=0,
             pairs=0, mt_pairs=0, least=0)
    rows, cols = 1 << 17, 256  # cols: whole groups
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        for c0 in range(0, c, cols):
            tn, enters = k2.slab_entry(o[sl, None, :], d[sl, None, :],
                                       g.cluster_min[None, c0:c0 + cols],
                                       g.cluster_max[None, c0:c0 + cols])
            m = enters & (tn <= t_end[sl, None]) & live[sl, None]
            m_g = torch.nn.functional.pad(m, (0, -m.shape[1] % group))
            m_g = m_g.view(m.shape[0], -1, group).any(dim=2)
            g0 = c0 // group
            w["member_tests"] += int((m_g.long() * sizes[None, g0:g0 + m_g.shape[1]]).sum())
            m_b = torch.nn.functional.pad(m, (0, 0, 0, -m.shape[0] % k2.MATRIX_BLOCK_RAYS))
            w["least"] += int(m_b.view(-1, k2.MATRIX_BLOCK_RAYS, m.shape[1]).any(dim=1).sum())
            rr, cc = torch.nonzero(m, as_tuple=True)
            w["pairs"] += rr.numel()
            w["mt_pairs"] += span_work(g, o, d, rr + r0, cc + c0, t_end)
    ops = ((w["live_rays"] * w["groups"] + w["member_tests"]
            + w["pairs"] * k2.PRETEST_PER_CHUNK) * OPS_SLAB + w["mt_pairs"] * OPS_MT)
    b_ms, b_by = bound(ops, n * 44 + c * 24 + g.tri_packed.numel() * 4)
    return b_ms, b_by, w


def k4_work(o, d, tm, cmin, cmax, k):
    """The work K4's function needs on these rays, per launch of
    `cull_candidates` (a superchunk of CULL_MAX_CLUSTERS clusters), per
    live ray (t_max > 0): the reference's slab test of each 16-box
    group's union box (`cull.group_unions`), of the members of every
    group whose union the ray itself enters, and of the far members
    (tested alone) of the groups it does not enter. Bytes per launch:
    rays, boxes, unions and the lists once. Returns (bound ms, by, a
    dict of the counts)."""
    import torch

    from hala_tpu_torch.ops import cull

    n, c = o.shape[0], cmin.shape[0]
    live = tm > 0.0
    w = dict(live_rays=int(live.sum()), launches=0, groups=0, union_tests=0,
             member_tests=0)
    nbytes = 0
    for lo in range(0, c, cull.CULL_MAX_CLUSTERS):
        bmin = cmin[lo:lo + cull.CULL_MAX_CLUSTERS]
        bmax = cmax[lo:lo + cull.CULL_MAX_CLUSTERS]
        cs = bmin.shape[0]
        u = cull.group_unions(bmin, bmax)
        groups = u.shape[0]
        sizes = torch.full((groups,), cull.CULL_GROUP, device=o.device)
        sizes[-1] = cs - cull.CULL_GROUP * (groups - 1)
        bits = u[:, 3].view(torch.int32)
        far = sum(((bits >> q) & 1) for q in range(cull.CULL_GROUP))
        for r0 in range(0, n, 1 << 16):
            sl = slice(r0, r0 + (1 << 16))
            enters = cull.slab_keys(o[sl], d[sl], tm[sl], u[:, 0:3], u[:, 4:7])[1]
            w["member_tests"] += int((enters.long() * sizes).sum()) + int(
                ((~enters & live[sl, None]).long() * far).sum())
        w["launches"] += 1
        w["groups"] += groups
        w["union_tests"] += w["live_rays"] * groups
        nbytes += n * 28 + cs * 24 + groups * 32 + n * k * 4 + n * 4
    b_ms, b_by = bound((w["union_tests"] + w["member_tests"]) * OPS_CULL, nbytes)
    return b_ms, b_by, w


def k5_work(g, o, d, tm, ids, k, hit, runs):
    """The work K5's function needs on these rays, the walk of each
    ray's list as the kernel runs it (`runs` clusters): per visit the
    eight sub-box tests, and Moller-Trumbore on the real triangles of
    the spans the ray enters at or before its hit (`span_work`); the
    admissibility rule's cluster-box test is needed only for the few
    pairs Moller-Trumbore accepts at or below the best t, and is not
    counted. Bytes: rays, lists and hits once, the slot blocks once.
    Returns (bound ms, by, visits, Moller-Trumbore pairs)."""
    import torch

    n = o.shape[0]
    walked = torch.arange(k, device=o.device)[None, :] < runs[:, None]
    r, j = torch.nonzero(walked, as_tuple=True)
    t_end = torch.where(hit.tri >= 0, hit.t, tm)
    visits = r.numel()
    mt_pairs = span_work(g, o, d, r, ids[r, j].long(), t_end)
    b_ms, b_by = bound(visits * 8 * OPS_SLAB + mt_pairs * OPS_MT,
                       n * 28 + n * k * 8 + n + g.tri_packed.numel() * 4 + n * 24)
    return b_ms, b_by, visits, mt_pairs


def check_k2(dev_scene, small, big, reps: int):
    """K2 (csrc/matrix_traverse.cu) vs its plain version, bit for bit,
    closest (t, tri, u, v) and any hit (the hit mask), on `small`
    unsorted and in matrix_query's coherence order, and vs K1 (closest
    and the any-hit mask); its schedule (hits and clusters visited per
    block) vs the plain model `matrix_walk_runs_plain` on the sorted
    `small`; then on `big` in coherence order against its plain version
    (in slices of 65,536 rays) and unsorted against that, timed on all
    four batches."""
    import torch

    from hala_tpu_torch.ops import traverse as k2
    from hala_tpu_torch.ops.pallas import intersect_kernel as k1

    g = dev_scene.geometry
    hit_labels = ("t", "tri", "u", "v")
    args = (g.cluster_min, g.cluster_max, g.tri_packed)
    small_s, _ = coherent_order(dev_scene, small)
    kernel_hits, plain_hits, masks = [], [], []
    for label, (o, d, tm) in (("small", small), ("small sorted", small_s)):
        n = o.shape[0]
        hk = k2.intersect_matrix(o, d, g, t_max=tm)
        hp = k2.intersect_matrix_plain(o, d, g, t_max=tm)
        kernel_hits.append(hk)
        plain_hits.append(hp)
        ok = k2.occluded_matrix(o, d, tm, g)
        masks.append(ok)
        torch.cuda.synchronize()
        equal_tensors(f"K2 vs plain, {label} (N={n})", hk, hp, hit_labels)
        if not torch.equal(ok, hp.tri >= 0):
            raise AssertionError(f"K2 any-hit disagrees with plain, {label} "
                                 f"({int((ok != (hp.tri >= 0)).sum())} rays)")
        log(f"  K2 {label} N={n}: closest equal to plain bit for bit, any-hit "
            f"mask equal ({int(ok.sum())} blocked)")
    o, d, tm = small
    hb = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    torch.cuda.synchronize()
    err = compare_hits(f"K2 vs K1 closest (N={o.shape[0]})", kernel_hits[0], hb,
                       o, d, g)
    if not torch.equal(masks[0], hb.tri >= 0):
        raise AssertionError(f"K2 any-hit disagrees with K1's hit mask "
                             f"({int((masks[0] != (hb.tri >= 0)).sum())} rays)")
    log(f"  K2 vs K1 any-hit (N={o.shape[0]}): the mask equals K1's hit mask")
    b_small, by_small, w_small = k2_work(g, *small_s, plain_hits[1])
    rec = dict(small_work=w_small)
    o, d, tm = small_s
    for any_hit in (False, True):
        hit, runs = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=any_hit)
        ref, ref_runs = k2.matrix_walk_runs_plain(o, d, tm, *args, any_hit)
        torch.cuda.synchronize()
        equal_tensors(f"K2 schedule any_hit={any_hit}", (*hit, runs),
                      (*ref, ref_runs), hit_labels + ("runs",))
        if not any_hit:
            rec["runs"] = dict(mean=float(runs.float().mean()), max=int(runs.max()),
                               least=w_small["least"] / runs.numel())
    log(f"  K2 schedule sorted N={o.shape[0]}: hits and runs equal the plain "
        f"model, closest and any hit; {rec['runs']['mean']:.1f} clusters visited "
        f"per {k2.MATRIX_BLOCK_RAYS}-ray block (max {rec['runs']['max']} of "
        f"{g.cluster_min.shape[0]}) against at least {rec['runs']['least']:.1f} "
        "entered before some lane's hit")

    big_s, inverse = coherent_order(dev_scene, big)
    o, d, tm = big_s
    n = o.shape[0]
    hk = k2.intersect_matrix(o, d, g, t_max=tm)
    ok = k2.occluded_matrix(o, d, tm, g)
    parts = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r0 in range(0, n, 1 << 16):
        sl = slice(r0, r0 + (1 << 16))
        parts.append(k2.intersect_matrix_plain(o[sl], d[sl], g, t_max=tm[sl]))
    end.record()
    torch.cuda.synchronize()
    hp = type(hk)(*(torch.cat(x) for x in zip(*parts)))
    equal_tensors(f"K2 vs plain, big sorted (N={n})", hk, hp, hit_labels)
    if not torch.equal(ok, hp.tri >= 0):
        raise AssertionError("K2 any-hit disagrees with plain, big sorted")
    hu = k2.intersect_matrix(big[0], big[1], g, t_max=big[2])
    torch.cuda.synchronize()
    equal_tensors(f"K2 big unsorted vs sorted (N={n})", hu,
                  tuple(x[inverse] for x in hk), hit_labels)
    b_ms, b_by, w_big = k2_work(g, o, d, tm, hp)
    times = {}
    for label, (o_, d_, tm_) in (("small", small), ("small_sorted", small_s),
                                 ("big", big), ("big_sorted", big_s)):
        r = reps if label.startswith("small") else max(1, reps // 2)
        for any_hit in (False, True):
            times[f"{label}{'_anyhit' if any_hit else ''}"] = cuda_ms(
                lambda: k2._launch_matrix(o_, d_, tm_, *args, any_hit), r)
    # The walk's floor: every ray live, but its range (1e-4, 2e-4)
    # enters almost no box, so only the union tests of the keys pass,
    # the compaction and the sort are left.
    short = torch.full_like(tm, 2.0e-4)
    times["big_sorted_nothing_entered"] = cuda_ms(
        lambda: k2._launch_matrix(o, d, short, *args, False), max(1, reps // 2))
    w_big["least"] /= n // k2.MATRIX_BLOCK_RAYS
    rec.update(
        bound_ms=b_ms, bound_by=b_by, small_bound_ms=b_small, big_work=w_big,
        max_abs_err=max(err, max_abs_diff((hk.t, hk.u, hk.v), (hp.t, hp.u, hp.v))),
        ms=times["big_sorted"], ms_unsorted=times["big"],
        anyhit_ms=times["big_sorted_anyhit"],
        plain_ms=start.elapsed_time(end), times=times, rays=n,
        k1_ms=cuda_ms(lambda: k1.intersect_pallas(
            small[0], small[1], g.tri_v0, g.tri_e1, g.tri_e2, t_max=small[2]), reps),
    )
    log(f"  K2 big sorted N={n}: closest equal to plain bit for bit (plain "
        f"{rec['plain_ms']:.0f} ms in slices), any-hit mask equal; unsorted "
        f"equal to sorted; work before the closest hit {w_big}; bound "
        f"{b_ms:.4f} ms ({b_by}), small {b_small:.4f} ms ({by_small})")
    log("  K2 ms [closest / any-hit] by batch: " + "; ".join(
        f"{label} {times[label]:.3f} / {times[label + '_anyhit']:.3f}"
        for label in ("small", "small_sorted", "big", "big_sorted"))
        + f"; big sorted with t_max 2e-4 (nothing entered) "
        f"{times['big_sorted_nothing_entered']:.3f}"
        + f"; K1 on all {g.tri_v0.shape[0]} slots (small) {rec['k1_ms']:.3f}")
    return rec


def equal_tensors(name: str, got, ref, labels) -> None:
    """Raise unless every pair of tensors is equal bit for bit."""
    import torch

    for label, x, y in zip(labels, got, ref):
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: {label} differs in "
                                 f"{int((x != y).sum())} of {x.numel()}")


def max_abs_diff(got, ref) -> float:
    """Largest |x - y| over the pairs of tensors, in float64 for floats
    and int64 for integers; equal values (infinities included) count 0."""
    import torch

    err = 0.0
    for x, y in zip(got, ref):
        x, y = (x.double(), y.double()) if x.dtype.is_floating_point else (
            x.long(), y.long())
        diff = torch.where(x == y, torch.zeros_like(x), (x - y).abs())
        if diff.numel():
            err = max(err, float(diff.max()))
    return err


def cull_misses(a, b, o, d, tm, g):
    """Rays where hit `a` (a cull-based engine) misses the triangle of
    hit `b` (an exact engine) because the reference's unpadded slab
    test (K4's) does not enter the cluster holding b's triangle: the
    JAX package's cull would miss it too. (N,) bool."""
    import torch

    from hala_tpu_torch.ops import cull

    out = torch.zeros_like(a.tri, dtype=torch.bool)
    rows = torch.nonzero((a.tri != b.tri) & (b.tri >= 0)).squeeze(1)
    for r0 in range(0, rows.numel(), 1024):
        r = rows[r0:r0 + 1024]
        c = (b.tri[r] // 128).long()
        _, hit = cull.slab_keys(o[r], d[r], tm[r], g.cluster_min[c],
                                g.cluster_max[c])
        out[r] = ~torch.diagonal(hit)
    return out


def compare_with_exact(name: str, a, b, o, d, tm, g):
    """compare_hits(a, b) where a comes from the cull-based traversal:
    rays whose b-winner lies in a cluster the reference cull misses are
    counted (kept for parity, ROADMAP Queue 3) and left out. Returns
    (max abs error, number of such rays)."""
    import torch

    from hala_tpu_torch.ops.intersect import Hit

    graze = cull_misses(a, b, o, d, tm, g)
    n = int(graze.sum())
    if n:
        log(f"  {name}: {n} rays miss the exact hit's cluster in the "
            "reference cull (unpadded slab test), left out")
        a = Hit(*(torch.where(graze, y, x) for x, y in zip(a, b)))
    return compare_hits(name, a, b, o, d, g), n


def check_k4(dev_scene, small, big, reps: int):
    """K4 (csrc/cull_topk.cu) vs its plain version, bit for bit, at
    K 4, 12 and 16 on the mixed batch `small` unsorted and in
    matrix_query's coherence order (the order the traverse engine's
    queries come in), the superchunk merge, and at the main path's K on
    the 2^21-ray batch `big`, both orders (timed on all four batches,
    with the selection alone over the materialised key matrix as the
    library yardstick). The bound is `k4_work`'s, the former one (every
    ray x box) beside it."""
    import torch

    from hala_tpu_torch.ops import cull
    from hala_tpu_torch.ops import traverse as k5

    g = dev_scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    small_s, _ = coherent_order(dev_scene, small)
    for label, (o, d, tm) in (("unsorted", small), ("sorted", small_s)):
        for k in (4, TRAVERSE_K, 16):
            got = cull.cull_topk(o, d, tm, cmin, cmax, k=k)
            ref = cull.cull_topk_plain(o, d, tm, cmin, cmax, k=k)
            torch.cuda.synchronize()
            equal_tensors(f"K4 K={k} {label}", got, ref, ("pk", "cnt"))
            log(f"  K4 K={k} N={o.shape[0]} {label}: pk, cnt equal bit for bit; "
                f"{float((got[1] > k).float().mean()):.3f} of rays truncated, "
                f"mean count {float(got[1].float().mean()):.2f}")
    o, d, tm = small
    one = k5.cull_candidates(o, d, tm, cmin, cmax, TRAVERSE_K)
    merged = k5.cull_candidates(o, d, tm, cmin, cmax, TRAVERSE_K, superchunk=256)
    torch.cuda.synchronize()
    equal_tensors("cull_candidates superchunk 256 vs one call", merged, one,
                  ("ids", "tns", "ovf"))
    log(f"  cull_candidates: {-(-cmin.shape[0] // 256)} superchunks of 256 "
        "merge to the single call's lists bit for bit")

    big_s, _ = coherent_order(dev_scene, big)
    n, c, k = big[0].shape[0], cmin.shape[0], TRAVERSE_K
    err = 0.0
    for label, (o, d, tm) in (("unsorted", big), ("sorted", big_s)):
        got = cull.cull_topk(o, d, tm, cmin, cmax, k=k)
        ref = cull.cull_topk_plain(o, d, tm, cmin, cmax, k=k)
        torch.cuda.synchronize()
        equal_tensors(f"K4 K={k} N={n} {label}", got, ref, ("pk", "cnt"))
        err = max(err, max_abs_diff(got, ref))
    # each ray's work does not depend on the order: one bound for both
    b_ms, b_by, work = k4_work(*big, cmin, cmax, k)
    old_ms, _ = bound(n * c * OPS_CULL, n * 28 + c * 24 + n * k * 4 + n * 4)
    unions = cull.group_unions(cmin, cmax)
    times = {}
    for label, (o_, d_, tm_) in (("small", small), ("small_sorted", small_s),
                                 ("big", big), ("big_sorted", big_s)):
        times[label] = cuda_ms(lambda: cull.cull_topk(
            o_, d_, tm_, cmin, cmax, k=k, unions=unions), reps)
    o, d, tm = big
    rec = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, old_bound_ms=old_ms,
        work=work, rays=n, times=times, ms=times["big_sorted"],
        ms_unsorted=times["big"],
        plain_ms=cuda_ms(lambda: cull.cull_topk_plain(o, d, tm, cmin, cmax, k=k), 1),
        truncated=float((got[1] > k).float().mean()),
    )
    keys = torch.empty((n, c), dtype=torch.int32, device=o.device)
    for r0 in range(0, n, 4096):
        sl = slice(r0, r0 + 4096)
        keys[sl] = cull.slab_keys(o[sl], d[sl], tm[sl], cmin, cmax)[0]
    sel = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    torch.cuda.synchronize()
    if not torch.equal(sel, cull.cull_topk(o, d, tm, cmin, cmax, k=k)[0]):
        raise AssertionError("K4: torch.topk over the key matrix disagrees")
    rec["library_ms"] = cuda_ms(
        lambda: torch.topk(keys, k, dim=1, largest=False, sorted=True), reps)
    del keys, sel
    log(f"  K4 K={k} N={n} x {c} clusters: pk, cnt equal bit for bit, both "
        f"orders; kernel {rec['ms']:.3f} ms sorted, {rec['ms_unsorted']:.3f} "
        f"unsorted, plain {rec['plain_ms']:.1f} ms, torch.topk over the "
        f"materialised keys (selection only) {rec['library_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {work}; every ray x box: {old_ms:.4f}); "
        f"{rec['truncated']:.3f} truncated; ms by batch: "
        + ", ".join(f"{key} {v:.3f}" for key, v in times.items()))
    return rec


def check_k5_k6(dev_scene, small, big, reps: int):
    """K5 (csrc/traverse_candidates.cu) and K6 (csrc/cluster_stream.cu)
    vs their plain versions, bit for bit: K5 at K 12 and 4 on `small`
    and at the main path's K on `big`, each unsorted and in
    matrix_query's coherence order; K6 on the fallback's inputs, on the
    full range and with every ray resolved; the traverse engine and K6
    against K2 on `small`; then both kernels at the main path's K on
    `big` as `intersect_traversed` feeds them (K6 with t_max = -inf for
    the rays K5 resolved), timed on both orders."""
    import torch

    from hala_tpu_torch.ops import cluster as k6
    from hala_tpu_torch.ops import traverse as k5

    g = dev_scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    hit_labels = ("t", "tri", "u", "v")
    k5_labels = hit_labels + ("unres", "runs")

    def run(o, d, tm, k, label, fallback=True):
        ids, tns, ovf = k5.cull_candidates(o, d, tm, cmin, cmax, k)
        got = k5.traverse_candidates(o, d, tm, ids, tns, ovf, cmin, cmax, g.tri_packed)
        ref = k5.traverse_candidates_plain(o, d, tm, ids, tns, ovf, cmin, cmax,
                                           g.tri_packed)
        torch.cuda.synchronize()
        equal_tensors(f"K5 K={k} {label}", (*got[0], got[1], got[2]),
                      (*ref[0], ref[1], ref[2]), k5_labels)
        live = max(int((tm > 0).sum()), 1)
        log(f"  K5 K={k} {label}: equal bit for bit; unresolved {int(got[1].sum()) / live:.4f} of live rays, "
            f"{float(got[2].sum()) / live:.2f} clusters visited per live ray")
        if not fallback:
            return ids, tns, ovf, got, ref
        fb_tm = k5.fallback_t_max(got[0], got[1])
        fk = k6.intersect_clustered(o, d, g, t_max=fb_tm)
        fp = k6.intersect_clustered_plain(o, d, g, t_max=fb_tm)
        torch.cuda.synchronize()
        equal_tensors(f"K6 fallback K={k} {label}", fk, fp, hit_labels)
        return ids, tns, ovf, got, ref, fb_tm, fk, fp

    small_s, _ = coherent_order(dev_scene, small)
    o, d, tm = small
    hm = k5.intersect_matrix(o, d, g, t_max=tm)
    for k in (TRAVERSE_K, 4):
        run(o, d, tm, k, f"N={o.shape[0]}")
        run(*small_s, k, f"N={o.shape[0]} sorted", fallback=False)
        ht = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=k)
        torch.cuda.synchronize()
        _, graze = compare_with_exact(f"intersect_traversed K={k} vs K2",
                                      ht, hm, o, d, tm, g)
    hk = k6.intersect_clustered(o, d, g, t_max=tm)
    hp = k6.intersect_clustered_plain(o, d, g, t_max=tm)
    torch.cuda.synchronize()
    equal_tensors("K6 full range", hk, hp, hit_labels)
    compare_hits(f"K6 vs K2 (N={o.shape[0]})", hk, hm, o, d, g)
    resolved = torch.full_like(tm, -torch.inf)  # an empty queue
    equal_tensors("K6 all rays resolved",
                  k6.intersect_clustered(o, d, g, t_max=resolved),
                  k6.intersect_clustered_plain(o, d, g, t_max=resolved), hit_labels)
    log(f"  K6 full range N={o.shape[0]}: equal to its plain version bit for "
        "bit; with every ray resolved (t_max -inf, an empty queue) too")

    o, d, tm = big
    n, k = o.shape[0], TRAVERSE_K
    ids, tns, ovf, got, ref, fb_tm, fk, fp = run(o, d, tm, k, f"N={n}")
    big_s, _ = coherent_order(dev_scene, big)
    lists_s = k5.cull_candidates(*big_s, cmin, cmax, k)
    sorted_run = run(*big_s, k, f"N={n} sorted")
    # each ray's walk does not depend on the order: one bound for both
    k5_ms, k5_by, visits, k5_pairs = k5_work(g, o, d, tm, ids, k, got[0], got[2])
    times = {}
    for label, (o_, d_, tm_), lists in (("small", small, None),
                                        ("small_sorted", small_s, None),
                                        ("big", big, (ids, tns, ovf)),
                                        ("big_sorted", big_s, lists_s)):
        lists = lists or k5.cull_candidates(o_, d_, tm_, cmin, cmax, k)
        times[label] = cuda_ms(lambda: k5.traverse_candidates(
            o_, d_, tm_, *lists, cmin, cmax, g.tri_packed), reps)
    k5_rec = dict(
        # over t, u, v of the pairs compared above; tri mismatches beside it
        max_abs_err=max(max_abs_diff((got[0].t, got[0].u, got[0].v),
                                     (ref[0].t, ref[0].u, ref[0].v)),
                        max_abs_diff(*((h.t, h.u, h.v) for h in (sorted_run[3][0],
                                                                   sorted_run[4][0])))),
        tri_mismatches=int((got[0].tri != ref[0].tri).sum()),
        bound_ms=k5_ms, bound_by=k5_by, library_ms=None,
        rays=n, visited=visits, mt_pairs=k5_pairs,
        unresolved=int(got[1].sum()), times=times,
        ms=times["big_sorted"], ms_unsorted=times["big"],
        plain_ms=cuda_ms(lambda: k5.traverse_candidates_plain(
            *big_s, *lists_s, cmin, cmax, g.tri_packed), 1),
    )
    # K6 on the fallback's inputs, in the main path's (sorted) order
    k6_rec = k6_record(g, big_s[0], big_s[1], *sorted_run[5:8], reps)
    k6_rec["ms_unsorted"] = cuda_ms(
        lambda: k6.intersect_clustered(o, d, g, t_max=fb_tm), reps)
    k6_rec["max_abs_err"] = max(k6_rec["max_abs_err"], max_abs_diff(
        (fk.t, fk.u, fk.v), (fp.t, fp.u, fp.v)))
    k6_rec["full_ms"] = cuda_ms(lambda: k6.intersect_clustered(o, d, g, t_max=tm), 2)
    log(f"  K5 K={k} N={n}: kernel {k5_rec['ms']:.3f} ms sorted, "
        f"{k5_rec['ms_unsorted']:.3f} unsorted, plain {k5_rec['plain_ms']:.1f} ms, "
        f"bound {k5_ms:.4f} ms ({k5_by}; {visits} cluster visits, "
        f"{k5_pairs} (ray, real triangle) pairs in the spans entered before the "
        f"hit); ms by batch: "
        + ", ".join(f"{key} {v:.3f}" for key, v in times.items()))
    log(f"  K6 on all {n} rays unsorted, on the fallback's inputs "
        f"{k6_rec['ms_unsorted']:.3f} ms; on the full range (the cluster engine) "
        f"{k6_rec['full_ms']:.3f} ms")
    return k5_rec, k6_rec, graze


def k6_record(g, o, d, fb_tm, fk, fp, reps: int):
    """K6 on the fallback's inputs (t_max `fb_tm`, K6's hits `fk`, its
    plain version's `fp`, held equal before): timed, with the bound of
    the function K2 and K6 share (`k2_work` over the live rays, t_max
    fb_tm, and the former bound, every box for every live ray, beside
    it)."""
    import torch

    from hala_tpu_torch.ops import cluster as k6

    c = g.cluster_min.shape[0]
    act = torch.nonzero(fb_tm > 1e-4).squeeze(1)
    b_ms, b_by, work = k2_work(g, o[act], d[act], fb_tm[act],
                               type(fk)(*(x[act] for x in fk)))
    # the former count: every box, and the real triangles of every
    # cluster entered before the hit, for each live ray
    real = (g.tri_mat >= 0).view(c, -1).sum(dim=1)
    t_end = torch.where(fk.tri >= 0, fk.t, fb_tm)[act]
    live_tris = 0
    for c0 in range(0, c, 64):
        hit = k6.slab_live(o[act], d[act], g.cluster_min[c0:c0 + 64],
                           g.cluster_max[c0:c0 + 64], t_end)
        live_tris += int((hit.long() * real[None, c0:c0 + 64]).sum())
    old_ms, _ = bound(act.numel() * c * OPS_SLAB + live_tris * OPS_MT, 0)
    n = o.shape[0]
    rec = dict(
        max_abs_err=max_abs_diff((fk.t, fk.u, fk.v), (fp.t, fp.u, fp.v)),
        tri_mismatches=int((fk.tri != fp.tri).sum()), bound_ms=b_ms,
        bound_by=b_by, old_bound_ms=old_ms, work=work, library_ms=None, rays=n,
        active=act.numel(),
        ms=cuda_ms(lambda: k6.intersect_clustered(o, d, g, t_max=fb_tm), reps),
        plain_ms=cuda_ms(lambda: k6.intersect_clustered_plain(o, d, g, t_max=fb_tm), 1),
    )
    log(f"  K6 fallback N={n} x {c} clusters ({act.numel()} unresolved), sorted: "
        f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; k2_work over the unresolved rays {work}; every "
        f"box for every unresolved ray: {old_ms:.4f})")
    return rec


def grazes(hit):
    """Rays whose canonical hit lies within 1e-4 (barycentric) of an
    edge of its triangle: the factored Moller-Trumbore of K7 and K8 and
    the classic one of K1 and K2 round differently, so such a hit may
    be accepted by one and rejected by the other."""
    import torch

    w0 = 1.0 - hit.u - hit.v
    return (hit.tri >= 0) & (torch.minimum(torch.minimum(hit.u, hit.v), w0) < 1e-4)


GRAZE_EXCUSED_MAX = 64  # per query of at most 2^21 rays


def canonical_equal(name: str, a, b) -> int:
    """Raise unless two canonical hits agree by the statement of
    tests/test_wavefront.py: the hit mask equal; where the triangle
    differs |dt| < 1e-4 (a near-tie); where it agrees t at rtol 1e-6
    and u, v at atol 1e-6. A ray either side hits at a graze (`grazes`)
    is excused from the first two, and at most GRAZE_EXCUSED_MAX rays
    may be excused so. Returns the number of winner flips and grazes."""
    import torch

    graze = grazes(a) | grazes(b)
    mask_diff = (a.tri >= 0) != (b.tri >= 0)
    if bool((mask_diff & ~graze).any()):
        raise AssertionError(f"{name}: hit masks differ in "
                             f"{int((mask_diff & ~graze).sum())} rays away from any edge")
    same = a.tri == b.tri
    far = ~same & ~((a.t - b.t).abs() < 1e-4)
    if bool((far & ~graze).any()):
        raise AssertionError(f"{name}: {int((far & ~graze).sum())} winner flips "
                             "beyond a near-tie")
    excused = int(((mask_diff | far) & graze).sum())
    if excused > GRAZE_EXCUSED_MAX:
        raise AssertionError(f"{name}: {excused} grazing rays differ in the hit mask "
                             f"or beyond a near-tie, more than {GRAZE_EXCUSED_MAX}")
    m = same & (b.tri >= 0)
    if not torch.allclose(a.t[m], b.t[m], rtol=1e-6, atol=0.0):
        raise AssertionError(f"{name}: t differs beyond rtol 1e-6")
    for x, y in ((a.u, b.u), (a.v, b.v)):
        if not torch.allclose(x[m], y[m], rtol=0.0, atol=1e-6):
            raise AssertionError(f"{name}: u, v differ beyond atol 1e-6")
    flips = int((~same).sum())
    log(f"  {name}: {flips} rays differ in the winner ({excused} excused as grazes "
        f"of at most {GRAZE_EXCUSED_MAX}, the others near-ties), t/u/v agree on the rest")
    return flips


def anyhit_equal(name: str, occ, ref, a, b) -> None:
    """Raise unless the any-hit masks agree, except on at most
    GRAZE_EXCUSED_MAX rays whose closest hit by either engine (a, b
    canonical) is a graze."""
    diff = occ != ref
    bad = diff & ~(grazes(a) | grazes(b))
    if bool(bad.any()):
        raise AssertionError(f"{name}: any-hit differs in {int(bad.sum())} rays "
                             "away from any edge")
    excused = int(diff.sum())
    if excused > GRAZE_EXCUSED_MAX:
        raise AssertionError(f"{name}: any-hit differs on {excused} grazing rays, "
                             f"more than {GRAZE_EXCUSED_MAX}")
    log(f"  {name}: any-hit differs on {excused} grazing rays "
        f"(at most {GRAZE_EXCUSED_MAX} excused)")


class TestedPairs:
    """Counts what the walks' plain versions test: for every (group,
    entry) they hand to `mm_chunk_test_plain`, with its span limits
    (`mm_span_mask`: a span is let in where its limit is finite; live
    rays only, t_max > 1e-4, as the kernels' lanes do no work
    otherwise):
      - pairs: live rays x the cluster's real triangles, every pair the
        walks tested before the span mask (the old bound's count);
      - span_pairs: live ray x real triangle in the spans the ray's mask
        lets in, the work the function needs (the bound's count, with
        slab_tests: 8 span boxes per live ray and tested entry; the
        cluster box of the admissibility rule is needed only on the
        pairs that pass, and is not counted), and of
        them passed_pairs, those that pass the division-free test
        (`mm_barycentric_pass`), which alone need t and the range test;
      - ray_spans: (ray, span) pairs let in; warp_spans: (warp, span)
        pairs some lane of the warp lets in, which the kernels run, 32
        lanes x 16 slots each; all_warp_spans: every (warp, span) pair
        of the tested entries.
    The kernels walk and test the same entries with the same masks
    (their outputs are held equal), so these are their counts too."""

    def __init__(self, module, real_spans):
        self.module, self.real = module, real_spans
        self.pairs = self.span_pairs = self.passed_pairs = self.slab_tests = 0
        self.ray_spans = self.warp_spans = self.all_warp_spans = 0

    def __enter__(self):
        self.inner = self.module.mm_chunk_test_plain
        module = self.module

        def counted(coef, cc, cid, o, d, tm, any_hit, limit):
            span = limit < float("inf")  # the spans the rays' limits let in
            real = self.real[cid]  # (R, 8)
            live = tm > 1e-4
            self.pairs += int((live.sum(dim=1) * real.sum(dim=1)).sum())
            self.span_pairs += int((span.long() * real[:, None, :]).sum())
            det, un, vn, _ = module.mm_terms(coef, cc, o, d)
            passed = module.mm_barycentric_pass(det, un, vn)
            self.passed_pairs += int((passed & span.repeat_interleave(16, dim=2)).sum())
            del det, un, vn, passed
            self.slab_tests += 8 * int(live.sum())
            self.ray_spans += int(span.sum())
            warps = span.view(span.shape[0], -1, 32, span.shape[2]).any(dim=2)
            self.warp_spans += int(warps.sum())
            self.all_warp_spans += warps.numel()
            return self.inner(coef, cc, cid, o, d, tm, any_hit, limit)

        self.module.mm_chunk_test_plain = counted
        return self

    def __exit__(self, *exc):
        self.module.mm_chunk_test_plain = self.inner

    def bounds(self, nbytes):
        """(bound ms, bound by, old bound ms): every span pair at
        OPS_MM_REJECT, the passed pairs OPS_MM_PASS more, and the span
        slab tests at OPS_SLAB; the old bound every live ray x real
        triangle pair of the tested entries at the whole test's
        OPS_MM_REJECT + OPS_MM_PASS."""
        ops = (self.span_pairs * OPS_MM_REJECT + self.passed_pairs * OPS_MM_PASS
               + self.slab_tests * OPS_SLAB)
        b_ms, b_by = bound(ops, nbytes)
        return b_ms, b_by, bound(self.pairs * (OPS_MM_REJECT + OPS_MM_PASS), nbytes)[0]

    def record(self):
        return dict(tested_pairs=self.pairs, span_pairs=self.span_pairs,
                    passed_pairs=self.passed_pairs,
                    slab_tests=self.slab_tests, ray_spans=self.ray_spans,
                    warp_spans=self.warp_spans, all_warp_spans=self.all_warp_spans,
                    warp_span_fill=self.warp_spans / max(self.all_warp_spans, 1),
                    lane_fill=self.ray_spans / max(32 * self.warp_spans, 1))

    def describe(self):
        r = self.record()
        return (f"{r['span_pairs']} live ray x real triangle pairs in the spans the "
                f"rays enter ({r['passed_pairs']} pass the division-free test; "
                f"{r['tested_pairs']} in the tested entries), "
                f"{r['ray_spans']} (ray, span) pairs in {r['warp_spans']} warp "
                f"spans of {r['all_warp_spans']} (per-warp span fill "
                f"{r['warp_span_fill']:.3f}, lane fill {r['lane_fill']:.3f})")


def real_spans(tri_packed):
    """(C, 8) int: the real triangles (a nonzero edge) of each 16-slot
    span."""
    c = tri_packed.shape[0]
    e = tri_packed[:, 3:9]
    return (e != 0).any(dim=1).view(c, 8, 16).sum(dim=2)


def span_breaking_walls(seed: int):
    """A table built to break the span mask of K7 and K8
    (csrc/mm_chunk_test.cuh), as numpy float32 arrays (tri_packed
    (5, 16, 128), cluster_min, cluster_max (5, 3), o, d (1024, 3),
    t_max (1024,)), the rays in the order the walks take them:
      - cluster 0 a wall at x = 2 in 8 strips (one per span, zero-
        thickness span boxes sharing their edges), cluster 1 a floor at
        y = -1.5 filling spans 0, 2, 4, 6, cluster 2 a wall at z = 1.25
        filling spans 1, 3, 5, 7 (the others empty, far v0 as the
        uploader pads), cluster 3 96 small triangles 60 units away,
        cluster 4 one triangle in slot 127, a padding slot in span 0 and
        a real zero-area triangle in span 3;
      - groups 0-3: rays from a unit box of origins at the corners, edge
        midpoints and centres of every span box, every other one moved
        by a relative 1e-6, every fifth with t_max 1.5;
      - group 4: axis-aligned rays along the strips' borders, and rays
        lying in the plane of a wall;
      - groups 5-6: warps in which exactly one lane (a different one in
        each warp) enters a span, the others live but short (t_max 0.3);
      - group 7: rays at span corners, a third dead (t_max 0), a third
        resolved (t_max -inf)."""
    rs = np.random.RandomState(seed)
    blk = np.zeros((5, 16, 128), np.float32)

    def put(c, slot, a, b, e):
        a, b, e = (np.asarray(x, np.float32) for x in (a, b, e))
        blk[c, 0:3, slot] = a
        blk[c, 3:6, slot] = b - a
        blk[c, 6:9, slot] = e - a

    def wall(c, spans, axis, w, u_rng, v_rng):
        ua, va = [a for a in range(3) if a != axis]
        du, dv = (u_rng[1] - u_rng[0]) / 8, (v_rng[1] - v_rng[0]) / 8

        def pt(u, v):
            p = np.zeros(3)
            p[axis], p[ua], p[va] = w, u, v
            return p

        for s in spans:
            for q in range(8):
                u0, v0 = u_rng[0] + s * du, v_rng[0] + q * dv
                p00, p10 = pt(u0, v0), pt(u0 + du, v0)
                p01, p11 = pt(u0, v0 + dv), pt(u0 + du, v0 + dv)
                put(c, 16 * s + 2 * q, p00, p10, p11)
                put(c, 16 * s + 2 * q + 1, p00, p11, p01)

    blk[2, 0:3] = 3.0e37
    wall(0, range(8), 0, 2.0, (-1.0, 1.0), (-1.0, 1.0))
    wall(1, (0, 2, 4, 6), 1, -1.5, (0.0, 4.0), (-1.0, 1.0))
    wall(2, (1, 3, 5, 7), 2, 1.25, (0.0, 4.0), (-1.5, 1.0))
    for slot in range(96):
        a = np.array([60.0, 0.3, -0.2]) + rs.uniform(-1, 1, 3)
        put(3, slot, a, a + rs.normal(size=3) * 1e-2, a + rs.normal(size=3) * 1e-2)
    put(4, 127, (3.0, -0.2, -0.2), (3.0, 0.2, -0.2), (3.0, -0.2, 0.2))
    blk[4, 0:3, 5] = 5.0e3
    put(4, 50, (3.5, 0.0, 0.0), (3.5, 0.1, 0.0), (3.5, 0.1, 0.0))

    v0, e1, e2 = blk[:, 0:3], blk[:, 3:6], blk[:, 6:9]
    real = ((e1 != 0) | (e2 != 0)).any(axis=1)[:, None, :]
    lo = np.where(real, np.minimum(np.minimum(v0, v0 + e1), v0 + e2), np.inf)
    hi = np.where(real, np.maximum(np.maximum(v0, v0 + e1), v0 + e2), -np.inf)
    cmin, cmax = lo.min(axis=2), hi.max(axis=2)
    targets, centres = [], []
    for c in range(5):
        for s in range(8):
            slo, shi = lo[c, :, 16 * s:16 * s + 16].min(1), hi[c, :, 16 * s:16 * s + 16].max(1)
            if not np.isfinite(slo).all():
                continue
            mid = 0.5 * (slo + shi)
            centres.append(mid)
            for corner in range(27):  # corners, edge and face midpoints, centre
                sel = [corner // 9, corner // 3 % 3, corner % 3]
                targets.append(np.array([(slo, mid, shi)[sel[a]][a] for a in range(3)]))
    targets = np.array(targets)[rs.permutation(len(targets))]
    n = 1024
    o = np.array([0.5, 0.0, -0.25]) + rs.uniform(-0.5, 0.5, (n, 3))
    tgt = targets[np.arange(n) % len(targets)].copy()
    tgt[1::2] *= 1.0 + 1e-6 * rs.normal(size=(n // 2, 3))
    tm = np.full(n, 3.0e38)
    tm[0:512:5] = 1.5
    # group 4: along the strips' borders, and in a wall's plane
    g4 = slice(512, 640)
    grid = np.linspace(-1.0, 1.0, 9)
    yz = np.array([(y, z) for y in grid for z in grid])
    o[512:593] = np.column_stack([np.zeros(81), yz])
    tgt[512:593] = o[512:593] + np.array([1.0, 0.0, 0.0])
    xs = np.linspace(0.0, 4.0, 9)
    xz = np.array([(x, z) for x in xs for z in (-1.0, -0.5, 0.0, 0.5, 1.0)])[:40]
    o[593:633] = np.column_stack([xz[:, 0], np.zeros(40), xz[:, 1]])
    tgt[593:633] = o[593:633] + np.array([0.0, -1.0, 0.0])
    o[633:640] = np.column_stack([np.full(7, 2.0), np.linspace(-0.9, 0.9, 7), np.full(7, 0.3)])
    tgt[633:640] = o[633:640] + np.array([0.0, 1.0, 0.0])
    tm[g4] = 3.0e38
    # groups 5-6: one lane a warp enters a span
    o[640:896] = np.array([0.5, 0.0, -0.25]) + rs.uniform(-0.5, 0.5, (256, 3))
    tgt[640:896] = o[640:896] + rs.normal(size=(256, 3))
    tm[640:896] = 0.3
    for w, lane in enumerate((0, 31, 5, 17, 9, 26, 13, 22)):
        i = 640 + 32 * w + lane
        tgt[i] = centres[(3 * w) % len(centres)]
        tm[i] = 3.0e38
    # group 7: dead and resolved rays among live ones
    tm[896::3] = 0.0
    tm[897::3] = -np.inf
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = np.float32
    return (blk, cmin.astype(f32), cmax.astype(f32), o.astype(f32), d.astype(f32),
            tm.astype(f32))


def grazing_table(seed: int):
    """`grazing_beside_span` in `span_breaking_walls`' form: numpy
    (tri_packed, cluster_min, cluster_max, o, d, t_max)."""
    g, o, d, tm = grazing_beside_span(seed)
    return tuple(x.numpy() for x in (g.tri_packed, g.cluster_min, g.cluster_max,
                                     o, d, tm))


def span_table_cases(dev, table=None, caps=(2, 5), name="span table"):
    """The walks' inputs on `span_breaking_walls` (or `table`, in its
    form), for K8 (k_cap in `caps`) and K7 (k in `caps`, m 8; the lists
    merged in the table's ray order, without the signature sort), each
    closest and any-hit: a list of (label, kernel, plain version,
    arguments, output labels)."""
    import torch

    from hala_tpu_torch.ops import cull
    from hala_tpu_torch.ops import traverse as k8
    from hala_tpu_torch.ops import wavefront as k7

    blk, cmin, cmax, o, d, tm = (torch.from_numpy(a).to(dev) for a in (
        span_breaking_walls(41) if table is None else table))
    c = cmin.shape[0]
    g_total = o.shape[0] // k8.GROUP
    cases = []
    for k_cap in caps:
        ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, k_cap)
        args = (o, d, tm, torch.clamp(usz, max=k_cap),
                torch.clamp(ids, max=c - 1).contiguous(), tns.view(torch.int32),
                blk, cmin, cmax)
        for any_hit in (False, True):
            cases.append((f"K8 {name} k_cap={k_cap} any_hit={any_hit}",
                          k8.grouped_walk, k8.grouped_walk_plain, args + (any_hit,),
                          ("t", "tri", "u", "v", "walked")))
    for k in caps:
        pk, _ = cull.cull_topk(o, d, tm, cmin, cmax, k=k)
        tnb, _ = k7._group_lists(pk, g_total, k, 8)
        args = (o, d, tm, tnb, k7.pack_want(k7.want_mask(tnb, pk, k)),
                k7.own_last_key(pk), blk, cmin, cmax)
        for any_hit in (False, True):
            cases.append((f"K7 {name} k={k} m=8 any_hit={any_hit}",
                          k7.wavefront_walk, k7.wavefront_walk_plain, args + (any_hit,),
                          ("t", "tri", "u", "v", "stats")))
    return cases


def check_span_table(dev):
    """K8 and K7 against their plain versions, bit for bit, on
    `span_breaking_walls`, with the table's span counts, and on the
    grazing table (`grazing_table`, seeds 1-5, K 1)."""
    import torch

    from hala_tpu_torch.ops import traverse as k8

    out = {}
    cases = span_table_cases(dev)
    for seed in (1, 2, 3, 4, 5):
        cases += span_table_cases(dev, grazing_table(seed), (1,), f"grazing seed {seed}")
    for label, kernel, plain, args, labels in cases:
        got = kernel(*args)
        with TestedPairs(k8, real_spans(args[6])) as work:
            ref = plain(*args)
        torch.cuda.synchronize()
        equal_tensors(label, got, ref, labels)
        hits = int((got[1] >= 0).sum())
        out[label] = dict(work.record(), hits=hits)
        log(f"  {label}: equal bit for bit, {hits} rays hit; {work.describe()}")
    return out


def grazing_beside_span(seed: int, n: int = 1024):
    """One cluster whose span 0 holds a unit triangle near (1000, 1000,
    0) and span 1 a larger triangle 1 below it, and n rays within ~1e-5
    rad of the first triangle's plane, crossing it 0.5 to 2 widths beside
    its edge e1 (tests/test_torch_mm_span.py `_grazing_case`), all turned
    by one random rotation. The second triangle widens the cluster's box
    over the rays' path, so they enter it but not span 0's padded box.
    Returns (geometry on the CPU, o, d, t_max)."""
    import types

    import torch

    from hala_tpu_torch.ops.cluster import with_pretest_row

    rs = np.random.RandomState(seed)
    v0 = np.array([1000.0, 1000.0, 0.0])
    far = rs.uniform(500, 2000, n)
    h = far * rs.uniform(0.3e-5, 3e-5, n)
    o = np.stack([v0[0] + rs.uniform(0.1, 0.9, n) - far,
                  v0[1] - rs.uniform(0.5, 2.0, n), h], 1)
    d = np.stack([far, np.zeros(n), -h], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    blk = np.zeros((1, 16, 128), np.float32)
    blk[0, 0:3, :] = 3.0e37  # padding slots: far v0, zero edges
    for slot, w0, e1, e2 in ((0, v0, (1.0, 0, 0), (0, 1.0, 0)),
                             (16, v0 + (-1.0, -3.0, -1.0), (4.0, 0, 0), (0, 5.0, 0))):
        blk[0, 0:3, slot], blk[0, 3:6, slot], blk[0, 6:9, slot] = (
            q @ w0, q @ np.array(e1), q @ np.array(e2))
    blk = with_pretest_row(torch.from_numpy(blk))
    rows = blk[0, 0:9, :].T.contiguous()
    real = rows[[0, 16]]
    corners = torch.cat([real[:, 0:3], real[:, 0:3] + real[:, 3:6],
                         real[:, 0:3] + real[:, 6:9]])
    g = types.SimpleNamespace(
        cluster_min=corners.amin(0)[None].contiguous(),
        cluster_max=corners.amax(0)[None].contiguous(), tri_packed=blk,
        tri_v0=rows[:, 0:3].contiguous(), tri_e1=rows[:, 3:6].contiguous(),
        tri_e2=rows[:, 6:9].contiguous())
    f32 = np.float32
    return (g, torch.from_numpy((o @ q.T).astype(f32)),
            torch.from_numpy((d @ q.T).astype(f32)), torch.full((n,), 3.0e38))


def half_box_table():
    """One cluster holding the unit triangle of the x = 0 plane (v0
    (0, 0, 0), e1 (0, 1, 0), e2 (0, 0, 1), slot 3) whose cluster box
    covers only y < 0.5 of it, and 64 rays along +x crossing the plane at
    y in [0.01, 0.98], z 0.02 (none along the box's face): those above
    y 0.5 hit the triangle inside its span box and outside the cluster
    box, so the admissibility rule's cluster clause alone rejects them.
    Returns (geometry on the CPU, o, d, t_max)."""
    import types

    import torch

    from hala_tpu_torch.ops.cluster import with_pretest_row

    blk = torch.zeros((1, 16, 128))
    blk[0, 0:3, :] = 3.0e37
    blk[0, 0:3, 3] = 0.0
    blk[0, 4, 3] = 1.0
    blk[0, 8, 3] = 1.0
    blk = with_pretest_row(blk)
    rows = blk[0, 0:9, :].T.contiguous()
    g = types.SimpleNamespace(
        cluster_min=torch.tensor([[0.0, 0.0, 0.0]]),
        cluster_max=torch.tensor([[0.0, 0.5, 1.0]]), tri_packed=blk,
        tri_v0=rows[:, 0:3].contiguous(), tri_e1=rows[:, 3:6].contiguous(),
        tri_e2=rows[:, 6:9].contiguous())
    ys = np.linspace(0.0, 0.96, 64) + 0.0101
    o = torch.tensor([[-2.0, y, 0.02] for y in ys], dtype=torch.float32)
    d = torch.tensor([[1.0, 0.0, 0.0]] * 64)
    return g, o, d, torch.full((64,), 3.0e38)


def check_k2_grazing(dev, seeds=(1, 2, 3, 4, 5)):
    """The admissibility rule on the card (ops/cluster.py): on
    `grazing_beside_span` K1's classic Moller-Trumbore accepts rays that
    pass beside span 0's triangle, outside its padded box; the cluster
    walks K2, K5 (on K4's lists) and K6 must equal `stream_plain`, their
    plain version, bit for bit (t, tri, u, v), K2 also its schedule
    model `matrix_walk_runs_plain` (runs too) and K1 its plain version,
    or the check fails; the same on `half_box_table`, where the cluster
    box alone rejects pairs. Logs per table the rays K1 and the walks
    hit."""
    import torch

    from hala_tpu_torch.ops import cluster as k6
    from hala_tpu_torch.ops import traverse as k2
    from hala_tpu_torch.ops.pallas import intersect_kernel as k1

    labels = ("t", "tri", "u", "v")
    out = []
    for seed in (*seeds, "half box"):
        g, o, d, tm = half_box_table() if seed == "half box" else grazing_beside_span(seed)
        for key in vars(g):
            setattr(g, key, getattr(g, key).to(dev))
        o, d, tm = o.to(dev), d.to(dev), tm.to(dev)
        args = (o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
        hit, runs = k2.matrix_walk_runs(o, d, g, t_max=tm)
        model, model_runs = k2.matrix_walk_runs_plain(*args, False)
        brute = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
        brute_plain = k1.intersect_pallas_plain(o, d, g.tri_v0, g.tri_e1, g.tri_e2,
                                                t_max=tm)
        stream = k6.stream_plain(*args)
        k6_hit = k6.intersect_clustered(o, d, g, t_max=tm)
        ids, tns, ovf = k2.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, 1)
        k5_hit = k2.traverse_candidates(o, d, tm, ids, tns, ovf, g.cluster_min,
                                        g.cluster_max, g.tri_packed)[0]
        torch.cuda.synchronize()
        equal_tensors(f"K2 vs its schedule model, grazing seed {seed}",
                      (*hit, runs), (*model, model_runs), labels + ("runs",))
        equal_tensors(f"K1 vs plain, grazing seed {seed}", brute, brute_plain, labels)
        for name, got in (("K2", hit), ("K5", k5_hit), ("K6", k6_hit)):
            equal_tensors(f"{name} vs stream_plain, grazing seed {seed}", got, stream,
                          labels)
        rec = dict(seed=seed, rays=o.shape[0], k1=int((brute.tri >= 0).sum()),
                   stream_plain=int((stream.tri >= 0).sum()),
                   k2=int((hit.tri >= 0).sum()), k5=int((k5_hit.tri >= 0).sum()),
                   k6=int((k6_hit.tri >= 0).sum()),
                   k1_only=int(((brute.tri >= 0) & (stream.tri < 0)).sum()))
        out.append(rec)
        table = "half_box_table" if seed == "half box" else f"grazing beside span 0, seed {seed}"
        log(f"  {table}: K2, K5 and K6 equal stream_plain "
            f"bit for bit ({rec['stream_plain']} of {rec['rays']} rays hit), K2 its "
            f"schedule model, K1 its plain version; K1 hits {rec['k1']}, "
            f"{rec['k1_only']} through pairs the admissibility rule rejects")
    return out


def check_k7_k8(dev_scene, small, big, reps: int):
    """K8 (csrc/grouped_walk.cu) and K7 (csrc/wavefront_walk.cu) vs
    their plain versions, bit for bit, closest and any-hit: on
    `span_breaking_walls`; on `small` with tight caps (k_cap 2;
    k_per_ray 3, m_group 8), so that lists truncate and the fallback
    runs, and with the defaults; the two engines there against K2's
    canonical hits and any-hit mask; then on `big` in coherence order,
    as matrix_query feeds them, at the defaults (k_cap 32; k_per_ray 16
    and 8, m_group 32), timed, with `TestedPairs`' span counts and the
    bound recounted from them (the old bound beside it)."""
    import torch

    from hala_tpu_torch.ops import traverse as k8
    from hala_tpu_torch.ops import wavefront as k7
    from hala_tpu_torch.ops.intersect import canonical_hit

    g = dev_scene.geometry
    cmin, cmax, blk = g.cluster_min, g.cluster_max, g.tri_packed
    c = cmin.shape[0]
    spans_real = (g.tri_mat >= 0).view(c, 8, 16).sum(dim=2)
    walk_labels = ("t", "tri", "u", "v", "walked")
    span_table = check_span_table(g.tri_packed.device)

    def coherent(batch):
        o, d, tm = k8.pad_to_groups(*batch)
        order = torch.argsort(k8._coherence_key(o, d, tm, cmin, cmax), stable=True)
        return o[order].contiguous(), d[order].contiguous(), tm[order].contiguous()

    def k8_args(o, d, tm, k_cap):
        k = min(k_cap, c)
        ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, k)
        return (o, d, tm, torch.clamp(usz, max=k),
                torch.clamp(ids, max=c - 1).contiguous(), tns.view(torch.int32),
                blk, cmin, cmax), usz

    def k7_args(o, d, tm, k, m):
        w = k7.wavefront_lists(o, d, tm, g, k, m)
        return (w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, blk, cmin, cmax), w

    def need_share(tm, need):
        return int(need.sum()) / max(int((tm > 0).sum()), 1)

    o, d, tm = coherent(small)
    n = o.shape[0]
    k2 = k8.intersect_matrix(o, d, g, t_max=tm)
    k2c = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, k2)
    k2_any = k8.intersect_matrix(o, d, g, t_max=tm, any_hit=True).tri >= 0
    for k_cap in (2, 32):
        args, usz = k8_args(o, d, tm, k_cap)
        for any_hit in (False, True):
            got = k8.grouped_walk(*args, any_hit)
            ref = k8.grouped_walk_plain(*args, any_hit)
            torch.cuda.synchronize()
            equal_tensors(f"K8 k_cap={k_cap} any_hit={any_hit}", got, ref, walk_labels)
        hit = k8.intersect_grouped(o, d, g, t_max=tm, k_cap=k_cap)
        canonical_equal(f"intersect_grouped k_cap={k_cap} vs K2 (N={n})", hit, k2c)
        occ = k8.intersect_grouped(o, d, g, t_max=tm, k_cap=k_cap, any_hit=True)
        anyhit_equal(f"intersect_grouped k_cap={k_cap}", occ.tri >= 0, k2_any, hit, k2c)
        log(f"  K8 k_cap={k_cap} N={n}: closest and any-hit equal to the plain "
            f"version bit for bit; {float((usz > k_cap).float().mean()):.3f} of "
            f"groups truncated; any-hit mask held against K2's")
    for k, m in ((3, 8), (16, 32)):
        args, w = k7_args(o, d, tm, k, m)
        for any_hit in (False, True):
            got = k7.wavefront_walk(*args, any_hit)
            ref = k7.wavefront_walk_plain(*args, any_hit)
            torch.cuda.synchronize()
            equal_tensors(f"K7 k={k} m={m} any_hit={any_hit}", got, ref,
                          walk_labels[:4] + ("stats",))
        hit = k7.intersect_wavefront(o, d, g, t_max=tm, k_per_ray=k, m_group=m)
        canonical_equal(f"intersect_wavefront k={k} m={m} vs K2 (N={n})", hit, k2c)
        occ = k7.intersect_wavefront(o, d, g, t_max=tm, k_per_ray=k, m_group=m,
                                     any_hit=True)
        anyhit_equal(f"intersect_wavefront k={k} m={m}", occ.tri >= 0, k2_any, hit, k2c)
        log(f"  K7 k={k} m={m} N={n}: closest and any-hit equal to the plain "
            f"version bit for bit; {float((w.cnt > k).float().mean()):.3f} of rays "
            f"truncated by the cull, {float((w.grp_bound != k7.INF_KEY).float().mean()):.3f} "
            f"of groups by the cap; any-hit mask held against K2's")

    # the main path's query size, in the order matrix_query gives K8
    o, d, tm = coherent(big)
    n = o.shape[0]
    g_total = n // k8.GROUP
    ray_bytes = n * 28 + n * 16 + blk.numel() * 4 + c * 24
    args, usz = k8_args(o, d, tm, 32)
    got = k8.grouped_walk(*args)
    with TestedPairs(k8, spans_real) as work:
        ref = k8.grouped_walk_plain(*args)
    torch.cuda.synchronize()
    equal_tensors(f"K8 k_cap=32 N={n}", got, ref, walk_labels)
    ref_any = k8.grouped_walk_plain(*args, True)
    equal_tensors(f"K8 k_cap=32 N={n} any-hit", k8.grouped_walk(*args, True), ref_any,
                  walk_labels)
    walked = int(got[4].sum())
    t_fin = torch.where(got[0] < 3.0e38, got[0], tm)
    bound8 = torch.where(usz > 32, args[5].view(torch.float32)[:, -1], 3.0e38)
    need8 = t_fin > bound8.repeat_interleave(k8.GROUP)
    b_ms, b_by, old_ms = work.bounds(ray_bytes + g_total * (4 + 32 * 8) + g_total * 4)
    k8_rec = dict(
        max_abs_err=max_abs_diff(got[:1] + got[2:4], ref[:1] + ref[2:4]),
        tri_mismatches=int((got[1] != ref[1]).sum()),
        bound_ms=b_ms, bound_by=b_by, old_bound_ms=old_ms, library_ms=None, rays=n,
        **work.record(), slot_fill=work.pairs / (walked * 128 * 128),
        walked_per_group=walked / g_total, need_share=need_share(tm, need8),
        truncated_groups=float((usz > 32).float().mean()),
        ms=cuda_ms(lambda: k8.grouped_walk(*args), reps),
        anyhit_ms=cuda_ms(lambda: k8.grouped_walk(*args, True), reps),
        plain_ms=cuda_ms(lambda: k8.grouped_walk_plain(*args), 1),
        lists_ms=cuda_ms(lambda: k8._group_candidates(o, d, tm, cmin, cmax, 32), 1),
        engine_ms=cuda_ms(lambda: k8.intersect_grouped(o, d, g, t_max=tm), 1),
    )
    log(f"  K8 k_cap=32 N={n}: equal bit for bit, closest and any-hit; kernel "
        f"{k8_rec['ms']:.3f} ms (any-hit {k8_rec['anyhit_ms']:.3f}), plain "
        f"{k8_rec['plain_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}; old bound "
        f"{old_ms:.4f}, every live ray x real triangle of the walked entries, "
        f"{k8_rec['slot_fill']:.3f} of their 128 x 128); {work.describe()}; "
        f"{k8_rec['walked_per_group']:.2f} entries walked per group, "
        f"{k8_rec['truncated_groups']:.3f} of groups truncated, "
        f"{k8_rec['need_share']:.4f} of live rays to the fallback; list glue "
        f"{k8_rec['lists_ms']:.1f} ms, the whole engine {k8_rec['engine_ms']:.1f} ms")
    del args, got, ref, ref_any

    k7_rec = None
    for k in (16, 8):
        args, w = k7_args(o, d, tm, k, 32)
        got = k7.wavefront_walk(*args)
        with TestedPairs(k8, spans_real) as work:
            ref = k7.wavefront_walk_plain(*args)
        torch.cuda.synchronize()
        equal_tensors(f"K7 k={k} m=32 N={n}", got, ref, walk_labels[:4] + ("stats",))
        equal_tensors(f"K7 k={k} m=32 N={n} any-hit", k7.wavefront_walk(*args, True),
                      k7.wavefront_walk_plain(*args, True), walk_labels[:4] + ("stats",))
        walked, tested = (int(x) for x in got[4].sum(dim=0))
        t_fin = torch.where(got[0] < 3.0e38, got[0], w.t_max)
        need7 = torch.clamp(t_fin, min=0.0).view(torch.int32) > k7.fallback_bound(
            w.pk, w.cnt, w.grp_bound, k)
        b_ms, b_by, old_ms = work.bounds(ray_bytes + g_total * 32 * 4 + n * 8 + g_total * 8)
        rec = dict(
            max_abs_err=max_abs_diff(got[:1] + got[2:4], ref[:1] + ref[2:4]),
            tri_mismatches=int((got[1] != ref[1]).sum()),
            bound_ms=b_ms, bound_by=b_by, old_bound_ms=old_ms, library_ms=None,
            rays=n, k=k, **work.record(), slot_fill=work.pairs / (tested * 128 * 128),
            walked_per_group=walked / g_total, tested_per_group=tested / g_total,
            need_share=need_share(w.t_max, need7),
            list_len=float((w.tnb != k7.INF_KEY).sum()) / g_total,
            ms=cuda_ms(lambda: k7.wavefront_walk(*args), reps),
            anyhit_ms=cuda_ms(lambda: k7.wavefront_walk(*args, True), reps),
            plain_ms=cuda_ms(lambda: k7.wavefront_walk_plain(*args), 1),
            lists_ms=cuda_ms(lambda: k7.wavefront_lists(o, d, tm, g, k, 32), 1),
            engine_ms=cuda_ms(lambda: k7.intersect_wavefront(
                o, d, g, t_max=tm, k_per_ray=k), 1),
        )
        log(f"  K7 k={k} m=32 N={n}: equal bit for bit, closest and any-hit; kernel "
            f"{rec['ms']:.3f} ms (any-hit {rec['anyhit_ms']:.3f}), plain "
            f"{rec['plain_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}; old bound "
            f"{old_ms:.4f}, every live ray x real triangle of the tested entries, "
            f"{rec['slot_fill']:.3f} of their 128 x 128); {work.describe()}; "
            f"lists of {rec['list_len']:.2f} entries, "
            f"{rec['walked_per_group']:.2f} walked and {rec['tested_per_group']:.2f} "
            f"tested per group, {rec['need_share']:.4f} of live rays to the "
            f"fallback; list glue (cull, sort, merge) {rec['lists_ms']:.1f} ms, the "
            f"whole engine {rec['engine_ms']:.1f} ms")
        if k7_rec is None:
            k7_rec = rec
        else:
            k7_rec["k8"] = {key: rec[key] for key in (
                "ms", "anyhit_ms", "bound_ms", "old_bound_ms", "span_pairs",
                "warp_span_fill", "walked_per_group", "tested_per_group",
                "need_share", "list_len", "engine_ms")}
        del args, got, ref, w
    # both engines against K2 at this size, the defaults
    k2c = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2,
                        k8.intersect_matrix(o, d, g, t_max=tm))
    k8_rec["flips_vs_k2"] = canonical_equal(
        f"intersect_grouped vs K2 (N={n})", k8.intersect_grouped(o, d, g, t_max=tm), k2c)
    k7_rec["flips_vs_k2"] = canonical_equal(
        f"intersect_wavefront vs K2 (N={n})", k7.intersect_wavefront(o, d, g, t_max=tm),
        k2c)
    k8_rec["span_table"] = span_table
    return k7_rec, k8_rec


def instanced_scene(host, copies: int = INSTANCES):
    """The host scene with `copies` - 1 more nodes per mesh node, the
    j-th translated along x by j * (the x extent of the scene's meshes
    + 2.0): copies of atrium_big side by side, with its camera and
    lights. The host scene itself is not changed. Returns (scene,
    spacing)."""
    import dataclasses as dc

    from hala_tpu_torch.scene.cpu.node import Node

    meshed = [n for n in host.nodes if n.mesh_index is not None]
    xs = [(p.positions @ n.world_transform[:3, :3].T + n.world_transform[:3, 3])[:, 0]
          for n in meshed for p in host.meshes[n.mesh_index].primitives]
    spacing = float(max(x.max() for x in xs) - min(x.min() for x in xs)) + 2.0
    extra = []
    for j in range(1, copies):
        for n in meshed:
            m = n.world_transform.copy()
            m[0, 3] += j * spacing
            extra.append(Node(name=f"{n.name}_{j}", local_transform=m,
                              world_transform=m.copy(), mesh_index=n.mesh_index))
    return dc.replace(host, nodes=list(host.nodes) + extra), spacing


def upload_instances(host, dev):
    """`instanced_scene` of `host` through SceneUploader.upload (the SAH
    build makes the clusters), timed on the host clock. Returns (host
    scene, device scene, seconds, spacing)."""
    from hala_tpu_torch.ops import traverse as k5
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    scene, spacing = instanced_scene(host)
    t0 = time.perf_counter()
    dev_scene = SceneUploader.upload(scene, device=dev)
    seconds = time.perf_counter() - t0
    c = dev_scene.geometry.cluster_min.shape[0]
    tris = int((dev_scene.geometry.tri_mat >= 0).sum())
    log(f"  {INSTANCES} instances of atrium_big, {spacing:.1f} apart along x: "
        f"{tris} triangles, {c} clusters (\"auto\" takes \"traverse\" above "
        f"{k5.MATRIX_MAX_CLUSTERS}); upload {seconds:.2f} s")
    if not c > k5.MATRIX_MAX_CLUSTERS:
        raise AssertionError(f"{c} clusters: \"auto\" would not traverse")
    return scene, dev_scene, seconds, spacing


def check_past_key_width(dev_scene, n_rand: int):
    """intersect_traversed over more than MATRIX_MAX_CLUSTERS clusters
    (two cull superchunks) against K1 over all slots."""
    import torch

    from hala_tpu_torch.ops import cull
    from hala_tpu_torch.ops import traverse as k5
    from hala_tpu_torch.ops.pallas import intersect_kernel as k1

    g = dev_scene.geometry
    c = g.cluster_min.shape[0]
    if not c > cull.CULL_MAX_CLUSTERS:
        raise AssertionError(f"{c} clusters: no second superchunk")
    o, d = random_rays(dev_scene, n_rand, 41)
    tm = torch.full((n_rand,), 3.0e38, device=o.device)
    tm[1::4] = 4.0
    cuda_lib_before = _launches()
    ht = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=TRAVERSE_K)
    hb = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    torch.cuda.synchronize()
    calls = {k: v - cuda_lib_before[k] for k, v in _launches().items()}
    if calls["cull_topk"] != 2:
        raise AssertionError(f"expected two cull superchunks, got {calls}")
    _, graze = compare_with_exact(
        f"intersect_traversed vs K1 over {c} clusters ({g.tri_v0.shape[0]} slots)",
        ht, hb, o, d, tm, g)
    hits = int((hb.tri >= 0).sum())
    far = int((hb.tri >= k5.TRI_CHUNK * cull.CULL_MAX_CLUSTERS).sum())
    log(f"  {c} clusters in 2 superchunks, {n_rand} rays: {hits} hits, {far} of "
        f"them in clusters past id {cull.CULL_MAX_CLUSTERS - 1}")
    if far == 0:
        raise AssertionError("no hit past the key width: the check proves nothing")
    return dict(clusters=c, rays=n_rand, hits=hits, hits_past_key_width=far,
                cull_misses=graze)


def check_instances(dev_scene, reps: int, cam=(1024, 1024), n_rand: int = 1 << 20):
    """K4 and K6 on the five instances of atrium_big (two cull
    superchunks), at the main path's K on a 2^21-ray mixed batch:
    each K4 launch against its plain version bit for bit, unsorted and
    in the coherence order the traverse engine's queries come in; K6 on
    the fallback's inputs (after K5 on the sorted lists) against its
    plain version bit for bit; both timed with their bounds; and what
    the superchunk merge of `cull_candidates` costs at 2^20 rays."""
    import torch

    from hala_tpu_torch.ops import cluster as k6
    from hala_tpu_torch.ops import cull
    from hala_tpu_torch.ops import traverse as k5

    g = dev_scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    c, k, sc = cmin.shape[0], TRAVERSE_K, cull.CULL_MAX_CLUSTERS
    big = mixed_batch(dev_scene, *cam, n_rand, 35)
    big_s, _ = coherent_order(dev_scene, big)
    n = big[0].shape[0]
    unions = cull.geometry_unions(g)
    slices = [(lo, slice(lo, lo + sc)) for lo in range(0, c, sc)]

    def query(o, d, tm):
        return [cull.cull_topk(o, d, tm, cmin[sl], cmax[sl], k=k, unions=unions[j])
                for j, (_, sl) in enumerate(slices)]

    err = 0.0
    for label, (o, d, tm) in (("unsorted", big), ("sorted", big_s)):
        for (lo, sl), got in zip(slices, query(o, d, tm)):
            ref = cull.cull_topk_plain(o, d, tm, cmin[sl], cmax[sl], k=k)
            torch.cuda.synchronize()
            equal_tensors(f"K4 K={k} N={n} clusters {lo}.. {label}", got, ref,
                          ("pk", "cnt"))
            err = max(err, max_abs_diff(got, ref))
    b_ms, b_by, work = k4_work(*big, cmin, cmax, k)
    old_ms = sum(bound(n * cs * OPS_CULL, n * 28 + cs * 24 + n * k * 4 + n * 4)[0]
                 for cs in (min(sc, c - lo) for lo, _ in slices))
    k4 = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, old_bound_ms=old_ms,
        work=work, rays=n, clusters=c, launches_per_query=len(slices),
        query_ms=cuda_ms(lambda: query(*big_s), reps),
        query_ms_unsorted=cuda_ms(lambda: query(*big), reps),
        plain_query_ms=cuda_ms(lambda: [cull.cull_topk_plain(
            *big_s, cmin[sl], cmax[sl], k=k) for _, sl in slices], 1),
    )
    half = tuple(x[:n // 2].contiguous() for x in big_s)
    k4["merge_ms_half"] = cuda_ms(lambda: k5.cull_candidates(
        *half, cmin, cmax, k, unions=unions), reps) - cuda_ms(lambda: query(*half), reps)
    log(f"  K4 K={k} N={n} x {c} clusters ({len(slices)} launches a query): pk, "
        f"cnt equal bit for bit, both orders; a query {k4['query_ms']:.3f} ms "
        f"sorted, {k4['query_ms_unsorted']:.3f} unsorted, plain "
        f"{k4['plain_query_ms']:.1f} ms, bound {b_ms:.4f} ms ({b_by}; {work}; "
        f"every ray x box: {old_ms:.4f}); the merge of the two lists at {n // 2} "
        f"rays {k4['merge_ms_half']:.3f} ms")

    ids, tns, ovf = k5.cull_candidates(*big_s, cmin, cmax, k, unions=unions)
    hit, unres, _ = k5.traverse_candidates(*big_s, ids, tns, ovf, cmin, cmax,
                                           g.tri_packed)
    fb_tm = k5.fallback_t_max(hit, unres)
    fk = k6.intersect_clustered(big_s[0], big_s[1], g, t_max=fb_tm)
    fp = k6.intersect_clustered_plain(big_s[0], big_s[1], g, t_max=fb_tm)
    torch.cuda.synchronize()
    equal_tensors(f"K6 fallback N={n} x {c} clusters", fk, fp, ("t", "tri", "u", "v"))
    k6_rec = k6_record(g, big_s[0], big_s[1], fb_tm, fk, fp, reps)
    k6_rec["full_ms"] = cuda_ms(
        lambda: k6.intersect_clustered(big_s[0], big_s[1], g, t_max=big_s[2]), 1)
    log(f"  K6 on the full range of the {n} sorted rays x {c} clusters (the "
        f"cluster engine): {k6_rec['full_ms']:.3f} ms")
    return k4, k6_rec


def _launches():
    from hala_tpu_torch.ops import cuda_lib

    return cuda_lib.launches()


def raster_inputs(dev_scene, width: int, height: int, tile: int):
    """Screen-space triangles of the scene's first camera (the bench
    camera), as RasterizationRenderer sets them up."""
    from hala_tpu_torch.models.rz_renderer import RasterSettings, _raster_setup

    settings = RasterSettings(width, height, binned=True, tile=tile)
    screen, depth, inv_w, valid, _ = _raster_setup(dev_scene, 0, settings)
    return screen, depth, inv_w, valid


def equal_planes(name: str, a, b) -> None:
    """Raise unless every plane of a and b is equal bit for bit."""
    import torch

    for label, x, y in zip(("depth", "tri", "uw", "vw", "iw"), a, b):
        same = torch.equal(x.view(torch.int32), y.view(torch.int32))
        if not same:
            bad = int((x.view(torch.int32) != y.view(torch.int32)).sum())
            raise AssertionError(f"{name}: {label} differs in {bad} pixels")


def inside_pairs(seg) -> int:
    """The (candidate, pixel) pairs of every tile's segment whose pixel
    lies inside the candidate, by the kernel's edge functions, walked
    as the plain version walks the segments."""
    import torch

    from hala_tpu_torch.ops import raster as rr
    from hala_tpu_torch.ops import raster_kernel as k3

    starts, data, tile = seg.starts, seg.data, seg.tile
    dev = data.device
    n_tiles = starts.shape[0] - 1
    n_pix = tile * tile
    seg0 = starts[:-1].long()
    seg_len = (starts[1:] - starts[:-1]).long()
    px, py = rr.tile_pixels(n_tiles, seg.tw, tile, dev)
    px, py = px[..., None], py[..., None]
    j = torch.arange(k3.CAND_CHUNK, device=dev)
    last = max(data.shape[0] - 1, 0)
    step = max(1, rr._BLOCK_ELEMS // (n_pix * k3.CAND_CHUNK))
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, n_tiles, step):
        b1 = min(n_tiles, b0 + step)
        for k0 in range(0, int(seg_len[b0:b1].max()), k3.CAND_CHUNK):
            col = k0 + j[None]
            ok = col < seg_len[b0:b1, None]
            rows = data[torch.clamp(seg0[b0:b1, None] + col, max=last)]
            x0, y0, x1, y1, x2, y2 = (rows[:, None, :, k] for k in range(6))
            sgn = rows[:, None, :, rr._SGN]
            inside = ok[:, None, :]
            for ex, ey, ax, ay in ((x2 - x1, y2 - y1, x1, y1),
                                   (x0 - x2, y0 - y2, x2, y2),
                                   (x1 - x0, y1 - y0, x0, y0)):
                w_e = rr.edge(ex, ey, px[b0:b1] - ax, py[b0:b1] - ay)
                inside = inside & (w_e * sgn >= 0.0)
            total += inside.sum()
    return int(total)


def skip_breaking_triangles(size: int, n_dense: int, seed: int,
                            finite: bool = False):
    """Screen-space triangles at size x size pixels built to break K3's
    sub-tile skip: near-collinear slivers on lines through pixel
    centres, slivers hugging the x = 0 and y = 0 borders with areas just
    above the 1e-12 cut, slivers a few ulps wide along the pixel-centre
    columns and rows next to sub-tile borders (their rounded edge
    functions accept pixel centres outside their boxes), huge triangles
    (some past 2^22), rows with NaN and infinite corners (left out with
    `finite`) and `n_dense` small triangles in the 64x64 tile at
    (64, 64); ids shuffled. Returns numpy (tri_screen, depth, inv_w,
    valid)."""
    rs = np.random.RandomState(seed)
    tris = []
    for _ in range(300):
        a = rs.randint(0, size, 2) + 0.5
        step = rs.randint(-3, 4, 2)
        if not step.any():
            step[0] = 1
        b = a + rs.randint(3, 40) * step
        c = (a + np.float32(rs.uniform(0.2, 0.8)) * (b - a)).astype(np.float32)
        c = c + rs.randint(-3, 4, 2) * np.spacing(np.abs(c))
        tris.append([a, b, c])
    for _ in range(60):
        y0, y1 = np.sort(rs.uniform(0, size, 2))
        off = rs.uniform(1.0, 50.0) * 2e-12 / max(y1 - y0, 1.0)
        tri = [[off, y0], [0.0, y1], [0.0, (y0 + y1) / 2]]
        tris.append([q[::-1] for q in tri] if rs.rand() < 0.5 else tri)
    for _ in range(200):
        x = 16 * rs.randint(0, size // 16) + rs.choice([-0.5, 0.5])
        y0, y1 = rs.randint(0, size, 2) + 0.5
        ulp = np.spacing(np.float32(abs(x)))
        tri = [[x, y0], [x + rs.randint(1, 4) * ulp, y1],
               [x - rs.randint(0, 3) * ulp, (y0 + y1) / 2 + 0.25]]
        tris.append([q[::-1] for q in tri] if rs.rand() < 0.5 else tri)
    for s in (1e3, 1e5, 3e6, 1e7):
        cx, cy = rs.uniform(0, size, 2)
        tris.append([[cx - s, cy - s], [cx + 2 * s, cy - s * 0.5], [cx, cy + 2 * s]])
    if not finite:
        inf, nan = np.inf, np.nan
        tris += [[[inf, 5.0], [0.0, 0.0], [0.0, 10.0]],
                 [[nan, 5.0], [3.0, 0.0], [3.0, 40.0]],
                 [[20.0, -inf], [30.0, 5.0], [10.0, 5.0]],
                 [[40.0, 40.0], [nan, nan], [60.0, 50.0]],
                 [[-inf, 70.0], [inf, 70.0], [50.0, 90.0]]]
    dense = rs.uniform(64, 128, (n_dense, 1, 2)) + rs.uniform(-1.5, 1.5, (n_dense, 3, 2))
    tri = np.concatenate([np.asarray(tris, np.float64), dense]).astype(np.float32)
    t = tri.shape[0]
    tri = tri[rs.permutation(t)]
    return (tri, rs.uniform(0.05, 0.95, (t, 3)).astype(np.float32),
            rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32), np.ones(t, bool))


def subtile_pairs(seg) -> int:
    """The (candidate, pixel) pairs K3 tests under its sub-tile skip:
    SUB_TILE^2 for every (segment row, sub-tile) that is not skipped."""
    from hala_tpu_torch.ops import raster_kernel as k3

    skip = k3.subtile_skip(seg.starts, seg.data, seg.tw, seg.tile)
    return int((~skip).sum()) * k3.SUB_TILE ** 2


def check_k3_skip_table(dev, reps: int, size: int = 256, n_dense: int = 5200,
                       tile: int = 64):
    """K3 on `skip_breaking_triangles` against its plain version, bit
    for bit: slivers along sub-tile borders, huge and non-finite rows,
    and one tile of more than 5000 candidates."""
    import torch

    from hala_tpu_torch.ops import raster_kernel as k3

    arrays = skip_breaking_triangles(size, n_dense, 21)
    tris = [torch.from_numpy(a).to(dev) for a in arrays]
    seg = k3.build_segments(*tris, size, size, tile)
    args = (seg.starts, seg.data, seg.tw, seg.tile)
    pk = k3.raster_segments(*args)
    pp = k3.raster_segments_plain(*args)
    torch.cuda.synchronize()
    equal_planes(f"K3 skip-breaking table {size}x{size}", pk, pp)
    seg_len = (seg.starts[1:] - seg.starts[:-1]).long()
    longest = int(seg_len.max())
    if longest <= 5000 or float(seg.over) != 0.0:
        raise AssertionError(f"K3 skip-breaking table: longest {longest}, "
                             f"overflow {float(seg.over)}")
    n_real = int(seg.n_real)
    skipped = 1.0 - subtile_pairs(seg) / (n_real * tile * tile)
    rec = dict(rows=arrays[0].shape[0], n_real=n_real, longest=longest,
               skipped_share=skipped,
               ms=cuda_ms(lambda: k3.raster_segments(*args), reps))
    log(f"  K3 skip-breaking table {size}x{size} tile {tile}: depth, tri, uw, "
        f"vw, iw equal bit for bit; {rec['rows']} triangles, {n_real} "
        f"(tile, candidate) pairs, longest segment {longest}, "
        f"{skipped:.3f} of (candidate, pixel) pairs skipped; kernel "
        f"{rec['ms']:.3f} ms")
    return rec


def check_k3(dev_scene, reps: int, w: int = 1920, h: int = 1088,
             small: int = 256):
    """K3 (csrc/raster_tiled.cu) vs its plain version at the bench
    shape, and the exact path vs the full scan at small x small."""
    import torch

    from hala_tpu_torch.ops import raster as rr
    from hala_tpu_torch.ops import raster_kernel as k3

    tile = 64
    tris = raster_inputs(dev_scene, w, h, tile)
    seg = k3.build_segments(*tris, w, h, tile)
    args = (seg.starts, seg.data, seg.tw, seg.tile)
    pk = k3.raster_segments(*args)
    pp = k3.raster_segments_plain(*args)
    torch.cuda.synchronize()
    equal_planes(f"K3 vs plain {w}x{h}", pk, pp)
    fk = k3.segments_to_fragments(pk, seg, w, h)
    fp = k3.segments_to_fragments(pp, seg, w, h)
    for label in ("u", "v"):
        if not torch.equal(getattr(fk, label), getattr(fp, label)):
            raise AssertionError(f"K3 vs plain: {label} differs")
    if float(seg.over) != 0.0:
        raise AssertionError("K3: a static selection bound overflowed")
    seg_len = (seg.starts[1:] - seg.starts[:-1]).long()
    n_real = int(seg.n_real)
    n_tiles = seg_len.shape[0]
    n_pix = tile * tile
    covered = float((fk.tri >= 0).float().mean())
    log(f"  K3 vs plain {w}x{h} tile {tile}: depth, tri, uw, vw, iw, u, v "
        f"equal bit for bit; overflow 0; n_real {n_real} (tile, candidate) "
        f"pairs, longest segment {int(seg_len.max())}, median "
        f"{int(seg_len.median())}, {n_tiles} tiles; {covered:.3f} of pixels "
        f"covered")

    s2 = raster_inputs(dev_scene, small, small, tile)
    f_exact, over2 = k3.rasterize_tiled_exact(*s2, small, small, tile=tile)
    pix = torch.arange(small * small, device=s2[0].device)
    px = (pix % small).float() + 0.5
    py = (pix // small).float() + 0.5
    f_full = rr.rasterize(*s2, px, py, chunk=128)
    torch.cuda.synchronize()
    for label in ("depth", "tri", "u", "v"):
        x, y = getattr(f_exact, label), getattr(f_full, label)
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"K3 vs full scan {small}x{small}: {label} differs")
    if float(over2) != 0.0:
        raise AssertionError(f"K3 {small}x{small}: overflow")
    log(f"  K3 {small}x{small} vs full-scan rasterize: depth, tri, u, v "
        "equal bit for bit")

    n_inside = inside_pairs(seg)
    n_bytes = n_real * k3.ROW_WIDTH * 4 + (n_tiles + 1) * 4 + 5 * n_tiles * n_pix * 4
    b_ms, b_by = bound(
        n_real * n_pix * OPS_RASTER_EDGE + n_inside * OPS_RASTER_INSIDE, n_bytes)
    # what the sub-tile model needs: the pairs of the sub-tiles not skipped
    n_sub = subtile_pairs(seg)
    sub_ms, sub_by = bound(n_sub * OPS_RASTER_EDGE + n_inside * OPS_RASTER_INSIDE,
                           n_bytes)
    err = max(  # over depth, uw, vw and iw (the tri plane is held equal)
        float((pk[i].double() - pp[i].double()).abs().max())
        for i in (0, 2, 3, 4)
    )
    rec = dict(
        max_abs_err=err, n_inside=n_inside,
        ms=cuda_ms(lambda: k3.raster_segments(*args), reps),
        plain_ms=cuda_ms(lambda: k3.raster_segments_plain(*args), 1),
        glue_ms=cuda_ms(lambda: k3.build_segments(*tris, w, h, tile), reps),
        bound_ms=b_ms, bound_by=b_by, n_real=n_real,
        longest=int(seg_len.max()), tiles=n_tiles,
        subtile_pairs=n_sub, subtile_bound_ms=sub_ms,
    )
    log(f"  K3 {w}x{h}: kernel {rec['ms']:.3f} ms, plain "
        f"{rec['plain_ms']:.1f} ms, glue (binning + table) "
        f"{rec['glue_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{n_real * n_pix} (candidate, pixel) pairs, {n_inside} inside); "
        f"the sub-tile model's {n_sub} pairs: {sub_ms:.4f} ms ({sub_by})")
    return rec


def golden_raster(device) -> None:
    """The raster goldens of tests/test_golden.py through the port."""
    from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
    from hala_tpu_torch.scene.cpu.scene import Scene
    from hala_tpu_torch.scene.procedural import cornell_box

    cases = (
        ("raster", cornell_box(), dict(chunk=128)),
        ("raster_atrium", Scene.load(os.path.join(HERE, "assets", "atrium.glb")),
         dict(binned=True, tile=16)),
    )
    for name, host, kw in cases:
        r = RasterizationRenderer("golden_" + name, 48, 48, device=device, **kw)
        r.set_scene(host)
        r.commit()
        r.update()
        img = r.get_final_image()
        with np.load(os.path.join(HERE, "tests", "fixtures",
                                  f"golden_{name}.npz")) as z:
            rmse = float(np.sqrt(np.mean((img - z["color"]) ** 2)))
        log(f"  golden_{name} color: RMSE {rmse:.3g}")
        if not rmse < 1e-3:
            raise AssertionError(f"golden_{name}: RMSE {rmse}")


def golden_envmap_array():
    """The map of the envmap golden: seeded noise with one hot texel."""
    rs = np.random.RandomState(11)
    rgb = rs.uniform(0.05, 0.4, (16, 32, 3)).astype(np.float32)
    rgb[4, 9] = 30.0
    return rgb


def bench_envmap_array():
    """bench.py's envmap configuration: a seeded 64x128 map with a hot
    "sun" patch the CDF must find."""
    rs = np.random.RandomState(7)
    rgb = rs.uniform(0.05, 0.3, (64, 128, 3)).astype(np.float32)
    rgb[20:26, 40:48] = 60.0
    return rgb


def golden_renders(device) -> None:
    """Small renders held against the fixtures: the auto path, and the
    environment-map golden through the brute force."""
    from hala_tpu_torch.envmap import EnvMap
    from hala_tpu_torch.models.integrator import (
        ENV_MAP, Film, RenderSettings, Uniforms, render_frame,
    )
    from hala_tpu_torch.scene.cpu.scene import Scene
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box

    cases = (
        ("cornell", cornell_box(), RenderSettings(32, 32, max_depth=3), 8,
         ("accum", "albedo", "normal"), None),
        ("atrium", Scene.load(os.path.join(HERE, "assets", "atrium.glb")),
         RenderSettings(24, 24, max_depth=2), 4, ("accum", "albedo"), None),
        # tests/test_golden.py TestGoldenEnvmap: the map of
        # tests/fixtures/regen_golden.py, no ceiling light
        ("envmap", cornell_box(light_intensity=0.0),
         RenderSettings(32, 32, max_depth=3, rr_depth=2, tile_size=1024,
                        intersector="bruteforce", env_type=ENV_MAP), 8,
         ("accum",), golden_envmap_array()),
    )
    for name, host, settings, frames, keys, env_rgb in cases:
        ds = SceneUploader.upload(host, device=device)
        film = Film.create(settings.width, settings.height, device)
        uni = Uniforms.default(device)
        env = None if env_rgb is None else EnvMap.from_array(env_rgb, device=device)
        for f in range(frames):
            render_frame(ds, env, uni, film, f, settings)
        with np.load(os.path.join(HERE, "tests", "fixtures",
                                  f"golden_{name}.npz")) as z:
            for k in keys:
                got = getattr(film, k).cpu().numpy()
                rmse = float(np.sqrt(np.mean((got - z[k]) ** 2)))
                log(f"  golden_{name} {k}: RMSE {rmse:.3g}")
                if not rmse < 1e-3:
                    raise AssertionError(f"golden_{name} {k}: RMSE {rmse}")


def warm_up(r):
    """One frame to load PyTorch's own kernels, then a fresh film.
    Returns the warm-up frame's RGB film (frame 0)."""
    import torch

    r.render_loop(1)
    torch.cuda.synchronize()
    first = r.film.accum[..., :3].clone()
    r.reset_accumulation()
    r.total_rays = 0.0
    return first


def rel_rmse(a, b) -> float:
    """RMSE of a - b relative to the RMS of b."""
    import torch

    return float(torch.sqrt(torch.mean((a - b) ** 2)) / torch.sqrt(torch.mean(b ** 2)))


def band_frame0(r, intersector: str):
    """Frame 0 of rows BAND_ROWS of r's image through `intersector`:
    render_frame with row_offset/full_height traces the same camera
    rays with the same RNG as those rows of the full frame. Returns the
    RGB band (rows, W, 3)."""
    import torch

    from hala_tpu_torch.models.integrator import Film, render_frame

    off, rows = BAND_ROWS
    st = dataclasses.replace(r.settings, height=rows, intersector=intersector)
    film = Film.create(st.width, rows, r.device)
    render_frame(r.scene, None, r.uniforms, film, 0, st, row_offset=off,
                 full_height=r.settings.height)
    torch.cuda.synchronize()
    return film.accum[..., :3]


def shadow_range_witness(k2_renderer, trav_frame0, k2_frame0, card: str):
    """Where the traverse film's distance to the K2 film comes from.
    Frame 0 of the band BAND_ROWS through K1 ("pallas": brute force
    over every slot; shadow rays in the batched closest-hit query, their
    range shortened once by 1 - 1e-4, as the traverse engine's) must
    match the traverse frame 0 on those rows. K2's frame 0 (shadow rays
    in a split any-hit query, their range shortened twice) is held
    against the same band and reported. The band also goes through
    "traverse" and "matrix", which must give those rows of their full
    frames."""
    off, rows = BAND_ROWS
    sl = slice(off, off + rows)
    k1 = band_frame0(k2_renderer, "pallas")
    tr = band_frame0(k2_renderer, "traverse")
    k2 = band_frame0(k2_renderer, "matrix")

    def differ(a, b) -> int:
        return int((a != b).any(dim=-1).sum())

    out = dict(
        rows=[off, off + rows],
        k1_vs_traverse=rel_rmse(trav_frame0[sl], k1),
        k1_vs_k2=rel_rmse(k2_frame0[sl], k1),
        traverse_vs_k2_frame0=rel_rmse(trav_frame0, k2_frame0),
        pixels_k1_traverse_differ=differ(trav_frame0[sl], k1),
        pixels_k1_k2_differ=differ(k2_frame0[sl], k1),
        traverse_band_vs_rows=rel_rmse(tr, trav_frame0[sl]),
        k2_band_vs_rows=rel_rmse(k2, k2_frame0[sl]),
    )
    log(f"  witness, rows {off}-{off + rows - 1} of frame 0 "
        f"({k1.shape[0] * k1.shape[1]} pixels): relative RMSE of the traverse "
        f"frame to the K1 band {out['k1_vs_traverse']:.3g} "
        f"({out['pixels_k1_traverse_differ']} pixels differ), of the K2 frame "
        f"{out['k1_vs_k2']:.3g} ({out['pixels_k1_k2_differ']} pixels differ); "
        f"whole frame 0, traverse vs K2: {out['traverse_vs_k2_frame0']:.3g}; "
        f"bands vs the rows of their full frames: traverse "
        f"{out['traverse_band_vs_rows']:.3g}, K2 {out['k2_band_vs_rows']:.3g} "
        f"[{card}]")
    for key in ("k1_vs_traverse", "traverse_band_vs_rows", "k2_band_vs_rows"):
        if not out[key] < REL_RMSE_TOL:
            raise AssertionError(f"witness {key}: relative RMSE {out[key]}")
    return out


def run_render(r, frames: int, k: int, name: str, card: str,
               cell: str | None = None):
    """Drive one renderer through render_loop; check the invariants of
    bench.py's `cell` (default: `name`)."""
    import torch

    from bench import check_invariants

    cell = cell or name
    t0 = time.perf_counter()
    r.render_loop(frames, frames_per_dispatch=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    accum = r.film.accum
    if not bool(torch.isfinite(accum).all()):
        raise AssertionError(f"{name}: non-finite film")
    mean = float(accum[..., :3].mean())
    primaries = r.info.width * r.info.height * frames
    check_invariants(cell, mean, r.total_rays, primaries)
    ref = JAX_TPU_REFERENCE.get(cell, ("not measured", "not measured"))
    out = dict(
        mean=mean, rays_per_primary=r.total_rays / primaries,
        mrays_per_s=r.total_rays / dt / 1e6, ms_per_frame=dt / frames * 1e3,
    )
    log(f"  {name} {r.info.width}x{r.info.height}x{frames}f: film mean "
        f"{mean:.4f} (JAX {ref[0]}), rays/primary "
        f"{out['rays_per_primary']:.2f} (JAX {ref[1]}); "
        f"{out['mrays_per_s']:.2f} Mrays/s, {out['ms_per_frame']:.1f} ms/frame "
        f"[{card}]")
    return out


def family_render(name: str, host_scene, frames: int, k2_film, card: str,
                  size=(1920, 1088), device="cuda", **kw):
    """One matrix-family render of atrium_big at 1920x1088: a warm-up
    frame, `frames` timed frames with the launch counts read around
    them, bench.py's sponza invariants, the film's relative RMSE to the
    K2 film of the same frames (gated at REL_RMSE_TOL: the whole family
    shares the split shadow query), then one more frame for the
    engines' counts. Returns (record, launches, renderer)."""
    import torch

    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.ops import cuda_lib
    from hala_tpu_torch.ops import traverse as k8

    r = RayTracingRenderer(name.replace(" ", "_"), *size, max_depth=4,
                           rr_depth=2, spp=1, device=device, **kw)
    r.set_scene(host_scene)
    r.commit()
    warm_up(r)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    out = run_render(r, frames, frames, name, card, cell="sponza")
    counts = cuda_lib.launches()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["rel_rmse_vs_k2"] = rel_rmse(r.film.accum[..., :3], k2_film)
    out["launches_per_frame"] = {
        key: counts[key] / frames
        for key in ("matrix_traverse", "cull_topk", "wavefront_walk", "grouped_walk")}
    if not out["rel_rmse_vs_k2"] < REL_RMSE_TOL:
        raise AssertionError(f"{name}: relative RMSE to the K2 film "
                             f"{out['rel_rmse_vs_k2']}")
    k8.walk_stats.reset()
    k8.walk_stats.enabled = True
    r.render_loop(1)
    torch.cuda.synchronize()
    k8.walk_stats.enabled = False
    out.update(k8.walk_stats.summary())
    log(f"  {name}: film relative RMSE vs the K2 film of the same {frames} "
        f"frame(s) {out['rel_rmse_vs_k2']:.3g}; launches per frame "
        f"{out['launches_per_frame']}; over the {out['queries']} walk queries of "
        f"one more frame: {out['walked_per_group']:.2f} entries walked and "
        f"{out['tested_per_group']:.2f} tested per group, {out['need_share']:.4f} "
        f"of live rays to the fallback; peak memory "
        f"{out['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    return out, counts, r


def instances_render(host_scene, frames: int, card: str, size=(1920, 1088),
                     device="cuda"):
    """The five instances of atrium_big at 1920x1088 through
    intersector="auto" (which must take "traverse": K4 twice a query,
    one per superchunk, K5 and K6, no K2 and no K1): a warm-up frame
    (frame 0, kept), `frames` timed frames with the launch counts read
    around them, bench.py's rays-per-camera-ray invariant (its film-mean
    band was set for one atrium_big: the mean is printed beside it, not
    gated), a torch.profiler window over one more frame; then frame 0
    through "cluster" (K6 alone) and rows BAND_ROWS of frame 0 through
    "pallas" (K1, brute force over every slot), each within relative
    RMSE REL_RMSE_TOL of the "auto" frame 0. Returns (record, launches)."""
    import torch

    from bench import ACCUM_MEAN_BANDS
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.ops import cuda_lib

    r = RayTracingRenderer("atrium_big_x5", *size, max_depth=4, rr_depth=2,
                           spp=1, intersector="auto", device=device)
    t0 = time.perf_counter()
    r.set_scene(host_scene)  # the upload
    upload_s = time.perf_counter() - t0
    r.commit()
    frame0 = warm_up(r)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    out = run_render(r, frames, frames, f"atrium_big x{INSTANCES} auto", card,
                     cell=f"atrium_big_x{INSTANCES}")
    counts = cuda_lib.launches()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["upload_s"] = upload_s
    out["launches_per_frame"] = {key: v / frames for key, v in counts.items() if v}
    queries = counts["traverse_candidates"]
    if not (queries > 0 and counts["cull_topk"] == 2 * queries
            and counts["cluster_stream"] == queries
            and counts["matrix_traverse"] == 0
            and counts["intersect_bruteforce"] == 0):
        raise AssertionError(f"atrium_big x{INSTANCES} auto launches {counts}")
    band = ACCUM_MEAN_BANDS["sponza"]
    log(f"  atrium_big x{INSTANCES} auto: film mean {out['mean']:.4f} (one "
        f"atrium_big's band {band}, not gated here); launches per frame "
        f"{out['launches_per_frame']}; set_scene (the upload) {upload_s:.2f} s; peak "
        f"memory {out['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    out["profile"] = profile_frames(f"atrium_big x{INSTANCES} auto",
                                    lambda: r.render_loop(1), 1,
                                    out["ms_per_frame"], card)
    clus = RayTracingRenderer("atrium_big_x5_cluster", *size, max_depth=4,
                              rr_depth=2, spp=1, intersector="cluster",
                              device=device)
    clus.set_scene(host_scene)
    clus.commit()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    clus.render_loop(1)
    torch.cuda.synchronize()
    out["cluster_frame_ms"] = (time.perf_counter() - t0) * 1e3
    after = cuda_lib.launches()
    if not (after["cluster_stream"] > 0
            and sum(after.values()) == after["cluster_stream"]):
        raise AssertionError(f"atrium_big x{INSTANCES} cluster launches {after}")
    out["rel_rmse_frame0_vs_cluster"] = rel_rmse(frame0, clus.film.accum[..., :3])
    del clus
    off, rows = BAND_ROWS
    k1_band = band_frame0(r, "pallas")
    out["rel_rmse_frame0_vs_k1_band"] = rel_rmse(frame0[off:off + rows], k1_band)
    log(f"  atrium_big x{INSTANCES} frame 0: relative RMSE to the cluster "
        f"engine's frame 0 {out['rel_rmse_frame0_vs_cluster']:.3g} (that frame "
        f"{out['cluster_frame_ms']:.1f} ms), to K1's rows {off}-{off + rows - 1} "
        f"{out['rel_rmse_frame0_vs_k1_band']:.3g} [{card}]")
    for key in ("rel_rmse_frame0_vs_cluster", "rel_rmse_frame0_vs_k1_band"):
        if not out[key] < REL_RMSE_TOL:
            raise AssertionError(f"atrium_big x{INSTANCES} {key}: {out[key]}")
    return out, counts


def post_program():
    """bench.py's post pass: simple ACES as a ComputeProgram."""
    from hala_tpu_torch.programs import ComputeProgram, ComputeProgramDesc

    return ComputeProgram(ComputeProgramDesc(
        shader_file_path="hala_tpu_torch.ops.tonemap:tonemap_aces_simple"))


def run_raster(r, name: str, card: str):
    """bench.py's raster timing: one warm-up frame, then timed frames
    ending in a synchronize; the band is checked on the mean of the
    post-processed color."""
    import torch

    from bench import check_invariants

    r.commit()
    r.update()
    torch.cuda.synchronize()
    frames = RASTER_FRAMES[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(frames):
        r.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    img = r.color
    if img.shape != (r.info.height, r.info.width, 3) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"{name}: bad image {tuple(img.shape)}")
    mean = float(img[..., :3].mean())
    check_invariants(name, mean)
    out = dict(mean=mean, ms_per_frame=dt / frames * 1e3, frames=frames,
               peak_bytes=peak)
    log(f"  {name} {r.info.width}x{r.info.height}: image mean {mean:.4f}, "
        f"{out['ms_per_frame']:.2f} ms/frame over {frames} frames [{card}]; "
        f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    return out


def raster_stages(r, reps: int, card: str):
    """Device time of each stage of one raster_atrium frame, each stage
    run alone on the renderer's scene with CUDA events: vertex setup,
    binning glue, K3, untile + divide, shading, post pass."""
    from hala_tpu_torch.models.rz_renderer import _raster_setup, _shade
    from hala_tpu_torch.ops import raster_kernel as k3

    st = r.settings
    w, h = st.width, st.height
    tris = _raster_setup(r.scene, 0, st)[:4]
    seg = k3.build_segments(*tris, w, h, st.tile)
    args = (seg.starts, seg.data, seg.tw, seg.tile)
    planes = k3.raster_segments(*args)
    frag = k3.segments_to_fragments(planes, seg, w, h)
    cam = r.scene.cameras.position[0]
    color = _shade(r.scene, frag, cam)[0].reshape(h, w, 3)
    stages = {
        "vertex setup": lambda: _raster_setup(r.scene, 0, st),
        "binning glue": lambda: k3.build_segments(*tris, w, h, st.tile),
        "K3": lambda: k3.raster_segments(*args),
        "untile + divide": lambda: k3.segments_to_fragments(planes, seg, w, h),
        "shade": lambda: _shade(r.scene, frag, cam),
        "post": lambda: r.post_program.dispatch(color),
    }
    out = {name: cuda_ms(fn, reps) for name, fn in stages.items()}
    log("  raster_atrium stages, device ms alone [" + card + "]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f"; sum {sum(out.values()):.3f}")
    return out


def profile_frames(label: str, step, frames: int, wall_ms: float, card: str):
    """torch.profiler over `frames` warm calls of `step` (one frame
    each): device time by kernel (kernel events only), and the busy
    share of the unprofiled frame time `wall_ms`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue  # host ops: their device time is their kernels'
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / frames, ev.count / frames, ev.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    launches = sum(c for _, c, _ in rows)
    log(f"  profile {label}, {frames} frames: kernels {busy:.3f} ms and "
        f"{launches:.0f} launches per frame; busy share of the unprofiled "
        f"{wall_ms:.2f} ms/frame: {busy / wall_ms:.3f} [{card}]")
    for ms, count, key in rows[:12]:
        log(f"    {ms:9.3f} ms/frame  {count:7.1f}/frame  {key[:90]}")
    return dict(busy_ms=busy, kernels_per_frame=launches,
                busy_share=busy / wall_ms,
                top=[dict(ms=ms, per_frame=c, kernel=k[:120])
                     for ms, c, k in rows[:12]])


# ---------------------------------------------------------------------------
# procedural spheres and pushed kernels
# ---------------------------------------------------------------------------


def procedural_scene():
    """examples/render_procedural.py's scene on the port: the Cornell box
    and three spheres (diffuse, Disney metal, emissive)."""
    from hala_tpu_torch import Material, MaterialType, ProceduralSphere
    from hala_tpu_torch.scene.procedural import cornell_box

    scene = cornell_box()
    blue = Material(base_color=np.array([0.2, 0.4, 0.9], np.float32))
    metal = Material(type=MaterialType.DISNEY,
                     base_color=np.array([0.95, 0.85, 0.6], np.float32),
                     metallic=1.0, roughness=0.15)
    glow = Material(base_color=np.array([1.0, 1.0, 1.0], np.float32),
                    emission=np.array([6.0, 3.0, 1.5], np.float32))
    for mat, center, radius in ((blue, (-0.45, -0.65, 0.1), 0.35),
                                (metal, (0.45, -0.7, -0.2), 0.30),
                                (glow, (0.0, 0.35, -0.4), 0.15)):
        scene.materials.append(mat)
        scene.procedurals.append(ProceduralSphere(center=center, radius=radius,
                                                  material=len(scene.materials) - 1))
    return scene


def frame0(r, intersector: str | None = None):
    """Frame 0 of renderer r's settings (or through `intersector`) on a
    fresh film: its RGB."""
    import torch

    from hala_tpu_torch.models.integrator import Film, render_frame

    st = r.settings if intersector is None else dataclasses.replace(
        r.settings, intersector=intersector)
    film = Film.create(st.width, st.height, r.device)
    render_frame(r.scene, None, r.uniforms, film, 0, st, hooks=r.hooks)
    torch.cuda.synchronize()
    return film.accum[..., :3]


def procedural_render(card: str, frames: int = 16, size=(512, 512), device="cuda"):
    """examples/render_procedural.py's scene through RayTracingRenderer
    "auto" (K1): two warm-up frames, `frames` timed frames (Mrays/s,
    ms/frame, K1 launches), gates: rays above 1.2x camera rays, the film
    mean within PROCEDURAL_BAND of PROCEDURAL_MEAN, frame 0 against the
    plain brute force's frame 0 (relative RMSE 2e-3); then a
    torch.profiler window over one more frame (the busy share)."""
    import torch

    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.ops import cuda_lib

    r = RayTracingRenderer("procedural", *size, max_depth=6, rr_depth=2, device=device)
    r.set_scene(procedural_scene())
    r.commit()
    r.render_loop(2)
    torch.cuda.synchronize()
    r.reset_accumulation()
    r.total_rays = 0.0
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    r.render_loop(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = cuda_lib.launches()
    if not (counts["intersect_bruteforce"] > 0
            and sum(counts.values()) == counts["intersect_bruteforce"]):
        raise AssertionError(f"procedural launches {counts}")
    accum = r.film.accum[..., :3]
    primaries = size[0] * size[1] * frames
    out = dict(mean=float(accum.mean()), rays_per_primary=r.total_rays / primaries,
               mrays_per_s=r.total_rays / dt / 1e6, ms_per_frame=dt / frames * 1e3,
               k1_launches=counts["intersect_bruteforce"],
               frame0_rel_rmse_vs_plain=rel_rmse(frame0(r), frame0(r, "bruteforce")))
    if not bool(torch.isfinite(accum).all()) or not out["rays_per_primary"] > 1.2:
        raise AssertionError(f"procedural: {out}")
    if not abs(out["mean"] - PROCEDURAL_MEAN) <= PROCEDURAL_BAND * PROCEDURAL_MEAN:
        raise AssertionError(f"procedural: film mean {out['mean']} outside "
                             f"{PROCEDURAL_MEAN} +- {PROCEDURAL_BAND:.1%}")
    if not out["frame0_rel_rmse_vs_plain"] < REL_RMSE_TOL:
        raise AssertionError(f"procedural frame 0 vs plain: {out}")
    log(f"  procedural {size[0]}x{size[1]}x{frames}f: film mean {out['mean']:.5f} "
        f"(JAX on the CPU {PROCEDURAL_MEAN}), rays/primary "
        f"{out['rays_per_primary']:.3f}; {out['mrays_per_s']:.2f} Mrays/s, "
        f"{out['ms_per_frame']:.2f} ms/frame, K1 {out['k1_launches']} launches; "
        f"frame 0 vs the plain brute force: relative RMSE "
        f"{out['frame0_rel_rmse_vs_plain']:.3g} [{card}]")
    out["profile"] = profile_frames("procedural", lambda: r.render_loop(1), 1,
                                    out["ms_per_frame"], card)
    return out


def with_spheres_on_view_axis(host, dev_scene):
    """A copy of host scene `host` with three diffuse spheres on its
    first camera's view axis, at 0.3, 0.5 and 0.7 of the distance t0 to
    the first surface along it (radii 0.05, 0.07, 0.09 t0, set off
    sideways by -0.12, 0, 0.12 t0); t0 from K2 on `dev_scene`."""
    import copy

    import torch

    from hala_tpu_torch import Material, ProceduralSphere
    from hala_tpu_torch.ops import traverse

    node = next(n for n in host.nodes if n.camera_index is not None)
    w = np.asarray(node.world_transform, np.float64)
    pos, right, fwd = w[:3, 3], w[:3, 0] / np.linalg.norm(w[:3, 0]), -w[:3, 2]
    fwd = fwd / np.linalg.norm(fwd)
    dev = dev_scene.geometry.tri_v0.device
    hit = traverse.intersect_matrix(
        torch.tensor(pos[None], dtype=torch.float32, device=dev),
        torch.tensor(fwd[None], dtype=torch.float32, device=dev), dev_scene.geometry)
    t0 = float(hit.t[0])
    if not (hit.tri[0] >= 0 and np.isfinite(t0)):
        raise AssertionError("the camera's view axis hits nothing")
    out = copy.copy(host)
    out.materials = list(host.materials)
    out.procedurals = []
    for i, (at, rad, side) in enumerate(((0.3, 0.05, -0.12), (0.5, 0.07, 0.0),
                                         (0.7, 0.09, 0.12))):
        out.materials.append(Material(base_color=np.array(
            [0.8, 0.3 + 0.2 * i, 0.2], np.float32)))
        c = pos + fwd * (at * t0) + right * (side * t0)
        out.procedurals.append(ProceduralSphere(center=tuple(float(x) for x in c),
                                                radius=rad * t0,
                                                material=len(out.materials) - 1))
    return out, t0


def spheres_render(host, card: str, frames: int = 2, size=(1920, 1088), device="cuda"):
    """atrium_big with three spheres on the view axis (`with_spheres_on_
    view_axis`), 1 spp, depth 4, rr 2: the share of primary hits on the
    spheres (>= SPHERE_SHARE_MIN), then "auto" (K2 sorted; bench.py's
    sponza invariants) and "traverse" (K4, K5, K6; the same), each a
    warm-up frame and `frames` timed frames, the traverse frame 0
    against one "cluster" frame (relative RMSE 2e-3)."""
    import torch

    from hala_tpu_torch.models import integrator
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.ops import cuda_lib
    from hala_tpu_torch.ops.prims import PROC_BASE
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    base = SceneUploader.upload(host, device=device)
    scene, t0 = with_spheres_on_view_axis(host, base)
    del base
    out = dict(view_axis_t0=t0)
    for label, sel in (("auto", "auto"), ("traverse", "traverse")):
        r = RayTracingRenderer(f"atrium_big_spheres_{label}", *size, max_depth=4,
                               rr_depth=2, spp=1, intersector=sel, device=device)
        r.set_scene(scene)
        r.commit()
        if label == "auto":
            o, d = camera_rays(r.scene, *size, seed=7)
            hit = integrator._intersect(r.scene, o, d, r.settings)
            out["sphere_share"] = float((hit.tri >= PROC_BASE).float().mean())
            out["hit_share"] = float((hit.tri >= 0).float().mean())
            if not out["sphere_share"] >= SPHERE_SHARE_MIN:
                raise AssertionError(f"spheres on atrium_big: {out}")
        first = warm_up(r)
        cuda_lib.reset_launches()
        rec = run_render(r, frames, frames, f"atrium_big + spheres {label}", card,
                         cell="sponza")
        rec["launches"] = cuda_lib.launches()
        large = ("cull_topk", "traverse_candidates", "cluster_stream")
        if label == "auto":
            ok = rec["launches"]["matrix_traverse"] > 0 and not any(
                rec["launches"][k] for k in large)
        else:
            ok = all(rec["launches"][k] > 0 for k in large) and not rec["launches"][
                "matrix_traverse"]
            rec["frame0_rel_rmse_vs_cluster"] = rel_rmse(first, frame0(r, "cluster"))
            ok = ok and rec["frame0_rel_rmse_vs_cluster"] < REL_RMSE_TOL
        if not ok:
            raise AssertionError(f"atrium_big + spheres {label}: {rec}")
        out[label] = rec
        del r
    log(f"  atrium_big + spheres: {out['sphere_share']:.4f} of primary rays hit a "
        f"sphere ({out['hit_share']:.4f} hit anything), launches auto "
        f"{out['auto']['launches']}, traverse {out['traverse']['launches']}; "
        f"traverse frame 0 vs cluster: relative RMSE "
        f"{out['traverse']['frame0_rel_rmse_vs_cluster']:.3g} [{card}]")
    return out


def _identity_kernels():
    """name -> kernel: an identity on every seam of RayTracingProgram."""
    return {
        "chip_smoke:identity_raygen": lambda gpix, fidx, r_jit: r_jit,
        "chip_smoke:identity_miss": lambda d, uniforms, default: default,
        "chip_smoke:identity_post_shade": lambda L, alb, nrm: (L, alb, nrm),
        "chip_smoke:identity_closest_hit": lambda ctx, mp: mp,
        "chip_smoke:identity_any_hit": lambda ctx, mp, r, default_pass: default_pass,
        "chip_smoke:identity_intersection": lambda o, d, lhit: lhit,
    }


HOOK_MISS = (0.0, 5.0, 0.0)     # the constant miss kernel's radiance
HOOK_ALBEDO = (1.0, 0.0, 0.0)   # the base color the closest-hit kernel forces


def hooks_render(card: str, frames: int = 8, size=(512, 512), device="cuda"):
    """The Cornell box through RayTracingProgram (depth 4), frames 0 and
    1: the builtin desc; the desc with identity kernels on every seam
    (equal bit for bit); one with a constant miss kernel (HOOK_MISS: the
    film's green mean rises, the albedo AOV stays bit for bit); one with
    a closest-hit kernel forcing the base color (HOOK_ALBEDO: the film
    changes, the albedo AOV is HOOK_ALBEDO times the share of frames
    whose camera ray met a surface first, so its green and blue are 0
    and its red positive on every such pixel). Each desc then `frames`
    timed frames (ms/frame)."""
    import torch

    from hala_tpu_torch.models.integrator import Film, Uniforms
    from hala_tpu_torch.ops import cuda_lib
    from hala_tpu_torch.programs import KernelCache, RayTracingProgram, RayTracingProgramDesc
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box

    cache = KernelCache.get_instance()
    kernels = _identity_kernels()
    kernels["chip_smoke:green_miss"] = lambda d, uniforms, default: torch.tensor(
        HOOK_MISS, device=default.device).expand_as(default)
    kernels["chip_smoke:forced_albedo"] = lambda ctx, mp: mp._replace(
        base_color=torch.tensor(HOOK_ALBEDO, device=mp.base_color.device).expand_as(
            mp.base_color))
    for name, fn in kernels.items():
        cache.from_memory(name, fn)
    scene = SceneUploader.upload(cornell_box(), device=device)
    uni = Uniforms.default(device)
    ident = [k for k in kernels if "identity" in k]
    descs = {
        "builtin": RayTracingProgramDesc(ray_recursion_depth=4),
        "identity": RayTracingProgramDesc(
            ray_recursion_depth=4, ray_gen_shader_file_path=ident[0],
            miss_shader_file_paths=[ident[1]], callable_shader_file_paths=[ident[2]],
            hit_shader_file_paths=ident[3:6]),
        "miss": RayTracingProgramDesc(
            ray_recursion_depth=4, miss_shader_file_paths=["chip_smoke:green_miss"]),
        "closest_hit": RayTracingProgramDesc(
            ray_recursion_depth=4, hit_shader_file_paths=["chip_smoke:forced_albedo"]),
    }
    out, films = {}, {}
    try:
        for label, desc in descs.items():
            prog = RayTracingProgram(desc, scene)
            film = Film.create(*size, device)
            for f in range(2):
                prog.trace_rays(film, *size, frame_index=f, uniforms=uni)
            torch.cuda.synchronize()
            films[label] = film
            timed = Film.create(*size, device)
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            for f in range(frames):
                prog.trace_rays(timed, *size, frame_index=f, uniforms=uni)
            torch.cuda.synchronize()
            out[label] = dict(ms_per_frame=(time.perf_counter() - t0) / frames * 1e3,
                              k1_launches=cuda_lib.launches()["intersect_bruteforce"])
    finally:
        for name in kernels:
            cache.remove(name)
    a, b = films["builtin"], films["identity"]
    m, c = films["miss"], films["closest_hit"]
    for k in ("accum", "albedo", "normal"):
        if not torch.equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"identity kernels changed the film's {k}")
    surface = a.albedo[..., :3].abs().sum(-1) > 0  # a surface met first
    out.update(
        identity_equal=True, surface_share=float(surface.float().mean()),
        green_mean=[float(a.accum[..., 1].mean()), float(m.accum[..., 1].mean())],
        albedo_forced=bool((c.albedo[..., 1:3] == 0).all()
                           and (c.albedo[..., 0][surface] > 0).all()
                           and torch.equal(c.albedo[..., 0] > 0, surface)))
    if not (out["surface_share"] > 0.5 and out["albedo_forced"]
            and out["green_mean"][1] > out["green_mean"][0]
            and torch.equal(a.albedo, m.albedo)
            and not torch.equal(a.accum, c.accum)):
        raise AssertionError(f"hooks: {out}")
    log(f"  hooks, Cornell {size[0]}x{size[1]} through RayTracingProgram: identity "
        f"kernels on every seam give the hookless film bit for bit; the miss kernel "
        f"raises the film's green mean {out['green_mean'][0]:.4f} -> "
        f"{out['green_mean'][1]:.4f}, the closest-hit kernel forces the albedo AOV "
        f"on the {out['surface_share']:.4f} of pixels a surface meets first; "
        f"ms/frame builtin {out['builtin']['ms_per_frame']:.2f}, identity "
        f"{out['identity']['ms_per_frame']:.2f}, miss "
        f"{out['miss']['ms_per_frame']:.2f}, closest hit "
        f"{out['closest_hit']['ms_per_frame']:.2f} [{card}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; "
              "this smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hala_tpu_torch.envmap import EnvMap
    from hala_tpu_torch.ops import cuda_lib
    from hala_tpu_torch.ops import traverse as k5
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
    from hala_tpu_torch.scene.cpu.scene import Scene
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box, random_triangle_soup
    from hala_tpu_torch.utils.pfm import read_pfm

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    dev = torch.device("cuda", 0)

    log("== phase 1: card and versions")
    card = card_line()
    log(card)
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 2: build the CUDA kernels")
    cuda_lib.build(verbose=True)
    log(f"  built {cuda_lib.LIB_PATH} in {cuda_lib.build_seconds:.1f} s")

    log("== phase 3: kernels against their plain versions")
    cornell_dev = SceneUploader.upload(cornell_box(), device=dev)
    soup_dev = SceneUploader.upload(random_triangle_soup(300, seed=3), device=dev)
    soup4k_dev = SceneUploader.upload(random_triangle_soup(4096, seed=4), device=dev)
    big_host = Scene.load(os.path.join(HERE, "assets", "atrium_big.glb"))
    big_dev = SceneUploader.upload(big_host, device=dev)
    k1_rec = check_k1(cornell_dev, soup_dev, soup4k_dev, 2 * 512 * 512, 77, reps=20)
    small = mixed_batch(big_dev, 256, 128, 32768, 31)
    big = mixed_batch(big_dev, 1024, 1024, 1 << 20, 33)
    k2_rec = check_k2(big_dev, small, big, reps=6)
    k3_rec = check_k3(big_dev, reps=10)
    k3_skip = check_k3_skip_table(dev, reps=10)
    k4_rec = check_k4(big_dev, small, big, reps=5)
    k5_rec, k6_rec, graze_k2 = check_k5_k6(big_dev, small, big, reps=5)
    k7_rec, k8_rec = check_k7_k8(big_dev, small, big, reps=5)
    graze_span = check_k2_grazing(dev)
    del big_dev, small, big
    x5_host, x5_dev, x5_upload_s, _ = upload_instances(big_host, dev)
    wide_rec = check_past_key_width(x5_dev, 32768)
    k4_x5, k6_x5 = check_instances(x5_dev, reps=3)
    wide_rec.update(upload_s=x5_upload_s)
    del x5_dev
    golden_renders(dev)
    golden_raster(dev)

    log("== phases 4-6: the main path")
    cornell = RayTracingRenderer("cornell", 512, 512, max_depth=4, rr_depth=2,
                                 device="cuda")
    cornell.set_scene(cornell_box())
    cornell.commit()
    sponza = RayTracingRenderer("sponza", 1920, 1088, max_depth=4, rr_depth=2,
                                spp=1, device="cuda")
    sponza.set_scene(big_host)
    sponza.commit()
    warm_up(cornell)
    k2_frame0 = warm_up(sponza)
    cuda_lib.reset_launches()
    c_out = run_render(cornell, 16, 16, "cornell", card)
    after_cornell = cuda_lib.launches()
    if not (after_cornell["intersect_bruteforce"] > 0
            and after_cornell["matrix_traverse"] == 0
            and after_cornell["raster_tiled"] == 0):
        raise AssertionError(f"cornell launches {after_cornell}")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    s_out = run_render(sponza, 4, 4, "sponza", card)
    after_sponza = cuda_lib.launches()
    large = ("cull_topk", "traverse_candidates", "cluster_stream")
    if after_sponza["matrix_traverse"] <= 0 or any(after_sponza[k] for k in large):
        raise AssertionError(f"atrium_big launches {after_sponza}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches: cornell {after_cornell}, atrium_big {after_sponza}; "
        f"atrium_big peak memory {peak / 2**30:.2f} GiB [{card}]")

    trav = RayTracingRenderer("atrium_big_traverse", 1920, 1088, max_depth=4,
                              rr_depth=2, spp=1, intersector="traverse",
                              device="cuda")
    trav.set_scene(big_host)
    trav.commit()
    trav_frame0 = warm_up(trav)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t_out = run_render(trav, 4, 4, "atrium_big traverse", card, cell="sponza")
    after_trav = cuda_lib.launches()
    t_peak = torch.cuda.max_memory_allocated()
    if not (all(after_trav[k] > 0 for k in large)
            and after_trav["matrix_traverse"] == 0
            and after_trav["intersect_bruteforce"] == 0):
        raise AssertionError(f"atrium_big traverse launches {after_trav}")
    # The K2 render splits its shadow rays into an any-hit query whose
    # range the reference shortens by a second factor (1 - 1e-4); the
    # traverse and cluster engines answer them in the batched closest
    # hit, as the JAX package does. So their estimator differs from K2's
    # there: the relative RMSE to the K2 film is reported, and the gates
    # are the cluster engine's frame 0 and, below, a band of frame 0
    # through the brute-force kernel K1 (batched shadow rays, no
    # clusters at all).
    t_out["rel_rmse_vs_k2"] = rel_rmse(trav.film.accum[..., :3],
                                       sponza.film.accum[..., :3])
    # one more K2 frame, profiled (after the comparison of the two films)
    s_prof = profile_frames("atrium_big K2 sorted", lambda: sponza.render_loop(1), 1,
                            s_out["ms_per_frame"], card)
    t_out["peak_bytes"] = t_peak
    t_prof = profile_frames("atrium_big traverse", lambda: trav.render_loop(1), 1,
                            t_out["ms_per_frame"], card)
    # The engine's counts, from one more frame outside the timed window
    # (each query adds three device reductions while they are on).
    k5.stats.reset()
    k5.stats.enabled = True
    trav.render_loop(1)
    torch.cuda.synchronize()
    k5.stats.enabled = False
    t_out.update(k5.stats.summary())
    log(f"  atrium_big traverse: film relative RMSE vs the K2 render "
        f"{t_out['rel_rmse_vs_k2']:.3g} (its shadow rays end 1e-4 earlier); "
        f"{t_out['unresolved_share']:.4f} of live rays unresolved by K5, "
        f"{t_out['visits_per_ray']:.2f} clusters visited per live ray over "
        f"{t_out['queries']} queries of one frame; launches {after_trav}; peak memory "
        f"{t_peak / 2**30:.2f} GiB [{card}]")
    del trav
    clus = RayTracingRenderer("atrium_big_cluster", 1920, 1088, max_depth=4,
                              rr_depth=2, spp=1, intersector="cluster",
                              device="cuda")
    clus.set_scene(big_host)
    clus.commit()
    cuda_lib.reset_launches()
    cl_out = run_render(clus, 1, 1, "atrium_big cluster", card, cell="sponza")
    after_clus = cuda_lib.launches()
    if not (after_clus["cluster_stream"] > 0
            and sum(after_clus.values()) == after_clus["cluster_stream"]):
        raise AssertionError(f"atrium_big cluster launches {after_clus}")
    t_out["rel_rmse_frame0_vs_cluster"] = rel_rmse(trav_frame0,
                                                   clus.film.accum[..., :3])
    log(f"  launches: atrium_big cluster {after_clus}; frame 0 of the traverse "
        f"render vs the cluster render: relative RMSE "
        f"{t_out['rel_rmse_frame0_vs_cluster']:.3g}")
    if not t_out["rel_rmse_frame0_vs_cluster"] < REL_RMSE_TOL:
        raise AssertionError("traverse frame 0 vs cluster: relative RMSE "
                             f"{t_out['rel_rmse_frame0_vs_cluster']}")
    del clus
    witness = shadow_range_witness(sponza, trav_frame0, k2_frame0, card)
    x5_out, after_x5 = instances_render(x5_host, 2, card)

    # The same K2 render without matrix_query's coherence sort, before
    # and after a second sorted window: K2 is exact under any order, so
    # the films must be equal bit for bit.
    unsorted = RayTracingRenderer("sponza_unsorted", 1920, 1088, max_depth=4,
                                  rr_depth=2, spp=1, device="cuda")
    unsorted.set_scene(big_host)
    unsorted.commit()
    unsorted.settings = dataclasses.replace(unsorted.settings, sort_rays=False)
    warm_up(unsorted)
    u_out = run_render(unsorted, 2, 2, "atrium_big K2 unsorted", card, cell="sponza")
    k2_two = unsorted.film.accum[..., :3].clone()
    sponza.reset_accumulation()
    sponza.total_rays = 0.0
    s2_out = run_render(sponza, 2, 2, "atrium_big K2 sorted", card, cell="sponza")
    if not torch.equal(sponza.film.accum, unsorted.film.accum):
        raise AssertionError("the coherence sort changed the K2 film")
    unsorted.reset_accumulation()
    unsorted.total_rays = 0.0
    u2_out = run_render(unsorted, 2, 2, "atrium_big K2 unsorted", card, cell="sponza")
    sort_out = dict(unsorted_ms=[u_out["ms_per_frame"], u2_out["ms_per_frame"]],
                    sorted_ms=[s_out["ms_per_frame"], s2_out["ms_per_frame"]])
    log(f"  K2 frame with / without the coherence sort: sorted "
        f"{sort_out['sorted_ms'][0]:.1f} and {sort_out['sorted_ms'][1]:.1f} "
        f"ms/frame, unsorted {sort_out['unsorted_ms'][0]:.1f} and "
        f"{sort_out['unsorted_ms'][1]:.1f}; films equal bit for bit [{card}]")
    del unsorted

    # The grouped and the wavefront engine, and the matrix backend with
    # its shadow and bounce rays routed to the wavefront (K 8).
    g_out, after_grouped, r = family_render(
        "atrium_big grouped", big_host, 1, k2_frame0, card, intersector="grouped")
    if not (after_grouped["grouped_walk"] > 0 and after_grouped["matrix_traverse"] > 0
            and after_grouped["wavefront_walk"] == 0 and after_grouped["cull_topk"] == 0):
        raise AssertionError(f"atrium_big grouped launches {after_grouped}")
    del r
    w_out, after_wave, wave = family_render(
        "atrium_big wavefront", big_host, 2, k2_two, card, intersector="wavefront")
    if not (after_wave["wavefront_walk"] > 0 and after_wave["cull_topk"] > 0
            and after_wave["matrix_traverse"] > 0 and after_wave["grouped_walk"] == 0):
        raise AssertionError(f"atrium_big wavefront launches {after_wave}")
    w_prof = profile_frames("atrium_big wavefront", lambda: wave.render_loop(1), 1,
                            w_out["ms_per_frame"], card)
    del wave
    x_out, after_mixed, r = family_render(
        "atrium_big matrix + wavefront shadow/extend", big_host, 2, k2_two, card,
        intersector="matrix", shadow_intersector="wavefront",
        extend_intersector="wavefront")
    if not all(after_mixed[k] > 0 for k in ("matrix_traverse", "cull_topk",
                                            "wavefront_walk")):
        raise AssertionError(f"matrix + wavefront routes launches {after_mixed}")
    del r

    # bench.py's envmap configuration through K1, and a short render
    # with a seeded blue-noise texture.
    envr = RayTracingRenderer("envmap", 512, 512, max_depth=4, rr_depth=2,
                              device="cuda")
    envr.set_scene(cornell_box(light_intensity=0.0))
    envr.set_envmap(EnvMap.from_array(bench_envmap_array(), device="cuda"))
    envr.commit()
    warm_up(envr)
    cuda_lib.reset_launches()
    e_out = run_render(envr, 16, 16, "envmap", card)
    after_env = cuda_lib.launches()
    if not (after_env["intersect_bruteforce"] > 0
            and sum(after_env.values()) == after_env["intersect_bruteforce"]):
        raise AssertionError(f"envmap launches {after_env}")
    bn = RayTracingRenderer("cornell_blue_noise", 256, 256, max_depth=4, rr_depth=2,
                            device="cuda")
    bn.set_scene(cornell_box())
    bn.blue_noise = torch.rand((64, 64, 4), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(5))
    bn.commit()
    bn_out = run_render(bn, 4, 4, "cornell blue noise", card, cell="cornell")
    log(f"  launches: envmap {after_env}")
    del envr, bn

    # procedural spheres (K1 on the Cornell box, K2 and K4-K6 on
    # atrium_big) and pushed kernels through RayTracingProgram (K1)
    proc_out = procedural_render(card)
    spheres_out = spheres_render(big_host, card)
    hooks_out = hooks_render(card)

    post = post_program()
    ra = RasterizationRenderer("raster_atrium", 1920, 1088, binned=True, tile=64,
                               post_program=post, device="cuda")
    ra.set_scene(big_host)
    cuda_lib.reset_launches()
    ra_out = run_raster(ra, "raster_atrium", card)
    after_ra = cuda_lib.launches()
    frames_ra = RASTER_FRAMES["raster_atrium"] + 1
    if after_ra["raster_tiled"] != frames_ra:
        raise AssertionError(f"raster_atrium launches {after_ra}, expected "
                             f"{frames_ra} of raster_tiled")
    rc = RasterizationRenderer("raster", 1920, 1088, binned=True, tile=64,
                               post_program=post, device="cuda")
    rc.set_scene(cornell_box())
    cuda_lib.reset_launches()
    rc_out = run_raster(rc, "raster", card)
    after_rc = cuda_lib.launches()
    if any(after_rc.values()):
        raise AssertionError(f"raster (Cornell) launches {after_rc}")
    log(f"  launches: raster_atrium {after_ra}, raster {after_rc}")
    ra_stages = raster_stages(ra, 5, card)
    ra_prof = profile_frames("raster_atrium", ra.update, 3, ra_out["ms_per_frame"],
                             card)

    log("== phase 7: save_images")
    with tempfile.TemporaryDirectory() as tmp:
        for r in (cornell, sponza):
            stem = os.path.join(tmp, r.info.name)
            r.save_images(stem + ".pfm")
            for kind in ("color", "albedo", "normal"):
                img = read_pfm(f"{stem}_{kind}.pfm")
                if img.shape != (r.info.height, r.info.width, 3) or not np.isfinite(img).all():
                    raise AssertionError(f"{stem}_{kind}.pfm: bad image {img.shape}")
        ra.save_image(os.path.join(tmp, "raster_atrium.pfm"))
        img = read_pfm(os.path.join(tmp, "raster_atrium.pfm"))
        if img.shape != (1088, 1920, 3) or not np.isfinite(img).all():
            raise AssertionError(f"raster_atrium.pfm: bad image {img.shape}")
    log("  PFMs finite")

    def entry(name, source, replaces, launches, rec):
        out = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=launches, max_abs_err=rec["max_abs_err"],
                   ms=rec["ms"], plain_ms=rec["plain_ms"],
                   bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                   library_ms=rec.get("library_ms"))
        if "ms_unsorted" in rec:  # K2, K5: ms on the coherence-sorted batch
            out["ms_unsorted"] = rec["ms_unsorted"]
        return out

    per_query = k4_x5["launches_per_query"]
    kernels = [
        # K1: the Cornell batch, and the 4096-triangle soup beside it
        dict(entry("intersect_bruteforce (K1)",
                   "hala_tpu_torch/csrc/intersect_bruteforce.cu",
                   "hala_tpu/ops/pallas/intersect_kernel.py:182",
                   after_cornell["intersect_bruteforce"], k1_rec),
             **{k: v for k, v in k1_rec.items() if k.endswith("_soup4096")}),
        entry("matrix_traverse (K2)", "hala_tpu_torch/csrc/matrix_traverse.cu",
              "hala_tpu/ops/traverse.py:1591",
              after_sponza["matrix_traverse"], k2_rec),
        # K3: beside the bound, the pairs its sub-tile skip leaves
        dict(entry("raster_tiled (K3)", "hala_tpu_torch/csrc/raster_tiled.cu",
                   "hala_tpu/ops/raster_kernel.py:309",
                   after_ra["raster_tiled"], k3_rec),
             subtile_pairs=k3_rec["subtile_pairs"],
             subtile_bound_ms=k3_rec["subtile_bound_ms"],
             skip_table_ms=k3_skip["ms"]),
        # K4-K6: launches where "auto" runs them (the five instances),
        # K4 per launch (a query's two superchunk launches, halved)
        dict(entry("cull_topk (K4)", "hala_tpu_torch/csrc/cull_topk.cu",
                   "hala_tpu/ops/cull.py:237", after_x5["cull_topk"], dict(
                       k4_x5, ms=k4_x5["query_ms"] / per_query,
                       plain_ms=k4_x5["plain_query_ms"] / per_query,
                       bound_ms=k4_x5["bound_ms"] / per_query, library_ms=None)),
             query_ms=k4_x5["query_ms"], launches_per_query=per_query,
             ms_atrium_big=k4_rec["ms"], ms_atrium_big_unsorted=k4_rec["ms_unsorted"],
             bound_ms_atrium_big=k4_rec["bound_ms"],
             library_ms_atrium_big=k4_rec["library_ms"]),
        entry("traverse_candidates (K5)",
              "hala_tpu_torch/csrc/traverse_candidates.cu",
              "hala_tpu/ops/traverse.py:463",
              after_x5["traverse_candidates"], k5_rec),
        dict(entry("cluster_stream (K6)", "hala_tpu_torch/csrc/cluster_stream.cu",
                   "hala_tpu/ops/cluster.py:285", after_x5["cluster_stream"], k6_x5),
             ms_atrium_big=k6_rec["ms"], ms_atrium_big_unsorted=k6_rec["ms_unsorted"],
             bound_ms_atrium_big=k6_rec["bound_ms"],
             full_range_ms_atrium_big=k6_rec["full_ms"],
             full_range_ms=k6_x5["full_ms"]),
        # K7, K8: beside the bound from the spans the rays enter, the old
        # one from every pair of the tested entries
        dict(entry("wavefront_walk (K7)", "hala_tpu_torch/csrc/wavefront_walk.cu",
                   "hala_tpu/ops/wavefront.py:287", after_wave["wavefront_walk"], k7_rec),
             old_bound_ms=k7_rec["old_bound_ms"], anyhit_ms=k7_rec["anyhit_ms"],
             warp_span_fill=k7_rec["warp_span_fill"]),
        dict(entry("grouped_walk (K8)", "hala_tpu_torch/csrc/grouped_walk.cu",
                   "hala_tpu/ops/traverse.py:2013", after_grouped["grouped_walk"], k8_rec),
             old_bound_ms=k8_rec["old_bound_ms"], anyhit_ms=k8_rec["anyhit_ms"],
             warp_span_fill=k8_rec["warp_span_fill"]),
    ]
    summary = dict(card=card, cornell=c_out, atrium_big=s_out,
                   atrium_big_peak_bytes=peak, atrium_big_profile=s_prof,
                   raster_atrium=ra_out,
                   raster=rc_out, raster_atrium_profile=ra_prof,
                   raster_atrium_stages=ra_stages,
                   atrium_big_traverse_profile=t_prof,
                   k1_rays=k1_rec["rays"], k2_rays=k2_rec["rays"],
                   k2_anyhit_ms=k2_rec["anyhit_ms"],
                   k2_runs=k2_rec["runs"], k2_small_work=k2_rec["small_work"],
                   k2_times=k2_rec["times"], k2_small_bound_ms=k2_rec["small_bound_ms"],
                   k2_big_work=k2_rec["big_work"],
                   k1_all_slots_on_atrium_big_ms=k2_rec["k1_ms"],
                   k5_times=k5_rec["times"],
                   k3_glue_ms=k3_rec["glue_ms"], k3_n_real=k3_rec["n_real"],
                   k3_longest_segment=k3_rec["longest"],
                   k3_subtile_pairs=k3_rec["subtile_pairs"],
                   k3_subtile_bound_ms=k3_rec["subtile_bound_ms"],
                   k3_skip_table=k3_skip,
                   atrium_big_traverse=t_out, atrium_big_cluster=cl_out,
                   k4_rays=k4_rec["rays"], k4_truncated=k4_rec["truncated"],
                   k4_atrium_big=k4_rec, k4_x5=k4_x5, k6_atrium_big=k6_rec,
                   k6_x5=k6_x5, atrium_big_x5=x5_out,
                   atrium_big_traverse_launches=after_trav,
                   k5_visits=k5_rec["visited"], k5_mt_pairs=k5_rec["mt_pairs"],
                   k5_unresolved=k5_rec["unresolved"],

                   k5_tri_mismatches=k5_rec["tri_mismatches"],
                   k6_tri_mismatches=k6_rec["tri_mismatches"],
                   shadow_range_witness=witness,
                   traverse_cull_misses_vs_k2=graze_k2,
                   k2_grazing_beside_span=graze_span,
                   past_key_width=wide_rec,
                   k7=k7_rec, k8=k8_rec, k2_sort=sort_out,
                   atrium_big_grouped=g_out, atrium_big_wavefront=w_out,
                   atrium_big_wavefront_profile=w_prof,
                   atrium_big_matrix_wavefront_routes=x_out,
                   envmap=e_out, cornell_blue_noise=bn_out,
                   procedural=proc_out, atrium_big_spheres=spheres_out,
                   hooks=hooks_out,
                   build_s=cuda_lib.build_seconds)
    log("summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
