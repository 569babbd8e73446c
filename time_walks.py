#!/usr/bin/env python
"""Time the cluster kernels K2 (csrc/matrix_traverse.cu), K4
(csrc/cull_topk.cu), K5 (csrc/traverse_candidates.cu) and K6
(csrc/cluster_stream.cu) of one checkout of hala_tpu_torch on the
batches the main path hands them, on one NVIDIA GPU.

    python3 time_walks.py [--root DIR] [--reps N] [--profile]

`--root` names the checkout whose `hala_tpu_torch` is built and timed
(default: the one holding this script), so two checkouts can be timed
in turns within one process tree. The batches, the timer, the five
instances of atrium_big and the bounds (`k2_work`, `k4_work`,
`k5_work`; printed for this checkout only, as they need its plain
models) are this checkout's `chip_smoke.py` helpers: atrium_big's mixed
batches `small` (65,536 rays) and `big` (2^21), each unsorted and in
the coherence order `matrix_query` and the traverse engine give them
(`_coherence_key`, `order_by`), and a 2^21-ray mixed batch of the five
instances (above 8191 clusters: two K4 launches a query), sorted: K2
closest and any-hit (atrium_big only), K4 at K 12 (a query: one launch
per superchunk), K5 on its lists, K6 on the fallback's inputs
(t_max -inf for the rays K5 resolved) and on the full range of the
sorted 2^21 rays. `--profile` adds, for atrium_big at 1920x1088 (depth
4, 1 spp) through intersector "matrix" (K2 under the coherence sort),
"traverse" (K4, K5, K6) and "wavefront" (K4, K7, K2 as the fallback),
and for the five instances through "auto" ("traverse"), the time of
two frames after a warm-up frame and a torch.profiler window over one
more.

`--k1k3` times the brute-force kernel K1 (csrc/intersect_bruteforce.cu)
and the raster kernel K3 (csrc/raster_tiled.cu) of the checkout
instead: K1 closest and any-hit on chip_smoke's Cornell batch (524,288
mixed rays, 34 triangles) and on a 4096-triangle `random_triangle_soup`
with 524,288 live rays; K3 at the raster bench shape (atrium_big,
1920x1088, tile 64, bench camera) and on chip_smoke's skip-breaking
table; then the raster_atrium frame (RasterizationRenderer with the
ACES post pass, 10 frames after a warm-up). Prints one JSON line;
exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def smoke_helpers():
    spec = importlib.util.spec_from_file_location(
        "smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_k1_k3(S, host, dev, reps: int) -> dict:
    """K1 and K3 of the checkout on chip_smoke's inputs, and the
    raster_atrium frame."""
    import torch

    from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
    from hala_tpu_torch.ops import raster_kernel as k3
    from hala_tpu_torch.ops.pallas import intersect_kernel as k1
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box, random_triangle_soup

    out = {}
    n = 2 * 512 * 512
    for label, scene_host in (("cornell", cornell_box()),
                              ("soup4096", random_triangle_soup(4096, seed=4))):
        sc = SceneUploader.upload(scene_host, device=dev)
        g = sc.geometry
        if label == "cornell":
            side = int((n // 2) ** 0.5)
            o, d, tm = S.mixed_batch(sc, side, side, n - side * side, 11)
        else:
            o, d = S.random_rays(sc, n, 12)
            tm = torch.full((o.shape[0],), 3.0e38, device=dev)
        tris = (g.tri_v0, g.tri_e1, g.tri_e2)
        k = g.num_triangles
        out[f"k1_{label}_ms"] = S.cuda_ms(lambda: k1.intersect_pallas(
            o, d, *tris, t_max=tm, num_real=k), reps)
        out[f"k1_{label}_anyhit_ms"] = S.cuda_ms(lambda: k1.occluded_pallas(
            o, d, tm, *tris, num_real=k), reps)
    scene = SceneUploader.upload(host, device=dev)
    tile = 64
    tris = S.raster_inputs(scene, 1920, 1088, tile)
    seg = k3.build_segments(*tris, 1920, 1088, tile)
    out["k3_bench_ms"] = S.cuda_ms(lambda: k3.raster_segments(
        seg.starts, seg.data, seg.tw, seg.tile), reps)
    arrays = S.skip_breaking_triangles(256, 5200, 21)
    seg2 = k3.build_segments(*(torch.from_numpy(a).to(dev) for a in arrays),
                             256, 256, tile)
    out["k3_skip_table_ms"] = S.cuda_ms(lambda: k3.raster_segments(
        seg2.starts, seg2.data, seg2.tw, seg2.tile), reps)
    r = RasterizationRenderer("raster_atrium", 1920, 1088, binned=True, tile=tile,
                              post_program=S.post_program(), device="cuda")
    r.set_scene(host)
    out["raster_atrium"] = S.run_raster(r, "raster_atrium", "")
    S.log("  " + ", ".join(f"{key} {v:.4f}" for key, v in out.items()
                           if isinstance(v, float))
          + f", raster_atrium {out['raster_atrium']['ms_per_frame']:.3f} ms/frame")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--k1k3", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("time_walks: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    S = smoke_helpers()
    from hala_tpu_torch.ops import cluster as k6
    from hala_tpu_torch.ops import cuda_lib, cull
    from hala_tpu_torch.ops import traverse as k2
    from hala_tpu_torch.ops.compaction import order_by
    from hala_tpu_torch.scene.cpu.scene import Scene
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    if not os.path.abspath(cuda_lib.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {cuda_lib.__file__}, not from {root}")
    card = S.card_line()
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    host = Scene.load(os.path.join(HERE, "assets", "atrium_big.glb"))
    if args.k1k3:
        out = time_k1_k3(S, host, dev, args.reps)
        out.update(root=root, card=card, build_s=cuda_lib.build_seconds)
        print(json.dumps(out), flush=True)
        return 0
    scene = SceneUploader.upload(host, device=dev)
    x5_host, x5_scene, _, _ = S.upload_instances(host, dev)
    own = root == HERE
    # the parent's K4 builds nothing per launch; here the unions are
    # built once per geometry, as the traverse engine does
    with_unions = "unions" in inspect.signature(cull.cull_topk).parameters
    out = dict(root=root, card=card, build_s=cuda_lib.build_seconds)
    batches = (("small", scene, S.mixed_batch(scene, 256, 128, 32768, 31)),
               ("big", scene, S.mixed_batch(scene, 1024, 1024, 1 << 20, 33)),
               ("x5", x5_scene, S.mixed_batch(x5_scene, 1024, 1024, 1 << 20, 35)))
    for label, sc, (o, d, tm) in batches:
        g = sc.geometry
        cmin, cmax = g.cluster_min, g.cluster_max
        c, k, step = cmin.shape[0], S.TRAVERSE_K, cull.CULL_MAX_CLUSTERS
        slices = [slice(lo, lo + step) for lo in range(0, c, step)]
        unions = [cull.group_unions(cmin[sl], cmax[sl]) for sl in slices] if with_unions else None
        order, _ = order_by(k2._coherence_key(o, d, tm, cmin, cmax))
        orders = (("unsorted", (o, d, tm)),
                  ("sorted", tuple(x[order].contiguous() for x in (o, d, tm))))
        for how, (o_, d_, tm_) in orders:
            if label == "x5" and how == "unsorted":
                continue

            def cull_query():
                return [cull.cull_topk(o_, d_, tm_, cmin[sl], cmax[sl], k=k,
                                       **({"unions": unions[j]} if with_unions else {}))
                        for j, sl in enumerate(slices)]

            ids, tns, ovf = k2.cull_candidates(o_, d_, tm_, cmin, cmax, k)
            k5_hit, unres, runs = k2.traverse_candidates(o_, d_, tm_, ids, tns, ovf,
                                                         g.tri_packed)
            fb_tm = k2.fallback_t_max(k5_hit, unres)
            rec = dict(rays=o_.shape[0], clusters=c, k4_launches=len(slices),
                       unresolved=int((fb_tm > 1e-4).sum()))
            if own:
                rec["k4_bound_ms"] = S.k4_work(o_, d_, tm_, cmin, cmax, k)[0]
                fk = k6.intersect_clustered(o_, d_, g, t_max=fb_tm)
                act = fb_tm > 1e-4
                rec["k6_bound_ms"] = S.k2_work(g, o_[act], d_[act], fb_tm[act],
                                               type(fk)(*(x[act] for x in fk)))[0]
            if label != "x5":
                hit = k2.intersect_matrix(o_, d_, g, t_max=tm_)
                if own:
                    k2_b = S.k2_work(g, o_, d_, tm_, hit)
                    k5_b = S.k5_work(g, o_, d_, tm_, ids, k, k5_hit, runs)
                    rec.update(k2_bound_ms=k2_b[0], k2_work=k2_b[2],
                               k5_bound_ms=k5_b[0], k5_visits=k5_b[2],
                               k5_mt_pairs=k5_b[3])
                rec["k2_ms"] = S.cuda_ms(lambda: k2.intersect_matrix(
                    o_, d_, g, t_max=tm_), args.reps)
                rec["k2_anyhit_ms"] = S.cuda_ms(lambda: k2.intersect_matrix(
                    o_, d_, g, t_max=tm_, any_hit=True), args.reps)
            rec["k4_ms"] = S.cuda_ms(cull_query, args.reps)
            rec["k5_ms"] = S.cuda_ms(lambda: k2.traverse_candidates(
                o_, d_, tm_, ids, tns, ovf, g.tri_packed), args.reps)
            rec["k6_ms"] = S.cuda_ms(lambda: k6.intersect_clustered(
                o_, d_, g, t_max=fb_tm), args.reps)
            if label != "small" and how == "sorted":
                rec["k6_full_range_ms"] = S.cuda_ms(lambda: k6.intersect_clustered(
                    o_, d_, g, t_max=tm_), 2)
            out[f"{label}_{how}"] = rec
            S.log(f"  {label} {how} N={rec['rays']} x {c} clusters: "
                  + ", ".join(f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
                              for key, v in rec.items()
                              if key.endswith("ms") or key == "unresolved")
                  + f" [{card}]")
    if args.profile:
        from hala_tpu_torch.models.rt_renderer import RayTracingRenderer

        for name, engine, scene_host in (("atrium_big", "matrix", host),
                                         ("atrium_big", "traverse", host),
                                         ("atrium_big", "wavefront", host),
                                         ("x5", "auto", x5_host)):
            r = RayTracingRenderer(f"{name}_{engine}", 1920, 1088, max_depth=4,
                                   rr_depth=2, spp=1, intersector=engine, device="cuda")
            r.set_scene(scene_host)
            r.commit()
            S.warm_up(r)
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            r.render_loop(2, frames_per_dispatch=2)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 2 * 1e3
            key = f"{name}_{engine}"
            out[f"{key}_frame_ms"] = wall
            out[f"{key}_launches_per_frame"] = {
                k: v / 2 for k, v in cuda_lib.launches().items() if v}
            S.log(f"  {key}: {wall:.1f} ms/frame, launches per frame "
                  f"{out[f'{key}_launches_per_frame']} [{card}]")
            out[f"{key}_frame_profile"] = S.profile_frames(
                f"{name} {engine} (sorted rays)", lambda: r.render_loop(1), 1,
                wall, card)
            del r
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
