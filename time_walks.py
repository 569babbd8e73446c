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
(`query_coherence_key`, `order_by`), and a 2^21-ray mixed batch of the five
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

`--frame` times K2 on the 18 launches of one atrium_big frame
(1920x1088, depth 4, 1 spp, the main path's coherence sort; chip_smoke
`frame_k2_launches`), each kind's launches back to back: camera,
extension, shadow (`time_k2_kinds`); for this checkout also each kind's
packed share of K2's Moller-Trumbore steps. Run it on two checkouts in
turns (parent, change, change, parent) within one call.

`--k1k3` times the brute-force kernel K1 (csrc/intersect_bruteforce.cu)
and the raster kernel K3 (csrc/raster_tiled.cu) of the checkout
instead: K1 closest and any-hit on chip_smoke's Cornell batch (524,288
mixed rays, 34 triangles) and on a 4096-triangle `random_triangle_soup`
with 524,288 live rays; K3 at the raster bench shape (atrium_big,
1920x1088, tile 64, bench camera) and on chip_smoke's skip-breaking
table; then the raster_atrium frame (RasterizationRenderer with the
ACES post pass, 10 frames after a warm-up). Prints one JSON line;
exits 2 without CUDA.

`--k7k8` times the grouped walk K8 (csrc/grouped_walk.cu, k_cap 32)
and the wavefront walk K7 (csrc/wavefront_walk.cu, k_per_ray 16,
m_group 32) of the checkout, closest and any-hit, on chip_smoke's
atrium_big batches (65,536 and 2^21 mixed rays in matrix_query's
coherence order, the lists as `check_k7_k8` builds them), then the
atrium_big frame through intersector="wavefront" (1920x1088, depth 4,
1 spp, two frames after a warm-up). For this checkout it also prints
the plain model's span counts on the 2^21 batch (chip_smoke
`TestedPairs`: pairs in the spans each ray enters, and in the spans
some lane of each warp enters) and both bounds. `--sass` compiles K2,
K5, K6 and the two walks to cubins with `-Xptxas -v` (registers,
shared memory, spills) and prints, from `cuobjdump -sass`, the
instructions of each loop (a backward branch and its target) of the
two walks with its opcode counts; the cubins and their SASS go to
hala_tpu_torch/_build/sass/ of the checkout timed.
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
        sc = SceneUploader.upload(scene_host, use_ray_tracing=False, device=dev)
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
    scene = SceneUploader.upload(host, use_ray_tracing=False, device=dev)
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


def k7k8_inputs(S, scene, batch):
    """The walks' arguments on `batch` in matrix_query's coherence
    order, as chip_smoke's `check_k7_k8` builds them: K8 at k_cap 32,
    K7 at k_per_ray 16 and m_group 32."""
    import torch

    from hala_tpu_torch.ops import traverse as k8
    from hala_tpu_torch.ops import wavefront as k7
    from hala_tpu_torch.ops.compaction import query_coherence_key

    g = scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    c = cmin.shape[0]
    o, d, tm = k8.pad_to_groups(*batch)
    order = torch.argsort(query_coherence_key(o, d, tm, cmin, cmax), stable=True)
    o, d, tm = (x[order].contiguous() for x in (o, d, tm))
    ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, 32)
    a8 = (o, d, tm, torch.clamp(usz, max=32), torch.clamp(ids, max=c - 1).contiguous(),
          tns.view(torch.int32), g.tri_packed, cmin, cmax)
    w = k7.wavefront_lists(o, d, tm, g, 16, 32)
    a7 = (w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, g.tri_packed, cmin, cmax)
    return a8, a7


def k7k8_counts(S, scene, a8, a7) -> dict:
    """This checkout's plain models with chip_smoke's `TestedPairs` on
    the walks' inputs: the span counts and both bounds."""
    from hala_tpu_torch.ops import traverse as k8
    from hala_tpu_torch.ops import wavefront as k7

    g = scene.geometry
    c = g.cluster_min.shape[0]
    spans_real = (g.tri_mat >= 0).view(c, 8, 16).sum(dim=2)
    out = {}
    for name, plain, args in (("k8", k8.grouped_walk_plain, a8),
                              ("k7", k7.wavefront_walk_plain, a7)):
        for any_hit in (False, True):
            with S.TestedPairs(k8, spans_real) as work:
                plain(*args, any_hit)
            n = args[0].shape[0]
            # the bound's bytes are small beside its operations
            b_ms, b_by, old_ms = work.bounds(n * 44 + g.tri_packed.numel() * 4)
            key = f"{name}{'_anyhit' if any_hit else ''}"
            out[key] = dict(work.record(), bound_ms=b_ms, bound_by=b_by,
                            old_bound_ms=old_ms)
            S.log(f"  {key} N={n}: bound {b_ms:.4f} ms ({b_by}), old bound "
                  f"{old_ms:.4f}; {work.describe()}")
    return out


def time_k7_k8(S, host, dev, reps: int, own: bool) -> dict:
    """K8 and K7 of the checkout on chip_smoke's atrium_big batches, and
    the wavefront frame."""
    import torch

    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.ops import traverse as k8
    from hala_tpu_torch.ops import wavefront as k7
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    scene = SceneUploader.upload(host, use_ray_tracing=False, device=dev)
    out = {}
    for label, batch in (("small", S.mixed_batch(scene, 256, 128, 32768, 31)),
                         ("big", S.mixed_batch(scene, 1024, 1024, 1 << 20, 33))):
        a8, a7 = k7k8_inputs(S, scene, batch)
        rec = {}
        if own and label == "big":
            rec["counts"] = k7k8_counts(S, scene, a8, a7)
        rec.update(
            k8_ms=S.cuda_ms(lambda: k8.grouped_walk(*a8), reps),
            k8_anyhit_ms=S.cuda_ms(lambda: k8.grouped_walk(*a8, True), reps),
            k7_ms=S.cuda_ms(lambda: k7.wavefront_walk(*a7), reps),
            k7_anyhit_ms=S.cuda_ms(lambda: k7.wavefront_walk(*a7, True), reps))
        S.log(f"  {label} N={a8[0].shape[0]}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in rec.items() if key.endswith("ms")))
        out[label] = rec
        del a8, a7
    r = RayTracingRenderer("atrium_big_wavefront", 1920, 1088, max_depth=4, rr_depth=2,
                           spp=1, intersector="wavefront", use_bvh=False, device="cuda")
    r.set_scene(host)
    r.commit()
    S.warm_up(r)
    t0 = time.perf_counter()
    r.render_loop(2, frames_per_dispatch=2)
    torch.cuda.synchronize()
    out["wavefront_frame_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    S.log(f"  atrium_big wavefront: {out['wavefront_frame_ms']:.1f} ms/frame")
    return out


def sass_loops(root: str) -> dict:
    """Registers, shared memory and spills (`-Xptxas -v`) of the cluster
    walks (K2, K5, K6) and of the two chunk-test walks (K8, K7), and for
    the latter the instructions of each loop of their SASS."""
    import collections
    import re
    import subprocess

    from hala_tpu_torch.ops import cuda_lib

    outdir = os.path.join(cuda_lib.BUILD_DIR, "sass")
    os.makedirs(outdir, exist_ok=True)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = {}
    for name in ("matrix_traverse", "traverse_candidates", "cluster_stream",
                 "grouped_walk", "wavefront_walk"):
        src = os.path.join(root, "hala_tpu_torch", "csrc", f"{name}.cu")
        cubin = os.path.join(outdir, f"{name}.cubin")
        ptxas = subprocess.run([cuda_lib.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v",
                                "-o", cubin, src], capture_output=True, text=True, check=True)
        sass = subprocess.run([os.path.join(os.path.dirname(cuda_lib.nvcc_path()),
                                            "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
        with open(os.path.join(outdir, f"{name}.sass"), "w") as f:
            f.write(sass)
        code = []
        for line in sass.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                code.append((int(m.group(1), 16), m.group(2).strip()))
        loops = []
        for addr, text in code if name in ("grouped_walk", "wavefront_walk") else ():
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                body = [t for a, t in code if lo <= a <= addr]
                ops = collections.Counter(
                    re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body)
                loops.append(dict(start=hex(lo), end=hex(addr), instructions=len(body),
                                  ops=dict(ops.most_common(12))))
        info = [ln.strip() for ln in ptxas.stderr.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln]
        out[name] = dict(ptxas=info, loops=loops)
        print(f"  {name}: " + " | ".join(info), flush=True)
        for lp in loops:
            print(f"    loop {lp['start']}-{lp['end']}: {lp['instructions']} "
                  f"instructions {lp['ops']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--frame", action="store_true")
    ap.add_argument("--k1k3", action="store_true")
    ap.add_argument("--k7k8", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    from hala_tpu_torch.ops.compaction import order_by, query_coherence_key
    from hala_tpu_torch.scene.cpu.scene import Scene
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    if not os.path.abspath(cuda_lib.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {cuda_lib.__file__}, not from {root}")
    card = S.card_line()
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    host = Scene.load(os.path.join(HERE, "assets", "atrium_big.glb"))
    if args.frame:
        scene = SceneUploader.upload(host, use_ray_tracing=False, device=dev)
        frame = S.time_k2_kinds(S.frame_k2_launches(scene), args.reps, own=root == HERE)
        S.log("  K2 ms a frame: " + ", ".join(
            f"{kind} {frame[kind]['ms']:.3f}" for kind in S.K2_KINDS)
            + f", all {frame['all_ms']:.3f} [{card}]")
        print(json.dumps(dict(root=root, card=card, build_s=cuda_lib.build_seconds,
                              frame=frame)), flush=True)
        return 0
    if args.k1k3:
        out = time_k1_k3(S, host, dev, args.reps)
        out.update(root=root, card=card, build_s=cuda_lib.build_seconds)
        print(json.dumps(out), flush=True)
        return 0
    if args.k7k8 or args.sass:
        out = dict(root=root, card=card, build_s=cuda_lib.build_seconds)
        if args.sass:
            out["sass"] = sass_loops(root)
        if args.k7k8:
            out.update(time_k7_k8(S, host, dev, args.reps, root == HERE))
        print(json.dumps(out), flush=True)
        return 0
    scene = SceneUploader.upload(host, use_ray_tracing=False, device=dev)
    x5_host, x5_scene, _, _ = S.upload_instances(host, dev)
    own = root == HERE
    # the parent's K4 builds nothing per launch; here the unions are
    # built once per geometry, as the traverse engine does
    with_unions = "unions" in inspect.signature(cull.cull_topk).parameters
    # the parent's K5 takes no cluster boxes (the admissibility rule's)
    k5_boxes = "cluster_min" in inspect.signature(k2.traverse_candidates).parameters
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
        order, _ = order_by(query_coherence_key(o, d, tm, cmin, cmax))
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
            k5_args = (o_, d_, tm_, ids, tns, ovf) + (
                (cmin, cmax, g.tri_packed) if k5_boxes else (g.tri_packed,))
            k5_hit, unres, runs = k2.traverse_candidates(*k5_args)
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
            rec["k5_ms"] = S.cuda_ms(lambda: k2.traverse_candidates(*k5_args),
                                     args.reps)
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
                                   rr_depth=2, spp=1, intersector=engine, use_bvh=False, device="cuda")
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
