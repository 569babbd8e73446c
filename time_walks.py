#!/usr/bin/env python
"""Time the two cluster walks, K2 (csrc/matrix_traverse.cu) and K5
(csrc/traverse_candidates.cu), of one checkout of hala_tpu_torch on
the batches the main path hands them, on one NVIDIA GPU.

    python3 time_walks.py [--root DIR] [--reps N] [--profile]

`--root` names the checkout whose `hala_tpu_torch` is built and timed
(default: the one holding this script), so two checkouts can be timed
in turns within one process tree. The batches, the timer and the bounds
(`k2_work`, `k5_work`; printed for this checkout only, as they need its
plain model) are this checkout's `chip_smoke.py` helpers: atrium_big's mixed batches
`small` (65,536 rays) and `big` (2^21), each unsorted and in the
coherence order `matrix_query` gives them (`_coherence_key`,
`order_by`); K2 closest and any-hit, K5 on `cull_candidates` lists at
K 12. `--profile` adds, for atrium_big at 1920x1088 (depth 4, 1 spp)
through intersector "matrix" (K2 under the coherence sort),
"traverse" (K4, K5, K6) and "wavefront" (K4, K7, K2 as the fallback),
the time of two frames after a warm-up frame and a torch.profiler
window over one more. Prints one JSON line; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("time_walks: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    S = smoke_helpers()
    from hala_tpu_torch.ops import cuda_lib
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
    scene = SceneUploader.upload(host, device=dev)
    g = scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    out = dict(root=root, card=card, build_s=cuda_lib.build_seconds)
    batches = (("small", S.mixed_batch(scene, 256, 128, 32768, 31)),
               ("big", S.mixed_batch(scene, 1024, 1024, 1 << 20, 33)))
    for label, (o, d, tm) in batches:
        order, _ = order_by(k2._coherence_key(o, d, tm, cmin, cmax))
        orders = (("unsorted", (o, d, tm)),
                  ("sorted", tuple(x[order].contiguous() for x in (o, d, tm))))
        for how, (o_, d_, tm_) in orders:
            ids, tns, ovf = k2.cull_candidates(o_, d_, tm_, cmin, cmax, S.TRAVERSE_K)
            hit = k2.intersect_matrix(o_, d_, g, t_max=tm_)
            k5_hit, _, runs = k2.traverse_candidates(o_, d_, tm_, ids, tns, ovf,
                                                     g.tri_packed)
            rec = dict(rays=o_.shape[0])
            if root == HERE:
                k2_b = S.k2_work(g, o_, d_, tm_, hit)
                k5_b = S.k5_work(g, o_, d_, tm_, ids, S.TRAVERSE_K, k5_hit, runs)
                rec.update(k2_bound_ms=k2_b[0], k2_work=k2_b[2], k5_bound_ms=k5_b[0],
                           k5_visits=k5_b[2], k5_mt_pairs=k5_b[3])
            rec["k2_ms"] = S.cuda_ms(lambda: k2.intersect_matrix(o_, d_, g, t_max=tm_),
                                     args.reps)
            rec["k2_anyhit_ms"] = S.cuda_ms(lambda: k2.intersect_matrix(
                o_, d_, g, t_max=tm_, any_hit=True), args.reps)
            rec["k5_ms"] = S.cuda_ms(lambda: k2.traverse_candidates(
                o_, d_, tm_, ids, tns, ovf, g.tri_packed), args.reps)
            out[f"{label}_{how}"] = rec
            S.log(f"  {label} {how} N={rec['rays']}: K2 {rec['k2_ms']:.3f} ms "
                  f"(any-hit {rec['k2_anyhit_ms']:.3f}), bound "
                  f"{rec.get('k2_bound_ms', 'not computed')}; K5 {rec['k5_ms']:.3f} ms, "
                  f"bound {rec.get('k5_bound_ms', 'not computed')} [{card}]")
    if args.profile:
        from hala_tpu_torch.models.rt_renderer import RayTracingRenderer

        for engine in ("matrix", "traverse", "wavefront"):
            r = RayTracingRenderer("sponza", 1920, 1088, max_depth=4, rr_depth=2,
                                   spp=1, intersector=engine, device="cuda")
            r.set_scene(host)
            r.commit()
            S.warm_up(r)
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            r.render_loop(2, frames_per_dispatch=2)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 2 * 1e3
            out[f"{engine}_frame_ms"] = wall
            out[f"{engine}_launches_per_frame"] = {
                k: v / 2 for k, v in cuda_lib.launches().items() if v}
            out[f"{engine}_frame_profile"] = S.profile_frames(
                f"atrium_big {engine} (sorted rays)", lambda: r.render_loop(1), 1,
                wall, card)
            del r
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
