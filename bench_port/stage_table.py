#!/usr/bin/env python3
"""The stage table of one cell: the program's spans joined to a device trace.

    python3 bench_port/stage_table.py --workload <cell> --seed <n> [--seconds S] [--out DIR]

One run of a cell's scene, poses and renderer, built as
`bench_port/run.py` builds them, with the program's tracer
(`hala_tpu_torch/utils/profiling.py`) switched on in three places:

- the set-up (glTF load and upload), for the upload's spans;
- windows of `--seconds` of frames back to back, tracing off, on, on
  and off in turn, for the cost of tracing: each window's mean frame;
- the traffic's traced frames under torch.profiler recording the device
  alone (as `run.py` traces them), joined to the spans by
  `lib/stages.py`. Where that profile carries no runtime launch events,
  one more frame recording the host too is attributed instead.

It prints one JSON line (and writes it under `--out`): the stage table,
the counters a traced frame, the per-layer numbers the spans give (under
the names a `BENCHMARK.json` entry would read), whether every K2 and K3
operation fell in its stage, and the time of a `span()` call with
tracing off and on. The card's name and power limit go beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402  (also puts the repository root on sys.path)
import torch  # noqa: E402
from lib import devtrace, stages  # noqa: E402

from hala_tpu_torch.utils import profiling  # noqa: E402

VISIBILITY_KERNELS = {
    "hala.query": ("matrix_walk_kernel", "intersect_bruteforce_kernel"),
    "hala.raster.visibility": ("order_tiles_kernel", "raster_tiled_kernel"),
}


def span_cost_ns(n: int = 200_000) -> dict:
    """The ns of one `span(...)` call and of one `with span(...)` block
    (an attr each), as tracing stands."""
    t0 = time.perf_counter_ns()
    for i in range(n):
        profiling.span("hala.shade", bounce=i)
    t1 = time.perf_counter_ns()
    for i in range(n):
        with profiling.span("hala.shade", bounce=i):
            pass
    t2 = time.perf_counter_ns()
    return {"call": (t1 - t0) / n, "block": (t2 - t1) / n}


def window(frame, seconds: float) -> dict:
    times = []
    w0 = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        frame()
        f1 = time.perf_counter()
        times.append(f1 - f0)
        if f1 - w0 >= seconds:
            break
    wall = time.perf_counter() - w0
    return {"frames": len(times), "mean_ms": wall * 1e3 / len(times)}


def per_layer(prefix: str, table: dict, counters: list, frames: int, setup: dict) -> dict:
    """The per-layer numbers of the stage table, named as the cell's
    metrics would be (`prefix` the cell's frame metric's: trace, raster,
    small_raster)."""
    busy = lambda *names: stages.busy_ms(table, names)  # noqa: E731
    dispatch = {f"{prefix}.dispatch_ms": stages.host_ms(table, "hala.frame")}
    if prefix == "trace":
        return dict(dispatch, **{
            "trace.sort_ms": busy("hala.sort"),
            "trace.visibility_ms": busy("hala.query"),
            "trace.shade_ms": busy("hala.shade"),
            "trace.film_ms": busy("hala.raygen", "hala.film"),
            "trace.query_rays_per_frame": stages.counter_total(counters, "query.rays") / frames,
            "upload.bvh_s": setup.get("hala.upload.bvh"),
        })
    return dict(dispatch, **{
        f"{prefix}.{stage}_ms": busy(f"hala.raster.{stage}")
        for stage in ("bin", "visibility", "shade", "post")
    })


def kernels_in_place(table: dict) -> dict:
    """For each visibility kernel traced: device ms a frame charged to
    its own stage, and to each other stage."""
    out = {}
    for home, parts in VISIBILITY_KERNELS.items():
        for stage, by_name in table["kernels"].items():
            for name, ms in by_name.items():
                if any(p in name for p in parts):
                    rec = out.setdefault(name[:60], {"stage": home})
                    rec[stage] = rec.get(stage, 0.0) + ms
    return out


def measure(cell: run.Cell, seed: int, seconds: float, device="cuda",
            overrides: dict | None = None) -> dict:
    """The stage table of one run of `cell` (see the module's docstring)."""
    tr = dict(cell.traffic, **(overrides or {}))
    prefix = next(m["name"][:-len("_frame_ms")] for m in cell.end_to_end
                  if m["name"].endswith("_frame_ms"))
    poses = tr["camera_poses"]
    torch.zeros(1, device=device)
    run.sync(device)

    profiling.reset()
    profiling.enable()
    host = run.host_scene(cell.config, seed, poses, tr.get("camera_path_seed", 0))
    r = run.make_renderer(cell, tr, device)
    t_up = time.perf_counter()
    r.set_scene(host)
    r.commit()
    run.sync(device)
    upload_s = time.perf_counter() - t_up
    profiling.disable()
    setup = {}
    for s in profiling.spans():
        setup[s.name] = setup.get(s.name, 0.0) + (s.end - s.start) / 1e9
    setup_counters = profiling.counters()
    profiling.reset()

    count = [0]

    def frame():
        if poses > 1:
            run.set_pose(r, count[0] % poses)
        count[0] += 1
        r.update()
        r.render()

    for _ in range(tr["warm_frames"]):
        frame()
    run.sync(device)

    windows = []
    for on in (False, True, True, False):
        (profiling.enable if on else profiling.disable)()
        windows.append(dict(window(frame, seconds), tracing=on))
        profiling.disable()
        profiling.reset()
    off = [w["mean_ms"] for w in windows if not w["tracing"]]
    on = [w["mean_ms"] for w in windows if w["tracing"]]

    from torch.profiler import ProfilerActivity, profile

    def traced(acts, n):
        profiling.reset()
        profiling.enable()
        run.sync(device)
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            for _ in range(n):
                frame()
            run.sync(device)
            t1 = time.time_ns()
        profiling.disable()
        return devtrace.DeviceTrace.from_profile(prof, t0, t1), profiling.spans(), profiling.counters()

    host_and_device = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        host_and_device.append(ProfilerActivity.CUDA)
    frames = tr["traced_frames"]
    trace, spans, counters = traced(host_and_device[-1:], frames)
    attributed_on = "device"
    if not trace.launches:
        frames = 1
        trace, spans, counters = traced(host_and_device, 1)
        attributed_on = "host+device"
    table = stages.attribute(trace, spans, frames)
    profiling.reset()

    off_ns = span_cost_ns()
    profiling.enable()
    on_ns = span_cost_ns()
    profiling.disable()
    profiling.reset()

    return {
        "workload": cell.name, "seed": seed, "device": device,
        "card": run.card_limit() if torch.device(device).type == "cuda" else "cpu",
        "attributed_on": attributed_on, "traced_frames": frames,
        "busy_ms_per_frame": trace.busy_s() * 1e3 / frames,
        "launches_per_frame": trace.count() / frames,
        "unattributed_share": table["unattributed_share"], "inherited_ops": table["inherited"],
        "ops": table["ops"],
        "metrics": per_layer(prefix, table, counters, frames, setup),
        "windows": windows,
        "tracing_cost_pct": 100.0 * (sum(on) / len(on) / (sum(off) / len(off)) - 1.0),
        "span_ns": {"off": off_ns, "on": on_ns},
        "upload_s": upload_s, "setup_spans_s": setup, "setup_counters": setup_counters,
        "counters_per_frame": [dict(c, value=c["value"] / frames) for c in counters],
        "visibility_kernels": kernels_in_place(table),
        "stages": table["stages"], "kernels": table["kernels"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=os.path.join(run.ROOT, "out", "stages"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the stage table needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(run.Cell(args.workload), args.seed, args.seconds)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}_{args.seed}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
