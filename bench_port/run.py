#!/usr/bin/env python3
"""The benchmark of hala_tpu_torch: one cell, one run, one result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of `workloads` in BENCHMARK.json: a configuration
(`bench_port/configs/<config>.json`: the scene, the renderer's settings,
the size of the camera offsets) under a traffic mix
(`bench_port/traffic/<traffic>.json`: the renderer, the film size, the
camera's poses, the warm and traced frames and the pixels compared).
Per-layer metrics are read by `bench_port/metrics/<name>.py`. A new
cell, mix or metric is a new file and a new entry in BENCHMARK.json.

A run loads the scene, writes the camera's poses into it (one drawn by
the seed, or a fixed path in an order the seed draws), uploads it
through the renderer (set-up, with warm frames that build and load every
kernel and render every pose), then renders frames back to back for
`--seconds` (each frame at the next pose, `update()` then `render()`,
which waits for the card), and prints the cell's end-to-end metrics.
With `--trace 1` it then renders the traffic's traced frames under
torch.profiler and prints the per-layer metrics instead. Either way it
then frees the renderer and holds what the timed frames produced
against the plain reference in `bench_port/lib` (pixels drawn from the
seed, at the last frame's pose), and prints the result as the last line
of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_port_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from lib import compare, devtrace, probes, stages  # noqa: E402


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic
    and metric definitions, all found by name. `config`, where given, is
    a configuration (as a dict) run in place of the workload's own file,
    under the workload's traffic, metrics and limits: a configuration
    that has no workload entry yet."""

    def __init__(self, name: str, bench: dict | None = None, config: dict | None = None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = found[0]
        self.chips = int(self.spec["chips"])
        self.config = config if config is not None else load_json(
            HERE, "configs", self.spec["config"] + ".json")
        self.traffic = load_json(HERE, "traffic", self.spec["traffic"] + ".json")

        def applies(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]


# --- the scene and its seeded pose --------------------------------------------


def host_scene(config: dict, seed: int, poses: int = 1, path_seed: int = 0):
    """The configuration's host scene with its camera moved by offsets
    drawn uniformly from [-s, s]^3 (s the config's `camera_offset`).
    One pose (`poses` 1): the seed draws the offset of the camera node.
    A path (`poses` > 1): `path_seed` draws the path's offsets, the same
    for every seed, so every run renders the same views; the seed draws
    their order. Camera k of the scene (the camera node, then one more
    node beside it for each further pose) is the k-th pose of that order.
    The configuration's `scene.procedurals` (see `add_spheres`) join the
    scene before the poses are written. The program receives only this
    scene."""
    src = config["scene"]
    if src["kind"] == "gltf":
        from hala_tpu_torch.scene.cpu.scene import Scene

        path = os.path.join(ROOT, src["path"])
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != src["sha256"]:
            raise SystemExit(f"{src['path']} is not the configuration's scene "
                             f"(sha256 {digest}, expected {src['sha256']})")
        host = Scene.load(path)
    elif src["kind"] == "quads":
        from lib import quadscene

        host = quadscene.build(src)
    else:
        raise ValueError(f"unknown scene kind {src['kind']!r}")
    add_spheres(host, src.get("procedurals", []))
    cams = [n for n in host.nodes if n.camera_index is not None]
    if len(cams) != 1:
        raise ValueError(f"the scene has {len(cams)} camera nodes; the benchmark poses one")
    size = np.float32(config["camera_offset"])
    if poses == 1:
        offsets = [np.random.default_rng(seed).uniform(-1.0, 1.0, 3).astype(np.float32) * size]
    else:
        drawn = np.random.default_rng(path_seed).uniform(-1.0, 1.0, (poses, 3)).astype(np.float32)
        offsets = list(drawn[np.random.default_rng(seed).permutation(poses)] * size)
    base = cams[0].local_transform.copy()
    for k, offset in enumerate(offsets):
        node = cams[0] if k == 0 else copy.deepcopy(cams[0])
        node.local_transform = base.copy()
        node.local_transform[:3, 3] += offset
        if k:
            node.name = f"{cams[0].name} pose {k}"
            node.children = []
            host.nodes.append(node)
            if node.parent is not None:
                host.nodes[node.parent].children.append(len(host.nodes) - 1)
    host.update_node_hierarchies()
    return host


def add_spheres(host, spheres) -> None:
    """Append, in list order, each sphere of a configuration's
    `scene.procedurals` ({"center": [x, y, z], "radius": r, "base_color":
    [r, g, b]}, world coordinates) to the host scene: a DIFFUSE material
    of that base colour (every other field at its default) after the
    scene's materials, and a procedural sphere using it. Apps register
    procedural shapes in code, not in the glTF file."""
    if not spheres:
        return
    from hala_tpu_torch.scene.cpu.material import Material
    from hala_tpu_torch.scene.cpu.prims import ProceduralSphere

    for sph in spheres:
        host.materials.append(Material(base_color=np.asarray(sph["base_color"], np.float32)))
        host.procedurals.append(ProceduralSphere(
            center=tuple(float(x) for x in sph["center"]), radius=float(sph["radius"]),
            material=len(host.materials) - 1))


def make_renderer(cell: Cell, tr: dict, device):
    cfg = cell.config["renderer"]
    if tr["renderer"] == "trace":
        from hala_tpu_torch.models.rt_renderer import RayTracingRenderer

        env = cell.config["environment"]
        r = RayTracingRenderer(cell.name, tr["width"], tr["height"],
                               max_depth=cfg["max_depth"], rr_depth=cfg["rr_depth"],
                               spp=cfg["spp"], use_bvh=cfg["use_bvh"],
                               intersector=cfg["intersector"], device=device)
        r.set_ground_color(env["ground_color"])
        r.set_sky_color(env["sky_color"])
        r.set_env_intensity(env["intensity"])
        return r
    from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
    from hala_tpu_torch.programs import ComputeProgram, ComputeProgramDesc

    post = ComputeProgram(ComputeProgramDesc(shader_file_path=tr["post_program"]))
    return RasterizationRenderer(cell.name, tr["width"], tr["height"], binned=tr["binned"],
                                 tile=tr["tile"], post_program=post, device=device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def film_values(r, kind: str, pixels):
    """What the timed frames produced at `pixels`, on the host."""
    idx = torch.as_tensor(pixels, dtype=torch.int64, device=r.device)
    if kind == "trace":
        film = torch.cat([r.film.accum, r.film.albedo, r.film.normal], dim=-1)
        return film.reshape(-1, 12)[idx].float().cpu()
    planes = [r.color, r.gbuffer["albedo"], r.gbuffer["normal"]]
    return torch.cat([p.reshape(-1, 3) for p in planes], dim=1)[idx].float().cpu()


def frame_metrics(name: str, times_s, window_s: float) -> dict:
    """`<name>_ms`, the window's mean frame time (its wall time over the
    frames completed in it), and `<name>_p90_ms`, the 90th percentile of
    all its frame times."""
    ms = np.asarray(times_s) * 1e3
    return {
        f"{name}_ms": {"value": window_s * 1e3 / len(ms), "unit": "ms"},
        f"{name}_p90_ms": {"value": float(np.percentile(ms, 90)), "unit": "ms"},
    }


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_port_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Traced:
    """What the per-layer readers read: the trace of the traced frames,
    the launches the probes captured in them, the program's spans and
    counters recorded in them and the stage table joining the spans to
    the trace (`lib/stages.py`; over `stage_frames` frames), the set-up's
    upload and the unprofiled window's mean frame."""

    def __init__(self, kind, frames, trace, captured, upload_s, mean_frame_s,
                 spans, counters, table, stage_frames):
        self.kind = kind
        self.frames = frames
        self.trace = trace
        self.captured = captured
        self.upload_s = upload_s
        self.mean_frame_s = mean_frame_s  # the unprofiled window's
        self.spans = spans
        self.counters = counters
        self.stages = table
        self.stage_frames = stage_frames


def run_traced(frame, kind: str, frames: int, device, upload_s, mean_frame_s):
    """`frames` more frames under torch.profiler recording the device
    alone (so the host runs at its unprofiled pace), with the probes
    holding the K1, K2 and K3 launches' inputs and answers and the
    program's tracer on; then one more frame recording the host's
    operations too, which names the idle gaps of the breakdown. The
    tracer is on only around those device-only frames; where their
    profile has no runtime launch events to join the spans to, it is on
    around the host frame instead, and that one frame is attributed.
    Returns the `Traced` run and the host frame's trace."""
    from torch.profiler import ProfilerActivity, profile

    from hala_tpu_torch.utils import profiling

    on_card = torch.device(device).type == "cuda"

    def frames_under(acts, n, traced):
        sync(device)
        profiling.reset()
        if traced:
            profiling.enable()
        try:
            with profile(activities=acts) as prof:
                t0 = time.time_ns()
                for _ in range(n):
                    frame(annotate=True)
                sync(device)
                t1 = time.time_ns()
        finally:
            profiling.disable()
        got = profiling.spans(), profiling.counters()
        profiling.reset()
        return devtrace.DeviceTrace.from_profile(prof, t0, t1, cpu_device=not on_card), got

    host_and_device = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with probes.capture() as captured:
        dtrace, recorded = frames_under(
            host_and_device[1:] if on_card else host_and_device, frames, True)
    fallback = not dtrace.launches
    host_trace, host_recorded = frames_under(host_and_device, 1, fallback)
    attributed, n = (host_trace, 1) if fallback else (dtrace, frames)
    spans, counters = host_recorded if fallback else recorded
    return Traced(kind, frames, dtrace, captured, upload_s, mean_frame_s, spans, counters,
                  stages.attribute(attributed, spans, n), n), host_trace


def set_pose(r, k: int) -> None:
    """Camera k of the uploaded table (the seeded path's pose k)."""
    if hasattr(r, "set_camera_index"):
        r.set_camera_index(k)
    else:
        r.camera_index = k


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, log=print) -> dict:
    """One run of `cell`; returns the result object."""
    tr = dict(cell.traffic, **(overrides or {}))
    kind = tr["renderer"]
    poses = tr["camera_poses"]
    path_seed = tr.get("camera_path_seed", 0)
    on_card = torch.device(device).type == "cuda"
    t_ctx = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    t_scene = time.perf_counter()
    host = host_scene(cell.config, seed, poses, path_seed)
    r = make_renderer(cell, tr, device)
    t_up = time.perf_counter()
    r.set_scene(host)
    r.commit()
    sync(device)
    upload_s = time.perf_counter() - t_up
    count = [0]

    def frame(annotate=False):
        """One frame at the next pose of the path: update(), then
        render(), which waits for the card."""
        if poses > 1:
            set_pose(r, count[0] % poses)
        count[0] += 1
        if annotate:
            with torch.profiler.record_function("bench.update"):
                r.update()
            with torch.profiler.record_function("bench.render"):
                r.render()
        else:
            r.update()
            r.render()

    t_warm = time.perf_counter()
    for _ in range(tr["warm_frames"]):
        frame()
    sync(device)

    # -- the measured window ----------------------------------------------
    times = []
    rays0 = getattr(r, "total_rays", 0.0)
    w0 = time.perf_counter()
    setup_s = w0 - T_START
    while True:
        f0 = time.perf_counter()
        frame()
        f1 = time.perf_counter()
        times.append(f1 - f0)
        if f1 - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    frame_metric = next(m["name"][:-3] for m in cell.end_to_end if m["name"].endswith("_frame_ms"))
    measured = dict(frame_metrics(frame_metric, times, window_s),
                    setup_s={"value": setup_s, "unit": "s"})
    metrics = {m["name"]: measured[m["name"]] for m in cell.end_to_end}
    # where set-up went, and the window's mean frame in eighths of its
    # frames (a drift inside the window shows there; a run that is slow
    # throughout shows as a level)
    eighths = [float(np.mean(part)) * 1e3 for part in np.array_split(times, 8) if len(part)]
    info = dict(frames=len(times), window_s=window_s, upload_s=upload_s,
                setup_parts_s=dict(imports=T_IMPORTED - T_START, context=t_scene - t_ctx,
                                   scene=t_up - t_scene, upload=upload_s,
                                   warm=w0 - t_warm),
                window_eighths_ms=eighths)
    if kind == "trace":
        rays = r.total_rays - rays0
        info.update(mrays_per_s=rays / window_s / 1e6,
                    rays_per_camera_ray=rays / (len(times) * tr["width"] * tr["height"]))

    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        traced, host_trace = run_traced(frame, kind, tr["traced_frames"], device, upload_s,
                                        window_s / len(times))
        dtrace = traced.trace
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=dtrace.busy_s(), window_s=dtrace.window_s())
        breakdown = {"device_ops": dtrace.top_ops(10), "idle_gaps": host_trace.idle_gaps(10)}
        info.update(traced_frames=tr["traced_frames"], traced_window_s=dtrace.window_s())
    info["card"] = card_limit() if on_card else "cpu"
    log("info: " + json.dumps(info))

    # -- what the timed path produced, against the plain reference ---------
    rng = np.random.default_rng([seed, 1])
    pixels = np.sort(rng.choice(tr["width"] * tr["height"], tr["check_pixels"], replace=False))
    got = film_values(r, kind, pixels)
    frames_total = getattr(r, "_frame_index", 0)
    last_pose = (count[0] - 1) % poses
    del r
    if on_card:
        torch.cuda.empty_cache()
    checks = compare.check(cell.name, cell.config, tr, host, pixels, got, frames_total, device,
                           log, camera=last_pose)

    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(times), "failed": 0, "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    found = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "hala_tpu"})
    if found:
        print(f"the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
