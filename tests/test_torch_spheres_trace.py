"""Procedural spheres on the path tracer's main path, and their span, on
the CPU.

- RayTracingRenderer on the benchmark's Cornell box
  (bench_port/configs/cornell.json through bench_port/lib/quadscene.py)
  with three spheres added by bench_port/run.py's `add_spheres` equals
  the plain reference (bench_port/lib/reftrace.py) on every pixel under
  the benchmark's rule (bench_port/lib/compare.py), under "auto" (K1's
  route, batched shadow rays) and "matrix" (K2's route, any-hit shadow
  rays), with tracing off and on;
- with tracing on, every `hala.query` holds exactly one
  `hala.query.spheres` with its kind and rays and the 3 spheres, and the
  counter `query.sphere_pairs` counts rays x 3; a scene without spheres
  records neither;
- with tracing off the sphere path reads no clock, and the images are
  bit for bit the same with tracing on and off;
- the benchmark's atrium_big_spheres configuration is the scene of
  bench_port/tests/atrium_big_spheres.json, and its cell's entries in
  BENCHMARK.json name files that exist; the sphere readers read None
  where the program recorded no sphere span.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_port")
CELL = "atrium_big_spheres.trace_1080p"
SIZE = 32
FRAMES = 2
# in the box's scene coordinates ([-1, 1]^3, the camera on -z looking
# along +z): one on the floor in front of the tall block, one above the
# short block, one in the air below the light
SPHERES = [
    {"center": [0.5, -0.73, -0.55], "radius": 0.25, "base_color": [0.8, 0.3, 0.2]},
    {"center": [-0.35, 0.1, -0.5], "radius": 0.2, "base_color": [0.8, 0.5, 0.2]},
    {"center": [0.0, 0.55, 0.3], "radius": 0.18, "base_color": [0.8, 0.7, 0.2]},
]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _bench():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from lib import compare, quadscene, reftrace
    from lib.refscene import RefScene

    spec = importlib.util.spec_from_file_location("bench_port_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return compare, quadscene, reftrace, RefScene, run


def _reader(name):
    _bench()
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"), os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _config(intersector):
    """Cornell's configuration on `intersector`, with the shadow rays'
    rule its route takes: any-hit on K2's, closest-hit on K1's."""
    config = copy.deepcopy(_json(BENCH, "configs", "cornell.json"))
    config["renderer"]["intersector"] = intersector
    config["renderer"]["shadow_rays"] = "any_hit" if intersector == "matrix" else "closest_hit"
    return config


def _host(config, spheres=SPHERES):
    _, quadscene, _, _, run = _bench()
    host = quadscene.build(config["scene"])
    run.add_spheres(host, spheres)
    return host


def _render(config, host, size=SIZE, frames=FRAMES, sharded=False):
    """Render `frames` frames; `sharded` runs the geometry-sharded query
    on a one-rank mesh."""
    rend, env = config["renderer"], config["environment"]
    r = RayTracingRenderer("spheres", size, size, max_depth=rend["max_depth"],
                           rr_depth=rend["rr_depth"], spp=rend["spp"], use_bvh=rend["use_bvh"],
                           intersector=rend["intersector"], device="cpu")
    r.set_ground_color(env["ground_color"])
    r.set_sky_color(env["sky_color"])
    r.set_env_intensity(env["intensity"])
    r.set_scene(host)
    r.commit()
    if sharded:
        from hala_tpu_torch.parallel import make_mesh

        r.settings = dataclasses.replace(r.settings, scene_axis=make_mesh("cpu"))
    for _ in range(frames):
        r.update()
        r.render()
    return r, torch.cat([r.film.accum, r.film.albedo, r.film.normal], dim=-1).reshape(-1, 12)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _sphere_hits(host, size=SIZE):
    """How many pixels' first camera rays the plain reference sends to a
    sphere."""
    _, _, reftrace, RefScene, _ = _bench()
    rs = RefScene(host, "cpu")
    pix = torch.arange(size * size)
    jitter = reftrace.sample4(pix, torch.zeros_like(pix), 0, 1)
    o, d = reftrace.camera_rays(rs, (pix % size).float(), (pix // size).float(), size, size,
                                jitter)
    _, tri, _, _ = reftrace.closest_hit(rs, o, d, torch.full((pix.shape[0],), reftrace.T_MAX))
    assert rs.num_spheres == len(SPHERES)
    return int((tri >= rs.num_triangles).sum())


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("intersector", ["auto", "matrix"])
def test_sphere_renderer_matches_the_reference(intersector, tracing):
    compare = _bench()[0]
    config = _config(intersector)
    host = _host(config)
    assert SIZE * SIZE // 20 <= _sphere_hits(host) <= SIZE * SIZE // 2
    if tracing:
        profiling.enable()
    _, got = _render(config, host)
    profiling.disable()
    traffic = {"renderer": "trace", "width": SIZE, "height": SIZE}
    ref, _ = compare.reference_values(config, traffic, host, np.arange(SIZE * SIZE), FRAMES,
                                      "cpu")
    assert int(compare.pixels_off(got.float(), ref).sum()) == 0
    assert (profiling.spans() != []) == tracing


@pytest.mark.parametrize("intersector,sharded,engine,kinds", [
    ("auto", False, "pallas", {"closest", "batched"}),
    ("matrix", False, "matrix", {"closest", "extend", "any"}),
    ("matrix", True, "matrix", {"closest", "extend", "any"}),
], ids=["auto", "matrix", "matrix-sharded"])
def test_every_query_holds_one_sphere_span(intersector, sharded, engine, kinds, monkeypatch):
    from hala_tpu_torch.models import integrator

    config = _config(intersector)
    _, plain = _render(config, _host(config), size=16, frames=1)
    gathered = []
    gather = integrator._gather_rays
    monkeypatch.setattr(integrator, "_gather_rays",
                        lambda *a: gathered.append(1) or gather(*a))
    profiling.enable()
    _, got = _render(config, _host(config), size=16, frames=1, sharded=sharded)
    profiling.disable()
    assert torch.equal(got, plain) and bool(gathered) == sharded
    spans = profiling.spans()
    queries = [s for s in spans if s.name == "hala.query"]
    spheres = [s for s in spans if s.name == "hala.query.spheres"]
    assert queries and len(spheres) == len(queries)
    assert {q.attrs["engine"] for q in queries} == {engine}
    for q in queries:
        kids = [s for s in spans if s.parent == q.index and s.name == "hala.query.spheres"]
        assert len(kids) == 1
        s = kids[0]
        assert q.start <= s.start <= s.end <= q.end and s.frame == q.frame
        assert s.attrs == {"kind": q.attrs["kind"], "rays": q.attrs["rays"], "spheres": 3}
    assert {s.attrs["kind"] for s in spheres} == kinds
    pairs = [c for c in profiling.counters() if c["name"] == "query.sphere_pairs"]
    assert {c["labels"]["kind"] for c in pairs} == kinds
    assert sum(c["value"] for c in pairs) == 3 * sum(s.attrs["rays"] for s in spheres)


@pytest.mark.parametrize("intersector", ["auto", "matrix"])
def test_scene_without_spheres_records_no_sphere_span(intersector):
    config = _config(intersector)
    profiling.enable()
    _render(config, _host(config, spheres=[]), size=16, frames=1)
    profiling.disable()
    assert any(s.name == "hala.query" for s in profiling.spans())
    assert not any(s.name == "hala.query.spheres" for s in profiling.spans())
    assert not any(c["name"] == "query.sphere_pairs" for c in profiling.counters())


def test_sphere_spans_off_read_no_clock(monkeypatch):
    config = _config("matrix")
    host = _host(config)

    def no_clock():
        raise AssertionError("a clock was read while tracing is off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    _render(config, host, size=16, frames=1)
    monkeypatch.undo()
    assert profiling.spans() == [] and profiling.counters() == []


@pytest.mark.parametrize("intersector", ["auto", "matrix"])
def test_sphere_images_equal_with_tracing_on_and_off(intersector):
    config = _config(intersector)
    _, off = _render(config, _host(config), size=16)
    profiling.enable()
    _, on = _render(config, _host(config), size=16)
    profiling.disable()
    assert torch.equal(off, on)


def test_benchmark_configuration_is_the_tests_copy():
    config = _json(BENCH, "configs", "atrium_big_spheres.json")
    tests_copy = _json(BENCH, "tests", "atrium_big_spheres.json")
    for key in ("scene", "renderer", "environment", "camera_offset", "precision", "assumed",
                "reduced"):
        assert config[key] == tests_copy[key], key
    assert len(config["scene"]["procedurals"]) == 3


def test_benchmark_entries_name_files_that_exist():
    bench = _json(ROOT, "BENCHMARK.json")
    [cfg] = [c for c in bench["configs"] if c["name"] == "atrium_big_spheres"]
    [cell] = [w for w in bench["workloads"] if w["name"] == CELL]
    assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    assert _json(ROOT, cfg["file"])["reduced"] == cfg["reduced"]
    assert _json(ROOT, cfg["file"])["source"] == cfg["source"]
    # A configuration is new only where its source or its cut differs from every other's.
    others = [(c["source"], c["reduced"]) for c in bench["configs"] if c is not cfg]
    assert (cfg["source"], cfg["reduced"]) not in others
    assert cell["config"] == cfg["name"] and cell["chips"] == 1
    assert os.path.isfile(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    assert _json(BENCH, "checks", CELL + ".json") == {"pixels_off_pct": 10.0}
    per_layer = [m for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])]
    assert {"spheres.query_ms", "spheres.launches_per_frame"} <= {m["name"] for m in per_layer}
    for m in per_layer:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    frame = [m for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert {m["name"] for m in frame} == {"setup_s", "trace_frame_ms", "trace_frame_p90_ms"}


class _Run:
    def __init__(self, rows):
        self.stages = {"stages": rows}


@pytest.mark.parametrize("name,value", [
    ("spheres.query_ms", 6.5), ("spheres.launches_per_frame", 905.0)])
def test_sphere_readers_read_the_span_or_nothing(name, value):
    read = _reader(name)
    row = dict(count=18.0, host_ms=9.0, self_ms=9.0, busy_ms=6.5, idle_ms=0.1, launches=905.0)
    assert read(_Run({"hala.query": dict(row, launches=18.0), "hala.query.spheres": row})) == value
    assert read(_Run({"hala.query": row})) is None
