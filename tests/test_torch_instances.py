"""The instanced scene of the benchmark's atrium_x5 configuration and the
"traverse" engine it runs, on the CPU.

- tools/make_instances.py writes assets/atrium_x5.glb byte for byte, as
  bench_port/configs/atrium_x5.json pins it;
- the port's loader reads that file into the scene the tool's
  `hall_scene` builds from atrium_big: the same nodes, meshes, world
  matrices, lights and camera; the plain reference counts its 833,080
  triangles;
- RayTracingRenderer(intersector="traverse") on the benchmark's Cornell
  box laid out five times as one hall by the same tool equals the plain reference
  (bench_port/lib/reftrace.py) on every pixel under the benchmark's
  rule (bench_port/lib/compare.py), with tracing off and on; with it on,
  every query holds one `hala.query.cull`, `.walk` and `.fallback`.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_port")
BIG = os.path.join(ROOT, "assets", "atrium_big.glb")
X5 = os.path.join(ROOT, "assets", "atrium_x5.glb")
SIZE = 32
FRAMES = 2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_instances", os.path.join(ROOT, "tools", "make_instances.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _bench_lib():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from lib import compare, quadscene

    return compare, quadscene


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


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


def test_tool_writes_the_pinned_file(tmp_path):
    out = str(tmp_path / "atrium_x5.glb")
    spacing = _tool().write_hall(BIG, out)
    assert spacing == 26.0
    pinned = _config("atrium_x5")["scene"]["sha256"]
    assert _sha256(out) == pinned == _sha256(X5)


def test_loaded_file_is_the_hall_scene():
    got = Scene.load(X5)
    want, spacing = _tool().hall_scene(Scene.load(BIG))
    assert spacing == 26.0
    assert len(got.nodes) == len(want.nodes) == 8
    for a, b in zip(got.nodes, want.nodes):
        assert (a.name, a.parent, a.children, a.mesh_index, a.camera_index,
                a.light_index) == (b.name, b.parent, b.children, b.mesh_index,
                                   b.camera_index, b.light_index)
        assert a.world_transform.dtype == b.world_transform.dtype == np.float32
        assert np.array_equal(a.world_transform, b.world_transform)
    # bay 0 loses its -x end wall, bays 1-3 both, bay 4 its +x one
    assert [n.mesh_index for n in got.nodes if n.mesh_index is not None] == [1, 2, 2, 2, 3]
    assert [n.world_transform[0, 3] for n in got.nodes if n.mesh_index is not None] == [
        0.0, -26.0, -52.0, -78.0, -104.0]
    assert sum(n.camera_index is not None for n in got.nodes) == 1
    assert len(got.cameras) == len(want.cameras) == 1
    assert len(got.meshes) == len(want.meshes) == 4
    for a, b in zip(got.meshes, want.meshes):
        assert len(a.primitives) == len(b.primitives) == 8
        for pa, pb in zip(a.primitives, b.primitives):
            assert pa.material_index == pb.material_index
            for key in ("indices", "positions", "normals", "tex_coords"):
                assert np.array_equal(getattr(pa, key), getattr(pb, key))
            # the loader derives tangents from the triangles it keeps
            used = np.zeros(len(pa.positions), bool)
            used[pa.indices] = True
            assert np.array_equal(pa.tangents[used], pb.tangents[used])
    cut = [len(a.indices) - len(b.indices)
           for m in got.meshes[1:] for a, b in zip(got.meshes[0].primitives, m.primitives)]
    assert sorted(cut) == [0] * 21 + [3 * 280, 3 * 280, 3 * 560]
    assert len(got.lights) == len(want.lights) == 2
    for a, b in zip(got.lights, want.lights):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for key, value in dataclasses.asdict(a).items():
            assert np.array_equal(np.asarray(value), np.asarray(dataclasses.asdict(b)[key]))

    compare, _ = _bench_lib()
    from lib.refscene import RefScene

    assert RefScene(got, "cpu").num_triangles == _config("atrium_x5")["triangles"] == 833080


def _cornell_x5():
    compare, quadscene = _bench_lib()
    config = _config("cornell")
    host, spacing = _tool().hall_scene(quadscene.build(config["scene"]))
    assert sum(n.mesh_index is not None for n in host.nodes) == 5 and spacing > 0.0
    return compare, config, host


def _render(config, host):
    env = config["environment"]
    rend = config["renderer"]
    r = RayTracingRenderer("x5", SIZE, SIZE, max_depth=rend["max_depth"],
                           rr_depth=rend["rr_depth"], spp=rend["spp"], use_bvh=False,
                           intersector="traverse", device="cpu")
    r.set_ground_color(env["ground_color"])
    r.set_sky_color(env["sky_color"])
    r.set_env_intensity(env["intensity"])
    r.set_scene(host)
    r.commit()
    for _ in range(FRAMES):
        r.update()
        r.render()
    return r, torch.cat([r.film.accum, r.film.albedo, r.film.normal], dim=-1).reshape(-1, 12)


@pytest.mark.parametrize("tracing", [False, True])
def test_traverse_renderer_matches_the_reference(tracing):
    compare, config, host = _cornell_x5()
    if tracing:
        profiling.enable()
    r, got = _render(config, host)
    profiling.disable()
    pixels = np.arange(SIZE * SIZE)
    traffic = {"renderer": "trace", "width": SIZE, "height": SIZE}
    ref, _ = compare.reference_values(config, traffic, host, pixels, FRAMES, "cpu")
    assert int(compare.pixels_off(got.float(), ref).sum()) == 0
    if not tracing:
        assert profiling.spans() == []
        return
    spans = profiling.spans()
    queries = [s for s in spans if s.name == "hala.query"]
    # per frame: the camera rays, then one batched query per bounce
    assert len(queries) == FRAMES * (1 + config["renderer"]["max_depth"])
    assert all(q.attrs["engine"] == "traverse" for q in queries)
    for q in queries:
        kids = [s for s in spans if s.parent == q.index]
        assert sorted(s.name for s in kids) == [
            "hala.query.cull", "hala.query.fallback", "hala.query.walk",
            "hala.sort", "hala.sort"]
        for s in kids:
            assert q.start <= s.start <= s.end <= q.end and s.frame == q.frame
    assert not any(s.name == "hala.query.merge" for s in spans)
    assert [s.attrs for s in spans if s.name == "hala.query.cull"] == [
        {"superchunks": 1}] * len(queries)
