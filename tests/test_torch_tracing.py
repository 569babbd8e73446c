"""The port's tracer (`hala_tpu_torch/utils/profiling.py`): off by default
and free while off; while on, the spans and counters of the path
tracer's and the rasterizer's frames and of the upload, nested in time
and sharing their frame's index; the images bit for bit the same with
tracing on and off; the bounded buffer; the JSON-lines export."""

import json
import os
import threading
import time

import pytest
import torch

from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils import profiling

HERE = os.path.dirname(__file__)
ATRIUM = os.path.join(HERE, "..", "assets", "atrium.glb")


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


def _trace_renderer(intersector="auto", size=32, max_depth=2):
    r = RayTracingRenderer("t", size, size, max_depth=max_depth, use_bvh=False,
                           intersector=intersector, device="cpu")
    r.set_scene(cornell_box())
    r.commit()
    return r


def _raster_renderer(scene, w=64, h=32, tile=16):
    r = RasterizationRenderer("r", w, h, binned=True, tile=tile, device="cpu")
    r.set_scene(scene)
    r.commit()
    return r


def _frames(r, n):
    for _ in range(n):
        r.update()
        r.render()


def _counter(name):
    return sum(c["value"] for c in profiling.counters() if c["name"] == name)


def _check_tree(spans):
    """Every child lies inside its parent in time and carries its frame."""
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent >= 0:
            p = by_index[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p, s)
            assert s.frame == p.frame, (p, s)
            assert s.thread == p.thread


def test_off_by_default_and_nothing_recorded():
    assert not profiling.enabled()
    _frames(_trace_renderer(), 1)
    assert profiling.spans() == []
    assert profiling.counters() == []


def test_off_reads_no_clock_and_returns_the_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read while tracing is off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert profiling.span("hala.frame", frame=3, renderer="x") is profiling.NO_SPAN
    with profiling.span("a") as s:
        assert s is None
    profiling.count("query.rays", 5, engine="matrix")
    assert profiling.spans() == [] and profiling.counters() == []


@pytest.mark.parametrize("intersector", ["auto", "matrix"])
def test_trace_frame_spans(intersector):
    """Each update is one hala.frame; raygen, every query (engine, kind,
    rays), shading per bounce and the film are its children; a matrix
    query holds the sort's two spans."""
    r = _trace_renderer(intersector)
    profiling.enable()
    _frames(r, 2)
    spans = profiling.spans()
    _check_tree(spans)
    frames = [s for s in spans if s.name == "hala.frame"]
    assert [s.frame for s in frames] == [0, 1]
    assert all(s.attrs["renderer"] == "trace" and s.parent == -1 for s in frames)
    waits = [s for s in spans if s.name == "hala.wait"]
    assert [s.frame for s in waits] == [0, 1]
    n = 32 * 32
    for f in frames:
        kids = [s for s in spans if s.parent == f.index]
        names = [s.name for s in kids]
        assert names.count("hala.raygen") == 1
        assert names.count("hala.film") == 3
        # init_state, then bounce_pre and the post step of each bounce
        shade = [s.attrs["bounce"] for s in kids if s.name == "hala.shade"]
        assert shade == [0, 0, 0, 1, 1]
        queries = [(s.attrs["kind"], s.attrs["rays"]) for s in kids if s.name == "hala.query"]
        if intersector == "matrix":
            assert queries == [("closest", n), ("extend", n), ("any", n),
                               ("extend", n), ("any", n)]
            for q in (s for s in kids if s.name == "hala.query"):
                assert q.attrs["engine"] == "matrix"
                sorts = [s for s in spans if s.parent == q.index]
                assert [s.name for s in sorts] == ["hala.sort", "hala.sort"]
        else:
            assert queries == [("closest", n), ("batched", 2 * n), ("batched", 2 * n)]
            assert all(s.attrs["engine"] == "pallas" for s in kids if s.name == "hala.query")
        assert all(s.frame == f.frame for s in kids)
    rays = sum(s.attrs["rays"] for s in spans if s.name == "hala.query")
    assert _counter("query.rays") == rays == 2 * 5 * n
    assert _counter("query.calls") == len([s for s in spans if s.name == "hala.query"])
    assert _counter("frame.tiles") == 2


@pytest.mark.parametrize("path", ["plain", "k3"])
def test_raster_frame_spans(path):
    """setup, bin, visibility (the capped plain path on the Cornell box
    at tile 8, which K3 cannot lay out, the exact segment path on
    atrium.glb's 34k triangles), shade and post under the frame; the
    `raster.path` counter names the path once."""
    if path == "plain":
        r = _raster_renderer(cornell_box(), tile=8)
    else:
        r = _raster_renderer(Scene.load(ATRIUM))
    profiling.enable()
    _frames(r, 1)
    spans = profiling.spans()
    _check_tree(spans)
    (frame,) = [s for s in spans if s.name == "hala.frame"]
    assert frame.attrs["renderer"] == "raster" and frame.frame == 0
    kids = sorted((s for s in spans if s.parent == frame.index), key=lambda s: s.index)
    assert [s.name for s in kids] == [
        "hala.raster.setup", "hala.raster.bin", "hala.raster.visibility",
        "hala.raster.shade", "hala.raster.post", "hala.raster.post"]
    assert kids[2].attrs["path"] == path
    assert _counter("raster.triangles") == r.scene.geometry.tri_v0.shape[0]
    assert [(c["labels"], c["value"]) for c in profiling.counters()
            if c["name"] == "raster.path"] == [({"path": path}, 1)]


@pytest.mark.parametrize("kind", ["trace", "raster"])
def test_images_bit_for_bit_with_tracing_on_and_off(kind):
    def render():
        if kind == "trace":
            r = _trace_renderer("matrix")
            _frames(r, 2)
            return [r.film.accum, r.film.albedo, r.film.normal]
        r = _raster_renderer(cornell_box())
        _frames(r, 1)
        return [r.color, r.gbuffer["albedo"], r.gbuffer["normal"]]

    off = render()
    profiling.enable()
    on = render()
    assert profiling.spans()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_upload_and_load_spans_are_outside_frames():
    profiling.enable()
    scene = Scene.load(ATRIUM)
    r = _raster_renderer(scene)
    spans = profiling.spans()
    _check_tree(spans)
    names = {s.name: s for s in spans}
    assert {"hala.load", "hala.upload", "hala.upload.geometry", "hala.upload.sah",
            "hala.upload.textures"} <= set(names)
    assert all(s.frame == -1 for s in spans)
    up = names["hala.upload"]
    assert names["hala.upload.geometry"].parent == up.index
    assert names["hala.upload.sah"].parent == names["hala.upload.geometry"].index
    g = r.scene.geometry
    assert _counter("upload.triangles") == g.num_triangles
    assert _counter("upload.clusters") == g.tri_packed.shape[0]
    assert _counter("upload.bytes") == r.scene.nbytes() > g.tri_packed.nbytes


def test_bounded_buffer_drops_the_oldest_and_counts_them():
    profiling.enable()
    extra = 5
    for i in range(profiling.SPAN_CAPACITY + extra):
        with profiling.span("s", i=i):
            pass
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_CAPACITY
    assert spans[0].attrs["i"] == extra and spans[-1].attrs["i"] == profiling.SPAN_CAPACITY + extra - 1
    assert _counter("spans.dropped") == extra


def test_spans_of_another_thread_have_their_own_parents():
    profiling.enable()
    seen = []

    def work():
        with profiling.span("worker"):
            seen.append(threading.get_native_id())

    with profiling.span("main", frame=7):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = {s.name: s for s in profiling.spans()}
    assert spans["worker"].parent == -1 and spans["worker"].frame == -1
    assert spans["worker"].thread == seen[0] != spans["main"].thread
    assert spans["main"].frame == 7


def test_dump_round_trips(tmp_path):
    profiling.enable()
    _frames(_trace_renderer(max_depth=1), 1)
    path = str(tmp_path / "spans.jsonl")
    profiling.dump(path)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    spans = [profiling.Span(**d["span"]) for d in lines if "span" in d]
    counters = [d["counter"] for d in lines if "counter" in d]
    assert spans == profiling.spans() and len(spans) > 5
    assert counters == profiling.counters()
    assert len(lines) == len(spans) + len(counters)


def test_traverse_spans_off_read_no_clock(monkeypatch):
    """The "traverse" engine's spans (`hala.query.cull`, `.merge`,
    `.walk`, `.fallback`) read no clock and record nothing while tracing
    is off: a frame through it and a query forced through one superchunk
    a cluster."""
    import importlib.util

    from hala_tpu_torch.ops import traverse

    spec = importlib.util.spec_from_file_location(
        "make_instances", os.path.join(HERE, "..", "tools", "make_instances.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    r = RayTracingRenderer("t", 16, 16, max_depth=2, use_bvh=False,
                           intersector="traverse", device="cpu")
    r.set_scene(tool.hall_scene(cornell_box())[0])
    r.commit()
    g = r.scene.geometry
    o = torch.tensor([[0.0, 0.0, 3.0], [0.2, 0.3, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, -0.1, -1.0]])
    ref = traverse.intersect_traversed(o, d, g, k_per_ray=2)

    def no_clock():
        raise AssertionError("a clock was read while tracing is off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    _frames(r, 1)
    hit = traverse.intersect_traversed(o, d, g, k_per_ray=2, superchunk=1)
    monkeypatch.undo()
    assert g.cluster_min.shape[0] > 1
    assert torch.equal(hit.tri, ref.tri) and torch.equal(hit.t, ref.t)
    assert profiling.spans() == [] and profiling.counters() == []


def test_signature_sort_cull_stays_in_hala_sort(monkeypatch):
    """K4 launched by `matrix_query`'s "signature" sort key runs inside
    `hala.sort`, under no span of the "traverse" engine, and opens
    none."""
    from hala_tpu_torch.ops import traverse

    r = _trace_renderer("matrix", size=16)
    g = r.scene.geometry
    rs = torch.Generator().manual_seed(5)
    o = torch.rand((256, 3), generator=rs) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn((256, 3), generator=rs), dim=1)
    real = traverse.cull_topk

    def cull_topk(*args, **kw):
        # a marker span where K4 launches: its ancestors are the spans
        # open at the launch
        with profiling.span("launch.cull_topk"):
            return real(*args, **kw)

    monkeypatch.setattr(traverse, "cull_topk", cull_topk)
    profiling.enable()
    with profiling.span("hala.query", engine="matrix", kind="closest", rays=256):
        traverse.matrix_query(o, d, g, sort_key="signature")
    spans = profiling.spans()
    _check_tree(spans)
    (mark,) = [s for s in spans if s.name == "launch.cull_topk"]
    by_index = {s.index: s for s in spans}
    ancestors = []
    while mark.parent != -1:
        mark = by_index[mark.parent]
        ancestors.append(mark.name)
    assert ancestors == ["hala.sort", "hala.query"]
    assert sorted(s.name for s in spans) == [
        "hala.query", "hala.sort", "hala.sort", "launch.cull_topk"]
