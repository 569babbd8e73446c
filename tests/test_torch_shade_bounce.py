"""A bounce's shading (`ops/shade_bounce.py`, K10) on the CPU.

The route rule; K10's output layout and the views `bounce_pre`'s dict
is made of, and its seam passes'; the kernel source's segments,
arguments and instances against the wrapper's; the `shade.bounce`
counter and span. And K10's source itself, compiled for the host with
g++ (its CUDA built-ins stubbed, one lane after another) and run
through the integrator's kernel route on CPU tensors: every mask and id
equal to the plain bounce's, every float within a few ulps' drift of
the CPU's own libm against PyTorch's CPU kernels; under pushed kernels
on its seams as well. K10 on the card, bit for bit, is
tests/test_torch_cuda.py.
"""

import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from hala_tpu_torch.envmap import EnvMap
from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.models.integrator import Film, KernelHooks, RenderSettings, Uniforms
from hala_tpu_torch.ops import cuda_lib
from hala_tpu_torch.ops import shade_bounce as k10
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "hala_tpu_torch", "csrc", "shade_bounce.cu")
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (bounce_pairs, bounce_diff)
from test_torch_features import (_alpha_scene, _lights_scene, _media_scene,  # noqa: E402
                                 _mods, _texture_scene)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the route, the instance, the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device, hook, route", [
    ("cuda", None, "kernel"), ("cpu", None, "plain"),
    ("cuda", "closest_hit", "kernel"), ("cuda", "any_hit", "kernel"),
    ("cuda", "miss", "kernel"), ("cuda", "intersection", "kernel"),
    ("cuda", "raygen", "kernel"), ("cuda", "post_shade", "kernel"),
    ("cpu", "raygen", "plain"),
])
def test_bounce_route(device, hook, route):
    """K10 on the card, whatever kernels are pushed (those on a seam
    inside the bounce run between K10's passes); the plain bounce on the
    CPU. The route a path context takes is the rule's."""
    hooks = None if hook is None else KernelHooks(**{hook: lambda *a: a[-1]})
    assert k10.bounce_route(torch.device(device)) == route
    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu")
    settings = RenderSettings(width=8, height=8, max_depth=1, tile_size=64)
    pix = torch.arange(64, dtype=torch.int64)
    profiling.reset()
    profiling.enable()
    try:
        init_state, bounce_pre, _ = tint._path_context(
            dev, None, Uniforms.default("cpu"), pix, 0, settings, 8, None, hooks)
        o = torch.zeros((64, 3))
        d = torch.tensor([0.0, 0.0, -1.0]).expand(64, 3).contiguous()
        bounce_pre(0, init_state(o, d))
        counted = [c["labels"] for c in profiling.counters() if c["name"] == "shade.bounce"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counted == [{"route": "plain"}]


@pytest.mark.parametrize("disney, trans, env, key", [
    (False, False, False, (0, 0, 0)), (False, True, False, (0, 0, 0)),
    (False, True, True, (0, 0, 1)), (True, False, False, (1, 0, 0)),
    (True, True, False, (1, 1, 0)), (True, True, True, (1, 1, 1)),
    (True, False, True, (1, 0, 1)),
])
def test_instance_key(disney, trans, env, key):
    """The capability flags pick the template instance; transmission only
    with Disney, whose lobe it is. Every key is one the kernel's
    dispatch builds."""
    assert k10.instance(disney, trans, env) == key
    src = open(CSRC).read()
    built = {int(c) for c in re.findall(r"case (\d+): return static_cast<int>\(launch<", src)}
    assert 4 * key[0] + 2 * key[1] + key[2] in built


@pytest.mark.parametrize("n", [1, 5, 1024, 4099])
@pytest.mark.parametrize("env, scatter", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_layout_segments(n, env, scatter):
    """Each segment starts on a 16-byte boundary, none overlaps the
    next, the buffer holds them all; a segment this bounce does not
    write is -1 and takes no room."""
    offs, size = k10.layout(n, env, scatter)
    q = 3 if env else 2
    assert len(offs) == len(k10.SEGMENTS) == k10._NUM_SEGS
    widths = {"3q": 3 * q, "q": q}
    end = 0
    for (name, width), off in zip(k10.SEGMENTS, offs):
        present = not ((name in ("new_density", "new_g", "new_color") and not scatter)
                       or (name == "env_contrib" and not env))
        assert (off >= 0) == present, name
        if not present:
            continue
        size_f = -(-q * n // 4) if width == "m" else widths.get(width, width) * n
        assert off % 4 == 0 and off >= end, name
        end = off + size_f
    assert end <= size < end + 4


@pytest.mark.parametrize("env, aov, scatter", [(False, False, False), (True, True, True)])
def test_views_of_the_buffer(env, aov, scatter):
    """`views`: the dict's fields are views of one buffer at the layout's
    offsets (float32, masks bool), the query rows are extension, shadow
    (and environment) rows in that order, and a field this bounce leaves
    as it was is the state's own tensor; the first bounce's albedo and
    normal are views of a buffer of their own."""
    n = 7
    offs, size = k10.layout(n, env, scatter)
    out = torch.arange(size, dtype=torch.float32)
    aov = torch.arange(6 * n, dtype=torch.float32).view(2, n, 3) if aov else None
    st = {k: torch.full((n, 3) if k in ("albedo", "normal", "med_color") else (n,), -1.0)
          for k in ("albedo", "normal", "med_density", "med_g", "med_color", "rays")}
    c = k10.views(out, aov, n, offs, env, st)
    seg = dict(zip((s[0] for s in k10.SEGMENTS), offs))
    qo, qd, qt = c.pop("query")
    q = 3 if env else 2
    assert qo.shape == (q * n, 3) and qd.shape == (q * n, 3) and qt.shape == (q * n,)
    assert float(qo[0, 0]) == seg["q_o"] and float(qd[0, 0]) == seg["q_d"]
    assert float(qt[0]) == seg["q_t"]
    for key, (t, row) in dict(next_o=(qo, 0), shadow_o=(qo, 1), next_d=(qd, 0),
                              nee_dir=(qd, 1), ext_tmax=(qt, 0), nee_tmax=(qt, 1)).items():
        assert c[key].data_ptr() == t[row * n:].data_ptr(), key
    for key, width in (("radiance", 3), ("next_tp", 3), ("next_pdf", 1), ("path_dist", 1),
                       ("nee_contrib", 3), ("r_alpha", 4)):
        assert c[key].dtype == torch.float32 and c[key].is_contiguous()
        assert c[key].shape == ((n, width) if width > 1 else (n,))
        assert float(c[key].reshape(-1)[0]) == seg[key], key
    for key in ("active", "candidate") + (("cand_e",) if env else ()):
        assert c[key].dtype == torch.bool and c[key].shape == (n,)
    masks = out.view(torch.uint8)[4 * seg["masks"]:]
    assert c["candidate"].data_ptr() == masks[n:].data_ptr()
    if env:
        assert c["wi_e"].data_ptr() == qd[2 * n:].data_ptr()
        assert c["env_tmax"].data_ptr() == qt[2 * n:].data_ptr()
        assert c["cand_e"].data_ptr() == masks[2 * n:].data_ptr()
    assert (c["st_albedo"] is st["albedo"]) == (aov is None)
    assert (c["new_color"] is st["med_color"]) == (not scatter)
    assert c["rays"] is st["rays"]
    if aov is not None:
        assert c["st_albedo"].data_ptr() == aov.data_ptr()
        assert c["st_normal"].data_ptr() == aov[1].data_ptr()
        assert c["st_normal"].shape == (n, 3) and c["st_normal"].is_contiguous()


def test_source_mirrors_the_wrapper():
    """csrc/shade_bounce.cu's segment enum is `SEGMENTS` in order, and
    its HalaBounceArgs is `BounceArgs` field for field."""
    src = open(CSRC).read()
    enum = re.search(r"enum Seg \{(.*?)\};", src, re.S).group(1)
    names = [e.strip() for e in enum.replace("\n", " ").split(",") if e.strip()]
    assert names[-1] == "kNumSegs" and len(names) - 1 == k10._NUM_SEGS == len(k10.SEGMENTS)
    body = re.search(r"struct HalaBounceArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(?:const )?([\w ]+?)(\*?)\s*(\w+)(\[\w+\])?;$", line)
        assert m, line
        fields.append((m.group(3), "p" if m.group(2) else m.group(1).strip()))
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "int", ctypes.c_longlong: "long long",
             ctypes.c_float: "float"}
    want = []
    for name, ctype in k10.BounceArgs._fields_:
        kind = kinds.get(ctype, "long long")  # the offsets: long long[kNumSegs]
        want.append((name, kind))
    assert fields == want
    seam = re.search(r"enum SeamSeg \{(.*?)\};", src, re.S).group(1)
    at = dict(re.findall(r"(k\w+) = (\d+)", seam))
    for names, segments, end in (
            (("kSeamLhT", "kSeamLhPdf", "kSeamLhRad", "kSeamEnvRad"), k10.RAY_SEAMS,
             "kRaySeamEnd"),
            (("kSeamP", "kSeamNs", "kSeamNg", "kSeamBase", "kSeamEmission", "kSeamMetallic",
              "kSeamRoughness", "kSeamAx", "kSeamAy", "kSeamIor", "kSeamRAlpha",
              "kSeamOnSurface"), k10.HIT_SEAMS, "kHitSeamEnd")):
        off = 0
        for name, (_, width) in zip(names, segments, strict=True):
            assert int(at[name]) == off, name
            off += 1 if width == "m" else width
        assert int(at[end]) == off == k10._seam_size(segments)


@pytest.mark.parametrize("segments", ["ray", "hit"])
def test_seam_views_of_the_buffer(segments):
    """`seam_views`: each field a view of the seam pass's buffer at k * n
    floats, (n,) or (n, width) float32 with a lane's values side by
    side, on_surface n bytes viewed as bool."""
    segs = k10.RAY_SEAMS if segments == "ray" else k10.HIT_SEAMS
    n = 5
    buf = torch.arange(k10._seam_size(segs) * n, dtype=torch.float32)
    v = k10.seam_views(buf, n, segs)
    assert list(v) == [name for name, _ in segs]
    at = 0
    for name, width in segs:
        t = v[name]
        if width == "m":
            assert t.dtype == torch.bool and t.shape == (n,)
            assert t.data_ptr() == buf[at * n:].data_ptr()
            at += 1
            continue
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.shape == ((n, width) if width > 1 else (n,))
        assert float(t.reshape(-1)[0]) == at * n and float(t.reshape(-1)[-1]) == (
            at + width) * n - 1
        at += width


def test_lane_makes_a_pushed_kernels_result_whole():
    """`_lane`: a pushed kernel's expanded or broadcast result becomes
    an (n,) or (n, width) contiguous tensor of K10's dtype, its values
    as they were; one already so is not copied."""
    x = torch.tensor([0.0, 5.0, 0.0]).expand(4, 3)
    t = k10._lane(x, 4, 3, torch.float32)
    assert t.is_contiguous() and torch.equal(t, x)
    assert torch.equal(k10._lane(torch.tensor(1), 4, 1, torch.bool), torch.ones(4, dtype=bool))
    y = torch.rand(4, 3)
    assert k10._lane(y, 4, 3, torch.float32).data_ptr() == y.data_ptr()  # no copy


def test_front_reads_nothing_without_maps_or_spheres():
    """On a scene without textures or spheres the fetch reads neither the
    path length nor the hit point: `front` launches nothing and hands
    the state's path lengths on."""
    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu")
    pix = torch.arange(16, dtype=torch.int64)
    ctx = k10.Context(dev, None, Uniforms.default("cpu"), pix, 3, None, 4, 2)
    st = {"path_dist": torch.zeros(16)}
    before = cuda_lib.SHADE_BOUNCE_PRE.launches
    pd, hit_p = k10.front(ctx, 0, st)
    assert pd is st["path_dist"] and hit_p is None
    assert cuda_lib.SHADE_BOUNCE_PRE.launches == before
    assert (ctx.disney, ctx.transmission, ctx.env_map) == k10.instance(
        dev.materials.has_disney, dev.materials.has_transmission, False)
    assert ctx.args.frame0 == 3 and ctx.args.n == 16 and ctx.args.q == 2


def test_context_checks_its_tables():
    """A table on another device or of another dtype is refused before
    anything launches."""
    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu")
    pix = torch.arange(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="shade_bounce"):
        k10.Context(dev, None, Uniforms.default("cpu"), pix.to(torch.int32), 0, None, 4, 2)
    with pytest.raises(ValueError, match="blue noise"):
        k10.Context(dev, None, Uniforms.default("cpu"), pix, 0, torch.rand(8, 8, 3), 4, 2)


def test_shade_bounce_counted_once_a_bounce_and_tile():
    """`shade.bounce` counts once a bounce and tile, labelled with the
    route (plain on the CPU), and `hala.shade.bounce` sits inside each
    bounce's first `hala.shade` span."""
    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu")
    settings = RenderSettings(width=32, height=32, max_depth=3, tile_size=512)
    film = Film.create(32, 32, "cpu")
    profiling.reset()
    profiling.enable()
    try:
        tint.render_frame(dev, None, Uniforms.default("cpu"), film, 0, settings)
        counters = [c for c in profiling.counters() if c["name"] == "shade.bounce"]
        spans = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    assert counters == [{"name": "shade.bounce", "labels": {"route": "plain"}, "value": 2 * 3}]
    by_index = {s.index: s for s in spans}
    bounces = [s for s in spans if s.name == "hala.shade.bounce"]
    assert len(bounces) == 2 * 3
    for s in bounces:
        parent = by_index[s.parent]
        assert parent.name == "hala.shade" and s.attrs == {"route": "plain"}
    fetches = [s for s in spans if s.name == "hala.shade.fetch"]
    assert all(by_index[s.parent].name == "hala.shade.bounce" for s in fetches)


# ---------------------------------------------------------------------------
# K10's source on the host
# ---------------------------------------------------------------------------

# The CUDA built-ins the source uses, for a host build: one lane a call.
_HOST_STUB = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <algorithm>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
struct HostIdx { long long x; };
static HostIdx blockIdx, threadIdx;
using std::isnan; using std::max; using std::min;
"""


@pytest.fixture(scope="module")
def host_k10(tmp_path_factory):
    """K10's source built for the host: each launch a loop over the lanes."""
    src = open(CSRC).read()
    loop = ("for (long long j = 0; j < a.n; ++j) {{ blockIdx.x = j / kBlock; "
            "threadIdx.x = j % kBlock; {}; }}")
    launches = {
        "shade_bounce_pre_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);":
            loop.format("shade_bounce_pre_kernel(a)"),
        "shade_bounce_seam_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>"
        "(a, phase);": loop.format("shade_bounce_seam_kernel(a, phase)"),
        "shade_bounce_kernel<kDisney, kTrans, kEnv><<<grid, kBlock, 0, s>>>(a);":
            loop.format("shade_bounce_kernel<kDisney, kTrans, kEnv>(a)"),
    }
    for old, new in launches.items():
        assert old in src
        src = src.replace(old, new)
    assert "<<<" not in src
    d = tmp_path_factory.mktemp("k10_host")
    (d / "cuda_runtime.h").write_text(_HOST_STUB)
    (d / "k10.cpp").write_text(src)
    so = d / "libk10.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so), str(d / "k10.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.hala_shade_bounce.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.hala_shade_bounce_pre.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.hala_shade_bounce_seam.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


@pytest.fixture
def host_route(host_k10, monkeypatch):
    """The integrator's kernel route on CPU tensors, K10 the host build."""
    def bounce(addr, disney, trans, env, stream):
        assert host_k10.hala_shade_bounce(addr, disney, trans, env, None) == 0

    def pre(addr, stream):
        assert host_k10.hala_shade_bounce_pre(addr, None) == 0

    def seam(addr, phase, stream):
        assert host_k10.hala_shade_bounce_seam(addr, phase, None) == 0

    monkeypatch.setattr(cuda_lib, "SHADE_BOUNCE", bounce)
    monkeypatch.setattr(cuda_lib, "SHADE_BOUNCE_PRE", pre)
    monkeypatch.setattr(cuda_lib, "SHADE_BOUNCE_SEAM", seam)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: None)
    monkeypatch.setattr(k10, "bounce_route", lambda device: "kernel")


def _host_case(name):
    m = _mods("hala_tpu_torch")
    up = lambda h: SceneUploader.upload(h, use_ray_tracing=False, device="cpu")  # noqa: E731
    env = lambda: EnvMap.from_array(chip_smoke.bench_envmap_array(), device="cpu")  # noqa: E731
    bn = lambda: torch.rand((64, 64, 4), generator=torch.Generator().manual_seed(5))  # noqa: E731
    return {
        "cornell": lambda: (up(cornell_box()), {}),
        "lights_and_glass": lambda: (up(_lights_scene(m)), {}),
        "media": lambda: (up(_media_scene(m)), dict(depth=6)),
        "textures": lambda: (up(_texture_scene(m)), {}),
        "alpha": lambda: (up(_alpha_scene(m)), {}),
        "envmap_glass": lambda: (up(_lights_scene(m)), dict(env=env())),
        "blue_noise": lambda: (up(cornell_box()), dict(blue_noise=bn())),
        "procedural": lambda: (up(chip_smoke.procedural_scene()), {}),
        "atrium": lambda: (up(Scene.load(os.path.join(ROOT, "assets", "atrium.glb"))), {}),
    }[name]()


@pytest.mark.parametrize("name", ["cornell", "lights_and_glass", "media", "textures",
                                  "alpha", "envmap_glass", "blue_noise", "procedural",
                                  "atrium"])
def test_kernel_source_on_the_host_matches_plain(host_route, name):
    """Every bounce of a 24x24 tile through K10's source (the host build)
    and through the plain bounce on the same state: masks and the query
    rows' layout exactly, floats within 2e-3 relative (the host's libm
    and PyTorch's CPU kernels round a few transcendentals differently,
    by an ulp, which the Disney lobes amplify). Covers Oren-Nayar and
    Disney with transmission, all five light types, the three media,
    normal and metallic-roughness maps, the alpha test, the environment
    map's eval and NEE, blue noise and procedural spheres."""
    scene, kw = _host_case(name)
    _close_to_plain(chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu", **kw),
                    kw.get("depth", 4))


def _close_to_plain(pairs, depth):
    """Masks and the query rows' layout exactly, floats within 2e-3
    relative, on each of `depth` bounces of `pairs` (bounce_pairs)."""
    seen = 0
    for b, st, got, ref in pairs:
        diff = chip_smoke.bounce_diff(got, ref)
        assert "keys" not in diff, diff
        for key in list(diff):
            field = "query" if key.startswith("query") else key
            assert diff[key][0] != "shape", (key, diff[key])
            x = got[field] if field != "query" else got["query"]["odt".index(key[-1])]
            assert x.dtype.is_floating_point, (b, key, diff[key])
        for key, x in got.items():
            if key == "query":
                continue
            y = ref[key]
            if x.dtype.is_floating_point:
                assert torch.allclose(x, y, rtol=2e-3, atol=1e-6, equal_nan=True), (
                    b, key, float((x - y).abs().max()))
            else:
                assert torch.equal(x, y), (b, key)
        seen += 1
    assert seen == depth


@pytest.mark.parametrize("name, kind", [
    ("cornell", "intersection"), ("cornell", "miss"), ("envmap_glass", "miss"),
    ("textures", "closest_hit"), ("lights_and_glass", "closest_hit"), ("alpha", "any_hit"),
    ("media", "all"), ("procedural", "all"),
])
def test_kernel_source_with_pushed_kernels_matches_plain(host_route, name, kind):
    """Pushed kernels on the seams inside the bounce (chip_smoke
    `seam_hooks`) run between K10's passes: every bounce of a 24x24
    tile through K10's host build with them against the plain bounce
    with them, masks exactly and floats within 2e-3 relative, and the
    pushed kernels change the result (a test that could not see a seam
    ignored would prove nothing)."""
    scene, kw = _host_case(name)
    hooks = chip_smoke.seam_hooks(kind)
    _close_to_plain(chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu", hooks=hooks,
                                            **kw), kw.get("depth", 4))
    bare = chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu", **kw)
    pushed = chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu", hooks=hooks, **kw)
    assert any(not torch.equal(p[2][k], b[2][k]) for b, p in zip(bare, pushed)
               for k in ("radiance", "active", "next_d", "next_tp", "st_albedo"))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", ["textures", "envmap_glass", "media"])
def test_kernel_source_with_identity_kernels_is_unchanged(host_route, name):
    """Identity kernels on all four seams: K10's seam passes hand back
    what K10 computes itself, so each bounce's dict equals the one with
    no pushed kernel bit for bit, and each bounce ran both seam passes."""
    scene, kw = _host_case(name)
    launches = []
    seam = cuda_lib.SHADE_BOUNCE_SEAM

    def counted(addr, phase, stream):
        launches.append(phase)
        seam(addr, phase, stream)

    bare = chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu", **kw)
    cuda_lib.SHADE_BOUNCE_SEAM = counted
    try:
        pushed = list(chip_smoke.bounce_pairs(scene, size=(24, 24), device="cpu",
                                              hooks=chip_smoke.seam_hooks("identity"), **kw))
    finally:
        cuda_lib.SHADE_BOUNCE_SEAM = seam
    depth = kw.get("depth", 4)
    # each bounce: the pair's K10 route, then bounce_body's
    assert sorted(launches) == [0] * (2 * depth) + [1] * (2 * depth)
    for (b, _, got_bare, _), (_, _, got, _) in zip(bare, pushed, strict=True):
        assert sorted(got) == sorted(got_bare)
        for key, x in got_bare.items():
            for xi, yi in zip(x, got[key]) if key == "query" else [(x, got[key])]:
                assert torch.equal(_bits(xi), _bits(yi)), (b, key)
