"""The shading point's surface fetch (`ops/shade_fetch.py`) on the CPU.

`shade_fetch_plain` against the fetch as `bounce_pre` wrote it inline
(kept below as `_inline_fetch`), bit for bit, on seeded tables that
cover 32- and 48-column rows, normal maps, uv transforms, one or more
mip levels, REPEAT wrap, map index -1, misses, ids past the table, both
ends of the LOD clamp and procedural spheres, and on uploaded scenes;
the router `shade_fetch` with rows given a lane; the route chooser;
the `shade.fetch` counter and span; K9's output layout against the
kernel's source. K9 itself runs only on the card
(tests/test_torch_cuda.py).
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.ops import shade_fetch as sf
from hala_tpu_torch.ops.bsdf import gather_materials
from hala_tpu_torch.ops.gathers import take_rows
from hala_tpu_torch.ops.intersect import Hit
from hala_tpu_torch.ops.prims import PROC_BASE
from hala_tpu_torch.ops.sampling import dot, normalize
from hala_tpu_torch.ops.texture import sample_textures_packed
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.gpu.scene import DeviceProcedural, TextureStack
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
ATRIUM = os.path.join(HERE, "..", "assets", "atrium.glb")
CSRC = os.path.join(HERE, "..", "hala_tpu_torch", "csrc", "shade_fetch.cu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inline_fetch(scene, hit, hit_p, path_dist, pixel_angle):
    """The fetch as models/integrator.py `bounce_pre` computed it inline
    (unsharded rows), kept verbatim as the reference."""
    rows_n = scene.geometry.shade_table.shape[0]
    u, v = hit.u, hit.v
    w0 = 1.0 - u - v
    rows = take_rows(scene.geometry.shade_table, torch.clamp(hit.tri, 0, rows_n - 1))
    ns = normalize(
        w0[:, None] * rows[:, 0:3]
        + u[:, None] * rows[:, 3:6]
        + v[:, None] * rows[:, 6:9]
    )
    uv = (
        w0[:, None] * rows[:, 9:11]
        + u[:, None] * rows[:, 11:13]
        + v[:, None] * rows[:, 13:15]
    )
    ng = rows[:, 15:18]
    ng = torch.where((dot(ng, ns) < 0)[:, None], -ng, ng)
    mat_idx = rows[:, 18].to(torch.int32)
    is_proc = prow = None
    if scene.procedural is not None:
        is_proc = hit.tri >= PROC_BASE
        pid = torch.clamp(hit.tri - PROC_BASE, 0,
                          scene.procedural.center.shape[0] - 1).long()
        prow = scene.procedural.packed[pid]
        ns_p = normalize(hit_p - prow[:, 0:3])
        ns = torch.where(is_proc[:, None], ns_p, ns)
        ng = torch.where(is_proc[:, None], ns_p, ng)
        uv = torch.where(is_proc[:, None], torch.stack([u, v], dim=1), uv)
        mat_idx = torch.where(is_proc, prow[:, 4].to(torch.int32), mat_idx)
    mp = gather_materials(scene.materials, mat_idx)
    if rows.shape[1] > 32:
        vcol = (
            w0[:, None] * rows[:, 32:35]
            + u[:, None] * rows[:, 35:38]
            + v[:, None] * rows[:, 38:41]
        )
        if is_proc is not None:
            vcol = torch.where(is_proc[:, None], 1.0, vcol)
        mp = mp._replace(base_color=mp.base_color * vcol)
    if scene.materials.has_uv_transform:
        uvt = scene.materials.uv_transform[torch.clamp(mat_idx, min=0).long()]
        su = uv[:, 0] * uvt[:, 3]
        sv = uv[:, 1] * uvt[:, 4]
        cr = torch.cos(uvt[:, 2])
        sr = torch.sin(uvt[:, 2])
        uv = torch.stack(
            [uvt[:, 0] + cr * su + sr * sv, uvt[:, 1] - sr * su + cr * sv],
            dim=1,
        )
    tan_raw = (
        w0[:, None] * rows[:, 20:23]
        + u[:, None] * rows[:, 23:26]
        + v[:, None] * rows[:, 26:29]
    )
    if is_proc is not None:
        tan_raw = torch.where(is_proc[:, None], 0.0, tan_raw)
    base_t = mr_t = em_t = n_tex = None
    if scene.textures is not None:
        uv_dens = rows[:, 29]
        if is_proc is not None:
            uv_dens = torch.where(
                is_proc, 1.0 / torch.clamp(2.0 * np.pi * prow[:, 3], min=1e-6),
                uv_dens)
        lod_uv = torch.log2(
            torch.clamp(path_dist * pixel_angle * uv_dens, 1e-6, 1e6)
        )
        maps = [mp.base_color_map, mp.metallic_roughness_map, mp.emission_map]
        map_lods = [lod_uv, lod_uv, lod_uv]
        if scene.materials.has_normal_map:
            maps.append(mp.normal_map)
            map_lods.append(None)
        fetched = sample_textures_packed(scene.textures, maps, uv, lods=map_lods)
        base_t, mr_t, em_t = fetched[:3]
        if scene.materials.has_normal_map:
            n_tex = fetched[3]
    return (ns, uv, ng, tan_raw, mat_idx, mp, base_t, mr_t, em_t, n_tex)


def fetch_case(cols=48, normal_map=True, uv_transform=True, levels=5, n=4096,
               seed=0, device="cpu", textures=True, spheres=False):
    """Seeded tables and hits for the fetch: (scene, hit, hit_p,
    path_dist, pixel_angle). uv spans [-2, 3] (REPEAT both ways), map
    ids include -1, hits include misses (-1) and ids past the table,
    path lengths and uv densities reach both ends of the LOD clamp;
    with `spheres`, a fifth of the hits are procedural ids."""
    rs = np.random.RandomState(seed)
    t_rows, n_mats, n_tex, h, w = 300, 8, 5, 16, 16
    table = rs.normal(size=(t_rows, cols)).astype(np.float32)
    table[:, 9:15] = rs.uniform(-2.0, 3.0, (t_rows, 6))
    table[:, 18] = rs.randint(0, n_mats, t_rows)
    table[:, 29] = np.exp(rs.uniform(-12.0, 12.0, t_rows))
    if cols > 32:
        table[:, 32:41] = rs.uniform(0.0, 1.0, (t_rows, 9))
    packed = rs.uniform(0.0, 1.0, (n_mats, 32)).astype(np.float32)
    packed[:, 22] = rs.randint(0, 2, n_mats)
    packed[:, 23:27] = rs.randint(-1, n_tex, (n_mats, 4))
    packed[0, 23:27] = -1
    uvt = np.concatenate([rs.uniform(-1, 1, (n_mats, 2)), rs.uniform(-3, 3, (n_mats, 1)),
                          rs.uniform(0.5, 3.0, (n_mats, 2))], 1).astype(np.float32)
    sizes = np.array([[16, 16], [8, 16], [16, 4], [5, 7], [1, 1]], np.int32)
    data = rs.uniform(0.0, 1.0, (n_tex, 2 * h, w, 4)).astype(np.float32)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    mats = types.SimpleNamespace(packed=f(packed), uv_transform=f(uvt),
                                 has_uv_transform=uv_transform, has_normal_map=normal_map)
    stack = (TextureStack(data=f(data), sizes=f(sizes), num_textures=n_tex,
                          num_levels=levels) if textures else None)
    proc = None
    tri = rs.randint(-1, t_rows + 40, n).astype(np.int32)
    tri[:4] = [-1, t_rows - 1, t_rows, t_rows + 1000]
    if spheres:
        centers = rs.uniform(-1, 1, (3, 3)).astype(np.float32)
        radii = rs.uniform(0.1, 0.5, 3).astype(np.float32)
        pmat = rs.randint(0, n_mats, 3).astype(np.int32)
        pp = np.zeros((3, 8), np.float32)
        pp[:, 0:3], pp[:, 3], pp[:, 4] = centers, radii, pmat
        proc = DeviceProcedural(center=f(centers), radius=f(radii), mat=f(pmat),
                                packed=f(pp), num_prims=3)
        pick = rs.uniform(size=n) < 0.2
        tri[pick] = PROC_BASE + rs.randint(0, 3, int(pick.sum()))
    u = rs.uniform(0, 1, n).astype(np.float32)
    v = rs.uniform(0, 1, n).astype(np.float32)
    pd = rs.uniform(0, 100, n).astype(np.float32)
    pd[4:8] = [0.0, 1e9, 3e38, 1e-30]
    scene = types.SimpleNamespace(
        geometry=types.SimpleNamespace(shade_table=f(table)), materials=mats,
        textures=stack, procedural=proc)
    hit = Hit(t=f(rs.uniform(0, 10, n).astype(np.float32)), tri=f(tri), u=f(u), v=f(v))
    hit_p = f(rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    return scene, hit, hit_p, f(pd), torch.tensor(1e-3, device=device)


def assert_fetch_equal(got, ref):
    """Every field of two fetches (a SurfaceFetch, or _inline_fetch's
    tuple in its order) holds the same bits."""
    for name, a, b in zip(sf.SurfaceFetch._fields, got, ref):
        if name == "mp":
            for field, x, y in zip(a._fields, a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), field
        elif a is None or b is None:
            assert a is None and b is None, name
        else:
            assert a.dtype == b.dtype, name
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


def _plain(scene, hit, hit_p, pd, pa):
    rows = take_rows(scene.geometry.shade_table,
                     torch.clamp(hit.tri, 0, scene.geometry.shade_table.shape[0] - 1))
    return sf.shade_fetch_plain(scene, rows, hit, hit_p, pd, pa)


@pytest.mark.parametrize("levels", [1, 5])
@pytest.mark.parametrize("uv_transform", [False, True])
@pytest.mark.parametrize("normal_map", [False, True])
@pytest.mark.parametrize("cols", [32, 48])
def test_plain_equals_the_inline_fetch(cols, normal_map, uv_transform, levels):
    case = fetch_case(cols, normal_map, uv_transform, levels, seed=cols + levels)
    assert_fetch_equal(_plain(*case), _inline_fetch(*case))


@pytest.mark.parametrize("textures", [False, True])
def test_plain_equals_the_inline_fetch_with_spheres(textures):
    case = fetch_case(textures=textures, spheres=True, seed=11)
    assert (case[1].tri >= PROC_BASE).any()
    assert_fetch_equal(_plain(*case), _inline_fetch(*case))


def _textured_host():
    from test_torch_features import _mods, _texture_scene

    return _texture_scene(_mods("hala_tpu_torch"))


@pytest.mark.parametrize("name", ["textures", "atrium", "cornell"])
def test_plain_equals_the_inline_fetch_on_uploads(name):
    """Uploaded tables: the feature scene (48-column rows, uv transform,
    normal map), atrium.glb (a mip pyramid, three maps), the Cornell box
    (no textures)."""
    host = {"textures": _textured_host, "cornell": cornell_box,
            "atrium": lambda: Scene.load(ATRIUM)}[name]()
    dev = SceneUploader.upload(host, use_ray_tracing=False, device="cpu")
    if name == "textures":
        assert dev.geometry.shade_table.shape[1] == 48
        assert dev.materials.has_uv_transform and dev.materials.has_normal_map
    if name == "atrium":
        assert dev.textures.num_levels > 1
    rs = np.random.RandomState(3)
    n, rows = 2048, dev.geometry.shade_table.shape[0]
    hit = Hit(t=torch.from_numpy(rs.uniform(0, 5, n).astype(np.float32)),
              tri=torch.from_numpy(rs.randint(-1, rows + 5, n).astype(np.int32)),
              u=torch.from_numpy(rs.uniform(0, 0.5, n).astype(np.float32)),
              v=torch.from_numpy(rs.uniform(0, 0.5, n).astype(np.float32)))
    pd = torch.from_numpy(rs.uniform(0, 40, n).astype(np.float32))
    hit_p = torch.zeros((n, 3))
    case = (dev, hit, hit_p, pd, torch.tensor(2e-3))
    assert_fetch_equal(_plain(*case), _inline_fetch(*case))
    # the router runs the plain version on CPU tensors
    assert_fetch_equal(sf.shade_fetch(*case), _inline_fetch(*case))


@pytest.mark.parametrize("device, axis, spheres, route", [
    ("cpu", False, False, "plain"),
    ("cuda", False, False, "kernel"),
    ("cuda", True, False, "kernel"),
    ("cuda", False, True, "kernel"),
    ("cpu", True, True, "plain"),
])
def test_fetch_route(device, axis, spheres, route):
    """K9 for every hit on the card, shade rows sharded across ranks
    and procedural spheres included; the plain version on the CPU.
    On the CPU the router's result is the inline fetch's, with the
    shade rows given a lane where they are sharded."""
    assert sf.fetch_route(torch.device(device)) == route
    if device != "cpu":
        return
    case = fetch_case(spheres=spheres, seed=13)
    scene, hit = case[0], case[1]
    rows = None
    if axis:
        table = scene.geometry.shade_table
        rows = take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))
    profiling.reset()
    profiling.enable()
    try:
        got = sf.shade_fetch(*case, rows)
        counters = profiling.counters()
    finally:
        profiling.disable()
        profiling.reset()
    assert counters == [{"name": "shade.fetch", "labels": {"route": route}, "value": 1}]
    assert_fetch_equal(got, _inline_fetch(*case))


@pytest.mark.parametrize("spheres", [False, True])
@pytest.mark.parametrize("cols", [32, 48])
def test_rows_given_a_lane_are_read_a_lane(cols, spheres):
    """Rows passed to `shade_fetch` are lane i's row for lane i, and the
    hit ids then pick nothing but the procedural override: permuted
    rows give the plain fetch over the same permuted rows, and differ
    from the table's own."""
    case = fetch_case(cols, spheres=spheres, n=1024, seed=17 + cols)
    scene, hit = case[0], case[1]
    table = scene.geometry.shade_table
    own = take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))
    perm = torch.from_numpy(np.random.RandomState(5).permutation(hit.tri.shape[0]))
    rows = own[perm]
    got = sf.shade_fetch(*case, rows)
    assert_fetch_equal(got, sf.shade_fetch_plain(scene, rows, hit, *case[2:]))
    assert not torch.equal(got.ns, sf.shade_fetch(*case).ns)
    if spheres:
        is_proc = hit.tri >= PROC_BASE
        assert is_proc.any()
        ref = _inline_fetch(*case)
        assert torch.equal(got.ns[is_proc], ref[0][is_proc])


def test_segments_match_the_kernel_source():
    """SEGMENTS, the wrapper's view of K9's output buffer, sits at the
    kSeg* offsets csrc/shade_fetch.cu writes."""
    src = open(CSRC).read()
    offsets = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (kSeg\w+) = (\d+);", src)}
    at, off = {}, 0
    for name, width, *_ in sf.SEGMENTS:
        at[name] = off
        off += width
    want = {"kSegNs": "ns", "kSegUv": "uv", "kSegNg": "ng", "kSegTan": "tan_raw",
            "kSegMatIdx": "mat_idx", "kSegBase": "base_color", "kSegEmission": "emission",
            "kSegScalars": "opacity", "kSegCoatTint": "clearcoat_tint",
            "kSegScalars2": "specular_transmission", "kSegMatType": "mat_type",
            "kSegSigma": "medium_sigma", "kSegMaps": "base_color_map"}
    assert {k: at[v] for k, v in want.items()} == {k: offsets[k] for k in want}
    assert offsets["kSegTexels"] == off == 42
    ints = [s[0] for s in sf.SEGMENTS if len(s) > 2]
    assert ints == ["mat_idx", "mat_type", "base_color_map", "metallic_roughness_map",
                    "emission_map", "normal_map"]


@pytest.mark.parametrize("n_maps", [0, 3, 4])
def test_views_are_contiguous_fields_of_one_buffer(n_maps):
    """The views K9's wrapper hands out: the right shapes and dtypes,
    each contiguous, none overlapping, covering the buffer."""
    n = 5
    out = torch.arange((42 + 4 * n_maps) * n, dtype=torch.float32)
    got = sf._views(out, n, n_maps)
    fields = [x for x in got if x is not None and not isinstance(x, tuple)] + list(got.mp)
    assert all(x.is_contiguous() and x.shape[0] == n for x in fields)
    assert sum(x.numel() for x in fields) == out.numel()
    assert got.mat_idx.dtype == got.mp.mat_type.dtype == torch.int32
    assert got.ns.shape == (n, 3) and got.uv.shape == (n, 2) and got.mp.ior.shape == (n,)
    assert (got.base_t is None) == (n_maps == 0) and (got.n_tex is None) == (n_maps < 4)
    assert float(got.uv[0, 0]) == 3 * n  # the second segment, lane 0


@pytest.mark.parametrize("scene", ["cornell", "textures"])
def test_shade_fetch_counter_and_span(scene):
    """`shade.fetch` counts once per bounce_pre call, route "plain" on the
    CPU, and each `hala.shade.fetch` span sits inside the bounce's
    `hala.shade.bounce`, inside a `hala.shade`."""
    host = cornell_box() if scene == "cornell" else _textured_host()
    dev = SceneUploader.upload(host, use_ray_tracing=False, device="cpu")
    size, depth, frames = 16, 3, 2
    settings = tint.RenderSettings(width=size, height=size, max_depth=depth,
                                   tile_size=size * size // 2)
    film = tint.Film.create(size, size, "cpu")
    profiling.reset()
    profiling.enable()
    try:
        for f in range(frames):
            tint.render_frame(dev, None, tint.Uniforms.default("cpu"), film, f, settings)
        counters = profiling.counters()
        spans = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    fetch = [c for c in counters if c["name"] == "shade.fetch"]
    assert [c["labels"] for c in fetch] == [{"route": "plain"}]
    assert fetch[0]["value"] == frames * 2 * depth  # two tiles a frame
    by_index = {s.index: s for s in spans}
    inner = [s for s in spans if s.name == "hala.shade.fetch"]
    assert len(inner) == frames * 2 * depth
    assert all(by_index[s.parent].name == "hala.shade.bounce" for s in inner)
    assert all(by_index[by_index[s.parent].parent].name == "hala.shade" for s in inner)
    assert all(s.attrs == {"route": "plain"} for s in inner)
