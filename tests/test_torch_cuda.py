"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports neither jax nor hala_tpu, so it also runs on a machine
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from hala_tpu_torch.models.integrator import Film, RenderSettings, Uniforms, render_frame
from hala_tpu_torch.ops import cluster as k6
from hala_tpu_torch.ops import compaction
from hala_tpu_torch.ops import cuda_lib
from hala_tpu_torch.ops import cull as k4
from hala_tpu_torch.ops import query
from hala_tpu_torch.ops import raster_kernel as k3
from hala_tpu_torch.ops import traverse as k2
from hala_tpu_torch.ops import traverse as k5
from hala_tpu_torch.ops import traverse as k8
from hala_tpu_torch.ops import wavefront as k7
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box, random_triangle_soup

HERE = os.path.dirname(__file__)
pytestmark = pytest.mark.cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(HERE)))
sys.path.insert(0, os.path.abspath(HERE))  # the CPU tests' tables (K9)

import chip_smoke  # noqa: E402  (the skip-breaking raster and span tables)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rays(n, seed, center=(0.0, 0.0, 0.0), spread=0.9):
    rs = np.random.RandomState(seed)
    o = np.asarray(center, np.float32) + rs.uniform(-spread, spread, (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = np.eye(3)[[0, 1, 2, 0, 1, 2]] * np.array([1, 1, 1, -1, -1, -1])[:, None]
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_k1_kernel_matches_plain(cuda_device, any_hit):
    g = SceneUploader.upload(random_triangle_soup(300, seed=5), use_ray_tracing=False, device=cuda_device).geometry
    o, d = (x.to(cuda_device) for x in _rays(5000 + 13, 3))
    tm = torch.full((o.shape[0],), 2.0, device=cuda_device)
    tris = (g.tri_v0, g.tri_e1, g.tri_e2)
    before = cuda_lib.INTERSECT_BRUTEFORCE.launches
    if any_hit:
        got = k1.occluded_pallas(o, d, tm, *tris, num_real=300)
        ref = k1.occluded_pallas_plain(o, d, tm, *tris, num_real=300)
        assert torch.equal(got, ref)
    else:
        got = k1.intersect_pallas(o, d, *tris, t_max=tm, num_real=300)
        ref = k1.intersect_pallas_plain(o, d, *tris, t_max=tm, num_real=300)
        assert torch.equal(got.tri, ref.tri) and torch.equal(got.t, ref.t)
        assert torch.equal(got.u, ref.u) and torch.equal(got.v, ref.v)
    assert cuda_lib.INTERSECT_BRUTEFORCE.launches == before + 1


def test_k2_kernel_matches_plain(cuda_device):
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))
    g = SceneUploader.upload(scene, use_ray_tracing=False, device=cuda_device).geometry
    real = g.tri_v0[g.tri_mat >= 0]
    center = ((real.amin(0) + real.amax(0)) / 2).cpu().numpy()
    o, d = (x.to(cuda_device) for x in _rays(4096, 4, center, 2.0))
    tm = torch.full((o.shape[0],), 3.0e38, device=cuda_device)
    tm[1::4] = 2.0
    tm[::13] = 0.0  # dead rays
    before = cuda_lib.MATRIX_TRAVERSE.launches
    got = k2.intersect_matrix(o, d, g, t_max=tm)
    ref = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    assert torch.equal(got.tri, ref.tri) and torch.equal(got.t, ref.t)
    occ = k2.occluded_matrix(o, d, tm, g)
    assert torch.equal(occ, ref.tri >= 0)
    assert cuda_lib.MATRIX_TRAVERSE.launches == before + 2


def test_wrapper_checks_before_launch(cuda_device):
    g = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device=cuda_device).geometry
    o, d = (x.to(cuda_device) for x in _rays(64, 5))
    with pytest.raises(ValueError):
        k1.intersect_pallas(o.double(), d, g.tri_v0, g.tri_e1, g.tri_e2)
    with pytest.raises(ValueError):
        k1.intersect_pallas(o, d.cpu(), g.tri_v0, g.tri_e1, g.tri_e2)


def test_cornell_golden_on_card(cuda_device):
    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device=cuda_device)
    film = Film.create(32, 32, cuda_device)
    uni = Uniforms.default(cuda_device)
    before = cuda_lib.INTERSECT_BRUTEFORCE.launches
    settings = RenderSettings(width=32, height=32, max_depth=3)
    for f in range(8):
        render_frame(dev, None, uni, film, f, settings)
    assert cuda_lib.INTERSECT_BRUTEFORCE.launches > before
    with np.load(os.path.join(HERE, "fixtures", "golden_cornell.npz")) as z:
        rmse = float(np.sqrt(np.mean((film.accum.cpu().numpy() - z["accum"]) ** 2)))
    assert rmse < 1e-3


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k3_kernel_matches_plain(cuda_device, tile):
    """K3 against its plain version, bit for bit, on atrium.glb's
    triangles from its first camera: at tile 16 a unit is the tile,
    tiles 32, 64 and 128 hold 4, 16 and 64 sub-tiles of 16x16."""
    from hala_tpu_torch.models.rz_renderer import RasterSettings, _raster_setup

    scene = SceneUploader.upload(
        Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")), use_ray_tracing=False, device=cuda_device)
    w, h = 320, 192
    tris = _raster_setup(scene, 0, RasterSettings(w, h, binned=True, tile=tile))[:4]
    seg = k3.build_segments(*tris, w, h, tile)
    before = cuda_lib.RASTER_TILED.launches
    got = k3.raster_segments(seg.starts, seg.data, seg.tw, seg.tile)
    ref = k3.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    torch.cuda.synchronize()
    assert cuda_lib.RASTER_TILED.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(seg.over) == 0.0 and int(seg.n_real) > 0


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_k3_skip_breaking_table_matches_plain(cuda_device, tile):
    """K3 against its plain version, bit for bit, on chip_smoke.py's
    table built to break the sub-tile skip: slivers along sub-tile
    borders that the rounded edge functions accept outside their boxes,
    huge triangles, NaN and infinite corners, and at tiles 64 and 128 a
    tile of more than 5000 candidates."""
    arrays = chip_smoke.skip_breaking_triangles(256, 5200, 21)
    tris = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    seg = k3.build_segments(*tris, 256, 256, tile, huge_max=1024)
    before = cuda_lib.RASTER_TILED.launches
    got = k3.raster_segments(seg.starts, seg.data, seg.tw, seg.tile)
    ref = k3.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    torch.cuda.synchronize()
    assert cuda_lib.RASTER_TILED.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    longest = int((seg.starts[1:] - seg.starts[:-1]).max())
    assert float(seg.over) == 0.0 and (tile < 64 or longest > 5000)


def test_k3_nan_depth_cancels_its_chunk(cuda_device):
    """A triangle with an infinite corner covers pixels with NaN depth;
    like the plain version, K3 then keeps the carried winner there for
    that chunk (tests/test_torch_raster_skip.py)."""
    scr = torch.tensor([[[np.inf, 5.0], [0.0, 0.0], [0.0, 10.0]],
                        [[0.0, 0.0], [16.0, 0.0], [0.0, 16.0]]], device=cuda_device)
    seg = k3.build_segments(scr, torch.tensor([[0.5] * 3, [0.3] * 3], device=cuda_device),
                            torch.ones(2, 3, device=cuda_device),
                            torch.ones(2, dtype=torch.bool, device=cuda_device), 16, 16, 16)
    got = k3.raster_segments(seg.starts, seg.data, seg.tw, seg.tile)
    ref = k3.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (got[1].reshape(16, 16)[5:10, :4] == -1).all()


def _cornell_path_scene():
    """The benchmark's Cornell Box (bench_port/configs/cornell.json,
    built by bench_port/lib/quadscene.py) with one camera node for each
    pose of the raster traffic's path: offsets drawn uniformly from
    [-s, s]^3 (s the config's `camera_offset`) by `camera_path_seed`, as
    the benchmark draws them. Returns (host scene, traffic)."""
    import copy
    import importlib.util
    import json

    bench = os.path.join(os.path.dirname(os.path.abspath(HERE)), "bench_port")
    with open(os.path.join(bench, "configs", "cornell.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench, "traffic", "raster_1080p.json")) as f:
        traffic = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "bench_port_quadscene", os.path.join(bench, "lib", "quadscene.py"))
    quadscene = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quadscene)
    host = quadscene.build(config["scene"])
    (cam,) = [n for n in host.nodes if n.camera_index is not None]
    drawn = np.random.default_rng(traffic["camera_path_seed"]).uniform(
        -1.0, 1.0, (traffic["camera_poses"], 3)).astype(np.float32)
    base = cam.local_transform.copy()
    for k, offset in enumerate(drawn * np.float32(config["camera_offset"])):
        node = cam if k == 0 else copy.deepcopy(cam)
        node.local_transform = base.copy()
        node.local_transform[:3, 3] += offset
        if k:
            node.children = []
            host.nodes.append(node)
            if node.parent is not None:
                host.nodes[node.parent].children.append(len(host.nodes) - 1)
    host.update_node_hierarchies()
    return host, traffic


def test_cornell_raster_routes_to_k3(cuda_device):
    """The benchmark's Cornell raster frame (128 slots, 1920x1088, tile
    64) at each of its 8 camera poses: the binned G-buffer pass takes
    K3, one launch a frame, the `raster.path` counter reads `k3` once a
    frame, and its fragments equal the capped per-tile path's bit for
    bit."""
    from hala_tpu_torch.models.rz_renderer import RasterSettings, _raster_setup, gbuffer_pass
    from hala_tpu_torch.ops.raster import rasterize_tiled
    from hala_tpu_torch.utils import profiling

    host, tr = _cornell_path_scene()
    scene = SceneUploader.upload(host, use_ray_tracing=False, device=cuda_device)
    assert scene.geometry.tri_v0.shape[0] == 128
    settings = RasterSettings(tr["width"], tr["height"], binned=True, tile=tr["tile"])
    for k in range(tr["camera_poses"]):
        before = cuda_lib.RASTER_TILED.launches
        profiling.reset()
        profiling.enable()
        try:
            frag = gbuffer_pass(scene, k, settings)
            routes = [(c["labels"], c["value"]) for c in profiling.counters()
                      if c["name"] == "raster.path"]
        finally:
            profiling.disable()
            profiling.reset()
        torch.cuda.synchronize()
        assert cuda_lib.RASTER_TILED.launches == before + 1
        assert routes == [({"path": "k3"}, 1)]
        tris = _raster_setup(scene, k, settings)[:4]
        ref, over = rasterize_tiled(*tris, settings.width, settings.height,
                                    tile=settings.tile, k_max=settings.bin_k_max,
                                    scatter=False)
        assert float(over) == 0.0
        assert float((ref.tri >= 0).float().mean()) > 0.5
        _equal_bits(frag, ref)


@pytest.mark.parametrize("case", ["huge_600", "pairs_2040"])
def test_routed_k3_past_the_jax_bounds(cuda_device, case):
    """K3 on meshes of at most 4096 triangles past the JAX package's
    static bounds (600 huge strips against its 512; 128 triangles around
    2040 tiles, more than its 131072 pairs): the routed path reads no
    overflow and gives the capped path's image (its cap k_max = t cannot
    clip) bit for bit, where the JAX package's bounds would not."""
    from hala_tpu_torch.ops.raster import rasterize_tiled

    rs = np.random.RandomState(7)
    if case == "huge_600":
        t, w, h = 600, 256, 64
        x0, y0 = rs.uniform(-20.0, 100.0, (t, 1)), rs.uniform(0.0, 64.0, (t, 1))
        length, height = rs.uniform(130.0, 250.0, (t, 1)), rs.uniform(1.0, 4.0, (t, 1))
        s = rs.uniform(0.2, 0.8, (t, 1))
        tri = np.stack([np.concatenate([x0, y0], 1),
                        np.concatenate([x0 + length, y0 + height * s], 1),
                        np.concatenate([x0 + length * s, y0 + height], 1)], 1)
    else:
        t, w, h = 128, 960, 544
        around = np.array([[-700.0, -300.0], [1700.0, -300.0], [480.0, 1500.0]])
        tri = around + rs.uniform(-500.0, 500.0, (t, 3, 2))
    arrays = (tri, rs.uniform(0.1, 0.9, (t, 3)), rs.uniform(0.5, 2.0, (t, 3)))
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_device) for a in arrays]
    args.append(torch.ones(t, dtype=torch.bool, device=cuda_device))
    assert float(k3.build_segments(*args, w, h, 16).over) == 1.0
    before = cuda_lib.RASTER_TILED.launches
    routed, over = rasterize_tiled(*args, w, h, tile=16)
    capped, c_over = rasterize_tiled(*args, w, h, tile=16, k_max=t, scatter=False)
    torch.cuda.synchronize()
    assert cuda_lib.RASTER_TILED.launches == before + 1
    assert float(over) == float(c_over) == 0.0
    assert float((routed.tri >= 0).float().mean()) > 0.3
    _equal_bits(routed, capped)


def _k1_soup(n_tris, n_rays, seed, dev):
    """n_tris random triangles in [-1, 1]^3 (slot 2000 a copy of slot
    1000) and n_rays rays: a tenth aimed at slot 1000's centroid, the
    rest random; t_max unbounded, bounded, exactly 1e-4, 0 and NaN."""
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-1, 1, (n_tris, 3))
    e1 = rs.uniform(-0.08, 0.08, (n_tris, 3))
    e2 = rs.uniform(-0.08, 0.08, (n_tris, 3))
    for a in (v0, e1, e2):
        a[2000] = a[1000]
    o = rs.uniform(-1.2, 1.2, (n_rays, 3))
    d = rs.normal(size=(n_rays, 3))
    aim = slice(0, n_rays // 10)
    d[aim] = v0[1000] + (e1[1000] + e2[1000]) / 3 - o[aim]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n_rays, 3.0e38)
    tm[7::31] = rs.uniform(0.1, 2.0, len(tm[7::31]))
    tm[5::29] = 1e-4
    tm[::17] = 0.0
    tm[11::97] = np.nan
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (o, d, tm, v0, e1, e2)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["4096", "num_real_below", "two_stages"])
def test_k1_soup_matches_plain(cuda_device, case, any_hit):
    """K1 against its plain version, bit for bit, at the top of "auto"'s
    brute-force range: 4096 triangles staged whole, 4000 real of 4096,
    and 6000 (two stages); a ragged ray count, dead rays, and a
    duplicated triangle whose copy must lose the equal-t tie."""
    n_tris = 6000 if case == "two_stages" else 4096
    num_real = 4000 if case == "num_real_below" else n_tris
    o, d, tm, v0, e1, e2 = _k1_soup(n_tris, 70_000 + 37, 9, cuda_device)
    before = cuda_lib.INTERSECT_BRUTEFORCE.launches
    if any_hit:
        got = k1.occluded_pallas(o, d, tm, v0, e1, e2, num_real=num_real)
        ref = k1.occluded_pallas_plain(o, d, tm, v0, e1, e2, num_real=num_real)
        assert torch.equal(got, ref) and 0 < int(got.sum()) < got.numel()
    else:
        got = k1.intersect_pallas(o, d, v0, e1, e2, t_max=tm, num_real=num_real)
        ref = k1.intersect_pallas_plain(o, d, v0, e1, e2, t_max=tm, num_real=num_real)
        for a, b in zip(got, ref):
            if a.dtype.is_floating_point:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
        assert int((got.tri == 1000).sum()) > 100 and not (got.tri == 2000).any()
        assert int((got.tri >= num_real).sum()) == 0
    assert cuda_lib.INTERSECT_BRUTEFORCE.launches == before + 1


@pytest.fixture(scope="module")
def atrium_batch():
    """atrium.glb (369 clusters) on the card and 4096 rays around its
    centre: a quarter bounded at 2, every 13th dead."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))
    g = SceneUploader.upload(scene, use_ray_tracing=False, device=dev).geometry
    real = g.tri_v0[g.tri_mat >= 0]
    center = ((real.amin(0) + real.amax(0)) / 2).cpu().numpy()
    o, d = (x.to(dev) for x in _rays(4096, 6, center, 2.0))
    tm = torch.full((o.shape[0],), 3.0e38, device=dev)
    tm[1::4] = 2.0
    tm[::13] = 0.0
    return g, o, d, tm


@pytest.fixture(scope="module")
def atrium_big_batch():
    """atrium_big (1861 clusters) on the card and 16,384 rays from inside
    its bounds (a dozen along the axes, a quarter bounded, some dead)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    g = SceneUploader.upload(scene, use_ray_tracing=False, device=dev).geometry
    return (g, *_inside_rays(g, 16384, 12))


def _inside_rays(g, n, seed):
    real = g.tri_v0[g.tri_mat >= 0]
    lo, hi = (x.cpu().numpy() for x in (real.amin(0), real.amax(0)))
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3))
    _, d = _rays(n, seed + 1)
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.05, 8.0, len(tm[1::4]))
    tm[::97] = 0.0
    dev = g.tri_v0.device
    return (torch.from_numpy(o.astype(np.float32)).to(dev), d.to(dev),
            torch.from_numpy(tm).to(dev))


@pytest.fixture(scope="module")
def instances_scene():
    """Five instances of atrium_big side by side along x (the scene
    "auto" sends to K4-K6: above 8191 clusters, two cull superchunks),
    uploaded through the SAH build."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    from hala_tpu_torch.scene.cpu.node import Node

    dev = torch.device("cuda", 0)
    host = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    xs = [(p.positions @ n.world_transform[:3, :3].T + n.world_transform[:3, 3])[:, 0]
          for n in host.nodes if n.mesh_index is not None
          for p in host.meshes[n.mesh_index].primitives]
    # the copies of chip_smoke.py `instanced_scene`
    spacing = float(max(x.max() for x in xs) - min(x.min() for x in xs)) + 2.0
    meshed = [n for n in host.nodes if n.mesh_index is not None]
    for j in range(1, 5):
        for n in meshed:
            m = n.world_transform.copy()
            m[0, 3] += j * spacing
            host.nodes.append(Node(name=f"{n.name}_{j}", local_transform=m,
                                   world_transform=m.copy(), mesh_index=n.mesh_index))
    scene = SceneUploader.upload(host, use_ray_tracing=False, device=dev)
    assert scene.geometry.cluster_min.shape[0] > k4.CULL_MAX_CLUSTERS
    return scene


@pytest.fixture(scope="module")
def instances(instances_scene):
    """The five instances' geometry and 16,384 rays from inside their
    bounds."""
    g = instances_scene.geometry
    return (g, *_inside_rays(g, 16384, 13))


def _coherent(g, o, d, tm):
    perm = torch.argsort(compaction.query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                         stable=True)
    return tuple(x[perm].contiguous() for x in (o, d, tm))


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("k", [4, 12, 16])
def test_k4_atrium_big_matches_plain(atrium_big_batch, k, order):
    """K4 (a warp skipping the 16-box groups no lane enters) on
    atrium_big, as given and in the traverse engine's coherence order:
    pk and cnt bit for bit."""
    g, o, d, tm = atrium_big_batch
    if order == "sorted":
        o, d, tm = _coherent(g, o, d, tm)
    before = cuda_lib.CULL_TOPK.launches
    got = k4.cull_topk(o, d, tm, g.cluster_min, g.cluster_max, k=k)
    ref = k4.cull_topk_plain(o, d, tm, g.cluster_min, g.cluster_max, k=k)
    torch.cuda.synchronize()
    assert cuda_lib.CULL_TOPK.launches == before + 1
    _equal_bits(got, ref)
    assert int((got[1] > k).sum()) > 0 and int((got[1] == 0).sum()) > 0


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_k4_instances_both_superchunks_match_plain(instances, order):
    """K4 on the five instances: one launch per superchunk of 8192
    clusters (the second ragged), each equal to its plain version, and
    the merged lists equal to the plain merge."""
    g, o, d, tm = instances
    if order == "sorted":
        o, d, tm = _coherent(g, o, d, tm)
    cmin, cmax = g.cluster_min, g.cluster_max
    sc = k4.CULL_MAX_CLUSTERS
    unions = k4.geometry_unions(g)
    assert len(unions) == 2
    for j, lo in enumerate(range(0, cmin.shape[0], sc)):
        sl = slice(lo, lo + sc)
        got = k4.cull_topk(o, d, tm, cmin[sl], cmax[sl], k=12, unions=unions[j])
        ref = k4.cull_topk_plain(o, d, tm, cmin[sl], cmax[sl], k=12)
        torch.cuda.synchronize()
        _equal_bits(got, ref)
        assert int((got[1] > 0).sum()) > 100
    before = cuda_lib.CULL_TOPK.launches
    got = k5.cull_candidates(o, d, tm, cmin, cmax, 12, unions=unions)
    torch.cuda.synchronize()
    assert cuda_lib.CULL_TOPK.launches == before + 2
    ref = k5.cull_candidates(o.cpu(), d.cpu(), tm.cpu(), cmin.cpu(), cmax.cpu(), 12)
    _equal_bits(tuple(x.cpu() for x in got), ref)


@pytest.mark.parametrize("superchunk", [1000, 1861])
def test_k4_ragged_groups_and_far_boxes_match_plain(atrium_big_batch, superchunk):
    """Superchunks that are not multiples of 16 (ragged last groups), and
    boxes the unions must handle: a 3e37 point box (an empty cluster's),
    one that a ray enters on the diagonal, NaN and infinite corners,
    inside groups of real boxes."""
    g, o, d, tm = atrium_big_batch
    cmin, cmax = g.cluster_min.clone(), g.cluster_max.clone()
    cmin[5] = cmax[5] = 3.0e37
    cmin[17, 1] = float("nan")
    cmax[40] = float("inf")
    cmin[1003] = cmax[1003] = 3.0e37
    # rays on the diagonal through the 3e37 point box enter it
    o = o.clone()
    d = d.clone()
    o[:64] = torch.tensor([1.0, 1.0, 1.0], device=o.device) * torch.arange(
        64, device=o.device)[:, None].float()
    d[:64] = 1.0 / np.sqrt(3.0)
    _, enters = k4.slab_keys(o[:64], d[:64], tm[:64], cmin[5:6], cmax[5:6])
    assert bool(enters.any())
    got = k5.cull_candidates(o, d, tm, cmin, cmax, 12, superchunk=superchunk)
    torch.cuda.synchronize()
    ref = k5.cull_candidates(o.cpu(), d.cpu(), tm.cpu(), cmin.cpu(), cmax.cpu(), 12,
                             superchunk=superchunk)
    _equal_bits(tuple(x.cpu() for x in got), ref)
    pk, cnt = k4.cull_topk(o, d, tm, cmin[:superchunk], cmax[:superchunk], k=16)
    _equal_bits((pk, cnt), k4.cull_topk_plain(o, d, tm, cmin[:superchunk],
                                              cmax[:superchunk], k=16))


@pytest.mark.parametrize("case", ["fallback", "full_range", "all_resolved", "sentinels"])
def test_k6_matches_stream_plain(atrium_big_batch, case):
    """K6 (a warp per queued ray) against `stream_plain`, bit for bit:
    on the fallback's inputs (a few live rays), on the full range (every
    ray live: the cluster engine), with every ray resolved (an empty
    queue: the launch does nothing), and on the full range with 3e37
    point boxes (an empty cluster's) inside two groups, which their
    unions leave out and the walk tests on their own."""
    g, o, d, tm = atrium_big_batch
    o, d, tm = _coherent(g, o, d, tm)
    if case == "sentinels":
        cmin, cmax = g.cluster_min.clone(), g.cluster_max.clone()
        cmin[[5, 21]] = cmax[[5, 21]] = 3.0e37
        g = types.SimpleNamespace(cluster_min=cmin, cluster_max=cmax,
                                  tri_packed=g.tri_packed)
    if case == "fallback":
        ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, 4)
        hit, unres, _ = k5.traverse_candidates(o, d, tm, ids, tns, ovf, g.cluster_min,
                                               g.cluster_max, g.tri_packed)
        tm = k5.fallback_t_max(hit, unres)
        live = int((tm > 1e-4).sum())
        assert 0 < live < o.shape[0] // 2
    elif case == "all_resolved":
        tm = torch.full_like(tm, -torch.inf)
    before = cuda_lib.CLUSTER_STREAM.launches
    got = k6.intersect_clustered(o, d, g, t_max=tm)
    ref = k6.intersect_clustered_plain(o, d, g, t_max=tm)
    torch.cuda.synchronize()
    assert cuda_lib.CLUSTER_STREAM.launches == before + 1
    _equal_bits(got, ref)
    if case == "all_resolved":
        assert bool((got.tri == -1).all())
    else:
        assert int((got.tri >= 0).sum()) > 0


@pytest.mark.parametrize("apart", [1, 40])
def test_k6_keeps_the_lowest_slot_at_equal_t(cuda_device, apart):
    """A triangle duplicated into a lower-id cluster: front to back a ray
    enters cluster `apart` first (slot 128 * apart + 3) and brute force
    keeps slot 7 of cluster 0; with `apart` 40 the two lie in different
    32-box ballots of the warp. Bit for bit against `stream_plain`."""
    from hala_tpu_torch.ops.cluster import with_pretest_row

    c = apart + 1
    blk = torch.zeros((c, 16, 128))
    blk[:, 0:3, :] = 3.0e37  # padding slots: far v0, zero edges
    tri = torch.tensor([[0, -1, -1], [0, 3, 0], [0, 0, 3]], dtype=torch.float32)
    blk[0, 0:9, 7] = tri.reshape(9)
    blk[apart, 0:9, 3] = tri.reshape(9)
    blk[apart, 0:9, 9] = torch.tensor([[-3, 10, 0], [0, 1, 0], [0, 0, 1]],
                                      dtype=torch.float32).reshape(9)
    cmin = torch.full((c, 3), 3.0e37)
    cmax = torch.full((c, 3), 3.0e37)
    cmin[0], cmax[0] = torch.tensor([0.0, -1.0, -1.0]), torch.tensor([0.0, 2.0, 2.0])
    cmin[apart] = torch.tensor([-3.0, -1.0, -1.0])
    cmax[apart] = torch.tensor([0.0, 11.0, 2.0])
    g = types.SimpleNamespace(cluster_min=cmin.to(cuda_device),
                              cluster_max=cmax.to(cuda_device),
                              tri_packed=with_pretest_row(blk).to(cuda_device))
    rs = np.random.RandomState(8)
    n = 200
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -5.0
    o[:, 1:] = rs.uniform(-0.5, 0.5, (n, 2))
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    d[150:] = rs.normal(size=(50, 3))
    d[150:] /= np.linalg.norm(d[150:], axis=1, keepdims=True)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in (o, d))
    tm = torch.full((n,), 3.0e38, device=cuda_device)
    tm[140:150] = 5.0  # the tie at exactly t_max: out of range
    got = k6.intersect_clustered(o, d, g, t_max=tm)
    ref = k6.intersect_clustered_plain(o, d, g, t_max=tm)
    torch.cuda.synchronize()
    _equal_bits(got, ref)
    assert (got.tri[:140] == 7).all() and (got.tri[140:150] == -1).all()


def test_traverse_on_instances_matches_k1(instances):
    """intersect_traversed (K4 over both superchunks, K5, K6) on the five
    instances against K1 over all slots: equal triangle ids, t/u/v
    within 1e-5, except near-ties (both t within 1e-5) and rays whose
    K1 winner lies in a cluster the reference's unpadded cull slab test
    misses (kept for parity)."""
    g, o, d, tm = instances
    before = cuda_lib.launches()
    got = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=12)
    ref = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    torch.cuda.synchronize()
    after = cuda_lib.launches()
    assert after["cull_topk"] == before["cull_topk"] + 2
    assert after["cluster_stream"] == before["cluster_stream"] + 1
    differ = torch.nonzero(got.tri != ref.tri).squeeze(1)
    for i in differ.tolist():
        assert int(ref.tri[i]) >= 0, i
        if int(got.tri[i]) >= 0 and abs(float(got.t[i] - ref.t[i])) <= 1e-5 * float(
                torch.maximum(got.t[i], ref.t[i])):
            continue  # a near-tie
        c = int(ref.tri[i]) // 128  # else the reference cull's grazing miss
        _, enters = k4.slab_keys(o[i:i + 1], d[i:i + 1], tm[i:i + 1],
                                 g.cluster_min[c:c + 1], g.cluster_max[c:c + 1])
        assert not bool(enters.any()), i
    assert differ.numel() <= 4
    same = (got.tri == ref.tri) & (ref.tri >= 0)
    for a, b in ((got.t, ref.t), (got.u, ref.u), (got.v, ref.v)):
        assert torch.allclose(a[same], b[same], rtol=1e-5, atol=1e-5)
    assert int(same.sum()) > 10000
    assert int((ref.tri >= 128 * k4.CULL_MAX_CLUSTERS).sum()) > 100


@pytest.mark.parametrize("k", [4, 12, 16])
def test_k4_kernel_matches_plain(atrium_batch, k):
    g, o, d, tm = atrium_batch
    before = cuda_lib.CULL_TOPK.launches
    pk, cnt = k4.cull_topk(o, d, tm, g.cluster_min, g.cluster_max, k=k)
    pk_p, cnt_p = k4.cull_topk_plain(o, d, tm, g.cluster_min, g.cluster_max, k=k)
    torch.cuda.synchronize()
    assert cuda_lib.CULL_TOPK.launches == before + 1
    assert torch.equal(pk, pk_p) and torch.equal(cnt, cnt_p)
    if k == 4:
        assert int((cnt > k).sum()) > 0  # truncated lists


@pytest.mark.parametrize("k", [4, 12])
def test_k5_k6_kernels_match_plain(atrium_batch, k):
    """K5 on K4's lists, then K6 on the fallback's inputs (t_max = -inf
    for resolved rays) and on the full range: bit for bit."""
    g, o, d, tm = atrium_batch
    ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, k)
    before = (cuda_lib.TRAVERSE_CANDIDATES.launches, cuda_lib.CLUSTER_STREAM.launches)
    boxes = (g.cluster_min, g.cluster_max, g.tri_packed)
    got = k5.traverse_candidates(o, d, tm, ids, tns, ovf, *boxes)
    ref = k5.traverse_candidates_plain(o, d, tm, ids, tns, ovf, *boxes)
    torch.cuda.synchronize()
    for a, b in zip((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])):
        assert torch.equal(a, b)
    fb_tm = k5.fallback_t_max(got[0], got[1])
    for t_max in (fb_tm, tm):
        hk = k6.intersect_clustered(o, d, g, t_max=t_max)
        hp = k6.intersect_clustered_plain(o, d, g, t_max=t_max)
        torch.cuda.synchronize()
        for a, b in zip(hk, hp):
            assert torch.equal(a, b)
    assert cuda_lib.TRAVERSE_CANDIDATES.launches == before[0] + 1
    assert cuda_lib.CLUSTER_STREAM.launches == before[1] + 2
    if k == 4:
        assert int(got[1].sum()) > 0  # the fallback has rays to rerun


def _equal_bits(got, ref):
    for a, b in zip(got, ref):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _k2_against_plain(o, d, tm, g, work_out=None):
    """K2 against its plain version (the same hits, any-hit mask) and its
    schedule against the plain model (hits, runs and the queued pairs
    and packed steps, closest and any hit), bit for bit. Returns the
    runs; `work_out`, a dict, receives the closest and any-hit work."""
    args = (o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    before = cuda_lib.MATRIX_TRAVERSE.launches
    hit, runs, work = k2.matrix_walk_runs(o, d, g, t_max=tm)
    occ, occ_runs, occ_work = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=True)
    plain = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    model = k2.matrix_walk_runs_plain(*args, False)
    occ_model = k2.matrix_walk_runs_plain(*args, True)
    torch.cuda.synchronize()
    assert cuda_lib.MATRIX_TRAVERSE.launches == before + 2
    _equal_bits(hit, plain)
    _equal_bits((*hit, runs, work), (*model[0], *model[1:]))
    _equal_bits((*occ, occ_runs, occ_work), (*occ_model[0], *occ_model[1:]))
    assert torch.equal(occ.tri >= 0, plain.tri >= 0)
    _equal_bits(k2.intersect_matrix(o, d, g, t_max=tm), plain)
    if work_out is not None:
        work_out.update(closest=work, any_hit=occ_work)
    return runs


def test_k2_keeps_the_lowest_slot_at_equal_t(cuda_device):
    """Two clusters hold the same triangle; front to back a ray meets it
    first in cluster 1 (slot 131), and brute force keeps slot 7 of
    cluster 0, entered later. Closest and any hit, bit for bit."""
    from hala_tpu_torch.ops.cluster import with_pretest_row

    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 3.0e37  # padding slots: far v0, zero edges
    for c, s, tri in ((0, 7, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 3, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 9, [[-3, 10, 0], [0, 1, 0], [0, 0, 1]])):
        blk[c, 0:9, s] = torch.tensor(tri, dtype=torch.float32).reshape(9)
    g = types.SimpleNamespace(
        cluster_min=torch.tensor([[0.0, -1.0, -1.0], [-3.0, -1.0, -1.0]], device=cuda_device),
        cluster_max=torch.tensor([[0.0, 2.0, 2.0], [0.0, 11.0, 2.0]], device=cuda_device),
        tri_packed=with_pretest_row(blk).to(cuda_device),
    )
    rs = np.random.RandomState(8)
    n = 200
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -5.0
    o[:, 1:] = rs.uniform(-0.5, 0.5, (n, 2))
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    d[150:] = rs.normal(size=(50, 3))  # and some that miss
    d[150:] /= np.linalg.norm(d[150:], axis=1, keepdims=True)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in (o, d))
    tm = torch.full((n,), 3.0e38, device=cuda_device)
    tm[140:150] = 5.0  # the tie at exactly t_max: out of range
    runs = _k2_against_plain(o, d, tm, g)
    got = k2.intersect_matrix(o, d, g, t_max=tm)
    assert (got.tri[:140] == 7).all() and (got.tri[140:150] == -1).all()
    assert int(runs[0]) == 2


def test_k2_edge_rays_match_plain(atrium_batch):
    """atrium.glb: origins at cluster box centres (inside the boxes),
    t_max exactly at the closest hit, t_max 0 and -inf; then the mixed
    batch of the fixture in matrix_query's coherence order."""
    g, o, d, tm = atrium_batch
    dev = o.device
    n = o.shape[0]
    rs = np.random.RandomState(9)
    pick = torch.from_numpy(rs.randint(0, g.cluster_min.shape[0] - 1, n)).to(dev)
    o_in = ((g.cluster_min + g.cluster_max) / 2)[pick].contiguous()
    first = k2.intersect_matrix_plain(o_in, d, g)
    tm_e = torch.where(first.tri >= 0, first.t, 3.0e38)
    tm_e[1::4] = 0.0
    tm_e[2::4] = -torch.inf
    _k2_against_plain(o_in, d, tm_e, g)
    order = torch.argsort(compaction.query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                          stable=True)
    o_s, d_s, tm_s = (x[order].contiguous() for x in (o, d, tm))
    runs = _k2_against_plain(o_s, d_s, tm_s, g)
    assert 0 < int(runs.max()) <= g.cluster_min.shape[0]
    assert int(runs[-1]) == 0 or bool((tm_s[-k2.MATRIX_BLOCK_RAYS:] > 1e-4).any())


def test_k2_sorted_atrium_big_matches_plain(cuda_device):
    """atrium_big (1861 clusters): 16,384 rays from inside its bounds in
    matrix_query's coherence order."""
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    g = SceneUploader.upload(scene, use_ray_tracing=False, device=cuda_device).geometry
    real = g.tri_v0[g.tri_mat >= 0]
    lo, hi = (x.cpu().numpy() for x in (real.amin(0), real.amax(0)))
    rs = np.random.RandomState(10)
    n = 16384
    o = torch.from_numpy(rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                                    (n, 3)).astype(np.float32)).to(cuda_device)
    _, d = _rays(n, 11)
    d = d.to(cuda_device)
    tm = torch.full((n,), 3.0e38, device=cuda_device)
    tm[1::4] = torch.from_numpy(rs.uniform(0.05, 8.0, n // 4).astype(np.float32)).to(
        cuda_device)
    tm[::97] = 0.0
    order = torch.argsort(compaction.query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                          stable=True)
    o, d, tm = (x[order].contiguous() for x in (o, d, tm))
    runs = _k2_against_plain(o, d, tm, g)
    assert int(runs.max()) <= g.cluster_min.shape[0]


def _on(dev, table):
    g, o, d, tm = table
    for key in vars(g):
        setattr(g, key, getattr(g, key).to(dev))
    return g, o.to(dev), d.to(dev), tm.to(dev)


@pytest.mark.parametrize("case", ["full_queue", "t_max_and_dead", "ties"])
def test_k2_queue_on_hand_built_tables_matches_plain(cuda_device, case):
    """K2's (ray, span) queue and packed Moller-Trumbore on chip_smoke.py's
    tables, bit for bit against its plain version and its schedule model
    (hits, runs, pairs queued, steps), closest and any hit:
    `span_stack_table` with every lane in all 8 spans (256 entries a
    warp; the any hit's lowest slot lies in the span a ray enters last),
    then with rays i % 8 == 0 dead and == 1 at t_max exactly at their hit
    (no hit), 165 rays; `span_tie_table`, one triangle hit at the same t
    in three spans of a visit and in the visit before, 200 rays."""
    if case == "ties":
        g, o, d, tm = _on(cuda_device, chip_smoke.span_tie_table(200))
    else:
        n = 128 if case == "full_queue" else 165
        g, o, d, tm = _on(cuda_device, chip_smoke.span_stack_table(n))
    if case == "t_max_and_dead":
        i = torch.arange(o.shape[0], device=cuda_device)
        first = k2.intersect_matrix_plain(o, d, g, t_max=tm)
        tm = torch.where(i % 8 == 0, 0.0, torch.where(i % 8 == 1, first.t, tm))
    work = {}
    _k2_against_plain(o, d, tm, g, work)
    hit = k2.intersect_matrix(o, d, g, t_max=tm)
    occ = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=True)[0]
    torch.cuda.synchronize()
    if case == "full_queue":
        assert work["closest"].tolist() == work["any_hit"].tolist() == [[1024, 512]]
        assert (hit.tri == 115).all() and (occ.tri == 3).all()
    elif case == "t_max_and_dead":
        assert work["closest"].tolist() == [[784, 392], [221, 111]]
        assert (hit.tri[2::8] == 115).all() and (hit.tri[1::8] == -1).all()
    else:
        assert work["closest"].tolist() == [[512, 256], [288, 144]]
        assert (hit.tri == 5).all() and (occ.tri == 131).all()


def test_k2_diffuse_bounce_on_atrium_big_matches_plain(atrium_big_scene):
    """atrium_big: the first diffuse bounce of 256 x 64 camera rays
    (chip_smoke.py `diffuse_bounce_batch`, in matrix_query's coherence
    order), where a warp's lanes enter many distinct spans of each
    cluster: K2 equals its plain version and its schedule model bit for
    bit, the queued pairs and packed steps included."""
    g = atrium_big_scene.geometry
    o, d, tm = chip_smoke.diffuse_bounce_batch(atrium_big_scene, 256, 64, 21)
    work = {}
    runs = _k2_against_plain(o, d, tm, g, work)
    assert float(runs.float().mean()) > 64
    assert 0.5 < k2.packed_share(work["closest"]) <= 1.0


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("k", [1, 4, 12, 16])
def test_k5_sorted_and_unsorted_match_plain(atrium_batch, k, order):
    """K5 (half a warp a ray) on K4's lists of the fixture's batch as
    given and in matrix_query's coherence order: all six outputs bit
    for bit."""
    g, o, d, tm = atrium_batch
    if order == "sorted":
        perm = torch.argsort(compaction.query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                             stable=True)
        o, d, tm = (x[perm].contiguous() for x in (o, d, tm))
    ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, k)
    before = cuda_lib.TRAVERSE_CANDIDATES.launches
    boxes = (g.cluster_min, g.cluster_max, g.tri_packed)
    got = k5.traverse_candidates(o, d, tm, ids, tns, ovf, *boxes)
    ref = k5.traverse_candidates_plain(o, d, tm, ids, tns, ovf, *boxes)
    torch.cuda.synchronize()
    assert cuda_lib.TRAVERSE_CANDIDATES.launches == before + 1
    _equal_bits((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2]))
    assert int((got[0].tri >= 0).sum()) > 100


def test_traverse_engine_on_card_equals_cpu(atrium_batch):
    """intersect_traversed on CUDA tensors launches K4, K5 and K6 once
    each and returns what its plain versions return on the CPU."""
    g, o, d, tm = atrium_batch
    before = cuda_lib.launches()
    got = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=8)
    torch.cuda.synchronize()
    after = cuda_lib.launches()
    for name in ("cull_topk", "traverse_candidates", "cluster_stream"):
        assert after[name] == before[name] + 1, name
    assert after["matrix_traverse"] == before["matrix_traverse"]
    ref = k5.intersect_traversed(o.cpu(), d.cpu(), g.to("cpu"), t_max=tm.cpu(),
                                 k_per_ray=8)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k_cap", [2, 32])
def test_k8_kernel_matches_plain(atrium_batch, any_hit, k_cap):
    """K8 on the group lists of 4096 coherence-sorted rays, bit for bit;
    k_cap 2 truncates every list."""
    g, o, d, tm = atrium_batch
    cmin, cmax = g.cluster_min, g.cluster_max
    order = torch.argsort(compaction.query_coherence_key(o, d, tm, cmin, cmax), stable=True)
    o, d, tm = o[order].contiguous(), d[order].contiguous(), tm[order].contiguous()
    c = cmin.shape[0]
    ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, k_cap)
    args = (o, d, tm, torch.clamp(usz, max=k_cap),
            torch.clamp(ids, max=c - 1).contiguous(), tns.view(torch.int32),
            g.tri_packed, cmin, cmax)
    before = cuda_lib.GROUPED_WALK.launches
    got = k8.grouped_walk(*args, any_hit)
    ref = k8.grouped_walk_plain(*args, any_hit)
    torch.cuda.synchronize()
    assert cuda_lib.GROUPED_WALK.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((got[1] >= 0).sum()) > (100 if k_cap == 2 else 1000)
    if k_cap == 2:
        assert int((usz > 2).sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k,m", [(3, 8), (16, 32)])
def test_k7_kernel_matches_plain(atrium_batch, any_hit, k, m):
    """K7 on the merged lists of 4096 rays, bit for bit, stats included;
    (3, 8) truncates rays' and groups' lists."""
    g, o, d, tm = atrium_batch
    w = k7.wavefront_lists(o, d, tm, g, k, m)
    args = (w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, g.tri_packed,
            g.cluster_min, g.cluster_max)
    before = cuda_lib.WAVEFRONT_WALK.launches
    got = k7.wavefront_walk(*args, any_hit)
    ref = k7.wavefront_walk_plain(*args, any_hit)
    torch.cuda.synchronize()
    assert cuda_lib.WAVEFRONT_WALK.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((got[1] >= 0).sum()) > (500 if k == 3 else 1000)
    assert bool((got[4][:, 1] <= got[4][:, 0]).all())  # tested <= walked
    if k == 3:
        assert int((w.cnt > k).sum()) > 0 and int((w.grp_bound != k7.INF_KEY).sum()) > 0


def test_k7_k8_span_breaking_table_matches_plain(cuda_device):
    """K8 and K7 against their plain versions, bit for bit, closest and
    any-hit, on chip_smoke.py's table built to break the span mask
    (`span_breaking_walls`: zero-thickness span boxes, empty spans, rays
    at span-box corners and edges, warps in which one lane enters a
    span, dead and resolved rays)."""
    before = cuda_lib.launches()
    cases = chip_smoke.span_table_cases(cuda_device)
    for label, kernel, plain, args, _ in cases:
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b), label
        assert int((got[1] >= 0).sum()) > 300, label
    after = cuda_lib.launches()
    assert after["grouped_walk"] - before["grouped_walk"] == 4
    assert after["wavefront_walk"] - before["wavefront_walk"] == 4


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_walks_on_the_grazing_table_equal_their_plain_versions(cuda_device, seed):
    """The admissibility rule (ops/cluster.py) on chip_smoke.py's
    `grazing_beside_span`, where K1 accepts rays beside span 0's
    triangle: K2, K5 and K6 equal `stream_plain` bit for bit, and K7 and
    K8 their plain versions (closest and any-hit)."""
    g, o, d, tm = chip_smoke.grazing_beside_span(seed)
    for key in vars(g):
        setattr(g, key, getattr(g, key).to(cuda_device))
    o, d, tm = o.to(cuda_device), d.to(cuda_device), tm.to(cuda_device)
    ref = k6.stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, 1)
    walks = (k2.intersect_matrix(o, d, g, t_max=tm),
             k5.traverse_candidates(o, d, tm, ids, tns, ovf, g.cluster_min,
                                    g.cluster_max, g.tri_packed)[0],
             k6.intersect_clustered(o, d, g, t_max=tm))
    torch.cuda.synchronize()
    for hit in walks:
        for a, b in zip(hit, ref):
            assert torch.equal(a, b)
    table = chip_smoke.grazing_table(seed)
    for label, kernel, plain, args, _ in chip_smoke.span_table_cases(
            cuda_device, table, (1,), "grazing"):
        for a, b in zip(kernel(*args), plain(*args)):
            assert torch.equal(a, b), label


def test_walks_on_the_half_box_table_equal_stream_plain(cuda_device):
    """chip_smoke.py's `half_box_table`, where the cluster box alone
    rejects pairs (K5 takes its second pass over the slots there): K2,
    K5 and K6 equal `stream_plain` bit for bit."""
    g, o, d, tm = chip_smoke.half_box_table()
    for key in vars(g):
        setattr(g, key, getattr(g, key).to(cuda_device))
    o, d, tm = o.to(cuda_device), d.to(cuda_device), tm.to(cuda_device)
    ref = k6.stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, 1)
    for hit in (k2.intersect_matrix(o, d, g, t_max=tm),
                k5.traverse_candidates(o, d, tm, ids, tns, ovf, g.cluster_min,
                                       g.cluster_max, g.tri_packed)[0],
                k6.intersect_clustered(o, d, g, t_max=tm)):
        for a, b in zip(hit, ref):
            assert torch.equal(a, b)
    assert 0 < int((ref.tri >= 0).sum()) < o.shape[0]


def test_grouped_and_wavefront_engines_on_card_equal_cpu(atrium_batch):
    """Both engines on CUDA tensors launch their kernels (the wavefront
    K4 and K7, the grouped K8, both K2 as the fallback) and return what
    their plain versions return on the CPU, at caps that truncate."""
    g, o, d, tm = atrium_batch
    g_cpu = g.to("cpu")
    before = cuda_lib.launches()
    got_g = k8.intersect_grouped(o, d, g, t_max=tm, k_cap=4)
    got_w = k7.intersect_wavefront(o, d, g, t_max=tm, k_per_ray=3, m_group=8)
    torch.cuda.synchronize()
    after = cuda_lib.launches()
    delta = {key: after[key] - before[key] for key in after}
    assert delta["grouped_walk"] == 1 and delta["wavefront_walk"] == 1
    assert delta["cull_topk"] == 1 and delta["matrix_traverse"] == 2
    ref_g = k8.intersect_grouped(o.cpu(), d.cpu(), g_cpu, t_max=tm.cpu(), k_cap=4)
    ref_w = k7.intersect_wavefront(o.cpu(), d.cpu(), g_cpu, t_max=tm.cpu(),
                                   k_per_ray=3, m_group=8)
    for got, ref in ((got_g, ref_g), (got_w, ref_w)):
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)


def test_wrappers_of_the_walks_check_before_launch(atrium_batch):
    g, o, d, tm = atrium_batch
    w = k7.wavefront_lists(o, d, tm, g, 3, 8)
    args = [w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, g.tri_packed,
            g.cluster_min, g.cluster_max]
    before = cuda_lib.WAVEFRONT_WALK.launches
    with pytest.raises(ValueError):
        k7.wavefront_walk(w.o[:100], w.d[:100], w.t_max[:100], *args[3:])  # not whole groups
    with pytest.raises(ValueError):
        k7.wavefront_walk(*args[:4], w.want.long(), *args[5:])
    with pytest.raises(ValueError):
        k7.wavefront_walk(*args[:3], w.tnb.cpu(), *args[4:])
    assert cuda_lib.WAVEFRONT_WALK.launches == before


# --- the animation path: kernels on moved tables ------------------------------


@pytest.fixture(scope="module")
def moved_atrium():
    """atrium.glb and a copy of it beside it (`instanced_scene`, 738
    clusters) in a RayTracingRenderer on the card, the copy moved by
    set_node_transform / update_scene to overlap the first one, 0.5 off
    along x; 4096 rays around the first one's centre. Returns
    (renderer, the geometry before the move, o, d, t_max)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer

    dev = torch.device("cuda", 0)
    host, spacing = chip_smoke.instanced_scene(
        Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")), copies=2)
    r = RayTracingRenderer("moved", 64, 64, device=dev)
    r.set_scene(host)
    before = r.scene.geometry
    real = before.tri_v0[before.tri_mat >= 0]
    center = ((real.amin(0) + real.amax(0)) / 2).cpu().numpy()
    copy = len(host.nodes) - 1
    shift = chip_smoke.animated_example().translate(0.5 - spacing, 0.3, 0.2)
    r.set_node_transform(copy, shift @ host.nodes[copy].world_transform)
    r.update_scene()
    o, d = (x.to(dev) for x in _rays(4096, 9, center, 4.0))
    tm = torch.full((o.shape[0],), 3.0e38, device=dev)
    tm[1::4] = 3.0
    return r, before, o, d, tm


def test_moved_tables_are_the_uploaders_rule(moved_atrium):
    r, before, *_ = moved_atrium
    g = r.scene.geometry
    chip_smoke.check_moved_tables("moved atrium", g)
    assert not torch.equal(g.cluster_min, before.cluster_min)


def test_moved_mesh_kernels_match_plain(moved_atrium):
    """K1, K2 (closest, any-hit), K4, K5 and K6 on the moved tables, each
    equal to its plain version bit for bit, and the moved copy hit."""
    r, _, o, d, tm = moved_atrium
    g = r.scene.geometry
    cmin, cmax = g.cluster_min, g.cluster_max
    ref = k6.stream_plain(o, d, tm, cmin, cmax, g.tri_packed)
    _equal_bits(k2.intersect_matrix(o, d, g, t_max=tm), ref)
    assert torch.equal(k2.occluded_matrix(o, d, tm, g), ref.tri >= 0)
    tris = (g.tri_v0, g.tri_e1, g.tri_e2)
    _equal_bits(k1.intersect_pallas(o[:2048], d[:2048], *tris, t_max=tm[:2048]),
                k1.intersect_pallas_plain(o[:2048], d[:2048], *tris, t_max=tm[:2048]))
    _equal_bits(k4.cull_topk(o, d, tm, cmin, cmax, k=12),
                k4.cull_topk_plain(o, d, tm, cmin, cmax, k=12))
    ids, tns, ovf = k5.cull_candidates(o, d, tm, cmin, cmax, 12)
    got = k5.traverse_candidates(o, d, tm, ids, tns, ovf, cmin, cmax, g.tri_packed)
    want = k5.traverse_candidates_plain(o, d, tm, ids, tns, ovf, cmin, cmax, g.tri_packed)
    _equal_bits((*got[0], got[1], got[2]), (*want[0], want[1], want[2]))
    fb = k5.fallback_t_max(got[0], got[1])
    _equal_bits(k6.intersect_clustered(o, d, g, t_max=fb),
                k6.intersect_clustered_plain(o, d, g, t_max=fb))
    moved = [i for i, n in enumerate(r.scene.prim_node) if n == len(r._host_scene.nodes) - 1]
    prim = g.tri_prim[ref.tri[ref.tri >= 0].long()]
    assert int(torch.isin(prim, torch.tensor(moved, device=prim.device)).sum()) > 50


def test_move_then_query_reads_rebuilt_caches(cuda_device):
    """After a move, the first K1 query packs the moved soup and the
    first traverse / cluster queries build K4's and K6's unions from the
    moved boxes (the old geometry's stay with it)."""
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer

    ex = chip_smoke.animated_example()
    scene, node, w0 = ex.tall_box_scene()
    r = RayTracingRenderer("caches", 32, 32, device=cuda_device)
    r.set_scene(scene)
    o, d = (x.to(cuda_device) for x in _rays(2048, 11))
    g0 = r.scene.geometry
    k1.intersect_pallas(o, d, g0.tri_v0, g0.tri_e1, g0.tri_e2)
    k5.intersect_traversed(o, d, g0)
    k6.intersect_clustered(o, d, g0)
    r.set_node_transform(node, ex.translate(0.3, 0.0, 0.1) @ w0)
    r.update_scene()
    g = r.scene.geometry
    assert not [a for a in vars(g) if a.startswith(("_stream_unions", "_cull_unions"))]
    soup = (g.tri_v0, g.tri_e1, g.tri_e2)
    hit = k1.intersect_pallas(o, d, *soup)
    _equal_bits(hit, k1.intersect_pallas_plain(o, d, *soup))
    assert torch.equal(k1.packed_triangles(*soup, g.tri_v0.shape[0]),
                       k1.pack_triangles(*soup, g.tri_v0.shape[0]))
    _equal_bits(k5.intersect_traversed(o, d, g),
                tuple(x.to(cuda_device) for x in k5.intersect_traversed(
                    o.cpu(), d.cpu(), g.to("cpu"))))
    _equal_bits(k6.intersect_clustered(o, d, g), k6.intersect_clustered_plain(o, d, g))
    chip_smoke.check_rebuilt_unions("moved Cornell", g)
    assert g0._stream_unions[0] != g._stream_unions[0]


# ---------------------------------------------------------------------------
# geometry sharding: per-shard queries merged in one process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def atrium_big_scene():
    """atrium_big (1861 clusters) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)")
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    return SceneUploader.upload(scene, use_ray_tracing=False, device=torch.device("cuda", 0))


def _shards(scene, n):
    from hala_tpu_torch.parallel import shard_scene
    from hala_tpu_torch.parallel.tiling import Mesh

    dev = scene.geometry.tri_v0.device
    return [shard_scene(scene, Mesh(None, r, n, dev)) for r in range(n)]


def _sharded_against_whole(scene, n, intersector, seed, ran, idle, whole_by=None):
    """chip_smoke's 65,536 mixed rays through `intersector` on `n` shards
    merged by `merge_shard_hits`, and through `whole_by` (default the
    same) on the whole scene: equal bits, closest hit and any-hit (the
    shards' masks OR'd); the shards launch each kernel of `ran` and none
    of `idle`."""
    from hala_tpu_torch.models import integrator as tint

    o, d, tm = chip_smoke.mixed_batch(scene, 256, 128, 32768, seed)
    s = RenderSettings(width=8, height=8, intersector=intersector)
    sw = query.resolve(RenderSettings(width=8, height=8, intersector=whole_by or intersector),
                       scene)
    whole = tint._intersect_local(scene, o, d, sw, tm)
    whole_occ = tint._occluded_local(scene, o, d, tm, sw)
    shards = _shards(scene, n)
    slots = shards[0].geometry.tri_v0.shape[0]
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    plans = [query.resolve(s, sh) for sh in shards]
    got = tint.merge_shard_hits([tint._intersect_local(sh, o, d, p, tm)
                                 for sh, p in zip(shards, plans)],
                                [r * slots for r in range(n)])
    occ = torch.stack([tint._occluded_local(sh, o, d, tm, p)
                       for sh, p in zip(shards, plans)]).any(0)
    torch.cuda.synchronize()
    counts = cuda_lib.launches()
    _equal_bits(got, whole)
    assert torch.equal(occ, whole_occ)
    assert int((whole.tri >= 0).sum()) > 30000
    assert all(counts[k] >= n for k in ran), counts
    assert not any(counts[k] for k in idle), counts


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_k2_merge_equals_unsharded(atrium_big_scene, n):
    """K2 on each of n shards of atrium_big, merged by (t, global tri),
    equals the unsharded K2 query bit for bit."""
    _sharded_against_whole(atrium_big_scene, n, "matrix", 61, ("matrix_traverse",),
                           ("intersect_bruteforce", "cull_topk", "traverse_candidates",
                            "cluster_stream"))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_traverse_merge_equals_unsharded(instances_scene, n):
    """"traverse" (K4, K5, K6) on each of n shards of the five instances
    (one cull superchunk a shard, two unsharded), merged, equals the
    unsharded query bit for bit."""
    _sharded_against_whole(instances_scene, n, "traverse", 63,
                           ("cull_topk", "traverse_candidates", "cluster_stream"),
                           ("intersect_bruteforce", "matrix_traverse"))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_k2_on_instances_equals_unsharded_traverse(instances_scene, n):
    """K2 on each shard of the five instances (4611 or 2306 clusters, the
    sharded "auto"), merged, equals the unsharded "traverse" query (the
    one-device "auto") bit for bit, closest hit and any-hit."""
    _sharded_against_whole(instances_scene, n, "matrix", 65, ("matrix_traverse",),
                           ("intersect_bruteforce", "cull_topk", "traverse_candidates",
                            "cluster_stream"), whole_by="traverse")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_tables_are_the_uploaders_rule(atrium_big_scene, instances_scene, n):
    """Each shard's cluster boxes and slot blocks (row 9 included) are
    `cluster_boxes` and `pack_slots` over its own slots."""
    for scene in (atrium_big_scene, instances_scene):
        for sh in _shards(scene, n):
            g = sh.geometry
            real = g.tri_mat >= 0
            cmin, cmax = k6.cluster_boxes(g.tri_v0, g.tri_e1, g.tri_e2, real)
            assert torch.equal(g.cluster_min, cmin) and torch.equal(g.cluster_max, cmax)
            assert torch.equal(g.tri_packed, k6.pack_slots(g.tri_v0, g.tri_e1, g.tri_e2, real))


# --- closing the port: the dense engine, traverse_query, the "bvh" engine ------


@pytest.mark.parametrize("k", [8, 2])
def test_dense_on_atrium_big_matches_k2(atrium_big_batch, k):
    """The dense engine (K4's candidates tested in plain PyTorch, K2 for
    truncated lists) on atrium_big: the any-hit mask equals K2's and the
    closest hits K2's canonical hits (chip_smoke `dense_vs_k2`: ids may
    differ only inside the packed key's granule; cull misses counted),
    and the card's result equals the same query on the CPU bit for bit."""
    from hala_tpu_torch.ops import dense
    from hala_tpu_torch.ops.intersect import canonical_hit

    g, o, d, tm = atrium_big_batch
    before = (cuda_lib.CULL_TOPK.launches, cuda_lib.MATRIX_TRAVERSE.launches)
    hit = dense.intersect_dense(o, d, g, t_max=tm, k=k)
    torch.cuda.synchronize()
    assert cuda_lib.CULL_TOPK.launches > before[0]
    assert cuda_lib.MATRIX_TRAVERSE.launches > before[1]
    ref = canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, k2.intersect_matrix(o, d, g, t_max=tm))
    rec = chip_smoke.dense_vs_k2(f"dense K {k}", hit, ref, o, d, tm, g, k)
    assert rec["cull_misses"] <= 64
    tf = tm * (1.0 - 1e-4)
    occ = dense.occluded_dense(o, d, tf, g, k=k)
    assert chip_smoke.dense_anyhit_vs_k2(f"dense any-hit K {k}", occ, o, d, tf, g) <= 64
    g_cpu = types.SimpleNamespace(**{f: getattr(g, f).cpu() for f in (
        "tri_v0", "tri_e1", "tri_e2", "cluster_min", "cluster_max", "tri_packed")})
    n = 2048
    cpu = dense.intersect_dense(o[:n].cpu(), d[:n].cpu(), g_cpu, t_max=tm[:n].cpu(), k=k)
    _equal_bits([x[:n].cpu() for x in hit], cpu)


def test_traverse_query_and_signature_sort_on_atrium_big(atrium_big_batch):
    """traverse_query equals intersect_traversed, matrix_query with the
    signature sort the Morton-sorted query, bit for bit; the inexact
    options equal their kernels' plain versions."""
    g, o, d, tm = atrium_big_batch
    _equal_bits(k5.traverse_query(o, d, g, t_max=tm), k5.intersect_traversed(o, d, g, t_max=tm))
    _equal_bits(k2.matrix_query(o, d, g, t_max=tm, sort_key="signature"),
                k2.matrix_query(o, d, g, t_max=tm))
    rough = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=4, exact=False)
    with chip_smoke.plain_versions((k5, "cull_topk", chip_smoke.cull_plain),
                                   (k5, "traverse_candidates", k5.traverse_candidates_plain)):
        ref = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=4, exact=False)
    _equal_bits(rough, ref)
    wf = k7.intersect_wavefront(o, d, g, t_max=tm, k_per_ray=4, m_group=8, fallback=False)
    with chip_smoke.plain_versions((k7, "cull_topk", chip_smoke.cull_plain),
                                   (k7, "wavefront_walk", k7.wavefront_walk_plain)):
        ref = k7.intersect_wavefront(o, d, g, t_max=tm, k_per_ray=4, m_group=8,
                                     fallback=False)
    _equal_bits(wf, ref)


def test_bvh_on_the_card_matches_k1(cuda_device):
    """The "bvh" engine on atrium.glb's tables on the card against K1 over
    all slots (chip_smoke `bvh_vs_k1`: exact-t ties and grazes only),
    with no kernel launched by the traversal."""
    from hala_tpu_torch.ops import bvh

    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))
    dev = SceneUploader.upload(scene, device=cuda_device)
    g = dev.geometry
    o, d, _ = chip_smoke.mixed_batch(dev, 64, 64, 4096, 71)
    before = dict(cuda_lib.launches())
    hit = bvh.intersect_bvh(dev.bvh, g, o, d)
    torch.cuda.synchronize()
    assert cuda_lib.launches() == before
    ref = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2)
    chip_smoke.bvh_vs_k1("atrium bvh", hit, ref, o, d, g)


@pytest.mark.parametrize("kind", ["trace", "raster"])
def test_spans_share_the_profilers_clock(cuda_device, kind):
    """Under a CPU+CUDA torch.profiler capture of one atrium.glb frame
    with tracing on, every runtime launch event of K2 lies inside a
    hala.query span and every launch of K3's two kernels inside
    hala.raster.visibility, by the spans' own ns against the events'
    ns; bench_port/lib/stages.py leaves under 5 % of the device busy
    time unattributed."""
    from torch.profiler import ProfilerActivity, profile

    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
    from hala_tpu_torch.utils import profiling

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(HERE)), "bench_port"))
    from lib import devtrace, stages

    if kind == "trace":
        r = RayTracingRenderer("spans", 256, 256, max_depth=2, use_bvh=False,
                               device=cuda_device)
        kernels, inside = ("matrix_walk_kernel",), "hala.query"
    else:
        r = RasterizationRenderer("spans", 256, 256, binned=True, tile=64,
                                  device=cuda_device)
        kernels, inside = ("order_tiles_kernel", "raster_tiled_kernel"), "hala.raster.visibility"
    r.set_scene(Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")))
    r.commit()
    r.update()
    r.render()  # builds and loads the kernels
    profiling.reset()
    profiling.enable()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            r.update()
            r.render()
            t1 = time.time_ns()
        spans = profiling.spans()
    finally:
        profiling.disable()
        profiling.reset()
    trace = devtrace.DeviceTrace.from_profile(prof, t0, t1)
    ops = [e for e in trace.dev_ops if any(k in e.name for k in kernels)]
    assert ops, [e.name for e in trace.dev_ops][:20]
    boxes = [(s.start, s.end) for s in spans if s.name == inside]
    for e in ops:
        launch = next(trace.launches[c] for c in e.corr if c and c in trace.launches)
        assert any(a <= launch[0] <= b for a, b in boxes), (e.name, launch, boxes)
    table = stages.attribute(trace, spans, 1)
    assert table["unattributed_share"] < 5.0, table


# ---------------------------------------------------------------------------
# K9: the shading point's surface fetch (csrc/shade_fetch.cu)
# ---------------------------------------------------------------------------


def _k9_against_plain(case, rows=None):
    """K9 once, against shade_fetch_plain on the same CUDA tensors;
    `rows`, where given, the shade rows a lane."""
    from hala_tpu_torch.ops import shade_fetch as k9
    from hala_tpu_torch.ops.gathers import take_rows
    from test_torch_shade_fetch import assert_fetch_equal

    scene, hit, hit_p, pd, pa = case
    table = scene.geometry.shade_table
    before = cuda_lib.SHADE_FETCH.launches
    got = k9.shade_fetch(scene, hit, hit_p, pd, pa, rows)
    if rows is None:
        rows = take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))
    ref = k9.shade_fetch_plain(scene, rows, hit, hit_p, pd, pa)
    torch.cuda.synchronize()
    assert cuda_lib.SHADE_FETCH.launches == before + 1
    assert_fetch_equal(got, ref)


@pytest.mark.parametrize("levels", [1, 5])
@pytest.mark.parametrize("uv_transform", [False, True])
@pytest.mark.parametrize("normal_map", [False, True])
@pytest.mark.parametrize("cols", [32, 48])
def test_k9_matches_plain(cuda_device, cols, normal_map, uv_transform, levels):
    """Bit for bit on every output: 32- and 48-column rows, normal map on
    and off, uv transform on and off, one and five mip levels; the
    tables put uv below 0 and above 1, map ids at -1, misses and ids
    past the table among the hits and the LOD at both ends of its
    clamp (tests/test_torch_shade_fetch.py `fetch_case`)."""
    from test_torch_shade_fetch import fetch_case

    _k9_against_plain(fetch_case(cols, normal_map, uv_transform, levels, n=100_003,
                                 seed=cols + 2 * levels, device=cuda_device))


def test_k9_without_textures_matches_plain(cuda_device):
    from test_torch_shade_fetch import fetch_case

    _k9_against_plain(fetch_case(n=4099, seed=7, device=cuda_device, textures=False))


@pytest.mark.parametrize("textures", [False, True])
@pytest.mark.parametrize("cols", [32, 48])
def test_k9_with_spheres_matches_plain(cuda_device, cols, textures):
    """Procedural sphere hits (a fifth of the lanes): the analytic
    normal, uv, material, vertex colour, tangent and uv density in
    place of the row's, bit for bit."""
    from hala_tpu_torch.ops.prims import PROC_BASE
    from test_torch_shade_fetch import fetch_case

    case = fetch_case(cols, n=100_003, seed=cols + 3, device=cuda_device,
                      textures=textures, spheres=True)
    assert int((case[1].tri >= PROC_BASE).sum()) > 10_000
    _k9_against_plain(case)


@pytest.mark.parametrize("spheres", [False, True])
@pytest.mark.parametrize("cols", [32, 48])
def test_k9_rows_given_a_lane_match_plain(cuda_device, cols, spheres):
    """Shade rows given a lane (a sharded geometry's, through its
    collective): lane i reads row i, here a permutation of the lanes'
    own rows, bit for bit against the plain fetch over the same rows."""
    from hala_tpu_torch.ops.gathers import take_rows
    from test_torch_shade_fetch import fetch_case

    case = fetch_case(cols, n=65_537, seed=cols + 5, device=cuda_device, spheres=spheres)
    scene, hit = case[0], case[1]
    table = scene.geometry.shade_table
    perm = torch.randperm(hit.tri.shape[0], device=cuda_device,
                          generator=torch.Generator(cuda_device).manual_seed(4))
    _k9_against_plain(case, take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))[perm])


def test_k9_on_atrium_big_frames_batches(cuda_device):
    """Every bounce of an atrium_big 1920x1088 frame (2^20-lane tiles)
    through K9 and the plain version, bit for bit."""
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    dev = SceneUploader.upload(scene, use_ray_tracing=False, device=cuda_device)
    batches = chip_smoke.fetch_batches(dev)
    assert len(batches) == 8 and batches[0][0].tri.shape[0] == 1 << 20
    for hit, hit_p, pd, pa in batches:
        _k9_against_plain((dev, hit, hit_p, pd, pa))


def _atrium_spheres(device):
    host = Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))
    base = SceneUploader.upload(host, use_ray_tracing=False, device=device)
    return chip_smoke.with_spheres_on_view_axis(host, base)[0]


@pytest.mark.parametrize("name", ["atrium", "textures", "cornell", "procedural",
                                  "atrium_spheres"])
def test_k9_film_equals_the_plain_route(cuda_device, name, monkeypatch):
    """Two frames through K9 and through the plain fetch on the card
    (the plain version swapped in): films equal bit for bit. atrium.glb
    has a mip pyramid and three maps, the feature scene 48-column rows,
    a uv transform and a normal map, the Cornell box no textures; the
    procedural example's Cornell box and atrium.glb each add spheres."""
    from hala_tpu_torch.models import integrator
    from hala_tpu_torch.ops import shade_fetch as k9
    from hala_tpu_torch.ops.gathers import take_rows
    from test_torch_features import _mods, _texture_scene

    host = {"atrium": lambda: Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")),
            "textures": lambda: _texture_scene(_mods("hala_tpu_torch")),
            "cornell": cornell_box, "procedural": chip_smoke.procedural_scene,
            "atrium_spheres": lambda: _atrium_spheres(cuda_device)}[name]()
    dev = SceneUploader.upload(host, use_ray_tracing=False, device=cuda_device)
    assert (dev.procedural is not None) == (name in ("procedural", "atrium_spheres"))
    settings = RenderSettings(width=128, height=96, max_depth=4, rr_depth=2)

    def films():
        film = Film.create(128, 96, cuda_device)
        for f in range(2):
            render_frame(dev, None, Uniforms.default(cuda_device), film, f, settings)
        torch.cuda.synchronize()
        return film

    before = cuda_lib.SHADE_FETCH.launches
    kernel = films()
    assert cuda_lib.SHADE_FETCH.launches == before + 2 * 4

    def plain_fetch(scene, hit, hit_p, path_dist, pixel_angle, rows=None):
        if rows is None:
            table = scene.geometry.shade_table
            rows = take_rows(table, torch.clamp(hit.tri, 0, table.shape[0] - 1))
        return k9.shade_fetch_plain(scene, rows, hit, hit_p, path_dist, pixel_angle)

    monkeypatch.setattr(integrator, "shade_fetch", plain_fetch)
    plain = films()
    assert cuda_lib.SHADE_FETCH.launches == before + 2 * 4
    for k in ("accum", "albedo", "normal"):
        assert torch.equal(getattr(kernel, k), getattr(plain, k)), k


def test_k9_counter_reads_kernel_on_the_card(cuda_device):
    """`shade.fetch` reads route "kernel" for every bounce of a frame."""
    from hala_tpu_torch.utils import profiling

    dev = SceneUploader.upload(Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")),
                               use_ray_tracing=False, device=cuda_device)
    settings = RenderSettings(width=64, height=64, max_depth=3, tile_size=2048)
    film = Film.create(64, 64, cuda_device)
    profiling.reset()
    profiling.enable()
    try:
        render_frame(dev, None, Uniforms.default(cuda_device), film, 0, settings)
        counters = [c for c in profiling.counters() if c["name"] == "shade.fetch"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counters == [{"name": "shade.fetch", "labels": {"route": "kernel"}, "value": 2 * 3}]


# ---------------------------------------------------------------------------
# K10: a bounce's shading after the fetch (csrc/shade_bounce.cu)
# ---------------------------------------------------------------------------


def _k10_against_plain(scene, **kw):
    """Every bounce of the first ray tile through K10 and through the
    plain bounce on the same state: every field bit for bit, the query
    rows too, one K10 launch a bounce on the kernel route."""
    seen = 0
    for b, st, got, ref in chip_smoke.bounce_pairs(scene, **kw):
        torch.cuda.synchronize()
        chip_smoke.equal_bounce(f"K10 vs plain, bounce {b}", got, ref)
        seen += 1
    assert seen == kw.get("depth", 4)


def _k10_scene(name, device):
    from hala_tpu_torch.envmap import EnvMap
    from test_torch_features import (_alpha_scene, _lights_scene, _media_scene, _mods,
                                     _texture_scene)

    m = _mods("hala_tpu_torch")

    def up(host):
        return SceneUploader.upload(host, use_ray_tracing=False, device=device)

    def env():
        return EnvMap.from_array(chip_smoke.bench_envmap_array(), device=device)

    bn = torch.rand((64, 64, 4), device=device,
                    generator=torch.Generator(device).manual_seed(5))
    return {
        "cornell": lambda: (up(cornell_box()), dict(size=(128, 128))),
        "lights_and_glass": lambda: (up(_lights_scene(m)), dict(size=(96, 96))),
        "media": lambda: (up(_media_scene(m)), dict(size=(96, 96), depth=6)),
        "textures": lambda: (up(_texture_scene(m)), dict(size=(96, 96))),
        "alpha": lambda: (up(_alpha_scene(m)), dict(size=(96, 96))),
        "envmap": lambda: (up(cornell_box(light_intensity=0.0)),
                           dict(size=(96, 96), env=env())),
        "envmap_glass": lambda: (up(_lights_scene(m)), dict(size=(96, 96), env=env())),
        "blue_noise": lambda: (up(cornell_box()), dict(size=(96, 96), blue_noise=bn)),
        "procedural": lambda: (up(chip_smoke.procedural_scene()), dict(size=(96, 96))),
        "atrium": lambda: (up(Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))),
                           dict(size=(128, 128))),
        "atrium_spheres": lambda: (up(_atrium_spheres(device)), dict(size=(128, 128))),
    }[name]()


@pytest.mark.parametrize("name", ["cornell", "lights_and_glass", "media", "textures",
                                  "alpha", "envmap", "envmap_glass", "blue_noise",
                                  "procedural", "atrium", "atrium_spheres"])
def test_k10_matches_plain(cuda_device, name):
    """Bit for bit on every field and bounce: Oren-Nayar, Disney with
    transmission and all five light types (`lights_and_glass`), the
    three media over six bounces, normal, metallic-roughness and base
    maps with a uv transform (`textures`), the alpha test, the
    environment map with and without Disney, blue noise, procedural
    spheres, a mip pyramid (atrium.glb)."""
    scene, kw = _k10_scene(name, cuda_device)
    _k10_against_plain(scene, **kw)


def test_k10_on_atrium_big_first_tile_matches_plain(atrium_big_scene):
    """atrium_big's first 2^20-lane tile of a 1920x1088 frame, bounces
    0-3 (Russian roulette from bounce 2), bit for bit."""
    _k10_against_plain(atrium_big_scene, size=(1920, 1088))


def test_k10_with_rows_of_a_sharded_geometry_matches_plain(cuda_device):
    """A geometry sharded over a one-rank mesh: the fetch takes its rows
    lane by lane through the owners' collective, and K10 reads that
    fetch, bit for bit with the plain bounce."""
    from hala_tpu_torch.parallel.scene_shard import shard_scene
    from hala_tpu_torch.parallel.tiling import make_mesh

    mesh = make_mesh(cuda_device)
    host = Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb"))
    scene = shard_scene(SceneUploader.upload(host, use_ray_tracing=False, device="cpu"), mesh)
    _k10_against_plain(scene, size=(128, 128), scene_axis=mesh)


@pytest.mark.parametrize("name, size, frames", [("atrium_big", (1920, 1088), 4),
                                                ("cornell", (512, 512), 16)])
def test_k10_film_equals_the_plain_route(cuda_device, atrium_big_scene, name, size, frames,
                                         monkeypatch):
    """The films of atrium_big (4 frames, 1920x1088, two tiles) and the
    Cornell box (16 frames, 512x512) through K10 and through the plain
    bounce on the card: equal bit for bit, K10 once a bounce and tile,
    its pass before the fetch only where the fetch reads a map."""
    from hala_tpu_torch.ops import shade_bounce as k10

    dev = (atrium_big_scene if name == "atrium_big" else
           SceneUploader.upload(cornell_box(), use_ray_tracing=False, device=cuda_device))
    w, h = size
    settings = RenderSettings(width=w, height=h, max_depth=4, rr_depth=2)

    def films():
        film = Film.create(w, h, cuda_device)
        for f in range(frames):
            render_frame(dev, None, Uniforms.default(cuda_device), film, f, settings)
        torch.cuda.synchronize()
        return film

    before = (cuda_lib.SHADE_BOUNCE.launches, cuda_lib.SHADE_BOUNCE_PRE.launches)
    kernel = films()
    want = chip_smoke.fetch_launches(settings, frames)
    assert (cuda_lib.SHADE_BOUNCE.launches - before[0],
            cuda_lib.SHADE_BOUNCE_PRE.launches - before[1]) == (
                want, want if dev.textures is not None else 0)
    monkeypatch.setattr(k10, "bounce_route", lambda device: "plain")
    before = cuda_lib.SHADE_BOUNCE.launches
    plain = films()
    assert cuda_lib.SHADE_BOUNCE.launches == before
    for k in ("accum", "albedo", "normal"):
        assert torch.equal(getattr(kernel, k), getattr(plain, k)), k


@pytest.mark.parametrize("name, kind", [
    ("cornell", "intersection"), ("cornell", "miss"), ("envmap_glass", "miss"),
    ("textures", "closest_hit"), ("lights_and_glass", "closest_hit"), ("alpha", "any_hit"),
    ("cornell", "identity"), ("media", "all"), ("procedural", "all"), ("atrium", "all"),
])
def test_k10_with_pushed_kernels_matches_plain(cuda_device, name, kind):
    """Pushed kernels on the seams inside the bounce (chip_smoke
    `seam_hooks`) run between K10's seam passes, and K10 reads what they
    give: every field and bounce bit for bit with the plain bounce under
    the same kernels."""
    scene, kw = _k10_scene(name, cuda_device)
    _k10_against_plain(scene, hooks=chip_smoke.seam_hooks(kind), **kw)


def test_k10_film_with_pushed_kernels_equals_the_plain_route(cuda_device, monkeypatch):
    """A 512x512 Cornell film, 4 frames, with pushed kernels on all four
    seams inside the bounce: equal to the plain route's bit for bit, K10
    once a bounce and tile and each of its two seam passes too."""
    from hala_tpu_torch.ops import shade_bounce as k10

    dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False, device=cuda_device)
    settings = RenderSettings(width=512, height=512, max_depth=4, rr_depth=2)
    hooks = chip_smoke.seam_hooks("all")

    def films():
        film = Film.create(512, 512, cuda_device)
        for f in range(4):
            render_frame(dev, None, Uniforms.default(cuda_device), film, f, settings,
                         hooks=hooks)
        torch.cuda.synchronize()
        return film

    cuda_lib.reset_launches()
    kernel = films()
    want = chip_smoke.fetch_launches(settings, 4)
    assert (cuda_lib.SHADE_BOUNCE.launches, cuda_lib.SHADE_BOUNCE_SEAM.launches) == (
        want, 2 * want)
    monkeypatch.setattr(k10, "bounce_route", lambda device: "plain")
    cuda_lib.reset_launches()
    plain = films()
    assert cuda_lib.SHADE_BOUNCE.launches == cuda_lib.SHADE_BOUNCE_SEAM.launches == 0
    for k in ("accum", "albedo", "normal"):
        assert torch.equal(getattr(kernel, k), getattr(plain, k)), k


def test_k10_counter_reads_kernel_on_the_card(cuda_device):
    """`shade.bounce` reads route "kernel" for every bounce of a frame,
    with and without a pushed closest-hit kernel."""
    from hala_tpu_torch.models.integrator import KernelHooks
    from hala_tpu_torch.utils import profiling

    dev = SceneUploader.upload(Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")),
                               use_ray_tracing=False, device=cuda_device)
    settings = RenderSettings(width=64, height=64, max_depth=3, tile_size=2048)
    counters = {}
    for label, hooks in (("bare", None),
                         ("closest_hit", KernelHooks(closest_hit=lambda ctx, mp: mp))):
        film = Film.create(64, 64, cuda_device)
        profiling.reset()
        profiling.enable()
        try:
            render_frame(dev, None, Uniforms.default(cuda_device), film, 0, settings,
                         hooks=hooks)
            counters[label] = [c for c in profiling.counters() if c["name"] == "shade.bounce"]
        finally:
            profiling.disable()
            profiling.reset()
    for label, got in counters.items():
        assert got == [{"name": "shade.bounce", "labels": {"route": "kernel"}, "value": 2 * 3}]
