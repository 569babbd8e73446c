"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports neither jax nor hala_tpu, so it also runs on a machine
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from hala_tpu_torch.models.integrator import Film, RenderSettings, Uniforms, render_frame
from hala_tpu_torch.ops import cluster as k6
from hala_tpu_torch.ops import cuda_lib
from hala_tpu_torch.ops import cull as k4
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
    g = SceneUploader.upload(random_triangle_soup(300, seed=5), device=cuda_device).geometry
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
    g = SceneUploader.upload(scene, device=cuda_device).geometry
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
    g = SceneUploader.upload(cornell_box(), device=cuda_device).geometry
    o, d = (x.to(cuda_device) for x in _rays(64, 5))
    with pytest.raises(ValueError):
        k1.intersect_pallas(o.double(), d, g.tri_v0, g.tri_e1, g.tri_e2)
    with pytest.raises(ValueError):
        k1.intersect_pallas(o, d.cpu(), g.tri_v0, g.tri_e1, g.tri_e2)


def test_cornell_golden_on_card(cuda_device):
    dev = SceneUploader.upload(cornell_box(), device=cuda_device)
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
        Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")), device=cuda_device)
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
    g = SceneUploader.upload(scene, device=dev).geometry
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
    g = SceneUploader.upload(scene, device=dev).geometry
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
def instances():
    """Five instances of atrium_big side by side along x (the scene
    "auto" sends to K4-K6: above 8191 clusters, two cull superchunks),
    uploaded through the SAH build, and 16,384 rays from inside their
    bounds."""
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
    g = SceneUploader.upload(host, device=dev).geometry
    assert g.cluster_min.shape[0] > k4.CULL_MAX_CLUSTERS
    return (g, *_inside_rays(g, 16384, 13))


def _coherent(g, o, d, tm):
    perm = torch.argsort(k2._coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
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


def _k2_against_plain(o, d, tm, g):
    """K2 against its plain version (the same hits, any-hit mask) and its
    schedule against the plain model (hits and runs, closest and any
    hit), bit for bit. Returns the runs."""
    args = (o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    before = cuda_lib.MATRIX_TRAVERSE.launches
    hit, runs = k2.matrix_walk_runs(o, d, g, t_max=tm)
    occ, occ_runs = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=True)
    plain = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    model, model_runs = k2.matrix_walk_runs_plain(*args, False)
    occ_model, occ_model_runs = k2.matrix_walk_runs_plain(*args, True)
    torch.cuda.synchronize()
    assert cuda_lib.MATRIX_TRAVERSE.launches == before + 2
    _equal_bits(hit, plain)
    _equal_bits((*hit, runs), (*model, model_runs))
    _equal_bits((*occ, occ_runs), (*occ_model, occ_model_runs))
    assert torch.equal(occ.tri >= 0, plain.tri >= 0)
    _equal_bits(k2.intersect_matrix(o, d, g, t_max=tm), plain)
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
    order = torch.argsort(k2._coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                          stable=True)
    o_s, d_s, tm_s = (x[order].contiguous() for x in (o, d, tm))
    runs = _k2_against_plain(o_s, d_s, tm_s, g)
    assert 0 < int(runs.max()) <= g.cluster_min.shape[0]
    assert int(runs[-1]) == 0 or bool((tm_s[-k2.MATRIX_BLOCK_RAYS:] > 1e-4).any())


def test_k2_sorted_atrium_big_matches_plain(cuda_device):
    """atrium_big (1861 clusters): 16,384 rays from inside its bounds in
    matrix_query's coherence order."""
    scene = Scene.load(os.path.join(HERE, "..", "assets", "atrium_big.glb"))
    g = SceneUploader.upload(scene, device=cuda_device).geometry
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
    order = torch.argsort(k2._coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
                          stable=True)
    o, d, tm = (x[order].contiguous() for x in (o, d, tm))
    runs = _k2_against_plain(o, d, tm, g)
    assert int(runs.max()) <= g.cluster_min.shape[0]


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("k", [1, 4, 12, 16])
def test_k5_sorted_and_unsorted_match_plain(atrium_batch, k, order):
    """K5 (half a warp a ray) on K4's lists of the fixture's batch as
    given and in matrix_query's coherence order: all six outputs bit
    for bit."""
    g, o, d, tm = atrium_batch
    if order == "sorted":
        perm = torch.argsort(k2._coherence_key(o, d, tm, g.cluster_min, g.cluster_max),
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
    order = torch.argsort(k8._coherence_key(o, d, tm, cmin, cmax), stable=True)
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
