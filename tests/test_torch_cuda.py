"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports neither jax nor hala_tpu, so it also runs on a machine
without JAX, where tests/conftest.py cannot load:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os

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
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box, random_triangle_soup

HERE = os.path.dirname(__file__)
pytestmark = pytest.mark.cuda


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
    triangles from its first camera: tiles 16, 32 and 64 take the 1-,
    4- and 16-pixels-a-thread instantiations, tile 128 walks its
    segment in four pixel passes."""
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
    got = k5.traverse_candidates(o, d, tm, ids, tns, ovf, g.tri_packed)
    ref = k5.traverse_candidates_plain(o, d, tm, ids, tns, ovf, g.tri_packed)
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
