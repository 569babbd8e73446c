"""The port's rasterizer ops against the JAX package's, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Triangle ids must be equal. Depth and the barycentrics must agree to
FLOAT_TOL: the port rounds its edge functions and three-term sums with
the fused multiply-adds XLA's CPU backend puts there (ops/raster.py), so
the two agree exactly in practice; the tolerance only allows an ulp of
platform rounding. The K3 wrapper runs its plain version here (CPU
tensors); tests/test_torch_cuda.py holds the kernel against it on the
card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops import raster as jr
from hala_tpu.ops import raster_kernel as jk
from hala_tpu_torch.ops import raster as tr
from hala_tpu_torch.ops import raster_kernel as tk

HERE = os.path.dirname(__file__)
FLOAT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mesh(seed, t, huge_frac=0.05, extent=64.0):
    """Random screen-space triangles in three size classes (as
    tests/test_raster.py TestExactSegmented builds them), every 17th
    invalid."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0, extent, (t, 1, 2))
    r = rs.rand(t, 1, 1)
    ext = np.where(r < 0.85, 8.0, np.where(r < 1 - huge_frac, 60.0, 300.0))
    tri = (c + rs.uniform(-0.5, 0.5, (t, 3, 2)) * ext).astype(np.float32)
    depth = rs.uniform(0.1, 0.9, (t, 3)).astype(np.float32)
    inv_w = rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32)
    valid = np.ones(t, bool)
    valid[::17] = False
    return tri, depth, inv_w, valid


def _quad_grid(cells=8, size=8.0, seed=0):
    """A grid of quads, two triangles each with mixed windings: pixel
    centres lie exactly on the shared diagonals (the seam case)."""
    rs = np.random.RandomState(seed)
    tris = []
    for i in range(cells):
        for j in range(cells):
            x0, y0 = i * size, j * size
            a, b = (x0, y0), (x0 + size, y0)
            c, d = (x0 + size, y0 + size), (x0, y0 + size)
            tris += [[a, b, c], [a, d, c]] if (i + j) % 2 else [[a, c, b], [a, c, d]]
    tri = np.asarray(tris, np.float32)
    t = tri.shape[0]
    depth = np.repeat(rs.uniform(0.2, 0.8, (t // 2, 1)), 2, axis=0)
    depth = np.repeat(depth, 3, axis=1).astype(np.float32)
    inv_w = rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32)
    return tri, depth, inv_w, np.ones(t, bool)


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _pixels(w, h):
    pix = np.arange(w * h)
    return ((pix % w).astype(np.float32) + 0.5,
            (pix // w).astype(np.float32) + 0.5)


def _assert_frag(jf, tf):
    np.testing.assert_array_equal(np.asarray(jf.tri), tf.tri.numpy())
    for k in ("depth", "u", "v"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)),
                                   rtol=0, atol=FLOAT_TOL, err_msg=k)


@pytest.mark.parametrize("variant", ["plain", "tri_ids", "depth_bound", "seam_dedup"])
def test_rasterize_matches_jax(variant):
    w = h = 64
    if variant == "seam_dedup":
        arrays = _quad_grid()
    else:
        arrays = _mesh(1, 320)
    t = arrays[0].shape[0]
    (j_args, t_args) = _both(arrays)
    px, py = _pixels(w, h)
    kw_j, kw_t = {}, {}
    if variant == "tri_ids":
        ids = np.random.RandomState(2).permutation(t).astype(np.int32) + 7
        kw_j["tri_ids"], kw_t["tri_ids"] = jnp.asarray(ids), torch.from_numpy(ids)
    if variant == "depth_bound":
        bound = np.random.RandomState(3).uniform(0.2, 1.0, w * h).astype(np.float32)
        kw_j["depth_bound"] = jnp.asarray(bound)
        kw_t["depth_bound"] = torch.from_numpy(bound)
    if variant == "seam_dedup":
        kw_j["seam_dedup"] = kw_t["seam_dedup"] = True
    chunk = t // 2
    jf = jr.rasterize(*j_args, jnp.asarray(px), jnp.asarray(py), chunk=chunk, **kw_j)
    tf = tr.rasterize(*t_args, torch.from_numpy(px), torch.from_numpy(py),
                      chunk=chunk, **kw_t)
    _assert_frag(jf, tf)
    assert (tf.tri >= 0).float().mean() > 0.3
    if variant == "seam_dedup":
        # every pixel of the grid is covered once: no cracks on the seams
        assert bool((tf.tri >= 0).all())


def test_fma32_is_a_fused_multiply_add():
    """One rounding of a * b + c: against exact rational arithmetic on
    random floats, including cancelling and far-apart magnitudes."""
    from fractions import Fraction

    rs = np.random.RandomState(0)
    a = (rs.uniform(-2, 2, 4000) * 10.0 ** rs.randint(-6, 6, 4000)).astype(np.float32)
    b = (rs.uniform(-2, 2, 4000) * 10.0 ** rs.randint(-6, 6, 4000)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * rs.choice([1.0, 1.0 + 1e-7, 0.5], 4000)).astype(np.float32)
    got = tr.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a[:800], b[:800], c[:800], got[:800]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the float32 nearest the exact value (float() rounds once, to
        # float64; check the neighbours for the true nearest)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert g == best, (x, y, z, g, best)


@pytest.mark.parametrize("path", ["overlap", "overlap_capped", "scatter", "scatter_capped"])
def test_rasterize_tiled_matches_jax(path):
    j_args, t_args = _both(_mesh(3, 400, huge_frac=0.0))
    if path.startswith("overlap"):
        k_max = 400 if path == "overlap" else 24
        jf, jo = jr.rasterize_tiled(*j_args, 64, 64, tile=16, k_max=k_max, scatter=False)
        tf, to = tr.rasterize_tiled(*t_args, 64, 64, tile=16, k_max=k_max, scatter=False)
    else:
        k_max, large = (400, 400) if path == "scatter" else (8, 16)
        jf, jo = jr._rasterize_tiled_scatter(*j_args, 64, 64, 16, k_max, large_max=large)
        tf, to = tr._rasterize_tiled_scatter(*t_args, 64, 64, 16, k_max, large_max=large)
    _assert_frag(jf, tf)
    assert float(jo) == float(to)
    assert (float(to) > 0) == path.endswith("capped")


@pytest.mark.parametrize("km_max", [16, 3])
def test_meshlet_binned_matches_jax(km_max):
    tri, depth, inv_w, valid = _mesh(4, 300, huge_frac=0.0)
    rs = np.random.RandomState(5)
    order = rs.permutation(300)
    ml_tri = np.full((15, 128), -1, np.int32)
    for m in range(15):
        members = order[m * 20:(m + 1) * 20]
        ml_tri[m, :len(members)] = members
    visible = rs.rand(15) < 0.8
    j_args, t_args = _both((tri, depth, inv_w, valid, ml_tri, visible))
    jf, jo = jr.rasterize_meshlet_binned(*j_args, 64, 64, tile=16, km_max=km_max)
    tf, to = tr.rasterize_meshlet_binned(*t_args, 64, 64, tile=16, km_max=km_max)
    _assert_frag(jf, tf)
    assert float(jo) == float(to)
    assert (float(to) > 0) == (km_max == 3)


# --- K3: the exact segment path ------------------------------------------


def _skewed(t=512, seed=5):
    """Every triangle stacked in one tile: the case that overflows any
    per-tile cap."""
    rs = np.random.RandomState(seed)
    tri = (rs.uniform(2, 12, (t, 1, 2)) + rs.uniform(-1, 1, (t, 3, 2))).astype(np.float32)
    return (tri, rs.uniform(0.1, 0.9, (t, 3)).astype(np.float32),
            rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32), np.ones(t, bool))


@pytest.mark.parametrize("case", ["mixed_256", "skewed_64"])
def test_exact_matches_jax_interpret(case):
    """The port's rasterize_tiled_exact (K3's plain version on the CPU)
    against the JAX package's Pallas kernel in interpret mode, and
    against the port's own full scan, on tests/test_raster.py's meshes."""
    if case == "mixed_256":
        arrays, size = _mesh(3, 600, extent=256.0), 256
    else:
        arrays, size = _skewed(), 64
    j_args, t_args = _both(arrays)
    jf, jo = jk.rasterize_tiled_exact(*j_args, size, size, tile=16, interpret=True)
    tf, to = tk.rasterize_tiled_exact(*t_args, size, size, tile=16)
    _assert_frag(jf, tf)
    assert float(jo) == float(to) == 0.0
    px, py = _pixels(size, size)
    t = arrays[0].shape[0]
    full = tr.rasterize(*t_args, torch.from_numpy(px), torch.from_numpy(py),
                        chunk=t // 4, tri_ids=torch.arange(t, dtype=torch.int32))
    for k in ("depth", "tri", "u", "v"):
        assert torch.equal(getattr(full, k), getattr(tf, k)), k


@pytest.mark.parametrize("bound", [dict(huge_max=4), dict(mid_max=2), dict(cand_cap=128)])
def test_exact_overflow_flags_match_jax(bound):
    arrays = _mesh(3, 600, huge_frac=0.2, extent=256.0)
    j_args, t_args = _both(arrays)
    _, jo = jk.rasterize_tiled_exact(*j_args, 256, 256, tile=16, interpret=True, **bound)
    tf, to = tk.rasterize_tiled_exact(*t_args, 256, 256, tile=16, **bound)
    assert float(jo) == float(to) == 1.0
    assert bool(torch.isfinite(tf.depth).all())


def test_exact_segments_are_id_ordered():
    """Segments cover [0, n_real) back to back and list each tile's
    candidates in ascending id order (what makes the sequential strict
    `>` equal to the full scan's lowest-id rule)."""
    _, t_args = _both(_mesh(7, 500, extent=128.0))
    seg = tk.build_segments(*t_args, 128, 128, tile=16)
    lengths = (seg.starts[1:] - seg.starts[:-1]).numpy()
    assert int(seg.starts[0]) == 0 and lengths.sum() == int(seg.n_real)
    assert (lengths >= 0).all() and float(seg.over) == 0.0
    ids = seg.data[:, 14].numpy()
    for t0, t1 in zip(seg.starts[:-1].tolist(), seg.starts[1:].tolist()):
        assert (np.diff(ids[t0:t1]) > 0).all()


def test_rasterize_tiled_routes_large_meshes_to_exact():
    """More than 4096 triangles with a lane-divisible tile goes to the
    exact segment path, as the JAX package routes it."""
    arrays = _mesh(11, 4200, huge_frac=0.01)
    _, t_args = _both(arrays)
    routed, over = tr.rasterize_tiled(*t_args, 64, 64, tile=16)
    exact, _ = tk.rasterize_tiled_exact(*t_args, 64, 64, tile=16)
    assert float(over) == 0.0
    for k in ("depth", "tri", "u", "v"):
        assert torch.equal(getattr(routed, k), getattr(exact, k)), k


@pytest.mark.parametrize("t, tile, n_tiles, path", [
    (128, 64, 510, "k3"),              # one 128-slot cluster at 1920x1088
    (128, 64, 2040, "k3"),             # 2x MSAA at 1080p
    (128, 64, 8160, "plain"),          # 4x MSAA at 1080p: cell << 20 passes 2^31
    (128, 8, 32640, "plain"),          # tile*tile 64: not lane-divisible
    (4224, 64, 510, "k3"),             # where the JAX package routes too
    (1 << 20, 64, 510, "plain"),       # ids past the fused key's 20 bits
])
def test_tiled_route(t, tile, n_tiles, path):
    """Every mesh K3 can lay out takes K3, whatever its size."""
    assert tr.tiled_route(t, tile, n_tiles) == path


def _cornell_pose(seed, width, height, tile):
    """The Cornell box uploaded with its 128-slot padding, its camera
    moved by up to 0.3 on each axis by `seed`: the binned pass's
    (screen, depth, inv_w, valid)."""
    from hala_tpu_torch.models.rz_renderer import RasterSettings, _raster_setup
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box

    host = cornell_box()
    (cam,) = [n for n in host.nodes if n.camera_index is not None]
    cam.local_transform = cam.local_transform.copy()
    cam.local_transform[:3, 3] += np.random.RandomState(seed).uniform(-0.3, 0.3, 3)
    host.update_node_hierarchies()
    scene = SceneUploader.upload(host, use_ray_tracing=False, device="cpu")
    assert scene.geometry.tri_v0.shape[0] == 128
    settings = RasterSettings(width, height, binned=True, tile=tile)
    return _raster_setup(scene, 0, settings)[:4]


def _equal_bits(a, b):
    assert torch.equal(a.tri, b.tri)
    for k in ("depth", "u", "v"):
        assert torch.equal(getattr(a, k).view(torch.int32),
                           getattr(b, k).view(torch.int32)), k


@pytest.mark.parametrize("case", ["cornell_0", "cornell_1", "cornell_2",
                                  "mesh_256", "mesh_1000"])
def test_exact_equals_capped_where_nothing_clips(case):
    """Where the capped per-tile path reports no overflow, the routed
    exact segment path (K3's plain version here) gives its image bit
    for bit."""
    if case.startswith("cornell"):
        width, height, tile = 200, 136, 64
        t_args = _cornell_pose(int(case[-1]), width, height, tile)
    else:
        width = height = 128
        tile = 16
        _, t_args = _both(_mesh(int(case[5:]), int(case[5:]), extent=128.0))
    capped, c_over = tr.rasterize_tiled(*t_args, width, height, tile=tile, scatter=False)
    exact, e_over = tr.rasterize_tiled(*t_args, width, height, tile=tile)
    assert float(c_over) == float(e_over) == 0.0
    assert (capped.tri >= 0).float().mean() > 0.3
    _equal_bits(exact, capped)


@pytest.mark.parametrize("case", ["skewed_512", "mesh_1000"])
def test_exact_is_the_full_scan_where_the_cap_clips(case):
    """Where a tile's candidate list clips at k_max (the capped path's
    overflow reads > 0), the exact path gives the unbinned full scan's
    image and the capped path another."""
    if case == "skewed_512":
        arrays, k_max = _skewed(512), 256
    else:
        arrays, k_max = _mesh(13, 1000, huge_frac=0.05), 64
    _, t_args = _both(arrays)
    capped, c_over = tr.rasterize_tiled(*t_args, 64, 64, tile=16, k_max=k_max,
                                        scatter=False)
    exact, e_over = tk.rasterize_tiled_exact(*t_args, 64, 64, tile=16)
    assert float(c_over) > 0.0 and float(e_over) == 0.0
    t = arrays[0].shape[0]
    px, py = _pixels(64, 64)
    full = tr.rasterize(*t_args, torch.from_numpy(px), torch.from_numpy(py),
                        chunk=t // 4, tri_ids=torch.arange(t, dtype=torch.int32))
    _equal_bits(exact, full)
    assert not torch.equal(capped.tri, full.tri)


def _strips(t, seed=7):
    """`t` thin strips across 256 x 64 pixels, each 130-250 wide (8 or
    more tiles of 16: the segment path's "huge" class) and 1-4 high."""
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(-20.0, 100.0, (t, 1))
    y0 = rs.uniform(0.0, 64.0, (t, 1))
    length = rs.uniform(130.0, 250.0, (t, 1))
    height = rs.uniform(1.0, 4.0, (t, 1))
    s = rs.uniform(0.2, 0.8, (t, 1))
    tri = np.stack([np.concatenate([x0, y0], 1),
                    np.concatenate([x0 + length, y0 + height * s], 1),
                    np.concatenate([x0 + length * s, y0 + height], 1)], 1)
    return (tri.astype(np.float32), rs.uniform(0.1, 0.9, (t, 3)).astype(np.float32),
            rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32), np.ones(t, bool))


def _covering(t, seed=8):
    """`t` triangles, each around 960 x 544 pixels (2040 tiles of 16)
    or most of it: about t x 2040 (tile, candidate) pairs."""
    rs = np.random.RandomState(seed)
    around = np.array([[-700.0, -300.0], [1700.0, -300.0], [480.0, 1500.0]])
    tri = (around + rs.uniform(-500.0, 500.0, (t, 3, 2))).astype(np.float32)
    return (tri, rs.uniform(0.1, 0.9, (t, 3)).astype(np.float32),
            rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32), np.ones(t, bool))


@pytest.mark.parametrize("case", ["huge_600", "pairs_2040"])
def test_routed_exact_past_the_jax_bounds(case):
    """Meshes of at most 4096 triangles past the JAX package's static
    bounds of the segment path (600 huge triangles against its 512; at
    2040 tiles more than its 131072 (tile, candidate) pairs): the
    routed path sizes the bounds so that none binds, and gives the full
    scan's image (at every 8th pixel at 2040 tiles), as the capped path
    does with a cap that cannot clip."""
    if case == "huge_600":
        arrays, w, h, step = _strips(600), 256, 64, 1
    else:
        arrays, w, h, step = _covering(128), 960, 544, 8
    t = arrays[0].shape[0]
    _, t_args = _both(arrays)
    assert float(tk.build_segments(*t_args, w, h, 16).over) == 1.0
    routed, over = tr.rasterize_tiled(*t_args, w, h, tile=16)
    assert float(over) == 0.0
    assert (routed.tri >= 0).float().mean() > 0.3
    px, py = _pixels(w, h)
    full = tr.rasterize(*t_args, torch.from_numpy(px[::step]), torch.from_numpy(py[::step]),
                        chunk=t // 4, tri_ids=torch.arange(t, dtype=torch.int32))
    _equal_bits(tr.FragmentBuffer(*(x[::step] for x in routed)), full)
    if step == 1:
        capped, c_over = tr.rasterize_tiled(*t_args, w, h, tile=16, k_max=t, scatter=False)
        assert float(c_over) == 0.0
        _equal_bits(routed, capped)


def test_k3_wrapper_takes_plain_version_on_cpu():
    from hala_tpu_torch.ops import cuda_lib

    before = cuda_lib.RASTER_TILED.launches
    _, t_args = _both(_skewed(64))
    seg = tk.build_segments(*t_args, 32, 32, tile=16)
    got = tk.raster_segments(seg.starts, seg.data, seg.tw, seg.tile)
    ref = tk.raster_segments_plain(seg.starts, seg.data, seg.tw, seg.tile)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert cuda_lib.RASTER_TILED.launches == before


# --- vertex stage and meshlet tables ---------------------------------------


def test_transform_and_clip_match_jax():
    rs = np.random.RandomState(8)
    pos = rs.uniform(-2, 2, (200, 3)).astype(np.float32)
    vp = rs.normal(size=(4, 4)).astype(np.float32)
    jc = jr.transform_vertices(jnp.asarray(pos), jnp.asarray(vp))
    tc = tr.transform_vertices(torch.from_numpy(pos), torch.from_numpy(vp))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    js = jr.clip_to_screen(jc, 64, 48)
    ts = tr.clip_to_screen(torch.from_numpy(np.array(jc)), 64, 48)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("scene", ["cornell", "atrium"])
def test_meshlet_tables_match_jax(scene):
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp
    from hala_tpu_torch.scene.loader.uploader import SceneUploader as TUp

    if scene == "cornell":
        from hala_tpu.scene.procedural import cornell_box as jb
        from hala_tpu_torch.scene.procedural import cornell_box as tb

        js, ts = jb(), tb()
    else:
        from hala_tpu.scene.cpu.scene import Scene as JS
        from hala_tpu_torch.scene.cpu.scene import Scene as TS

        path = os.path.join(HERE, "..", "assets", "atrium.glb")
        js, ts = JS.load(path), TS.load(path)
    jm = JUp.upload(js, use_mesh_shader=True, use_ray_tracing=False).meshlets
    tm = TUp.upload(ts, use_mesh_shader=True, use_ray_tracing=False, device="cpu").meshlets
    assert jm.num_meshlets == tm.num_meshlets > 0
    for k in ("cone_apex", "cone_axis", "cone_cutoff", "center", "radius",
              "tri_meshlet", "tri_ids"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)), k)
    # host meshlets of both packages' native clustering
    jp = js.meshes[0].primitives[0]
    tp = ts.meshes[0].primitives[0]
    np.testing.assert_array_equal(tp.meshlet_vertices, jp.meshlet_vertices)
    np.testing.assert_array_equal(tp.meshlet_primitives, jp.meshlet_primitives)


def test_native_meshlets_match_python_clustering():
    from hala_tpu_torch.ops.meshlets import build_meshlets
    from hala_tpu_torch.scene.procedural import cornell_box

    prim = cornell_box().meshes[0].primitives[0]
    native = build_meshlets(prim.indices, prim.positions)
    python = build_meshlets(prim.indices, prim.positions, use_native=False)
    assert len(native[0]) == len(python[0])
    np.testing.assert_array_equal(native[1], python[1])
    np.testing.assert_array_equal(native[2], python[2])
