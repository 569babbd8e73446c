"""The large-scene engines of the port against the JAX package.

K4 (`ops/cull.py`, csrc/cull_topk.cu), K5 (`ops/traverse.py`,
csrc/traverse_candidates.cu) and K6 (`ops/cluster.py`,
csrc/cluster_stream.cu), with the modules around them: `morton3d`,
`sort_rays`, `cull_candidates`, `cull_ordered`, `intersect_traversed`,
`intersect_clustered` and the integrator's "traverse" and "cluster"
engines. On the CPU each wrapper
runs its plain PyTorch version; hala_tpu's Pallas kernels run in
interpret mode, as tests/test_traverse.py and tests/test_cluster.py run
them.

- Bit for bit against the JAX package: Morton codes, the ray sort, the
  K4 keys and counts, the superchunk merge and `cull_ordered`.
- Against brute force (triangle ids equal, t/u/v within rtol/atol 1e-5,
  the tolerance of tests/test_traverse.py): every intersector.
- Renders side by side with hala_tpu's frame at atol 1e-3, the
  tolerance of tests/test_cluster.py.

Two geometries: the sponza_like of tests/test_traverse.py (3 clusters)
and a 6x6-room sponza_like (63 clusters), where candidate lists really
truncate at K = 4 and superchunks of 8 really merge.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops import cluster as j_cluster
from hala_tpu.ops import compaction as j_compaction
from hala_tpu.ops import morton as j_morton
from hala_tpu.ops import traverse as j_traverse
from hala_tpu.ops.cull import cull_topk as j_cull_topk
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import sponza_like
from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.ops import cluster as k6
from hala_tpu_torch.ops import compaction, cull, morton
from hala_tpu_torch.ops import traverse as k5
from hala_tpu_torch.ops.cluster import with_pretest_row
from hala_tpu_torch.ops.intersect import intersect_bruteforce
from hala_tpu_torch.scene.gpu.scene import from_numpy

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _upload(**kw):
    jdev = JUp.upload(sponza_like(**kw), use_ray_tracing=False)
    return jdev, from_numpy(jdev, "cpu")


@pytest.fixture(scope="module")
def geoms():
    """name -> (hala_tpu device scene, hala_tpu_torch device scene)."""
    return {
        # the geometry of tests/test_traverse.py
        "sponza": _upload(rooms=(2, 2), columns_per_room=4, boxes_per_room=2),
        "rooms": _upload(rooms=(6, 6), columns_per_room=8, boxes_per_room=4),
    }


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(tdev, n, seed):
    """Rays inside the scene's bounds, a dozen along the axes (zero
    direction components), a quarter of them bounded and some dead."""
    rs = np.random.RandomState(seed)
    g = tdev.geometry
    real = g.tri_v0[g.tri_mat >= 0]
    lo, hi = real.amin(0).numpy(), real.amax(0).numpy()
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(12):
        d[i] = 0.0
        d[i, i % 3] = 1.0 if (i // 3) % 2 == 0 else -1.0
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.1, 4.0, len(tm[1::4]))
    tm[::13] = 0.0
    return o, d, tm


def _assert_hits(ours, ref, what=""):
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri), err_msg=what)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=TOL, err_msg=what)
    m = np.asarray(ref.tri) >= 0
    for a, b in ((ours.u, ref.u), (ours.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], atol=TOL, err_msg=what)


def _brute(tdev, o, d, tm):
    g = tdev.geometry
    return intersect_bruteforce(_t(o), _t(d), g.tri_v0, g.tri_e1, g.tri_e2,
                                t_max=_t(tm), chunk=512)


# --- Morton codes and the ray sort --------------------------------------------


def test_morton3d_matches_jax():
    rs = np.random.RandomState(1)
    pts = rs.uniform(-3.0, 5.0, (4096, 3)).astype(np.float32)  # some clipped
    lo = np.asarray([-2.0, -1.0, 0.5], np.float32)
    hi = np.asarray([4.0, 3.0, 0.5], np.float32)  # a flat axis: ext 1e-9
    ref = np.asarray(j_morton.morton3d(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    ours = morton.morton3d(_t(pts), _t(lo), _t(hi))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    assert len(np.unique(ref)) > 1000


def test_sort_rays_matches_jax():
    rs = np.random.RandomState(2)
    n = 2048
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    o[::7] = o[3]  # equal keys: the stable order must match
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::5, 1] = 0.0
    active = rs.rand(n) > 0.3
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    ref = j_compaction.sort_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
                                 jnp.asarray(lo), jnp.asarray(hi))
    ours = compaction.sort_rays(_t(o), _t(d), _t(active), _t(lo), _t(hi))
    np.testing.assert_array_equal(ours.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(ours.inverse.numpy(), np.asarray(ref.inverse))
    assert int(ours.num_alive) == int(ref.num_alive)
    back = compaction.permute(ours.inverse, compaction.permute(ours.order, _t(o)))
    assert torch.equal(back, _t(o))


# --- K4 and the candidate lists ---------------------------------------------------


@pytest.mark.parametrize("name,k,chunk", [
    ("sponza", 4, None), ("sponza", 16, None), ("sponza", 4, 1),
    ("rooms", 4, None), ("rooms", 16, None), ("rooms", 4, 8), ("rooms", 16, 8),
])
def test_k4_plain_matches_cull_topk_interpret(geoms, name, k, chunk):
    jdev, tdev = geoms[name]
    jg, tg = jdev.geometry, tdev.geometry
    o, d, tm = _batch(tdev, 1024, 3)
    pk_ref, cnt_ref = j_cull_topk(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jg.cluster_min,
        jg.cluster_max, k=k, interpret=True, chunk=chunk,
    )
    pk, cnt = cull.cull_topk(_t(o), _t(d), _t(tm), tg.cluster_min, tg.cluster_max, k=k)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(pk_ref))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_ref))
    assert int((cnt > 0).sum()) > 500
    if name == "rooms" and k == 4:
        assert int((cnt > k).sum()) > 50  # lists really truncate


def test_k4_keys_at_zero_directions_and_signed_zero():
    """A zero direction component (the 1e-12 guard), an origin on a box
    face (an entry distance of -0 keys as +0) and a NaN direction (no
    hit), against the JAX kernel."""
    cmin = np.asarray([[0.0, -1.0, -1.0], [2.0, -1.0, -1.0]], np.float32)
    cmax = np.asarray([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]], np.float32)
    o = np.asarray([[-1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.5, 0.0],
                    [-1.0, 0.0, 0.0]], np.float32)
    d = np.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                    [np.nan, 0.0, 1.0]], np.float32)
    tm = np.full(4, 3.0e38, np.float32)
    ref = j_cull_topk(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      jnp.asarray(cmin), jnp.asarray(cmax), k=2, interpret=True)
    ours = cull.cull_topk(_t(o), _t(d), _t(tm), _t(cmin), _t(cmax), k=2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[0][2, 0]) == 0  # origin on the face: tn = -0 -> key 0
    assert int(ours[1][3]) == 0


@pytest.mark.parametrize("name,sc", [("sponza", 1), ("rooms", 8)])
def test_cull_candidates_superchunk_matches_jax(geoms, name, sc):
    jdev, tdev = geoms[name]
    jg, tg = jdev.geometry, tdev.geometry
    o, d, tm = _batch(tdev, 1024, 4)
    ref = j_traverse.cull_candidates(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jg.cluster_min,
        jg.cluster_max, 8, interpret=True, kernel=True, superchunk=sc,
    )
    ours = k5.cull_candidates(_t(o), _t(d), _t(tm), tg.cluster_min,
                              tg.cluster_max, 8, superchunk=sc)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    single = k5.cull_candidates(_t(o), _t(d), _t(tm), tg.cluster_min,
                                tg.cluster_max, 8)
    for a, b in zip(ours, single):
        assert torch.equal(a, b)  # the merge is exact


@pytest.mark.parametrize("name", ["sponza", "rooms"])
def test_cull_ordered_matches_jax(geoms, name):
    jdev, tdev = geoms[name]
    jg, tg = jdev.geometry, tdev.geometry
    o, d, tm = _batch(tdev, 1024, 5)
    ref = j_traverse.cull_ordered(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                  jg.cluster_min, jg.cluster_max, 8)
    ours = k5.cull_ordered(_t(o), _t(d), _t(tm), tg.cluster_min, tg.cluster_max, 8)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- K5, K6 and the engines --------------------------------------------------------


@pytest.mark.parametrize("name", ["sponza", "rooms"])
@pytest.mark.parametrize("k", [4, 12])
@pytest.mark.parametrize("bounded", [False, True])
def test_intersect_traversed_matches_bruteforce(geoms, name, k, bounded):
    _, tdev = geoms[name]
    o, d, tm = _batch(tdev, 2048, 6)
    if not bounded:
        tm = np.full_like(tm, 3.0e38)
    bf = _brute(tdev, o, d, tm)
    ours = k5.intersect_traversed(_t(o), _t(d), tdev.geometry, t_max=_t(tm),
                                  k_per_ray=k)
    _assert_hits(ours, bf, f"{name} K={k}")
    assert int((bf.tri >= 0).sum()) > 1000


@pytest.mark.parametrize("k", [4, 12])
def test_intersect_traversed_matches_jax_interpret(geoms, k):
    jdev, tdev = geoms["rooms"]
    o, d, tm = _batch(tdev, 2048, 7)
    ref = j_traverse.intersect_traversed(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                         t_max=jnp.asarray(tm), k_per_ray=k,
                                         interpret=True)
    ours = k5.intersect_traversed(_t(o), _t(d), tdev.geometry, t_max=_t(tm),
                                  k_per_ray=k)
    _assert_hits(ours, ref, f"K={k}")


def test_k5_unresolved_rays_take_the_fallback(geoms):
    """K5 alone at K = 4: the rays it leaves unresolved are exactly the
    truncated ones whose hit lies beyond the 4th entry distance, it
    visits no more clusters than it has candidates, and the exact
    engine repairs every ray whose K5 hit differs from brute force."""
    _, tdev = geoms["rooms"]
    g = tdev.geometry
    o, d, tm = (_t(x) for x in _batch(tdev, 2048, 8))
    ids, tns, ovf = k5.cull_candidates(o, d, tm, g.cluster_min, g.cluster_max, 4)
    hit, unres, runs = k5.traverse_candidates(o, d, tm, ids, tns, ovf, g.cluster_min,
                                              g.cluster_max, g.tri_packed)
    assert torch.equal(unres.bool(), ovf & (hit.t > tns[:, 3]))
    assert bool((runs <= (ids != k5.BIG_CLUSTER).sum(1)).all())
    bf = intersect_bruteforce(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm, chunk=512)
    wrong = hit.tri != bf.tri
    assert int(wrong.sum()) > 0 and bool(unres[wrong].all())
    assert int(unres.sum()) < int(ovf.sum())  # most truncated rays resolve
    k5.stats.reset()
    k5.stats.enabled = True
    try:
        exact = k5.intersect_traversed(o, d, g, t_max=tm, k_per_ray=4)
    finally:
        k5.stats.enabled = False
    assert torch.equal(exact.tri, bf.tri)
    live = int((tm > 0).sum())
    assert k5.stats.summary() == dict(
        queries=1, live_rays=live,
        unresolved_share=int(unres.sum()) / live,
        visits_per_ray=int(runs.sum()) / live,
    )


def test_k5_keeps_the_lowest_slot_at_equal_t():
    """Two clusters holding the same triangle, listed in descending id
    order: the walk keeps the lexicographic (t, slot) minimum."""
    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 5.0e3  # far v0 for the unused slots (zero edges)
    tri = torch.tensor([[0.0, -1.0, -1.0], [0.0, 3.0, 0.0], [0.0, 0.0, 3.0]])
    for c, s in ((0, 7), (1, 3)):
        for q in range(9):
            blk[c, q, s] = tri[q // 3, q % 3]
    o = torch.tensor([[-2.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    tm = torch.tensor([3.0e38])
    ids = torch.tensor([[1, 0]], dtype=torch.int32)
    tns = torch.tensor([[1.5, 1.5]])
    # the admissibility rule's boxes: the triangle's, and row 9
    cmin = torch.tensor([[0.0, -1.0, -1.0]] * 2)
    cmax = torch.tensor([[0.0, 2.0, 2.0]] * 2)
    hit, unres, runs = k5.traverse_candidates(o, d, tm, ids, tns, torch.tensor([False]),
                                              cmin, cmax, with_pretest_row(blk))
    assert int(hit.tri[0]) == 7 and float(hit.t[0]) == pytest.approx(2.0)
    assert int(runs[0]) == 2 and int(unres[0]) == 0


def test_fallback_keeps_the_lowest_slot_at_equal_t():
    """K = 1: the ray's only candidate (cluster 1, entered at 2) holds a
    triangle at t = 5 in slot 131; cluster 0, entered at 5, holds the
    same triangle in slot 7. The ray is unresolved, and K6 must find
    slot 7 at the same t, as brute force does."""
    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 5.0e3
    for c, s, tri in ((0, 7, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 3, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 9, [[-3, 10, 0], [0, 1, 0], [0, 0, 1]])):
        blk[c, 0:9, s] = torch.tensor(tri, dtype=torch.float32).reshape(9)
    v0, e1, e2 = k6._slot_table(blk)
    g = types.SimpleNamespace(
        cluster_min=torch.tensor([[0.0, -1.0, -1.0], [-3.0, -1.0, -1.0]]),
        cluster_max=torch.tensor([[0.0, 2.0, 2.0], [0.0, 11.0, 2.0]]),
        tri_packed=blk,
    )
    o = torch.tensor([[-5.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    ids, tns, ovf = k5.cull_candidates(o, d, torch.tensor([3.0e38]),
                                       g.cluster_min, g.cluster_max, 1)
    assert int(ids[0, 0]) == 1 and bool(ovf[0])
    bf = intersect_bruteforce(o, d, v0, e1, e2)
    hit = k5.intersect_traversed(o, d, g, k_per_ray=1)
    assert int(bf.tri[0]) == 7 and int(hit.tri[0]) == 7
    assert torch.equal(hit.t, bf.t)


def test_traversal_exact_through_superchunk_merge(geoms):
    _, tdev = geoms["rooms"]
    o, d, tm = _batch(tdev, 1024, 10)
    bf = _brute(tdev, o, d, tm)
    ours = k5.intersect_traversed(_t(o), _t(d), tdev.geometry, t_max=_t(tm),
                                  k_per_ray=4, superchunk=8)
    _assert_hits(ours, bf)


@pytest.mark.parametrize("name", ["sponza", "rooms"])
def test_intersect_clustered_matches_bruteforce_and_jax(geoms, name):
    jdev, tdev = geoms[name]
    o, d, tm = _batch(tdev, 2048, 11)
    bf = _brute(tdev, o, d, tm)
    ours = k6.intersect_clustered(_t(o), _t(d), tdev.geometry, t_max=_t(tm))
    _assert_hits(ours, bf)
    ref = j_cluster.intersect_clustered(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                        t_max=jnp.asarray(tm), interpret=True)
    _assert_hits(ours, ref)


def test_k6_resolved_rays_keep_minus_inf(geoms):
    """t_max = -inf: no hit, and t stays -inf (not 0); t_max = 0 from an
    origin inside a box: no hit either."""
    _, tdev = geoms["rooms"]
    o, d, _ = _batch(tdev, 256, 12)
    tm = torch.full((256,), -torch.inf)
    tm[::2] = 0.0
    hit = k6.intersect_clustered(_t(o), _t(d), tdev.geometry, t_max=tm)
    assert bool((hit.tri == -1).all()) and torch.equal(hit.t, tm)


# --- the integrator -----------------------------------------------------------------


_RENDER = dict(width=16, height=16, max_depth=2, tile_size=256, traverse_k=2)


@pytest.fixture(scope="module")
def jax_frames(geoms):
    """engine -> hala_tpu's frame through its Pallas kernels in
    interpret mode (sorted queries; the engines are exact, so the frame
    does not depend on the sort), made once per engine."""
    from hala_tpu.models import integrator as jint

    jdev, _ = geoms["sponza"]
    cache = {}

    def frame(engine):
        if engine not in cache:
            s = jint.RenderSettings(intersector=engine, interpret_pallas=True,
                                    sort_rays=True, **_RENDER)
            film, _ = jint.render_frame(jdev, None, jint.Uniforms.default(),
                                        jint.Film.create(16, 16), 0, s)
            cache[engine] = np.asarray(film.accum)
        return cache[engine]

    return frame


@pytest.mark.parametrize("engine", ["traverse", "cluster"])
@pytest.mark.parametrize("sort", [True, False])
def test_render_side_by_side_with_jax(geoms, jax_frames, engine, sort):
    """16x16, depth 2, one frame through each engine, sorted and not,
    against hala_tpu's frame. traverse_k = 2 truncates lists on this
    scene, so the K6 fallback runs too."""
    _, tdev = geoms["sponza"]
    film = tint.Film.create(16, 16, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 0,
                      tint.RenderSettings(intersector=engine, sort_rays=sort,
                                          **_RENDER))
    np.testing.assert_allclose(film.accum.numpy(), jax_frames(engine), atol=1e-3)
    assert float(film.accum[..., :3].mean()) > 0.1


def test_traverse_render_equals_the_brute_force_render(geoms):
    """The traverse engine answers shadow rays in the batched closest
    hit, as the brute-force kernel's backend does: the same estimator
    with exact visibility, so the frames agree. (The matrix backend
    splits its shadow rays into an any-hit query whose range the
    reference shortens by a second factor 1 - 1e-4, so its frame is a
    different estimator.)"""
    _, tdev = geoms["rooms"]
    films = []
    for sel in ("traverse", "pallas"):
        film = tint.Film.create(16, 16, "cpu")
        tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 0,
                          tint.RenderSettings(width=16, height=16, max_depth=3,
                                              intersector=sel, traverse_k=4))
        films.append(film.accum)
    np.testing.assert_allclose(films[0].numpy(), films[1].numpy(), atol=1e-6)


def test_cluster_render_equals_the_brute_force_render(geoms):
    """The cluster engine, like the traverse engine, is the brute-force
    backend's estimator with exact visibility."""
    _, tdev = geoms["rooms"]
    films = []
    for sel in ("cluster", "pallas"):
        film = tint.Film.create(16, 16, "cpu")
        tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 0,
                          tint.RenderSettings(width=16, height=16, max_depth=3,
                                              intersector=sel))
        films.append(film.accum)
    np.testing.assert_allclose(films[0].numpy(), films[1].numpy(), atol=1e-6)


def test_row_band_equals_the_rows_of_the_full_frame(geoms):
    """A band rendered with row_offset/full_height is the same rows of
    the full frame (camera and RNG keyed on global pixel ids), so a
    crop can stand in for the frame when comparing engines."""
    _, tdev = geoms["rooms"]
    full = tint.Film.create(16, 16, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), full, 0,
                      tint.RenderSettings(width=16, height=16, max_depth=2,
                                          intersector="traverse", traverse_k=4))
    band = tint.Film.create(16, 4, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), band, 0,
                      tint.RenderSettings(width=16, height=4, max_depth=2,
                                          intersector="traverse", traverse_k=4),
                      row_offset=8, full_height=16)
    assert torch.equal(band.accum, full.accum[8:12])


def test_auto_routes_past_the_key_width():
    """"auto" sends scenes above MATRIX_MAX_CLUSTERS clusters to the
    candidate traversal instead of raising."""
    def stub(c):
        g = types.SimpleNamespace(num_triangles=c * 128, prefix_layout=False,
                                  tri_packed=torch.zeros((c, 1, 1)))
        return types.SimpleNamespace(geometry=g)

    s = tint.RenderSettings(width=8, height=8)
    assert k5.MATRIX_MAX_CLUSTERS == 8191
    assert tint._backend(s, stub(8191)) == "matrix"
    assert tint._backend(s, stub(8192)) == "traverse"
    for sel in ("traverse", "cluster"):
        assert tint._backend(tint.RenderSettings(8, 8, intersector=sel), stub(4)) == sel
