"""The grouped and wavefront engines of the port against the JAX package.

K8 (`ops/traverse.py` `grouped_walk`, csrc/grouped_walk.cu) and K7
(`ops/wavefront.py` `wavefront_walk`, csrc/wavefront_walk.cu), the glue
around them and the coherence-sorted `matrix_query`. On the CPU each
wrapper runs its plain PyTorch version; hala_tpu's Pallas kernels run
in interpret mode, as tests/test_wavefront.py and tests/test_traverse.py
run them.

- Array-equal to the JAX package: the integer glue (`_group_lists`, the
  want mask, `own_last`, the signature key, the fallback bound,
  `query_coherence_key`, `_group_candidates`, the sorted order).
- The engines' hits after `canonical_hit`, by the statement of
  tests/test_wavefront.py: the hit mask equal; where the triangle
  differs |dt| < 1e-4 (a near-tie: the factored Moller-Trumbore is
  summed in another order than XLA's dot_general, so winners may flip
  between near-equal candidates, and nothing else may); where it agrees
  t at rtol 1e-6 and u, v at atol 5e-6. That file holds u, v to 1e-6
  inside one framework; across the two, `canonical_hit` itself differs
  by up to 1.3e-6 in v on the same (ray, triangle), because XLA's CPU
  backend contracts multiply-adds (measured 1.55e-6 at most over these
  batches). So where the triangle agrees the port's hit must also equal
  the port's own `canonical_hit` of that triangle bit for bit.
  Any-hit: the boolean equal.
- Small renders within relative RMSE 2e-3 of hala_tpu's frame at the
  same settings and of the port's own "matrix" frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.models import integrator as jint
from hala_tpu.ops import traverse as j_traverse
from hala_tpu.ops import wavefront as j_wavefront
from hala_tpu.ops.intersect import intersect_bruteforce as j_bruteforce
from hala_tpu.ops.intersect import occluded_bruteforce as j_occluded
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import sponza_like
from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.ops import compaction, cuda_lib, cull
from hala_tpu_torch.ops import traverse as k8
from hala_tpu_torch.ops import wavefront as k7
from hala_tpu_torch.ops.intersect import Hit, canonical_hit
from hala_tpu_torch.scene.gpu.scene import from_numpy

INF_KEY = cull.INF_KEY
ID_MASK = cull._ID_MASK


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
    """name -> (hala_tpu device scene, hala_tpu_torch device scene):
    the two geometries of tests/test_wavefront.py."""
    out = {
        "sponza": _upload(rooms=(2, 2), columns_per_room=4, boxes_per_room=2),
        "sah": _upload(rooms=(4, 4), columns_per_room=4, boxes_per_room=16),
    }
    assert not out["sah"][1].geometry.prefix_layout
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(n, seed, center=(4.0, 1.5, 4.0)):
    rs = np.random.RandomState(seed)
    o = np.tile(np.asarray(center, np.float32), (n, 1))
    o += rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _canon_equal(hit, ref, rays=None):
    """`rays` = (o, d, geometry) of a canonical engine: its t, u, v are
    then also held bit for bit to the port's canonical_hit of the
    reference's triangle, wherever the two agree on it."""
    th, tb = hit.t.numpy(), np.asarray(ref.t)
    trih, trib = hit.tri.numpy(), np.asarray(ref.tri)
    np.testing.assert_array_equal(trih >= 0, trib >= 0)
    same = trih == trib
    assert np.abs(th - tb)[~same].max(initial=0.0) < 1e-4
    m = (trib >= 0) & same
    np.testing.assert_allclose(th[m], tb[m], rtol=1e-6)
    np.testing.assert_allclose(hit.u.numpy()[m], np.asarray(ref.u)[m], atol=5e-6)
    np.testing.assert_allclose(hit.v.numpy()[m], np.asarray(ref.v)[m], atol=5e-6)
    if rays is not None:
        o, d, g = rays
        own = canonical_hit(_t(o), _t(d), g.tri_v0, g.tri_e1, g.tri_e2,
                            Hit(hit.t, _t(trib), hit.u, hit.v))
        for a, b in zip(hit, own):
            assert torch.equal(a[_t(m)], b[_t(m)])
    return int((~same).sum())


_CENTER = {"sponza": (4.0, 1.5, 4.0), "sah": (8.0, 1.5, 8.0)}


def _packed_lists(geoms, name, n, k, seed):
    """A signature-sorted batch's packed keys, as both packages see them."""
    jdev, tdev = geoms[name]
    o, d = _rays(n, seed, _CENTER[name])
    tm = np.full(n, 3.0e38, np.float32)
    tm[::9] = 1.5
    tm[::17] = 0.0
    tg = tdev.geometry
    pk, cnt = cull.cull_topk(_t(o), _t(d), _t(tm), tg.cluster_min, tg.cluster_max, k=k)
    order = torch.argsort(k7.signature_key(pk), stable=True)
    return o, d, tm, pk, cnt, order


# --- the integer glue ---------------------------------------------------------


@pytest.mark.parametrize("name,k,m", [("sponza", 3, 8), ("sah", 8, 8),
                                      ("sah", 16, 32), ("sah", 2, 16)])
def test_group_lists_match_jax(geoms, name, k, m):
    _, _, _, pk, _, order = _packed_lists(geoms, name, 1024, k, 1)
    pk_s = pk[order]
    g_total = 1024 // 128
    ref_tnb, ref_gb = j_wavefront._group_lists(jnp.asarray(pk_s.numpy()), g_total, k, m)
    tnb, gb = k7._group_lists(pk_s, g_total, k, m)
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(ref_tnb))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(ref_gb))
    if name == "sah" and m == 8:
        assert int((gb != INF_KEY).sum()) > 0  # the cap really drops entries


@pytest.mark.parametrize("name,k,m", [("sah", 3, 8), ("sah", 8, 16)])
def test_want_mask_own_last_and_bounds_match_jax(geoms, name, k, m):
    """The expressions of hala_tpu/ops/wavefront.py:417-462 on the same
    sorted keys."""
    _, _, tm, pk, cnt, order = _packed_lists(geoms, name, 1024, k, 2)
    pk_s, cnt_s = pk[order], cnt[order]
    g_total = 1024 // 128
    tnb, gb = k7._group_lists(pk_s, g_total, k, m)
    jpk, jtnb, jgb = (jnp.asarray(x.numpy()) for x in (pk_s, tnb, gb))
    eid = jnp.where(jtnb != INF_KEY, jtnb & ID_MASK, -2)
    cand = jnp.where(jpk != INF_KEY, jpk & ID_MASK, -1).reshape(g_total, 128, k)
    ref_want = jnp.any(cand[:, :, :, None] == eid[:, None, None, :], axis=2)
    ref_last = jnp.max(jnp.where(jpk != INF_KEY, jpk, -1), axis=1).astype(jnp.int32)
    want = k7.want_mask(tnb, pk_s, k)
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref_want))
    np.testing.assert_array_equal(k7.own_last_key(pk_s).numpy(), np.asarray(ref_last))
    bits = k7.pack_want(want).view(g_total, 128)
    for j in range(m):
        assert torch.equal(((bits >> j) & 1) != 0, want[:, :, j])
    assert int(want.sum()) > 0 and not bool(want.all())
    # the per-ray fallback bound and the need lanes for some t_fin
    rs = np.random.RandomState(5)
    t_fin = rs.uniform(0.0, 6.0, 1024).astype(np.float32)
    jcnt = jnp.asarray(cnt_s.numpy())
    ray_bound = jnp.where(jcnt > k, jpk[:, k - 1], jnp.int32(INF_KEY))
    own_dropped = jnp.min(
        jnp.where(jpk >= jnp.repeat(jgb, 128)[:, None], jpk, jnp.int32(INF_KEY)), axis=1)
    ref_bound = jnp.minimum(ray_bound, own_dropped)
    ref_need = jax.lax.bitcast_convert_type(
        jnp.maximum(jnp.asarray(t_fin), 0.0), jnp.int32) > ref_bound
    bound = k7.fallback_bound(pk_s, cnt_s, gb, k)
    np.testing.assert_array_equal(bound.numpy(), np.asarray(ref_bound))
    need = torch.clamp(_t(t_fin), min=0.0).view(torch.int32) > bound
    np.testing.assert_array_equal(need.numpy(), np.asarray(ref_need))
    assert 0 < int(need.sum()) < 1024


def test_signature_key_and_order_match_jax(geoms):
    """The signature key (wavefront.py:381-386) and the total order of
    lax.sort((skey, lane), num_keys=2)."""
    _, _, _, pk, _, order = _packed_lists(geoms, "sah", 1024, 8, 3)
    jpk = jnp.asarray(pk.numpy())
    id0, id1, id2 = (jpk[:, q] & ID_MASK for q in range(3))
    skey = (id0 << 18) | (id1 << 5) | (id2 >> 8)
    _, lane_s = jax.lax.sort((skey, jnp.arange(1024, dtype=jnp.int32)), num_keys=2)
    np.testing.assert_array_equal(k7.signature_key(pk).numpy(), np.asarray(skey))
    np.testing.assert_array_equal(order.numpy(), np.asarray(lane_s))
    assert len(np.unique(np.asarray(skey))) < 1024  # ties: the lane breaks them


def test_coherence_key_and_sorted_order_match_jax(geoms):
    jdev, tdev = geoms["sah"]
    jg, tg = jdev.geometry, tdev.geometry
    o, d = _rays(2048, 4, (8.0, 1.5, 8.0))
    o[::7] = o[3]  # equal keys: the stable order must match
    tm = np.full(2048, 3.0e38, np.float32)
    tm[::5] = 0.0
    ref = j_traverse._coherence_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                    jg.cluster_min, jg.cluster_max)
    key = compaction.query_coherence_key(_t(o), _t(d), _t(tm), tg.cluster_min, tg.cluster_max)
    np.testing.assert_array_equal(key.numpy(), np.asarray(ref).astype(np.int64))
    _, idx_s = jax.lax.sort((ref, jnp.arange(2048, dtype=jnp.int32)), num_keys=1)
    np.testing.assert_array_equal(torch.argsort(key, stable=True).numpy(),
                                  np.asarray(idx_s))


@pytest.mark.parametrize("name,k", [("sponza", 2), ("sah", 4), ("sah", 32)])
def test_group_candidates_match_jax(geoms, name, k):
    jdev, tdev = geoms[name]
    jg, tg = jdev.geometry, tdev.geometry
    k = min(k, tg.cluster_min.shape[0])
    o, d = _rays(1024, 6, _CENTER[name])
    tm = np.full(1024, 3.0e38, np.float32)
    tm[1::4] = 2.0
    tm[::13] = 0.0
    ref = j_traverse._group_candidates(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                       jg.cluster_min, jg.cluster_max, k)
    ours = k8._group_candidates(_t(o), _t(d), _t(tm), tg.cluster_min, tg.cluster_max, k)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # rays start inside clusters: equal distances of 0 decide the order
    assert int((ours[1][:, :2] == 0).all(dim=1).sum()) > 0


# --- K8: the grouped engine ---------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(k_cap=2)], ids=["default", "k_cap=2"])
def test_intersect_grouped_matches_jax(geoms, kw):
    jdev, tdev = geoms["sponza"]
    o, d = _rays(1024, 7)
    ref = j_traverse.intersect_grouped(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                       interpret=True, **kw)
    ours = k8.intersect_grouped(_t(o), _t(d), tdev.geometry, **kw)
    _canon_equal(ours, ref, (o, d, tdev.geometry))
    bf = j_bruteforce(jnp.asarray(o), jnp.asarray(d), jdev.geometry.tri_v0,
                      jdev.geometry.tri_e1, jdev.geometry.tri_e2, chunk=128)
    _canon_equal(ours, bf)
    if kw:
        tg = tdev.geometry
        _, _, usz = k8._group_candidates(_t(o), _t(d), torch.full((1024,), 3.0e38),
                                         tg.cluster_min, tg.cluster_max, 2)
        assert int((usz > 2).sum()) > 0  # lists really truncate


def test_intersect_grouped_any_hit_matches_jax_and_bruteforce(geoms):
    jdev, tdev = geoms["sponza"]
    jg = jdev.geometry
    o, d = _rays(512, 8)
    tf = np.full(512, 3.0, np.float32)
    ref = j_traverse.intersect_grouped(jnp.asarray(o), jnp.asarray(d), jg,
                                       t_max=jnp.asarray(tf), interpret=True, any_hit=True)
    for kw in (dict(), dict(k_cap=2)):
        ours = k8.intersect_grouped(_t(o), _t(d), tdev.geometry, t_max=_t(tf),
                                    any_hit=True, **kw)
        np.testing.assert_array_equal(ours.tri.numpy() >= 0, np.asarray(ref.tri) >= 0)
    bf = j_occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tf) / (1.0 - 1e-4),
                    jg.tri_v0, jg.tri_e1, jg.tri_e2)
    occ = k8.occluded_grouped(_t(o), _t(d), _t(tf), tdev.geometry)
    assert int((occ.numpy() != np.asarray(bf)).sum()) <= 1  # t_far rescaled: ulp
    assert 50 < int(occ.sum()) < 500


def test_intersect_grouped_ragged_n_and_dead_rays(geoms):
    jdev, tdev = geoms["sponza"]
    o, d = _rays(300, 9)
    tm = np.where(np.arange(300) % 3 == 0, 0.0, 3.0e38).astype(np.float32)
    ref = j_traverse.intersect_grouped(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                       t_max=jnp.asarray(tm), interpret=True)
    ours = k8.intersect_grouped(_t(o), _t(d), tdev.geometry, t_max=_t(tm))
    _canon_equal(ours, ref, (o, d, tdev.geometry))
    assert bool((ours.tri[::3] == -1).all()) and ours.t.shape == (300,)


def _two_plates():
    """Cluster 0: a plate at x = 1.5 (box x in [1, 2]); cluster 1: a
    plate at x = 5.5 (box x in [5, 6]); boxes span y, z in [-2, 2], the
    plates the half of it with y + z <= 2."""
    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 5.0e3  # far v0 for the unused slots (zero edges)
    for c, x in ((0, 1.5), (1, 5.5)):
        blk[c, 0:9, 3] = torch.tensor([x, -2.0, -2.0, 0.0, 6.0, 0.0, 0.0, 0.0, 6.0])
    cmin = torch.tensor([[1.0, -2.0, -2.0], [5.0, -2.0, -2.0]])
    cmax = torch.tensor([[2.0, 2.0, 2.0], [6.0, 2.0, 2.0]])
    return blk, cmin, cmax


def test_grouped_walk_exits_once_every_lane_is_inside():
    """Two groups along +x: in the first every ray hits the near plate,
    so the far cluster (entered at 5 > t = 1.5) is never walked; in the
    second one ray passes beside the near plate, so the group walks on
    and that ray finds the far plate... which it passes beside too."""
    blk, cmin, cmax = _two_plates()
    o = torch.zeros((256, 3))
    o[:, 1:] = torch.linspace(-0.5, 0.5, 256)[:, None]
    o[200, 1] = 1.9  # inside the boxes, beyond the hypotenuse of both plates
    o[200, 2] = 1.9
    d = torch.tensor([1.0, 0.0, 0.0]).repeat(256, 1)
    tm = torch.full((256,), 3.0e38)
    ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, 2)
    assert ids.tolist() == [[0, 1], [0, 1]] and usz.tolist() == [2, 2]
    assert tns.tolist() == [[1.0, 5.0], [1.0, 5.0]]
    t, tri, u, v, walked = k8.grouped_walk(o, d, tm, usz, ids, tns.view(torch.int32),
                                           blk, cmin, cmax)
    assert walked.tolist() == [1, 2]
    hit = torch.ones(256, dtype=torch.bool)
    hit[200] = False
    assert bool((tri[hit] == 3).all()) and bool((t[hit] == 1.5).all())
    assert int(tri[200]) == -1 and float(t[200]) == pytest.approx(3.0e38)
    # any-hit: t 0 and the cluster's first slot where blocked
    t, tri, _, _, walked = k8.grouped_walk(o, d, tm, usz, ids, tns.view(torch.int32),
                                           blk, cmin, cmax, any_hit=True)
    assert bool((tri[hit] == 0).all()) and bool((t[hit] == 0).all())
    assert walked.tolist() == [1, 2]


def test_wavefront_walk_exit_bound_and_want_mask():
    """K7's plain version on the two plates. A ray that misses both
    (t stays 3e38) does not keep the walk alive past its own last
    candidate; an entry nobody who can still improve wants is walked
    but not tested."""
    blk, cmin, cmax = _two_plates()
    o = torch.zeros((128, 3))
    o[:, 1:] = torch.linspace(-0.5, 0.5, 128)[:, None]
    o[7, 1] = o[7, 2] = 1.9  # this ray passes beside both plates
    d = torch.tensor([1.0, 0.0, 0.0]).repeat(128, 1)
    tm = torch.full((128,), 3.0e38)
    pk, cnt = cull.cull_topk(o, d, tm, cmin, cmax, k=2)
    tnb, gb = k7._group_lists(pk, 1, 2, 8)
    assert (tnb[0, :2] & ID_MASK).tolist() == [0, 1] and int(tnb[0, 2]) == INF_KEY
    want = k7.pack_want(k7.want_mask(tnb, pk, 2))
    assert bool((want == 3).all())
    t, tri, _, _, stats = k7.wavefront_walk(o, d, tm, tnb, want, k7.own_last_key(pk),
                                            blk, cmin, cmax)
    # ray 7 still has t = 3e38 beyond entry 1 and wants it: both tested
    assert stats.tolist() == [[2, 2]] and int(tri[7]) == -1
    assert int((tri == 3).sum()) == 127
    # ray 7 owning only the near cluster: entry 1 lies past its own last
    # key, so the walk ends after one entry
    pk7 = pk.clone()
    pk7[7, 1] = INF_KEY
    want7 = k7.pack_want(k7.want_mask(tnb, pk7, 2))
    assert int(want7[7]) == 1
    _, _, _, _, stats = k7.wavefront_walk(o, d, tm, tnb, want7, k7.own_last_key(pk7),
                                          blk, cmin, cmax)
    assert stats.tolist() == [[1, 1]]
    # nobody wants entry 0: it is walked, not tested, and entry 1 is hit
    none = torch.full_like(want, 2)
    t, tri, _, _, stats = k7.wavefront_walk(o, d, tm, tnb, none, k7.own_last_key(pk),
                                            blk, cmin, cmax)
    assert stats.tolist() == [[2, 1]] and int((tri == 128 + 3).sum()) == 127


def test_walk_stats_count_the_fallback_share(geoms):
    _, tdev = geoms["sah"]
    g = tdev.geometry
    o, d = (_t(x) for x in _rays(1024, 10, _CENTER["sah"]))
    k8.walk_stats.reset()
    k8.walk_stats.enabled = True
    try:
        k8.intersect_grouped(o, d, g, k_cap=2)
        s_grouped = k8.walk_stats.summary()
        k8.walk_stats.reset()
        k7.intersect_wavefront(o, d, g, k_per_ray=3, m_group=8)
        s_wave = k8.walk_stats.summary()
    finally:
        k8.walk_stats.enabled = False
        k8.walk_stats.reset()
    assert s_grouped["queries"] == 1 and s_grouped["groups"] == 8
    assert 0 < s_grouped["need_share"] <= 1 and s_grouped["walked_per_group"] <= 2
    assert s_wave["groups"] == 8 and 0 < s_wave["need_share"] <= 1
    assert s_wave["tested_per_group"] <= s_wave["walked_per_group"] <= 8


# --- K7: the wavefront engine -------------------------------------------------


@pytest.mark.parametrize(
    "kw", [dict(), dict(k_per_ray=2), dict(k_per_ray=3, m_group=8)],
    ids=["default", "ray-overflow", "tiny-caps"],
)
def test_intersect_wavefront_matches_jax(geoms, kw):
    jdev, tdev = geoms["sponza"]
    o, d = _rays(1024, 11)
    ref = j_wavefront.intersect_wavefront(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                          interpret=True, **kw)
    ours = k7.intersect_wavefront(_t(o), _t(d), tdev.geometry, **kw)
    _canon_equal(ours, ref, (o, d, tdev.geometry))
    bf = j_bruteforce(jnp.asarray(o), jnp.asarray(d), jdev.geometry.tri_v0,
                      jdev.geometry.tri_e1, jdev.geometry.tri_e2, chunk=128)
    _canon_equal(ours, bf)


def test_intersect_wavefront_on_sah_layout(geoms):
    jdev, tdev = geoms["sah"]
    o, d = _rays(1024, 12, (8.0, 1.5, 8.0))
    ref = j_wavefront.intersect_wavefront(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                          interpret=True, k_per_ray=8, m_group=16)
    ours = k7.intersect_wavefront(_t(o), _t(d), tdev.geometry, k_per_ray=8, m_group=16)
    _canon_equal(ours, ref, (o, d, tdev.geometry))
    w = k7.wavefront_lists(_t(o), _t(d), torch.full((1024,), 3.0e38), tdev.geometry, 8, 16)
    lens = (w.tnb != INF_KEY).sum(dim=1)
    _, ref_lens = j_wavefront.intersect_wavefront(
        jnp.asarray(o), jnp.asarray(d), jdev.geometry, interpret=True, k_per_ray=8,
        m_group=16, with_stats=True)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))


@pytest.mark.parametrize("kw", [dict(), dict(k_per_ray=2, m_group=8)],
                         ids=["any-hit", "any-hit-truncated"])
def test_intersect_wavefront_any_hit(geoms, kw):
    jdev, tdev = geoms["sponza"]
    jg = jdev.geometry
    o, d = _rays(512, 13)
    tf = np.full(512, 3.0, np.float32)
    bf = j_occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tf), jg.tri_v0,
                    jg.tri_e1, jg.tri_e2)
    ref = j_wavefront.intersect_wavefront(jnp.asarray(o), jnp.asarray(d), jg,
                                          t_max=jnp.asarray(tf), interpret=True,
                                          any_hit=True, **kw)
    ours = k7.intersect_wavefront(_t(o), _t(d), tdev.geometry, t_max=_t(tf),
                                  any_hit=True, **kw)
    np.testing.assert_array_equal(ours.tri.numpy() >= 0, np.asarray(ref.tri) >= 0)
    np.testing.assert_array_equal(ours.tri.numpy() >= 0, np.asarray(bf))


def test_intersect_wavefront_ragged_n_and_dead_rays(geoms):
    jdev, tdev = geoms["sponza"]
    o, d = _rays(300, 14)
    tm = np.where(np.arange(300) % 3 == 0, 0.0, 3.0e38).astype(np.float32)
    ref = j_wavefront.intersect_wavefront(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                          t_max=jnp.asarray(tm), interpret=True)
    ours = k7.intersect_wavefront(_t(o), _t(d), tdev.geometry, t_max=_t(tm))
    _canon_equal(ours, ref, (o, d, tdev.geometry))
    assert bool((ours.tri[::3] == -1).all()) and ours.t.shape == (300,)


def test_wavefront_rejects_caps_beyond_the_key_widths(geoms):
    """m_group is bounded by the 32 bits of the want word, k_per_ray by
    the cull's register list."""
    _, tdev = geoms["sah"]
    g = tdev.geometry
    o, d = (_t(x) for x in _rays(256, 15, (8.0, 1.5, 8.0)))
    with pytest.raises(ValueError):
        k7.intersect_wavefront(o, d, g, m_group=40)
    with pytest.raises(ValueError):
        k7.intersect_wavefront(o, d, g, k_per_ray=cull.CULL_MAX_K + 1)
    k7.intersect_wavefront(o, d, g, k_per_ray=cull.CULL_MAX_K, m_group=32)


# --- the sorted matrix_query --------------------------------------------------


@pytest.mark.parametrize("kernel", ["matrix", "grouped", "wavefront"])
def test_matrix_query_kernels_match_jax(geoms, kernel):
    jdev, tdev = geoms["sponza"]
    o, d = _rays(1024, 16)
    tm = np.full(1024, 3.0e38, np.float32)
    tm[::11] = 0.0
    ref = j_traverse.matrix_query(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                  t_max=jnp.asarray(tm), interpret=True, kernel=kernel)
    ours = k8.matrix_query(_t(o), _t(d), tdev.geometry, t_max=_t(tm), kernel=kernel)
    _canon_equal(ours, ref, None if kernel == "matrix" else (o, d, tdev.geometry))


@pytest.mark.parametrize("any_hit", [False, True])
def test_matrix_query_sort_changes_the_order_only(geoms, any_hit):
    """K2 is exact under any permutation, so the sorted query's hits
    equal the unsorted query's bit for bit."""
    jdev, tdev = geoms["sponza"]
    g = tdev.geometry
    o, d = _rays(1024, 17)
    tm = np.full(1024, 2.5 if any_hit else 3.0e38, np.float32)
    base = k8.matrix_query(_t(o), _t(d), g, t_max=_t(tm), any_hit=any_hit)
    raw = k8.intersect_matrix(_t(o), _t(d), g, t_max=_t(tm), any_hit=any_hit)
    ref = j_traverse.matrix_query(jnp.asarray(o), jnp.asarray(d), jdev.geometry,
                                  t_max=jnp.asarray(tm), interpret=True, any_hit=any_hit)
    np.testing.assert_array_equal(base.tri.numpy() >= 0, np.asarray(ref.tri) >= 0)
    for x, y in zip(base, raw):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        k8.matrix_query(_t(o), _t(d), g, kernel="hilbert")


def test_cpu_tensors_never_launch_the_walks(geoms):
    cuda_lib.reset_launches()
    _, tdev = geoms["sponza"]
    o, d = _rays(256, 18)
    k8.intersect_grouped(_t(o), _t(d), tdev.geometry, k_cap=2)
    k7.intersect_wavefront(_t(o), _t(d), tdev.geometry, k_per_ray=2)
    assert not any(cuda_lib.launches().values())


# --- the integrator -----------------------------------------------------------


_RENDER = dict(width=16, height=16, max_depth=2, tile_size=256)
_ROUTES = {
    "matrix": dict(intersector="matrix"),
    "grouped": dict(intersector="grouped"),
    "wavefront": dict(intersector="wavefront", wavefront_k=3, wavefront_m=8),
    "shadow": dict(intersector="matrix", shadow_intersector="wavefront",
                   shadow_wavefront_k=3),
    "extend": dict(intersector="matrix", shadow_intersector="wavefront",
                   extend_intersector="wavefront", extend_wavefront_k=3),
}


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.fixture(scope="module")
def port_frames(geoms):
    _, tdev = geoms["sponza"]
    cache = {}

    def frame(route):
        if route not in cache:
            film = tint.Film.create(16, 16, "cpu")
            tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 0,
                              tint.RenderSettings(**_RENDER, **_ROUTES[route]))
            cache[route] = film.accum.numpy().copy()
        return cache[route]

    return frame


@pytest.mark.parametrize("route", ["grouped", "wavefront", "shadow", "extend"])
def test_render_matches_jax_and_the_matrix_frame(geoms, port_frames, route):
    """16x16, depth 2, one frame. hala_tpu's frame goes through its
    Pallas kernels in interpret mode; the extend route exists only in
    its staged dispatcher, so that frame comes from there."""
    jdev, _ = geoms["sponza"]
    s = jint.RenderSettings(interpret_pallas=True, **_RENDER, **_ROUTES[route])
    render = jint.render_frame_staged if route == "extend" else jint.render_frame
    film, _ = render(jdev, None, jint.Uniforms.default(), jint.Film.create(16, 16), 0, s)
    ours = port_frames(route)
    assert _rel_rmse(ours, np.asarray(film.accum)) < 2e-3
    assert _rel_rmse(ours, port_frames("matrix")) < 2e-3
    assert float(ours[..., :3].mean()) > 0.1
