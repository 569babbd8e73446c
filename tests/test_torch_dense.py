"""The dense engine of the port (ops/dense.py) against the JAX package's
and against the port's exact engines.

The cases of tests/test_dense.py on its geometry (`sponza_like(rooms=
(2, 2), ...)`, the same tables in both packages through `from_numpy`),
with hala_tpu's cull in interpret mode:
- closest hits at K 8 and K 1 (every list truncates, so the K2 fallback
  decides), any hits, dead rays and a t_max: triangle ids and the
  any-hit mask equal to the JAX engine's, t at rtol 1e-6 and u, v at
  atol 5e-6 where the triangle agrees (XLA's CPU backend contracts the
  multiply-adds of `canonical_hit`, tests/test_torch_wavefront.py), and
  the port's hits equal to its own K2 (`intersect_matrix`,
  `canonical_hit` of its winner) bit for bit;
- per-ray bits independent of the batch order and of the pair chunking.
On the grazing table of chip_smoke.py (`grazing_beside_span`), where the
admissibility rule decides (ops/cluster.py), the dense hits equal the
rule's (`stream_plain`); the JAX engine has no rule and accepts what the
brute force accepts there, so the two differ exactly on pairs the rule
rejects. A 16x16 frame with `shadow_dense_k` equals the "matrix" frame
bit for bit.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops.dense import intersect_dense as j_dense
from hala_tpu.ops.dense import occluded_dense as j_occluded
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import sponza_like as jsponza
from hala_tpu_torch.models.integrator import Film, RenderSettings, Uniforms, render_frame
from hala_tpu_torch.ops import dense
from hala_tpu_torch.ops.cluster import TRI_CHUNK, admissible_limit, pretest_boxes, stream_plain
from hala_tpu_torch.ops.intersect import T_MAX, canonical_hit
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.ops.traverse import intersect_matrix
from hala_tpu_torch.scene.gpu.scene import from_numpy
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import sponza_like

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the grazing table)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geoms():
    jdev = JUp.upload(jsponza(rooms=(2, 2), columns_per_room=4, boxes_per_room=2),
                      use_ray_tracing=False)
    return jdev.geometry, from_numpy(jdev, "cpu").geometry


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    o = np.tile(np.asarray([4.0, 1.5, 4.0], np.float32), (n, 1))
    o += rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _against_jax(hit, ref):
    tri, rtri = hit.tri.numpy(), np.asarray(ref.tri)
    np.testing.assert_array_equal(tri, rtri)
    m = rtri >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(ref.t)[m], rtol=1e-6)
    np.testing.assert_allclose(hit.u.numpy()[m], np.asarray(ref.u)[m], atol=5e-6)
    np.testing.assert_allclose(hit.v.numpy()[m], np.asarray(ref.v)[m], atol=5e-6)


def _against_k2(hit, o, d, g, tm=None):
    """The dense hit is K2's winner, re-evaluated by canonical_hit."""
    ref = intersect_matrix(o, d, g, t_max=tm)
    _bits_equal(hit, canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, ref))


@pytest.mark.parametrize("k,n", [(8, 1024), (1, 512)])
def test_closest_matches_jax_and_k2(geoms, k, n):
    """K 8 tests every candidate; K 1 truncates nearly every list, so the
    K2 fallback keeps the result exact."""
    jg, g = geoms
    o, d = _rays(n, 42 + k)
    ref = j_dense(jnp.asarray(o), jnp.asarray(d), jg, k=k, interpret=True)
    hit = dense.intersect_dense(_t(o), _t(d), g, k=k)
    _against_jax(hit, ref)
    _against_k2(hit, _t(o), _t(d), g)


def test_any_hit_matches_jax_and_k2(geoms):
    jg, g = geoms
    o, d = _rays(512, 7)
    tf = np.full(512, 3.0 * (1.0 - 1e-4), np.float32)
    ref = np.asarray(j_occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tf), jg,
                                k=8, interpret=True))
    occ = dense.occluded_dense(_t(o), _t(d), _t(tf), g, k=8)
    np.testing.assert_array_equal(occ.numpy(), ref)
    k2 = intersect_matrix(_t(o), _t(d), g, t_max=_t(tf), any_hit=True).tri >= 0
    assert torch.equal(occ, k2)
    assert 0 < int(occ.sum()) < 512


def test_dead_rays_and_t_max(geoms):
    _, g = geoms
    n = 300  # not a multiple of 128
    o, d = _rays(n, 11)
    tm = torch.where(torch.arange(n) % 3 == 0, 0.0, T_MAX)
    tm[1::3] = 0.8
    hit = dense.intersect_dense(_t(o), _t(d), g, t_max=tm, k=6)
    _against_k2(hit, _t(o), _t(d), g, tm)
    assert bool((hit.tri[::3] == -1).all())


def test_batch_composition_and_chunking_bit_identity(geoms, monkeypatch):
    """Per-ray bits are a function of the ray: the same rays in another
    order, and the pairs tested 37 at a time, give the same bits."""
    _, g = geoms
    o, d = _rays(512, 13)
    base = dense.intersect_dense(_t(o), _t(d), g, k=2)
    perm = torch.from_numpy(np.random.RandomState(2).permutation(512))
    permuted = dense.intersect_dense(_t(o)[perm], _t(d)[perm], g, k=2)
    _bits_equal([x[perm] for x in base], permuted)
    monkeypatch.setattr(dense, "DENSE_CHUNK_PAIRS", 37)
    _bits_equal(base, dense.intersect_dense(_t(o), _t(d), g, k=2))


def test_fallback_off_keeps_the_candidates_hits(geoms):
    """fallback=False returns the candidates' best alone: never closer
    than the exact hit, equal to it on every ray whose list was whole."""
    _, g = geoms
    o, d = _rays(512, 17)
    exact = dense.intersect_dense(_t(o), _t(d), g, k=1)
    kern = dense.intersect_dense(_t(o), _t(d), g, k=1, fallback=False)
    same = kern.tri == exact.tri
    assert bool((kern.t[~same] >= exact.t[~same]).all())
    assert int(same.sum()) > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_grazing_table_follows_the_rule(seed):
    """Where the rule decides: the dense hits equal stream_plain's bit
    for bit (after canonical_hit), and every ray the brute force (the JAX
    engine's rule-free test) hits beyond them is a pair the rule rejects."""
    g, o, d, tm = chip_smoke.grazing_beside_span(seed)
    hit = dense.intersect_dense(o, d, g, t_max=tm, k=1)
    rule = stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    _bits_equal(hit, canonical_hit(o, d, g.tri_v0, g.tri_e1, g.tri_e2, rule))
    occ = dense.occluded_dense(o, d, tm, g, k=1)
    assert torch.equal(occ, rule.tri >= 0)
    brute = k1.intersect_pallas_plain(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    extra = brute.tri != hit.tri
    lo, hi = pretest_boxes(g.tri_packed)
    slot = brute.tri.clamp(min=0).long()
    c, s = slot // TRI_CHUNK, slot % TRI_CHUNK // 16
    lim = admissible_limit(o, d, g.cluster_min[c], g.cluster_max[c], lo[c], hi[c])
    lim = torch.gather(lim, 1, s[:, None])[:, 0]
    assert bool((brute.tri[extra] >= 0).all())
    assert bool((lim[extra] > brute.t[extra]).all())


def test_k_above_the_cull_register_list_raises(geoms):
    _, g = geoms
    o, d = _rays(8, 1)
    with pytest.raises(ValueError, match="registers"):
        dense.intersect_dense(_t(o), _t(d), g, k=17)


def test_dense_shadow_frame_equals_matrix_frame(monkeypatch):
    """shadow_dense_k sends the split shadow query to occluded_dense, which
    equals K2's any-hit mask: the frame equals the "matrix" frame bit for
    bit (tests/test_dense.py holds the JAX pair to 1e-5)."""
    from hala_tpu_torch.ops import query

    calls = []

    def counted(*args, **kw):
        calls.append(kw["k"])
        return dense.occluded_dense(*args, **kw)

    monkeypatch.setattr(query, "occluded_dense", counted)
    dev = SceneUploader.upload(sponza_like(rooms=(2, 2), columns_per_room=3,
                                           boxes_per_room=4),
                               use_ray_tracing=False, device="cpu")
    base = dict(width=16, height=16, max_depth=2, tile_size=256,
                intersector="matrix", sort_rays=True)
    films = []
    for k in (4, 0):
        film = Film.create(16, 16, "cpu")
        render_frame(dev, None, Uniforms.default("cpu"), film, 0,
                     RenderSettings(**base, shadow_dense_k=k))
        films.append(film)
    for f in ("accum", "albedo", "normal"):
        assert torch.equal(getattr(films[0], f), getattr(films[1], f)), f
    assert float(films[0].accum[..., :3].mean()) > 0.0
    assert calls and set(calls) == {4}  # the dense route ran, and only at K 4
