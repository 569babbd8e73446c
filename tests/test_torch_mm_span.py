"""The span mask of the walks' chunk test (K7, K8) against the JAX package.

The port's grouped (K8) and wavefront (K7) walks accept a (ray, slot)
pair at t only where it is admissible: the ray enters the padded boxes
of the slot's cluster and of its span of 16 at entry distances <= t
(ops/cluster.py `admissible_limit`, `span_boxes`; ops/traverse.py
`mm_span_mask`); the JAX package's `_mm_chunk_test` has no such rule.
The kernels (csrc/mm_chunk_test.cuh) skip the spans no lane of a warp
enters and are held to the masked plain version on the card
(tests/test_torch_cuda.py); here the masked plain version is held to
the JAX kernels, run in interpret mode on the same lists:

- where both report the same triangle, t at rtol 1e-5 + atol 1e-6 (the
  raw factored test, before `canonical_hit`: XLA's dot_general sums in
  another order than the port's left-to-right sums, and t_num = o'.n -
  c0 carries an absolute error; the raw u, v differ by up to 2e-4 on
  the SAH layout, so they are left to the engines' tests, which compare
  `canonical_hit`'s);
- where they differ, the JAX winner lies in a span whose padded box the
  ray does not enter before that t (the mask's deviation), or one of
  the two winners is a graze (within 1e-4 barycentric of an edge, where
  the two orders of summation round differently), or the two are a
  near-tie (|dt| < 1e-4); on rays at random neither happens, on
  chip_smoke.py's table (rays at span-box corners and edges, which are
  triangle edges) grazes do;
- any-hit: the blocked rays equal, but for the rays so excused;
- the walks' counts (entries walked, and tested) are the JAX kernel's
  on rays at random, and those of the port's walk without the mask.

A constructed case shows the deviation: rays within ~1e-5 rad of the
plane of a unit triangle ~1000 units away, passing half a width to two
widths beside it. The factored test's barycentric numerators are then
rounding noise, so the JAX kernel accepts some of them; the port drops
them (they miss the padded span box) and the classic Moller-Trumbore of
the brute force (K1's plain version) rejects them too.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops import traverse as j_traverse
from hala_tpu.ops import wavefront as j_wavefront
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import random_triangle_soup, sponza_like
from hala_tpu_torch.ops import cull
from hala_tpu_torch.ops import traverse as k8
from hala_tpu_torch.ops import wavefront as k7
from hala_tpu_torch.ops.cluster import (FAR_BOX, WHOLE_BOX, admissible_limit,
                                        real_slots, slab_entry, span_boxes,
                                        with_pretest_row)
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.scene.gpu.scene import from_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the span-breaking table)

GROUP = k8.GROUP


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_geometry(blk, cmin, cmax):
    """What the JAX kernels read of a geometry, from (C, 16, 128) blocks."""
    rows = np.asarray(blk)[:, 0:9, :].transpose(0, 2, 1).reshape(-1, 9)
    return types.SimpleNamespace(
        tri_packed=jnp.asarray(blk), tri_v0=jnp.asarray(rows[:, 0:3]),
        tri_e1=jnp.asarray(rows[:, 3:6]), tri_e2=jnp.asarray(rows[:, 6:9]),
        cluster_min=jnp.asarray(cmin), cluster_max=jnp.asarray(cmax))


def _scene(name):
    """(blk, cmin, cmax, o, d, tm) as numpy arrays: a random soup and the
    SAH layout of tests/test_wavefront.py, with seeded rays (some with a
    short range, some dead, some resolved), and chip_smoke.py's table
    built to break the span mask."""
    if name == "walls":
        return chip_smoke.span_breaking_walls(41)
    if name == "soup":
        scene, center, n, seed = random_triangle_soup(4000, seed=6), (0.0, 0.0, 0.0), 512, 3
    else:
        scene, center, n, seed = (sponza_like(rooms=(4, 4), columns_per_room=4,
                                              boxes_per_room=16), (8.0, 1.5, 8.0), 512, 4)
    g = from_numpy(JUp.upload(scene, use_ray_tracing=False), "cpu").geometry
    if name == "sah":
        assert not g.prefix_layout
    real = g.tri_v0[g.tri_mat >= 0]
    if name == "soup":
        center = ((real.amin(0) + real.amax(0)) / 2).numpy()
    rs = np.random.RandomState(seed)
    o = np.asarray(center, np.float32) + rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, 3.0e38, np.float32)
    tm[::9] = 1.5
    tm[::17] = 0.0
    tm[5::23] = -np.inf
    return (g.tri_packed.numpy(), g.cluster_min.numpy(), g.cluster_max.numpy(), o, d, tm)


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in ("walls", "soup", "sah")}


def _grouped_lists(o, d, tm, cmin, cmax, k):
    c = cmin.shape[0]
    k = min(k, c)
    ids, tns, usz = k8._group_candidates(o, d, tm, cmin, cmax, k)
    return (torch.clamp(usz, max=k), torch.clamp(ids, max=c - 1).contiguous(),
            tns.view(torch.int32))


def _run_grouped(scene, k, any_hit):
    """The port's plain K8 and the JAX grouped kernel (interpret mode) on
    the same lists: ((t, tri, u, v, walked), (t, tri, u, v) numpy)."""
    blk, cmin, cmax, o, d, tm = (_t(a) for a in scene)
    counts, ids, tnb = _grouped_lists(o, d, tm, cmin, cmax, k)
    ours = k8.grouped_walk_plain(o, d, tm, counts, ids, tnb, blk, cmin, cmax, any_hit)
    ref = j_traverse.grouped_pallas_call(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(tm.numpy()),
        _jax_geometry(*scene[:3]), jnp.asarray(counts.numpy()),
        jnp.asarray(ids.numpy().reshape(-1)), jnp.asarray(tnb.numpy().reshape(-1)),
        k=ids.shape[1], any_hit=any_hit, interpret=True)
    return ours, tuple(np.asarray(x)[:, 0, :].reshape(-1) for x in ref), (o, d, tm)


def _run_wavefront(scene, k, m, any_hit):
    """The port's plain K7 and the JAX wavefront kernel (interpret mode)
    on the same lists (the port's glue, array-equal to the JAX
    package's): ((t, tri, u, v, stats), (t, tri, u, v, stats) numpy)."""
    blk, cmin, cmax, o, d, tm = (_t(a) for a in scene)
    o, d, tm = k8.pad_to_groups(o, d, tm)
    geo = types.SimpleNamespace(cluster_min=cmin, cluster_max=cmax, tri_packed=blk)
    w = k7.wavefront_lists(o, d, tm, geo, k, m)
    ours = k7.wavefront_walk_plain(w.o, w.d, w.t_max, w.tnb, w.want, w.own_last,
                                   blk, cmin, cmax, any_hit)
    g_total = w.tnb.shape[0]
    pkl = np.pad(w.tnb.numpy().reshape(-1, 1), ((0, 0), (0, 127)),
                 constant_values=cull.INF_KEY)
    want = k7.want_mask(w.tnb, w.pk, k).permute(0, 2, 1).reshape(g_total * m, GROUP)
    ref = j_wavefront._wf_pallas_call(
        jnp.asarray(w.o.numpy()), jnp.asarray(w.d.numpy()), jnp.asarray(w.t_max.numpy()),
        _jax_geometry(*scene[:3]), jnp.asarray(pkl),
        jnp.asarray(want.to(torch.int32).numpy()), jnp.asarray(w.own_last.numpy()),
        m, any_hit=any_hit, interpret=True)
    out = tuple(np.asarray(x)[:, 0, :].reshape(-1) for x in ref[:4])
    stats = np.asarray(ref[4])[:, 0:2, 0]
    return ours, out + (stats,), (w.o, w.d, w.t_max)


def _outside(scene, rays, tri, t):
    """Per ray: True where the pair (ray, slot tri) at t is not
    admissible by its boxes: the ray enters the padded box of the slot's
    cluster or of its span (`span_boxes`) beyond t or not at all
    (`admissible_limit`). Rays without a slot give False."""
    blk, cmin, cmax = (_t(a) for a in scene[:3])
    o, d, _ = rays
    lo, hi = span_boxes(blk, real_slots(blk))
    has = tri >= 0
    slot = np.where(has, tri, 0)
    c, s = _t(slot // 128).long(), _t(slot % 128 // 16).long()
    limit = admissible_limit(o, d, cmin[c], cmax[c], lo[c], hi[c])
    limit = torch.gather(limit, 1, s[:, None])[:, 0]
    return has & ~(limit <= _t(t)).numpy()


def _grazes(tri, u, v):
    """Hits within 1e-4 (barycentric) of an edge of their triangle: XLA's
    sums and the port's round differently there, so either may accept
    a pair the other rejects."""
    return (tri >= 0) & (np.minimum(np.minimum(u, v), 1.0 - u - v) < 1e-4)


def _hold(scene, rays, ours, ref):
    """The statement of the module docstring for closest hits. Returns
    per ray (dropped, excused): the JAX winner lies outside its span
    box; the rays differ otherwise at a graze of either winner."""
    t_o, tri_o, u_o, v_o = (x.numpy() for x in ours[:4])
    t_r, tri_r, u_r, v_r = ref[:4]
    same = tri_o == tri_r
    dropped = ~same & _outside(scene, rays, tri_r, t_r)
    graze = ~same & ~dropped & (_grazes(tri_o, u_o, v_o) | _grazes(tri_r, u_r, v_r))
    hit = same & (tri_r >= 0)
    np.testing.assert_allclose(t_o[hit], t_r[hit], rtol=1e-5, atol=1e-6)
    tie = ~same & ~dropped & ~graze
    assert not bool((tie & ((tri_o < 0) | (tri_r < 0))).any())
    assert np.abs(t_o - t_r)[tie].max(initial=0.0) < 1e-4
    # the port never accepts a pair its own mask excludes
    assert not bool(_outside(scene, rays, tri_o, t_o).any())
    return dropped, graze


def _hold_any_hit(ours, ref, excused):
    """Any-hit: the blocked rays equal, except rays whose closest hits
    differ by the mask or at a graze (`excused`)."""
    diff = (ours[1].numpy() >= 0) != (ref[1] >= 0)
    assert not bool((diff & ~excused).any())


@pytest.mark.parametrize("name,k", [("walls", 5), ("soup", 16), ("sah", 8), ("sah", 2)])
def test_grouped_walk_matches_jax_but_for_the_span_mask(scenes, name, k):
    ours, ref, rays = _run_grouped(scenes[name], k, False)
    dropped, graze = _hold(scenes[name], rays, ours, ref)
    assert int((ours[1] >= 0).sum()) > 100
    if name != "walls":  # rays at random: no graze, no dropped winner
        assert not bool((dropped | graze).any())
    ours, ref, _ = _run_grouped(scenes[name], k, True)
    _hold_any_hit(ours, ref, dropped | graze)


@pytest.mark.parametrize("name,k,m", [("walls", 5, 8), ("soup", 16, 32), ("sah", 8, 16),
                                      ("sah", 3, 8)])
def test_wavefront_walk_matches_jax_but_for_the_span_mask(scenes, name, k, m):
    for any_hit in (False, True):
        ours, ref, rays = _run_wavefront(scenes[name], k, m, any_hit)
        if any_hit:
            _hold_any_hit(ours, ref, dropped | graze)
        else:
            dropped, graze = _hold(scenes[name], rays, ours, ref)
            assert int((ours[1] >= 0).sum()) > 100
        # the walked and the tested entries per group are the JAX
        # kernel's (on the table a graze may change a vote)
        if name != "walls":
            np.testing.assert_array_equal(ours[4].numpy(), ref[4])


def _no_mask(o, d, tm, t_cur, lo, hi, cmin, cmax):
    """Every pair of a live ray admissible: the JAX kernel's test."""
    live = (tm > k8.T_MIN)[..., None].expand(*tm.shape, 8)
    return torch.where(live, -torch.inf, torch.inf)


@pytest.mark.parametrize("name", ["walls", "sah"])
def test_the_mask_leaves_the_walks_counts_unchanged(scenes, name, monkeypatch):
    """Entries walked (K8) and walked and tested (K7) with the span mask
    equal those without it, and so does every hit on these tables."""
    scene = scenes[name]
    blk, cmin, cmax, o, d, tm = (_t(a) for a in scene)
    lists = _grouped_lists(o, d, tm, cmin, cmax, 5)
    geo = types.SimpleNamespace(cluster_min=cmin, cluster_max=cmax, tri_packed=blk)
    w = k7.wavefront_lists(o, d, tm, geo, 5, 8)
    k7_args = (w.o, w.d, w.t_max, w.tnb, w.want, w.own_last, blk, cmin, cmax)
    masked = (k8.grouped_walk_plain(o, d, tm, *lists, blk, cmin, cmax),
              k7.wavefront_walk_plain(*k7_args))
    monkeypatch.setattr(k8, "mm_span_mask", _no_mask)
    bare = (k8.grouped_walk_plain(o, d, tm, *lists, blk, cmin, cmax),
            k7.wavefront_walk_plain(*k7_args))
    for a, b in zip(masked, bare):
        assert torch.equal(a[4], b[4])
        assert torch.equal(a[1], b[1])


def _grazing_case(seed=1, n=1024):
    """One unit triangle near (1000, 1000, 0) and n rays within ~1e-5 rad
    of its plane, crossing it 0.5 to 2 widths beside the edge e1 (but
    the first of each group of 128, which hits it), all turned by one
    random rotation (so the cross products cancel in every
    coordinate)."""
    rs = np.random.RandomState(seed)
    v0 = np.array([1000.0, 1000.0, 0.0])
    e1, e2 = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
    far = rs.uniform(500, 2000, n)
    h = far * rs.uniform(0.3e-5, 3e-5, n)
    o = np.stack([v0[0] + rs.uniform(0.1, 0.9, n) - far,
                  v0[1] - rs.uniform(0.5, 2.0, n), h], 1)
    d = np.stack([far, np.zeros(n), -h], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # lane 0 of each group hits the triangle head-on, so that every
    # group's list holds its cluster
    o[::128] = v0 + np.array([0.3, 0.3, 5.0])
    d[::128] = np.array([0.0, 0.0, -1.0])
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    blk = np.zeros((1, 16, 128), np.float32)
    blk[0, 0:3, 0], blk[0, 3:6, 0], blk[0, 6:9, 0] = q @ v0, q @ e1, q @ e2
    v = blk[0, 0:3, 0]
    corners = np.stack([v, v + blk[0, 3:6, 0], v + blk[0, 6:9, 0]])
    f32 = np.float32
    return (blk, corners.min(0)[None].astype(f32), corners.max(0)[None].astype(f32),
            (o @ q.T).astype(f32), (d @ q.T).astype(f32), np.full(n, 3.0e38, f32))


def test_grazing_rays_the_jax_kernel_accepts_are_dropped_as_k1_drops_them():
    """The deviation, constructed: the JAX kernel accepts rays that pass
    beside the triangle, outside its padded span box; the port drops
    them, and the classic Moller-Trumbore of the brute force rejects
    them too."""
    scene = _grazing_case()
    ours, ref, rays = _run_grouped(scene, 1, False)
    tri_o, tri_r = ours[1].numpy(), ref[1]
    jax_only = (tri_r >= 0) & (tri_o < 0)
    assert int(jax_only.sum()) >= 3
    beside = np.arange(tri_o.shape[0]) % 128 != 0
    assert not bool((tri_o[beside] >= 0).any()) and bool((tri_o[~beside] == 0).all())
    assert bool(_outside(scene, rays, tri_r, ref[0])[jax_only].all())
    blk = _t(scene[0])
    v0, e1, e2 = (blk[0, q:q + 3, :].T.contiguous() for q in (0, 3, 6))
    o, d, tm = rays
    classic = k1.intersect_pallas_plain(o, d, v0, e1, e2, t_max=tm, num_real=1)
    assert not bool((classic.tri.numpy()[jax_only] >= 0).any())
    dropped, _ = _hold(scene, rays, ours, ref)
    assert np.array_equal(dropped, jax_only)


def test_span_boxes_are_row_9_and_survive_odd_slots(scenes):
    """`span_boxes` equals the pretest row the JAX package's uploader
    writes, and `with_pretest_row` writes it in that layout; an empty span gets the far box, a span
    with a NaN or infinite corner the box every live ray enters."""
    for name in ("soup", "sah"):
        blk = _t(scenes[name][0])
        lo, hi = span_boxes(blk, real_slots(blk))
        row9 = blk[:, 9, :48].reshape(-1, 8, 6)
        assert torch.equal(lo, row9[..., :3]) and torch.equal(hi, row9[..., 3:])
    blk = _t(scenes["walls"][0])
    lo, hi = span_boxes(blk, real_slots(blk))
    row9 = with_pretest_row(blk)[:, 9, :48].reshape(-1, 8, 6)
    assert torch.equal(lo, row9[..., :3]) and torch.equal(hi, row9[..., 3:])
    assert bool((lo[1, 1::2] == FAR_BOX).all()) and bool((hi[2, 0::2] == FAR_BOX).all())
    odd = blk.clone()
    odd[0, 0, 3] = float("nan")  # one coordinate of one vertex: ignored
    odd[0, 0:3, 40] = float("inf")
    lo2, hi2 = span_boxes(odd, real_slots(odd))
    assert torch.equal(lo2[0, 0], lo[0, 0]) and torch.equal(hi2[0, 0], hi[0, 0])
    assert bool((lo2[0, 2] == -WHOLE_BOX).all()) and bool((hi2[0, 2] == WHOLE_BOX).all())
    whole = torch.tensor([[WHOLE_BOX] * 3])
    limit = k8.mm_span_mask(torch.zeros(1, 1, 3), torch.tensor([[[0.0, 0.0, 1.0]]]),
                            torch.ones(1, 1), torch.ones(1, 1), lo2[None, 0], hi2[None, 0],
                            -whole, whole)
    assert (limit[0, 0] < torch.inf).tolist() == [False, False, True] + [False] * 5


def test_span_mask_uses_the_best_t_and_ignores_dead_rays():
    """A span whose admissible limit (the later of the cluster's and the
    span's entry distances) lies beyond the ray's best t (closest hit)
    or its t_max is out; a dead (t_max 0) or resolved (t_max -inf) ray
    has none. The limit takes the cluster box where the ray enters it
    after the span box."""
    lo = torch.tensor([[[1.0, -1.0, -1.0]] * 8])
    hi = torch.tensor([[[2.0, 1.0, 1.0]] * 8])
    lo[0, 4:, 0], hi[0, 4:, 0] = 5.0, 6.0
    cmin, cmax = torch.tensor([[1.5, -1.0, -1.0]]), torch.tensor([[6.0, 1.0, 1.0]])
    o = torch.zeros(1, 4, 3)
    d = torch.tensor([1.0, 0.0, 0.0]).repeat(1, 4, 1)
    tm = torch.tensor([[3.0e38, 3.0e38, 0.0, -float("inf")]])
    t_cur = torch.tensor([[3.0e38, 3.0, 3.0e38, 3.0e38]])
    limit = k8.mm_span_mask(o, d, tm, t_cur, lo, hi, cmin, cmax)
    mask = limit < torch.inf
    assert mask[0, 0].all()
    assert mask[0, 1].tolist() == [True] * 4 + [False] * 4
    assert not mask[0, 2:].any()
    tn_c = slab_entry(o[0, 0], d[0, 0], cmin[0], cmax[0])[0]
    tn_s = slab_entry(o[0, 0], d[0, 0], lo[0, 4], hi[0, 4])[0]
    assert 1.0 < float(tn_c) < 1.5 and float(tn_s) > 4.9
    assert bool((limit[0, 0, :4] == tn_c).all()) and bool((limit[0, 0, 4:] == tn_s).all())
