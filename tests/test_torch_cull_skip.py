"""The pieces of the redesigned K4 and K6 that run on the CPU.

- `cull.group_unions`: each union box contains its near members; NaN
  members stay out, far members (the 3e37 point boxes of empty
  clusters, infinities) are flagged to be tested on their own.
- A plain model of K4's group skip (csrc/cull_topk.cu): each ray, or
  each warp of 32 consecutive rays, tests a group's members only where
  its union is entered (plus the far members), and the K nearest keys
  and the count come out equal to `cull_topk_plain` and to the JAX
  package's `cull_topk` (interpret mode, as tests/test_torch_traverse.py
  runs it), on geometries with zero directions, +-0, NaN rays and
  t_max 0.
- `cluster.stream_unions`, K6's unions of padded boxes, and a plain
  model of its first pass: no cluster a ray enters before its hit is
  skipped.
- `cluster.live_queue`, K6's work queue: the live rays' ids in order
  and their count on the device, the empty queue.
- chip_smoke.py's work counters behind the K4 and K6 bounds (`k4_work`,
  `k2_work`) on toy scenes whose counts are known by hand.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops.cull import cull_topk as j_cull_topk
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import sponza_like
from hala_tpu_torch.ops import cluster, cull
from hala_tpu_torch.scene.gpu.scene import from_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the work counters of the bounds)

G = cull.CULL_GROUP


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rooms():
    """The 6x6-room sponza_like of tests/test_torch_traverse.py (63
    clusters: three full groups and a ragged one), both packages."""
    jdev = JUp.upload(sponza_like(rooms=(6, 6), columns_per_room=8, boxes_per_room=4),
                      use_ray_tracing=False)
    return jdev, from_numpy(jdev, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(lo, hi, n, seed):
    """Rays inside [lo, hi]: zero direction components (a dozen along
    the axes, some with -0), NaN rays, a quarter bounded, some dead."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(12):
        d[i] = 0.0
        d[i, i % 3] = 1.0 if (i // 3) % 2 == 0 else -1.0
    d[12:24, 1] = -0.0
    d[24, 0] = np.nan
    o[25, 2] = np.nan
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.1, 4.0, len(tm[1::4]))
    tm[::13] = 0.0
    tm[26] = np.nan
    return o, d, tm


def _odd_boxes(cmin, cmax):
    """The boxes with a 3e37 point box, a NaN corner, an infinite
    corner and a corner at -0 placed inside groups of real ones, and an
    all-sentinel group appended."""
    cmin, cmax = cmin.copy(), cmax.copy()
    cmin[3] = cmax[3] = 3.0e37
    cmin[18, 1] = np.nan
    cmax[33, 0] = np.inf
    cmin[40, 0] = -0.0
    far = np.full((G, 3), 3.0e37, np.float32)
    return np.concatenate([cmin, far]), np.concatenate([cmax, far])


def skip_model(o, d, tm, cmin, cmax, k, warp):
    """K4's group skip as a plain model: every (ray, member) pair the
    kernel tests, then the K smallest keys and the count over those
    pairs only. `warp` 1: each ray tests a group's members where it
    enters the union; 32: where some ray of its warp (32 consecutive
    rays) does, each ray still testing only its own entered groups'
    members, as the kernel's lanes do."""
    n, c = o.shape[0], cmin.shape[0]
    u = cull.group_unions(cmin, cmax)
    groups = u.shape[0]
    _, near = cull.slab_keys(o, d, tm, u[:, 0:3], u[:, 4:7])  # (N, groups)
    bits = u[:, 3].view(torch.int32)
    far = ((bits[:, None] >> torch.arange(G)) & 1).bool()  # (groups, G)
    live = ~torch.isnan(tm) & (tm > 0.0)
    mine = near[:, :, None] | (far[None] & live[:, None, None])  # (N, groups, G)
    if warp > 1:
        # a lane tests only its own members, whatever its warp enters:
        # the warp's walk changes which members are visited, not which
        # a lane tests
        pad = -n % warp
        walked = torch.nn.functional.pad(mine, (0, 0, 0, 0, 0, pad))
        walked = walked.view(-1, warp, groups, G).any(dim=1)
        walked = walked.repeat_interleave(warp, dim=0)[:n]
        mine = mine & walked
    tested = mine.reshape(n, groups * G)[:, :c]
    key, hit = cull.slab_keys(o, d, tm, cmin, cmax)
    key = torch.where(tested, key, cull.INF_KEY)
    pk = torch.full((n, k), cull.INF_KEY, dtype=torch.int32)
    kk = min(k, c)
    pk[:, :kk] = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    return pk, (hit & tested).sum(dim=1, dtype=torch.int32)


# --- the union boxes ---------------------------------------------------------


@pytest.mark.parametrize("odd", [False, True])
def test_group_unions_contain_their_members(rooms, odd):
    _, tdev = rooms
    cmin, cmax = (x.numpy() for x in (tdev.geometry.cluster_min, tdev.geometry.cluster_max))
    if odd:
        cmin, cmax = _odd_boxes(cmin, cmax)
    c = cmin.shape[0]
    u = cull.group_unions(_t(cmin), _t(cmax)).numpy()
    assert u.shape == (-(-c // G), 8)
    bits = u[:, 3].view(np.int32)
    for j in range(c):
        lo, hi = np.minimum(cmin[j], cmax[j]), np.maximum(cmin[j], cmax[j])
        g, q = divmod(j, G)
        if np.isnan(lo).any() or np.isnan(hi).any():
            assert not (bits[g] >> q) & 1
        elif (np.abs(np.concatenate([lo, hi])) >= cull.FAR_COORD).any():
            assert (bits[g] >> q) & 1, j
        else:
            assert not (bits[g] >> q) & 1
            assert (u[g, 0:3] <= lo).all() and (hi <= u[g, 4:7]).all(), j
    # the unions are the tightest: each face touches a near member
    assert (np.abs(u[:, 0:3]) < cull.FAR_COORD).all() or odd
    assert (u[:, 7] == 0).all()


def test_group_unions_of_sentinels_and_nan_boxes():
    """A group of real boxes and a 3e37 sentinel keeps the real boxes'
    union; a group of sentinels only gets a NaN box (never entered);
    a NaN member changes nothing; a ragged last group."""
    cmin = np.asarray([[0, 0, 0], [3e37] * 3, [1, -2, 0], [np.nan, 0, 0],
                       [3e37] * 3, [3e37] * 3, [-np.inf, 0, 0]], np.float32)
    cmax = np.asarray([[1, 1, 1], [3e37] * 3, [2, 0, 5], [9, 9, 9],
                       [3e37] * 3, [3e37] * 3, [0, 1, 1]], np.float32)
    u = cull.group_unions(_t(cmin), _t(cmax)).numpy()
    assert u.shape == (1, 8)
    np.testing.assert_array_equal(u[0, 0:3], [0, -2, 0])
    np.testing.assert_array_equal(u[0, 4:7], [2, 1, 5])
    assert u[0, 3].view(np.int32) == 0b1110010
    only_far = cull.group_unions(_t(cmin[[1, 4, 5]]), _t(cmax[[1, 4, 5]])).numpy()
    assert np.isnan(only_far[0, [0, 1, 2, 4, 5, 6]]).all()
    assert only_far[0, 3].view(np.int32) == 0b111
    empty = cull.group_unions(torch.zeros((0, 3)), torch.zeros((0, 3)))
    assert empty.shape == (0, 8)


def test_geometry_unions_are_kept_per_geometry(rooms):
    _, tdev = rooms
    g = types.SimpleNamespace(cluster_min=tdev.geometry.cluster_min.clone(),
                              cluster_max=tdev.geometry.cluster_max.clone())
    first = cull.geometry_unions(g, 24)
    assert len(first) == 3 and first is cull.geometry_unions(g, 24)
    assert [x.shape[0] for x in first] == [2, 2, 1]
    g.cluster_max[0, 0] += 100.0  # an in-place edit: built again
    again = cull.geometry_unions(g, 24)
    assert again is not first and float(again[0][0, 4]) >= 100.0


@pytest.mark.parametrize("odd", [False, True])
def test_stream_unions_contain_the_padded_members(rooms, odd):
    """K6's unions hold every near member's padded box (the padding of
    `slab_entry`); NaN, infinite and 3e37 members are far."""
    _, tdev = rooms
    cmin, cmax = (x.numpy() for x in (tdev.geometry.cluster_min, tdev.geometry.cluster_max))
    if odd:
        cmin, cmax = _odd_boxes(cmin, cmax)
    u = cluster.stream_unions(_t(cmin), _t(cmax)).numpy()
    bits = u[:, 3].view(np.int32)
    pad = (np.float32(1e-5) * (np.abs(cmin) + np.abs(cmax)) + np.float32(1e-6)).astype(np.float32)
    lo_p, hi_p = cmin - pad, cmax + pad
    for j in range(cmin.shape[0]):
        g, q = divmod(j, G)
        corners = np.concatenate([cmin[j], cmax[j]])
        if not (np.abs(corners) < cull.FAR_COORD).all():  # NaN compares False
            assert (bits[g] >> q) & 1, j
        else:
            assert not (bits[g] >> q) & 1
            assert (u[g, 0:3] <= np.minimum(lo_p[j], hi_p[j])).all(), j
            assert (np.maximum(lo_p[j], hi_p[j]) <= u[g, 4:7]).all(), j


@pytest.mark.parametrize("odd", [False, True])
def test_stream_union_skip_keeps_every_cluster_entered(rooms, odd):
    """The plain model of K6's first pass: every cluster a ray enters
    (padded test) at or before its closest hit lies in a group whose
    union it enters there too, or is far (tested on its own), so the
    skip never drops a cluster the walk needs."""
    _, tdev = rooms
    g = tdev.geometry
    cmin, cmax = (x.numpy() for x in (g.cluster_min, g.cluster_max))
    if odd:
        cmin, cmax = _odd_boxes(cmin, cmax)
    cmin, cmax = _t(cmin), _t(cmax)
    real = g.tri_v0[g.tri_mat >= 0].numpy()
    o, d, tm = (_t(x) for x in _rays(real.min(0), real.max(0), 1024, 31))
    hit = cluster.stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    t_end = torch.where(hit.tri >= 0, hit.t, tm)
    u = cluster.stream_unions(cmin, cmax)
    tn, enters = cluster.slab_entry(o[:, None], d[:, None], cmin[None], cmax[None])
    need = enters & (tn <= t_end[:, None]) & (tm > 1e-4)[:, None]
    box = u.view(-1, 2, 4)
    # the unions are already padded: the kernel tests them as they are
    utn, uenters = _padded_entry(o, d, box[:, 0, :3], box[:, 1, :3])
    kept = (uenters & (utn <= t_end[:, None])).repeat_interleave(G, dim=1)
    bits = box[:, 0, 3].view(torch.int32)
    far = ((bits[:, None] >> torch.arange(G)) & 1).bool().reshape(-1)
    kept = (kept | far[None])[:, :cmin.shape[0]]
    assert bool((kept | ~need).all())
    assert int(need.sum()) > 1000 and int((~kept).sum()) > 0


def _padded_entry(o, d, lo_p, hi_p):
    """csrc/cluster_walk.cuh `padded_entry` of rays (N, 3) against
    already padded boxes (G, 3): `slab_entry` without its padding."""
    tn = tf = inside = None
    for ax in range(3):
        oa, da = o[:, None, ax], d[:, None, ax]
        t0 = (lo_p[None, :, ax] - oa) * (1.0 / da)
        t1 = (hi_p[None, :, ax] - oa) * (1.0 / da)
        par = torch.abs(da) < cluster._TINY_DIR
        tn_a = torch.where(par, -torch.inf, torch.fmin(t0, t1))
        tf_a = torch.where(par, torch.inf, torch.fmax(t0, t1))
        in_a = ~par | ((lo_p[None, :, ax] <= oa) & (oa <= hi_p[None, :, ax]))
        tn = tn_a if tn is None else torch.fmax(tn, tn_a)
        tf = tf_a if tf is None else torch.fmin(tf, tf_a)
        inside = in_a if inside is None else inside & in_a
    tn = torch.where(tn < 0.0, tn * cluster._WIDEN_UP, tn * cluster._WIDEN_DOWN)
    tf = torch.where(tf > 0.0, tf * cluster._WIDEN_UP, tf * cluster._WIDEN_DOWN)
    return tn, inside & (tn <= tf) & (tf > 0.0)


# --- the plain model of the group skip -----------------------------------------


@pytest.mark.parametrize("warp", [1, 32])
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("odd", [False, True])
def test_skip_model_matches_plain_and_jax(rooms, warp, k, odd):
    jdev, tdev = rooms
    cmin, cmax = (x.numpy() for x in (tdev.geometry.cluster_min, tdev.geometry.cluster_max))
    if odd:
        cmin, cmax = _odd_boxes(cmin, cmax)
    real = tdev.geometry.tri_v0[tdev.geometry.tri_mat >= 0].numpy()
    o, d, tm = _rays(real.min(0), real.max(0), 1024, 21 + k)
    if odd:  # rays that enter the 3e37 point boxes on the diagonal
        o[40:48] = np.arange(8, dtype=np.float32)[:, None]
        d[40:48] = np.float32(1.0 / np.sqrt(3.0))
    args = (_t(o), _t(d), _t(tm), _t(cmin), _t(cmax))
    pk, cnt = skip_model(*args, k, warp)
    ref = cull.cull_topk_plain(*args, k)
    assert torch.equal(pk, ref[0]) and torch.equal(cnt, ref[1])
    jax_pk, jax_cnt = j_cull_topk(*(jnp.asarray(x) for x in (o, d, tm, cmin, cmax)),
                                  k=k, interpret=True)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jax_pk))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jax_cnt))
    assert int((cnt > 4).sum()) > 0 and int((cnt == 0).sum()) > 0
    if odd:
        _, hit = cull.slab_keys(*args[:3], args[3][-G:], args[4][-G:])
        assert bool(hit[40:48].any())  # the sentinels are entered


def test_skip_model_skips_groups(rooms):
    """On coherent rays from one point the model really skips: every ray
    misses some union, and the keys stay those of the plain version."""
    _, tdev = rooms
    g = tdev.geometry
    n = 1024
    o = torch.zeros((n, 3)) + g.tri_v0[g.tri_mat >= 0].mean(0)
    ang = torch.linspace(0.0, 0.5, n)
    d = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros(n)], dim=1)
    tm = torch.full((n,), 3.0e38)
    u = cull.group_unions(g.cluster_min, g.cluster_max)
    _, near = cull.slab_keys(o, d, tm, u[:, 0:3], u[:, 4:7])
    assert bool((~near).any(dim=1).all())
    ref = cull.cull_topk_plain(o, d, tm, g.cluster_min, g.cluster_max, 8)
    for warp in (1, 32):
        got = skip_model(o, d, tm, g.cluster_min, g.cluster_max, 8, warp)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# --- K6's queue ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "all_live", "empty", "no_rays"])
def test_live_queue(case):
    rs = np.random.RandomState(5)
    n = {"no_rays": 0}.get(case, 777)
    tm = rs.uniform(0.0, 3.0, n).astype(np.float32)
    if case == "mixed":
        tm[::3] = -np.inf
        tm[1::7] = 0.0
        tm[2::11] = 1e-4  # at t_min: not live
        tm[5] = np.nan
    elif case == "all_live":
        tm += 1.0
    elif case == "empty":
        tm[:] = -np.inf
    queue = cluster.live_queue(_t(tm))
    assert queue.dtype == torch.int32 and queue.shape == (n + 3,)
    live = np.flatnonzero(tm > np.float32(1e-4))
    count = int(queue[0])
    assert count == live.size and int(queue[1]) == 0
    np.testing.assert_array_equal(queue[2:2 + count].numpy(), live)
    if case == "all_live":
        assert count == n
    if case in ("empty", "no_rays"):
        assert count == 0


# --- the work counters of the bounds ----------------------------------------------


def test_k4_work_counts_by_hand():
    """20 boxes along x (a full group and a ragged one of 4): a ray
    through all of them enters both unions (20 member tests), one
    bounded at t 10 only the first (16), one along +y none; a dead ray
    does no work at all."""
    x = np.arange(20, dtype=np.float32)[:, None] * 2.0
    cmin = np.concatenate([x, np.full((20, 2), -1.0, np.float32)], axis=1)
    cmax = np.concatenate([x + 1.0, np.full((20, 2), 1.0, np.float32)], axis=1)
    o = _t(np.asarray([[-1, 0, 0], [-1, 0, 0], [100, 0, 0], [-1, 0, 0]], np.float32))
    d = _t(np.asarray([[1, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0]], np.float32))
    tm = _t(np.asarray([3e38, 10.0, 3e38, 0.0], np.float32))
    ms, by, w = chip_smoke.k4_work(o, d, tm, _t(cmin), _t(cmax), 8)
    assert w == dict(live_rays=3, launches=1, groups=2, union_tests=6, member_tests=36)
    t_ops = 42 * chip_smoke.OPS_CULL / chip_smoke.PEAK_FP32 * 1e3
    # rays 28 bytes, boxes 24, unions 32, lists 4 K + 4 a ray
    t_bytes = (4 * 28 + 20 * 24 + 2 * 32 + 4 * 8 * 4 + 4 * 4) / chip_smoke.PEAK_BYTES * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes))
    assert by == ("operations" if t_ops >= t_bytes else "bytes")


def test_k2_work_counts_by_hand():
    """Two clusters of one triangle each, facing the x axis at x = 0 and
    x = 5: a ray from x = -5 along +x enters cluster 0 before its hit
    (t = 5), not cluster 1 (t = 10); a ray from x = 2.5 enters only
    cluster 1; a ray along -x enters none. K6's bound counts these, as
    K2's: 3 union tests, 4 member tests, 2 (ray, cluster) pairs, 2
    Moller-Trumbore pairs, and 2 clusters some ray of the block enters."""
    from hala_tpu_torch.ops.intersect import full_t_max

    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 3.0e37
    tri = torch.tensor([[0, -1, -1], [0, 3, 0], [0, 0, 3]], dtype=torch.float32)
    for c, x0 in ((0, 0.0), (1, 5.0)):
        blk[c, 0:9, 0] = tri.reshape(9)
        blk[c, 0, 0] = x0
    tri_mat = torch.full((256,), -1, dtype=torch.int32)
    tri_mat[[0, 128]] = 0
    g = types.SimpleNamespace(
        cluster_min=torch.tensor([[0.0, -1, -1], [5.0, -1, -1]]),
        cluster_max=torch.tensor([[0.0, 2, 2], [5.0, 2, 2]]),
        tri_packed=cluster.with_pretest_row(blk), tri_mat=tri_mat)
    o = torch.tensor([[-5.0, 0, 0], [2.5, 0, 0], [-5.0, 0, 0]])
    d = torch.tensor([[1.0, 0, 0], [1.0, 0, 0], [-1.0, 0, 0]])
    tm = full_t_max(None, 3, o.device)
    hit = cluster.stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    assert hit.tri.tolist() == [0, 128, -1]
    _, _, w = chip_smoke.k2_work(g, o, d, tm, hit)
    assert w == dict(live_rays=3, groups=1, member_tests=4, pairs=2, mt_pairs=2,
                     least=2)
