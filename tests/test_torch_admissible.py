"""The admissibility rule of the cluster walks (ops/cluster.py).

A (ray, slot) pair counts only where classic Moller-Trumbore accepts it
at t in (1e-4, t_max) and the ray enters the padded boxes of the slot's
cluster and of its 16-slot span (row 9) at entry distances <= t. The
closest hit is the lexicographic (t, slot) minimum over the admissible
pairs. Every plain walk of the port computes that one function: K6's
and K2's plain version `stream_plain`, K2's schedule model
`matrix_walk_runs_plain` (blocks of 128 and of 32 rays), K5's plain
walk inside the traverse engine, and `intersect_clustered` on the CPU.
Here they are held to one another and to the rule written out over all
slots (`_rule`), on chip_smoke.py's `grazing_beside_span` table, where
the brute force K1 accepts rays beside the triangle that the rule
rejects, and on tables where the cluster box and the span box differ.
No JAX: the reference has no such rule (its TPU kernel's pretest reads
the running best t).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from hala_tpu_torch.ops import cluster as k6
from hala_tpu_torch.ops import traverse as k2
from hala_tpu_torch.ops.cluster import (TRI_CHUNK, admissible_limit, pretest_boxes,
                                        with_pretest_row)
from hala_tpu_torch.ops.intersect import T_MAX, Hit, mt_components
from hala_tpu_torch.ops.pallas import intersect_kernel as k1

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the grazing table)

SEEDS = (1, 2, 3, 4, 5)


def _rule(o, d, tm, cmin, cmax, tri_packed):
    """The rule over every slot at once: per ray the lexicographic
    (t, slot) minimum of the admissible pairs, and the (N, C * 128) mask
    of the pairs classic Moller-Trumbore accepts."""
    c = cmin.shape[0]
    rows = tri_packed[:, 0:9, :].permute(0, 2, 1).reshape(-1, 9)
    t, u, v, valid = mt_components(
        (o[:, 0:1], o[:, 1:2], o[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
        [rows[None, :, q] for q in range(9)])
    mt = valid & (t < tm[:, None])
    lo, hi = pretest_boxes(tri_packed)
    limit = admissible_limit(o[:, None, :], d[:, None, :], cmin[None], cmax[None],
                             lo[None], hi[None])  # (N, C, 8)
    limit = limit.reshape(o.shape[0], -1).repeat_interleave(16, dim=1)
    ok = mt & (limit <= t)
    t_ok = torch.where(ok, t, torch.inf)
    t_min = t_ok.amin(dim=1)
    slots = torch.arange(c * TRI_CHUNK)
    arg = torch.where(ok & (t_ok == t_min[:, None]), slots, c * TRI_CHUNK).amin(dim=1)
    found = arg < c * TRI_CHUNK
    at = arg.clamp(max=c * TRI_CHUNK - 1)[:, None]
    r = lambda x: torch.gather(x, 1, at)[:, 0]  # noqa: E731
    hit = Hit(t=torch.where(found, t_min, tm), tri=torch.where(found, arg, -1).int(),
              u=torch.where(found, r(u), 0.0), v=torch.where(found, r(v), 0.0))
    return hit, mt


def _walks(g, o, d, tm, monkeypatch):
    """Every plain walk of the port on the same rays: name -> Hit."""
    args = (o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    out = {"stream_plain": k6.stream_plain(*args),
           "model_128": k2.matrix_walk_runs_plain(*args, False)[0],
           "traverse": k2.intersect_traversed(o, d, g, t_max=tm),
           "cluster": k6.intersect_clustered(o, d, g, t_max=tm)}
    with monkeypatch.context() as m:
        m.setattr(k2, "MATRIX_BLOCK_RAYS", 32)
        out["model_32"] = k2.matrix_walk_runs_plain(*args, False)[0]
    any_hit = k2.matrix_walk_runs_plain(*args, True)[0]
    assert torch.equal(any_hit.tri >= 0, out["stream_plain"].tri >= 0)
    return out


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _hold(g, o, d, tm, monkeypatch):
    """All walks equal the rule bit for bit; K1's hits beyond them fail
    the rule. Returns (K1 hits, rule hits)."""
    ref, mt = _rule(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    for name, hit in _walks(g, o, d, tm, monkeypatch).items():
        _equal(hit, ref)
    brute = k1.intersect_pallas_plain(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    extra = brute.tri != ref.tri
    # K1 differs only where its winner is a pair the rule rejects
    lo, hi = pretest_boxes(g.tri_packed)
    slot = brute.tri.clamp(min=0).long()
    c, s = slot // TRI_CHUNK, slot % TRI_CHUNK // 16
    lim = admissible_limit(o, d, g.cluster_min[c], g.cluster_max[c], lo[c], hi[c])
    lim = torch.gather(lim, 1, s[:, None])[:, 0]
    assert bool((brute.tri[extra] >= 0).all())
    assert bool((lim[extra] > brute.t[extra]).all())
    assert bool(mt.any(dim=1)[extra].all())
    return int((brute.tri >= 0).sum()), int((ref.tri >= 0).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_walks_equal_the_rule_on_the_grazing_table(seed, monkeypatch):
    """`grazing_beside_span`: every walk equals the rule; K1 hits more
    rays (2-23 a seed), each through a pair outside the span box."""
    g, o, d, tm = chip_smoke.grazing_beside_span(seed)
    k1_hits, rule_hits = _hold(g, o, d, tm, monkeypatch)
    assert k1_hits > rule_hits


def _one_triangle(cluster_lo, cluster_hi, o, d):
    """One cluster holding the unit triangle of the x = 0 plane
    (v0 (0, 0, 0), e1 (0, 1, 0), e2 (0, 0, 1)) in slot 3, with the given
    cluster box; row 9 from `with_pretest_row`."""
    blk = torch.zeros((1, 16, 128))
    blk[0, 0:3, :] = 3.0e37
    blk[0, 0:3, 3] = 0.0
    blk[0, 4, 3] = 1.0
    blk[0, 8, 3] = 1.0
    blk = with_pretest_row(blk)
    rows = blk[0, 0:9, :].T.contiguous()
    g = types.SimpleNamespace(
        cluster_min=torch.tensor([cluster_lo], dtype=torch.float32),
        cluster_max=torch.tensor([cluster_hi], dtype=torch.float32), tri_packed=blk,
        tri_v0=rows[:, 0:3].contiguous(), tri_e1=rows[:, 3:6].contiguous(),
        tri_e2=rows[:, 6:9].contiguous())
    o = torch.tensor(o, dtype=torch.float32)
    d = torch.tensor(d, dtype=torch.float32)
    return g, o, d, torch.full((o.shape[0],), T_MAX)


def test_the_cluster_box_is_part_of_the_rule(monkeypatch):
    """chip_smoke.py's `half_box_table`: a cluster box that covers only
    y < 0.5 of the triangle; rays through y > 0.5 hit the triangle inside
    its span box, the cluster box rejects them, so every walk misses and
    K1 hits; rays through y < 0.5 hit in every walk. (No ray runs along
    the box's face, where the cull's unpadded test, the reference's, may
    miss the cluster.)"""
    g, o, d, tm = chip_smoke.half_box_table()
    k1_hits, rule_hits = _hold(g, o, d, tm, monkeypatch)
    assert k1_hits == 64 and rule_hits == int((o[:, 1] < 0.5).sum())


def test_a_span_box_an_ulp_outside_its_cluster_box(monkeypatch):
    """The cluster box is the span box with every face moved inward by
    one ulp, as the uploader's float32 corners (v0 + e1, v0 + e2) can
    leave a span box poking out of the cluster box built from the
    original corners. Rays graze the triangle's plane and cross it
    beside and on its edges: the walks equal the rule, which takes the
    later of the two entries, and K1 differs only on pairs it rejects;
    pairs whose span entry lies at or before t and whose cluster entry
    lies after it would be dropped (no such ray was found: the entries
    differ by ~1e-7, the noise hits lie outside both boxes)."""
    rs = np.random.RandomState(7)
    n = 2048
    lo, hi = np.zeros(3, np.float32), np.array([0.0, 1.0, 1.0], np.float32)
    c_lo = np.nextafter(lo, np.float32(np.inf))
    c_hi = np.nextafter(hi, np.float32(-np.inf))
    # rays nearly in the plane x = 0, crossing it at y in [-0.2, 1.2]
    y = rs.uniform(-0.2, 1.2, n)
    z = rs.uniform(-0.2, 1.2, n)
    slope = rs.uniform(1e-7, 1e-5, n) * rs.choice([-1.0, 1.0], n)
    far = rs.uniform(1.0, 50.0, n)
    o = np.stack([-slope * far, y - far, z], 1)
    d = np.stack([slope, np.ones(n), np.zeros(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    g, o, d, tm = _one_triangle(c_lo.tolist(), c_hi.tolist(), o.tolist(), d.tolist())
    blo, bhi = pretest_boxes(g.tri_packed)
    assert bool((blo[0, 0] < g.cluster_min[0]).all() and (bhi[0, 0] > g.cluster_max[0]).all())
    k1_hits, rule_hits = _hold(g, o, d, tm, monkeypatch)
    assert rule_hits > 100


def test_no_admissible_pair_is_lost_on_a_sah_scene(monkeypatch):
    """A small SAH scene with rays at random: the walks equal the rule,
    and the rule equals K1 there (no pair lies outside its boxes)."""
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import sponza_like

    scene = sponza_like(rooms=(4, 4), columns_per_room=4, boxes_per_room=16)
    g = SceneUploader.upload(scene, device="cpu").geometry
    assert not g.prefix_layout
    rs = np.random.RandomState(11)
    n = 512
    o = torch.from_numpy((np.array([8.0, 1.5, 8.0]) + rs.uniform(-1, 1, (n, 3))).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.full((n,), T_MAX)
    k1_hits, rule_hits = _hold(g, o, d, tm, monkeypatch)
    assert k1_hits == rule_hits > 100
