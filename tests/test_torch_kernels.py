"""The two kernels of the port's main path, against the JAX package.

K1 (`ops/pallas/intersect_kernel.py`, csrc/intersect_bruteforce.cu) and
K2 (`ops/traverse.py`, csrc/matrix_traverse.cu): on the CPU each
wrapper runs its plain PyTorch version, which is held here against
hala_tpu's Pallas kernels run in interpret mode (as tests/test_pallas.py
and tests/test_traverse.py run them) and against its brute force.
Triangle ids are equal; t/u/v agree within rtol/atol 1e-5 (the
tolerance tests/test_traverse.py holds the TPU kernels to).

K2's schedule (the front-to-back walk per block of rays) has a plain
model, `matrix_walk_runs_plain`, held here bit for bit to K2's plain
version and to hala_tpu's kernel in interpret mode, on adversarial
rays, ties across clusters and edge ranges; the clusters it visits per
block fall as the batch gets more coherent.

The kernels themselves are compared with their plain versions on the
card by tests/test_torch_cuda.py.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops.intersect import intersect_bruteforce as j_bruteforce
from hala_tpu.ops.pallas.intersect_kernel import (
    intersect_pallas as j_intersect_pallas,
    occluded_pallas as j_occluded_pallas,
)
from hala_tpu.ops.traverse import intersect_matrix as j_intersect_matrix
from hala_tpu.ops.traverse import occluded_matrix as j_occluded_matrix
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import (
    cornell_box,
    random_triangle_soup,
    sponza_like,
)
from hala_tpu_torch.ops import cuda_lib
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.ops import traverse as k2
from hala_tpu_torch.scene.gpu.scene import from_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (K2's hand-built span tables)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    more threads per worker only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _rays(n, rs, center=(0.0, 0.0, 0.0), spread=0.9, axis_aligned=0):
    o = np.asarray(center, np.float32) + rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # rays along the axes: direction components exactly 0, parallel to
    # the axis-aligned walls (the slab test's 0 * inf case)
    for i in range(axis_aligned):
        d[i] = 0.0
        d[i, i % 3] = 1.0 if (i // 3) % 2 == 0 else -1.0
    return o, d


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_hits(ours, ref, what="", uv_atol=TOL):
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri), err_msg=what)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=TOL, err_msg=what)
    m = np.asarray(ref.tri) >= 0
    for a, b in ((ours.u, ref.u), (ours.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], atol=uv_atol, err_msg=what)


def _jax_and_port(host_scene):
    jdev = JUp.upload(host_scene, use_ray_tracing=False)
    return jdev, from_numpy(jdev, "cpu")


@pytest.fixture(scope="module")
def cornell():
    return _jax_and_port(cornell_box())


@pytest.fixture(scope="module")
def soup():
    return _jax_and_port(random_triangle_soup(300, seed=5))


@pytest.fixture(scope="module")
def sponza():
    # the geometry of tests/test_traverse.py
    return _jax_and_port(sponza_like(rooms=(2, 2), columns_per_room=4, boxes_per_room=2))


@pytest.fixture(scope="module")
def atrium():
    import os

    from hala_tpu.scene.cpu.scene import Scene

    path = os.path.join(os.path.dirname(__file__), "..", "assets", "atrium.glb")
    return _jax_and_port(Scene.load(path))


# --- K1: brute force --------------------------------------------------------


@pytest.mark.parametrize("which", ["cornell", "soup"])
def test_k1_plain_matches_pallas_interpret(which, cornell, soup, rs):
    jdev, tdev = {"cornell": cornell, "soup": soup}[which]
    jg, tg = jdev.geometry, tdev.geometry
    n = 300  # ragged: not a multiple of any block
    o, d = _rays(n, rs, axis_aligned=6)
    tm = rs.uniform(0.2, 3.0, n).astype(np.float32)
    tm[::5] = 3.0e38
    tm[::17] = 0.0  # dead rays
    num_real = tg.num_triangles
    if which == "soup":
        assert tg.tri_v0.shape[0] == 384 and num_real == 300  # 3 chunks, ragged tail
    ref = j_intersect_pallas(
        jnp.asarray(o), jnp.asarray(d), jg.tri_v0, jg.tri_e1, jg.tri_e2,
        t_max=jnp.asarray(tm), interpret=True, num_real=num_real,
    )
    ours = k1.intersect_pallas(
        _t(o), _t(d), tg.tri_v0, tg.tri_e1, tg.tri_e2, t_max=_t(tm),
        num_real=num_real,
    )
    assert int((ours.tri >= 0).sum()) > (50 if which == "cornell" else 5)
    _assert_hits(ours, ref, which)
    occ_ref = j_occluded_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jg.tri_v0, jg.tri_e1,
        jg.tri_e2, interpret=True, num_real=num_real,
    )
    occ = k1.occluded_pallas(
        _t(o), _t(d), _t(tm), tg.tri_v0, tg.tri_e1, tg.tri_e2, num_real=num_real
    )
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_k1_plain_matches_bruteforce_all_slots(soup, rs):
    jdev, tdev = soup
    jg, tg = jdev.geometry, tdev.geometry
    o, d = _rays(257, rs)
    ref = j_bruteforce(jnp.asarray(o), jnp.asarray(d), jg.tri_v0, jg.tri_e1, jg.tri_e2)
    ours = k1.intersect_pallas(_t(o), _t(d), tg.tri_v0, tg.tri_e1, tg.tri_e2)
    _assert_hits(ours, ref)


# --- K2: cluster traversal ----------------------------------------------------


def _k2_batch(rs, n, center, spread):
    o, d = _rays(n, rs, center=center, spread=spread, axis_aligned=12)
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.1, 4.0, len(tm[1::4]))
    tm[::13] = 0.0  # dead rays
    return o, d, tm


def test_k2_plain_matches_matrix_interpret(sponza, rs):
    jdev, tdev = sponza
    jg, tg = jdev.geometry, tdev.geometry
    o, d, tm = _k2_batch(rs, 256, (4.0, 1.5, 4.0), 1.0)
    ref = j_intersect_matrix(jnp.asarray(o), jnp.asarray(d), jg,
                             t_max=jnp.asarray(tm), interpret=True)
    ours = k2.intersect_matrix(_t(o), _t(d), tg, t_max=_t(tm))
    assert int((ours.tri >= 0).sum()) > 100
    _assert_hits(ours, ref, "closest")
    bf = j_bruteforce(jnp.asarray(o), jnp.asarray(d), jg.tri_v0, jg.tri_e1,
                      jg.tri_e2, t_max=jnp.asarray(tm))
    _assert_hits(ours, bf, "vs brute force")
    occ_ref = j_occluded_matrix(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                jg, interpret=True)
    occ = k2.occluded_matrix(_t(o), _t(d), _t(tm), tg)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(bf.tri) >= 0)


def test_k2_plain_on_sah_layout_matches_bruteforce(atrium, rs):
    """atrium.glb: 33,920 triangles on the binned-SAH layout (interior
    padding slots, 369 clusters)."""
    jdev, tdev = atrium
    jg, tg = jdev.geometry, tdev.geometry
    assert not tg.prefix_layout and tg.tri_packed.shape[0] > 300
    real = tg.tri_v0[tg.tri_mat >= 0]
    center = ((real.amin(0) + real.amax(0)) / 2).numpy()
    o, d, tm = _k2_batch(rs, 384, center, 2.0)
    bf = j_bruteforce(jnp.asarray(o), jnp.asarray(d), jg.tri_v0, jg.tri_e1,
                      jg.tri_e2, t_max=jnp.asarray(tm))
    ours = k2.matrix_query(_t(o), _t(d), tg, t_max=_t(tm))
    assert int((ours.tri >= 0).sum()) > 150
    # ids and t as everywhere; u/v to 5e-5: one grazing hit of this batch
    # measured |du| = 2.02e-5 (relative 6.1e-5), the 1/det amplification
    # of a different summation order of the same dot products.
    _assert_hits(ours, bf, uv_atol=5e-5)


def test_k2_plain_reads_the_cluster_aabbs(sponza, rs):
    """A cluster table that excludes its own triangles changes the
    plain version's answer: the culling is real, not a brute force."""
    import dataclasses

    _, tdev = sponza
    g = tdev.geometry
    o, d, tm = _k2_batch(rs, 256, (4.0, 1.5, 4.0), 1.0)
    good = k2.intersect_matrix(_t(o), _t(d), g, t_max=_t(tm))
    c = int(torch.mode(good.tri[good.tri >= 0] // 128).values)
    far = torch.full((3,), 3.0e37)
    bad = dataclasses.replace(
        g, cluster_min=g.cluster_min.clone().index_put_((torch.tensor([c]),), far),
        cluster_max=g.cluster_max.clone().index_put_((torch.tensor([c]),), far),
    )
    wrong = k2.intersect_matrix(_t(o), _t(d), bad, t_max=_t(tm))
    lost = (good.tri // 128 == c) & (good.tri >= 0)
    assert int(lost.sum()) > 0
    assert bool((wrong.tri[lost] != good.tri[lost]).all())
    keep = ~lost
    assert torch.equal(wrong.tri[keep], good.tri[keep])


# --- K2's schedule: the plain model of the front-to-back block walk ----------


def _assert_bits(ours, ref):
    """Hits equal bit for bit: tri, and t/u/v as int32 bit patterns."""
    assert torch.equal(ours.tri, ref.tri)
    for a, b in ((ours.t, ref.t), (ours.u, ref.u), (ours.v, ref.v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def sponza_k2_ref(sponza):
    """`_k2_batch`'s adversarial rays on sponza_like (axis-aligned
    directions, bounded and dead rays) and hala_tpu's intersect_matrix
    and occluded_matrix on them in interpret mode."""
    jg = sponza[0].geometry
    o, d, tm = _k2_batch(np.random.RandomState(7), 256, (4.0, 1.5, 4.0), 1.0)
    ref = j_intersect_matrix(jnp.asarray(o), jnp.asarray(d), jg,
                             t_max=jnp.asarray(tm), interpret=True)
    occ = j_occluded_matrix(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                            jg, interpret=True)
    return o, d, tm, ref, np.asarray(occ)


@pytest.mark.parametrize("order", ["drawn", "sorted"])
@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_k2_walk_model_matches_matrix_interpret(sponza, sponza_k2_ref, query, order):
    """The plain model of K2's walk equals stream_plain bit for bit and
    hala_tpu's kernel in interpret mode: the closest hit, or the hit
    mask of the any-hit query, on the rays as drawn and in
    matrix_query's coherence order. Its counts of queued (ray, span)
    pairs and packed steps stay within what the visits allow."""
    from hala_tpu_torch.ops.compaction import order_by, query_coherence_key

    g = sponza[1].geometry
    o, d, tm, ref, occ_ref = sponza_k2_ref
    o, d, tm = _t(o), _t(d), _t(tm)
    if order == "sorted":
        perm, _ = order_by(query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max))
        o, d, tm = (x[perm].contiguous() for x in (o, d, tm))
        ref = types.SimpleNamespace(**{k: np.asarray(getattr(ref, k))[perm.numpy()]
                                       for k in ("t", "tri", "u", "v")})
        occ_ref = occ_ref[perm.numpy()]
    plain = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    hit, runs, work = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=query == "any_hit")
    if query == "closest":
        _assert_bits(hit, plain)
        assert int((hit.tri >= 0).sum()) > 100
        _assert_hits(hit, ref, "vs interpret")
    else:
        np.testing.assert_array_equal((hit.tri >= 0).numpy(), occ_ref)
        assert torch.equal(hit.tri >= 0, plain.tri >= 0)
    c = g.cluster_min.shape[0]
    blocks = 256 // k2.MATRIX_BLOCK_RAYS
    warps = k2.MATRIX_BLOCK_RAYS // k2.MATRIX_WARP_RAYS
    assert runs.shape == (blocks,) and 0 < int(runs.max()) <= c
    # a warp queues at most 8 spans a lane a visit and runs them two a
    # step, one step more where its count is odd
    pairs, steps = work[:, 0], work[:, 1]
    assert work.shape == (blocks, 2) and int(pairs.min()) > 0
    assert (pairs <= k2.PRETEST_PER_CHUNK * k2.MATRIX_BLOCK_RAYS * runs).all()
    assert (2 * steps >= pairs).all() and (2 * steps - pairs <= warps * runs).all()


def test_k2_walk_model_runs_fall_with_coherence(atrium, rs):
    """atrium.glb (369 clusters): the model equals stream_plain bit for
    bit on random rays, unsorted and in matrix_query's coherence order,
    and on pinhole rays; the clusters a block visits never exceed C and
    fall as the batch gets more coherent."""
    from hala_tpu_torch.ops.compaction import order_by, query_coherence_key

    g = atrium[1].geometry
    c = g.cluster_min.shape[0]
    real = g.tri_v0[g.tri_mat >= 0]
    center = ((real.amin(0) + real.amax(0)) / 2).numpy()
    o, d, tm = (_t(x) for x in _k2_batch(rs, 512, center, 2.0))
    order, _ = order_by(query_coherence_key(o, d, tm, g.cluster_min, g.cluster_max))
    pin_d = torch.from_numpy(rs.normal(size=(512, 3)).astype(np.float32) * 0.1
                             + np.float32([1.0, 0.0, 0.0]))
    pin_d = pin_d / torch.linalg.norm(pin_d, dim=1, keepdim=True)
    batches = {
        "unsorted": (o, d, tm),
        "sorted": (o[order].contiguous(), d[order].contiguous(), tm[order].contiguous()),
        "pinhole": (torch.from_numpy(np.tile(center, (512, 1))), pin_d,
                    torch.full((512,), 3.0e38)),
    }
    mean = {}
    for how, (o_, d_, tm_) in batches.items():
        plain = k2.intersect_matrix_plain(o_, d_, g, t_max=tm_)
        hit, runs, work = k2.matrix_walk_runs(o_, d_, g, t_max=tm_)
        _assert_bits(hit, plain)
        assert int(runs.max()) <= c
        mean[how] = float(runs.float().mean())
    assert mean["pinhole"] < mean["sorted"] < mean["unsorted"]


def _tie_geometry():
    """Two clusters holding the same triangle in the plane x = 0: slot 7
    of cluster 0 (box [0, -1, -1]-[0, 2, 2]) and slot 3 of cluster 1,
    whose slot 9 (a triangle off to the side at x = -3) stretches its box
    toward rays coming from x = -5. Such a ray enters cluster 1 at 2 and
    cluster 0 at 5, where both slots hit: front to back it meets slot 131
    first, and brute force keeps slot 7."""
    from hala_tpu_torch.ops.cluster import with_pretest_row

    blk = torch.zeros((2, 16, 128))
    blk[:, 0:3, :] = 3.0e37  # padding slots: far v0, zero edges
    for c, s, tri in ((0, 7, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 3, [[0, -1, -1], [0, 3, 0], [0, 0, 3]]),
                      (1, 9, [[-3, 10, 0], [0, 1, 0], [0, 0, 1]])):
        blk[c, 0:9, s] = torch.tensor(tri, dtype=torch.float32).reshape(9)
    return types.SimpleNamespace(
        cluster_min=torch.tensor([[0.0, -1.0, -1.0], [-3.0, -1.0, -1.0]]),
        cluster_max=torch.tensor([[0.0, 2.0, 2.0], [0.0, 11.0, 2.0]]),
        tri_packed=with_pretest_row(blk),
    )


def test_k2_walk_model_keeps_the_lowest_slot_at_equal_t(rs):
    g = _tie_geometry()
    n = 40
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = -5.0
    o[:, 1:] = rs.uniform(-0.5, 0.5, (n, 2))
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    plain = k2.intersect_matrix_plain(_t(o), _t(d), g)
    assert (plain.tri == 7).all() and (plain.t == 5.0).all()
    hit, runs, work = k2.matrix_walk_runs(_t(o), _t(d), g)
    _assert_bits(hit, plain)
    assert runs.tolist() == [2]  # cluster 1, then cluster 0
    # any hit: the lowest hit slot of the first cluster with one
    occ, _, _ = k2.matrix_walk_runs(_t(o), _t(d), g, any_hit=True)
    assert (occ.tri == 131).all()


@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_k2_walk_model_counts_a_full_queue(query):
    """chip_smoke.py's `span_stack_table`: every live ray enters all
    eight spans, so a warp of 32 queues 8 pairs a live lane; rays whose
    t_max is exactly their closest hit enter only the nearest span and
    keep no hit; dead rays queue nothing. Rays i % 8 == 0 dead, == 1 at
    t_max, the rest full, in a block of 128 and a ragged one of 37: the
    pairs and steps follow in closed form."""
    g, o, d, tm = chip_smoke.span_stack_table(165)
    first = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    assert (first.tri == 115).all()
    i = torch.arange(165)
    tm = torch.where(i % 8 == 0, 0.0, torch.where(i % 8 == 1, first.t, tm))
    hit, runs, work = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=query == "any_hit")
    # a full warp: 4 dead, 4 at t_max (1 pair each), 24 full (8 each);
    # the last 5 rays: 1 dead, 1 at t_max, 3 full
    assert runs.tolist() == [1, 1]
    assert work.tolist() == [[4 * 196, 4 * 98], [196 + 25, 98 + 13]]
    assert k2.packed_share(work) == pytest.approx(1005 * 16 / (503 * 32))
    full = i % 8 >= 2
    assert (hit.tri[~full] == -1).all() and torch.equal(hit.t[~full], tm[~full])
    if query == "closest":
        _assert_bits(hit, k2.intersect_matrix_plain(o, d, g, t_max=tm))
        assert (hit.tri[full] == 115).all()
    else:
        assert (hit.tri[full] == 3).all() and (hit.t[full] == 8.0).all()


@pytest.mark.parametrize("query", ["closest", "any_hit"])
def test_k2_walk_model_counts_ties_across_spans(query):
    """chip_smoke.py's `span_tie_table`: each ray meets one triangle four
    times at t 5, in slot 131 (visit 1, one span) and in slots 5, 40 and
    100 (visit 2, three spans): the closest hit is slot 5, 4 pairs a ray
    over two visits; the any hit slot 131, one pair in one visit. 40
    rays: warps of 32 and 8."""
    g, o, d, tm = chip_smoke.span_tie_table(40)
    hit, runs, work = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=query == "any_hit")
    plain = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    assert (plain.tri == 5).all()
    if query == "closest":
        _assert_bits(hit, plain)
        assert runs.tolist() == [2] and work.tolist() == [[160, 80]]
    else:
        assert (hit.tri == 131).all() and torch.equal(hit.t, plain.t)
        assert runs.tolist() == [1] and work.tolist() == [[40, 20]]


def test_k2_walk_model_edge_rays(atrium, rs):
    """Origins inside cluster boxes (their centres), t_max exactly at the
    closest hit (that hit is then out of range), t_max 0 and -inf: bit
    for bit stream_plain, and the same hit mask with any_hit."""
    g = atrium[1].geometry
    n = 256
    ctr = (g.cluster_min + g.cluster_max) / 2
    pick = torch.from_numpy(rs.randint(0, g.cluster_min.shape[0] - 1, n))
    o = ctr[pick].contiguous()
    d = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    d = (d / torch.linalg.norm(d, dim=1, keepdim=True)).contiguous()
    first = k2.intersect_matrix_plain(o, d, g)
    tm = torch.where(first.tri >= 0, first.t, 3.0e38)
    tm[1::4] = 0.0
    tm[2::4] = -torch.inf
    assert int((first.tri[::4] >= 0).sum()) > 32
    plain = k2.intersect_matrix_plain(o, d, g, t_max=tm)
    hit, _, _ = k2.matrix_walk_runs(o, d, g, t_max=tm)
    _assert_bits(hit, plain)
    occ, _, _ = k2.matrix_walk_runs(o, d, g, t_max=tm, any_hit=True)
    assert torch.equal(occ.tri >= 0, plain.tri >= 0)
    assert (plain.tri[1::4] == -1).all() and (plain.tri[2::4] == -1).all()


def test_slab_test_edge_cases():
    """Zero-thickness boxes, zero direction components, far-sentinel
    empty clusters and dead rays."""
    cmin = torch.tensor([[0.0, -1.0, -1.0], [3.0e37] * 3, [-1.0, -1.0, 2.0]])
    cmax = torch.tensor([[0.0, 1.0, 1.0], [3.0e37] * 3, [1.0, 1.0, 2.0]])
    o = torch.tensor([[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [0.0, 0.5, 0.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0],
                      [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    t_cur = torch.tensor([3.0e38, 3.0e38, 3.0e38, 3.0e38, 1.0])
    live = k2.slab_live(o, d, cmin, cmax, t_cur)
    # ray 0 crosses the zero-thickness wall x=0; ray 1 runs parallel to
    # it at x=-1 (outside); ray 2 runs inside the wall's plane; ray 3
    # hits the z=2 plate head-on and ray 4 would, but its range ends
    # before the plate
    assert live[0, 0] and not live[1, 0] and live[2, 0] and live[3, 2]
    assert not live[4, 2]
    assert not live[:, 1].any()  # far sentinel box
    # dead rays (t_max = 0) return no hit and their t_max
    g = types.SimpleNamespace(
        cluster_min=cmin, cluster_max=cmax,
        tri_packed=torch.zeros((3, 16, 128)),
    )
    hit = k2.intersect_matrix(o, d, g, t_max=torch.zeros(5))
    assert (hit.tri == -1).all() and (hit.t == 0).all()


def test_cpu_tensors_never_launch(cornell, sponza, rs):
    cuda_lib.reset_launches()
    _, tdev = cornell
    g = tdev.geometry
    o, d = _rays(64, rs)
    k1.intersect_pallas(_t(o), _t(d), g.tri_v0, g.tri_e1, g.tri_e2)
    k1.occluded_pallas(_t(o), _t(d), torch.ones(64), g.tri_v0, g.tri_e1, g.tri_e2)
    _, sdev = sponza
    k2.intersect_matrix(_t(o), _t(d), sdev.geometry)
    k2.occluded_matrix(_t(o), _t(d), torch.ones(64), sdev.geometry)
    from hala_tpu_torch.ops.raster_kernel import rasterize_tiled_exact

    tri = torch.tensor([[[1.0, 1.0], [30.0, 2.0], [5.0, 30.0]]])
    rasterize_tiled_exact(tri, torch.ones(1, 3), torch.ones(1, 3),
                          torch.ones(1, dtype=torch.bool), 32, 32, tile=16)
    from hala_tpu_torch.ops.cluster import intersect_clustered
    from hala_tpu_torch.ops.traverse import intersect_traversed

    intersect_traversed(_t(o), _t(d), sdev.geometry, k_per_ray=2)
    hit = intersect_clustered(_t(o), _t(d), sdev.geometry)
    from hala_tpu_torch.ops.shade_fetch import shade_fetch

    shade_fetch(sdev, hit, torch.zeros((64, 3)), torch.ones(64), torch.tensor(1e-3))
    assert cuda_lib.launches() == {
        "intersect_bruteforce": 0, "matrix_traverse": 0, "raster_tiled": 0,
        "cull_topk": 0, "traverse_candidates": 0, "cluster_stream": 0,
        "grouped_walk": 0, "wavefront_walk": 0, "shade_fetch": 0,
        "shade_bounce": 0, "shade_bounce_pre": 0, "shade_bounce_seam": 0,
    }


def test_wrappers_reject_bad_inputs():
    """On a CUDA tensor the wrapper checks before it launches; here a
    CPU/CUDA mix is what can be built without a card."""
    with pytest.raises(ValueError):
        cuda_lib.check_cuda("x", {"o": torch.zeros(3, 3)}, {}, torch.device("cuda", 0))
    with pytest.raises(ValueError):
        cuda_lib.check_cuda("x", {"o": torch.zeros(3, 3).t()}, {}, torch.device("cpu"))
    with pytest.raises(ValueError):
        cuda_lib.check_cuda("x", {"o": torch.zeros(3, 3, dtype=torch.float64)}, {},
                            torch.device("cpu"))
