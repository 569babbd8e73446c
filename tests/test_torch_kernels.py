"""The two kernels of the port's main path, against the JAX package.

K1 (`ops/pallas/intersect_kernel.py`, csrc/intersect_bruteforce.cu) and
K2 (`ops/traverse.py`, csrc/matrix_traverse.cu): on the CPU each
wrapper runs its plain PyTorch version, which is held here against
hala_tpu's Pallas kernels run in interpret mode (as tests/test_pallas.py
and tests/test_traverse.py run them) and against its brute force.
Triangle ids are equal; t/u/v agree within rtol/atol 1e-5 (the
tolerance tests/test_traverse.py holds the TPU kernels to).

The kernels themselves are compared with their plain versions on the
card by tests/test_torch_cuda.py.
"""

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
    intersect_clustered(_t(o), _t(d), sdev.geometry)
    assert cuda_lib.launches() == {
        "intersect_bruteforce": 0, "matrix_traverse": 0, "raster_tiled": 0,
        "cull_topk": 0, "traverse_candidates": 0, "cluster_stream": 0,
        "grouped_walk": 0, "wavefront_walk": 0,
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
