"""The query options that close the port, against the JAX package:
`traverse_query`, `intersect_traversed(exact=False)`,
`matrix_query(sort_key="signature")` and `intersect_wavefront(fallback=,
canonical=)`. hala_tpu's Pallas kernels run in interpret mode, as
tests/test_traverse.py and tests/test_wavefront.py run them; on the CPU
the port's wrappers run their kernels' plain versions.

Geometry: the 6x6-room sponza_like of tests/test_torch_traverse.py (63
clusters), where lists truncate at K 2-4 and the options matter.

- Against the JAX package, by the statements of the files above:
  triangle ids equal, t at rtol 1e-5 and u, v at atol 1e-5 for the
  exact queries and `exact=False` (classic Moller-Trumbore); for the
  wavefront's own t/u/v (`canonical=False`, the factored test) winners
  may flip at near-ties (|dt| < 1e-4) and nothing else, t at rtol 1e-6
  where they agree.
- Within the port, bit for bit: `traverse_query` equals
  `intersect_traversed`, the signature sort equals the Morton sort,
  and each inexact option equals its exact query wherever it resolved
  the ray (and is never closer elsewhere).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.ops import traverse as j_traverse
from hala_tpu.ops import wavefront as j_wavefront
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import sponza_like
from hala_tpu_torch.ops import traverse as k5
from hala_tpu_torch.ops import wavefront as k7
from hala_tpu_torch.scene.gpu.scene import from_numpy

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rooms():
    jdev = JUp.upload(sponza_like(rooms=(6, 6), columns_per_room=8, boxes_per_room=4),
                      use_ray_tracing=False)
    return jdev.geometry, from_numpy(jdev, "cpu").geometry


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _batch(g, n, seed):
    """Rays inside the scene's bounds, a quarter of them bounded and some
    dead (tests/test_torch_traverse.py `_batch` without the axis rays)."""
    rs = np.random.RandomState(seed)
    real = g.tri_v0[g.tri_mat >= 0]
    lo, hi = real.amin(0).numpy(), real.amax(0).numpy()
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.1, 4.0, len(tm[1::4]))
    tm[::13] = 0.0
    return o, d, tm


def _assert_hits(ours, ref):
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=TOL)
    m = np.asarray(ref.tri) >= 0
    for a, b in ((ours.u, ref.u), (ours.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], atol=TOL)


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _inexact_vs_exact(rough, exact):
    """An option that skips the exact fallback: equal bits wherever it
    found the exact winner, never a closer hit elsewhere; returns the
    rays it left unresolved."""
    same = rough.tri == exact.tri
    _bits_equal([x[same] for x in rough], [x[same] for x in exact])
    hit = exact.tri >= 0
    assert bool((rough.t[~same & hit] >= exact.t[~same & hit]).all())
    return int((~same).sum())


def test_traverse_query_matches_jax_and_intersect_traversed(rooms):
    jg, g = rooms
    o, d, tm = _batch(g, 1024, 3)
    ref = j_traverse.traverse_query(jnp.asarray(o), jnp.asarray(d), jg, t_max=jnp.asarray(tm),
                                    k_per_ray=4, interpret=True)
    ours = k5.traverse_query(_t(o), _t(d), g, t_max=_t(tm), k_per_ray=4)
    _assert_hits(ours, ref)
    _bits_equal(ours, k5.intersect_traversed(_t(o), _t(d), g, t_max=_t(tm), k_per_ray=4))


def test_intersect_traversed_inexact_matches_jax(rooms):
    """exact=False: K5's hits as they stand, the K6 fallback skipped."""
    jg, g = rooms
    o, d, tm = _batch(g, 1024, 5)
    ref = j_traverse.intersect_traversed(jnp.asarray(o), jnp.asarray(d), jg,
                                         t_max=jnp.asarray(tm), k_per_ray=2, exact=False,
                                         interpret=True)
    ours = k5.intersect_traversed(_t(o), _t(d), g, t_max=_t(tm), k_per_ray=2, exact=False)
    _assert_hits(ours, ref)
    exact = k5.intersect_traversed(_t(o), _t(d), g, t_max=_t(tm), k_per_ray=2)
    assert _inexact_vs_exact(ours, exact) > 0  # at K 2 some rays stay unresolved
    _bits_equal(k5.traverse_query(_t(o), _t(d), g, t_max=_t(tm), k_per_ray=2, exact=False),
                ours)


@pytest.mark.parametrize("any_hit", [False, True])
def test_matrix_query_signature_sort(rooms, any_hit):
    """The signature order changes which rays share a K2 block, never a
    hit: bit for bit the Morton-sorted query (closest; the any-hit mask),
    and the JAX signature query's triangles."""
    jg, g = rooms
    o, d, tm = _batch(g, 1024, 7)
    if any_hit:
        tm = np.minimum(tm, 2.5).astype(np.float32)
    sig = k5.matrix_query(_t(o), _t(d), g, t_max=_t(tm), any_hit=any_hit,
                          sort_key="signature")
    base = k5.matrix_query(_t(o), _t(d), g, t_max=_t(tm), any_hit=any_hit)
    if any_hit:
        assert torch.equal(sig.tri >= 0, base.tri >= 0)
        return
    _bits_equal(sig, base)
    ref = j_traverse.matrix_query(jnp.asarray(o), jnp.asarray(d), jg, t_max=jnp.asarray(tm),
                                  interpret=True, sort_key="signature")
    _assert_hits(sig, ref)
    with pytest.raises(ValueError):
        k5.matrix_query(_t(o), _t(d), g, sort_key="hilbert")


def test_wavefront_without_fallback_or_canonical_matches_jax(rooms):
    jg, g = rooms
    o, d, tm = _batch(g, 1024, 9)
    kw = dict(k_per_ray=3, m_group=8)
    ref = j_wavefront.intersect_wavefront(jnp.asarray(o), jnp.asarray(d), jg,
                                          t_max=jnp.asarray(tm), interpret=True,
                                          fallback=False, canonical=False, **kw)
    ours = k7.intersect_wavefront(_t(o), _t(d), g, t_max=_t(tm), fallback=False,
                                  canonical=False, **kw)
    tri, rtri = ours.tri.numpy(), np.asarray(ref.tri)
    np.testing.assert_array_equal(tri >= 0, rtri >= 0)
    same = tri == rtri
    assert np.abs(ours.t.numpy() - np.asarray(ref.t))[~same].max(initial=0.0) < 1e-4
    np.testing.assert_allclose(ours.t.numpy()[same], np.asarray(ref.t)[same], rtol=1e-6)
    # within the port: the exact query wherever the walk resolved the ray
    exact = k7.intersect_wavefront(_t(o), _t(d), g, t_max=_t(tm), **kw)
    canon = k7.intersect_wavefront(_t(o), _t(d), g, t_max=_t(tm), fallback=False, **kw)
    assert _inexact_vs_exact(canon, exact) > 0
    assert torch.equal(ours.tri, canon.tri)
    kept = k7.intersect_wavefront(_t(o), _t(d), g, t_max=_t(tm), canonical=False, **kw)
    assert torch.equal(kept.tri, exact.tri)
