"""The "bvh" engine of the port against the JAX package: `sort_by_morton`,
the skip-link BVH build, its traversal and the integrator's "bvh" and
"legacy" backends.

- Bit for bit: `sort_by_morton` with repeated codes (a stable sort, as
  jnp.argsort), and the node tables of `build_bvh` on the Cornell box
  (prefix layout), a random soup and a SAH layout with interior padding
  (the same numpy calls in the same order; the subtree sizes come from
  a one-pass stack instead of the reference's ancestor scan).
- `intersect_bvh` / `occluded_bvh` on the JAX package's own node table
  (carried by `from_numpy`): triangle ids equal wherever the hit is not
  a near-tie, i.e. wherever no other triangle of the scene is hit
  within 1e-5 relative of the winner's t (coplanar and shared-edge hits,
  where XLA's CPU FMA contraction rounds t differently); t at rtol 1e-6
  and the any-hit mask equal.
- Films: 16x16 through "bvh" and "legacy" within relative RMSE 2e-3 of
  the JAX package's "bvh" film (ROADMAP's side-by-side policy), and
  "bvh" on a moved scene (no BVH) bit for bit the "bruteforce" film.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.models import integrator as jint
from hala_tpu.ops import bvh as jbvh
from hala_tpu.ops.morton import sort_by_morton as j_sort_by_morton
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import cornell_box as jcornell
from hala_tpu.scene.procedural import random_triangle_soup as jsoup
from hala_tpu.scene.procedural import sponza_like as jsponza
from hala_tpu_torch.models.integrator import (
    Film,
    RenderSettings,
    Uniforms,
    render_frame,
)
from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.ops import bvh, query
from hala_tpu_torch.ops.intersect import intersect_bruteforce
from hala_tpu_torch.ops.morton import sort_by_morton
from hala_tpu_torch.scene.gpu.scene import from_numpy
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box, random_triangle_soup, sponza_like

TIE_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


SCENES = {
    "cornell": (jcornell, cornell_box),
    "soup": (lambda: jsoup(700, seed=9), lambda: random_triangle_soup(700, seed=9)),
    "sah": (lambda: jsponza(rooms=(4, 4), columns_per_room=4, boxes_per_room=16),
            lambda: sponza_like(rooms=(4, 4), columns_per_room=4, boxes_per_room=16)),
}


@pytest.fixture(scope="module")
def uploads():
    """name -> (JAX device scene with its BVH, the port's own upload)."""
    return {name: (JUp.upload(jb(), use_ray_tracing=True),
                   SceneUploader.upload(tb(), device="cpu"))
            for name, (jb, tb) in SCENES.items()}


def _bits(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_sort_by_morton_repeated_codes():
    rs = np.random.RandomState(3)
    codes = rs.randint(0, 6, 500).astype(np.uint32)  # every code repeated
    pay_f = rs.rand(500, 3).astype(np.float32)
    pay_i = np.arange(500, dtype=np.int32)
    ref = j_sort_by_morton(jnp.asarray(codes), jnp.asarray(pay_f), jnp.asarray(pay_i))
    got = sort_by_morton(torch.from_numpy(codes.astype(np.int64)),
                         torch.from_numpy(pay_f), torch.from_numpy(pay_i))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_matches_jax_bit_for_bit(uploads, name):
    jdev, tdev = uploads[name]
    if name == "sah":
        assert not tdev.geometry.prefix_layout  # interior padding slots
    ref, got = jdev.bvh, tdev.bvh
    assert got.num_nodes == ref.num_nodes
    for f in ("node_min", "node_max", "skip", "first_tri", "tri_count", "tri_order"):
        a, b = _bits(getattr(ref, f)), _bits(getattr(got, f).numpy())
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _reference_sizes(spans):
    """The JAX build's subtree-size scan, written out."""
    sizes = np.ones(len(spans), np.int64)
    stack = []
    for i, (s, e) in enumerate(spans):
        while stack and not (spans[stack[-1]][0] <= s and e <= spans[stack[-1]][1]):
            stack.pop()
        for anc in stack:
            sizes[anc] += 1
        stack.append(i)
    return sizes


def test_subtree_sizes_match_the_reference_scan():
    # pre-order spans of a median split of 37 items into leaves of <= 4
    spans, stack = [], [(0, 37)]
    while stack:
        s, e = stack.pop()
        spans.append((s, e))
        if e - s > bvh.LEAF_SIZE:
            mid = (e - s) // 2
            stack += [(s + mid, e), (s, s + mid)]
    np.testing.assert_array_equal(bvh.subtree_sizes(spans), _reference_sizes(spans))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_skip_links_cover_every_leaf(uploads, name):
    """A walk that descends at every internal node visits every node once,
    in order, and its leaves list every real slot once."""
    _, tdev = uploads[name]
    b, g = tdev.bvh, tdev.geometry
    first, count, skip = b.first_tri.numpy(), b.tri_count.numpy(), b.skip.numpy()
    ptr, seen, slots = 0, [], []
    while ptr < b.num_nodes:
        seen.append(ptr)
        if first[ptr] >= 0:
            slots += list(b.tri_order.numpy()[first[ptr]:first[ptr] + count[ptr]])
            ptr = skip[ptr]
        else:
            ptr += 1
    assert seen == list(range(b.num_nodes))
    real = np.nonzero(g.tri_mat.numpy() >= 0)[0]
    np.testing.assert_array_equal(np.sort(slots), real)
    # a skip link leaves the subtree: never backwards, at most past the end
    assert (skip > np.arange(b.num_nodes)).all() and (skip <= b.num_nodes).all()


def _rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    o = (lo + rs.rand(n, 3) * (hi - lo)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _near_tie(o, d, g, t):
    """Rays with a second triangle hit within TIE_REL of t (brute force
    over every slot), where the winner is a matter of rounding."""
    from hala_tpu_torch.ops.intersect import ray_triangle

    tt, _, _ = ray_triangle(torch.from_numpy(o), torch.from_numpy(d),
                            g.tri_v0, g.tri_e1, g.tri_e2)
    close = (tt - t[:, None]).abs() <= TIE_REL * t.abs()[:, None]
    return close.sum(dim=1) >= 2


@pytest.mark.parametrize("name", ["sah", "soup"])
def test_intersect_bvh_matches_jax(uploads, name):
    jdev, _ = uploads[name]
    tdev = from_numpy(jdev, "cpu")  # the JAX package's own node table
    g = tdev.geometry
    real = g.tri_mat >= 0
    lo = g.tri_v0[real].amin(dim=0).numpy()
    hi = g.tri_v0[real].amax(dim=0).numpy()
    o, d = _rays(768, 5, lo, hi)
    tm = np.full(768, 3.0e38, np.float32)
    tm[::5] = 0.7
    ref = jbvh.intersect_bvh(jdev.bvh, jdev.geometry, jnp.asarray(o), jnp.asarray(d),
                             t_max=jnp.asarray(tm))
    got = bvh.intersect_bvh(tdev.bvh, g, torch.from_numpy(o), torch.from_numpy(d),
                            t_max=torch.from_numpy(tm))
    assert bvh.walk_stats.steps > 0
    rtri, rt = np.asarray(ref.tri), np.asarray(ref.t)
    np.testing.assert_array_equal(got.tri.numpy() >= 0, rtri >= 0)
    differ = got.tri.numpy() != rtri
    tie = _near_tie(o, d, g, got.t).numpy()
    assert not (differ & ~tie).any(), int((differ & ~tie).sum())
    np.testing.assert_allclose(got.t.numpy(), rt, rtol=1e-6)
    # and the brute force over all slots: the same winners but at ties
    bf = intersect_bruteforce(torch.from_numpy(o), torch.from_numpy(d), g.tri_v0,
                              g.tri_e1, g.tri_e2, t_max=torch.from_numpy(tm))
    differ = (got.tri != bf.tri).numpy()
    assert not (differ & ~tie).any()
    # any hit: the same mask as the JAX query
    tf = (np.where(rtri >= 0, rt, 2.0) * 1.5).astype(np.float32)
    occ_ref = np.asarray(jbvh.occluded_bvh(jdev.bvh, jdev.geometry, jnp.asarray(o),
                                           jnp.asarray(d), jnp.asarray(tf)))
    occ = bvh.occluded_bvh(tdev.bvh, g, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tf))
    np.testing.assert_array_equal(occ.numpy(), occ_ref)


def _rel_rmse(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-12))


def test_bvh_and_legacy_films_match_jax(uploads):
    jdev, tdev = uploads["cornell"]
    kw = dict(width=16, height=16, max_depth=3, rr_depth=2, tile_size=256)
    jfilm = jint.Film.create(16, 16)
    jfilm, _ = jint.render_frame(jdev, None, jint.Uniforms.default(), jfilm, 0,
                                 jint.RenderSettings(**kw, intersector="bvh"))
    for sel in ("bvh", "legacy"):
        s = RenderSettings(**kw, intersector=sel, use_bvh=True)
        assert query.resolve(s, tdev).engine == "bvh"
        film = Film.create(16, 16, "cpu")
        render_frame(tdev, None, Uniforms.default("cpu"), film, 0, s)
        for k in ("accum", "albedo", "normal"):
            rel = _rel_rmse(getattr(film, k).numpy(), getattr(jfilm, k))
            assert rel < 2e-3, (sel, k, rel)


def test_moved_scene_drops_the_bvh():
    """update_scene drops the node table, as the JAX package does: "bvh"
    then renders through the brute force, bit for bit."""
    films = {}
    for sel in ("bvh", "bruteforce"):
        r = RayTracingRenderer(sel, 16, 16, max_depth=3, tile_size=256,
                               intersector=sel, device="cpu")
        host = cornell_box()
        r.set_scene(host)
        assert r.scene.bvh is not None
        node = next(i for i, n in enumerate(host.nodes) if n.mesh_index is not None)
        world = np.asarray(host.nodes[node].world_transform, np.float32).copy()
        world[:3, 3] += (0.05, 0.0, 0.02)
        r.set_node_transform(node, world)
        r.update_scene()
        assert r.scene.bvh is None
        r.commit()
        assert query.resolve(r.settings, r.scene).engine == "bruteforce"
        r.update()
        r.render()
        films[sel] = r.film.accum
    assert torch.equal(films["bvh"], films["bruteforce"])


def test_renderer_use_bvh_flag():
    r = RayTracingRenderer("no_bvh", 8, 8, use_bvh=False, intersector="legacy",
                           device="cpu")
    r.set_scene(cornell_box())
    r.commit()
    assert r.scene.bvh is None and not r.settings.use_bvh
    assert query.resolve(r.settings, r.scene).engine == "bruteforce"


def test_upload_flags_as_the_reference():
    host = cornell_box()
    assert SceneUploader.upload(host, device="cpu").bvh is not None
    dev = SceneUploader.upload(host, use_mesh_shader=True, use_global_meshlets=True,
                               use_ray_tracing=False, device="cpu")
    assert dev.bvh is None and dev.meshlets is not None


def test_atrium_bvh_camera_rays_match_bruteforce():
    """atrium.glb (SAH layout): the node table of the port's upload and
    every camera ray's winner against the brute force over all slots,
    equal but at near-ties."""
    from hala_tpu_torch.ops.camera import generate_rays
    from hala_tpu_torch.scene.cpu.scene import Scene

    host = Scene.load(os.path.join(os.path.dirname(__file__), "..", "assets", "atrium.glb"))
    dev = SceneUploader.upload(host, device="cpu")
    assert dev.bvh.num_nodes > 1000
    w, h = 24, 16
    pix = torch.arange(w * h)
    half = torch.full((w * h, 2), 0.5)
    o, d = generate_rays(dev.cameras, 0, (pix % w).float(), (pix // w).float(), w, h,
                         half, half)
    g = dev.geometry
    got = bvh.intersect_bvh(dev.bvh, g, o, d)
    bf = intersect_bruteforce(o, d, g.tri_v0, g.tri_e1, g.tri_e2)
    tie = _near_tie(o.numpy(), d.numpy(), g, bf.t)
    assert not ((got.tri != bf.tri) & ~tie).any()
    assert int((bf.tri >= 0).sum()) > w * h // 2
