"""The animation path of the port (ops/animate.py, the refit and device
build of ops/cluster.py, `set_node_transform` / `update_scene`) against
the JAX package.

Mirrors tests/test_animate.py and the refit and device-build tests of
tests/test_cluster.py on the same tables (hala_tpu's upload carried
across with `from_numpy`). Where the JAX refit lets a partly padded
cluster reach to 3e37, the port keeps the uploader's box: cluster_max
is held to JAX's on the clusters without a padding slot and, with
cluster_min and row 9 of `tri_packed`, to the uploader's rule written
out in numpy (chip_smoke.py `rule_np`) over the moved soup, bit for
bit. Renders after a
move are held to the port's render of a fresh upload of the moved host
scene (atol 2e-3, as the reference test). The caches that K1, K4 and
K6 keep per geometry must not survive a move, and a device-lost
restore must re-apply the moves.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from hala_tpu.ops import animate as janim
from hala_tpu.ops import cluster as jcluster
from hala_tpu.scene.cpu.node import Node as JNode
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import cornell_box as jcornell
from hala_tpu.scene.procedural import sponza_like as jsponza
from hala_tpu_torch.error import HalaRendererError
from hala_tpu_torch.models.integrator import Film, RenderSettings, Uniforms, render_frame
from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.models.rz_renderer import RasterizationRenderer
from hala_tpu_torch.ops import cluster, cull
from hala_tpu_torch.ops import traverse
from hala_tpu_torch.ops.animate import build_deltas, retransform_geometry
from hala_tpu_torch.ops.intersect import intersect_bruteforce
from hala_tpu_torch.ops.pallas import intersect_kernel as k1
from hala_tpu_torch.scene.cpu.node import Node
from hala_tpu_torch.scene.gpu.scene import from_numpy
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box, sponza_like

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402  (the uploader's rule written out in numpy)

_example = chip_smoke.animated_example()  # examples/torch_render_animated.py
tall_box_scene, translate = _example.tall_box_scene, _example.translate

FAR = np.float32(3.0e37)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _with_copy(scene, node_cls, dx):
    """`scene` plus a second node of its first mesh, dx along x."""
    src = next(n for n in scene.nodes if n.mesh_index is not None)
    m = np.asarray(src.world_transform, np.float32).copy()
    m[0, 3] += dx
    scene.nodes.append(node_cls(name="copy", local_transform=m,
                                world_transform=m.copy(), mesh_index=src.mesh_index))
    return scene


ROOMS = dict(rooms=(4, 4), columns_per_room=8, boxes_per_room=4)


def _two_rooms(sponza, node_cls):
    """Two copies of a sponza_like block side by side (above 4096
    triangles, so the SAH layout with partly padded clusters)."""
    return _with_copy(sponza(**ROOMS), node_cls, 40.0)


def _mesh_nodes(scene):
    return [i for i, n in enumerate(scene.nodes) if n.mesh_index is not None]


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX device scene, port device scene with the same
    tables, the node to move)."""
    out = {}
    for name, jscene in (("cornell", jcornell()),
                         ("two_rooms", _two_rooms(jsponza, JNode))):
        jdev = JUp.upload(jscene, use_ray_tracing=False)
        out[name] = (jdev, from_numpy(jdev, "cpu"), _mesh_nodes(jscene)[-1])
    return out


def _rotate_scale():
    c, s = np.cos(0.3), np.sin(0.3)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.diag([1.5, 1.0, 0.8])
    m[:3, 3] = (0.1, -0.05, 0.2)
    return m


DELTAS = {"translate": translate(0.25, 0.5, -0.125), "rotate_scale": _rotate_scale()}


def _both(scenes, name, delta):
    """The moved geometry through both packages: (JAX, port, port before)."""
    jdev, tdev, node = scenes[name]
    n_nodes = max(tdev.prim_node) + 1
    jg = janim.retransform_geometry(
        jdev.geometry, *janim.build_deltas(jdev.prim_node, {node: delta}, n_nodes))
    tg = retransform_geometry(
        tdev.geometry, *build_deltas(tdev.prim_node, {node: delta}, n_nodes, "cpu"))
    return jg, tg, tdev.geometry


def _assert_rule(g):
    """g's cluster boxes and tri_packed are the uploader's for its soup."""
    v0, e1, e2 = (x.numpy() for x in (g.tri_v0, g.tri_e1, g.tri_e2))
    cmin, cmax, row9 = chip_smoke.rule_np(v0, e1, e2, g.tri_mat.numpy() >= 0)
    np.testing.assert_array_equal(g.cluster_min.numpy(), cmin)
    np.testing.assert_array_equal(g.cluster_max.numpy(), cmax)
    np.testing.assert_array_equal(g.tri_packed[:, 9].numpy(), row9)
    c = v0.shape[0] // 128
    for row, a in ((0, v0), (3, e1), (6, e2)):
        np.testing.assert_array_equal(g.tri_packed[:, row:row + 3].numpy(),
                                      a.reshape(c, 128, 3).transpose(0, 2, 1))
    assert not g.tri_packed[:, 10:].any()


def _padded(g):
    """(C,) bool: the clusters that hold a padding slot."""
    return ~(g.tri_mat >= 0).reshape(-1, 128).all(dim=1).numpy()


# --- retransform_geometry and the refit ---------------------------------------


@pytest.mark.parametrize("delta", sorted(DELTAS))
@pytest.mark.parametrize("name", ["cornell", "two_rooms"])
def test_retransform_matches_jax(scenes, name, delta):
    jg, tg, before = _both(scenes, name, DELTAS[delta])
    real = (tg.tri_mat >= 0).numpy()
    for field, tol in (("tri_v0", 1e-5), ("tri_e1", 1e-5), ("tri_e2", 1e-5),
                       ("normals", 1e-5), ("tangents", 1e-5), ("shade_table", 1e-4)):
        # the JAX package moves padding slots with primitive 0; the port
        # leaves them at the far point
        np.testing.assert_allclose(getattr(tg, field).numpy()[real],
                                   np.asarray(getattr(jg, field))[real], atol=tol,
                                   err_msg=field)
    np.testing.assert_array_equal(tg.tri_v0.numpy()[~real], before.tri_v0.numpy()[~real])
    np.testing.assert_array_equal(tg.cluster_min.numpy(), np.asarray(jg.cluster_min))
    full = ~_padded(tg)
    np.testing.assert_array_equal(tg.cluster_max.numpy()[full],
                                  np.asarray(jg.cluster_max)[full])
    # where JAX's refit reaches to the far point, the port keeps the box
    assert (np.asarray(jg.cluster_max)[~full] == FAR).all()
    _assert_rule(tg)
    if name == "two_rooms":
        assert _padded(tg).sum() > 10  # partly padded SAH leaves
    moved = tg.tri_v0.numpy() != before.tri_v0.numpy()
    assert moved.any() and not moved[~real].any()


@pytest.mark.parametrize("name", ["cornell", "two_rooms"])
def test_identity_delta_is_noop(scenes, name):
    _, tdev, _ = scenes[name]
    g = tdev.geometry
    g2 = retransform_geometry(g, *build_deltas(tdev.prim_node, {}, 1, "cpu"))
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name), getattr(g2, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


@pytest.mark.parametrize("name", ["cornell", "two_rooms"])
def test_refit_of_the_upload_is_the_upload(scenes, name):
    """The uploader's rule, through refit_clusters and pack_slots, on the
    unmoved soup gives the JAX upload's boxes and slot blocks bit for
    bit (the padding slots' 3e37 of the JAX refit aside)."""
    jdev, tdev, _ = scenes[name]
    g = tdev.geometry
    cmin, cmax = cluster.refit_clusters(g.tri_v0, g.tri_e1, g.tri_e2, g.tri_mat)
    np.testing.assert_array_equal(cmin.numpy(), np.asarray(jdev.geometry.cluster_min))
    np.testing.assert_array_equal(cmax.numpy(), np.asarray(jdev.geometry.cluster_max))
    packed = cluster.pack_slots(g.tri_v0, g.tri_e1, g.tri_e2, g.tri_mat >= 0)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdev.geometry.tri_packed))


def test_refit_tracks_motion():
    g = SceneUploader.upload(sponza_like(rooms=(2, 2), boxes_per_room=1),
                             use_ray_tracing=False, device="cpu").geometry
    shift = torch.tensor([10.0, 0.0, 0.0])
    cmin, cmax = cluster.refit_clusters(g.tri_v0 + shift, g.tri_e1, g.tri_e2, g.tri_mat)
    real = g.cluster_min[:, 0] < 1e30
    np.testing.assert_allclose(cmin[real, 0].numpy(), (g.cluster_min[real, 0] + 10).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(cmax[real, 0].numpy(), (g.cluster_max[real, 0] + 10).numpy(),
                               rtol=1e-5)


def test_device_build_matches_jax():
    """build_cluster_tables_device: JAX's Morton order bit for bit, the
    permuted soup, cluster_min and the slot blocks' rows 0-8 equal, and
    a stream over the rebuilt tables gives brute force's hits."""
    jdev = JUp.upload(jsponza(rooms=(2, 2)), use_ray_tracing=False)
    jg, g = jdev.geometry, from_numpy(jdev, "cpu").geometry
    ref = jcluster.build_cluster_tables_device(jg.tri_v0, jg.tri_e1, jg.tri_e2,
                                               jg.num_triangles)
    got = cluster.build_cluster_tables_device(g.tri_v0, g.tri_e1, g.tri_e2, g.num_triangles)
    for i in (0, 1, 2, 3, 4):  # order, v0, e1, e2, cluster_min
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    np.testing.assert_array_equal(got[6][:, :9].numpy(), np.asarray(ref[6])[:, :9])
    real = torch.arange(g.tri_v0.shape[0]) < g.num_triangles
    full = real.reshape(-1, 128).all(dim=1).numpy()
    np.testing.assert_array_equal(got[5].numpy()[full], np.asarray(ref[5])[full])
    assert not full.all()  # the tail cluster holds padding
    rebuilt = dataclasses.replace(g, tri_v0=got[1], tri_e1=got[2], tri_e2=got[3],
                                  cluster_min=got[4], cluster_max=got[5],
                                  tri_packed=got[6], tri_mat=g.tri_mat[got[0].long()])
    _assert_rule(rebuilt)
    rs = np.random.RandomState(0)
    o = torch.tensor(np.tile([4.0, 1.5, 4.0], (512, 1)), dtype=torch.float32)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    bf = intersect_bruteforce(o, d, g.tri_v0, g.tri_e1, g.tri_e2, chunk=128)
    hit = cluster.intersect_clustered(o, d, rebuilt)
    np.testing.assert_allclose(hit.t.numpy(), bf.t.numpy(), rtol=1e-5)
    assert int((hit.tri >= 0).sum()) > 400


# --- the engines on a moved mesh ----------------------------------------------


def _batch(g, n, seed):
    rs = np.random.RandomState(seed)
    real = g.tri_v0[g.tri_mat >= 0]
    lo, hi = real.amin(0).numpy(), real.amax(0).numpy()
    o = rs.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, 3.0e38, np.float32)
    tm[1::4] = rs.uniform(0.1, 8.0, len(tm[1::4]))
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm)


@pytest.fixture(scope="module")
def moved_rooms(scenes):
    """two_rooms with its copy turned and shifted into the first block's
    neighbourhood, a batch of rays over both, and (P,) True on the
    copy's primitives."""
    _, tdev, node = scenes["two_rooms"]
    _, tg, _ = _both(scenes, "two_rooms", translate(-20.0, 0.5, 3.0) @ _rotate_scale())
    return tg, _batch(tg, 3000, 7), torch.tensor([ni == node for ni in tdev.prim_node])


@pytest.mark.parametrize("engine", ["matrix", "traverse", "cluster"])
def test_moved_mesh_hits(moved_rooms, engine):
    """"matrix" (K2), "traverse" (K4, K5, K6) and "cluster" (K6) on the
    moved tables: stream_plain bit for bit, and K1's plain version's
    triangles."""
    g, (o, d, tm), copy_prims = moved_rooms
    hit = {"matrix": lambda: traverse.intersect_matrix(o, d, g, t_max=tm),
           "traverse": lambda: traverse.intersect_traversed(o, d, g, t_max=tm),
           "cluster": lambda: cluster.intersect_clustered(o, d, g, t_max=tm)}[engine]()
    ref = cluster.stream_plain(o, d, tm, g.cluster_min, g.cluster_max, g.tri_packed)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(hit, f), getattr(ref, f)), f
    bf = k1.intersect_pallas(o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=tm)
    assert torch.equal(hit.tri, bf.tri)
    np.testing.assert_allclose(hit.t.numpy(), bf.t.numpy(), rtol=1e-6)
    tri = hit.tri[hit.tri >= 0].long()
    assert tri.numel() > 500 and int(copy_prims[g.tri_prim[tri].long()].sum()) > 100


# --- the renderer API ---------------------------------------------------------


def _settings(r):
    return RenderSettings(width=r.info.width, height=r.info.height, max_depth=r.max_depth,
                          rr_depth=r.rr_depth, tile_size=256)


def _fresh_frame(host, settings):
    dev = SceneUploader.upload(host, use_ray_tracing=False, device="cpu")
    film = Film.create(settings.width, settings.height, "cpu")
    render_frame(dev, None, Uniforms.default("cpu"), film, 0, settings)
    return film.accum


def test_moved_object_renders_at_new_position():
    """set_node_transform + update_scene moves the tall box; the frame
    equals a fresh upload of the moved host scene's."""
    scene, node, w0 = tall_box_scene()
    r = RayTracingRenderer("anim", 32, 32, max_frames=1, tile_size=256, device="cpu")
    r.set_scene(scene)
    r.commit()
    before = r.scene.geometry
    new_world = translate(0.3, 0.0, 0.2) @ w0
    r.set_node_transform(node, new_world)
    r.update_scene()
    assert r.scene.geometry is not before
    r.render_loop(1)
    img = r.film.accum

    host2, _, _ = tall_box_scene()
    host2.nodes[node].world_transform = new_world
    ref = _fresh_frame(host2, _settings(r))
    assert bool(torch.isfinite(img).all())
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-3)
    unmoved = _fresh_frame(tall_box_scene()[0], _settings(r))
    assert float((img - unmoved).abs().max()) > 0.1


def test_two_updates_compose():
    """Two updates accumulate: each delta is taken against the world
    the node is baked at, not the host's."""
    host = cornell_box()
    node = _mesh_nodes(host)[0]
    r = RayTracingRenderer("anim2", 16, 16, max_frames=1, tile_size=256, device="cpu")
    r.set_scene(host)
    r.commit()
    w0 = np.asarray(host.nodes[node].world_transform, np.float32)
    r.set_node_transform(node, translate(0.1, 0, 0) @ w0)
    r.update_scene()
    r.set_node_transform(node, translate(0.1, 0.2, 0) @ w0)
    r.update_scene()
    host2 = cornell_box()
    host2.nodes[node].world_transform = translate(0.1, 0.2, 0) @ w0
    ref = SceneUploader.upload(host2, use_ray_tracing=False, device="cpu")
    np.testing.assert_allclose(r.scene.geometry.tri_v0.numpy(),
                               ref.geometry.tri_v0.numpy(), atol=1e-4)


def test_reset_accumulation_restarts_progressive_mean():
    """After 3 frames and a reset, one more frame equals a fresh
    renderer's first frame bit for bit."""
    def renderer(name):
        r = RayTracingRenderer(name, 16, 16, max_frames=8, tile_size=256, device="cpu")
        r.set_scene(cornell_box())
        r.commit()
        return r

    r = renderer("reset")
    r.render_loop(3)
    r.reset_accumulation()
    assert float(r.film.accum.abs().max()) == 0.0
    r.render_loop(1)
    r2 = renderer("fresh")
    r2.render_loop(1)
    assert torch.equal(r.film.accum, r2.film.accum)


def test_update_scene_errors_and_noop():
    r = RayTracingRenderer("early", 8, 8, device="cpu")
    r.set_node_transform(0, np.eye(4))
    with pytest.raises(HalaRendererError, match="before set_scene"):
        r.update_scene()
    r = RayTracingRenderer("noop", 8, 8, device="cpu")
    r.set_scene(cornell_box())
    scene = r.scene
    r.update_scene()
    assert r.scene is scene


def test_rasterizer_moves_too():
    """RasterizationRenderer inherits the API: the moved image equals a
    fresh upload's."""
    def image(scene, move=None):
        r = RasterizationRenderer("rz", 48, 48, device="cpu")
        r.set_scene(scene)
        r.commit()
        if move is not None:
            r.set_node_transform(*move)
            r.update_scene()
        r.update()
        return r.get_final_image()

    scene, node, w0 = tall_box_scene()
    new_world = translate(0.3, 0.0, 0.2) @ w0
    got = image(scene, (node, new_world))
    host2, _, _ = tall_box_scene()
    host2.nodes[node].world_transform = new_world
    ref = image(host2)
    np.testing.assert_allclose(got, ref, atol=2e-3)
    assert float(np.abs(got - image(tall_box_scene()[0])).max()) > 0.1


# --- the caches that must not survive a move ----------------------------------


def _bits(x):
    """x's bits (unions hold NaN boxes for groups without near members)."""
    return x.view(torch.int32)


def test_update_scene_drops_the_cached_unions(scenes):
    """The new geometry carries none of K4's or K6's unions until a
    query builds them, and those are the moved boxes' unions."""
    _, tdev, node = scenes["two_rooms"]
    r = RayTracingRenderer("cache", 8, 8, device="cpu")
    r.scene, r._host_scene = tdev, _two_rooms(sponza_like, Node)
    g = r.scene.geometry
    old_k4 = cull.geometry_unions(g)
    old_k6 = cull.cached_on(g, "_stream_unions",
                            lambda: cluster.stream_unions(g.cluster_min, g.cluster_max))
    r.set_node_transform(node, translate(-20.0, 0.5, 3.0) @ np.asarray(
        r._host_scene.nodes[node].world_transform, np.float32))
    r.update_scene()
    g2 = r.scene.geometry
    assert not [k for k in vars(g2) if k.startswith(("_stream_unions", "_cull_unions"))]
    new_k4 = cull.geometry_unions(g2)
    want = cull.group_unions(g2.cluster_min, g2.cluster_max)
    assert len(new_k4) == 1 and torch.equal(_bits(new_k4[0]), _bits(want))
    assert not torch.equal(_bits(new_k4[0]), _bits(old_k4[0]))
    new_k6 = cull.cached_on(g2, "_stream_unions",
                            lambda: cluster.stream_unions(g2.cluster_min, g2.cluster_max))
    assert not torch.equal(_bits(new_k6), _bits(old_k6))
    assert old_k6 is cull.cached_on(g, "_stream_unions", lambda: None)


def test_first_query_after_a_move_packs_the_moved_soup():
    """K1's packed table is keyed on the tensors themselves: the first
    pack after a move is the moved soup's."""
    scene, node, w0 = tall_box_scene()
    r = RayTracingRenderer("pack", 8, 8, device="cpu")
    r.set_scene(scene)
    g = r.scene.geometry
    n = g.num_triangles
    first = k1.packed_triangles(g.tri_v0, g.tri_e1, g.tri_e2, n)
    assert k1.packed_triangles(g.tri_v0, g.tri_e1, g.tri_e2, n) is first
    r.set_node_transform(node, translate(0.3, 0.0, 0.0) @ w0)
    r.update_scene()
    g2 = r.scene.geometry
    moved = k1.packed_triangles(g2.tri_v0, g2.tri_e1, g2.tri_e2, n)
    assert torch.equal(moved, k1.pack_triangles(g2.tri_v0, g2.tri_e1, g2.tri_e2, n))
    assert not torch.equal(moved, first)


@pytest.mark.parametrize("kind", ["rt", "rz"])
def test_device_lost_restore_reapplies_the_moves(kind):
    """After a device loss the restore re-uploads the host scene and
    re-applies the recorded moves; a later move composes from there."""
    scene, node, w0 = tall_box_scene()
    cls = RayTracingRenderer if kind == "rt" else RasterizationRenderer
    r = cls("lost", 16, 16, device="cpu")
    r.set_scene(scene)
    r.set_node_transform(node, translate(0.3, 0.0, 0.0) @ w0)
    r.update_scene()
    moved = r.scene.geometry
    r.is_device_lost = True
    assert r.check_and_restore_device()
    g = r.scene.geometry
    assert g is not moved
    for f in ("tri_v0", "tri_e1", "tri_e2", "cluster_min", "cluster_max", "tri_packed"):
        assert torch.equal(getattr(g, f), getattr(moved, f)), f
    r.set_node_transform(node, translate(0.1, 0.0, 0.0) @ w0)
    r.update_scene()
    once = cls("once", 16, 16, device="cpu")
    once.set_scene(tall_box_scene()[0])
    once.set_node_transform(node, translate(0.1, 0.0, 0.0) @ w0)
    once.update_scene()
    np.testing.assert_allclose(r.scene.geometry.tri_v0.numpy(),
                               once.scene.geometry.tri_v0.numpy(), atol=1e-5)
