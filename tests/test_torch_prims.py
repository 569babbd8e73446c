"""Procedural spheres in the port against the JAX package.

Mirrors tests/test_prims.py (all but the staged dispatcher's test: the
port has no staged dispatcher): the sphere queries of ops/prims.py on
the same inputs through both packages (ids exact, t/u/v at 1e-6), the
sphere renders' properties, and side-by-side renders held to hala_tpu
at relative RMSE below 2e-3 (the BASELINE.md policy): examples/
render_procedural.py's Cornell scene with its three spheres through
the brute-force backend (hala_tpu's Pallas kernel in interpret mode),
and a small SAH scene with spheres through "matrix" and "traverse".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.models import integrator as jint
from hala_tpu.ops import prims as jprims
from hala_tpu.ops.intersect import Hit as JHit
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import cornell_box as jcornell
from hala_tpu.scene.procedural import sponza_like as jsponza
from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.ops import prims
from hala_tpu_torch.ops.intersect import T_MAX, Hit
from hala_tpu_torch.scene.cpu.material import Material
from hala_tpu_torch.scene.cpu.prims import ProceduralSphere
from hala_tpu_torch.scene.gpu.scene import from_numpy
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tables(centers, radii, mats):
    """The same sphere table for both packages: (JAX, torch)."""
    centers = np.array(centers, np.float32).reshape(-1, 3)
    radii = np.array(radii, np.float32)
    mats = np.array(mats, np.int32)
    packed = np.zeros((centers.shape[0], 8), np.float32)
    packed[:, 0:3], packed[:, 3], packed[:, 4] = centers, radii, mats
    j = jprims.DeviceProcedural(center=jnp.asarray(centers), radius=jnp.asarray(radii),
                                mat=jnp.asarray(mats), packed=jnp.asarray(packed),
                                num_prims=centers.shape[0])
    t = prims.DeviceProcedural(center=torch.from_numpy(centers),
                               radius=torch.from_numpy(radii), mat=torch.from_numpy(mats),
                               packed=torch.from_numpy(packed), num_prims=centers.shape[0])
    return j, t


def _both(fn_name, j, t, o, d, *args):
    """Run ops/prims.`fn_name` of both packages on numpy rays."""
    jout = getattr(jprims, fn_name)(j, jnp.asarray(o), jnp.asarray(d), *args)
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
             for a in args]
    tout = getattr(prims, fn_name)(t, torch.from_numpy(o), torch.from_numpy(d), *targs)
    return jout, tout


def _hold(jhit, thit):
    np.testing.assert_array_equal(thit.tri.numpy(), np.asarray(jhit.tri))
    for a, b in ((thit.t, jhit.t), (thit.u, jhit.u), (thit.v, jhit.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _f32(x):
    return np.asarray(x, np.float32)


class TestSphereIntersection:
    def test_closed_form(self):
        j, t = _tables([[0.0, 0.0, 5.0]], [1.0], [0])
        o, d = _f32([[0, 0, 0], [3, 0, 0]]), _f32([[0, 0, 1], [0, 0, 1]])
        jh, th = _both("intersect_spheres", j, t, o, d)
        _hold(jh, th)
        assert abs(float(th.t[0]) - 4.0) < 1e-5 and int(th.tri[0]) == prims.PROC_BASE
        assert int(th.tri[1]) == -1 and float(th.t[1]) == float(np.float32(T_MAX))

    def test_inside_hits_far_side(self):
        j, t = _tables([[0.0, 0.0, 0.0]], [2.0], [0])
        jh, th = _both("intersect_spheres", j, t, _f32([[0, 0, 0]]), _f32([[1, 0, 0]]))
        _hold(jh, th)
        assert abs(float(th.t[0]) - 2.0) < 1e-5

    def test_closest_of_two(self):
        j, t = _tables([[0, 0, 5.0], [0, 0, 3.0]], [0.5, 0.5], [0, 1])
        jh, th = _both("intersect_spheres", j, t, _f32([[0, 0, 0]]), _f32([[0, 0, 1]]))
        _hold(jh, th)
        assert int(th.tri[0]) == prims.PROC_BASE + 1

    def test_t_max_excludes(self):
        j, t = _tables([[0.0, 0.0, 5.0]], [1.0], [0])
        jh, th = _both("intersect_spheres", j, t, _f32([[0, 0, 0]]), _f32([[0, 0, 1]]),
                       3.0)
        _hold(jh, th)
        assert int(th.tri[0]) == -1

    def test_occluded_window(self):
        j, t = _tables([[0.0, 0.0, 5.0]], [1.0], [0])
        o, d = _f32([[0, 0, 0], [0, 0, 0]]), _f32([[0, 0, 1], [0, 1, 0]])
        for t_far, want in ((10.0, [True, False]), (3.0, [False, False])):
            jo, to = _both("occluded_spheres", j, t, o, d, jnp.float32(t_far))
            assert to.tolist() == np.asarray(jo).tolist() == want

    def test_merge_prefers_closer_triangle(self):
        j, t = _tables([[0.0, 0.0, 5.0]], [1.0], [0])
        o, d = _f32([[0, 0, 0]]), _f32([[0, 0, 1]])
        for t_tri, want in ((2.0, 7), (9.0, prims.PROC_BASE), (4.0, 7)):
            jh = JHit(t=jnp.asarray([t_tri], jnp.float32), tri=jnp.asarray([7], jnp.int32),
                      u=jnp.asarray([0.1], jnp.float32), v=jnp.asarray([0.2], jnp.float32))
            th = Hit(t=torch.tensor([t_tri]), tri=torch.tensor([7], dtype=torch.int32),
                     u=torch.tensor([0.1]), v=torch.tensor([0.2]))
            if t_tri == 4.0:  # a triangle at the sphere's exact t is kept
                t_sph = float(prims.intersect_spheres(t, torch.from_numpy(o),
                                                      torch.from_numpy(d)).t[0])
                jh = jh._replace(t=jnp.asarray([t_sph], jnp.float32))
                th = th._replace(t=torch.tensor([t_sph]))
            jm = jprims.merge_procedural(j, jnp.asarray(o), jnp.asarray(d), jh)
            tm = prims.merge_procedural(t, torch.from_numpy(o), torch.from_numpy(d), th)
            _hold(jm, tm)
            assert int(tm.tri[0]) == want

    def test_random_rays_and_spheres(self):
        """Seeded rays against 24 spheres (ties between copies of one
        sphere included), with and without t_max, and the merge."""
        rs = np.random.RandomState(5)
        centers = rs.uniform(-3, 3, (24, 3))
        centers[12:14] = centers[3]  # exact copies: the first one wins
        radii = rs.uniform(0.2, 1.0, 24)
        radii[12:14] = radii[3]
        j, t = _tables(centers, radii, np.arange(24) % 5)
        n = 4096
        o = _f32(rs.uniform(-4, 4, (n, 3)))
        d = rs.normal(size=(n, 3))
        d = _f32(d / np.linalg.norm(d, axis=1, keepdims=True))
        tm = _f32(rs.uniform(0.5, 6.0, n))
        jh, th = _both("intersect_spheres", j, t, o, d)
        _hold(jh, th)
        assert int((th.tri >= 0).sum()) > 500
        assert not bool(((th.tri - prims.PROC_BASE == 12) | (th.tri - prims.PROC_BASE == 13)).any())
        jh, th = _both("intersect_spheres", j, t, o, d, tm)
        _hold(jh, th)
        jo, to = _both("occluded_spheres", j, t, o, d, tm)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        tri_t = _f32(rs.uniform(0.5, 8.0, n))
        jm = jprims.merge_procedural(j, jnp.asarray(o), jnp.asarray(d), JHit(
            t=jnp.asarray(tri_t), tri=jnp.arange(n, dtype=jnp.int32),
            u=jnp.zeros(n), v=jnp.zeros(n)))
        tmg = prims.merge_procedural(t, torch.from_numpy(o), torch.from_numpy(d), Hit(
            t=torch.from_numpy(tri_t), tri=torch.arange(n, dtype=torch.int32),
            u=torch.zeros(n), v=torch.zeros(n)))
        _hold(jm, tmg)


def _with_sphere(build, radius=0.35, emissive=False):
    """Cornell box (`build`: either package's) and a procedural sphere in
    the middle, for that package."""
    scene = build()
    mat = type(scene.materials[0])()
    mat.base_color = np.array([0.2, 0.4, 0.9], np.float32)
    if emissive:
        mat.emission = np.array([4.0, 4.0, 4.0], np.float32)
    scene.materials.append(mat)
    sphere = ProceduralSphere if build is cornell_box else jprims_sphere()
    scene.procedurals.append(sphere(center=(0.0, 0.0, 0.0), radius=radius,
                                    material=len(scene.materials) - 1))
    return scene


def jprims_sphere():
    from hala_tpu.scene.cpu.prims import ProceduralSphere as JSphere

    return JSphere


class TestProceduralRender:
    def _render(self, scene, frames=2, size=48, tile=None):
        r = RayTracingRenderer("prim", size, size, max_frames=frames,
                               tile_size=tile or size * size, device="cpu")
        r.set_scene(scene)
        r.commit()
        r.render_loop(frames)
        return r

    def test_sphere_visible_in_albedo(self):
        alb = self._render(_with_sphere(cornell_box)).film.albedo.numpy()[:, :, :3]
        h, w = alb.shape[:2]
        center = alb[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2]
        assert center[..., 2].mean() > 1.5 * center[..., 0].mean()

    def test_sphere_casts_shadow(self):
        img0 = self._render(cornell_box()).get_final_image()
        img1 = self._render(_with_sphere(cornell_box)).get_final_image()
        h, w = img0.shape[:2]
        floor0 = img0[int(h * 0.88):, w // 2 - 4:w // 2 + 4].mean()
        floor1 = img1[int(h * 0.88):, w // 2 - 4:w // 2 + 4].mean()
        assert floor1 < floor0 * 0.9, (floor0, floor1)

    def test_emissive_sphere_lights_scene(self):
        img = self._render(_with_sphere(cornell_box, emissive=True)).get_final_image()
        h, w = img.shape[:2]
        assert img[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2].mean() > 0.5

    def test_no_procedural_uploads_none(self):
        assert SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu").procedural is None

    def test_film_tiling_bit_identity(self):
        """Sphere hits are pure functions of (o, d): a tiled frame equals
        the one-tile frame bit for bit."""
        a = self._render(_with_sphere(cornell_box), frames=1, size=32, tile=1024)
        b = self._render(_with_sphere(cornell_box), frames=1, size=32, tile=256)
        assert torch.equal(a.film.accum, b.film.accum)


def _procedural_example(build, material, sphere):
    """examples/render_procedural.py's scene for one package."""
    scene = build()
    blue = material(base_color=np.array([0.2, 0.4, 0.9], np.float32))
    metal = material(type=type(blue.type).DISNEY,
                     base_color=np.array([0.95, 0.85, 0.6], np.float32),
                     metallic=1.0, roughness=0.15)
    glow = material(base_color=np.array([1.0, 1.0, 1.0], np.float32),
                    emission=np.array([6.0, 3.0, 1.5], np.float32))
    for mat, center, radius in ((blue, (-0.45, -0.65, 0.1), 0.35),
                                (metal, (0.45, -0.7, -0.2), 0.30),
                                (glow, (0.0, 0.35, -0.4), 0.15)):
        scene.materials.append(mat)
        scene.procedurals.append(sphere(center=center, radius=radius,
                                        material=len(scene.materials) - 1))
    return scene


def _rel_rmse(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)), 1e-12))


def _side_by_side(jscene, engine, frames, size, depth, **kw):
    """One scene through both packages' render_frame (hala_tpu's Pallas
    kernels in interpret mode, the port's plain versions): the relative
    RMSE of each film plane, and the port's film."""
    js = jint.RenderSettings(width=size, height=size, max_depth=depth, rr_depth=2,
                             tile_size=size * size, intersector=engine,
                             interpret_pallas=True, **kw)
    jdev = JUp.upload(jscene, use_ray_tracing=False)
    jfilm = jint.Film.create(size, size)
    for f in range(frames):
        jfilm, _ = jint.render_frame(jdev, None, jint.Uniforms.default(), jfilm, f, js)
    tdev = from_numpy(jdev, "cpu")
    assert tdev.procedural is not None
    ts = tint.RenderSettings(width=size, height=size, max_depth=depth, rr_depth=2,
                             tile_size=size * size, intersector=engine, **kw)
    tfilm = tint.Film.create(size, size, "cpu")
    for f in range(frames):
        tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), tfilm, f, ts)
    return {k: _rel_rmse(getattr(tfilm, k).numpy(), getattr(jfilm, k))
            for k in ("accum", "albedo", "normal")}, tfilm


def test_procedural_example_side_by_side_with_jax():
    """examples/render_procedural.py's Cornell box with its three spheres
    (diffuse, Disney metal, emissive), 32x32, depth 6, two frames."""
    from hala_tpu.scene.cpu.material import Material as JMaterial

    scene = _procedural_example(jcornell, JMaterial, jprims_sphere())
    rel, film = _side_by_side(scene, "pallas", 2, 32, 6)
    for k, r in rel.items():
        assert r < 2e-3, (k, r)
    # the port's own upload of its own scene gives the same film
    tdev = SceneUploader.upload(_procedural_example(cornell_box, Material,
                                                    ProceduralSphere), use_ray_tracing=False, device="cpu")
    own = tint.Film.create(32, 32, "cpu")
    ts = tint.RenderSettings(width=32, height=32, max_depth=6, rr_depth=2, tile_size=1024,
                             intersector="pallas")
    for f in range(2):
        tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), own, f, ts)
    assert torch.equal(own.accum, film.accum)


def _sah_with_spheres():
    """A small SAH scene (tests/test_traverse.py's geometry) with three
    spheres between its walls."""
    from hala_tpu.scene.cpu.material import Material as JMaterial

    scene = jsponza(rooms=(2, 2), columns_per_room=4, boxes_per_room=2)
    lo = np.min([p.positions.min(0) for m in scene.meshes for p in m.primitives], 0)
    hi = np.max([p.positions.max(0) for m in scene.meshes for p in m.primitives], 0)
    span = hi - lo
    sphere = jprims_sphere()
    for i, (fx, fz, r) in enumerate(((0.3, 0.4, 0.08), (0.6, 0.5, 0.12), (0.5, 0.7, 0.05))):
        scene.materials.append(JMaterial(
            base_color=np.array([0.2 + 0.3 * i, 0.5, 0.9 - 0.3 * i], np.float32)))
        scene.procedurals.append(sphere(
            center=tuple(float(x) for x in lo + span * np.array([fx, 0.3, fz])),
            radius=float(r * span.max()), material=len(scene.materials) - 1))
    return scene


@pytest.mark.parametrize("engine", ["matrix", "traverse"])
def test_sah_scene_with_spheres_side_by_side_with_jax(engine):
    """16x16, depth 2, one frame through the cluster backends (K2's
    plain version; K4, K5, K6's), against hala_tpu's frame."""
    rel, film = _side_by_side(_sah_with_spheres(), engine, 1, 16, 2, traverse_k=2)
    for k, r in rel.items():
        assert r < 2e-3, (k, r)
    assert float(film.accum[..., :3].mean()) > 0.05


def test_sphere_ids_and_shading_rows_clip_on_every_table():
    """A sphere hit's id (>= 2^24) never indexes a triangle table: the
    sphere-only pixels of a primary-hit frame shade from the sphere's
    own material (its albedo AOV is the sphere's base color)."""
    scene = _with_sphere(cornell_box, radius=0.5)
    tdev = SceneUploader.upload(scene, use_ray_tracing=False, device="cpu")
    film = tint.Film.create(16, 16, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 0,
                      tint.RenderSettings(width=16, height=16, max_depth=1))
    assert np.allclose(film.albedo[8, 8, :3].numpy(), [0.2, 0.4, 0.9], atol=1e-6)
