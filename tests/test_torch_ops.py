"""Per-op parity: every ported op module of hala_tpu_torch against its
hala_tpu counterpart on identical numpy inputs (made from a seed).

Tolerances: integers (RNG bits, triangle ids, light ids) are equal;
floats agree within rtol 1e-5, with atol 1e-6 for unit-scale values
(directions, barycentrics, colors), where a relative bound means
nothing at zero crossings.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hala_tpu.ops.bsdf as jb
import hala_tpu.ops.camera as jcam
import hala_tpu.ops.env as jenv
import hala_tpu.ops.intersect as ji
import hala_tpu.ops.lights as jl
import hala_tpu.ops.rng as jr
import hala_tpu.ops.sampling as jsm
import hala_tpu.ops.texture as jtex
import hala_tpu.ops.tonemap as jtm
import hala_tpu_torch.ops.bsdf as tb
import hala_tpu_torch.ops.camera as tcam
import hala_tpu_torch.ops.env as tenv
import hala_tpu_torch.ops.intersect as ti
import hala_tpu_torch.ops.lights as tl
import hala_tpu_torch.ops.rng as tr
import hala_tpu_torch.ops.sampling as tsm
import hala_tpu_torch.ops.texture as ttex
import hala_tpu_torch.ops.tonemap as ttm
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu_torch.scene.loader.uploader import SceneUploader as TUp


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    more threads per worker only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6


def close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        t.numpy() if isinstance(t, torch.Tensor) else t,
        np.asarray(j), rtol=rtol, atol=atol, err_msg=what,
    )


def both(a):
    """numpy -> (torch tensor, jax array) with the same values."""
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# --- rng ----------------------------------------------------------------


def test_pcg4d_bit_exact_including_high_bit():
    rs = np.random.RandomState(0)
    v = rs.randint(0, 2**32, size=(4096, 4), dtype=np.uint64)
    v[:8] = [2**32 - 1, 2**31, 2**31 + 7, 0xDEADBEEF]  # >= 2^31 on purpose
    out_t = tr.pcg4d(torch.from_numpy(v.astype(np.int64)))
    out_j = np.asarray(jr.pcg4d(jnp.asarray(v.astype(np.uint32))))
    np.testing.assert_array_equal(out_t.numpy(), out_j.astype(np.int64))


def test_sample4_bit_exact():
    rs = np.random.RandomState(1)
    pix = rs.randint(0, 2**31 - 1, size=2048).astype(np.int64)
    pix[:4] = [0, 1, 2**31 - 2, 1920 * 1088 - 1]
    for frame, bounce, seed in ((0, 0, 0), (7, 3, 19), (2**32 - 5, 1, 53)):
        t = tr.sample4(torch.from_numpy(pix), frame, bounce, seed)
        j = jr.sample4(jnp.asarray(pix.astype(np.int32)), np.uint32(frame),
                       bounce, seed)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert float(t.max()) < 1.0 and float(t.min()) >= 0.0
    # per-ray frame indices (spp > 1 virtual frames)
    fr = rs.randint(0, 2**32, size=2048, dtype=np.uint64)
    t = tr.sample4(torch.from_numpy(pix), torch.from_numpy(fr.astype(np.int64)), 2, 11)
    j = jr.sample4(jnp.asarray(pix.astype(np.int32)), jnp.asarray(fr.astype(np.uint32)), 2, 11)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --- camera ---------------------------------------------------------------


def _camera_scenes():
    from hala_tpu.scene.cpu.camera import OrthographicCamera as JO
    from hala_tpu.scene.cpu.camera import PerspectiveCamera as JP
    from hala_tpu.scene.procedural import cornell_box as jc
    from hala_tpu_torch.scene.cpu.camera import OrthographicCamera as TO
    from hala_tpu_torch.scene.cpu.camera import PerspectiveCamera as TP
    from hala_tpu_torch.scene.procedural import cornell_box as tc

    out = {}
    for name, jcam_, tcam_ in (
        ("pinhole", None, None),
        ("dof", JP(yfov=0.6, focal_distance=3.0, aperture=0.2),
         TP(yfov=0.6, focal_distance=3.0, aperture=0.2)),
        ("ortho", JO(xmag=1.2, ymag=0.9), TO(xmag=1.2, ymag=0.9)),
    ):
        js, ts = jc(), tc()
        if jcam_ is not None:
            js.cameras, ts.cameras = [jcam_], [tcam_]
        out[name] = (JUp.upload(js, use_ray_tracing=False), TUp.upload(ts, use_ray_tracing=False, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["pinhole", "dof", "ortho"])
def test_generate_rays(kind):
    jdev, tdev = _camera_scenes()[kind]
    rs = np.random.RandomState(2)
    w, h = 40, 24
    px = rs.randint(0, w, 500).astype(np.float32)
    py = rs.randint(0, h, 500).astype(np.float32)
    jit = rs.uniform(0, 1, (500, 4)).astype(np.float32)
    ot, dt = tcam.generate_rays(
        tdev.cameras, 0, torch.from_numpy(px), torch.from_numpy(py), w, h,
        torch.from_numpy(jit[:, :2]), torch.from_numpy(jit[:, 2:]),
    )
    oj, dj = jcam.generate_rays(
        jdev.cameras, 0, jnp.asarray(px), jnp.asarray(py), w, h,
        jnp.asarray(jit[:, :2]), jnp.asarray(jit[:, 2:]),
    )
    close(ot, oj, what="origin")
    close(dt, dj, what="direction")


# --- sampling -------------------------------------------------------------


def _sampling_cases(rs, n=512):
    u1 = rs.uniform(0, 1, n).astype(np.float32)
    u2 = rs.uniform(0, 1, n).astype(np.float32)
    nrm = unit(rs, n)
    wo = unit(rs, n)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = unit(rs, n)
    ax = rs.uniform(0.05, 1.0, n).astype(np.float32)
    ay = rs.uniform(0.05, 1.0, n).astype(np.float32)
    cmax = rs.uniform(-0.5, 0.99, n).astype(np.float32)
    g = rs.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:32] = 0.0  # isotropic branch
    eta = rs.uniform(0.6, 2.0, n).astype(np.float32)
    pdf_a = rs.uniform(0, 5, n).astype(np.float32)
    pdf_b = rs.uniform(0, 5, n).astype(np.float32)
    a_cc = rs.uniform(0.01, 0.1, n).astype(np.float32)
    return {
        "build_basis": ("build_basis", (nrm,)),
        "cosine_sample_hemisphere": ("cosine_sample_hemisphere", (u1, u2)),
        "uniform_sample_sphere": ("uniform_sample_sphere", (u1, u2)),
        "uniform_sample_cone": ("uniform_sample_cone", (u1, u2, cmax)),
        "sample_ggx_vndf": ("sample_ggx_vndf", (wo, ax, ay, u1, u2)),
        "ggx_d": ("ggx_d", (wi, ax, ay)),
        "ggx_g1": ("ggx_g1", (wi, ax, ay)),
        "ggx_g2": ("ggx_g2", (wo, wi, ax, ay)),
        "gtr1_d": ("gtr1_d", (wi[:, 2], a_cc)),
        "sample_gtr1": ("sample_gtr1", (a_cc, u1, u2)),
        "sample_henyey_greenstein": ("sample_henyey_greenstein", (nrm, g, u1, u2)),
        "hg_pdf": ("hg_pdf", (wi[:, 2], g)),
        "fresnel_schlick": ("fresnel_schlick", (ax[:, None] * 0.5, wi[:, 2:3])),
        "fresnel_dielectric": ("fresnel_dielectric", (np.abs(wi[:, 2]), eta)),
        "power_heuristic": ("power_heuristic", (pdf_a, pdf_b)),
        "normalize": ("normalize", (wi * 3.0,)),
        "to_local": ("to_local", (wi, nrm, wo, unit(rs, n))),
    }


@pytest.mark.parametrize(
    "case", sorted(_sampling_cases(np.random.RandomState(3)).keys())
)
def test_sampling(case):
    fn, args = _sampling_cases(np.random.RandomState(3))[case]
    out_t = getattr(tsm, fn)(*[torch.from_numpy(a) for a in args])
    out_j = getattr(jsm, fn)(*[jnp.asarray(a) for a in args])
    if not isinstance(out_t, tuple):
        out_t, out_j = (out_t,), (out_j,)
    for a, b in zip(out_t, out_j):
        close(a, b, what=case)


# --- lights -----------------------------------------------------------------


def _light_scene(pkg):
    import importlib

    light = importlib.import_module(f"{pkg}.scene.cpu.light")
    node = importlib.import_module(f"{pkg}.scene.cpu.node")
    proc = importlib.import_module(f"{pkg}.scene.procedural")
    scene = proc.cornell_box()
    specs = [
        (light.LightType.POINT, (0.0, 0.0), [0.2, 0.5, 0.1], None),
        (light.LightType.DIRECTIONAL, (0.3, 0.0), [0.0, 0.0, 0.0], 0.4),
        (light.LightType.SPOT, (0.3, 0.6), [-0.3, 0.6, 0.2], 1.1),
        (light.LightType.QUAD, (0.5, 0.4), [0.1, 0.95, -0.2], 1.57),
        (light.LightType.SPHERE, (0.15, 0.0), [-0.4, -0.3, 0.3], None),
    ]
    for lt, params, pos, rot_x in specs:
        n = node.Node(name=f"l{int(lt)}")
        m = np.eye(4, dtype=np.float32)
        if rot_x is not None:
            c, s = math.cos(rot_x), math.sin(rot_x)
            m[1:3, 1:3] = [[c, -s], [s, c]]
        m[:3, 3] = pos
        n.local_transform = m
        n.light_index = len(scene.lights)
        scene.nodes.append(n)
        scene.lights.append(light.Light(
            color=np.array([1.0, 0.8, 0.6], np.float32), intensity=3.0,
            light_type=lt, params=params,
        ))
    scene.update_node_hierarchies()
    return scene


@pytest.fixture(scope="module")
def light_scenes():
    return (
        JUp.upload(_light_scene("hala_tpu"), use_ray_tracing=False),
        TUp.upload(_light_scene("hala_tpu_torch"), use_ray_tracing=False, device="cpu"),
    )


def test_sample_one_light(light_scenes):
    jdev, tdev = light_scenes
    assert tdev.lights.num_lights == 6
    rs = np.random.RandomState(4)
    p = rs.uniform(-0.9, 0.9, (1024, 3)).astype(np.float32)
    rnd = rs.uniform(0, 1, (1024, 3)).astype(np.float32)
    st = tl.sample_one_light(tdev.lights, torch.from_numpy(p), torch.from_numpy(rnd))
    sj = jl.sample_one_light(jdev.lights, jnp.asarray(p), jnp.asarray(rnd))
    for name in ("wi", "dist", "radiance", "pdf"):
        close(getattr(st, name), getattr(sj, name), what=name)
    np.testing.assert_array_equal(st.is_delta.numpy(), np.asarray(sj.is_delta))


def test_intersect_lights(light_scenes):
    jdev, tdev = light_scenes
    rs = np.random.RandomState(5)
    o = rs.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    d = unit(rs, 2048)
    ht = tl.intersect_lights(tdev.lights, torch.from_numpy(o), torch.from_numpy(d))
    hj = jl.intersect_lights(jdev.lights, jnp.asarray(o), jnp.asarray(d))
    assert int((ht.t < ti.T_MAX).sum()) > 50  # the rays do hit lights
    for name in ("t", "radiance", "pdf"):
        close(getattr(ht, name), getattr(hj, name), what=name)


# --- texture ----------------------------------------------------------------


@pytest.fixture(scope="module")
def atrium_textures():
    import os

    from hala_tpu.scene.cpu.scene import Scene as JS
    from hala_tpu_torch.scene.cpu.scene import Scene as TS

    path = os.path.join(os.path.dirname(__file__), "..", "assets", "atrium.glb")
    return (JUp._upload_textures(JS.load(path)),
            TUp._upload_textures(TS.load(path), torch.device("cpu")))


def test_sample_texture(atrium_textures):
    js, ts = atrium_textures
    assert ts.num_levels > 1
    rs = np.random.RandomState(6)
    n = 1500
    idx = rs.randint(-1, ts.num_textures, n).astype(np.int32)
    uv = rs.uniform(-3, 3, (n, 2)).astype(np.float32)
    lod = rs.uniform(-12, 2, n).astype(np.float32)
    for lod_arg in (None, lod):
        t = ttex.sample_texture(ts, torch.from_numpy(idx), torch.from_numpy(uv),
                                None if lod_arg is None else torch.from_numpy(lod_arg))
        j = jtex.sample_texture(js, jnp.asarray(idx), jnp.asarray(uv),
                                None if lod_arg is None else jnp.asarray(lod_arg))
        close(t, j, what=f"lod={lod_arg is not None}")
    maps = [rs.randint(-1, ts.num_textures, n).astype(np.int32) for _ in range(4)]
    lods = [lod, lod, lod, None]
    t = ttex.sample_textures_packed(
        ts, [torch.from_numpy(m) for m in maps], torch.from_numpy(uv),
        lods=[None if x is None else torch.from_numpy(x) for x in lods],
    )
    j = jtex.sample_textures_packed(
        js, [jnp.asarray(m) for m in maps], jnp.asarray(uv),
        lods=[None if x is None else jnp.asarray(x) for x in lods],
    )
    for a, b in zip(t, j):
        close(a, b, what="packed")


# --- bsdf ---------------------------------------------------------------------


def _mat_params(mod, arrays):
    return mod.MatParams(**{k: (torch.from_numpy(v) if mod is tb else jnp.asarray(v))
                            for k, v in arrays.items()})


def _random_materials(rs, n):
    f = lambda lo, hi, shape=(n,): rs.uniform(lo, hi, shape).astype(np.float32)  # noqa: E731
    trans = f(0, 1)
    trans[rs.uniform(0, 1, n) < 0.5] = 0.0
    mt = (rs.uniform(0, 1, n) < 0.7).astype(np.int32)
    return dict(
        base_color=f(0.05, 1, (n, 3)), emission=f(0, 0.2, (n, 3)),
        opacity=f(0.5, 1), metallic=f(0, 1), roughness=f(0.05, 1),
        subsurface=f(0, 1), specular_tint=f(0, 1), sheen=f(0, 1),
        sheen_tint=f(0, 1), clearcoat=f(0, 1), clearcoat_roughness=f(0, 1),
        clearcoat_tint=f(0.5, 1, (n, 3)), specular_transmission=trans,
        ior=f(1.2, 2.0), ax=f(0.05, 1), ay=f(0.05, 1), mat_type=mt,
    )


@pytest.mark.parametrize("w_disney,w_trans", [(False, False), (True, False), (True, True)])
def test_bsdf_eval_and_sample(w_disney, w_trans):
    rs = np.random.RandomState(7)
    n = 2048
    arrays = _random_materials(rs, n)
    mt, mj = _mat_params(tb, arrays), _mat_params(jb, arrays)
    wo = unit(rs, n)
    wo[:, 2] = np.abs(wo[:, 2]) + 1e-3
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = unit(rs, n)
    ft, pt = tb.bsdf_eval(mt, torch.from_numpy(wo), torch.from_numpy(wi), w_disney, w_trans)
    fj, pj = jb.bsdf_eval(mj, jnp.asarray(wo), jnp.asarray(wi), w_disney, w_trans)
    close(ft, fj, what="eval f")
    close(pt, pj, what="eval pdf")
    rnd = rs.uniform(0, 1, (n, 4)).astype(np.float32)
    st = tb.bsdf_sample(mt, torch.from_numpy(wo), torch.from_numpy(rnd), w_disney, w_trans)
    sj = jb.bsdf_sample(mj, jnp.asarray(wo), jnp.asarray(rnd), w_disney, w_trans)
    for a, b, what in zip(st, sj, ("wi", "f", "pdf")):
        close(a, b, what=f"sample {what}")


def test_gather_materials():
    from hala_tpu.scene.procedural import cornell_box as jc
    from hala_tpu_torch.scene.procedural import cornell_box as tc

    jdev = JUp.upload(jc(), use_ray_tracing=False)
    tdev = TUp.upload(tc(), use_ray_tracing=False, device="cpu")
    rs = np.random.RandomState(8)
    idx = rs.randint(-1, tdev.materials.packed.shape[0], 300).astype(np.int32)
    gt = tb.gather_materials(tdev.materials, torch.from_numpy(idx))
    gj = jb.gather_materials(jdev.materials, jnp.asarray(idx))
    for name in gt._fields:
        a, b = getattr(gt, name), getattr(gj, name)
        if a is None:
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# --- sky and tonemap ----------------------------------------------------------


def test_sky_radiance():
    rs = np.random.RandomState(9)
    d = unit(rs, 777)
    g = np.array([[0.5, 0.4, 0.3]], np.float32)
    s = np.array([[0.2, 0.6, 0.9]], np.float32)
    close(tenv.sky_radiance(*[torch.from_numpy(x) for x in (d, g, s)]),
          jenv.sky_radiance(*[jnp.asarray(x) for x in (d, g, s)]))


@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (True, True, True), (True, True, False)])
def test_tonemap(flags):
    rs = np.random.RandomState(10)
    c = rs.uniform(0, 8, (64, 48, 3)).astype(np.float32)
    close(ttm.apply_tonemap(torch.from_numpy(c), *flags),
          jtm.apply_tonemap(jnp.asarray(c), *flags))
    close(ttm.luminance(torch.from_numpy(c)), jtm.luminance(jnp.asarray(c)))


# --- brute-force intersection -------------------------------------------------


@pytest.fixture(scope="module")
def cornell_geoms():
    from hala_tpu.scene.procedural import cornell_box as jc
    from hala_tpu_torch.scene.procedural import cornell_box as tc

    return (JUp.upload(jc(), use_ray_tracing=False).geometry,
            TUp.upload(tc(), use_ray_tracing=False, device="cpu").geometry)


def test_intersect_bruteforce(cornell_geoms):
    jg, tg = cornell_geoms
    rs = np.random.RandomState(11)
    n = 1000
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = unit(rs, n)
    tm = rs.uniform(0.1, 3.0, n).astype(np.float32)
    tm[::7] = 3.0e38
    tm[::31] = 0.0
    tris_t = (tg.tri_v0, tg.tri_e1, tg.tri_e2)
    tris_j = (jg.tri_v0, jg.tri_e1, jg.tri_e2)
    ht = ti.intersect_bruteforce(torch.from_numpy(o), torch.from_numpy(d), *tris_t,
                                 t_max=torch.from_numpy(tm), chunk=64)
    hj = ji.intersect_bruteforce(jnp.asarray(o), jnp.asarray(d), *tris_j,
                                 t_max=jnp.asarray(tm), chunk=64)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    for name in ("t", "u", "v"):
        close(getattr(ht, name), getattr(hj, name), what=name)
    ot = ti.occluded_bruteforce(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tm), *tris_t)
    oj = ji.occluded_bruteforce(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), *tris_j)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    ct = ti.canonical_hit(torch.from_numpy(o), torch.from_numpy(d), *tris_t, ht)
    cj = ji.canonical_hit(jnp.asarray(o), jnp.asarray(d), *tris_j, hj)
    for name in ("t", "u", "v"):
        close(getattr(ct, name), getattr(cj, name), what=f"canonical {name}")


def test_ray_triangle_sphere_quad():
    rs = np.random.RandomState(12)
    o = rs.uniform(-1, 1, (300, 3)).astype(np.float32)
    d = unit(rs, 300)
    v0 = rs.uniform(-1, 1, (40, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    # (t, u, v) over every (ray, triangle) pair; compared where the pair
    # is a hit: elsewhere u and v are unmasked intermediate values,
    # ill-conditioned when det is near its 1e-7 cut.
    tt, ut, vt = ti.ray_triangle(*[torch.from_numpy(x) for x in (o, d, v0, e1, e2)])
    tj, uj, vj = ji.ray_triangle(*[jnp.asarray(x) for x in (o, d, v0, e1, e2)])
    hit = np.asarray(tj) < 3.0e38
    assert hit.sum() > 20
    np.testing.assert_array_equal(tt.numpy() < 3.0e38, hit)
    for a, b in ((tt, tj), (ut, uj), (vt, vj)):
        close(a.numpy()[hit], np.asarray(b)[hit])
    rad = rs.uniform(0.05, 0.4, 40).astype(np.float32)
    close(ti.ray_sphere(*[torch.from_numpy(x) for x in (o, d, v0, rad)]),
          ji.ray_sphere(*[jnp.asarray(x) for x in (o, d, v0, rad)]))
    close(ti.ray_quad(*[torch.from_numpy(x) for x in (o, d, v0, e1, e2)]),
          ji.ray_quad(*[jnp.asarray(x) for x in (o, d, v0, e1, e2)]))
