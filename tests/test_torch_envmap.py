"""The HDR environment map and blue-noise sampling of the port against
the JAX package, on the same seeded numpy inputs.

- `EnvMap.from_array`: `marginal`, `conditional`, `luminance`,
  `total_luminance` array-equal to hala_tpu's (the same numpy build);
  the `dist_cache` bytes identical.
- `env_sample` (driven by integer tables and per-row / per-column trig
  made in numpy as hala_tpu's sample table): wi and radiance at atol
  1e-6, the pdf at rtol 1e-6 (it reaches 7 on the hot patch, where one
  ulp is 5e-7).
- `env_radiance`, `env_pdf`, `env_eval` (driven by atan2 / acos of the
  direction): u agrees bit for bit, v by one ulp (torch's and XLA's
  acos differ in the last bit for one value in six), which moves the
  bilinear row weight by up to 64 ulp on this 64-row map. So the pdf
  holds atol 1e-6 (measured 4.8e-7), and the radiance rtol 5e-5 with
  atol 1e-6 (measured 1.8e-5 relative; 3.4e-4 absolute on the 90.0
  patch, where an absolute 1e-6 is below the weight's own rounding).
- `bn_sample4`: bit for bit (integer hashing, one float add and one
  remainder).
- `golden_envmap` at tests/test_golden.py's settings: RMSE < 1e-3; a
  side-by-side frame with hala_tpu, and a blue-noise render.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu import envmap as j_envmap
from hala_tpu.models import integrator as jint
from hala_tpu.ops import env as j_env
from hala_tpu.ops import rng as j_rng
from hala_tpu.scene.loader.uploader import SceneUploader as JUp
from hala_tpu.scene.procedural import cornell_box
from hala_tpu_torch import envmap as t_envmap
from hala_tpu_torch.models import integrator as tint
from hala_tpu_torch.models.rt_renderer import EnvType, RayTracingRenderer
from hala_tpu_torch.ops import env as t_env
from hala_tpu_torch.ops import rng as t_rng
from hala_tpu_torch.scene.gpu.scene import from_numpy

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bench_map():
    """bench.py's envmap configuration: a seeded 64x128 map with a hot patch."""
    rs = np.random.RandomState(7)
    rgb = rs.uniform(0.05, 0.3, (64, 128, 3)).astype(np.float32)
    rgb[20:26, 40:48] = 60.0
    return rgb


def _golden_map():
    """tests/fixtures/regen_golden.py `test_envmap`."""
    rs = np.random.RandomState(11)
    rgb = rs.uniform(0.05, 0.4, (16, 32, 3)).astype(np.float32)
    rgb[4, 9] = 30.0
    return rgb


@pytest.fixture(scope="module")
def envs():
    rgb = _bench_map()
    return j_envmap.EnvMap.from_array(rgb), t_envmap.EnvMap.from_array(rgb, device="cpu")


def _write_hdr(path, rgb):
    """A flat-scanline Radiance RGBE file (the one float format
    ImageData.load reads); the decoded values are the RGBE-rounded ones."""
    m = rgb.max(axis=-1)
    _, ex = np.frexp(m)
    scale = np.where(m > 1e-32, 256.0 / np.ldexp(1.0, ex), 0.0)
    rgbe = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, ex + 128, 0)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _dirs(n, seed):
    rs = np.random.RandomState(seed)
    z = rs.uniform(-1, 1, n)
    phi = rs.uniform(0, 2 * np.pi, n)
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1).astype(np.float32)


# --- tables -------------------------------------------------------------------


@pytest.mark.parametrize("make", [_bench_map, _golden_map], ids=["bench", "golden"])
def test_tables_equal_the_jax_package(make):
    rgb = make()
    ref = j_envmap.EnvMap.from_array(rgb)
    ours = t_envmap.EnvMap.from_array(rgb, device="cpu")
    for key in ("image", "marginal", "conditional", "luminance", "total_luminance"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(),
                                      np.asarray(getattr(ref, key)), err_msg=key)
    assert (ours.width, ours.height) == (ref.width, ref.height)
    carried = t_envmap.EnvMap.from_numpy(ref, "cpu")
    for f in ("marginal", "conditional", "sin_theta", "cos_phi"):
        assert torch.equal(getattr(carried, f), getattr(ours, f))
    # the per-row / per-column trig is the sample table's dir0 and sin
    stab = np.asarray(ref.stab)
    x0 = ours.sin_theta[:, None] * ours.cos_phi[None, :]
    z0 = ours.sin_theta[:, None] * ours.sin_phi[None, :]
    np.testing.assert_array_equal(x0.numpy(), stab[..., 4])
    np.testing.assert_array_equal(ours.cos_theta.numpy(), stab[:, 0, 5])
    np.testing.assert_array_equal(z0.numpy(), stab[..., 6])
    np.testing.assert_array_equal(
        torch.clamp(ours.sin_theta, min=1e-6).numpy(), stab[:, 0, 7])


def test_build_distribution_maps_equal():
    rgb = np.random.RandomState(3).uniform(0.01, 5.0, (8, 16, 3)).astype(np.float32)
    for a, b in zip(t_envmap.build_distribution_maps(rgb),
                    j_envmap.build_distribution_maps(rgb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_writes_and_reads_the_same_dist_cache(tmp_path):
    """`load` from a Radiance file: the cache bytes equal hala_tpu's, and
    a second load takes the tables from the cache."""
    path = str(tmp_path / "sky.hdr")
    _write_hdr(path, _golden_map())
    ours = t_envmap.EnvMap.load(path, cache_dir=str(tmp_path / "t"), device="cpu")
    ref = j_envmap.EnvMap.load(path, cache_dir=str(tmp_path / "j"))
    with open(tmp_path / "t" / "sky.dist_cache", "rb") as f:
        mine = f.read()
    with open(tmp_path / "j" / "sky.dist_cache", "rb") as f:
        theirs = f.read()
    assert mine == theirs and len(mine) == 4 * (1 + 16 + 16 * 32)
    assert ours.name == "sky"
    np.testing.assert_array_equal(ours.conditional.numpy(), np.asarray(ref.conditional))
    # poison the cache: the second load must read it
    raw = np.frombuffer(mine, "<f4").copy()
    raw[1] = 0.5
    raw.tofile(tmp_path / "t" / "sky.dist_cache")
    again = t_envmap.EnvMap.load(path, cache_dir=str(tmp_path / "t"), device="cpu")
    assert float(again.marginal[0]) == 0.5


def test_load_rejects_non_float_and_non_finite(tmp_path, monkeypatch):
    from hala_tpu_torch.error import HalaRendererError
    from hala_tpu_torch.scene.cpu.image_data import ImageData

    bad = _golden_map()
    bad[0, 0, 0] = np.inf
    for pixels, what in ((bad, "NaN/Inf"),
                         (np.zeros((4, 8, 3), np.uint8), "float image")):
        monkeypatch.setattr(ImageData, "load",
                            staticmethod(lambda path, px=pixels: ImageData.from_array(px)))
        with pytest.raises(HalaRendererError, match=what):
            t_envmap.EnvMap.load("sky.hdr", cache_dir=str(tmp_path), device="cpu")


# --- sampling ------------------------------------------------------------------


@pytest.mark.parametrize("rot", [0.0, 0.73])
def test_env_sample_matches_jax(envs, rot):
    ref_env, env = envs
    rnd = np.random.RandomState(21).uniform(0, 1, (4096, 2)).astype(np.float32)
    wi_r, rad_r, pdf_r = j_env.env_sample(ref_env, jnp.asarray(rnd), jnp.float32(rot),
                                          jnp.float32(2.0))
    wi, rad, pdf = t_env.env_sample(env, _t(rnd), torch.tensor(rot), torch.tensor(2.0))
    np.testing.assert_allclose(wi.numpy(), np.asarray(wi_r), atol=1e-6)
    np.testing.assert_allclose(rad.numpy(), np.asarray(rad_r), atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_r), rtol=1e-6)
    assert float(pdf.max()) > 5.0 and int((rad[:, 0] > 100.0).sum()) > 1000
    if rot == 0.0:
        np.testing.assert_array_equal(wi.numpy(), np.asarray(wi_r))


@pytest.mark.parametrize("rot", [0.0, 0.73])
def test_env_eval_radiance_pdf_match_jax(envs, rot):
    ref_env, env = envs
    d = _dirs(4096, 22)
    jrot, jint_ = jnp.float32(rot), jnp.float32(1.5)
    trot, tint_ = torch.tensor(rot), torch.tensor(1.5)
    rad_r = np.asarray(j_env.env_radiance(ref_env, jnp.asarray(d), jrot, jint_))
    pdf_r = np.asarray(j_env.env_pdf(ref_env, jnp.asarray(d), jrot))
    ev_r = j_env.env_eval(ref_env, jnp.asarray(d), jrot, jint_)
    rad = t_env.env_radiance(env, _t(d), trot, tint_)
    pdf = t_env.env_pdf(env, _t(d), trot)
    ev = t_env.env_eval(env, _t(d), trot, tint_)
    assert torch.equal(ev[0], rad) and torch.equal(ev[1], pdf)
    np.testing.assert_array_equal(np.asarray(ev_r[0]), rad_r)
    np.testing.assert_allclose(rad.numpy(), rad_r, rtol=5e-5, atol=1e-6)
    assert float(np.abs(rad.numpy() - rad_r).mean()) < 1e-6
    np.testing.assert_allclose(pdf.numpy(), pdf_r, rtol=0.0, atol=1e-6)
    u, v = t_env.dir_to_uv(_t(d), trot)
    ju, jv = j_env.dir_to_uv(jnp.asarray(d), jrot)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1.2e-7)
    back = t_env.uv_to_dir(u, v, trot)
    np.testing.assert_allclose(back.numpy(), d, atol=1e-5)


def test_env_pdf_integrates_to_one():
    rgb = np.random.RandomState(27).uniform(0.1, 2.0, (32, 64, 3)).astype(np.float32)
    env = t_envmap.EnvMap.from_array(rgb, device="cpu")
    pdf = t_env.env_pdf(env, _t(_dirs(20000, 23)), torch.tensor(0.0))
    assert float(pdf.mean()) * 4 * np.pi == pytest.approx(1.0, rel=0.05)


def test_bn_sample4_equals_jax_bit_for_bit():
    rs = np.random.RandomState(24)
    tex = rs.uniform(0, 1, (32, 48, 4)).astype(np.float32)
    px = rs.randint(0, 1920, 4096).astype(np.int32)
    py = rs.randint(0, 1088, 4096).astype(np.int32)
    frames = rs.randint(0, 1 << 20, 4096).astype(np.uint32)
    for frame, bounce, seed in ((5, 0, 1), (frames, 3, 17), (0xFFFFFFFF, 2, 53)):
        ref = j_rng.bn_sample4(jnp.asarray(tex), jnp.asarray(px), jnp.asarray(py),
                               jnp.asarray(frame, jnp.uint32), bounce, seed)
        f = frame if np.isscalar(frame) else _t(frame.astype(np.int64))
        ours = t_rng.bn_sample4(_t(tex), _t(px), _t(py), f, bounce, seed)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert float(ours.min()) >= 0.0 and float(ours.max()) < 1.0


# --- renders -------------------------------------------------------------------


def test_golden_envmap():
    """tests/test_golden.py TestGoldenEnvmap through the port."""
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box as t_cornell

    dev = SceneUploader.upload(t_cornell(light_intensity=0.0), use_ray_tracing=False, device="cpu")
    settings = tint.RenderSettings(
        width=32, height=32, max_depth=3, rr_depth=2, tile_size=1024,
        intersector="bruteforce", env_type=tint.ENV_MAP,
    )
    env = t_envmap.EnvMap.from_array(_golden_map(), device="cpu")
    film = tint.Film.create(32, 32, "cpu")
    uni = tint.Uniforms.default("cpu")
    for f in range(8):
        tint.render_frame(dev, env, uni, film, f, settings)
    with np.load(os.path.join(FIXTURES, "golden_envmap.npz")) as z:
        rmse = float(np.sqrt(np.mean((film.accum.numpy() - z["accum"]) ** 2)))
    assert rmse < 1e-3


@pytest.fixture(scope="module")
def cornell_pair():
    jdev = JUp.upload(cornell_box(light_intensity=0.0), use_ray_tracing=False)
    return jdev, from_numpy(jdev, "cpu")


@pytest.mark.parametrize("intersector", ["bruteforce", "matrix"])
def test_envmap_frame_side_by_side_with_jax(cornell_pair, intersector):
    """One 16x16 frame lit by the map alone: "bruteforce" batches the
    two shadow queries with the extension rays, "matrix" splits them
    into one any-hit query of 2N rays."""
    jdev, tdev = cornell_pair
    rgb = _golden_map()
    kw = dict(width=16, height=16, max_depth=3, tile_size=256, env_type=1,
              intersector=intersector)
    jfilm, jrays = jint.render_frame(
        jdev, j_envmap.EnvMap.from_array(rgb), jint.Uniforms.default(),
        jint.Film.create(16, 16), 0,
        jint.RenderSettings(interpret_pallas=True, **kw))
    film = tint.Film.create(16, 16, "cpu")
    _, rays = tint.render_frame(
        tdev, t_envmap.EnvMap.from_array(rgb, device="cpu"),
        tint.Uniforms.default("cpu"), film, 0, tint.RenderSettings(**kw))
    np.testing.assert_allclose(film.accum.numpy(), np.asarray(jfilm.accum), atol=1e-3)
    assert float(rays) == float(jrays) and float(film.accum[..., :3].mean()) > 0.01


def test_blue_noise_frame_side_by_side_with_jax(cornell_pair):
    jdev = JUp.upload(cornell_box(), use_ray_tracing=False)
    tdev = from_numpy(jdev, "cpu")
    tex = np.random.RandomState(25).uniform(0, 1, (16, 16, 4)).astype(np.float32)
    kw = dict(width=16, height=16, max_depth=2, tile_size=256, spp=2,
              intersector="bruteforce")
    jfilm, _ = jint.render_frame(jdev, None, jint.Uniforms.default(),
                                 jint.Film.create(16, 16), 1,
                                 jint.RenderSettings(**kw), blue_noise=jnp.asarray(tex))
    film = tint.Film.create(16, 16, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), film, 1,
                      tint.RenderSettings(**kw), blue_noise=_t(tex))
    np.testing.assert_allclose(film.accum.numpy(), np.asarray(jfilm.accum), atol=1e-3)
    plain = tint.Film.create(16, 16, "cpu")
    tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), plain, 1,
                      tint.RenderSettings(**kw))
    assert not torch.equal(plain.accum, film.accum)


def test_renderer_set_envmap_and_blue_noise(tmp_path, monkeypatch):
    """The renderer's entry points: set_envmap (an EnvMap or a path,
    rotation in degrees), load_blue_noise_texture, and the film they
    give equals render_frame's."""
    from hala_tpu_torch.scene.procedural import cornell_box as t_cornell

    rgb = _golden_map()
    _write_hdr(str(tmp_path / "sky.hdr"), rgb)
    tex = np.random.RandomState(26).uniform(0, 0.99, (8, 8, 3)).astype(np.float32)
    _write_hdr(str(tmp_path / "noise.hdr"), tex)
    monkeypatch.chdir(tmp_path)  # the dist_cache goes to ./out
    r = RayTracingRenderer("env", 16, 16, max_depth=2, intersector="bruteforce",
                           device="cpu")
    r.set_scene(t_cornell(light_intensity=0.0))
    r.set_envmap(str(tmp_path / "sky.hdr"), rotation=90.0)
    r.load_blue_noise_texture(str(tmp_path / "noise.hdr"))
    assert r.env_type == EnvType.MAP and float(r.uniforms.env_rotation) == 0.25
    assert r.blue_noise.shape == (8, 8, 4)
    assert os.path.exists(tmp_path / "out" / "sky.dist_cache")
    r.render_loop(2)
    assert r.settings.env_type == tint.ENV_MAP
    film = tint.Film.create(16, 16, "cpu")
    for f in range(2):
        tint.render_frame(r.scene, r.env, r.uniforms, film, f, r.settings,
                          blue_noise=r.blue_noise)
    assert torch.equal(film.accum, r.film.accum)
    assert float(r.film.accum[..., :3].mean()) > 0.005
    r2 = RayTracingRenderer("env2", 16, 16, device="cpu")
    r2.set_envmap(t_envmap.EnvMap.from_array(rgb, device="cpu"))
    assert r2.env_type == EnvType.MAP and float(r2.uniforms.env_rotation) == 0.0
