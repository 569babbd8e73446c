"""The port's whole slice: golden renders, a side-by-side render with the
JAX package, render_frames bit-equality, and the renderer API.

Images follow ROADMAP's policy: RMSE < 1e-3 against the fixtures of
tests/fixtures (made by the JAX package, tests/fixtures/regen_golden.py)
at the settings tests/test_golden.py uses, and relative RMSE < 2e-3 for
side-by-side renders. All of it runs on the CPU through the "auto"
backend, so the kernels' plain versions carry the visibility queries:
K1's for the Cornell scenes, K2's for atrium.glb (SAH layout).
"""

import os

import numpy as np
import pytest
import torch

from hala_tpu_torch.error import HalaRendererError
from hala_tpu_torch.models.integrator import (
    Film,
    RenderSettings,
    Uniforms,
    _backend,
    render_frame,
    render_frames,
)
from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils.pfm import read_pfm


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    more threads per worker only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


HERE = os.path.dirname(__file__)
RMSE_TOL = 1e-3


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _golden(name):
    return np.load(os.path.join(HERE, "fixtures", f"golden_{name}.npz"))


def _ggx_scene():
    from hala_tpu_torch.scene.cpu.material import Material, MaterialType

    metal = Material(type=MaterialType.DISNEY,
                     base_color=np.array([0.9, 0.75, 0.4], np.float32),
                     roughness=0.2, metallic=1.0)
    glossy = Material(type=MaterialType.DISNEY,
                      base_color=np.array([0.2, 0.4, 0.9], np.float32),
                      roughness=0.45, metallic=0.0)
    return cornell_box(tall_box_material=metal, short_box_material=glossy)


def _ortho_scene():
    from hala_tpu_torch.scene.cpu.camera import OrthographicCamera, orthographic_rh

    scene = cornell_box()
    cam = OrthographicCamera(xmag=1.2, ymag=1.2)
    cam.orthography = orthographic_rh(-1.2, 1.2, -1.2, 1.2, 0.1, 100.0)
    scene.cameras = [cam]
    return scene


def _trace(host, settings, frames):
    dev = SceneUploader.upload(host, device="cpu")
    film = Film.create(settings.width, settings.height, "cpu")
    uni = Uniforms.default("cpu")
    for f in range(frames):
        render_frame(dev, None, uni, film, f, settings)
    return dev, film


GOLDENS = {
    # name: (scene builder, settings kwargs, frames, compared images)
    "cornell": (cornell_box, dict(width=32, height=32, max_depth=3), 8,
                ("accum", "albedo", "normal")),
    "ggx": (_ggx_scene, dict(width=32, height=32, max_depth=4), 8, ("accum",)),
    "ortho": (_ortho_scene, dict(width=32, height=32, max_depth=3), 4,
              ("accum", "normal")),
    "atrium": (lambda: Scene.load(os.path.join(HERE, "..", "assets", "atrium.glb")),
               dict(width=24, height=24, max_depth=2), 4, ("accum", "albedo")),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    build, kw, frames, keys = GOLDENS[name]
    settings = RenderSettings(rr_depth=2, tile_size=kw["width"] * kw["height"], **kw)
    dev, film = _trace(build(), settings, frames)
    expected = "matrix" if name == "atrium" else "pallas"
    assert _backend(settings, dev) == expected
    assert torch.isfinite(film.accum).all()
    with _golden(name) as z:
        for k in keys:
            assert _rmse(getattr(film, k).numpy(), z[k]) < RMSE_TOL, k


def test_side_by_side_with_jax_pallas_interpret():
    """Cornell 32x32 next to hala_tpu's render_frame through its Pallas
    kernel in interpret mode."""
    from hala_tpu.models import integrator as jint
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp
    from hala_tpu.scene.procedural import cornell_box as jcornell

    frames = 2
    js = jint.RenderSettings(width=32, height=32, max_depth=3, rr_depth=2,
                             tile_size=1024, intersector="pallas",
                             interpret_pallas=True)
    jdev = JUp.upload(jcornell(), use_ray_tracing=False)
    jfilm = jint.Film.create(32, 32)
    for f in range(frames):
        jfilm, _ = jint.render_frame(jdev, None, jint.Uniforms.default(), jfilm, f, js)
    ts = RenderSettings(width=32, height=32, max_depth=3, rr_depth=2,
                        tile_size=1024, intersector="pallas")
    _, tfilm = _trace(cornell_box(), ts, frames)
    for k in ("accum", "albedo", "normal"):
        ref = np.asarray(getattr(jfilm, k))
        rel = _rmse(getattr(tfilm, k).numpy(), ref) / max(_rmse(ref, 0.0), 1e-12)
        assert rel < 2e-3, (k, rel)


def test_render_frames_equals_sequential_frames():
    settings = RenderSettings(width=32, height=32, max_depth=3, rr_depth=2,
                              tile_size=256)
    dev = SceneUploader.upload(cornell_box(), device="cpu")
    uni = Uniforms.default("cpu")
    seq = Film.create(32, 32, "cpu")
    rays_seq = 0.0
    for f in range(2, 5):
        _, r = render_frame(dev, None, uni, seq, f, settings)
        rays_seq += float(r)
    fused = Film.create(32, 32, "cpu")
    _, rays = render_frames(dev, None, uni, fused, 2, 3, settings)
    for k in ("accum", "albedo", "normal"):
        assert torch.equal(getattr(seq, k), getattr(fused, k)), k
    assert float(rays) == rays_seq


def test_tiling_does_not_change_the_image():
    """RNG is keyed on the global pixel id: tile size and the 32x32
    swizzle change nothing, bit for bit."""
    dev = SceneUploader.upload(cornell_box(), device="cpu")
    uni = Uniforms.default("cpu")
    films = []
    for tile in (1024, 96):  # one swizzled tile / ragged unswizzled tiles
        film = Film.create(32, 32, "cpu")
        render_frame(dev, None, uni, film, 3,
                     RenderSettings(width=32, height=32, max_depth=3, tile_size=tile))
        films.append(film)
    assert torch.equal(films[0].accum, films[1].accum)


def test_bruteforce_backend_matches_auto():
    dev = SceneUploader.upload(cornell_box(), device="cpu")
    uni = Uniforms.default("cpu")
    out = []
    for sel in ("auto", "bruteforce"):
        film = Film.create(16, 16, "cpu")
        render_frame(dev, None, uni, film, 0,
                     RenderSettings(width=16, height=16, intersector=sel))
        out.append(film.accum)
    assert _rmse(out[0].numpy(), out[1].numpy()) < 1e-6


# --- renderer API -----------------------------------------------------------


def test_renderer_api_and_save_images(tmp_path):
    r = RayTracingRenderer("api", 32, 32, max_depth=3, device="cpu",
                           max_frames=5, staged=True)
    r.set_scene(cornell_box())
    r.set_sky_color([0.4, 0.6, 0.9])
    r.set_ground_color([0.3, 0.3, 0.3])
    r.set_env_intensity(1.0)
    r.set_exposure_value(1.2)
    r.set_camera_index(0)
    r.commit()
    r.update()
    r.render()
    assert r.total_rays > 32 * 32
    r.render_loop(3, frames_per_dispatch=2)
    r.render_loop(3)  # capped by max_frames
    assert r._frame_index == 5
    r.render_loop(2, pipelined=False)  # budget reached: no frames
    assert r._frame_index == 5
    img = r.get_final_image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.mean() > 0.1
    r.save_images(str(tmp_path / "api.pfm"))
    for kind in ("color", "albedo", "normal"):
        pfm = read_pfm(str(tmp_path / f"api_{kind}.pfm"))
        assert pfm.shape == (32, 32, 3) and np.isfinite(pfm).all()
        assert np.abs(pfm).max() > 0
    r.reset_accumulation()
    assert float(r.film.accum.abs().sum()) == 0.0
    assert r.statistics.total_frames > 0


def test_renderer_error_probes():
    r = RayTracingRenderer("probe", 16, 16, device="cpu")
    with pytest.raises(HalaRendererError, match="before set_scene"):
        r.commit()
    scene = cornell_box()
    for node in scene.nodes:
        node.camera_index = None
    with pytest.raises(HalaRendererError, match="no camera"):
        r.set_scene(scene)
    r.set_scene(cornell_box())
    # pushed kernels are ported: only the stages push_general_shader
    # takes are accepted
    with pytest.raises(HalaRendererError, match="raygen/miss/callable"):
        r.push_general_kernel("closest_hit", lambda *a: None)


def test_cuda_error_marks_device_lost_and_restores(tmp_path):
    """A CUDA runtime error while waiting for a frame is the reference's
    device-lost case: the frame is dropped, and the next update
    re-creates the film and re-uploads the scene."""
    r = RayTracingRenderer("lost", 16, 16, max_depth=2, device="cpu")
    r.set_scene(cornell_box())
    r.update()
    r.render()
    rays_before = r.total_rays

    def lost():
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    r.update()
    r._sync = lost
    r._pending = True
    r.render()
    assert r.is_device_lost and r.total_rays == rays_before
    r.save_images(str(tmp_path / "lost.pfm"))  # refused while lost
    assert not list(tmp_path.iterdir())
    del r._sync
    r.update()
    assert not r.is_device_lost and r._frame_index == 1
    r.render()
    assert r.total_rays > rays_before


@pytest.mark.parametrize("option", ["intersector", "env", "blue_noise", "hooks",
                                    "scene_axis"])
def test_unported_integrator_options_raise(option):
    """What is still unported raises; the environment map, the
    blue-noise texture and pushed kernel hooks, ported since, render
    instead."""
    dev = SceneUploader.upload(cornell_box(), device="cpu")
    kw = dict(width=8, height=8)
    args = dict(env=None, blue_noise=None, hooks=None)
    if option == "intersector":
        kw["intersector"] = "bvh"
    elif option == "env":
        from hala_tpu_torch.envmap import EnvMap

        kw["env_type"] = 1
        args["env"] = EnvMap.from_array(np.full((4, 8, 3), 0.5, np.float32),
                                        device="cpu")
    elif option == "blue_noise":
        args["blue_noise"] = torch.rand(
            (16, 16, 4), generator=torch.Generator().manual_seed(1))
    elif option == "scene_axis":
        kw["scene_axis"] = "x"
    elif option == "hooks":
        from hala_tpu_torch.models.integrator import KernelHooks

        args["hooks"] = KernelHooks(miss=lambda d, uniforms, default: default)
    else:
        args[option] = object()

    def render():
        film = Film.create(8, 8, "cpu")
        render_frame(dev, args["env"], Uniforms.default("cpu"), film, 0,
                     RenderSettings(**kw), blue_noise=args["blue_noise"],
                     hooks=args["hooks"])
        return film

    if option in ("env", "blue_noise", "hooks"):
        film = render()
        assert bool(torch.isfinite(film.accum).all())
        assert float(film.accum[..., :3].mean()) > 0.0
        return
    with pytest.raises(HalaRendererError, match="not yet ported"):
        render()


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(HalaRendererError, match="cuda"):
        RayTracingRenderer("default", 8, 8)
