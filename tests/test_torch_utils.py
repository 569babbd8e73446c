"""The port's utilities against the JAX package's: `RenderConfig` (the
same JSON both ways), render-state checkpoints (a file either package
writes loads in the other) and the Chrome trace exporter, which draws
the tracer's spans (tests/test_torch_tracing.py holds the tracer)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hala_tpu.models.integrator import Film as JFilm
from hala_tpu.utils import checkpoint as jck
from hala_tpu.utils.config import RenderConfig as JRenderConfig
from hala_tpu_torch.error import HalaRendererError
from hala_tpu_torch.models.integrator import Film, RenderSettings, Uniforms, render_frame
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils.checkpoint import load_render_state, save_render_state
from hala_tpu_torch.utils.config import RenderConfig
from hala_tpu_torch.utils import profiling
from hala_tpu_torch.utils.profiling import trace


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell_dev():
    return SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu")


# --- RenderConfig -------------------------------------------------------------


def test_config_json_roundtrip_and_field_parity():
    cfg = RenderConfig(width=256, max_depth=6, env_type="map", sky_color=(0.1, 0.2, 0.3))
    assert RenderConfig.from_json(cfg.to_json()) == cfg
    assert [f.name for f in dataclasses.fields(RenderConfig)] == [
        f.name for f in dataclasses.fields(JRenderConfig)]
    assert RenderConfig().tile_size == 1 << 20  # the port renderer's default


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_json_loads_across_packages(tmp_path, writer):
    """A JSON written by one package loads in the other with every value."""
    kw = dict(name="x", width=96, height=64, max_depth=7, env_type="map",
              envmap_path="sky.hdr", ground_color=(0.1, 0.2, 0.3), tile_size=4096,
              use_bvh=False, intersector="traverse", spp=2, staged=True)
    src = JRenderConfig(**kw) if writer == "jax" else RenderConfig(**kw)
    path = str(tmp_path / "cfg.json")
    src.save(path)
    dst = RenderConfig.load(path) if writer == "jax" else JRenderConfig.load(path)
    assert dataclasses.asdict(dst) == dataclasses.asdict(src)


def test_config_unknown_keys_ignored():
    cfg = RenderConfig.from_json('{"width": 64, "bogus_key": 1}')
    assert cfg.width == 64


def test_config_build_renderer(cornell_dev):
    cfg = RenderConfig(width=16, height=16, max_frames=1, tile_size=256,
                       sky_color=(0.2, 0.3, 0.4), exposure_value=2.0)
    r = cfg.build_renderer(device="cpu")
    assert r.device.type == "cpu" and r.info.width == 16 and r._tile_size == 256
    np.testing.assert_array_equal(r.uniforms.sky_color.numpy(),
                                  np.float32([0.2, 0.3, 0.4]))
    assert float(r.uniforms.exposure_value) == 2.0
    r.set_scene(cornell_box())
    r.commit()
    r.update()
    r.render()
    assert r._frame_index == 1 and float(r.film.accum.mean()) > 0
    bvh = RenderConfig(width=8, height=8, intersector="bvh").build_renderer(device="cpu")
    bvh.set_scene(cornell_box())
    bvh.commit()
    assert bvh.scene.bvh is not None and bvh.settings.use_bvh
    bvh.update()
    bvh.render()
    assert bool(torch.isfinite(bvh.film.accum).all())
    assert float(bvh.film.accum[..., :3].mean()) > 0.0


# --- checkpoints --------------------------------------------------------------


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {k: rs.rand(8, 8, 4).astype(np.float32) for k in ("accum", "albedo", "normal")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    arrs = _arrays(3)
    path = str(tmp_path / "state.npz")
    if writer == "jax":
        jck.save_render_state(path, JFilm(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                              frame_index=42, seed=7, extra={"spp": 4})
        film, fidx, seed, extra = load_render_state(path, device="cpu")
        got = {k: getattr(film, k).numpy() for k in arrs}
    else:
        save_render_state(path, Film(**{k: torch.from_numpy(v) for k, v in arrs.items()}),
                          frame_index=42, seed=7, extra={"spp": torch.tensor(4)})
        film, fidx, seed, extra = jck.load_render_state(path)
        got = {k: np.asarray(getattr(film, k)) for k in arrs}
    for k, v in arrs.items():
        np.testing.assert_array_equal(got[k], v)
    assert fidx == 42 and seed == 7 and int(extra["spp"]) == 4
    assert os.listdir(tmp_path) == ["state.npz"]  # the temporary file renamed


def test_checkpoint_rejects_other_versions(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, version=np.int64(2), **_arrays(0), frame_index=np.int64(0),
             seed=np.int64(0))
    with pytest.raises(HalaRendererError, match="version 2"):
        load_render_state(path, device="cpu")


def test_resume_continues_progressive(tmp_path, cornell_dev):
    """2 frames, checkpoint, resume, 2 more == 4 frames straight."""
    settings = RenderSettings(width=16, height=16, max_depth=2, tile_size=256)
    uni = Uniforms.default("cpu")

    def frames(film, lo, hi):
        for f in range(lo, hi):
            render_frame(cornell_dev, None, uni, film, f, settings)
        return film

    straight = frames(Film.create(16, 16, "cpu"), 0, 4)
    path = str(tmp_path / "ck.npz")
    save_render_state(path, frames(Film.create(16, 16, "cpu"), 0, 2), frame_index=2)
    film, fidx, _, _ = load_render_state(path, device="cpu")
    resumed = frames(film, fidx, 4)
    assert torch.equal(straight.accum, resumed.accum)


# --- profiling ----------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path, cornell_dev):
    """Inside `trace()` spans are on and drawn as named ranges; after it
    tracing is off again."""
    log_dir = str(tmp_path / "profile")
    settings = RenderSettings(width=8, height=8, max_depth=1, tile_size=64,
                              intersector="bruteforce")
    film = Film.create(8, 8, "cpu")
    assert not profiling.enabled()
    try:
        with trace(log_dir) as out:
            with profiling.span("hala.frame", frame=0):
                render_frame(cornell_dev, None, Uniforms.default("cpu"), film, 0, settings)
        assert not profiling.enabled()
        assert out == log_dir
        with open(os.path.join(log_dir, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"hala.frame", "hala.raygen", "hala.query", "hala.shade", "hala.film"} <= names
        assert [s.name for s in profiling.spans() if s.parent == -1] == ["hala.frame"]
    finally:
        profiling.reset()
