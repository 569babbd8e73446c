"""The harness on a configuration with procedural spheres, and the
program's spans in `run.Traced`, on the CPU at sizes a test run holds.

    python3 -m pytest -q bench_port/tests

`atrium_big_spheres.json` (beside this file) is atrium_big with three
diffuse spheres on the camera's view axis; it has no workload entry, so
it runs as a dict under `atrium_big.trace_1080p`'s traffic, metrics and
limit. The cases:

- at least 4 compared pixels' camera rays hit a sphere;
- a sound run reads no pixel off, and the control (the reference in
  bfloat16 in the program's place) reads above the limit;
- `correct` reads false with the spheres left out of the closest-hit
  merge, and with them left out of the shadow rays' any-hit test;
- the reference refuses a sphere material it does not cover;
- a configuration without spheres gives the reference's values of the
  commit before spheres were covered, bit for bit;
- `Traced` carries the spans of the traced frames, joined to their
  trace, and the tracer is off in the set-up and the timed window;
- the plain reference imports nothing of the program and no JAX.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import control  # noqa: E402
import run  # noqa: E402
from lib import compare, readers, reftrace  # noqa: E402
from lib.refscene import RefScene  # noqa: E402

SEED = 2**31 + 977
CELL = "atrium_big.trace_1080p"
SIZE = dict(width=16, height=16, check_pixels=64)
TINY = dict(warm_frames=1, traced_frames=1)
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "atrium_big_spheres.json")) as f:
    SPHERES = json.load(f)

# sha256 of the float32 bytes of the reference's values (atrium_big's
# trace cell at SIZE, SEED, 4 frames) as computed before the reference
# covered spheres: torch 2.13.0 on x86-64
REFERENCE_BEFORE_SPHERES = "7bb3fce1952cca2ce6391ab914bc5f4c8b2e189566647692ac2b05578b542628"


def _cell(config=SPHERES):
    return run.Cell(CELL, config=config)


def _run(trace=False, config=SPHERES):
    return run.run_cell(_cell(config), SEED, 0.0, trace, device="cpu",
                        overrides=dict(SIZE, **TINY), log=lambda *_: None)


def test_compared_pixels_hit_spheres():
    host = run.host_scene(SPHERES, SEED)
    rs = RefScene(host, "cpu")
    w, h, n = SIZE["width"], SIZE["height"], SIZE["check_pixels"]
    pix = torch.as_tensor(np.sort(np.random.default_rng([SEED, 1]).choice(w * h, n,
                                                                          replace=False)))
    jitter = reftrace.sample4(pix, torch.zeros_like(pix), 0, 1)
    o, d = reftrace.camera_rays(rs, (pix % w).float(), (pix // w).float(), w, h, jitter)
    _, tri, _, _ = reftrace.closest_hit(rs, o, d, torch.full((n,), reftrace.T_MAX))
    assert rs.num_spheres == 3
    assert int((tri >= rs.num_triangles).sum()) >= 4


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"]
    assert res["checks"]["pixels_off_pct"]["value"] == 0.0


def test_control_fails():
    pct = control.control_pct(_cell(), SEED, 4, "cpu", SIZE)
    assert pct > compare.limits(CELL)["pixels_off_pct"]


def _spheres_not_merged(monkeypatch):
    from hala_tpu_torch.models import integrator

    monkeypatch.setattr(integrator, "_merge_proc", lambda scene, o, d, hit, t_max: hit)


def _spheres_cast_no_shadow(monkeypatch):
    from hala_tpu_torch.models import integrator

    monkeypatch.setattr(integrator, "occluded_spheres",
                        lambda proc, o, d, t_far: torch.zeros(o.shape[0], dtype=torch.bool,
                                                              device=o.device))


@pytest.mark.parametrize("fault", [_spheres_not_merged, _spheres_cast_no_shadow],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_sphere_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not _run()["correct"]


@pytest.mark.parametrize("field,value,refusal", [
    ("base_color_map_index", 0, "base-colour map"),
    ("emission", np.ones(3, np.float32), "is emissive"),
])
def test_reference_refuses_a_sphere_material_it_does_not_cover(field, value, refusal):
    host = run.host_scene(SPHERES, SEED)
    setattr(host.materials[host.procedurals[1].material], field, value)
    with pytest.raises(ValueError, match=refusal):
        RefScene.check(host)


def test_reference_without_spheres_is_unchanged():
    cell = run.Cell(CELL)
    assert "procedurals" not in cell.config["scene"]
    tr = dict(cell.traffic, **SIZE)
    host = run.host_scene(cell.config, SEED)
    pixels = np.sort(np.random.default_rng([SEED, 1]).choice(256, 64, replace=False))
    vals, _ = compare.reference_values(cell.config, tr, host, pixels, 4, "cpu")
    assert hashlib.sha256(vals.numpy().tobytes()).hexdigest() == REFERENCE_BEFORE_SPHERES


def test_spheres_join_the_scene_before_the_poses():
    host = run.host_scene(SPHERES, SEED)
    plain = run.host_scene(run.Cell(CELL).config, SEED)
    assert len(host.materials) == len(plain.materials) + 3
    for k, (sph, spec) in enumerate(zip(host.procedurals, SPHERES["scene"]["procedurals"])):
        assert sph.material == len(plain.materials) + k
        assert sph.center == tuple(spec["center"]) and sph.radius == spec["radius"]
        m = host.materials[sph.material]
        assert m.base_color.tolist() == np.float32(spec["base_color"]).tolist()
    assert [n.local_transform.tolist() for n in host.nodes] == [
        n.local_transform.tolist() for n in plain.nodes]


def test_traced_carries_the_programs_spans(monkeypatch):
    from hala_tpu_torch.models.rt_renderer import RayTracingRenderer
    from hala_tpu_torch.utils import profiling

    tracing = []
    real_render = RayTracingRenderer.render

    def render(self, *args, **kw):
        tracing.append(profiling.enabled())
        return real_render(self, *args, **kw)

    seen = []
    monkeypatch.setattr(RayTracingRenderer, "render", render)
    monkeypatch.setattr(run, "load_reader", lambda name: lambda t: seen.append(t))
    res = _run(trace=True)
    assert res["correct"]
    # warm frame and timed window off, the device-only traced frame on,
    # the frame recording the host off
    assert tracing == [False, False, True, False]
    assert not profiling.enabled()
    traced = seen[0]
    assert traced.stage_frames == 1 and traced.stages["stages"]["hala.query"]["busy_ms"] > 0
    assert readers.span_busy_ms(traced, "hala.query") > 0
    assert readers.span_busy_ms(traced, "hala.no.such.span") is None
    assert readers.counter_per_frame(traced, "query.calls") > 0
    assert readers.counter_per_frame(traced, "no.such.counter") is None
    assert {s.name for s in traced.spans} >= {"hala.frame", "hala.query", "hala.shade"}


def test_config_without_spheres_loads_as_before():
    cfg = copy.deepcopy(SPHERES)
    del cfg["scene"]["procedurals"]
    host = run.host_scene(cfg, SEED)
    assert host.procedurals == []
    assert len(host.materials) == len(run.host_scene(run.Cell(CELL).config, SEED).materials)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from lib import refscene, reftrace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'hala_tpu_torch', 'hala_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, HERE], capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"
