"""Tests of the comparison that decides `correct`, on the CPU at sizes a
test run holds: the program's plain versions stand in for its kernels.

    python3 -m pytest -q bench_port/tests

- a sound run of each cell reads no pixel off;
- the control (the reference in bfloat16 in the program's place) reads
  above each cell's limit;
- a run with the timed path broken underneath reads `correct` false, once
  for each fault the cell can have: a frame that leaves its output as it
  was (the path tracer's film not accumulated; the rasterizer's image of
  the previous pose shown again, which the camera path makes wrong),
  half of each batch left out, and a visibility answer altered where it
  is produced. No cell spans chips, so none can drop an exchange between
  them.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import control  # noqa: E402
import run  # noqa: E402
from lib import compare  # noqa: E402

SEED = 2**31 + 977
SIZES = {
    "atrium_big.trace_1080p": dict(width=16, height=16, check_pixels=64),
    "atrium_big.raster_1080p": dict(width=32, height=32, check_pixels=256),
    "cornell.raster_1080p": dict(width=64, height=32, check_pixels=512),
}
TINY = dict(warm_frames=1, traced_frames=1)
SECONDS = 0.0  # a window of one frame


def _run(cell_name, trace=False):
    cell = run.Cell(cell_name)
    return run.run_cell(cell, SEED, SECONDS, trace, device="cpu",
                        overrides=dict(SIZES[cell_name], **TINY), log=lambda *_: None)


@pytest.mark.parametrize("cell_name", list(SIZES))
def test_sound_run_is_correct(cell_name):
    res = _run(cell_name)
    assert res["correct"]
    assert res["checks"]["pixels_off_pct"]["value"] == 0.0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell_name", list(SIZES))
def test_control_fails(cell_name):
    cell = run.Cell(cell_name)
    frames = 4 if cell.traffic["renderer"] == "trace" else 2
    pct = control.control_pct(cell, SEED, frames, "cpu", SIZES[cell_name])
    assert pct > compare.limits(cell_name)["pixels_off_pct"]


def _unchanged(monkeypatch):
    from hala_tpu_torch.models import rt_renderer

    real = rt_renderer.render_frame

    def render_frame(scene, env, uniforms, film, frame_index, settings, **kw):
        if frame_index == 0:
            return real(scene, env, uniforms, film, frame_index, settings, **kw)
        return film, torch.zeros((), device=film.accum.device)

    monkeypatch.setattr(rt_renderer, "render_frame", render_frame)


def _half_trace(monkeypatch):
    from hala_tpu_torch.models import integrator

    real = integrator.trace_paths

    def trace_paths(*args, **kw):
        out = real(*args, **kw)
        n = out[0].shape[0]
        keep = (torch.arange(n, device=out[0].device) < n // 2)[:, None]
        return tuple(torch.where(keep, x, 0.0) for x in out[:3]) + (out[3],)

    monkeypatch.setattr(integrator, "trace_paths", trace_paths)


def _altered_trace(monkeypatch):
    from hala_tpu_torch.models import integrator

    real = integrator._intersect_local

    def intersect_local(*args, **kw):
        hit = real(*args, **kw)
        return hit._replace(t=hit.t * (1.0 + 1e-3))

    monkeypatch.setattr(integrator, "_intersect_local", intersect_local)


def _stale_raster(monkeypatch):
    from hala_tpu_torch.models import rz_renderer

    real = rz_renderer.raster_frame
    first = []

    def raster_frame(*args, **kw):
        if not first:
            first.append(real(*args, **kw))
        return first[0]

    monkeypatch.setattr(rz_renderer, "raster_frame", raster_frame)


def _frag_fault(monkeypatch, change):
    from hala_tpu_torch.models import rz_renderer

    real = rz_renderer.gbuffer_pass

    def gbuffer_pass(*args, **kw):
        return change(real(*args, **kw))

    monkeypatch.setattr(rz_renderer, "gbuffer_pass", gbuffer_pass)


def _half_raster(monkeypatch):
    def change(frag):
        n = frag.tri.shape[0]
        drop = torch.arange(n, device=frag.tri.device) >= n // 2
        return frag._replace(tri=torch.where(drop, -1, frag.tri),
                             depth=torch.where(drop, 0.0, frag.depth))

    _frag_fault(monkeypatch, change)


def _altered_raster(monkeypatch):
    _frag_fault(monkeypatch, lambda frag: frag._replace(u=frag.u * (1.0 - 1e-3)))


FAULTS = [
    ("atrium_big.trace_1080p", _unchanged), ("atrium_big.trace_1080p", _half_trace),
    ("atrium_big.trace_1080p", _altered_trace),
    ("atrium_big.raster_1080p", _stale_raster), ("atrium_big.raster_1080p", _half_raster),
    ("atrium_big.raster_1080p", _altered_raster),
    ("cornell.raster_1080p", _stale_raster), ("cornell.raster_1080p", _half_raster),
    ("cornell.raster_1080p", _altered_raster),
]


@pytest.mark.parametrize("cell_name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_broken_path_is_not_correct(cell_name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell_name)
    assert not res["correct"]


def test_roofline_reader_refuses_a_trace_that_does_not_match_the_probes():
    from types import SimpleNamespace

    from lib import readers

    op = SimpleNamespace(name="matrix_walk_kernel", start=0, end=1000)
    run_ = SimpleNamespace(captured={"k2": [], "calls": {"k2": 2}},
                           trace=SimpleNamespace(dev_ops=[op]))
    with pytest.raises(RuntimeError, match="no longer match"):
        readers.roofline_share(run_, "k2")
    silent = SimpleNamespace(captured={"k2": [], "calls": {"k2": 0}},
                             trace=SimpleNamespace(dev_ops=[]))
    assert readers.roofline_share(silent, "k2") is None
