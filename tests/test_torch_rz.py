"""The port's RasterizationRenderer and programs beside the JAX package's.

Goldens: tests/test_golden.py's raster settings through the port, RMSE
below 1e-3 against the fixtures. Side by side: each case builds the same
host scene with each package's own classes, renders it through both
renderers on the CPU, and holds the images to relative RMSE < 2e-3
(ROADMAP's side-by-side policy). Hooks and kernels are written once, in
operators both array types take.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from hala_tpu_torch.error import HalaRendererError
from hala_tpu_torch.models.rz_renderer import CLEAR_COLOR, RasterizationRenderer
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.procedural import cornell_box

HERE = os.path.dirname(__file__)
ATRIUM = os.path.join(HERE, "..", "assets", "atrium.glb")
RMSE_TOL = 1e-3
REL_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_kernel_caches():
    """Pushed rz.* kernels live in each package's process-wide cache."""
    from hala_tpu.programs import KernelCache as JCache
    from hala_tpu_torch.programs import KernelCache as TCache

    yield
    JCache.get_instance().clear()
    TCache.get_instance().clear()


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2)))


def _rel(got, ref):
    return _rmse(got, ref) / max(_rmse(ref, 0.0), 1e-12)


def _mods(pkg):
    names = ("scene.cpu.camera", "scene.cpu.light", "scene.cpu.material",
             "scene.cpu.mesh", "scene.cpu.node", "scene.cpu.scene",
             "scene.procedural")
    return {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}") for n in names}


def _glass_scene(pkg, front_a=0.4, mid_a=0.6):
    """tests/conftest.py make_glass_scene for either package: an opaque
    back wall and two transparent full-screen quads."""
    m = _mods(pkg)
    scene = m["scene"].Scene()
    mat = m["material"]
    mats = [mat.Material(type=mat.MaterialType.DIFFUSE,
                         base_color=np.array([0.6, 0.2, 0.2], np.float32))]
    prims = [m["procedural"].make_quad([-2, -2, -1], [4, 0, 0], [0, 4, 0], 0)]
    for z, a, col in [(-0.5, mid_a, [0.2, 0.6, 0.2]), (0.0, front_a, [0.8, 0.8, 0.9])]:
        mats.append(mat.Material(type=mat.MaterialType.DIFFUSE,
                                 base_color=np.array(col, np.float32),
                                 opacity=np.float32(a)))
        prims.append(m["procedural"].make_quad([-2, -2, z], [4, 0, 0], [0, 4, 0],
                                               len(mats) - 1))
    scene.materials = mats
    scene.meshes = [m["mesh"].Mesh(primitives=prims)]
    root = m["node"].Node(name="root")
    root.mesh_index = 0
    scene.nodes.append(root)
    light_node = m["node"].Node(name="light")
    lm = np.eye(4, dtype=np.float32)
    lm[:3, 3] = [0, 0, 2.5]
    light_node.local_transform = lm
    light_node.light_index = 0
    scene.nodes.append(light_node)
    scene.lights = [m["light"].Light(color=np.ones(3, np.float32), intensity=30.0,
                                     light_type=m["light"].LightType.POINT)]
    cam_node = m["node"].Node(name="camera")
    cm = np.eye(4, dtype=np.float32)
    cm[:3, 3] = [0, 0, 3.0]
    cam_node.local_transform = cm
    cam_node.camera_index = 0
    scene.nodes.append(cam_node)
    scene.cameras = [m["camera"].PerspectiveCamera(aspect=1.0, yfov=0.7, znear=0.1,
                                                   focal_distance=3.0)]
    scene.update_node_hierarchies()
    return scene


def _host(pkg, name):
    if name == "cornell":
        return _mods(pkg)["procedural"].cornell_box()
    if name == "atrium":
        return _mods(pkg)["scene"].Scene.load(ATRIUM)
    return _glass_scene(pkg)


def _post(pkg):
    prog = importlib.import_module(f"{pkg}.programs.compute_program")
    return prog.ComputeProgram(prog.ComputeProgramDesc(
        shader_file_path=f"{pkg}.ops.tonemap:tonemap_aces_simple"))


def _fragment_hook(color, albedo, normal):
    return color * 0.5 + albedo * 0.25, albedo, normal


def _vertex_hook(corners):
    return corners * 0.9


def _task_hook(meshlets, eye):
    return meshlets.center[:, 0] > 0.0


# name: (scene, size, renderer kwargs, pushed hooks, extra step)
CASES = {
    "forward": ("cornell", 32, dict(chunk=128), None, None),
    "deferred_relight": ("cornell", 32, dict(use_deferred=True, chunk=128), None, "relight"),
    "msaa2": ("cornell", 24, dict(msaa=2, chunk=128), None, None),
    "binned": ("cornell", 32, dict(binned=True, tile=16), None, None),
    "mesh_shader": ("atrium", 32, dict(use_mesh_shader=True, tile=16), None, None),
    "peel_forward": ("glass", 24, dict(chunk=128), None, None),
    "peel_deferred_additive": ("glass", 24, dict(use_deferred=True, chunk=128,
                                                 blend="additive"), None, None),
    "fragment_vertex_hooks": ("cornell", 32, dict(chunk=128), "traditional", None),
    "task_mesh_hooks": ("atrium", 32, dict(use_mesh_shader=True, tile=16), "mesh", None),
    "post_and_ui": ("cornell", 32, dict(binned=True, tile=16, enable_tonemap=True),
                    None, "post"),
}


def _render(pkg, case):
    mod = importlib.import_module(f"{pkg}.models.rz_renderer")
    scene_name, size, kw, hooks, extra = CASES[case]
    kw = dict(kw)
    if extra == "post":
        kw["post_program"] = _post(pkg)
    if pkg == "hala_tpu_torch":
        kw["device"] = "cpu"
    r = mod.RasterizationRenderer(case, size, size, **kw)
    if hooks == "traditional":
        r.push_traditional_kernels(_vertex_hook, _fragment_hook)
    elif hooks == "mesh":
        r.push_kernels(_vertex_hook, _fragment_hook, task=_task_hook)
    r.set_scene(_host(pkg, scene_name))
    r.commit()
    r.update(ui_fn=(lambda img: img * 0.8) if extra == "post" else None)
    if extra == "relight":
        lights = r.scene.lights
        if pkg == "hala_tpu_torch":
            lights.intensity.mul_(2.0)
        else:
            r.scene = dataclasses.replace(
                r.scene, lights=dataclasses.replace(lights, intensity=lights.intensity * 2.0))
        r.relight()
    return r


@pytest.mark.parametrize("case", sorted(CASES))
def test_side_by_side_with_jax(case):
    j = _render("hala_tpu", case)
    t = _render("hala_tpu_torch", case)
    ref = np.asarray(j.get_final_image())
    got = t.get_final_image()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert _rel(got, ref) < REL_TOL, _rel(got, ref)
    for k in ("albedo", "normal", "depth"):
        gref = np.asarray(j.gbuffer[k])
        assert _rel(t.gbuffer[k].numpy(), gref) < REL_TOL, k
    assert np.abs(got - np.asarray(CLEAR_COLOR)).sum(-1).max() > 1e-3  # not all clear


@pytest.mark.parametrize("name,kw", [
    ("raster", dict(chunk=128)),
    ("raster_atrium", dict(binned=True, tile=16)),
])
def test_golden(name, kw):
    """tests/test_golden.py TestGoldenRaster / TestGoldenRasterAtrium
    through the port; the atrium case runs K3's plain version on the
    asset's 34k triangles."""
    r = RasterizationRenderer("golden", 48, 48, device="cpu", **kw)
    r.set_scene(cornell_box() if name == "raster" else Scene.load(ATRIUM))
    r.commit()
    r.update()
    img = r.get_final_image()
    with np.load(os.path.join(HERE, "fixtures", f"golden_{name}.npz")) as z:
        assert _rmse(img, z["color"]) < RMSE_TOL
    assert float(img.mean()) > 0.05


def test_graphics_program_draw_matches_jax():
    from hala_tpu.programs.graphics_program import GraphicsProgram as JG
    from hala_tpu.programs.graphics_program import GraphicsProgramDesc as JD
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp
    from hala_tpu_torch.programs import GraphicsProgram, GraphicsProgramDesc
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    jp = JG(JD(), JUp.upload(_host("hala_tpu", "cornell"), use_ray_tracing=False))
    tp = GraphicsProgram(GraphicsProgramDesc(),
                         SceneUploader.upload(cornell_box(), use_ray_tracing=False, device="cpu"))
    jc, _ = jp.draw(24, 24)
    tc, tg = tp.draw(24, 24)
    assert _rel(tc.numpy(), np.asarray(jc)) < REL_TOL
    n = tp.scene.geometry.tri_mat.shape[0]
    full, _ = tp.draw_indirect(torch.tensor(n, dtype=torch.int32), 24, 24)
    assert torch.equal(full, tc)
    none, gnone = tp.draw_indirect(0, 24, 24)
    assert float(gnone["depth"].abs().max()) == 0.0
    jnone, _ = jp.draw_indirect(0, 24, 24)
    assert _rel(none.numpy(), np.asarray(jnone)) < REL_TOL


def test_graphics_desc_validation_and_blend():
    from hala_tpu_torch.programs import BlendState, GraphicsProgram, GraphicsProgramDesc
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    d = GraphicsProgramDesc.from_json(
        '{"color_blend": {"src_factor": "src_alpha", '
        '"dst_factor": "one_minus_src_alpha", "op": "add"}}')
    assert d.validate() == "over"
    assert GraphicsProgramDesc.from_json(d.to_json()).validate() == "over"
    assert GraphicsProgramDesc(mesh_shader_file_path="builtin:meshlet").uses_mesh_shader
    for bad, match in ((dict(primitive_topology="line_strip"), "topology"),
                       (dict(multisample_count=3), "multisample"),
                       (dict(deferred=True, multisample_count=2), "Multisampling"),
                       (dict(color_blend=BlendState("dst_color", "src_color", "add")), "blend"),
                       (dict(task_shader_file_path="t:f"), "task shader"),
                       (dict(mesh_shader_file_path="m:f", vertex_shader_file_path="v:f"),
                        "mutually exclusive")):
        with pytest.raises(HalaRendererError, match=match):
            GraphicsProgramDesc(**bad).validate()
    scene = SceneUploader.upload(_glass_scene("hala_tpu_torch"), use_ray_tracing=False, device="cpu")
    over = GraphicsProgram(GraphicsProgramDesc(), scene)
    add = GraphicsProgram(GraphicsProgramDesc(color_blend=BlendState("one", "one", "add")),
                          scene)
    assert over.blend == "over" and add.blend == "additive"
    assert float((add.draw(16, 16)[0] - over.draw(16, 16)[0]).abs().max()) > 0.01


def test_compute_program_and_kernel_cache():
    from hala_tpu_torch.programs import ComputeProgram, ComputeProgramDesc, KernelCache

    cache = KernelCache.get_instance()
    with pytest.raises(HalaRendererError):
        cache.load("no_such_module:fn")
    with pytest.raises(HalaRendererError):
        cache.load("not-a-kernel-path")
    prog = ComputeProgram(ComputeProgramDesc(
        shader_file_path="hala_tpu_torch.ops.tonemap:tonemap_reinhard_lum"))
    assert float(prog.dispatch(torch.full((1, 3), 1.5)).max()) < 1.0
    desc = ComputeProgramDesc(shader_file_path="m:f", push_constant_size=8,
                              bindings=["a", "b"])
    assert ComputeProgramDesc.from_json(desc.to_json()) == desc
    cache.from_memory("test.masked_double", lambda count, buf: torch.where(
        torch.arange(buf.shape[0]) < count, buf * 2.0, buf))
    out = ComputeProgram(ComputeProgramDesc(shader_file_path="test.masked_double")
                         ).dispatch_indirect(torch.tensor(3) + 2, torch.arange(8.0))
    assert out.tolist() == [0.0, 2.0, 4.0, 6.0, 8.0, 5.0, 6.0, 7.0]
    cache.set_kernel_dir("hala_tpu_torch.ops")
    try:
        assert cache.load("tonemap:tonemap_aces_simple") is not None
    finally:
        cache.set_kernel_dir("")


def test_renderer_error_probes():
    with pytest.raises(HalaRendererError, match="Multisampling"):
        RasterizationRenderer("e", 8, 8, use_deferred=True, msaa=2, device="cpu")
    with pytest.raises(HalaRendererError, match="blend"):
        RasterizationRenderer("e", 8, 8, blend="multiply", device="cpu")
    r = RasterizationRenderer("e", 8, 8, device="cpu")
    with pytest.raises(HalaRendererError, match="before set_scene"):
        r.commit()
    with pytest.raises(HalaRendererError, match="use_mesh_shader=True"):
        r.push_kernels(_vertex_hook, _fragment_hook)
    with pytest.raises(HalaRendererError, match="use_mesh_shader=False"):
        RasterizationRenderer("e", 8, 8, use_mesh_shader=True,
                              device="cpu").push_traditional_kernels(_vertex_hook,
                                                                     _fragment_hook)
    r.set_scene(cornell_box())
    r.update()
    with pytest.raises(HalaRendererError, match="deferred"):
        r.relight()
    d = RasterizationRenderer("e", 8, 8, use_deferred=True, device="cpu")
    d.set_scene(cornell_box())
    d.commit()
    with pytest.raises(HalaRendererError, match="before update"):
        d.relight()


def test_save_image_and_device_lost_restore(tmp_path):
    from hala_tpu_torch.utils.pfm import read_pfm

    r = RasterizationRenderer("lost", 16, 16, chunk=128, device="cpu")
    r.set_scene(cornell_box())
    r.update()
    r.render()
    before = r.get_final_image()
    r.save_image(str(tmp_path / "ok.pfm"))
    assert np.array_equal(read_pfm(str(tmp_path / "ok.pfm")), before)

    def lost():
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    r.update()
    r._sync = lost
    r.render()
    assert r.is_device_lost
    r.save_image(str(tmp_path / "lost.pfm"))  # refused while lost
    assert not (tmp_path / "lost.pfm").exists()
    del r._sync
    r.update()  # restores: re-uploads the scene, then renders
    assert not r.is_device_lost
    assert np.array_equal(r.get_final_image(), before)


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(HalaRendererError, match="cuda"):
        RasterizationRenderer("default", 8, 8)
