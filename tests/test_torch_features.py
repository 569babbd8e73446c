"""The port's integrator features side by side with the JAX package.

Each case builds the same host scene with each package's own scene
classes, renders it through `render_frame` in both (hala_tpu on its
chunked brute force, the port through "auto", i.e. K1's plain
version), and holds the films to relative RMSE < 2e-3 (ROADMAP's
side-by-side policy). The cases cover what the goldens do not: all five
light types, Disney transmission, alpha-tested shadow surfaces stacked
up to shadow_surfaces, absorbing / scattering / emissive media, base,
metallic-roughness and normal maps with a KHR_texture_transform, and
vertex colors.
"""

import importlib
import math

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    more threads per worker only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mods(pkg):
    names = ("scene.cpu.camera", "scene.cpu.light", "scene.cpu.material",
             "scene.cpu.mesh", "scene.cpu.node", "scene.cpu.scene",
             "scene.cpu.image_data", "scene.procedural")
    return {n.split(".")[-1]: importlib.import_module(f"{pkg}.{n}") for n in names}


def _floor_scene(m, light, light_tf, material):
    scene = m["scene"].Scene()
    scene.materials = [material]
    scene.meshes = [m["mesh"].Mesh([m["procedural"].make_quad(
        [-5, 0, -5], [0, 0, 10], [10, 0, 0], 0)])]
    floor = m["node"].Node(name="floor")
    floor.mesh_index = 0
    scene.nodes.append(floor)
    ln = m["node"].Node(name="light")
    ln.local_transform = light_tf
    ln.light_index = 0
    scene.nodes.append(ln)
    scene.lights = [light]
    cn = m["node"].Node(name="cam")
    cm = np.eye(4, dtype=np.float32)
    cm[:3, 1] = [0, 0, -1]
    cm[:3, 2] = [0, 1, 0]  # look down
    cm[:3, 3] = [0, 4, 0]
    cn.local_transform = cm
    cn.camera_index = 0
    scene.nodes.append(cn)
    scene.cameras = [m["camera"].PerspectiveCamera(aspect=1.0, yfov=0.9)]
    return scene


def _down(y=3.0):
    t = np.eye(4, dtype=np.float32)
    t[:3, 1] = [0, 0, 1]
    t[:3, 2] = [0, -1, 0]  # +Z (quad emission) points down
    t[:3, 3] = [0, y, 0]
    return t


def _alpha_scene(m):
    L, Mat = m["light"], m["material"]
    scene = _floor_scene(
        m, L.Light(intensity=40.0, light_type=L.LightType.QUAD, params=(4.0, 4.0)),
        _down(6.0), Mat.Material(type=Mat.MaterialType.DIFFUSE,
                                 base_color=np.full(3, 0.8, np.float32)),
    )
    scene.materials.append(Mat.Material(
        type=Mat.MaterialType.DIFFUSE, base_color=np.ones(3, np.float32), opacity=0.5))
    for i in range(3):  # three stacked panes: exercises every shadow surface
        scene.meshes[0].primitives.append(m["procedural"].make_quad(
            [-5, 4.5 + 0.4 * i, -5], [0, 0, 10], [10, 0, 0], 1))
    scene.update_node_hierarchies()
    return scene


def _media_scene(m):
    L, Mat = m["light"], m["material"]
    box = m["procedural"].make_box
    scene = _floor_scene(
        m, L.Light(intensity=30.0, light_type=L.LightType.POINT), _down(3.5),
        Mat.Material(type=Mat.MaterialType.DIFFUSE, base_color=np.ones(3, np.float32),
                     emission=np.full(3, 0.5, np.float32)),
    )
    media = [
        (Mat.MediumType.SCATTER, [0.9, 0.9, 0.9], 1.5, 0.3, [-2.5, 1.0, 0.0], 1.1),
        (Mat.MediumType.ABSORB, [0.3, 0.6, 0.9], 1.0, 0.0, [2.5, 1.0, 0.0], 1.5),
        (Mat.MediumType.EMISSIVE, [2.0, 1.0, 0.5], 0.8, 0.0, [0.0, 1.0, 2.5], 1.02),
    ]
    for i, (mt, color, dens, aniso, center, ior) in enumerate(media):
        scene.materials.append(Mat.Material(
            type=Mat.MaterialType.DISNEY, base_color=np.ones(3, np.float32),
            roughness=0.1, specular_transmission=1.0, ior=ior,
            medium=Mat.Medium(type=mt, color=np.array(color, np.float32),
                              density=dens, anisotropy=aniso),
        ))
        scene.meshes[0].primitives += box(center, [2.0, 1.6, 2.0], i + 1)
    scene.update_node_hierarchies()
    return scene


def _texture_scene(m):
    L, Mat, Img = m["light"], m["material"], m["image_data"]
    rs = np.random.RandomState(21)
    mat = Mat.Material(type=Mat.MaterialType.DISNEY,
                       base_color=np.array([0.9, 0.8, 0.7], np.float32),
                       roughness=0.6, metallic=0.5)
    mat.base_color_map_index = 0
    mat.metallic_roughness_map_index = 1
    mat.normal_map_index = 2
    mat.uv_transform = (0.1, -0.2, 0.4, 2.0, 1.5)
    scene = _floor_scene(
        m, L.Light(intensity=25.0, light_type=L.LightType.POINT), _down(), mat)
    checker = (np.indices((32, 32)).sum(axis=0) % 2).astype(np.float32)
    base = np.stack([checker, 0.5 + 0.5 * checker, np.full_like(checker, 0.7),
                     np.ones_like(checker)], -1)
    mr = np.concatenate([rs.uniform(0, 1, (16, 16, 3)), np.ones((16, 16, 1))],
                        -1).astype(np.float32)
    n = rs.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nmap = np.concatenate([n * 0.5 + 0.5, np.ones((16, 16, 1), np.float32)], -1)
    scene.image_data = [
        Img.ImageData(im.shape[1], im.shape[0], Img.ImageFormat.R32G32B32A32_SFLOAT, im)
        for im in (base, mr, nmap)
    ]
    scene.texture2image_mapping = {0: 0, 1: 1, 2: 2}
    scene.image2data_mapping = {0: 0, 1: 1, 2: 2}
    prim = scene.meshes[0].primitives[0]
    prim.colors = np.array([[1.0, 0.2, 0.2], [0.2, 1.0, 0.2],
                            [0.2, 0.2, 1.0], [1.0, 1.0, 1.0]], np.float32)
    scene.update_node_hierarchies()
    return scene


def _lights_scene(m):
    L, N, Mat = m["light"], m["node"], m["material"]
    # No clearcoat: the reference's GTR1 NDF clamps a negative
    # denominator to 1e-12 (ops/sampling.gtr1_d), so clearcoat renders
    # radiance near -1e9 in both packages alike (ROADMAP, Queue 3).
    glass = Mat.Material(type=Mat.MaterialType.DISNEY,
                         base_color=np.array([0.9, 0.95, 1.0], np.float32),
                         roughness=0.15, specular_transmission=0.9, ior=1.45,
                         sheen=0.3, subsurface=0.4)
    scene = m["procedural"].cornell_box(tall_box_material=glass)
    specs = [
        (L.LightType.POINT, (0.0, 0.0), [0.2, 0.5, 0.1], None),
        (L.LightType.DIRECTIONAL, (0.3, 0.0), [0.0, 0.0, 0.0], 0.4),
        (L.LightType.SPOT, (0.3, 0.6), [-0.3, 0.6, 0.2], 1.1),
        (L.LightType.SPHERE, (0.1, 0.0), [-0.4, -0.3, 0.3], None),
    ]
    for lt, params, pos, rot_x in specs:
        node = N.Node(name=f"l{int(lt)}")
        t = np.eye(4, dtype=np.float32)
        if rot_x is not None:
            c, s = math.cos(rot_x), math.sin(rot_x)
            t[1:3, 1:3] = [[c, -s], [s, c]]
        t[:3, 3] = pos
        node.local_transform = t
        node.light_index = len(scene.lights)
        scene.nodes.append(node)
        scene.lights.append(L.Light(color=np.array([1.0, 0.8, 0.6], np.float32),
                                    intensity=2.0, light_type=lt, params=params))
    scene.update_node_hierarchies()
    return scene


CASES = {
    # name: (builder, max_depth, frames, flags the case must switch on)
    "alpha_shadow_surfaces": (_alpha_scene, 3, 4, ("has_alpha",)),
    "media": (_media_scene, 6, 4, ("has_scatter_medium", "has_absorb_medium",
                                   "has_emissive_medium", "has_transmission")),
    "textures": (_texture_scene, 3, 4, ("has_normal_map", "has_uv_transform")),
    "lights_and_glass": (_lights_scene, 4, 4, ("has_transmission",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_render_side_by_side(case):
    from hala_tpu.models import integrator as jint
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp
    from hala_tpu_torch.models import integrator as tint
    from hala_tpu_torch.scene.loader.uploader import SceneUploader as TUp

    build, depth, frames, flags = CASES[case]
    size = 24
    jdev = JUp.upload(build(_mods("hala_tpu")), use_ray_tracing=False)
    tdev = TUp.upload(build(_mods("hala_tpu_torch")), use_ray_tracing=False, device="cpu")
    for flag in flags:
        assert getattr(tdev.materials, flag), flag
    if case == "textures":
        assert tdev.geometry.shade_table.shape[1] == 48  # vertex colors

    js = jint.RenderSettings(width=size, height=size, max_depth=depth, rr_depth=2,
                             tile_size=size * size, intersector="bruteforce")
    jfilm = jint.Film.create(size, size)
    for f in range(frames):
        jfilm, _ = jint.render_frame(jdev, None, jint.Uniforms.default(), jfilm, f, js)
    ts = tint.RenderSettings(width=size, height=size, max_depth=depth, rr_depth=2,
                             tile_size=size * size)
    tfilm = tint.Film.create(size, size, "cpu")
    for f in range(frames):
        tint.render_frame(tdev, None, tint.Uniforms.default("cpu"), tfilm, f, ts)
    for k in ("accum", "albedo", "normal"):
        ref = np.asarray(getattr(jfilm, k))[..., :3]
        got = getattr(tfilm, k).numpy()[..., :3]
        assert np.isfinite(got).all()
        scale = float(np.sqrt(np.mean(ref ** 2)))
        assert scale > 1e-3, k
        # A path can take another branch in the two packages where a
        # comparison sits within rounding of its threshold. Measured:
        # 2 of 576 pixels in "lights_and_glass" (frames 2 and 3), where
        # hala_tpu's own answer depends on its batch (the same ray traced
        # alone by hala_tpu gives the port's value); 0 in the other
        # cases. So: at most 1 % of pixels may diverge, and the rest
        # hold to the side-by-side bound.
        agree = np.all(np.abs(got - ref) <= 1e-3 * (np.abs(ref) + 1e-2), axis=-1)
        assert agree.mean() >= 0.99, (k, int((~agree).sum()))
        rel = float(np.sqrt(np.mean((got - ref)[agree] ** 2))) / scale
        assert rel < 2e-3, (k, rel)
    assert float(torch.mean(tfilm.accum[..., :3])) > 1e-3
