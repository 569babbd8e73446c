"""The analytic oracle of tests/test_oracle.py on the port.

A single diffuse floor under a quad light has the closed-form reflected
radiance L = albedo / pi * Le * F(P), with F the exact Lambert polygon
formula over the quad's corner directions from P. The port's NEE + MIS
estimate (quad sampling pdf, MIS weights, BSDF albedo / pi, cosine
factors, radiance conventions) must converge to it: the same scene, the
same settings and frames and the same bound (relative 4e-3) as the JAX
package's test, on the CPU (the brute-force kernel's plain version
carries the visibility queries). No JAX.
"""

import numpy as np
import torch

from hala_tpu_torch.models.integrator import (
    ENV_SKY, Film, RenderSettings, Uniforms, render_frame,
)
from hala_tpu_torch.scene.cpu.camera import OrthographicCamera
from hala_tpu_torch.scene.cpu.light import Light, LightType
from hala_tpu_torch.scene.cpu.mesh import Mesh
from hala_tpu_torch.scene.cpu.node import Node
from hala_tpu_torch.scene.cpu.scene import Scene
from hala_tpu_torch.scene.loader.uploader import SceneUploader
from hala_tpu_torch.scene.procedural import _diffuse, make_quad

ALBEDO = 0.6
LE = 2.0          # quad emitted radiance (record intensity, color=1)
QW, QH = 0.8, 0.6  # quad extent
QY = 1.0           # quad height above the floor


def _scene():
    scene = Scene()
    scene.materials = [_diffuse([ALBEDO] * 3)]
    # floor: y=0 plane spanning [-4,4]^2, normal +Y
    scene.meshes = [Mesh(primitives=[
        make_quad([-4, 0, -4], [0, 0, 8], [8, 0, 0], 0)
    ])]
    root = Node(name="root")
    root.mesh_index = 0
    scene.nodes.append(root)

    # quad light at y=QY, emitting downward (-Y): node z-axis = -Y
    ln = Node(name="light")
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = [1, 0, 0]
    m[:3, 1] = [0, 0, 1]
    m[:3, 2] = [0, -1, 0]
    m[:3, 3] = [0, QY, 0]
    ln.local_transform = m
    ln.light_index = 0
    scene.nodes.append(ln)
    scene.lights = [Light(
        color=np.ones(3, np.float32), intensity=LE,
        light_type=LightType.QUAD, params=(QW, QH),
    )]

    # orthographic camera looking straight down from y=0.5 (between
    # floor and light, so primaries always hit the floor), covering
    # [-xmag, xmag] x [-ymag, ymag] on the floor.
    cn = Node(name="camera")
    cm = np.eye(4, dtype=np.float32)
    # forward = -z axis of the node; point it at -Y: z axis = +Y
    cm[:3, 0] = [1, 0, 0]
    cm[:3, 1] = [0, 0, 1]
    cm[:3, 2] = [0, 1, 0]
    cm[:3, 3] = [0, 0.5, 0]
    cn.local_transform = cm
    cn.camera_index = 0
    scene.nodes.append(cn)
    scene.cameras = [OrthographicCamera(xmag=0.5, ymag=0.5)]
    scene.update_node_hierarchies()
    return SceneUploader.upload(scene, use_ray_tracing=False, device="cpu")


def _analytic_L(px_world, pz_world):
    """Exact reflected radiance at floor points (x, 0, z): Lambert's
    polygon irradiance formula for the quad [-QW/2,QW/2]x[-QH/2,QH/2]
    at height QY, seen from below."""
    x = px_world[..., None]
    z = pz_world[..., None]
    # corners ordered so the boundary winds positively around +Y seen
    # from the floor point
    cx = np.array([-QW / 2, QW / 2, QW / 2, -QW / 2])
    cz = np.array([-QH / 2, -QH / 2, QH / 2, QH / 2])
    gx = cx - x
    gy = np.full_like(gx, QY)
    gz = cz - z
    norm = np.sqrt(gx * gx + gy * gy + gz * gz)
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    F = 0.0
    for i in range(4):
        j = (i + 1) % 4
        d = np.clip(gx[..., i] * gx[..., j] + gy[..., i] * gy[..., j]
                    + gz[..., i] * gz[..., j], -1.0, 1.0)
        # cross(g_i, g_j) . n with n = +Y
        cry = gz[..., i] * gx[..., j] - gx[..., i] * gz[..., j]
        crn = np.sqrt(
            (gy[..., i] * gz[..., j] - gz[..., i] * gy[..., j]) ** 2
            + cry ** 2
            + (gx[..., i] * gy[..., j] - gy[..., i] * gx[..., j]) ** 2
        )
        F = F + np.arccos(d) * (cry / np.maximum(crn, 1e-12))
    F = np.abs(F) * 0.5 / np.pi  # form factor (E = Le * pi * F ... see below)
    # Lambert: E = Le/2 * sum acos(.) (unit-cross . n)  ->  F above is
    # E/(Le*pi); reflected radiance L = albedo/pi * E = albedo * Le * F
    return ALBEDO * LE * F


def test_quad_light_matches_analytic():
    scene = _scene()
    size = 64
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=8,
        tile_size=size * size, env_type=ENV_SKY,
    )
    uniforms = Uniforms.default("cpu")
    # kill the sky so ONLY the quad contributes
    uniforms.ground_color = torch.zeros(3)
    uniforms.sky_color = torch.zeros(3)
    uniforms.env_intensity = torch.tensor(0.0)
    film = Film.create(size, size, "cpu")
    frames = 96
    for f in range(frames):
        render_frame(scene, None, uniforms, film, f, settings)
    acc = film.accum.numpy()[..., 0]  # accum is the running mean

    # region mean over the central half of the image vs the analytic
    # mean over the same footprint (ortho: pixel (i, j) covers
    # x in [-0.5 + j/size, ...], z row mapping via ndc_y flip + node
    # orientation; averaging over a symmetric centered region makes the
    # exact row orientation irrelevant)
    q = size // 4
    region = acc[q:3 * q, q:3 * q]
    # dense quadrature over the same world rectangle [-0.25,0.25]^2
    g = (np.arange(4 * size) + 0.5) / (4 * size) - 0.5
    gx, gz = np.meshgrid(g * 0.5, g * 0.5)  # half-extent region grid
    ana = _analytic_L(gx, gz).mean()
    got = float(region.mean())
    rel = abs(got - ana) / ana
    assert rel < 4e-3, (got, ana, rel)
