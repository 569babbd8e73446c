"""The plain reference's own device tables, built from the host scene.

The host scene (the parsed glTF file, or the scene built from a
configuration's published quads, with the seeded camera poses written
in) is the input that the benchmark hands to the program's `set_scene`. Everything the program's uploader derives
from it (world-space triangles, per-corner shading attributes, material
rows, light records, the camera frame, the mip pyramids) is derived here
again, in plain numpy and torch, with the arithmetic the renderer's
documented semantics fix. Nothing is read from the program's device
tables, and nothing of the program is imported.

Only what the benchmark's configurations use is supported: DIFFUSE
(Oren-Nayar) materials, base-colour maps, quad lights, the sky
environment, a perspective pinhole camera and procedural spheres whose
material is DIFFUSE with no map. `RefScene.check` refuses a scene with
anything else, so a later configuration cannot be compared against a
reference that silently ignores part of it.
"""

from __future__ import annotations

import numpy as np
import torch

_NO_MAP = 0xFFFFFFFF
_IDENTITY_UV = (0.0, 0.0, 0.0, 1.0, 1.0)
QUAD = 3
DIFFUSE = 0


def _enum_int(x) -> int:
    return int(getattr(x, "value", x))


class RefScene:
    """World-space tables of one host scene on `device` in `dtype`
    (float32 for the reference, a lower precision for its control)."""

    def __init__(self, host, device, dtype=torch.float32, camera: int = 0):
        self.device = torch.device(device)
        self.dtype = dtype
        self.check(host)
        self._geometry(host)
        self._materials(host)
        self._lights(host)
        self._camera(host, camera)
        self._textures(host)
        self._spheres(host)

    # -- what the reference covers ------------------------------------

    @staticmethod
    def check(host) -> None:
        bad = []
        for i, m in enumerate(host.materials):
            if _enum_int(m.type) != DIFFUSE:
                bad.append(f"material {i} is not DIFFUSE")
            if m.opacity < 1.0:
                bad.append(f"material {i} has opacity {m.opacity}")
            if _enum_int(m.medium.type) != 0:
                bad.append(f"material {i} has a medium")
            if tuple(m.uv_transform) != _IDENTITY_UV:
                bad.append(f"material {i} has a uv transform")
            for key in ("normal_map_index", "metallic_roughness_map_index",
                        "emission_map_index"):
                if getattr(m, key) != _NO_MAP:
                    bad.append(f"material {i} has {key}")
            if np.any(np.asarray(m.emission) != 0):
                bad.append(f"material {i} is emissive")
        for i, lt in enumerate(host.lights):
            if _enum_int(lt.light_type) != QUAD:
                bad.append(f"light {i} is not a quad")
        for i, c in enumerate(host.cameras):
            if not hasattr(c, "yfov") or c.aperture != 0.0:
                bad.append(f"camera {i} is not a pinhole perspective camera")
        for mesh in host.meshes:
            for p in mesh.primitives:
                if p.colors is not None:
                    bad.append("a primitive has vertex colours")
        for i, sph in enumerate(host.procedurals):
            # the loop above refuses every material's emission, opacity,
            # medium and other maps; a sphere's also takes no base-colour map
            if host.materials[sph.material].base_color_map_index != _NO_MAP:
                bad.append(f"sphere {i}'s material has a base-colour map")
        if bad:
            raise ValueError("reference does not cover: " + "; ".join(sorted(set(bad))))

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            self.device, dtype or self.dtype)

    # -- geometry -----------------------------------------------------

    def _geometry(self, host) -> None:
        """Triangles in (node, primitive, index) order: v0, e1, e2, and
        per triangle the corner normals, uvs and tangents, the unit
        geometric normal, the material and the uv texel density."""
        v0s, e1s, e2s, ns, ts, uvs, mats = [], [], [], [], [], [], []
        for node in host.nodes:
            if node.mesh_index is None:
                continue
            mesh = host.meshes[node.mesh_index]
            w = node.world_transform
            nrm_mtx = np.linalg.inv(w[:3, :3]).T
            p_tri, p_pos, p_nrm, p_tan, p_uv, p_mat, p_cnt = [], [], [], [], [], [], []
            off = 0
            for prim in mesh.primitives:
                tri = prim.indices.reshape(-1, 3).astype(np.int64)
                p_tri.append(tri + off)
                off += prim.positions.shape[0]
                p_pos.append(prim.positions)
                p_nrm.append(prim.normals)
                p_tan.append(prim.tangents)
                p_uv.append(prim.tex_coords)
                p_mat.append(-1 if prim.material_index == _NO_MAP else prim.material_index)
                p_cnt.append(len(tri))
            if not p_tri:
                continue
            tri = np.concatenate(p_tri)
            pos_w = np.concatenate(p_pos) @ w[:3, :3].T + w[:3, 3]
            nrm_w = np.concatenate(p_nrm) @ nrm_mtx.T
            nrm_len = np.linalg.norm(nrm_w, axis=1, keepdims=True)
            nrm_w = np.where(nrm_len > 0, nrm_w / nrm_len, nrm_w)
            tan_w = np.concatenate(p_tan) @ w[:3, :3].T
            uv_n = np.concatenate(p_uv)
            a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
            v0s.append(pos_w[a])
            e1s.append(pos_w[b] - pos_w[a])
            e2s.append(pos_w[c] - pos_w[a])
            ns.append(np.stack([nrm_w[a], nrm_w[b], nrm_w[c]], axis=1))
            ts.append(np.stack([tan_w[a], tan_w[b], tan_w[c]], axis=1))
            uvs.append(np.stack([uv_n[a], uv_n[b], uv_n[c]], axis=1))
            mats.append(np.repeat(np.asarray(p_mat, np.int32), np.asarray(p_cnt)))
        v0 = np.concatenate(v0s).astype(np.float32)
        e1 = np.concatenate(e1s).astype(np.float32)
        e2 = np.concatenate(e2s).astype(np.float32)
        n = v0.shape[0]
        ng = np.cross(e1, e2)
        ng_len = np.linalg.norm(ng, axis=1, keepdims=True)
        ng = np.where(ng_len > 0, ng / np.maximum(ng_len, 1e-30), ng).astype(np.float32)
        uv = np.concatenate(uvs).astype(np.float32)
        uv3 = uv.reshape(n, 3, 2)
        uv_area = 0.5 * np.abs(
            (uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
            - (uv3[:, 1, 1] - uv3[:, 0, 1]) * (uv3[:, 2, 0] - uv3[:, 0, 0]))
        world_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        dens = np.sqrt(uv_area / np.maximum(world_area, 1e-12)).astype(np.float32)
        self.num_triangles = n
        self.v0, self.e1, self.e2 = self._t(v0), self._t(e1), self._t(e2)
        self.normals = self._t(np.concatenate(ns).astype(np.float32))   # (T, 3, 3)
        self.tangents = self._t(np.concatenate(ts).astype(np.float32))  # (T, 3, 3)
        self.uvs = self._t(uv)                                          # (T, 3, 2)
        self.ng = self._t(ng)
        self.uv_density = self._t(dens)
        self.tri_mat = torch.as_tensor(np.concatenate(mats)).to(self.device, torch.int64)

    # -- materials ----------------------------------------------------

    def _materials(self, host) -> None:
        """Base colour, Oren-Nayar A and B (sigma = roughness * pi / 4)
        and the base-colour map per material."""
        base, a_on, b_on, maps = [], [], [], []
        for m in host.materials:
            sigma = m.roughness * 0.5 * (np.pi / 2.0)
            sigma2 = sigma * sigma
            base.append(np.asarray(m.base_color, np.float32))
            a_on.append(1.0 - sigma2 / (2.0 * (sigma2 + 0.33)))
            b_on.append(0.45 * sigma2 / (sigma2 + 0.09))
            maps.append(-1 if m.base_color_map_index == _NO_MAP else int(m.base_color_map_index))
        self.mat_base = self._t(np.stack(base))
        self.mat_a = self._t(np.asarray(a_on, np.float32))
        self.mat_b = self._t(np.asarray(b_on, np.float32))
        self.mat_map = torch.as_tensor(maps, dtype=torch.int64, device=self.device)

    # -- lights -------------------------------------------------------

    def _lights(self, host) -> None:
        """Quad lights: corner, edge vectors, radiance and area. A light
        node's x and y axes span the quad; it emits along +z."""
        inten, corner, eu, ev, area = [], [], [], [], []
        for node in host.nodes:
            if node.light_index is None:
                continue
            lt = host.lights[node.light_index]
            w = node.world_transform
            x_axis, y_axis, w_axis = w[:3, 0], w[:3, 1], w[:3, 3]
            p0, p1 = lt.params
            inten.append(np.asarray(lt.color * np.float32(lt.intensity), np.float32))
            corner.append(np.asarray(w_axis - x_axis * (p0 * 0.5) - y_axis * (p1 * 0.5), np.float32))
            eu.append(np.asarray(x_axis * p0, np.float32))
            ev.append(np.asarray(y_axis * p1, np.float32))
            area.append(np.float32(p0 * p1))
        self.num_lights = len(inten)
        self.light_rad = self._t(np.stack(inten))
        self.light_corner = self._t(np.stack(corner))
        self.light_u = self._t(np.stack(eu))
        self.light_v = self._t(np.stack(ev))
        self.light_area = self._t(np.asarray(area, np.float32))

    # -- camera -------------------------------------------------------

    def _camera(self, host, camera: int) -> None:
        """Camera node number `camera` in node order (the row of the
        uploaded camera table): position and the axes of its world
        transform (forward = -z), and its view and projection matrices
        for the rasterizer."""
        nodes = [node for node in host.nodes if node.camera_index is not None]
        if camera >= len(nodes):
            raise ValueError(f"the scene has no camera {camera}")
        node = nodes[camera]
        cam = host.cameras[node.camera_index]
        w = node.world_transform
        self.cam_pos = self._t(w[:3, 3])
        self.cam_right = self._t(w[:3, 0])
        self.cam_up = self._t(w[:3, 1])
        self.cam_forward = self._t(-w[:3, 2])
        self.cam_yfov = self._t(np.float32(cam.yfov))
        self.cam_focal = self._t(np.float32(cam.focal_distance))
        self.cam_aperture = self._t(np.float32(cam.aperture))
        self.view_matrix = np.linalg.inv(w).astype(np.float32)
        self.proj_matrix = np.asarray(cam.projection, np.float32)

    # -- procedural spheres -------------------------------------------

    def _spheres(self, host) -> None:
        """Centre, radius and material row of each procedural sphere, in
        the scene's order (the order that breaks a tie between them)."""
        self.num_spheres = len(host.procedurals)
        if not self.num_spheres:
            return
        self.sph_center = self._t(np.array([p.center for p in host.procedurals],
                                           np.float32).reshape(-1, 3))
        self.sph_radius = self._t(np.array([p.radius for p in host.procedurals], np.float32))
        self.sph_mat = torch.as_tensor([int(p.material) for p in host.procedurals],
                                       dtype=torch.int64, device=self.device)

    # -- textures -----------------------------------------------------

    def _textures(self, host) -> None:
        """Box-filtered mip pyramid of each texture (level l halves the
        previous one, floor-sized, down to 1x1), and the level count of
        the trilinear lookup: log2 of the largest side, where heights
        are first rounded up to a power of two, plus one, at most 12."""
        self.textures = None
        if not host.texture2image_mapping:
            return
        n = max(host.texture2image_mapping) + 1
        imgs = []
        for t in range(n):
            img_idx = host.texture2image_mapping.get(t)
            data_idx = host.image2data_mapping.get(img_idx, img_idx)
            imgs.append(host.image_data[data_idx].as_float_rgba())
        max_h = 1 << (max(im.shape[0] for im in imgs) - 1).bit_length()
        max_w = max(im.shape[1] for im in imgs)
        self.num_levels = max(1, min(int(np.log2(max(max_h, max_w))) + 1, 12))
        self.textures = []
        for im in imgs:
            levels = []
            level = im.astype(np.float32)
            for _ in range(self.num_levels):
                levels.append(self._t(level))
                if level.shape[0] > 1 or level.shape[1] > 1:
                    h2 = max(1, level.shape[0] // 2)
                    w2 = max(1, level.shape[1] // 2)
                    level = level[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4).mean(axis=(1, 3))
            self.textures.append(levels)
