"""Host -> device scene upload with record precompute.

Parity: reference src/scene/loader/gpu_uploader.rs
(HalaSceneGPUUploader::upload, :63-545):

* camera records from node world transforms (view = inverse(world),
  gpu_uploader.rs:114; axis extraction per gpu/camera.rs:28-61), capped
  at MAX_CAMERA_COUNT=8 with warn+truncate (gpu_uploader.rs:39, 99-104);
* light records + light AABBs per gpu_uploader.rs:157-274, capped at
  MAX_LIGHT_COUNT=32 (gpu_uploader.rs:40, 142-147);
* material records with the BSDF precompute of gpu/material.rs:53-69;
* per-(node, primitive) instance flattening with custom_index parity
  (gpu_uploader.rs:843-874) — here triangles are pre-transformed to world
  space and concatenated into one SoA soup instead of building
  BLAS-per-primitive + TLAS;
* texture stack instead of per-texture Vulkan images + samplers
  (gpu_uploader.rs:334-403).

The tables are built in numpy exactly as the JAX package builds them
(same slot order, padding and packing) and only the final wraps become
tensors on the requested `device`. `use_ray_tracing` (the default, as
in the JAX package) also builds the skip-link BVH of the "bvh" engine
on the host (ops/bvh.py; the cluster tables serve every other engine).
`use_mesh_shader` builds the per-primitive meshlet tables
(gpu_uploader.rs:555-765); `use_global_meshlets` is accepted as the JAX
package accepts it, with no effect there either. Procedural spheres
upload as their own table (`_upload_procedural`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...error import HalaRendererError
from ...utils import profiling
from ...ops.cluster import cluster_boxes, pack_slots
from ..cpu.scene import Scene
from ..cpu.camera import PerspectiveCamera, OrthographicCamera
from ..cpu.material import Material, MaterialType
from ..cpu.light import LightType
from ..gpu.scene import (
    MAX_CAMERA_COUNT,
    MAX_LIGHT_COUNT,
    TRI_PAD,
    DeviceCameras,
    DeviceGeometry,
    DeviceLights,
    DeviceMaterials,
    DeviceProcedural,
    DeviceScene,
    TextureStack,
    pad_rows,
    resolve_device,
)

logger = logging.getLogger("hala_tpu_torch.scene")


def _t(arr, device: torch.device) -> torch.Tensor:
    """numpy table -> tensor on `device` (dtype kept)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _material_precompute(m: Material) -> tuple[float, float, float]:
    """(roughness, ax, ay) per gpu/material.rs:53-69."""
    if m.type == MaterialType.DIFFUSE:
        sigma = m.roughness * 0.5 * (np.pi / 2.0)
        sigma2 = sigma * sigma
        a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
        b = 0.45 * sigma2 / (sigma2 + 0.09)
        return m.roughness, a, b
    rough = m.roughness * m.roughness
    aspect = float(np.sqrt(1.0 - np.clip(m.anisotropic, 0.0, 1.0) * 0.9))
    return rough, max(0.001, rough / aspect), max(0.001, rough * aspect)


class SceneUploader:
    """Builds a DeviceScene from a host Scene (gpu_uploader.rs:63 role)."""

    @staticmethod
    def upload(
        scene: Scene,
        use_mesh_shader: bool = False,
        use_global_meshlets: bool = False,
        use_ray_tracing: bool = True,
        device="cuda",
    ) -> DeviceScene:
        with profiling.span("hala.upload"):
            dev = resolve_device(device)
            cameras = SceneUploader._upload_cameras(scene, dev)
            lights = SceneUploader._upload_lights(scene, dev)
            materials = SceneUploader._upload_materials(scene, dev)
            with profiling.span("hala.upload.geometry"):
                geometry = SceneUploader._upload_geometry(scene, dev)
            with profiling.span("hala.upload.textures"):
                textures = SceneUploader._upload_textures(scene, dev)

            # flattened primitive id -> node index, in the same enumeration
            # order as _upload_geometry's prim_id (animation delta routing)
            prim_node = tuple(
                ni
                for ni, node in enumerate(scene.nodes)
                if node.mesh_index is not None
                for _ in scene.meshes[node.mesh_index].primitives
            )
            meshlets = None
            if use_mesh_shader:
                from ...ops.meshlets import build_scene_meshlets

                build_scene_meshlets(scene, global_meshlets=use_global_meshlets)
                meshlets = SceneUploader._upload_meshlets(scene, geometry, dev)
            bvh = None
            if use_ray_tracing:
                from ...ops.bvh import build_bvh

                with profiling.span("hala.upload.bvh"):
                    bvh = build_bvh(geometry)
            out = DeviceScene(
                geometry=geometry,
                materials=materials,
                lights=lights,
                cameras=cameras,
                textures=textures,
                meshlets=meshlets,
                bvh=bvh,
                procedural=SceneUploader._upload_procedural(scene, dev),
                prim_node=prim_node,
            )
            if profiling.enabled():
                profiling.count("upload.triangles", geometry.num_triangles)
                profiling.count("upload.clusters", geometry.tri_packed.shape[0])
                profiling.count("upload.bytes", out.nbytes())
            return out

    # -- procedural primitives -------------------------------------------

    @staticmethod
    def _upload_procedural(scene: Scene, device) -> DeviceProcedural | None:
        """The sphere table of Scene.procedurals (gpu_uploader.rs:818-840
        role); None when the scene declares no procedural shapes, so the
        integrator's merge does nothing."""
        prims = getattr(scene, "procedurals", None)
        if not prims:
            return None
        centers = np.array([p.center for p in prims], np.float32).reshape(-1, 3)
        radii = np.array([p.radius for p in prims], np.float32)
        mats = np.array([p.material for p in prims], np.int32)
        packed = np.zeros((len(prims), 8), np.float32)
        packed[:, 0:3] = centers
        packed[:, 3] = radii
        packed[:, 4] = mats.astype(np.float32)

        def t(a):
            return torch.from_numpy(a).to(device)

        return DeviceProcedural(center=t(centers), radius=t(radii), mat=t(mats),
                                packed=t(packed), num_prims=len(prims))

    # -- cameras ---------------------------------------------------------

    @staticmethod
    def _upload_cameras(scene: Scene, device) -> DeviceCameras:
        recs = []
        for node in scene.nodes:
            if node.camera_index is None:
                continue
            if len(recs) >= MAX_CAMERA_COUNT:
                logger.warning(
                    "Too many cameras (max %d); truncating.", MAX_CAMERA_COUNT
                )
                break
            cam = scene.cameras[node.camera_index]
            w = node.world_transform
            position, right, up = w[:3, 3], w[:3, 0], w[:3, 1]
            forward = -w[:3, 2]
            if isinstance(cam, PerspectiveCamera):
                rec = (position, right, up, forward, cam.yfov,
                       cam.focal_distance, cam.aperture, 0, np.linalg.inv(w),
                       cam.projection)
            elif isinstance(cam, OrthographicCamera):
                rec = (position, right, up, forward, 0.0, cam.xmag, cam.ymag,
                       1, np.linalg.inv(w), cam.orthography)
            else:  # pragma: no cover
                raise HalaRendererError(f"Unknown camera type: {cam!r}")
            recs.append(rec)
        if not recs:
            raise HalaRendererError("Scene has no camera.")
        n = len(recs)

        def col(i, shape, dtype=np.float32):
            out = np.zeros((MAX_CAMERA_COUNT,) + shape, dtype)
            for k, r in enumerate(recs):
                out[k] = r[i]
            return _t(out, device)

        return DeviceCameras(
            position=col(0, (3,)), right=col(1, (3,)), up=col(2, (3,)),
            forward=col(3, (3,)), yfov=col(4, ()),
            focal_or_xmag=col(5, ()), aperture_or_ymag=col(6, ()),
            ctype=col(7, (), np.int32), view_matrix=col(8, (4, 4)),
            proj_matrix=col(9, (4, 4)), num_cameras=n,
        )

    # -- lights ----------------------------------------------------------

    @staticmethod
    def _upload_lights(scene: Scene, device) -> DeviceLights:
        """gpu_uploader.rs:157-274 record construction."""
        intensity, position, u, v = [], [], [], []
        radius, area, ltype, amin, amax = [], [], [], [], []
        count = 0
        for node in scene.nodes:
            if node.light_index is None:
                continue
            if count >= MAX_LIGHT_COUNT:
                logger.warning(
                    "Too many lights (max %d); truncating.", MAX_LIGHT_COUNT
                )
                break
            light = scene.lights[node.light_index]
            w = node.world_transform
            x_axis, y_axis, z_axis, w_axis = w[:3, 0], w[:3, 1], w[:3, 2], w[:3, 3]
            I = light.color * np.float32(light.intensity)
            # NOTE: zero-power lights are NOT dropped — analytic lights
            # also OCCLUDE visibility rays (the reference's light BLAS
            # blocks shadow/extension rays regardless of intensity), so
            # removing one changes the image (measured: envmap golden
            # RMSE 0.0066 when the black ceiling quad stops blocking).
            p0, p1 = light.params
            t = light.light_type
            if t == LightType.POINT:
                rec = (I, w_axis, np.zeros(3), np.zeros(3), 0.0, 0.0, 0,
                       w_axis, w_axis)
            elif t == LightType.DIRECTIONAL:
                rec = (I, np.zeros(3), -z_axis,
                       np.array([np.cos(0.5 * p0), 0, 0], np.float32),
                       0.0, 0.0, 1, np.zeros(3), np.zeros(3))
            elif t == LightType.SPOT:
                rec = (I, w_axis, -z_axis,
                       np.array([np.cos(p0), np.cos(p1), 0], np.float32),
                       0.0, 0.0, 2, w_axis, w_axis)
            elif t == LightType.QUAD:
                corner = w_axis - x_axis * (p0 * 0.5) - y_axis * (p1 * 0.5)
                other = corner + x_axis * p0 + y_axis * p1 + z_axis * 0.01
                rec = (I, corner, x_axis * p0, y_axis * p1, 0.0, p0 * p1, 3,
                       np.minimum(corner, other), np.maximum(corner, other))
            elif t == LightType.SPHERE:
                rec = (I, w_axis, np.zeros(3), np.zeros(3), p0,
                       4.0 * np.pi * p0 * p0, 4, w_axis - p0, w_axis + p0)
            else:  # pragma: no cover
                raise HalaRendererError(f"Invalid light type: {t}")
            for lst, val in zip(
                (intensity, position, u, v, radius, area, ltype, amin, amax), rec
            ):
                lst.append(np.asarray(val, np.float32 if lst is not ltype else np.int32))
            count += 1

        def stack(lst, shape, dtype=np.float32, fill=0):
            arr = (
                np.stack(lst).astype(dtype)
                if lst
                else np.zeros((0,) + shape, dtype)
            )
            return _t(pad_rows(arr, MAX_LIGHT_COUNT, fill), device)

        return DeviceLights(
            intensity=stack(intensity, (3,)),
            position=stack(position, (3,)),
            u=stack(u, (3,)),
            v=stack(v, (3,)),
            radius=stack(radius, ()),
            area=stack(area, ()),
            ltype=stack(ltype, (), np.int32, fill=-1),
            aabb_min=stack(amin, (3,)),
            aabb_max=stack(amax, (3,)),
            num_lights=count,
        )

    # -- materials -------------------------------------------------------

    @staticmethod
    def _upload_materials(scene: Scene, device) -> DeviceMaterials:
        mats = scene.materials or [Material()]

        def f(fn, dtype=np.float32):
            return _t(np.array([fn(m) for m in mats], dtype), device)

        def tex_idx(fn):
            return _t(
                np.array(
                    [(-1 if fn(m) == 0xFFFFFFFF else fn(m)) for m in mats],
                    np.int32,
                ),
                device,
            )

        pre = [_material_precompute(m) for m in mats]

        def _map_idx(i):
            return -1.0 if i == 0xFFFFFFFF else float(i)

        packed = np.zeros((len(mats), 32), np.float32)
        for i, (m, p) in enumerate(zip(mats, pre)):
            packed[i, 0:3] = m.base_color
            packed[i, 3] = m.opacity
            packed[i, 4:7] = m.emission
            packed[i, 7] = m.metallic
            packed[i, 8] = p[0]
            packed[i, 9] = m.subsurface
            packed[i, 10] = m.specular_tint
            packed[i, 11] = m.sheen
            packed[i, 12] = m.sheen_tint
            packed[i, 13] = m.clearcoat
            packed[i, 14] = m.clearcoat_roughness
            packed[i, 15:18] = m.clearcoat_tint
            packed[i, 18] = m.specular_transmission
            packed[i, 19] = m.ior
            packed[i, 20] = p[1]
            packed[i, 21] = p[2]
            packed[i, 22] = float(int(m.type))
            packed[i, 23] = _map_idx(m.base_color_map_index)
            packed[i, 24] = _map_idx(m.metallic_roughness_map_index)
            packed[i, 25] = _map_idx(m.emission_map_index)
            packed[i, 26] = _map_idx(m.normal_map_index)
            packed[i, 27] = m.anisotropic
            # [28:31] premultiplied absorption sigma (ABSORB media only;
            # Beer-Lambert in the integrator)
            if int(m.medium.type) == 1:
                packed[i, 28:31] = m.medium.color * m.medium.density

        return DeviceMaterials(
            packed=_t(packed, device),
            has_disney=any(m.type == MaterialType.DISNEY for m in mats),
            has_transmission=any(
                m.type == MaterialType.DISNEY and m.specular_transmission > 0
                for m in mats
            ),
            has_absorb_medium=any(
                int(m.medium.type) == 1 and m.medium.density > 0
                for m in mats
            ),
            has_normal_map=any(
                m.normal_map_index != 0xFFFFFFFF for m in mats
            ),
            has_alpha=any(m.opacity < 1.0 for m in mats),
            has_scatter_medium=any(
                int(m.medium.type) == 2 and m.medium.density > 0
                for m in mats
            ),
            has_emissive_medium=any(
                int(m.medium.type) == 3 and m.medium.density > 0
                for m in mats
            ),
            base_color=f(lambda m: m.base_color),
            opacity=f(lambda m: m.opacity),
            emission=f(lambda m: m.emission),
            anisotropic=f(lambda m: m.anisotropic),
            metallic=f(lambda m: m.metallic),
            roughness=_t(np.array([p[0] for p in pre], np.float32), device),
            subsurface=f(lambda m: m.subsurface),
            specular_tint=f(lambda m: m.specular_tint),
            sheen=f(lambda m: m.sheen),
            sheen_tint=f(lambda m: m.sheen_tint),
            clearcoat=f(lambda m: m.clearcoat),
            clearcoat_roughness=f(lambda m: m.clearcoat_roughness),
            clearcoat_tint=f(lambda m: m.clearcoat_tint),
            specular_transmission=f(lambda m: m.specular_transmission),
            ior=f(lambda m: m.ior),
            ax=_t(np.array([p[1] for p in pre], np.float32), device),
            ay=_t(np.array([p[2] for p in pre], np.float32), device),
            medium_color=f(lambda m: m.medium.color),
            medium_density=f(lambda m: m.medium.density),
            medium_anisotropy=f(lambda m: m.medium.anisotropy),
            medium_type=f(lambda m: int(m.medium.type), np.int32),
            mat_type=f(lambda m: int(m.type), np.int32),
            uv_transform=f(
                lambda m: np.asarray(m.uv_transform, np.float32)
            ),
            has_uv_transform=any(
                tuple(m.uv_transform) != (0.0, 0.0, 0.0, 1.0, 1.0)
                for m in mats
            ),
            base_color_map=tex_idx(lambda m: m.base_color_map_index),
            normal_map=tex_idx(lambda m: m.normal_map_index),
            metallic_roughness_map=tex_idx(lambda m: m.metallic_roughness_map_index),
            emission_map=tex_idx(lambda m: m.emission_map_index),
        )

    # -- geometry --------------------------------------------------------

    @staticmethod
    def _upload_geometry(scene: Scene, device) -> DeviceGeometry:
        # Per-NODE vectorization: primitives only contribute cheap list
        # appends; the transform + per-corner gathers run once over the
        # node's concatenated vertex soup (procedural scenes carry
        # thousands of tiny primitives — the per-primitive version of
        # this loop measured 11 s at 115k tris, ~all Python/numpy call
        # overhead). Arithmetic and enumeration order are IDENTICAL to
        # the per-primitive form, so device outputs are bit-equal.
        v0s, e1s, e2s, ns, ts, uvs, mats, prims = [], [], [], [], [], [], [], []
        vcs, any_vc = [], False
        prim_id = 0
        for node in scene.nodes:
            if node.mesh_index is None:
                continue
            mesh = scene.meshes[node.mesh_index]
            w = node.world_transform
            # normal matrix = inverse-transpose of the upper 3x3
            nrm_mtx = np.linalg.inv(w[:3, :3]).T
            p_pos, p_nrm, p_tan, p_uv, p_vc = [], [], [], [], []
            p_tri, p_mat, p_pid, p_cnt = [], [], [], []
            v_off = 0
            for prim in mesh.primitives:
                tri = prim.indices.reshape(-1, 3).astype(np.int64)
                p_tri.append(tri + v_off)
                nv = prim.positions.shape[0]
                v_off += nv
                p_pos.append(prim.positions)
                p_nrm.append(prim.normals)
                p_tan.append(prim.tangents)
                p_uv.append(prim.tex_coords)
                if prim.colors is not None:
                    any_vc = True
                    p_vc.append(prim.colors)
                else:
                    p_vc.append(np.ones((nv, 3), np.float32))
                mat = prim.material_index
                p_mat.append(-1 if mat == 0xFFFFFFFF else mat)
                p_pid.append(prim_id)
                p_cnt.append(len(tri))
                prim_id += 1
            if not p_tri:
                continue
            tri = np.concatenate(p_tri)
            pos_w = np.concatenate(p_pos) @ w[:3, :3].T + w[:3, 3]
            nrm_w = np.concatenate(p_nrm) @ nrm_mtx.T
            nrm_len = np.linalg.norm(nrm_w, axis=1, keepdims=True)
            nrm_w = np.where(nrm_len > 0, nrm_w / nrm_len, nrm_w)
            tan_w = np.concatenate(p_tan) @ w[:3, :3].T
            uv_n = np.concatenate(p_uv)
            vc_n = np.concatenate(p_vc)
            a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
            v0s.append(pos_w[a])
            e1s.append(pos_w[b] - pos_w[a])
            e2s.append(pos_w[c] - pos_w[a])
            ns.append(np.stack([nrm_w[a], nrm_w[b], nrm_w[c]], axis=1))
            ts.append(np.stack([tan_w[a], tan_w[b], tan_w[c]], axis=1))
            uvs.append(np.stack([uv_n[a], uv_n[b], uv_n[c]], axis=1))
            vcs.append(np.stack([vc_n[a], vc_n[b], vc_n[c]], axis=1))
            cnt = np.asarray(p_cnt, np.int64)
            mats.append(np.repeat(np.asarray(p_mat, np.int32), cnt))
            prims.append(np.repeat(np.asarray(p_pid, np.int32), cnt))

        if not v0s:
            raise HalaRendererError("Scene has no geometry.")
        v0 = np.concatenate(v0s).astype(np.float32)
        e1 = np.concatenate(e1s).astype(np.float32)
        e2 = np.concatenate(e2s).astype(np.float32)
        n_tris = v0.shape[0]
        # Padding triangles: far away and degenerate so they never hit.
        far = np.float32(3.0e37)

        nrm = np.concatenate(ns).astype(np.float32)
        uv = np.concatenate(uvs).astype(np.float32)
        mat = np.concatenate(mats)
        prim = np.concatenate(prims)

        # Cluster layout: each TRI_PAD block of the device soup is one
        # spatially tight *cluster* — the unit of the streaming
        # intersectors' AABB culling (ops/cluster.py, ops/traverse.py).
        # Large scenes get ragged binned-SAH leaves (interior padding
        # slots; see ops/sahbuild.py for the measured 3.4x pair cut);
        # small scenes keep the tail-padded Morton order the SMEM
        # brute-force path's `num_real` prefix trim relies on. `slots`
        # maps device slot -> enumeration-order triangle (-1 = padding).
        from ...ops.sahbuild import SAH_MIN_TRIS, sah_slot_map

        tri_lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        tri_hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        if n_tris > SAH_MIN_TRIS:
            with profiling.span("hala.upload.sah"):
                slots = sah_slot_map(tri_lo, tri_hi, TRI_PAD)
            prefix_layout = False
        else:
            from ...ops.morton import morton3d_np

            centroid = v0 + (e1 + e2) / 3.0
            order = np.argsort(
                morton3d_np(centroid, centroid.min(axis=0),
                            centroid.max(axis=0)),
                kind="stable",
            ).astype(np.int64)
            tail = -(-n_tris // TRI_PAD) * TRI_PAD - n_tris
            slots = np.concatenate([order, np.full(tail, -1, np.int64)])
            prefix_layout = True
        total = slots.shape[0]
        gather = np.maximum(slots, 0)
        real = slots >= 0

        def take(arr, pad_value):
            """arr (n_tris, ...) in enumeration order -> (total, ...)
            in cluster-slot order with `pad_value` in padding slots."""
            out = arr[gather]
            out[~real] = pad_value
            return out

        ng = np.cross(e1, e2)
        ng_len = np.linalg.norm(ng, axis=1, keepdims=True)
        ng = np.where(
            ng_len > 0, ng / np.maximum(ng_len, 1e-30), ng
        ).astype(np.float32)
        tan = np.concatenate(ts).astype(np.float32)
        # Vertex colors widen the packed shade row from 32 to 48 columns
        # ([32:41] = per-corner RGB); scenes without COLOR_0 keep the
        # narrow table so the per-hit row gather stays cheap (the shade
        # width is a static shape, so the integrator specializes on it).
        width = 48 if any_vc else 32
        shade = np.zeros((n_tris, width), np.float32)
        if any_vc:
            vc_all = np.concatenate(vcs).astype(np.float32)
            shade[:, 32:41] = vc_all.reshape(n_tris, 9)
        shade[:, 0:9] = nrm.reshape(n_tris, 9)
        shade[:, 9:15] = uv.reshape(n_tris, 6)
        shade[:, 15:18] = ng
        shade[:, 18] = mat.astype(np.float32)
        shade[:, 19] = prim.astype(np.float32)
        shade[:, 20:29] = tan.reshape(n_tris, 9)  # per-corner tangents
        # [29] uv texel density sqrt(uv_area / world_area): the
        # triangle-constant term of mip LOD selection (ops/texture.py).
        uv3 = uv.reshape(n_tris, 3, 2)
        uv_area = 0.5 * np.abs(
            (uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
            - (uv3[:, 1, 1] - uv3[:, 0, 1]) * (uv3[:, 2, 0] - uv3[:, 0, 0])
        )
        world_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        shade[:, 29] = np.sqrt(
            uv_area / np.maximum(world_area, 1e-12)
        ).astype(np.float32)
        # [30] enumeration-order triangle index, for host tables built
        # in (node, primitive) order (e.g. meshlet ids).
        shade[:, 30] = np.arange(n_tris, dtype=np.float32)

        # Cluster AABBs + packed geometry blocks over the slotted soup:
        # ops/cluster's `cluster_boxes` (all-padding clusters get an
        # empty far point box that never intersects) and `pack_slots`
        # (rows 0-8 v0/e1/e2, row 9 the 16-slot span boxes of K2's and
        # K5's pretest, equal to the JAX package's row wherever the
        # corners are finite), the same functions the animation refit
        # calls (ops/animate.py).
        v0p = take(v0, far)
        e1p = take(e1, 0)
        e2p = take(e2, 0)
        v0t, e1t, e2t = (torch.from_numpy(a) for a in (v0p, e1p, e2p))
        real_t = torch.from_numpy(real)
        cluster_min, cluster_max = cluster_boxes(v0t, e1t, e2t, real_t)
        tri_packed = pack_slots(v0t, e1t, e2t, real_t)

        return DeviceGeometry(
            shade_table=_t(take(shade, 0), device),
            cluster_min=cluster_min.to(device),
            cluster_max=cluster_max.to(device),
            tri_packed=tri_packed.to(device),
            tri_v0=_t(v0p, device),
            tri_e1=_t(e1p, device),
            tri_e2=_t(e2p, device),
            # NOTE: all attribute arrays carry the same cluster-slot
            # ordering as tri_v0/e1/e2 (a mismatch silently mis-shades).
            normals=_t(take(nrm, 0), device),
            tangents=_t(take(tan, 0), device),
            uvs=_t(take(uv, 0), device),
            tri_mat=_t(take(mat, -1), device),
            tri_prim=_t(take(prim, -1), device),
            num_triangles=n_tris,
            num_primitives=prim_id,
            prefix_layout=prefix_layout,
        )

    # -- meshlets ----------------------------------------------------------

    @staticmethod
    def _upload_meshlets(scene: Scene, geometry, device):
        """World-space meshlet cone/sphere tables + the per-triangle
        meshlet map over the slotted soup (the task-shader cone culling
        data of the reference's meshlet pipeline)."""
        from ..gpu.scene import DeviceMeshlets

        apexes, axes, cuts, centers, radii = [], [], [], [], []
        orig_mids = []
        m_off = 0
        for node in scene.nodes:
            if node.mesh_index is None:
                continue
            w = node.world_transform
            rot = w[:3, :3]
            for prim in scene.meshes[node.mesh_index].primitives:
                for m in prim.meshlets:
                    apexes.append(rot @ m.cone_apex + w[:3, 3])
                    ax = rot @ m.cone_axis
                    ln = np.linalg.norm(ax)
                    axes.append(ax / ln if ln > 0 else np.float32([0, 0, 1]))
                    cuts.append(m.cone_cutoff)
                    centers.append(rot @ m.center + w[:3, 3])
                    # conservative world radius under (possibly scaled) rot
                    scale = max(np.linalg.norm(rot, axis=0).max(), 1e-6)
                    radii.append(m.radius * scale)
                counts = np.array(
                    [m.num_of_primitives for m in prim.meshlets], np.int64
                )
                ends = np.cumsum(counts)
                local = np.searchsorted(
                    ends, np.arange(prim.triangle_count), side="right"
                )
                orig_mids.append(local.astype(np.int32) + m_off)
                m_off += len(prim.meshlets)

        if m_off == 0:
            return None
        orig_mids = np.concatenate(orig_mids)
        # map through the slot order recorded in shade column 30
        orig_idx = geometry.shade_table[:, 30].cpu().numpy().astype(np.int64)
        tri_mat = geometry.tri_mat.cpu().numpy()
        tri_meshlet = np.where(
            tri_mat >= 0, orig_mids[np.clip(orig_idx, 0, len(orig_mids) - 1)], -1
        ).astype(np.int32)
        # invert the map: per-meshlet triangle slot list (mesh-shader
        # draw granularity; meshopt caps meshlets at 124 triangles)
        max_tris = 128
        order = np.argsort(tri_meshlet, kind="stable")
        sorted_m = tri_meshlet[order]
        first = np.searchsorted(sorted_m, np.arange(m_off), side="left")
        last = np.searchsorted(sorted_m, np.arange(m_off), side="right")
        tri_ids = np.full((m_off, max_tris), -1, np.int32)
        for m in range(m_off):
            members = order[first[m] : last[m]][:max_tris]
            tri_ids[m, : len(members)] = members
        return DeviceMeshlets(
            cone_apex=_t(np.stack(apexes).astype(np.float32), device),
            cone_axis=_t(np.stack(axes).astype(np.float32), device),
            cone_cutoff=_t(np.array(cuts, np.float32), device),
            center=_t(np.stack(centers).astype(np.float32), device),
            radius=_t(np.array(radii, np.float32), device),
            tri_meshlet=_t(tri_meshlet, device),
            tri_ids=_t(tri_ids, device),
            num_meshlets=m_off,
        )

    # -- textures --------------------------------------------------------

    @staticmethod
    def _upload_textures(scene: Scene, device) -> TextureStack | None:
        """Texture index list resolution (texture -> image -> data,
        cpu/scene.rs maps) into one padded f32 stack."""
        if not scene.texture2image_mapping:
            return None
        n = max(scene.texture2image_mapping) + 1
        imgs = []
        for t in range(n):
            img_idx = scene.texture2image_mapping.get(t)
            data_idx = scene.image2data_mapping.get(img_idx, img_idx)
            imgs.append(scene.image_data[data_idx].as_float_rgba())
        # Canvas height rounded UP to a power of two: the sampler computes
        # level row offsets in closed form (2*max_h - (2*max_h >> l),
        # ops/texture.py) which only equals the iterative packing sum
        # (row += max_h >> l) when max_h is a power of two.
        max_h = 1 << (max(im.shape[0] for im in imgs) - 1).bit_length()
        max_w = max(im.shape[1] for im in imgs)
        # Full mip chain (gen_mipmaps parity, gpu_uploader.rs:366-401):
        # box-filter pyramid packed vertically — level l occupies rows
        # [row_off(l), row_off(l) + H/2^l) at width W/2^l.
        n_levels = max(1, min(int(np.log2(max(max_h, max_w))) + 1, 12))
        stack = np.zeros((n, 2 * max_h, max_w, 4), np.float32)
        sizes = np.zeros((n, 2), np.int32)
        for i, im in enumerate(imgs):
            # row offsets follow the padded canvas height so all textures
            # share the same per-level offsets: row_off(l) = sum max_h/2^k
            row = 0
            level = im
            for l in range(n_levels):
                stack[i, row : row + level.shape[0], : level.shape[1]] = level
                row += max(max_h >> l, 1)
                if level.shape[0] > 1 or level.shape[1] > 1:
                    h2 = max(1, level.shape[0] // 2)
                    w2 = max(1, level.shape[1] // 2)
                    level = level[: h2 * 2, : w2 * 2].reshape(
                        h2, 2, w2, 2, 4
                    ).mean(axis=(1, 3))
            sizes[i] = (im.shape[0], im.shape[1])
        return TextureStack(
            data=_t(stack, device), sizes=_t(sizes, device),
            num_textures=n, num_levels=n_levels,
        )
