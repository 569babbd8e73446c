"""Device scene: structure-of-arrays tensors in plain dataclasses.

Parity: reference src/scene/gpu/scene.rs:11-37 (gpu::HalaScene) and the
record layouts of gpu/{camera,light,material,mesh}.rs, with the same
columns, shapes and dtypes as the JAX package's `scene/gpu/scene.py`
(float32 everywhere, int32 ids). Each table lives on one explicit
`device`; `.to(device)` moves it (nested tables included). Python-level
fields (counts, layout and capability flags) are host metadata.

`from_numpy` carries tables across frameworks: it rebuilds these
dataclasses from any object whose array fields convert with
`np.asarray` — the JAX package's DeviceScene included — so tests feed
both packages identical tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...error import HalaRendererError

# Caps match gpu_uploader.rs:39-40.
MAX_CAMERA_COUNT = 8
MAX_LIGHT_COUNT = 32

# Triangle-count padding granularity: one 128-triangle cluster block.
TRI_PAD = 128


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request on a host without CUDA
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HalaRendererError(
            f"device={device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


class TensorTables:
    """Mixin: `.to(device)` / `.device` over tensor and nested fields."""

    def to(self, device):
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorTables)):
                v = v.to(dev)
            out[f.name] = v
        return dataclasses.replace(self, **out)

    def nbytes(self) -> int:
        """Bytes of every tensor held, nested tables included (read from
        the shapes: no device access)."""
        total = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                total += v.nbytes
            elif isinstance(v, TensorTables):
                total += v.nbytes()
        return total

    @property
    def device(self) -> torch.device:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorTables)):
                return v.device
        raise HalaRendererError(f"{type(self).__name__} holds no tensors")


@dataclasses.dataclass
class DeviceGeometry(TensorTables):
    """World-space triangle soup in cluster-slot order, padded to a
    multiple of TRI_PAD. Padding slots carry material -1, a far-away v0
    and zero edges, so they can never be hit."""

    tri_v0: torch.Tensor      # (T, 3) f32 — first vertex
    tri_e1: torch.Tensor      # (T, 3) f32 — v1 - v0
    tri_e2: torch.Tensor      # (T, 3) f32 — v2 - v0
    normals: torch.Tensor     # (T, 3, 3) f32 — per-corner shading normals
    tangents: torch.Tensor    # (T, 3, 3) f32
    uvs: torch.Tensor         # (T, 3, 2) f32
    tri_mat: torch.Tensor     # (T,) i32 — material index, -1 for padding
    tri_prim: torch.Tensor    # (T,) i32 — flattened instance id
    # Packed per-triangle shading row (T, 32|48) f32:
    # [0:9] n0 n1 n2 [9:15] uv0 uv1 uv2 [15:18] geometric normal
    # [18] material id [19] primitive id [20:29] per-corner tangents
    # [29] uv texel density [30] enumeration-order triangle index
    # [32:41] per-corner vertex colors (48-wide rows only).
    shade_table: torch.Tensor
    # Per-cluster AABBs (C, 3) and the packed (C, 16, TRI_PAD) blocks:
    # rows 0-8 v0/e1/e2 components per slot, row 9 the 16-triangle
    # pretest sub-AABBs. Empty clusters carry a far point box (3e37).
    cluster_min: torch.Tensor
    cluster_max: torch.Tensor
    tri_packed: torch.Tensor
    num_triangles: int = 0   # un-padded count
    num_primitives: int = 0  # instance count
    # True iff real triangles occupy the prefix [0, num_triangles) of the
    # slot arrays (Morton tail-padded layout); the binned-SAH layout has
    # interior padding, so mask real triangles with tri_mat >= 0 there.
    prefix_layout: bool = True


@dataclasses.dataclass
class DeviceMaterials(TensorTables):
    """Material table (gpu/material.rs:16-48 layout, SoA). `ax`/`ay`
    hold the BSDF precompute of gpu/material.rs:53-69; `packed` mirrors
    the columns as one (M, 32) row per material (layout in the JAX
    package's scene/gpu/scene.py, plus [28:31] the absorption sigma)."""

    base_color: torch.Tensor            # (M, 3)
    opacity: torch.Tensor               # (M,)
    emission: torch.Tensor              # (M, 3)
    anisotropic: torch.Tensor           # (M,)
    metallic: torch.Tensor              # (M,)
    roughness: torch.Tensor             # (M,)
    subsurface: torch.Tensor            # (M,)
    specular_tint: torch.Tensor         # (M,)
    sheen: torch.Tensor                 # (M,)
    sheen_tint: torch.Tensor            # (M,)
    clearcoat: torch.Tensor             # (M,)
    clearcoat_roughness: torch.Tensor   # (M,)
    clearcoat_tint: torch.Tensor        # (M, 3)
    specular_transmission: torch.Tensor  # (M,)
    ior: torch.Tensor                   # (M,)
    ax: torch.Tensor                    # (M,)
    ay: torch.Tensor                    # (M,)
    medium_color: torch.Tensor          # (M, 3)
    medium_density: torch.Tensor        # (M,)
    medium_anisotropy: torch.Tensor     # (M,)
    medium_type: torch.Tensor           # (M,) i32
    uv_transform: torch.Tensor          # (M, 5) offset_u/v, rotation, scale_u/v
    mat_type: torch.Tensor              # (M,) i32 — 0 DIFFUSE, 1 DISNEY
    base_color_map: torch.Tensor        # (M,) i32, -1 = none
    normal_map: torch.Tensor            # (M,) i32
    metallic_roughness_map: torch.Tensor  # (M,) i32
    emission_map: torch.Tensor          # (M,) i32
    packed: torch.Tensor                # (M, 32) f32
    # Scene capability flags (cpu/scene.rs:59-95 probes): the integrator
    # skips BSDF lobes and features no material uses.
    has_disney: bool = True
    has_transmission: bool = True
    has_absorb_medium: bool = False
    has_normal_map: bool = False
    has_alpha: bool = False
    has_scatter_medium: bool = False
    has_emissive_medium: bool = False
    has_uv_transform: bool = False


@dataclasses.dataclass
class DeviceLights(TensorTables):
    """Light table (gpu/light.rs:8-32 layout, SoA), padded to
    MAX_LIGHT_COUNT rows (ltype -1 for padding)."""

    intensity: torch.Tensor   # (L, 3) — color * intensity
    position: torch.Tensor    # (L, 3)
    u: torch.Tensor           # (L, 3)
    v: torch.Tensor           # (L, 3)
    radius: torch.Tensor      # (L,)
    area: torch.Tensor        # (L,)
    ltype: torch.Tensor       # (L,) i32
    aabb_min: torch.Tensor    # (L, 3)
    aabb_max: torch.Tensor    # (L, 3)
    num_lights: int = 0


@dataclasses.dataclass
class DeviceCameras(TensorTables):
    """Camera table (gpu/camera.rs:10-20 layout, SoA), padded to
    MAX_CAMERA_COUNT rows. forward = -Z axis of the node transform."""

    position: torch.Tensor       # (C, 3)
    right: torch.Tensor          # (C, 3)
    up: torch.Tensor             # (C, 3)
    forward: torch.Tensor        # (C, 3)
    yfov: torch.Tensor           # (C,)
    focal_or_xmag: torch.Tensor  # (C,) focal distance (persp) or xmag (ortho)
    aperture_or_ymag: torch.Tensor  # (C,)
    ctype: torch.Tensor          # (C,) i32: 0 perspective, 1 orthographic
    view_matrix: torch.Tensor    # (C, 4, 4)
    proj_matrix: torch.Tensor    # (C, 4, 4)
    num_cameras: int = 0


@dataclasses.dataclass
class TextureStack(TensorTables):
    """All textures padded into one (NT, 2H, W, 4) f32 canvas with the
    mip pyramid packed vertically (level l at rows 2H - 2H/2^l)."""

    data: torch.Tensor    # (NT, 2H, W, 4) f32
    sizes: torch.Tensor   # (NT, 2) i32 — level-0 (height, width)
    num_textures: int = 0
    num_levels: int = 1


@dataclasses.dataclass
class DeviceMeshlets(TensorTables):
    """Meshlet cull tables of the mesh-shader raster mode (reference
    meshlet pipeline, gpu_uploader.rs:555-765, and the task shader's
    cone culling). `tri_meshlet` maps every triangle slot to its
    meshlet; `tri_ids` lists each meshlet's slots, the draw and binning
    granularity of `ops/raster.rasterize_meshlet_binned`."""

    cone_apex: torch.Tensor    # (M, 3)
    cone_axis: torch.Tensor    # (M, 3)
    cone_cutoff: torch.Tensor  # (M,)
    center: torch.Tensor       # (M, 3)
    radius: torch.Tensor       # (M,)
    tri_meshlet: torch.Tensor  # (T,) i32, -1 for padding
    tri_ids: torch.Tensor | None = None  # (M, 128) i32 slots, -1 padded
    num_meshlets: int = 0


@dataclasses.dataclass
class DeviceProcedural(TensorTables):
    """Procedural spheres (ops/prims.py): the SoA table and the packed
    row the shading fetch gathers."""

    center: torch.Tensor   # (P, 3) f32
    radius: torch.Tensor   # (P,) f32
    mat: torch.Tensor      # (P,) i32, material index
    packed: torch.Tensor   # (P, 8) f32 [cx cy cz r mat 0 0 0]
    num_prims: int = 0


@dataclasses.dataclass
class DeviceScene(TensorTables):
    """Everything the integrator and the rasterizer read
    (gpu/scene.rs:11-37 role)."""

    geometry: DeviceGeometry
    materials: DeviceMaterials
    lights: DeviceLights
    cameras: DeviceCameras
    textures: TextureStack | None = None
    meshlets: DeviceMeshlets | None = None
    # the skip-link node table of the "bvh" engine (ops/bvh.py `BVH`);
    # None until built, and dropped by a node move
    bvh: object = None
    procedural: DeviceProcedural | None = None
    name: str = "scene"
    # flattened primitive id -> scene node index (host metadata)
    prim_node: tuple = ()


def pad_rows(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    """Pad axis 0 to `total` rows with `fill`."""
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _carry(cls, src, device: torch.device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        if f.name == "bvh":
            from ...ops.bvh import BVH  # ops/bvh.py builds on this module

            kw[f.name] = None if v is None else _carry(BVH, v, device)
        elif f.name in _NESTED:
            kw[f.name] = None if v is None else _carry(_NESTED[f.name], v, device)
        elif v is None or isinstance(v, (bool, int, float, str, tuple)):
            kw[f.name] = v
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


_NESTED = {
    "geometry": DeviceGeometry,
    "materials": DeviceMaterials,
    "lights": DeviceLights,
    "cameras": DeviceCameras,
    "textures": TextureStack,
    "meshlets": DeviceMeshlets,
    "procedural": DeviceProcedural,
}


def from_numpy(tables, device) -> DeviceScene:
    """Build a DeviceScene on `device` from any object with the same
    field names whose array fields convert with `np.asarray` (a JAX
    DeviceScene, or this package's own), procedural spheres and the BVH
    node table included. Dtypes are kept as they are."""
    return _carry(DeviceScene, tables, resolve_device(device))
