"""Meshlet clustering for the raster path.

Parity: reference gpu_uploader.rs:555-765
(additively_upload_for_mesh_shader): meshopt `build_meshlets` with
max_vertices=64, max_triangles=124, cone_weight=0.5
(gpu_uploader.rs:577-583) + `compute_meshlet_bounds`; meshlet triangle
indices packed 3 x u8 -> u32 (gpu_uploader.rs:615-617).

This is a greedy scan-order clusterer (meshopt's quality is a perf
optimization, not a correctness contract); bounds/cone math matches
meshopt's definitions. A C++ native version can swap in behind the same
signature.
"""

from __future__ import annotations

import numpy as np

from ..scene.meshlet import (
    MESHLET_MAX_PRIMITIVES,
    MESHLET_MAX_VERTICES,
    Meshlet,
)


def build_meshlets(
    indices: np.ndarray, positions: np.ndarray, use_native: bool = True
) -> tuple[list[Meshlet], np.ndarray, np.ndarray]:
    """Cluster triangles into meshlets.

    Returns (meshlets, meshlet_vertices (u32), meshlet_primitives (u32,
    3 x u8 packed per triangle)). Uses the C++ clustering
    (native/meshopt.cpp) when available; this Python path is the
    fallback and the test oracle.
    """
    if use_native:
        from ..native import build_meshlets_native

        native = build_meshlets_native(
            indices, positions, MESHLET_MAX_VERTICES, MESHLET_MAX_PRIMITIVES
        )
        if native is not None:
            return native
    tris = indices.reshape(-1, 3)
    meshlets: list[Meshlet] = []
    mv: list[int] = []  # global vertex ids, grouped per meshlet
    mp: list[int] = []  # packed local triangle indices

    cur_map: dict[int, int] = {}
    cur_tris: list[tuple[int, int, int]] = []
    v_off = 0
    p_off = 0

    def flush():
        nonlocal cur_map, cur_tris, v_off, p_off
        if not cur_tris:
            return
        verts = list(cur_map.keys())
        pos = positions[verts]
        center = 0.5 * (pos.min(axis=0) + pos.max(axis=0))
        radius = float(np.linalg.norm(pos - center, axis=1).max())
        # cone from triangle normals
        p0 = positions[[t[0] for t in cur_tris]]
        p1 = positions[[t[1] for t in cur_tris]]
        p2 = positions[[t[2] for t in cur_tris]]
        n = np.cross(p1 - p0, p2 - p0)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(ln > 0, n / ln, 0.0)
        axis = n.sum(axis=0)
        al = np.linalg.norm(axis)
        axis = axis / al if al > 0 else np.array([0.0, 0.0, 1.0])
        mindp = float((n @ axis).min()) if len(n) else 1.0
        cutoff = np.sqrt(max(0.0, 1.0 - mindp * mindp)) if mindp > 0 else 1.0
        meshlets.append(
            Meshlet(
                center=center.astype(np.float32),
                radius=radius,
                cone_apex=center.astype(np.float32),
                cone_cutoff=float(cutoff),
                cone_axis=axis.astype(np.float32),
                num_of_vertices=len(verts),
                offset_of_vertices=v_off,
                num_of_primitives=len(cur_tris),
                offset_of_primitives=p_off,
            )
        )
        mv.extend(verts)
        for t in cur_tris:
            a, b, c = cur_map[t[0]], cur_map[t[1]], cur_map[t[2]]
            mp.append(a | (b << 8) | (c << 16))
        v_off += len(verts)
        p_off += len(cur_tris)
        cur_map = {}
        cur_tris = []

    for tri in tris:
        a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
        new = sum(1 for x in (a, b, c) if x not in cur_map)
        if (
            len(cur_map) + new > MESHLET_MAX_VERTICES
            or len(cur_tris) + 1 > MESHLET_MAX_PRIMITIVES
        ):
            flush()
        for x in (a, b, c):
            if x not in cur_map:
                cur_map[x] = len(cur_map)
        cur_tris.append((a, b, c))
    flush()

    return (
        meshlets,
        np.array(mv, np.uint32),
        np.array(mp, np.uint32),
    )


def build_scene_meshlets(scene, global_meshlets: bool = False) -> None:
    """Fill primitive meshlet fields across the scene (uploader hook).
    `global_meshlets` is accepted as the JAX package accepts it; it has
    no effect there either."""
    del global_meshlets
    draw_index = 0
    for mesh in scene.meshes:
        for prim in mesh.primitives:
            meshlets, mv, mp = build_meshlets(prim.indices, prim.positions)
            for m in meshlets:
                m.draw_index = draw_index
            prim.meshlets = meshlets
            prim.meshlet_vertices = mv
            prim.meshlet_primitives = mp
            draw_index += 1
