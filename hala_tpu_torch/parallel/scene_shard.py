"""Geometry-sharded rendering over the ranks of a mesh.

Film tiling (tiling.py) replicates the scene; this module shards it:
each rank holds 1/n of the SAH cluster blocks (cluster boxes, slot
blocks, the slot soup and its shade rows) and 1/n of the film rows.
Per visibility query the integrator all-gathers the rays, runs its
query on the rank's own clusters, and merges the per-rank hits by the
lexicographic (t, global tri) minimum (integrator `merge_shard_hits`);
winner shade rows come back through an owner-masked reduce-scatter of
their int32 bit patterns (integrator `_rows_sharded`). The minimum over
a partition of the triangles is the global minimum, and every engine
breaks exact-t ties to the smaller slot, so the sharded film is the
one-device film bit for bit.

`shard_scene` gives each rank a new DeviceGeometry holding contiguous
copies of its block, so no per-geometry cache of the unsharded scene
(the cull's unions, K1's packed table) carries over. Padding clusters
follow the uploader's rule (`ops/cluster.py` `cluster_boxes` and
`pack_slots` over slots with no triangle): far-point cluster boxes, and
far-point span boxes in row 9 of their slot blocks, where the JAX
package's pad writes zeros (ROADMAP Queue 3, known differences).

Animation moves the unsharded scene; shard it again after update_scene.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.integrator import RenderSettings, Uniforms
from ..ops.cluster import cluster_boxes, pack_slots
from ..scene.gpu.scene import TRI_PAD
from .tiling import Mesh, TiledFilm, _sharded_frame

# DeviceGeometry fields sliced along dim 0. Cluster tables split by
# cluster blocks; slot arrays (leading dim C * TRI_PAD) in the same
# block order, so a rank's slots are contiguous and global slot id =
# local id + rank * local slots. normals, tangents, uvs and tri_prim
# serve only the animation path and stay replicated.
_CLUSTER_FIELDS = ("cluster_min", "cluster_max", "tri_packed")
_SLOT_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "shade_table", "tri_mat")
_SHARDED_FIELDS = _CLUSTER_FIELDS + _SLOT_FIELDS


def pad_scene_for_sharding(scene, n: int):
    """The scene with its cluster count padded to a multiple of `n`:
    clusters of slots with no triangle (v0, e1, e2 and the shade row
    zero, material -1), their boxes and slot blocks by the uploader's
    rule. Padding is appended, so every triangle keeps its global slot
    id. Returns a new DeviceScene, or the input when `n` divides."""
    g = scene.geometry
    c = g.tri_packed.shape[0]
    dc = -(-c // n) * n - c
    if dc == 0:
        return scene
    ds = dc * TRI_PAD
    z3 = torch.zeros((ds, 3), dtype=torch.float32, device=g.tri_v0.device)
    real = torch.zeros(ds, dtype=torch.bool, device=z3.device)
    pmin, pmax = cluster_boxes(z3, z3, z3, real)
    pad = dict(
        cluster_min=pmin, cluster_max=pmax, tri_packed=pack_slots(z3, z3, z3, real),
        tri_v0=z3, tri_e1=z3, tri_e2=z3,
        shade_table=g.shade_table.new_zeros((ds, g.shade_table.shape[1])),
        tri_mat=g.tri_mat.new_full((ds,), -1),
    )
    geometry = dataclasses.replace(g, **{
        name: torch.cat([getattr(g, name), extra]) for name, extra in pad.items()})
    return dataclasses.replace(scene, geometry=geometry)


def scene_shard_specs(scene) -> tuple[str, ...]:
    """The DeviceGeometry fields a rank holds 1/n of (split along dim 0
    in cluster-block order); every other table is replicated."""
    return _SHARDED_FIELDS


def shard_scene(scene, mesh: Mesh):
    """This rank's scene on `mesh.device`: the scene padded for the mesh
    size, with a new DeviceGeometry holding contiguous copies of the
    rank's block of `scene_shard_specs` (num_triangles stays the global
    count) and every other table replicated."""
    scene = pad_scene_for_sharding(scene, mesh.size)
    g = scene.geometry
    k = g.tri_packed.shape[0] // mesh.size
    blocks = {name: k for name in _CLUSTER_FIELDS}
    blocks.update({name: k * TRI_PAD for name in _SLOT_FIELDS})
    own = {name: getattr(g, name)[mesh.rank * rows:(mesh.rank + 1) * rows].clone()
           for name, rows in blocks.items()}
    scene = dataclasses.replace(scene, geometry=dataclasses.replace(g, **own))
    return scene.to(mesh.device)


def render_frame_scene_sharded(scene, env, uniforms: Uniforms, tiled: TiledFilm,
                               frame_index, settings: RenderSettings):
    """One progressive frame with the film rows and the geometry both
    sharded over the mesh. `scene` is this rank's `shard_scene`. Returns
    (TiledFilm, total rays)."""
    return _sharded_frame(scene, env, uniforms, tiled, frame_index, settings,
                          scene_axis=tiled.mesh)
