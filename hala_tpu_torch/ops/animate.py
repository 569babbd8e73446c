"""Node moves on the device: the retransform of a mesh node's triangles
and the refit of the tables every intersector reads (the animation path).

Counterpart of the JAX package's ops/animate.py. Geometry is baked to
world space at upload, so moving a node applies the DELTA transform
new_world @ inv(current world) to that node's triangles on the device,
with no host re-upload. The slot order (and so the SAH or Morton
cluster partition) is kept, as a hardware BVH refit keeps its topology:
the clusters loosen as objects move far from where they were uploaded,
and a fresh upload tightens them again.

What a move rewrites is what the kernels read: the soup (K1 packs it,
`packed_triangles`), the cluster boxes (K2, K4, K5, K6), rows 0-9 of
`tri_packed` (K2, K5, K6, K7, K8) and the shading columns. The boxes
and row 9 are part of the walks' function (the admissibility rule,
ops/cluster.py), so they come from the uploader's own rule,
`cluster.cluster_boxes` and `cluster.pack_slots` over the uploader's
mask tri_mat >= 0: after a move they are what a fresh upload of the
moved soup in this slot order would give. The JAX refit differs there
(its `refit_clusters` lets every partly padded cluster reach to 3e37).

`retransform_geometry` returns a new DeviceGeometry, so nothing cached
on the old one (K4's group unions and K6's `_stream_unions`,
ops/cull.py `cached_on`) travels with it. Procedural spheres do not
move: the reference's retransform leaves `scene.procedural` as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cluster import cluster_boxes, pack_slots
from .raster import fma32


def _mat_vec(m, v):
    """m (T, 3, 3) times each vector of v, (T, 3) or (T, K, 3), rounded
    as XLA's CPU backend rounds the reference's einsum: fma(m2, v2,
    fma(m1, v1, m0 v0)), one rounding per fused multiply-add
    (ops/raster.fma32, the same bits on any device). So a moved soup,
    and with it its cluster boxes, equals the JAX package's bit for
    bit."""
    if v.dim() == 3:
        m = m[:, None]
    x = m[..., 0] * v[..., 0, None]
    x = fma32(m[..., 1], v[..., 1, None].expand_as(x), x)
    return fma32(m[..., 2], v[..., 2, None].expand_as(x), x)


def _unit(a):
    """a / max(|a|, 1e-30) along the last axis, as the reference divides."""
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-30)


def retransform_geometry(geometry, deltas, normal_deltas):
    """Apply per-primitive delta transforms to the device geometry.

    deltas: (P, 4, 4) float32, the delta world matrix per flattened
    primitive id (geometry.tri_prim), identity for unmoved primitives;
    normal_deltas: (P, 3, 3) float32, the inverse transpose of each
    delta's linear part (`build_deltas`), on the geometry's device.

    The triangles of a primitive whose delta is not exactly the identity
    get, in the reference's order: v0 moved by the whole delta, e1, e2
    and the corner tangents by its linear part, the corner normals by
    the normal delta and normalised, and their shade-table columns
    rewritten (0:9 normals, 15:18 the unit geometric normal of e1 x e2,
    20:29 tangents, 29 the uv texel density sqrt(uv area / max(world
    area, 1e-12))). The other rows are left as they are, bit for bit, as
    are the uvs, materials, slot order and vertex colours. The cluster
    boxes and `tri_packed` (rows 0-8 and the span boxes of row 9) are
    then rebuilt over the whole soup by the uploader's rule. Returns a
    new DeviceGeometry."""
    g = geometry
    real = g.tri_mat >= 0
    eye = torch.eye(4, dtype=deltas.dtype, device=deltas.device)
    moved_prim = (deltas != eye).flatten(1).any(dim=1)
    pid = torch.clamp(g.tri_prim, min=0).long()
    rows = torch.nonzero(real & moved_prim[pid]).squeeze(1)
    v0, e1, e2 = g.tri_v0, g.tri_e1, g.tri_e2
    normals, tangents, shade = g.normals, g.tangents, g.shade_table
    if rows.numel():
        m = deltas[pid[rows]]
        r = normal_deltas[pid[rows]]
        lin = m[:, :3, :3]
        v0_r = _mat_vec(lin, v0[rows]) + m[:, :3, 3]
        e1_r = _mat_vec(lin, e1[rows])
        e2_r = _mat_vec(lin, e2[rows])
        n_r = _unit(_mat_vec(r, normals[rows]))
        tan_r = _mat_vec(lin, tangents[rows])
        cross = torch.linalg.cross(e1_r, e2_r)
        ng = _unit(cross)
        uv3 = g.uvs[rows]
        uv_area = 0.5 * torch.abs(
            (uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
            - (uv3[:, 1, 1] - uv3[:, 0, 1]) * (uv3[:, 2, 0] - uv3[:, 0, 0])
        )
        world_area = 0.5 * torch.linalg.vector_norm(cross, dim=1)
        k = rows.shape[0]
        shade_r = shade[rows].clone()
        shade_r[:, 0:9] = n_r.reshape(k, 9)
        shade_r[:, 15:18] = ng
        shade_r[:, 20:29] = tan_r.reshape(k, 9)
        shade_r[:, 29] = torch.sqrt(uv_area / torch.clamp(world_area, min=1e-12))
        v0, e1, e2 = (a.index_copy(0, rows, b) for a, b in
                      ((v0, v0_r), (e1, e1_r), (e2, e2_r)))
        normals = normals.index_copy(0, rows, n_r)
        tangents = tangents.index_copy(0, rows, tan_r)
        shade = shade.index_copy(0, rows, shade_r)
    cluster_min, cluster_max = cluster_boxes(v0, e1, e2, real)
    return dataclasses.replace(
        g,
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        normals=normals, tangents=tangents, shade_table=shade,
        cluster_min=cluster_min, cluster_max=cluster_max,
        tri_packed=pack_slots(v0, e1, e2, real),
    )


def build_deltas(prim_node, node_deltas, num_nodes, device):
    """The (P, 4, 4) delta and (P, 3, 3) normal-delta tables from a
    {node index: delta 4x4} dict and the prim -> node map recorded at
    upload (DeviceScene.prim_node): identity for the primitives of
    unmoved nodes, inv(d[:3, :3]).T in float32 numpy as the reference
    computes it. Both tables land on `device`."""
    del num_nodes  # the reference's signature; prim_node names the nodes
    p = max(len(prim_node), 1)
    deltas = np.tile(np.eye(4, dtype=np.float32), (p, 1, 1))
    ndeltas = np.tile(np.eye(3, dtype=np.float32), (p, 1, 1))
    for pi, ni in enumerate(prim_node):
        d = node_deltas.get(ni)
        if d is not None:
            deltas[pi] = d
            ndeltas[pi] = np.linalg.inv(d[:3, :3]).T
    return torch.from_numpy(deltas).to(device), torch.from_numpy(ndeltas).to(device)
