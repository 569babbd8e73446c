#!/usr/bin/env python
"""Write assets/atrium_x5.glb: assets/atrium_big.glb laid end to end five
times as one long hall.

    python3 tools/make_instances.py [SRC [DST [BAYS]]]

Bay j is a copy of the source's meshed nodes translated along -x by
j * spacing, where spacing is the x extent of the source's meshes (26.0
for atrium_big), so the bays abut: their floors, long walls and roofs
join into one hall 130 units long. The triangles that lie in the plane
of a joint between two bays (atrium_big's end walls) are left out there,
so only the hall's two outer end walls stay. atrium_big's camera stands
at its +x end looking down -x, so the camera and bounce rays reach every
bay. The camera and the lights stay in bay 0; the skylights of bays 1-4
let the sky in.

The written file keeps the source's buffers, meshes, materials,
textures, lights and camera, and appends: one index accessor for each
primitive a joint cuts, one mesh for each kind of bay that loses
triangles (the first, the middle ones, the last), and the nodes of bays
1 to BAYS - 1 as root nodes. Vertex data is shared, not copied, so the
file stays near the source's size. The output is byte-stable: the same
source gives the same file.

`hall_scene` is the same layout on a host scene already loaded: loading
the written file gives the nodes and meshes `hall_scene(Scene.load(SRC))`
gives, in the same order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import sys

import numpy as np

BAYS = 5
_KINDS = ("first", "middle", "last")


def _world_x(prim, w):
    return prim.positions @ w[0, :3] + w[0, 3]


def _hall(host, bays: int):
    """(scene, spacing, origin): `hall_scene`'s result, and for each
    mesh it appends the index of the host mesh it was cut from."""
    from hala_tpu_torch.scene.cpu.mesh import Mesh
    from hala_tpu_torch.scene.cpu.node import Node

    meshed = [i for i, n in enumerate(host.nodes) if n.mesh_index is not None]
    xs = [_world_x(p, host.nodes[i].world_transform)
          for i in meshed for p in host.meshes[host.nodes[i].mesh_index].primitives]
    lo = float(min(x.min() for x in xs))
    hi = float(max(x.max() for x in xs))
    spacing = hi - lo
    tol = 1e-6 * spacing
    nodes, meshes, origin = list(host.nodes), list(host.meshes), []
    variant = {}  # (node index, kind) -> mesh index
    for i in meshed:
        node = host.nodes[i]
        for kind in [k for k in _KINDS if bays > 1 and (k != "middle" or bays > 2)]:
            planes = {"first": (lo,), "middle": (lo, hi), "last": (hi,)}[kind]
            prims, cut = [], False
            for p in host.meshes[node.mesh_index].primitives:
                x = _world_x(p, node.world_transform)[p.indices.reshape(-1, 3)]
                joint = np.zeros(len(x), bool)
                for plane in planes:
                    joint |= np.all(np.abs(x - plane) <= tol, axis=1)
                cut |= bool(joint.any())
                prims.append(dataclasses.replace(
                    p, indices=p.indices.reshape(-1, 3)[~joint].reshape(-1)))
            if cut:
                meshes.append(Mesh(primitives=prims))
                origin.append(node.mesh_index)
                variant[i, kind] = len(meshes) - 1
            else:
                variant[i, kind] = node.mesh_index
    if bays > 1:
        for i in meshed:
            nodes[i] = dataclasses.replace(nodes[i], mesh_index=variant[i, "first"])
    for j in range(1, bays):
        kind = "last" if j == bays - 1 else "middle"
        for i in meshed:
            m = host.nodes[i].world_transform.copy()
            m[0, 3] -= j * spacing
            nodes.append(Node(name=f"{host.nodes[i].name}_{j}", local_transform=m,
                              world_transform=m.copy(), mesh_index=variant[i, kind]))
    return dataclasses.replace(host, nodes=nodes, meshes=meshes), spacing, origin


def hall_scene(host, bays: int = BAYS):
    """`host` laid end to end `bays` times along -x as one hall; `host`
    itself is not changed. Bay 0 is `host`'s own nodes; bay j appends,
    for each meshed node, a root node `<name>_<j>` whose local and world
    matrix are the original's world matrix translated along x by
    -j * spacing (spacing: the x extent of the meshes). A node's mesh
    loses, in a new mesh appended to the scene, the triangles whose
    three corners lie in the plane of a joint: the x = min plane in
    every bay but the last, the x = max plane in every bay but the
    first. Returns (scene, spacing)."""
    scene, spacing, _ = _hall(host, bays)
    return scene, spacing


def _read_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError(f"{path} is not a binary glTF 2.0 file")
    doc, blob, offset = None, None, 12
    while offset < len(data):
        length, kind = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8:offset + 8 + length]
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            blob = chunk
        offset += 8 + length
    if doc is None or blob is None:
        raise ValueError(f"{path} lacks its JSON or BIN chunk")
    return doc, blob


def _write_glb(path: str, doc: dict, blob: bytes) -> None:
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(blob)


def write_hall(src: str, dst: str, bays: int = BAYS) -> float:
    """Write `src` laid out as `hall_scene` lays it to `dst`; returns
    the spacing. The source's nodes must all be roots (as make_asset.py
    writes them), so the loader's breadth-first walk meets the new
    nodes last, in the order `hall_scene` appends them."""
    from hala_tpu_torch.scene.cpu.scene import Scene

    doc, blob = _read_glb(src)
    roots = doc["scenes"][doc.get("scene", 0)]["nodes"]
    if sorted(roots) != list(range(len(doc["nodes"]))):
        raise ValueError(f"{src}: every node must be a root of the scene")
    host = Scene.load(src)
    scene, spacing, origin = _hall(host, bays)
    blob = bytearray(blob)
    for m, src_mesh in enumerate(origin, start=len(host.meshes)):
        gmesh = json.loads(json.dumps(doc["meshes"][src_mesh]))
        gmesh["name"] = f"{gmesh.get('name', 'mesh')}_{m}"
        for gprim, prim, was in zip(gmesh["primitives"], scene.meshes[m].primitives,
                                    host.meshes[src_mesh].primitives):
            if len(prim.indices) == len(was.indices):
                continue
            data = np.ascontiguousarray(prim.indices, "<u4").tobytes()
            doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                                       "byteLength": len(data), "target": 34963})
            blob += data
            doc["accessors"].append({"bufferView": len(doc["bufferViews"]) - 1,
                                     "componentType": 5125, "count": len(prim.indices),
                                     "type": "SCALAR"})
            gprim["indices"] = len(doc["accessors"]) - 1
        doc["meshes"].append(gmesh)
    doc["buffers"][0]["byteLength"] = len(blob)
    for i, node in enumerate(scene.nodes):
        if i < len(host.nodes):
            if node.mesh_index is not None:
                doc["nodes"][i]["mesh"] = node.mesh_index
            continue
        # glTF matrices are column-major; float32 values written exactly
        cols = np.asarray(node.local_transform, np.float32).T.reshape(-1)
        roots.append(len(doc["nodes"]))
        doc["nodes"].append({"name": node.name, "mesh": node.mesh_index,
                             "matrix": [float(v) for v in cols]})
    doc["asset"]["generator"] = (f"{doc['asset'].get('generator', '')} + "
                                 f"make_instances hall x{bays}").lstrip(" +")
    _write_glb(dst, doc, bytes(blob))
    return spacing


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = sys.argv[1:]
    src = args[0] if len(args) > 0 else "assets/atrium_big.glb"
    dst = args[1] if len(args) > 1 else "assets/atrium_x5.glb"
    bays = int(args[2]) if len(args) > 2 else BAYS
    spacing = write_hall(src, dst, bays)
    print(f"wrote {dst}: {bays} bays {spacing:.1f} long along -x, "
          f"{os.path.getsize(dst) / 1e6:.2f} MB")
