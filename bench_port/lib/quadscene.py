"""A host scene built from a configuration's published quads.

A configuration of kind "quads" lists its geometry as four-cornered
faces (the Cornell Box data's form) in groups, each group with the point
its normals face toward or away from, plus materials by name, one quad
light and a pinhole camera, all in the source's units. `build` maps them
to scene units (`to_scene`: centre to the origin, then scaled) and fills
the program's host scene graph with them: each quad two triangles
(0, 1, 2) and (0, 2, 3), wound so that the face's normal points its
group's way. The program receives only this scene, as it would receive
a parsed glTF file.
"""

from __future__ import annotations

import numpy as np


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def build(spec: dict):
    from hala_tpu_torch.scene.cpu.camera import PerspectiveCamera
    from hala_tpu_torch.scene.cpu.light import Light, LightType
    from hala_tpu_torch.scene.cpu.material import Material, MaterialType
    from hala_tpu_torch.scene.cpu.mesh import Mesh, Primitive
    from hala_tpu_torch.scene.cpu.node import Node
    from hala_tpu_torch.scene.cpu.scene import Scene

    centre = np.asarray(spec["to_scene"]["center"], np.float64)
    scale = float(spec["to_scene"]["scale"])

    def to_scene(p):
        return (np.asarray(p, np.float64) - centre) * scale

    names = list(spec["materials"])
    scene = Scene()
    scene.materials = [Material(type=MaterialType.DIFFUSE,
                                base_color=np.asarray(spec["materials"][n], np.float32),
                                roughness=0.0) for n in names]
    prims = []
    for group in spec["groups"]:
        point = to_scene(group["point"])
        sign = 1.0 if group["faces"] == "toward" else -1.0
        for quad in group["quads"]:
            c = to_scene(quad["corners"])
            n = _unit(np.cross(c[2] - c[0], c[3] - c[1]))
            if sign * np.dot(n, point - c.mean(axis=0)) < 0:
                n = -n
            if np.dot(np.cross(c[1] - c[0], c[2] - c[0]), n) < 0:
                c = c[[0, 3, 2, 1]]
            prims.append(Primitive(
                indices=np.array([0, 1, 2, 0, 2, 3], np.uint32),
                positions=c.astype(np.float32),
                normals=np.tile(n.astype(np.float32), (4, 1)),
                tangents=np.tile(_unit(c[1] - c[0]).astype(np.float32), (4, 1)),
                tex_coords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                material_index=names.index(quad["material"]),
            ))
    scene.meshes = [Mesh(primitives=prims)]
    root = Node(name="root")
    root.mesh_index = 0
    scene.nodes.append(root)

    # The quad light: its node's x and y axes span the quad, it emits
    # along +z, here down from the ceiling.
    lt = spec["light"]
    c = to_scene(lt["corners"])
    eu, ev = c[1] - c[0], c[3] - c[0]
    x_axis, y_axis = _unit(eu), _unit(ev)
    z_axis = _unit(np.cross(x_axis, y_axis))
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = x_axis, y_axis, z_axis
    m[:3, 3] = c.mean(axis=0) + z_axis * float(lt["below_ceiling"]) * scale
    light_node = Node(name="light", local_transform=m)
    light_node.light_index = 0
    scene.nodes.append(light_node)
    scene.lights = [Light(color=np.asarray(lt["color"], np.float32),
                          intensity=float(lt["intensity"]), light_type=LightType.QUAD,
                          params=(float(np.linalg.norm(eu)), float(np.linalg.norm(ev))))]

    # The pinhole camera: forward is the node's -z, up its y.
    cam = spec["camera"]
    forward, up = _unit(cam["direction"]), _unit(cam["up"])
    right = _unit(np.cross(forward, up))
    cm = np.eye(4, dtype=np.float32)
    cm[:3, 0], cm[:3, 1], cm[:3, 2] = right, np.cross(right, forward), -forward
    cm[:3, 3] = to_scene(cam["position"])
    cam_node = Node(name="camera", local_transform=cm)
    cam_node.camera_index = 0
    scene.nodes.append(cam_node)
    yfov = 2.0 * np.arctan(0.5 * cam["film"] / cam["focal_length"])
    distance = float(np.linalg.norm(to_scene(cam["position"])))
    scene.cameras = [PerspectiveCamera(aspect=1.0, yfov=float(yfov), znear=float(cam["znear"]),
                                       focal_distance=distance)]
    scene.update_node_hierarchies()
    return scene
