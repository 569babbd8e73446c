#!/usr/bin/env python
"""End-to-end example on the PyTorch port: an animated object inside a
progressive render.

    python examples/torch_render_animated.py [frames_per_pose] [out_prefix] [--device cpu]

Renders the Cornell box while translating the tall box through three
poses, on the GPU unless `--device cpu` is given. The tall box is split
onto its own scene node, so each `set_node_transform` + `update_scene`
moves just that node's triangles on the device (the delta matrix, the
cluster boxes and slot blocks rebuilt by the uploader's rule,
hala_tpu_torch/ops/animate.py) with no host re-upload. Accumulation
restarts at every pose (`reset_accumulation`): a moved object
invalidates the running mean.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from hala_tpu_torch import Mesh, Node, RayTracingRenderer
from hala_tpu_torch.scene.procedural import cornell_box

POSES_DX = (0.0, 0.15, 0.3)  # the tall box's x offset at each pose


def translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def tall_box_scene(**cornell_kw):
    """The Cornell box with its tall box on a node of its own. Returns
    (scene, node index of the tall box, its world transform)."""
    scene = cornell_box(**cornell_kw)
    # cornell_box puts everything on one mesh node: 5 wall quads, then 6
    # tall-box quads, then 6 short-box quads
    prims = scene.meshes[0].primitives
    scene.meshes[0].primitives = prims[:5] + prims[11:]
    scene.meshes.append(Mesh(primitives=prims[5:11]))
    box_node = Node(name="tall_box")
    box_node.mesh_index = 1
    scene.nodes.append(box_node)
    scene.update_node_hierarchies()
    node = len(scene.nodes) - 1
    return scene, node, np.asarray(scene.nodes[node].world_transform, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("out", nargs="?", default="out/torch_animated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    scene, node, w0 = tall_box_scene()
    r = RayTracingRenderer("animated", 512, 512, max_depth=4, rr_depth=2,
                           device=args.device)
    r.set_scene(scene)
    r.commit()
    for pose, dx in enumerate(POSES_DX):
        r.set_node_transform(node, translate(dx, 0.0, 0.0) @ w0)
        r.update_scene()
        r.reset_accumulation()
        r.render_loop(args.frames)
        r.save_images(f"{args.out}_pose{pose}.pfm")
        print(f"pose {pose}: dx={dx:+.2f}, {args.frames} frames accumulated")


if __name__ == "__main__":
    main()
