#!/usr/bin/env python
"""End-to-end example on the PyTorch port: progressive path trace of a
glTF/GLB file (the twin of examples/render_gltf.py).

    python examples/torch_render_gltf.py [scene.glb] [frames] [out_prefix]
        [--device cpu] [--size W H] [--intersector NAME]

Defaults to the bundled assets/atrium.glb (34k triangles, embedded PNG
textures, quad area lights). Large scenes take the binned-SAH cluster
layout and the coherence-sorted cluster traversal through the "auto"
engine (docs/TORCH_GUIDE.md says which engine runs which kernel);
`--intersector` picks another. Writes {out}_color.pfm / _albedo.pfm /
_normal.pfm like the reference's save_images, on the GPU unless
`--device cpu` is given (then pass a small `--size`: the plain versions
of the kernels hold (rays x clusters) tables).
"""

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from hala_tpu_torch import RayTracingRenderer, Scene  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default=os.path.join(ROOT, "assets", "atrium.glb"))
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("out", nargs="?", default="out/torch_atrium")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", nargs=2, type=int, default=(960, 544), metavar=("W", "H"))
    ap.add_argument("--intersector", default="auto")
    args = ap.parse_args()

    renderer = RayTracingRenderer(
        os.path.basename(args.scene), *args.size, max_depth=4, max_frames=args.frames,
        intersector=args.intersector, use_bvh=args.intersector in ("bvh", "legacy"),
        device=args.device,
    )
    renderer.set_scene(Scene.load(args.scene))
    renderer.commit()
    renderer.render_loop(args.frames)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    renderer.save_images(args.out + ".pfm")
    print(f"{args.frames} frames, {renderer.total_rays / 1e6:.1f} Mrays -> "
          f"{args.out}_color.pfm")


if __name__ == "__main__":
    main()
