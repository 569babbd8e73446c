#!/usr/bin/env python
"""Procedural-primitive example on the PyTorch port (the twin of
examples/render_procedural.py): analytic spheres traced beside the
Cornell box triangles (the reference's AABB-geometry + intersection-
shader path, gpu_uploader.rs:818-840, registered in code, not glTF).

    python examples/torch_render_procedural.py [frames] [out_prefix] [--device cpu]

Three spheres with different material responses (diffuse, Disney metal,
emissive) shade through the full material system and block shadow
rays. Writes {out}_color.pfm / _albedo.pfm / _normal.pfm, on the GPU
unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from hala_tpu_torch import Material, MaterialType, ProceduralSphere, RayTracingRenderer  # noqa: E402
from hala_tpu_torch.scene.procedural import cornell_box  # noqa: E402


def procedural_scene():
    """The Cornell box and three spheres (diffuse, Disney metal, emissive)."""
    scene = cornell_box()
    blue = Material(base_color=np.array([0.2, 0.4, 0.9], np.float32))
    metal = Material(type=MaterialType.DISNEY,
                     base_color=np.array([0.95, 0.85, 0.6], np.float32),
                     metallic=1.0, roughness=0.15)
    glow = Material(base_color=np.array([1.0, 1.0, 1.0], np.float32),
                    emission=np.array([6.0, 3.0, 1.5], np.float32))
    for mat, center, radius in ((blue, (-0.45, -0.65, 0.1), 0.35),
                                (metal, (0.45, -0.7, -0.2), 0.30),
                                (glow, (0.0, 0.35, -0.4), 0.15)):
        scene.materials.append(mat)
        scene.procedurals.append(ProceduralSphere(center=center, radius=radius,
                                                  material=len(scene.materials) - 1))
    return scene


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=64)
    ap.add_argument("out", nargs="?", default="./out/torch_procedural")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    r = RayTracingRenderer("procedural", 512, 512, max_depth=6, rr_depth=2,
                           enable_tonemap=True, enable_aces=True, use_simple_aces=False,
                           max_frames=args.frames, device=args.device)
    r.set_scene(procedural_scene())
    r.commit()
    r.render_loop(args.frames, frames_per_dispatch=min(16, args.frames))
    r.save_images(args.out + ".pfm")
    m = r.statistics.last_metrics
    print(f"rendered {args.frames} frames ({m.get('mrays_per_s', 0):.1f} Mrays/s) "
          f"-> {args.out}_color.pfm")


if __name__ == "__main__":
    main()
