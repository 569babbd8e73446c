#!/usr/bin/env python
"""End-to-end example on the PyTorch port: progressive path trace of the
Cornell box, configured through `RenderConfig`.

    python examples/torch_render_cornell.py [frames] [out_prefix] [--config cfg.json] [--device cpu]

Writes {out}_color.pfm / _albedo.pfm / _normal.pfm (the reference's
save_images AOV set), on the GPU unless `--device cpu` is given. A JSON
config (`RenderConfig.save`, the JAX package's files too) replaces the
settings below; with its `scene_path` set, that scene replaces the
Cornell box.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hala_tpu_torch.scene.procedural import cornell_box
from hala_tpu_torch.utils.config import RenderConfig


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="?", type=int, default=64)
    ap.add_argument("out", nargs="?", default="./out/torch_cornell")
    ap.add_argument("--config", help="a RenderConfig JSON file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    if args.config:
        cfg = RenderConfig.load(args.config)
    else:
        cfg = RenderConfig(name="cornell", width=512, height=512, max_depth=6,
                           rr_depth=2, enable_aces=True, max_frames=args.frames)
    r = cfg.build_renderer(device=args.device)
    if r.scene is None:
        r.set_scene(cornell_box())
    r.commit()
    r.render_loop(args.frames)
    r.save_images(args.out + ".pfm")
    m = r.statistics.last_metrics
    print(f"rendered {args.frames} frames; {m.get('mrays_per_s', 0):.1f} Mrays/s")
    print(f"wrote {args.out}_color.pfm / _albedo.pfm / _normal.pfm")


if __name__ == "__main__":
    main()
