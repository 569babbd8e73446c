#!/usr/bin/env python3
"""The control of the comparison that decides `correct`.

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 [--frames N] [--device cuda]

For each seed it computes the plain reference in float32 and again in
bfloat16 (the next precision below the configurations' float32), at the
run's own pixels and for `--frames` frames (a path-traced run's
progressive frame count; for a rasterized run, the frame whose pose of
the camera path is compared), puts the bfloat16
values in the program's place and prints the number `correct` compares,
the share of pixels off. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402
from lib import compare  # noqa: E402


def control_pct(cell, seed: int, frames: int, device, overrides=None) -> float:
    tr = dict(cell.traffic, **(overrides or {}))
    host = run.host_scene(cell.config, seed, tr["camera_poses"],
                          tr.get("camera_path_seed", 0))
    rng = np.random.default_rng([seed, 1])
    pixels = np.sort(rng.choice(tr["width"] * tr["height"], tr["check_pixels"], replace=False))
    pose = (frames - 1) % tr["camera_poses"]
    ref, covered = compare.reference_values(cell.config, tr, host, pixels, frames, device,
                                            camera=pose)
    low, _ = compare.reference_values(cell.config, tr, host, pixels, frames, device,
                                      dtype=torch.bfloat16, camera=pose)
    return 100.0 * float(compare.pixels_off(low, ref, covered).float().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = run.Cell(args.workload)
    for seed in args.seeds:
        pct = control_pct(cell, seed, args.frames, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": args.frames,
                          "control_pixels_off_pct": pct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
