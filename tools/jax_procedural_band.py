#!/usr/bin/env python
"""Film mean of examples/render_procedural.py's scene through the JAX
package on the CPU, at the settings of chip_smoke.py's procedural phase
(512x512, max_depth 6, rr_depth 2, frames 0-15, "bruteforce": exact
brute-force hits in plain jnp, the estimator of the Pallas path):

    JAX_PLATFORMS=cpu python tools/jax_procedural_band.py

Prints one JSON line with the mean of the film's RGB and the traced rays
per camera ray; chip_smoke.py's PROCEDURAL_MEAN is this mean.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from hala_tpu import Material, MaterialType, ProceduralSphere  # noqa: E402
from hala_tpu.models import integrator as jint  # noqa: E402
from hala_tpu.scene.loader.uploader import SceneUploader  # noqa: E402
from hala_tpu.scene.procedural import cornell_box  # noqa: E402

SIZE, FRAMES = 512, 16


def scene():
    """examples/render_procedural.py's Cornell box and three spheres."""
    s = cornell_box()
    blue = Material(base_color=np.array([0.2, 0.4, 0.9], np.float32))
    metal = Material(type=MaterialType.DISNEY,
                     base_color=np.array([0.95, 0.85, 0.6], np.float32),
                     metallic=1.0, roughness=0.15)
    glow = Material(base_color=np.array([1.0, 1.0, 1.0], np.float32),
                    emission=np.array([6.0, 3.0, 1.5], np.float32))
    for mat, center, radius in ((blue, (-0.45, -0.65, 0.1), 0.35),
                                (metal, (0.45, -0.7, -0.2), 0.30),
                                (glow, (0.0, 0.35, -0.4), 0.15)):
        s.materials.append(mat)
        s.procedurals.append(ProceduralSphere(center=center, radius=radius,
                                              material=len(s.materials) - 1))
    return s


def main():
    dev = SceneUploader.upload(scene(), use_ray_tracing=False)
    settings = jint.RenderSettings(width=SIZE, height=SIZE, max_depth=6, rr_depth=2,
                                   intersector="bruteforce")
    film = jint.Film.create(SIZE, SIZE)
    rays = 0.0
    t0 = time.time()
    for f in range(FRAMES):
        film, r = jint.render_frame(dev, None, jint.Uniforms.default(), film, f, settings)
        rays += float(r)
    accum = np.asarray(film.accum)[..., :3]
    print(json.dumps(dict(mean=float(accum.mean()), frames=FRAMES, size=SIZE,
                          rays_per_primary=rays / (SIZE * SIZE * FRAMES),
                          finite=bool(np.isfinite(accum).all()),
                          seconds=time.time() - t0)))


if __name__ == "__main__":
    main()
