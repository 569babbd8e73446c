"""Multi-device rendering over `torch.distributed`, one rank per device.

Two modes over a 1-D mesh of ranks (the JAX package's `parallel/` over
a device mesh under `shard_map`):

- film tiling (tiling.py): the scene replicated, each rank renders its
  own rows, with no communication in the render loop;
- geometry sharding (scene_shard.py): the cluster blocks and shade rows
  sharded too, rays all-gathered per query and hits merged by the
  lexicographic (t, tri) minimum.

Both give the one-device film bit for bit.
"""

from .scene_shard import render_frame_scene_sharded, shard_scene
from .tiling import make_mesh, render_frame_multichip, TiledFilm

__all__ = [
    "make_mesh",
    "render_frame_multichip",
    "render_frame_scene_sharded",
    "shard_scene",
    "TiledFilm",
]
