"""Wavefront ray stream compaction and coherence sorting.

The JAX package's ops/compaction.py: one argsort per query on the key
[dead | direction octant | origin Morton cell], so dead rays sink to the
end and live rays with similar direction and origin sit side by side
(neighbouring threads then fetch the same cluster blocks). The sort is
stable, as `jnp.argsort`, so the permutation equals the JAX package's.
`sorted_query` is the one coherence-sorted dispatch of a query: the
matrix family's (`traverse.matrix_query`) and the "traverse" and
"cluster" engines' (ops/query.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from .intersect import Hit
from .morton import morton3d


class RayOrder(NamedTuple):
    order: torch.Tensor      # (N,) int64: permutation old -> sorted
    inverse: torch.Tensor    # (N,) int64: scatter sorted results back
    num_alive: torch.Tensor  # () int64


def coherence_key(o, d, active, scene_min, scene_max, cell_bits: int = 9):
    """[dead | direction octant | origin Morton cell] as int64 holding
    the JAX package's uint32 key."""
    octant = ((d[:, 0] >= 0).to(torch.int64)
              | ((d[:, 1] >= 0).to(torch.int64) << 1)
              | ((d[:, 2] >= 0).to(torch.int64) << 2))
    cell = morton3d(o, scene_min, scene_max) >> (30 - cell_bits * 3)
    return (((~active).to(torch.int64) << 31) | (octant << 27)
            | (cell & ((1 << 27) - 1)))


def query_coherence_key(o, d, t_max, cluster_min, cluster_max) -> torch.Tensor:
    """`coherence_key` of a query's rays: octant and origin Morton cell
    inside the clusters' bounds, dead rays (t_max <= 0) last."""
    smin = cluster_min.amin(dim=0)
    smax = torch.where(cluster_max < 1e30, cluster_max, -torch.inf).amax(dim=0)
    return coherence_key(o, d, ~(t_max <= 0), smin, smax)


def order_by(key: torch.Tensor):
    """The stable ascending order of `key` and its inverse: (order
    old -> sorted, inverse to scatter sorted results back), both int64."""
    order = torch.argsort(key, stable=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(key.shape[0], device=key.device)
    return order, inverse


def sort_rays(o, d, active, scene_min, scene_max, cell_bits: int = 9) -> RayOrder:
    """Coherence key sort. Returns the permutation and its inverse."""
    order, inverse = order_by(
        coherence_key(o, d, active, scene_min, scene_max, cell_bits))
    return RayOrder(order=order, inverse=inverse, num_alive=active.sum())


def permute(order: torch.Tensor, *arrays):
    """Apply a permutation to any number of ray-major arrays."""
    out = tuple(a[order] for a in arrays)
    return out if len(out) > 1 else out[0]


def sorted_query(key, query, o, d, tm) -> Hit:
    """Run `query(o, d, tm) -> Hit` on the rays in the stable order of
    `key(o, d, tm)` and put its hits back in the rays' order. The key,
    the sort and the permutations run in `hala.sort` spans."""
    with profiling.span("hala.sort"):
        order, inverse = order_by(key(o, d, tm))
        rays = permute(order, o, d, tm)
    hit = query(*rays)
    del rays  # the sorted rays are not kept through the inverse permutation
    with profiling.span("hala.sort"):
        return Hit(*(permute(inverse, x) for x in hit))
