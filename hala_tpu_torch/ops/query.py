"""The visibility layer: which engine answers a query, sorted or not.

`resolve(settings, scene)` reads `RenderSettings` and the scene and
returns a `QueryPlan`; `closest` and `occluded` run one query of a plan
on this device through `_ENGINES`, the one table of each engine's
closest-hit and any-hit calls, under the coherence sort
(`compaction.sorted_query`) where `sort_rays` asks for it. The path
tracer (models/integrator.py) resolves a plan once a tile and names no
engine. The same plan holds on every device: for CPU tensors the
kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from .bvh import intersect_bvh, occluded_bvh
from .cluster import intersect_clustered
from .compaction import query_coherence_key, sorted_query
from .dense import DENSE_MAX_CLUSTERS, occluded_dense
from .intersect import Hit, full_t_max, intersect_bruteforce, occluded_bruteforce
from .pallas.intersect_kernel import STAGE_MAX, intersect_pallas, occluded_pallas, prefix_slots
from .traverse import MATRIX_MAX_CLUSTERS, intersect_grouped, intersect_matrix, intersect_traversed
from .wavefront import WAVEFRONT_ID_LIMIT, intersect_wavefront

_INTERSECTORS = ("auto", "pallas", "matrix", "grouped", "wavefront", "traverse",
                "cluster", "bruteforce", "bvh", "legacy")
_MATRIX_FAMILY = ("wavefront", "matrix", "grouped")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """The engines of one scene's queries under one `RenderSettings`.
    `k`, `extend_k` and `shadow_k` are the list lengths of the engine
    each query class runs ("traverse", "wavefront", "dense"; 0 for the
    engines that take none)."""

    engine: str          # every closest-hit query's engine
    extend: str          # the bounce rays' closest-hit query: "wavefront" or `engine`
    shadow: str          # the any-hit query: "dense", "wavefront" or `engine`
    split_shadow: bool   # shadow rays get an any-hit query of their own
    k: int
    extend_k: int
    shadow_k: int
    sort_rays: bool
    chunk: int           # the brute force's triangle chunk
    wavefront_m: int
    scene_axis: object   # the mesh of a geometry shard, or None


def resolve(settings, scene) -> QueryPlan:
    """The plan of `scene` under `settings`.

    The engine: "auto" takes "pallas" up to STAGE_MAX triangles on the
    prefix (Morton) layout, "matrix" up to MATRIX_MAX_CLUSTERS clusters
    (K2's 13-bit ids) and "traverse" above. "legacy" is "bvh" where
    `use_bvh` is set, and "bvh" on a scene without a BVH (never uploaded
    with one, or moved since) is "bruteforce", as in the JAX package. On
    a geometry shard (`scene_axis`) K1's prefix trim and the node table's
    global slots do not apply: "pallas" and "bvh", and "auto" on the
    prefix layout or up to STAGE_MAX triangles, are the plain brute
    force over the local slots; the shard's own cluster count decides
    the rest.

    The routes, on a matrix-family engine only: the bounce rays go to the
    wavefront on `extend_intersector="wavefront"`; the shadow rays to the
    dense engine on `shadow_dense_k` > 0 (at most DENSE_MAX_CLUSTERS
    clusters), else to the wavefront on `shadow_intersector="wavefront"`
    or an unsorted "wavefront" engine; the wavefront routes need fewer
    than WAVEFRONT_ID_LIMIT clusters. Shadow rays get an any-hit query of
    their own on a matrix-family engine and a scene without alpha
    materials."""
    sel = settings.intersector
    if sel not in _INTERSECTORS:
        raise ValueError(
            f"Unknown intersector {sel!r}; expected one of {_INTERSECTORS}"
        )
    sharded = settings.scene_axis is not None
    g = scene.geometry
    clusters = g.tri_packed.shape[0]
    if sel == "legacy":
        sel = "bvh" if settings.use_bvh and scene.bvh is not None else "bruteforce"
    if sel == "bvh" and scene.bvh is None or sharded and sel in ("pallas", "bvh"):
        engine = "bruteforce"
    elif sel != "auto":
        engine = sel
    elif sharded and (g.prefix_layout or g.num_triangles <= STAGE_MAX):
        engine = "bruteforce"
    elif g.num_triangles <= STAGE_MAX and g.prefix_layout:
        engine = "pallas"
    else:
        engine = "matrix" if clusters <= MATRIX_MAX_CLUSTERS else "traverse"
    family = engine in _MATRIX_FAMILY
    k = {"traverse": settings.traverse_k, "wavefront": settings.wavefront_k}.get(engine, 0)

    def wavefront(choice):
        return family and choice == "wavefront" and clusters < WAVEFRONT_ID_LIMIT

    extend, extend_k = engine, k
    if wavefront(settings.extend_intersector):
        extend, extend_k = "wavefront", settings.extend_wavefront_k
    shadow, shadow_k = engine, k
    if family and settings.shadow_dense_k > 0 and clusters <= DENSE_MAX_CLUSTERS:
        shadow, shadow_k = "dense", settings.shadow_dense_k
    elif wavefront(settings.shadow_intersector) or (
            engine == "wavefront" and not settings.sort_rays):
        # shadow segments are short: their own, smaller K
        shadow, shadow_k = "wavefront", settings.shadow_wavefront_k
    return QueryPlan(
        engine=engine, extend=extend, shadow=shadow,
        split_shadow=family and not scene.materials.has_alpha,
        k=k, extend_k=extend_k, shadow_k=shadow_k, sort_rays=settings.sort_rays,
        chunk=settings.chunk, wavefront_m=settings.wavefront_m,
        scene_axis=settings.scene_axis,
    )


def _sorted(plan, scene, o, d, t, walk) -> Hit:
    """`walk(o, d, tm)` on the rays, under the coherence sort where
    `sort_rays` is on."""
    g = scene.geometry
    tm = full_t_max(t, o.shape[0], o.device)
    if not plan.sort_rays:
        return walk(o, d, tm)
    return sorted_query(lambda *r: query_coherence_key(*r, g.cluster_min, g.cluster_max),
                        walk, o, d, tm)


def _tris(scene):
    g = scene.geometry
    return g.tri_v0, g.tri_e1, g.tri_e2


# engine -> (closest(plan, scene, o, d, t_max, k, any_hit), any-hit(plan,
# scene, o, d, t_far, k)); an engine without the second answers any-hit as
# its closest query under t_far * (1 - 1e-4), which `any_hit` lets stop a
# ray at its first hit, read as tri >= 0
_ENGINES = {
    "pallas": (
        lambda p, s, o, d, t, k, a: intersect_pallas(
            o, d, *_tris(s), t_max=t, num_real=prefix_slots(s.geometry)),
        lambda p, s, o, d, t, k: occluded_pallas(
            o, d, t, *_tris(s), num_real=prefix_slots(s.geometry)),
    ),
    "matrix": (lambda p, s, o, d, t, k, a: _sorted(
        p, s, o, d, t, lambda o, d, tm: intersect_matrix(o, d, s.geometry, t_max=tm, any_hit=a)),
        None),
    "grouped": (lambda p, s, o, d, t, k, a: _sorted(
        p, s, o, d, t, lambda o, d, tm: intersect_grouped(o, d, s.geometry, t_max=tm, any_hit=a)),
        None),
    # never under the coherence sort: it sorts by candidate signature itself
    "wavefront": (lambda p, s, o, d, t, k, a: intersect_wavefront(
        o, d, s.geometry, t_max=t, any_hit=a, k_per_ray=k, m_group=p.wavefront_m), None),
    "dense": (None, lambda p, s, o, d, t, k: occluded_dense(
        o, d, t * (1.0 - 1e-4), s.geometry, k=k)),
    "traverse": (lambda p, s, o, d, t, k, a: _sorted(
        p, s, o, d, t, lambda o, d, tm: intersect_traversed(o, d, s.geometry, t_max=tm,
                                                           k_per_ray=k)), None),
    "cluster": (lambda p, s, o, d, t, k, a: _sorted(
        p, s, o, d, t, lambda o, d, tm: intersect_clustered(o, d, s.geometry, t_max=tm)), None),
    "bvh": (
        lambda p, s, o, d, t, k, a: intersect_bvh(s.bvh, s.geometry, o, d, t_max=t),
        lambda p, s, o, d, t, k: occluded_bvh(s.bvh, s.geometry, o, d, t),
    ),
    "bruteforce": (
        lambda p, s, o, d, t, k, a: intersect_bruteforce(o, d, *_tris(s), t_max=t, chunk=p.chunk),
        lambda p, s, o, d, t, k: occluded_bruteforce(o, d, t, *_tris(s), chunk=p.chunk),
    ),
}


def closest(plan: QueryPlan, scene, o, d, t_max=None, extend: bool = False) -> Hit:
    """The closest triangle hit in (1e-4, t_max) of this device's
    geometry; `extend` marks the bounce rays' query (`plan.extend`)."""
    engine, k = (plan.extend, plan.extend_k) if extend else (plan.engine, plan.k)
    return _ENGINES[engine][0](plan, scene, o.contiguous(), d.contiguous(), t_max, k, False)


def occluded(plan: QueryPlan, scene, o, d, t_far) -> torch.Tensor:
    """True where a triangle of this device's geometry lies in
    (1e-4, t_far * (1 - 1e-4)): `plan.shadow`'s any-hit query."""
    o, d = o.contiguous(), d.contiguous()
    query, any_hit = _ENGINES[plan.shadow]
    if any_hit is not None:
        return any_hit(plan, scene, o, d, t_far, plan.shadow_k)
    return query(plan, scene, o, d, t_far * (1.0 - 1e-4), plan.shadow_k, True).tri >= 0
