"""The visibility layer's plan (hala_tpu_torch/ops/query.py): one table of
`resolve` cases, each a RenderSettings and a scene stub with the fields
the rules read, against the plan's engine, routes, list lengths and
`split_shadow`. No query runs here; the films of every engine and route
are held to the JAX package's in tests/test_torch_render.py,
test_torch_bvh.py, test_torch_parallel.py, test_torch_wavefront.py,
test_torch_traverse.py and test_torch_dense.py.
"""

import types

import pytest
import torch

from hala_tpu_torch.models.integrator import RenderSettings
from hala_tpu_torch.ops import query
from hala_tpu_torch.ops.dense import DENSE_MAX_CLUSTERS
from hala_tpu_torch.ops.pallas.intersect_kernel import STAGE_MAX
from hala_tpu_torch.ops.traverse import MATRIX_MAX_CLUSTERS
from hala_tpu_torch.ops.wavefront import WAVEFRONT_ID_LIMIT
from hala_tpu_torch.parallel.tiling import Mesh


def _scene(tris=34, prefix=True, clusters=1, bvh=True, alpha=False):
    """The fields `resolve` reads of a device scene. The default is the
    Cornell box's: 34 triangles on the Morton (prefix) layout, a BVH."""
    g = types.SimpleNamespace(num_triangles=tris, prefix_layout=prefix,
                              tri_packed=torch.zeros((clusters, 1, 1)))
    return types.SimpleNamespace(geometry=g, bvh=object() if bvh else None,
                                 materials=types.SimpleNamespace(has_alpha=alpha))


def _sah(clusters, **kw):
    """A scene on the SAH layout with `clusters` clusters."""
    return dict(tris=clusters * 128, prefix=False, clusters=clusters, **kw)


SHARD = dict(scene_axis=Mesh(None, 0, 2, torch.device("cpu")))
WF_ROUTES = dict(shadow_intersector="wavefront", extend_intersector="wavefront")

# id: (RenderSettings fields, scene fields, expected plan fields)
CASES = {
    # "bvh" and "legacy"
    "bvh": (dict(intersector="bvh"), {}, dict(engine="bvh")),
    "bvh_without_use_bvh": (dict(intersector="bvh", use_bvh=False), {}, dict(engine="bvh")),
    "bvh_on_a_scene_without_one": (dict(intersector="bvh"), dict(bvh=False),
                                   dict(engine="bruteforce")),
    "bvh_on_a_shard": (dict(intersector="bvh", **SHARD), {}, dict(engine="bruteforce")),
    "legacy": (dict(intersector="legacy"), {}, dict(engine="bvh")),
    "legacy_without_use_bvh": (dict(intersector="legacy", use_bvh=False), {},
                               dict(engine="bruteforce")),
    "legacy_on_a_scene_without_one": (dict(intersector="legacy"), dict(bvh=False),
                                      dict(engine="bruteforce")),
    "legacy_on_a_shard": (dict(intersector="legacy", **SHARD), {}, dict(engine="bruteforce")),
    # "auto" and the explicit engines, on one device and on a shard
    "auto_on_the_cornell_box": (dict(), {}, dict(engine="pallas", shadow="pallas",
                                                extend="pallas", split_shadow=False)),
    "auto_at_4096_triangles": (dict(), dict(tris=STAGE_MAX), dict(engine="pallas")),
    "auto_past_4096_triangles": (dict(), dict(tris=STAGE_MAX + 1, clusters=33),
                                 dict(engine="matrix")),
    "pallas_on_a_shard": (dict(intersector="pallas", **SHARD), dict(tris=STAGE_MAX),
                          dict(engine="bruteforce")),
    "auto_on_a_shard": (dict(**SHARD), dict(tris=STAGE_MAX), dict(engine="bruteforce")),
    "auto_on_a_shard_of_few_triangles": (dict(**SHARD), dict(tris=STAGE_MAX, prefix=False),
                                         dict(engine="bruteforce")),
    "matrix_on_a_shard": (dict(intersector="matrix", **SHARD), dict(tris=STAGE_MAX),
                          dict(engine="matrix")),
    "auto_on_a_shard_at_8191_clusters": (
        dict(**SHARD), dict(tris=5000, prefix=False, clusters=MATRIX_MAX_CLUSTERS),
        dict(engine="matrix")),
    "auto_on_a_shard_past_8191_clusters": (
        dict(**SHARD), dict(tris=5000, prefix=False, clusters=MATRIX_MAX_CLUSTERS + 1),
        dict(engine="traverse")),
    "auto_at_8191_clusters": (dict(), _sah(8191), dict(engine="matrix", split_shadow=True)),
    "auto_past_8191_clusters": (dict(), _sah(8192),
                                dict(engine="traverse", k=12, split_shadow=False)),
    "traverse": (dict(intersector="traverse", traverse_k=4), {},
                 dict(engine="traverse", k=4, extend="traverse", shadow="traverse")),
    "cluster": (dict(intersector="cluster"), {}, dict(engine="cluster", shadow="cluster")),
    "grouped": (dict(intersector="grouped"), _sah(40),
                dict(engine="grouped", extend="grouped", shadow="grouped")),
    "bruteforce": (dict(intersector="bruteforce"), {}, dict(engine="bruteforce", chunk=2048)),
    # the shadow and extend routes
    "auto_takes_no_route": (dict(), _sah(40),
                            dict(engine="matrix", extend="matrix", shadow="matrix")),
    "wavefront_routes": (dict(intersector="matrix", extend_wavefront_k=3, **WF_ROUTES),
                         _sah(40), dict(extend="wavefront", extend_k=3, shadow="wavefront",
                                        shadow_k=8, wavefront_m=32)),
    "routes_need_the_matrix_family": (dict(intersector="pallas", **WF_ROUTES), {},
                                      dict(extend="pallas", shadow="pallas")),
    "wavefront_routes_at_8190_clusters": (dict(intersector="matrix", **WF_ROUTES),
                                          _sah(WAVEFRONT_ID_LIMIT - 1),
                                          dict(extend="wavefront", shadow="wavefront")),
    "wavefront_routes_past_8190_clusters": (dict(intersector="matrix", **WF_ROUTES),
                                            _sah(WAVEFRONT_ID_LIMIT),
                                            dict(extend="matrix", shadow="matrix")),
    "dense_at_8192_clusters": (dict(intersector="matrix", shadow_dense_k=8),
                               _sah(DENSE_MAX_CLUSTERS), dict(shadow="dense", shadow_k=8)),
    "dense_past_8192_clusters": (dict(intersector="matrix", shadow_dense_k=8),
                                 _sah(DENSE_MAX_CLUSTERS + 1), dict(shadow="matrix")),
    "dense_before_the_wavefront": (dict(intersector="matrix", shadow_dense_k=4, **WF_ROUTES),
                                   _sah(40), dict(shadow="dense", shadow_k=4,
                                                  extend="wavefront")),
    "dense_needs_the_matrix_family": (dict(intersector="traverse", shadow_dense_k=8),
                                      _sah(40), dict(shadow="traverse")),
    "wavefront_engine": (dict(intersector="wavefront"), _sah(40),
                         dict(engine="wavefront", k=16, extend="wavefront", extend_k=16,
                              shadow="wavefront", shadow_k=16)),
    "wavefront_engine_unsorted": (dict(intersector="wavefront", sort_rays=False), _sah(40),
                                  dict(shadow="wavefront", shadow_k=8, extend_k=16,
                                       sort_rays=False)),
    "dense_before_the_unsorted_wavefront": (
        dict(intersector="wavefront", sort_rays=False, shadow_dense_k=8), _sah(40),
        dict(shadow="dense", shadow_k=8)),
    # split_shadow: a matrix-family engine and no alpha material
    "split_shadow": (dict(intersector="matrix"), _sah(40), dict(split_shadow=True)),
    "split_shadow_off_with_alpha": (dict(intersector="matrix"), _sah(40, alpha=True),
                                    dict(split_shadow=False, shadow="matrix")),
    "split_shadow_off_the_matrix_family": (dict(intersector="cluster"), _sah(40),
                                           dict(split_shadow=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve(case):
    settings, scene, want = CASES[case]
    plan = query.resolve(RenderSettings(width=8, height=8, **settings), _scene(**scene))
    got = {name: getattr(plan, name) for name in want}
    assert got == want
    assert plan.scene_axis is settings.get("scene_axis")


def test_unknown_intersector_raises():
    with pytest.raises(ValueError, match="Unknown intersector 'kd'"):
        query.resolve(RenderSettings(width=8, height=8, intersector="kd"), _scene())


def test_limits():
    """The limits' values: K1 stages 4096 triangles, K2's ids are 13-bit,
    the cull's 13-bit key takes 8192 clusters and the wavefront 8190."""
    assert (STAGE_MAX, MATRIX_MAX_CLUSTERS, DENSE_MAX_CLUSTERS, WAVEFRONT_ID_LIMIT) == (
        4096, 8191, 8192, 8191)
    s = RenderSettings(width=8, height=8)
    assert (s.wavefront_k, s.wavefront_m, s.shadow_wavefront_k, s.extend_wavefront_k,
            s.traverse_k) == (16, 32, 8, 8, 12)


def test_the_cornell_upload_is_the_default_stub():
    """The stub's defaults are the uploaded Cornell box's fields."""
    from hala_tpu_torch.scene.loader.uploader import SceneUploader
    from hala_tpu_torch.scene.procedural import cornell_box

    dev = SceneUploader.upload(cornell_box(), device="cpu")
    g = dev.geometry
    assert (g.num_triangles, g.prefix_layout, dev.bvh is not None,
            dev.materials.has_alpha) == (34, True, True, False)
    for sel in ("auto", "legacy", "matrix"):
        s = RenderSettings(width=8, height=8, intersector=sel)
        assert query.resolve(s, dev) == query.resolve(s, _scene(clusters=g.tri_packed.shape[0]))
