"""Multi-device rendering in the port (hala_tpu_torch/parallel) on the CPU.

Mirrors tests/test_multichip.py and tests/test_scene_shard.py over gloo
ranks: one spawn per world size (2 and 4) renders every case below both
film-tiled and geometry-sharded, and each gathered film must equal the
port's one-device film bit for bit, with the same ray counts. The
one-device film must lie within relative RMSE 2e-3 of the JAX package's
film at the same settings. The padded tables are held against the JAX
package's `pad_scene_for_sharding`, and the cross-shard merge
(`merge_shard_hits`) against the JAX package's sharded `_intersect`
under shard_map on the 8-device CPU mesh (K2 in interpret mode).

The rank bodies live in this module and import no jax: a spawned rank
imports this module again.
"""

import dataclasses
import functools
import importlib
import os
import tempfile
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hala_tpu_torch.models.integrator import (
    ENV_MAP,
    Film,
    Hit,
    RenderSettings,
    Uniforms,
    _intersect_local,
    _rows_sharded,
    merge_shard_hits,
    render_frame,
)
from hala_tpu_torch.ops.query import resolve
from hala_tpu_torch.ops.cluster import cluster_boxes, pack_slots
from hala_tpu_torch.parallel import (
    TiledFilm,
    make_mesh,
    render_frame_multichip,
    render_frame_scene_sharded,
    shard_scene,
)
from hala_tpu_torch.parallel.scene_shard import (
    _SHARDED_FIELDS,
    pad_scene_for_sharding,
    scene_shard_specs,
)
from hala_tpu_torch.parallel.tiling import Mesh
from hala_tpu_torch.scene.gpu.scene import TRI_PAD, from_numpy

WORLDS = (2, 4)
MODES = ("tiled", "sharded")
REL_RMSE_TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# scenes, built the same way from either package
# ---------------------------------------------------------------------------


def _host(pkg: str, key: str):
    """Host scene `key` built with package `pkg` ("hala_tpu_torch" or
    "hala_tpu")."""
    proc = importlib.import_module(f"{pkg}.scene.procedural")
    if key == "cornell":
        return proc.cornell_box()
    if key == "alpha":
        mat = importlib.import_module(f"{pkg}.scene.cpu.material")
        pane = mat.Material(type=mat.MaterialType.DIFFUSE,
                            base_color=np.ones(3, np.float32), opacity=0.5)
        return proc.cornell_box(tall_box_material=pane)
    if key == "textures":
        img = importlib.import_module(f"{pkg}.scene.cpu.image_data")
        scene = proc.cornell_box()
        scene.materials[0].base_color_map_index = 0
        tex = np.random.RandomState(5).uniform(0.2, 1.0, (16, 16, 4)).astype(np.float32)
        scene.image_data = [img.ImageData(16, 16, img.ImageFormat.R32G32B32A32_SFLOAT, tex)]
        scene.texture2image_mapping = {0: 0}
        scene.image2data_mapping = {0: 0}
        return scene
    if key == "sponza3":  # 10 clusters
        return proc.sponza_like(rooms=(3, 3), columns_per_room=3, boxes_per_room=6)
    if key == "sponza2":  # 3 clusters
        return proc.sponza_like(rooms=(2, 2), columns_per_room=4, boxes_per_room=2)
    raise KeyError(key)


def _env_rgb():
    rgb = np.random.RandomState(3).uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    rgb[2, 5] = 40.0
    return rgb


# name: (scene, settings, frames, env map)
_S32 = dict(width=32, height=32, rr_depth=2)
CASES = {
    "cornell": ("cornell", dict(_S32, max_depth=3, tile_size=128), 2, False),
    "envmap": ("cornell", dict(_S32, max_depth=3, tile_size=128, env_type=ENV_MAP), 2, True),
    "textures": ("textures", dict(_S32, max_depth=2, tile_size=128), 2, False),
    "cluster_sorted": ("cornell", dict(_S32, max_depth=2, tile_size=128,
                                       intersector="cluster", sort_rays=True), 1, False),
    "matrix": ("cornell", dict(_S32, max_depth=2, tile_size=128, intersector="matrix"),
               1, False),
    "grouped": ("cornell", dict(_S32, max_depth=2, tile_size=128, intersector="grouped"),
                1, False),
    "wavefront_truncated": ("sponza3", dict(_S32, max_depth=2, tile_size=128,
                                            intersector="wavefront", wavefront_k=3,
                                            wavefront_m=8), 1, False),
    "spp2": ("cornell", dict(_S32, max_depth=2, tile_size=256, spp=2), 1, False),
    # tiles that do not divide the film nor a band: padding pixels differ
    "ragged_tiles": ("cornell", dict(_S32, max_depth=2, tile_size=96), 1, False),
    "uneven_aspect": ("cornell", dict(width=40, height=48, rr_depth=2, max_depth=2,
                                      tile_size=240), 2, False),
    "alpha_shadows": ("alpha", dict(_S32, max_depth=3, tile_size=128), 2, False),
    "multicluster": ("sponza2", dict(_S32, max_depth=3, tile_size=128), 2, False),
    "matrix_engine": ("sponza2", dict(width=16, height=16, rr_depth=2, max_depth=2,
                                      tile_size=256, intersector="matrix"), 1, False),
    # the split shadow query through the dense engine (K4 + plain tests + K2)
    "matrix_dense_shadows": ("sponza2", dict(width=16, height=16, rr_depth=2, max_depth=2,
                                             tile_size=256, intersector="matrix",
                                             shadow_dense_k=4), 1, False),
}


@functools.lru_cache(maxsize=None)
def _port_scene(key: str):
    from hala_tpu_torch.scene.loader.uploader import SceneUploader

    return SceneUploader.upload(_host("hala_tpu_torch", key), use_ray_tracing=False, device="cpu")


def _job(name: str) -> dict:
    from hala_tpu_torch.envmap import EnvMap

    key, kw, frames, env = CASES[name]
    return dict(scene=_port_scene(key), settings=RenderSettings(**kw), frames=frames,
                env=EnvMap.from_array(_env_rgb(), device="cpu") if env else None)


def _films(film, rays):
    return dict(accum=film.accum, albedo=film.albedo, normal=film.normal, rays=rays)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _render_ranked(mesh, job: dict, mode: str) -> dict:
    s = job["settings"]
    tiled = TiledFilm.create(mesh, s.width, s.height)
    if mode == "sharded":
        scene, step = shard_scene(job["scene"], mesh), render_frame_scene_sharded
    else:
        scene, step = job["scene"], render_frame_multichip
    uni = Uniforms.default("cpu")
    rays = []
    for f in range(job["frames"]):
        _, r = step(scene, job["env"], uni, tiled, f, s)
        rays.append(float(r))
    return _films(tiled.gather(), rays)


def _bits_table(rows: int) -> torch.Tensor:
    """(rows, 4) f32 rows of awkward bits: -0.0, +0.0, infinities, a NaN
    with a payload, a denormal, and seeded values."""
    t = torch.from_numpy(np.random.RandomState(9).normal(size=(rows, 4)).astype(np.float32))
    special = np.array([-0.0, 0.0, np.inf, -np.inf, 1e-40], np.float32)
    t.view(-1)[::3][:special.size * (rows // 4)] = torch.from_numpy(
        np.resize(special, special.size * (rows // 4)))
    t.view(torch.int32)[1, 2] = 0x7FC0_1234  # a NaN with a payload
    return t


def _owner_fetch(mesh, rank: int) -> dict:
    """`_rows_sharded` of float and int tables split over the ranks, at
    ids seeded per rank; returns every rank's ids and rows."""
    table = _bits_table(16 * mesh.size)
    mats = torch.arange(table.shape[0], dtype=torch.int32) * 7 - 5
    rows = table.shape[0] // mesh.size
    own = slice(rank * rows, (rank + 1) * rows)
    gen = torch.Generator().manual_seed(100 + rank)
    idx = torch.randint(0, table.shape[0], (64,), generator=gen, dtype=torch.int32)
    got = _rows_sharded(table[own].clone(), idx, mesh)
    got_mat = _rows_sharded(mats[own].clone(), idx, mesh)
    return dict(idx=mesh.all_gather(idx), rows=mesh.all_gather(got),
                mats=mesh.all_gather(got_mat))


def _rank_main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=world, timeout=timedelta(seconds=300))
    try:
        jobs = torch.load(os.path.join(root, "jobs.pt"), weights_only=False)
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
        out = {(name, mode): _render_ranked(mesh, job, mode)
               for name, job in jobs.items() for mode in MODES}
        out["owner_fetch"] = _owner_fetch(mesh, rank)
        if rank == 0:
            torch.save(out, os.path.join(root, "films.pt"))
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _spawned(world: int) -> dict:
    """Every case in both modes on `world` gloo ranks: {(case, mode): films}."""
    with tempfile.TemporaryDirectory() as root:
        torch.save({name: _job(name) for name in CASES}, os.path.join(root, "jobs.pt"))
        mp.spawn(_rank_main, args=(world, root), nprocs=world, join=True)
        return torch.load(os.path.join(root, "films.pt"), weights_only=False)


@functools.lru_cache(maxsize=None)
def _one_device(name: str) -> dict:
    job = _job(name)
    s = job["settings"]
    film = Film.create(s.width, s.height, "cpu")
    uni = Uniforms.default("cpu")
    rays = []
    for f in range(job["frames"]):
        _, r = render_frame(job["scene"], job["env"], uni, film, f, s)
        rays.append(float(r))
    return _films(film, rays)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_film_matches_one_device(world, name, mode):
    """The gathered film of `world` ranks equals the one-device film bit
    for bit (accum, albedo, normal) and so do the frames' ray counts."""
    got, ref = _spawned(world)[(name, mode)], _one_device(name)
    for k in ("accum", "albedo", "normal"):
        assert torch.equal(got[k], ref[k]), k
    assert got["rays"] == ref["rays"]
    assert float(ref["accum"][..., :3].mean()) > 0.01  # not an all-black film


@pytest.mark.parametrize("world", WORLDS)
def test_owner_fetch_keeps_the_owners_bits(world):
    """`_rows_sharded` over gloo returns every rank the owners' rows bit
    for bit: -0.0, infinities, a denormal and a NaN payload included (a
    float sum would turn -0.0 into +0.0), and int rows alike."""
    got = _spawned(world)["owner_fetch"]
    table = _bits_table(16 * world)
    idx = got["idx"].long()
    assert torch.equal(got["rows"].view(torch.int32), table[idx].view(torch.int32))
    assert torch.equal(got["mats"], idx.to(torch.int32) * 7 - 5)
    assert bool((table[idx].view(torch.int32) == -2**31).any())  # -0.0 was fetched


def test_ragged_tiles_count_only_the_films_rays():
    """A last tile padded past the film traces its padding pixels but
    does not count their rays: the ray count does not depend on the
    tile size (nor, so, on the band a rank renders)."""
    dev = _port_scene("cornell")
    uni = Uniforms.default("cpu")
    out = []
    for tile in (1024, 96):  # one tile; 11 tiles, the last with 32 padding pixels
        film = Film.create(32, 32, "cpu")
        _, rays = render_frame(dev, None, uni, film, 0,
                               RenderSettings(width=32, height=32, max_depth=2, tile_size=tile))
        out.append((film.accum, float(rays)))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


def test_merge_shard_hits_rule():
    """The merge keeps the smallest t, at equal t the smallest global
    tri, and the winner's u, v bits (-0.0 included); a ray no shard hits
    keeps t_max, tri -1 and zero u, v."""
    t_max = 9.0
    # rays: a tie across shards, a strict win on shard 1, a miss everywhere,
    # a tie inside the lower global ids
    a = Hit(t=torch.tensor([2.0, 3.0, t_max, 1.0]), tri=torch.tensor([7, 4, -1, 2], dtype=torch.int32),
            u=torch.tensor([0.25, 0.5, 0.0, -0.0]), v=torch.tensor([-0.0, 0.5, 0.0, 0.125]))
    b = Hit(t=torch.tensor([2.0, 1.5, t_max, 1.0]), tri=torch.tensor([0, 3, -1, 0], dtype=torch.int32),
            u=torch.tensor([0.75, -0.0, 0.0, 0.5]), v=torch.tensor([0.0, 0.25, 0.0, 0.5]))
    got = merge_shard_hits([a, b], [0, 100])
    assert got.t.tolist() == [2.0, 1.5, t_max, 1.0]
    assert got.tri.tolist() == [7, 103, -1, 2]
    want_u = torch.tensor([0.25, -0.0, 0.0, -0.0])
    want_v = torch.tensor([-0.0, 0.25, 0.0, 0.125])
    assert torch.equal(got.u.view(torch.int32), want_u.view(torch.int32))
    assert torch.equal(got.v.view(torch.int32), want_v.view(torch.int32))


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _rel_rmse(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)), 1e-12))


@functools.lru_cache(maxsize=None)
def _jax_film(key: str, width: int, height: int, max_depth: int, spp: int,
              env: bool, frames: int):
    """The JAX package's film ("auto": the brute force on the CPU)."""
    from hala_tpu.envmap import EnvMap as JEnv
    from hala_tpu.models import integrator as jint
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp

    dev = JUp.upload(_host("hala_tpu", key), use_ray_tracing=False)
    s = jint.RenderSettings(width=width, height=height, max_depth=max_depth, rr_depth=2,
                            tile_size=width * height * spp, spp=spp,
                            env_type=jint.ENV_MAP if env else jint.ENV_SKY)
    jenv = JEnv.from_array(_env_rgb()) if env else None
    film = jint.Film.create(width, height)
    for f in range(frames):
        film, _ = jint.render_frame(dev, jenv, jint.Uniforms.default(), film, f, s)
    return {k: np.asarray(getattr(film, k)) for k in ("accum", "albedo", "normal")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_device_film_matches_jax(name):
    """The port's film (which the tiled and sharded films equal bit for
    bit) against the JAX package's at the same scene, size, depth, spp,
    env map and frames."""
    key, kw, frames, env = CASES[name]
    ref = _jax_film(key, kw["width"], kw["height"], kw["max_depth"], kw.get("spp", 1),
                    env, frames)
    got = _one_device(name)
    for k in ("accum", "albedo", "normal"):
        assert _rel_rmse(got[k].numpy(), ref[k]) < REL_RMSE_TOL, k


# ---------------------------------------------------------------------------
# tables and the merge
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_scene(key: str):
    from hala_tpu.scene.loader.uploader import SceneUploader as JUp

    return JUp.upload(_host("hala_tpu", key), use_ray_tracing=False)


@pytest.mark.parametrize("key,n", [("cornell", 8), ("sponza3", 4), ("sponza3", 8)])
def test_padded_tables_match_jax(key, n):
    """Both packages pad the same tables alike on every sharded field,
    except row 9 of the padding clusters' slot blocks: the port fills it
    by the uploader's rule (far-point span boxes), the JAX package with
    zeros."""
    from hala_tpu.parallel.scene_shard import pad_scene_for_sharding as jpad

    jdev = _jax_scene(key)
    jg = jpad(jdev, n).geometry
    dev = from_numpy(jdev, "cpu")
    g = pad_scene_for_sharding(dev, n).geometry
    c = dev.geometry.tri_packed.shape[0]
    assert g.tri_packed.shape[0] % n == 0 and g.tri_packed.shape[0] > c
    for name in _SHARDED_FIELDS:
        got, ref = getattr(g, name).numpy(), np.asarray(getattr(jg, name))
        if name == "tri_packed":
            np.testing.assert_array_equal(got[:c], ref[:c])
            np.testing.assert_array_equal(got[c:, :9], ref[c:, :9])
            np.testing.assert_array_equal(got[c:, 10:], ref[c:, 10:])
            got, ref = got[c:, 9], ref[c:, 9]
            assert (ref == 0).all()
            rule = pack_slots(*(torch.zeros((got.shape[0] * TRI_PAD, 3)),) * 3,
                              torch.zeros(got.shape[0] * TRI_PAD, dtype=torch.bool))
            np.testing.assert_array_equal(got, rule[:, 9].numpy())
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    for f in dataclasses.fields(g):
        if f.name not in _SHARDED_FIELDS and isinstance(getattr(g, f.name), torch.Tensor):
            assert getattr(g, f.name) is getattr(dev.geometry, f.name), f.name
    assert g.num_triangles == dev.geometry.num_triangles


@pytest.mark.parametrize("n", (2, 4, 8))
def test_shard_tables_follow_the_uploader_rule(n):
    """Each shard holds new contiguous copies of its block; its cluster
    boxes and slot blocks (row 9 included) are `cluster_boxes` and
    `pack_slots` over its own slots; the other tables are replicated and
    num_triangles stays global."""
    dev = _port_scene("sponza3")
    padded = pad_scene_for_sharding(dev, n).geometry
    k = padded.tri_packed.shape[0] // n
    assert scene_shard_specs(dev) == _SHARDED_FIELDS
    for rank in range(n):
        g = shard_scene(dev, Mesh(None, rank, n, torch.device("cpu"))).geometry
        assert g is not dev.geometry and g.num_triangles == dev.geometry.num_triangles
        assert g.tri_packed.shape[0] == k and g.tri_v0.shape[0] == k * TRI_PAD
        for name in _SHARDED_FIELDS:
            t, full = getattr(g, name), getattr(padded, name)
            rows = t.shape[0]
            assert t.is_contiguous() and t.data_ptr() != full.data_ptr()
            assert torch.equal(t, full[rank * rows:(rank + 1) * rows]), name
        real = g.tri_mat >= 0
        cmin, cmax = cluster_boxes(g.tri_v0, g.tri_e1, g.tri_e2, real)
        assert torch.equal(g.cluster_min, cmin) and torch.equal(g.cluster_max, cmax)
        assert torch.equal(g.tri_packed, pack_slots(g.tri_v0, g.tri_e1, g.tri_e2, real))
        assert g.normals is dev.geometry.normals


def test_one_rank_mesh_is_the_identity():
    """Without a process group `make_mesh` gives one rank whose
    collectives return their input, and both modes give the one-device
    film."""
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    for f in (mesh.all_gather, mesh.all_min, mesh.all_sum, mesh.sum_scatter):
        assert f(x) is x
    ref = _one_device("cornell")
    for mode in MODES:
        got = _render_ranked(mesh, _job("cornell"), mode)
        assert torch.equal(got["accum"], ref["accum"]) and got["rays"] == ref["rays"]


def test_film_height_must_divide_the_mesh():
    with pytest.raises(ValueError, match="must divide"):
        TiledFilm.create(Mesh(None, 0, 3, torch.device("cpu")), 8, 8)


def _mixed_rays(dev, n: int, seed: int):
    """Rays from random points inside the scene box toward random
    directions, and rays from the camera."""
    g = torch.Generator().manual_seed(seed)
    real = dev.geometry.tri_mat >= 0
    v0 = dev.geometry.tri_v0[real]
    lo, hi = v0.amin(0), v0.amax(0)
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    return o.contiguous(), d.contiguous()


def test_merge_shard_hits_matches_jax_shard_map():
    """merge_shard_hits over 8 in-process shards of sponza_like (K2's
    plain version on each) against the JAX package's sharded `_intersect`
    under shard_map on the 8-device CPU mesh (K2 in interpret mode): the
    tri ids agree on every ray whose hit is not a graze (barycentrics
    within 1e-4 of an edge), and the merge equals the port's unsharded
    query bit for bit."""
    import functools as ft

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from hala_tpu.models import integrator as jint
    from hala_tpu.parallel.scene_shard import shard_scene as jshard
    from hala_tpu.parallel.tiling import AXIS, make_mesh as jmesh

    n_shards, n = 8, 1024
    jdev = _jax_scene("sponza3")
    dev = from_numpy(jdev, "cpu")
    o, d = _mixed_rays(dev, n, 7)

    js = jint.RenderSettings(width=8, height=8, intersector="matrix",
                             interpret_pallas=True, scene_axis=AXIS)
    jm = jmesh()
    sharded, specs = jshard(jdev, jm)

    @ft.partial(shard_map, mesh=jm, in_specs=(specs, P(AXIS), P(AXIS)),
                out_specs=P(AXIS), check_vma=False)
    def query(scene, o_, d_):
        return jint._intersect(scene, o_, d_, js)

    jhit = query(sharded, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    jtri, ju, jv = (np.asarray(x) for x in (jhit.tri, jhit.u, jhit.v))

    s = RenderSettings(width=8, height=8, intersector="matrix")
    shards = [shard_scene(dev, Mesh(None, r, n_shards, torch.device("cpu")))
              for r in range(n_shards)]
    slots = shards[0].geometry.tri_v0.shape[0]
    hit = merge_shard_hits([_intersect_local(sh, o, d, resolve(s, sh)) for sh in shards],
                           [r * slots for r in range(n_shards)])
    assert int((hit.tri >= 0).sum()) > n // 4
    graze = (jtri >= 0) & (np.minimum(np.minimum(ju, jv), 1.0 - ju - jv) < 1e-4)
    np.testing.assert_array_equal(hit.tri.numpy()[~graze], jtri[~graze])
    assert graze.sum() < n // 100
    whole = _intersect_local(dev, o, d, resolve(s, dev))
    for a, b in zip(hit, whole):
        assert torch.equal(a, b)
