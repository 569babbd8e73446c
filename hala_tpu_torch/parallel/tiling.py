"""Film tiling across ranks (image-space data parallelism).

The JAX package shards the film by row blocks over a 1-D device mesh
under `shard_map`. Here the mesh is a `torch.distributed` process group
with one rank per device: each rank renders its own band of rows with
the scene replicated, so the render loop needs no communication. The
collectives appear only for the ray statistic (one all-reduce) and when
the film is gathered. Every pixel's samples are keyed on its global
pixel id, so the gathered film is the one-device film bit for bit.

`Mesh` also carries the collectives the geometry-sharded integrator
runs (parallel/scene_shard.py): an all-gather along dim 0, all-reduce
MIN and SUM, and a SUM reduce-scatter along dim 0. They pick their path
by the group's backend: on NCCL the tensors go straight in; on gloo,
CUDA tensors are staged through the host (the compute stays on the
card), and the reduce-scatter is an all-reduce followed by this rank's
slice. Without an initialised process group `make_mesh` gives a
one-rank mesh whose collectives are the identity.

Ranks: on a multi-GPU host, `torchrun --nproc-per-node=N` with NCCL and
`cuda:{LOCAL_RANK}`; on the CPU, gloo with device="cpu"; two gloo
ranks can share one card (every rank on cuda:0) to check the sharded
paths where only one GPU exists.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch
import torch.distributed as dist

from ..models.integrator import Film, RenderSettings, Uniforms, render_frame
from ..scene.gpu.scene import resolve_device

AXIS = "tiles"


@dataclasses.dataclass
class CommStats:
    """Counts of the collectives this process ran. `nbytes` adds, per
    collective, the size of the full-batch tensor on this rank (an
    all-gather's output, a reduction's input). With `enabled` on, each
    collective first waits for the card and `seconds` adds its wall
    time, staging included."""

    enabled: bool = False
    calls: int = 0
    nbytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.nbytes, self.seconds = 0, 0, 0.0


comm_stats = CommStats()


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of `size` ranks over the process group `group` (None
    for the one-rank mesh); this process is `rank` and renders on
    `device`."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    def _run(self, x: torch.Tensor, nbytes: int, op):
        comm_stats.calls += 1
        comm_stats.nbytes += nbytes
        if not comm_stats.enabled:
            return op()
        _sync(x)
        t0 = time.perf_counter()
        out = op()
        _sync(out)
        comm_stats.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' `x` (equal shapes) concatenated along dim 0, in rank
        order, on every rank."""
        if self.size == 1:
            return x
        x = x.contiguous()

        def op():
            if self.backend == "nccl":
                out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
                dist.all_gather_into_tensor(out, x, group=self.group)
                return out
            xh = x.cpu()
            parts = [torch.empty_like(xh) for _ in range(self.size)]
            dist.all_gather(parts, xh, group=self.group)
            return torch.cat(parts).to(x.device)

        return self._run(x, x.nbytes * self.size, op)

    def _all_reduce(self, x: torch.Tensor, red, keep=slice(None)) -> torch.Tensor:
        def op():
            if self.backend == "nccl":
                y = x.clone()
                dist.all_reduce(y, red, group=self.group)
                return y[keep]
            xh = x.to("cpu", copy=True)
            dist.all_reduce(xh, red, group=self.group)
            return xh[keep].to(x.device)

        return self._run(x, x.nbytes, op)

    def all_min(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the ranks."""
        if self.size == 1:
            return x
        return self._all_reduce(x.contiguous(), dist.ReduceOp.MIN)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks."""
        if self.size == 1:
            return x
        return self._all_reduce(x.contiguous(), dist.ReduceOp.SUM)

    def sum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x` (dim 0 a multiple of the size),
        this rank's block of rows of it."""
        if self.size == 1:
            return x
        x = x.contiguous()
        n = x.shape[0] // self.size
        if self.backend == "nccl":
            def op():
                out = x.new_empty((n, *x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                           group=self.group)
                return out

            return self._run(x, x.nbytes, op)
        return self._all_reduce(x, dist.ReduceOp.SUM,
                                slice(self.rank * n, (self.rank + 1) * n))


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of the ranks of `group` (the default group), this rank
    on `device`: by default "cuda" on a one-rank mesh and
    cuda:{LOCAL_RANK} (0 without torchrun) on a process group. Without
    an initialised process group the mesh has one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, resolve_device("cuda" if device is None else device))
    group = dist.group.WORLD if group is None else group
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev, backend = resolve_device(device), str(dist.get_backend(group))
    if backend == "nccl":
        torch.cuda.set_device(dev)  # NCCL's communicator lives on the current device
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev, backend)


@dataclasses.dataclass
class TiledFilm:
    """This rank's band of a film sharded by rows over the mesh."""

    film: Film
    mesh: Mesh
    full_height: int
    width: int

    @staticmethod
    def create(mesh: Mesh, width: int, height: int) -> "TiledFilm":
        if height % mesh.size:
            raise ValueError(f"film height {height} must divide the mesh size {mesh.size}")
        return TiledFilm(
            film=Film.create(width, height // mesh.size, mesh.device),
            mesh=mesh, full_height=height, width=width,
        )

    def gather(self) -> Film:
        """The whole film on every rank (a collective: every rank calls it)."""
        f = self.film
        return Film(*(self.mesh.all_gather(x) for x in (f.accum, f.albedo, f.normal)))


def _sharded_frame(scene, env, uniforms: Uniforms, tiled: TiledFilm, frame_index,
                   settings: RenderSettings, scene_axis: Mesh | None = None):
    """One frame of this rank's band: `render_frame` at the band's global
    row offset and the full height, with `scene_axis` set for the
    geometry-sharded merge. Returns (tiled, total rays over the ranks)."""
    mesh = tiled.mesh
    band = settings.height // mesh.size
    shard_settings = dataclasses.replace(settings, height=band, scene_axis=scene_axis)
    _, rays = render_frame(scene, env, uniforms, tiled.film, frame_index,
                           shard_settings, row_offset=mesh.rank * band,
                           full_height=settings.height)
    return tiled, mesh.all_sum(rays.reshape(1))[0]


def render_frame_multichip(scene, env, uniforms: Uniforms, tiled: TiledFilm,
                           frame_index, settings: RenderSettings):
    """One progressive frame over the mesh, the scene replicated. Returns
    (TiledFilm, total rays); the band is updated in place.

    `settings.height` is the full film height; each rank renders
    full_height / size rows at its global row offset."""
    return _sharded_frame(scene, env, uniforms, tiled, frame_index, settings)
