"""Renderer scaffolding: info, statistics, frame-loop base class.

Parity: reference src/renderer.rs, as in the JAX package's
`models/renderer.py`:

* `RendererInfo` — name/width/height (renderer.rs:11-33);
* `RendererStatistics` — frame counter + GPU/CPU time accumulators with a
  once-per-second FPS log line (renderer.rs:134-207);
* `BaseRenderer` — the HalaRendererTrait analog (renderer.rs:210-324):
  update() dispatches a frame on the device, render() waits for it and
  feeds the statistics, and a CUDA error there marks the device lost
  (check_and_restore_device() re-creates the device state);
* the animation API `set_node_transform` / `update_scene` (ops/animate.py),
  inherited by both renderers.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..error import HalaRendererError
from ..utils import profiling

logger = logging.getLogger("hala_tpu_torch.renderer")


@dataclasses.dataclass
class RendererInfo:
    """renderer.rs:11-33."""

    name: str
    width: int
    height: int


class RendererStatistics:
    """renderer.rs:134-207: totals + 1 Hz FPS log."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total_frames = 0
        self.total_gpu_frame_time = 0.0  # seconds
        self.total_cpu_frame_time = 0.0
        self._last_log_time = time.monotonic()
        self._frames_since_log = 0
        self._gpu_since_log = 0.0
        self._cpu_since_log = 0.0
        self._rays_since_log = 0.0
        self.last_metrics: dict = {}

    def record_frame(
        self, gpu_time: float, cpu_time: float, rays: float = 0.0
    ) -> None:
        self.total_frames += 1
        self.total_gpu_frame_time += gpu_time
        self.total_cpu_frame_time += cpu_time
        self._frames_since_log += 1
        self._gpu_since_log += gpu_time
        self._cpu_since_log += cpu_time
        self._rays_since_log += rays
        now = time.monotonic()
        if now - self._last_log_time >= 1.0:
            dt = now - self._last_log_time
            fps = self._frames_since_log / dt
            gpu_ms = 1000.0 * self._gpu_since_log / self._frames_since_log
            cpu_ms = 1000.0 * self._cpu_since_log / self._frames_since_log
            mrays = self._rays_since_log / dt / 1e6
            self.last_metrics = {
                "fps": fps, "gpu_ms": gpu_ms, "cpu_ms": cpu_ms,
                "mrays_per_s": mrays, "total_frames": self.total_frames,
            }
            logger.info(
                "FPS: %.2f, GPU Time: %.3fms, CPU Time: %.3fms, "
                "Rays: %.2f Mrays/s, Total Frames: %d",
                fps, gpu_ms, cpu_ms, mrays, self.total_frames,
            )
            self._rays_since_log = 0.0
            self._last_log_time = now
            self._frames_since_log = 0
            self._gpu_since_log = 0.0
            self._cpu_since_log = 0.0


class BaseRenderer:
    """Frame-loop skeleton (HalaRendererTrait, renderer.rs:210-324)."""

    def __init__(self, name: str, width: int, height: int, device):
        self.info = RendererInfo(name, width, height)
        self.statistics = RendererStatistics()
        self.device = device
        self.is_device_lost = False  # HalaRendererData parity (renderer.rs:119)
        self._pending = False  # a dispatched frame not yet waited for
        self._pending_frame = -1  # its frame index, for the wait's span
        self._last_cpu_time = 0.0
        self._last_rays = None  # 0-d device tensor of the last frame
        # the animation path: staged node -> new world 4x4, and the world
        # each moved node's device geometry is baked at
        self._staged_transforms: dict[int, np.ndarray] = {}
        self._node_world: dict[int, np.ndarray] = {}

    # -- animation / per-frame transforms --------------------------------
    # (the reference's per-mesh object uniforms rewritten every frame,
    # rz_renderer.rs:38-53, 690-716, plus the BLAS refit)

    def set_node_transform(self, node_index: int, world) -> None:
        """Stage a new WORLD transform (4x4) for a mesh node; the next
        update_scene() applies it on the device."""
        self._staged_transforms[int(node_index)] = np.asarray(
            world, np.float32).reshape(4, 4)

    def update_scene(self) -> None:
        """Apply the staged node transforms on the device: each moved
        node's triangles get the delta new_world @ inv(current world),
        their shading columns are re-derived, and the cluster boxes and
        slot blocks are rebuilt by the uploader's rule
        (ops/animate.py `retransform_geometry`). The current world is
        the one the last update gave the node, else the host node's.
        The moved scene keeps no BVH (the JAX package drops it too), so
        "bvh" renders it through the brute force. Nothing staged: nothing
        happens."""
        if not self._staged_transforms:
            return
        from ..ops.animate import build_deltas, retransform_geometry

        scene = getattr(self, "scene", None)
        host = getattr(self, "_host_scene", None)
        if scene is None or host is None:
            raise HalaRendererError("update_scene() before set_scene().")
        node_deltas = {}
        for ni, new_w in self._staged_transforms.items():
            cur = self._node_world.get(ni)
            if cur is None:
                cur = np.asarray(host.nodes[ni].world_transform, np.float32)
            node_deltas[ni] = new_w @ np.linalg.inv(cur)
            self._node_world[ni] = new_w
        deltas, ndeltas = build_deltas(scene.prim_node, node_deltas,
                                       len(host.nodes), self.device)
        geom = retransform_geometry(scene.geometry, deltas, ndeltas)
        self.scene = dataclasses.replace(scene, geometry=geom, bvh=None)
        self._staged_transforms.clear()

    def _upload_moved(self) -> None:
        """Upload the host scene again (set_scene) and re-apply the node
        moves recorded in _node_world, which the host scene does not
        hold: the device-lost restore of both renderers. Staged moves
        stay staged."""
        moved = dict(self._node_world)
        self.set_scene(self._host_scene)
        staged, self._staged_transforms = self._staged_transforms, moved
        try:
            self.update_scene()
        finally:
            self._staged_transforms = staged

    # -- trait surface ---------------------------------------------------

    def commit(self) -> None:
        """Freeze the frame configuration (pipeline build role)."""
        raise NotImplementedError

    def update(self, delta_time: float = 0.0) -> None:
        """Record + dispatch one frame."""
        raise NotImplementedError

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(self) -> None:
        """Submit/present analog: wait for the dispatched frame and feed
        statistics (renderer.rs:285-322 incl. the device-lost catch)."""
        if self.is_device_lost:
            return
        try:
            t0 = time.monotonic()
            with profiling.span("hala.wait", frame=self._pending_frame):
                if self._pending:
                    self._sync()
                    self._pending = False
                gpu_time = time.monotonic() - t0
                rays = 0.0 if self._last_rays is None else float(self._last_rays)
            self.statistics.record_frame(gpu_time, self._last_cpu_time, rays)
        # the CUDA runtime's errors (a lost device, an illegal access)
        except torch.AcceleratorError as err:  # device lost analog
            logger.warning("Device error during render: %s", err)
            self.is_device_lost = True

    def wait_idle(self) -> None:
        """renderer.rs:251-256."""
        if self._pending:
            self._sync()
            self._pending = False

    def check_and_restore_device(self) -> bool:
        """renderer.rs:234-247 / rt_renderer.rs:508-563 analog: re-create
        device state after a device error. Returns True if a restore
        happened."""
        if not self.is_device_lost:
            return False
        logger.warning("Restoring device state.")
        self._restore_device_state()
        self.statistics.reset()
        self.is_device_lost = False
        return True

    def _restore_device_state(self) -> None:
        """Subclass hook: re-create device-resident images/buffers."""
