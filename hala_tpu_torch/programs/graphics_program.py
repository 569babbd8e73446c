"""Graphics program: JSON desc -> configured raster pipeline.

Parity: reference src/graphics_program.rs (HalaGraphicsProgram{Desc}):
desc with color/depth formats, VS or task+mesh shader paths + FS,
topology, blend/rasterizer/multisample/depth state, and a full draw-call
family. Here the desc configures RasterSettings for the software
rasterizer — `validate()` rejects state the rasterizer cannot honor with
a clear error, the blend state (graphics_program.rs:62-65) selects the
transparency composite operator (rz_renderer.rs:490 forward pipelines
use SRC_ALPHA/ONE_MINUS_SRC_ALPHA — the "over" operator), and `draw`
runs `models.rz_renderer.raster_frame`.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from ..error import HalaRendererError
from ..models.rz_renderer import RasterSettings, raster_frame

# (src_factor, dst_factor, op) -> composite operator implemented by
# peel_composite_pass. These are the blend states the software
# rasterizer can honor exactly; anything else fails validate() loudly
# instead of silently rendering with a different operator.
_BLEND_TABLE = {
    ("src_alpha", "one_minus_src_alpha", "add"): "over",
    ("one", "one", "add"): "additive",
    ("one", "one_minus_src_alpha", "add"): "premultiplied",
    ("one", "zero", "add"): "none",
}

_TOPOLOGIES = ("triangle_list",)  # the rasterizer consumes triangle soups
_COLOR_FORMATS = ("R32G32B32A32_SFLOAT", "R16G16B16A16_SFLOAT",
                  "R8G8B8A8_UNORM", "B8G8R8A8_UNORM")
_DEPTH_FORMATS = ("D32_SFLOAT", "D24_UNORM_S8_UINT")
_MSAA_COUNTS = (1, 2, 4, 8)


@dataclasses.dataclass
class BlendState:
    """graphics_program.rs color_blend/alpha_blend (HalaBlendState):
    src/dst factors + op, lowercase snake-case in JSON."""

    src_factor: str | None = None
    dst_factor: str | None = None
    op: str | None = None

    def operator(self) -> str:
        if self.src_factor is None and self.dst_factor is None:
            return "over"  # desc default = the reference forward state
        key = (
            (self.src_factor or "").lower(),
            (self.dst_factor or "").lower(),
            (self.op or "add").lower(),
        )
        try:
            return _BLEND_TABLE[key]
        except KeyError:
            raise HalaRendererError(
                f"unsupported blend state {key}: the software rasterizer "
                f"implements {sorted(set(_BLEND_TABLE.values()))} via "
                "depth-peeled compositing "
                f"(supported factor triples: {list(_BLEND_TABLE)})"
            ) from None


@dataclasses.dataclass
class GraphicsProgramDesc:
    """graphics_program.rs:41-73 JSON shape (the subset the software
    rasterizer can honor)."""

    vertex_shader_file_path: str | None = "builtin:vertex_transform"
    task_shader_file_path: str | None = None
    mesh_shader_file_path: str | None = None
    fragment_shader_file_path: str = "builtin:forward_shade"
    primitive_topology: str = "triangle_list"
    multisample_count: int = 1
    deferred: bool = False
    color_format: str = "R32G32B32A32_SFLOAT"
    depth_format: str = "D32_SFLOAT"
    color_blend: BlendState = dataclasses.field(default_factory=BlendState)

    @staticmethod
    def from_json(text: str) -> "GraphicsProgramDesc":
        d = json.loads(text)
        out = GraphicsProgramDesc()
        for f in dataclasses.fields(out):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        if isinstance(out.color_blend, dict):
            out.color_blend = BlendState(**out.color_blend)
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @property
    def uses_mesh_shader(self) -> bool:
        """VS-or-mesh-shader exclusivity (graphics_program.rs constructors)."""
        return self.mesh_shader_file_path is not None

    def validate(self) -> str:
        """Reject desc state the software rasterizer cannot honor; returns
        the resolved blend operator. Clear-error parity with the Vulkan
        pipeline-creation failures the reference would surface."""
        if self.primitive_topology not in _TOPOLOGIES:
            raise HalaRendererError(
                f"primitive_topology {self.primitive_topology!r} is not "
                f"supported (the rasterizer consumes {_TOPOLOGIES})"
            )
        if self.multisample_count not in _MSAA_COUNTS:
            raise HalaRendererError(
                f"multisample_count {self.multisample_count} not in "
                f"{_MSAA_COUNTS}"
            )
        if self.deferred and self.multisample_count > 1:
            # rz_renderer.rs:1590 parity
            raise HalaRendererError(
                "Multisampling is not supported in deferred rendering."
            )
        if self.color_format not in _COLOR_FORMATS:
            raise HalaRendererError(
                f"color_format {self.color_format!r} not in {_COLOR_FORMATS}"
            )
        if self.depth_format not in _DEPTH_FORMATS:
            raise HalaRendererError(
                f"depth_format {self.depth_format!r} not in {_DEPTH_FORMATS}"
            )
        if (
            self.uses_mesh_shader
            and self.vertex_shader_file_path
            not in (None, "builtin:vertex_transform")
        ):
            # the dataclass default VS is fine to leave in place — the
            # mesh path supersedes it; an EXPLICIT custom VS + mesh
            # shader is the contradiction the reference's constructors
            # make unrepresentable (they take one or the other)
            raise HalaRendererError(
                "vertex shader and mesh shader are mutually exclusive "
                "(graphics_program.rs constructors take one or the other)"
            )
        if self.task_shader_file_path and not self.mesh_shader_file_path:
            raise HalaRendererError(
                "a task shader requires a mesh shader"
            )
        if not self.fragment_shader_file_path:
            raise HalaRendererError("fragment_shader_file_path is required")
        blend = self.color_blend
        if isinstance(blend, dict):
            blend = BlendState(**blend)
        return blend.operator()


class GraphicsProgram:
    def __init__(self, desc: GraphicsProgramDesc, scene):
        self.blend = desc.validate()
        self.desc = desc
        self.scene = scene

    def _settings(self, width: int, height: int) -> RasterSettings:
        return RasterSettings(
            width=width,
            height=height,
            deferred=self.desc.deferred,
            msaa=self.desc.multisample_count,
            mesh_shader=self.desc.uses_mesh_shader,
            blend=self.blend,
        )

    def draw(self, width: int, height: int, camera_index: int = 0):
        """graphics_program.rs draw family: rasterize one frame."""
        return raster_frame(
            self.scene, int(camera_index), self._settings(width, height),
        )

    def draw_indirect(
        self, prim_count, width: int, height: int, camera_index: int = 0
    ):
        """Indirect draw family (graphics_program.rs:469-643:
        draw[_indexed]_indirect[_count] read a VkDrawIndirectCommand
        from a DEVICE buffer). Here `prim_count` is an i32 scalar or
        0-d tensor, used on the device with no host read: shapes stay
        fixed and the count masks primitive validity. The `_count`
        variants collapse to the same mechanism: pass `counts[i]`
        (still a device value)."""
        dev = self.scene.geometry.tri_v0.device
        return raster_frame(
            self.scene, int(camera_index), self._settings(width, height),
            prim_count=torch.as_tensor(prim_count, dtype=torch.int32,
                                       device=dev),
        )
