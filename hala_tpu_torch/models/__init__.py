"""Renderers (parity: reference src/renderer.rs, rt_renderer.rs,
rz_renderer.rs)."""

from .renderer import BaseRenderer, RendererInfo, RendererStatistics
from .rt_renderer import RayTracingRenderer, EnvType
from .rz_renderer import RasterizationRenderer

__all__ = [
    "BaseRenderer", "RendererInfo", "RendererStatistics",
    "RayTracingRenderer", "EnvType", "RasterizationRenderer",
]
