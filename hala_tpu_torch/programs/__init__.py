"""Program facade: data-driven pipeline construction.

Parity: reference src/{compute,graphics}_program.rs and
src/shader_cache.rs (SURVEY.md section 2.10). Apps describe pipelines
with serde-JSON descs; here "shaders" are Python callables on tensors
registered in a process-wide KernelCache, and the descs keep the same
JSON shape so app-side configs translate directly. The ray-tracing
program is not ported yet.
"""

from .shader_cache import KernelCache
from .compute_program import ComputeProgram, ComputeProgramDesc
from .graphics_program import BlendState, GraphicsProgram, GraphicsProgramDesc

__all__ = [
    "KernelCache",
    "ComputeProgram", "ComputeProgramDesc",
    "BlendState", "GraphicsProgram", "GraphicsProgramDesc",
]
