"""hala_tpu_torch — the path tracer and the rasterizer of `hala_tpu`,
ported to PyTorch and hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

The JAX package `hala_tpu` beside it is the reference this package is
held against: same module paths and public names, same tables, the same
PCG4D random streams. This package imports torch and never jax.

Every renderer and upload takes `device=` ("cuda" by default). A host
without CUDA raises instead of running on the CPU; pass device="cpu"
to run there, where each kernel's wrapper runs its plain PyTorch
version. Float32 throughout, with TF32 disabled below.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .error import HalaRendererError  # noqa: E402
from .scene.bounds import Bounds  # noqa: E402
from .scene.meshlet import Meshlet, MESHLET_MAX_VERTICES, MESHLET_MAX_PRIMITIVES  # noqa: E402
from .scene.cpu.scene import Scene  # noqa: E402
from .scene.cpu.node import Node  # noqa: E402
from .scene.cpu.mesh import Mesh, Primitive  # noqa: E402
from .scene.cpu.material import Material, Medium, MaterialType, MediumType  # noqa: E402
from .scene.cpu.light import Light, LightType  # noqa: E402
from .scene.cpu.camera import Camera, PerspectiveCamera, OrthographicCamera  # noqa: E402
from .scene.cpu.prims import ProceduralSphere  # noqa: E402
from .scene.cpu.image_data import ImageData, ImageFormat  # noqa: E402
from .scene.loader.gltf_loader import GltfLoader  # noqa: E402
from .scene.loader.uploader import SceneUploader  # noqa: E402
from .scene.gpu.scene import DeviceScene, from_numpy  # noqa: E402
from .envmap import EnvMap  # noqa: E402
from .models.renderer import RendererInfo, RendererStatistics, BaseRenderer  # noqa: E402
from .models.rt_renderer import RayTracingRenderer, EnvType  # noqa: E402
from .models.rz_renderer import RasterizationRenderer  # noqa: E402
from .programs import (  # noqa: E402
    KernelCache,
    ComputeProgram, ComputeProgramDesc,
    RayTracingProgram, RayTracingProgramDesc,
    GraphicsProgram, GraphicsProgramDesc,
)

__version__ = "0.1.0"

__all__ = [
    "ProceduralSphere",
    "HalaRendererError",
    "Bounds", "Meshlet", "MESHLET_MAX_VERTICES", "MESHLET_MAX_PRIMITIVES",
    "Scene", "Node", "Mesh", "Primitive",
    "Material", "Medium", "MaterialType", "MediumType",
    "Light", "LightType",
    "Camera", "PerspectiveCamera", "OrthographicCamera",
    "ImageData", "ImageFormat",
    "GltfLoader", "SceneUploader", "DeviceScene", "from_numpy", "EnvMap",
    "RendererInfo", "RendererStatistics", "BaseRenderer",
    "RayTracingRenderer", "EnvType", "RasterizationRenderer",
    "KernelCache",
    "ComputeProgram", "ComputeProgramDesc",
    "RayTracingProgram", "RayTracingProgramDesc",
    "GraphicsProgram", "GraphicsProgramDesc",
]
