"""Device-side scene representation (parity: reference src/scene/gpu/):
structure-of-arrays tensors in dataclasses with an explicit device."""

from .scene import (
    DeviceScene,
    DeviceGeometry,
    DeviceMaterials,
    DeviceLights,
    DeviceCameras,
    DeviceMeshlets,
    DeviceProcedural,
    TextureStack,
    from_numpy,
)

__all__ = [
    "DeviceScene", "DeviceGeometry", "DeviceMaterials", "DeviceLights",
    "DeviceCameras", "DeviceMeshlets", "DeviceProcedural", "TextureStack",
    "from_numpy",
]
