"""Host scene graph container.

Parity: reference src/scene/cpu/scene.rs:17-114 (cpu::HalaScene):
nodes, meshes, materials, texture->image and image->data maps, decoded
image data, lights, cameras; `load()` dispatches on extension and then
runs a single-pass parent-before-child world-transform propagation
(update_node_hierarchies, scene.rs:99-114 — valid because the loader
emits nodes in BFS order). Capability probes (scene.rs:59-95) let apps
pick shader permutations; here they gate integrator features.
"""

from __future__ import annotations

import dataclasses

from ...error import HalaRendererError
from ...utils import profiling
from .node import Node
from .mesh import Mesh
from .material import Material, MediumType
from .light import Light
from .camera import Camera
from .image_data import ImageData


@dataclasses.dataclass
class Scene:
    nodes: list[Node] = dataclasses.field(default_factory=list)
    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(default_factory=list)
    texture2image_mapping: dict[int, int] = dataclasses.field(default_factory=dict)
    image2data_mapping: dict[int, int] = dataclasses.field(default_factory=dict)
    image_data: list[ImageData] = dataclasses.field(default_factory=list)
    lights: list[Light] = dataclasses.field(default_factory=list)
    cameras: list[Camera] = dataclasses.field(default_factory=list)
    # Procedural (non-triangle) primitives, registered by apps in code
    # (the reference's AABB-geometry path, gpu_uploader.rs:818-840 —
    # glTF itself has no procedural shapes). See cpu/prims.py.
    procedurals: list = dataclasses.field(default_factory=list)

    @staticmethod
    def load(path: str) -> "Scene":
        """Extension dispatch (scene.rs:40-56; only .gltf/.glb supported)."""
        lower = path.lower()
        if lower.endswith(".gltf") or lower.endswith(".glb"):
            from ..loader.gltf_loader import GltfLoader

            with profiling.span("hala.load"):
                scene = GltfLoader.load(path)
        else:
            raise HalaRendererError(f"Unsupported scene file format: {path}")
        scene.update_node_hierarchies()
        return scene

    def update_node_hierarchies(self) -> None:
        """World transforms in one pass; loader emits BFS order so every
        parent precedes its children (scene.rs:99-114)."""
        for node in self.nodes:
            if node.parent is None:
                node.world_transform = node.local_transform.copy()
            else:
                node.world_transform = (
                    self.nodes[node.parent].world_transform @ node.local_transform
                )

    # --- capability probes (scene.rs:59-95) ---

    def has_light(self) -> bool:
        return len(self.lights) > 0

    def has_medium(self) -> bool:
        return any(m.medium.type != MediumType.NONE for m in self.materials)

    def has_medium_with(self, medium_type: MediumType) -> bool:
        return any(m.medium.type == medium_type for m in self.materials)

    def has_transparent(self) -> bool:
        return any(
            m.opacity < 1.0 or m.specular_transmission > 0.0 for m in self.materials
        )
