"""Render configuration: dataclass + JSON round trip.

Counterpart of the JAX package's utils/config.py, with the same fields
and JSON keys, so a file written for either package loads in the other.
The reference's three configuration channels are constructor params,
program descs and glTF extras; this is the first as a declarative
config, so applications and CLIs can drive the renderer from JSON.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class RenderConfig:
    name: str = "hala"
    width: int = 512
    height: int = 512
    # rt constructor params (rt_renderer.rs:650-660)
    max_depth: int = 4
    rr_depth: int = 2
    enable_tonemap: bool = True
    enable_aces: bool = False
    use_simple_aces: bool = False
    max_frames: int = 0
    # environment knobs (rt_renderer.rs:1184-1219)
    env_type: str = "sky"            # "sky" | "map"
    envmap_path: str | None = None
    env_rotation: float = 0.0
    env_intensity: float = 1.0
    ground_color: tuple[float, float, float] = (0.5, 0.5, 0.5)
    sky_color: tuple[float, float, float] = (0.5, 0.7, 0.9)
    exposure_value: float = 1.0
    # scene + output
    scene_path: str | None = None
    camera_index: int = 0
    output_path: str = "./out/render.png"
    # tracer knobs. tile_size is the port renderer's default: the film
    # does not depend on it (RNG streams are keyed on the global pixel).
    tile_size: int = 1 << 20
    use_bvh: bool = True
    intersector: str = "auto"
    shadow_intersector: str = "auto"
    spp: int = 1
    staged: bool = False

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        """Parse a JSON object; unknown keys are ignored, lists become
        tuples."""
        d = json.loads(text)
        out = RenderConfig()
        known = {f.name for f in dataclasses.fields(out)}
        for k, v in d.items():
            if k in known:
                setattr(out, k, tuple(v) if isinstance(v, list) else v)
        return out

    @staticmethod
    def load(path: str) -> "RenderConfig":
        with open(path) as f:
            return RenderConfig.from_json(f.read())

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def build_renderer(self, device="cuda"):
        """The port's RayTracingRenderer for this config on `device`, with
        the scene and the environment map loaded when paths are given."""
        from ..models.rt_renderer import RayTracingRenderer
        from ..scene.cpu.scene import Scene

        r = RayTracingRenderer(
            self.name, self.width, self.height,
            max_depth=self.max_depth, rr_depth=self.rr_depth,
            enable_tonemap=self.enable_tonemap,
            enable_aces=self.enable_aces,
            use_simple_aces=self.use_simple_aces,
            max_frames=self.max_frames,
            tile_size=self.tile_size, use_bvh=self.use_bvh,
            intersector=self.intersector,
            shadow_intersector=self.shadow_intersector,
            spp=self.spp, staged=self.staged,
            device=device,
        )
        r.set_ground_color(list(self.ground_color))
        r.set_sky_color(list(self.sky_color))
        r.set_env_intensity(self.env_intensity)
        r.set_exposure_value(self.exposure_value)
        r.set_camera_index(self.camera_index)
        if self.scene_path:
            r.set_scene(Scene.load(self.scene_path))
        if self.env_type == "map" and self.envmap_path:
            r.set_envmap(self.envmap_path, rotation=self.env_rotation)
        return r
