"""Config dataclasses and the named sun-sampling strategies (port of
``config.py``).

The settings with the reference's values as defaults: target spp and
branch count, the bounce cap 5, the ray distance 1024, the world's octree
depth, the sun's defaults.  :meth:`Config.to_json` and :meth:`Config.from_json`
write and read the same JSON as the JAX package's ``Config``: the same
sections, field names and defaults, tuples as JSON lists.
"""

from __future__ import annotations

import dataclasses
import json

from .models.sun import SunSampling


@dataclasses.dataclass
class CameraConfig:
    eye: tuple = (0.0, 0.0, 10.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_degrees: float = 70.0
    aperture: float = 0.0
    focal_distance: float = 0.0


@dataclasses.dataclass
class SunConfig:
    azimuth: float = 1.2566370614359172  # pi/2.5
    altitude: float = 1.0471975511965976  # pi/3
    radius: float = 0.03
    luminosity: float = 100.0
    draw_texture: bool = True


@dataclasses.dataclass
class SamplingConfig:
    sun_strategy: str = "importance"  # off|non_luminous|fast|importance|high_quality
    emitter_strategy: str = "none"  # none|one|one_block|all
    emitters_enabled: bool = True
    f_sub_surface: float = 0.3


@dataclasses.dataclass
class RenderConfig:
    width: int = 1280  # the reference's window size
    height: int = 720
    target_spp: int = 64
    branch_count: int = 10
    max_bounces: int = 5
    max_distance: float = 1024.0
    seed: int = 0
    mode: str = "pathtraced"  # pathtraced|preview


@dataclasses.dataclass
class WorldConfig:
    path: str = ""
    depth: int = 9  # a region's build depth; the reference's range is 2..=12
    origin: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ShardingConfig:
    n_devices: int = 0  # 0 = all
    sample_axis: int = 0  # 0 = auto


_SECTIONS = {"render": RenderConfig, "camera": CameraConfig, "sun": SunConfig, "sampling": SamplingConfig,
             "world": WorldConfig, "sharding": ShardingConfig}


@dataclasses.dataclass
class Config:
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    sun: SunConfig = dataclasses.field(default_factory=SunConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    world: WorldConfig = dataclasses.field(default_factory=WorldConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        """A missing section or field keeps its default; JSON lists become
        tuples."""
        raw = json.loads(text)

        def load(cls, d):
            return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

        return Config(**{name: load(cls, raw.get(name, {})) for name, cls in _SECTIONS.items()})


def sun_sampling_from_name(name: str) -> SunSampling:
    return {
        "off": SunSampling.off,
        "non_luminous": SunSampling.non_luminous,
        "fast": SunSampling.fast,
        "importance": SunSampling.importance,
        "high_quality": SunSampling.high_quality,
    }[name]()
