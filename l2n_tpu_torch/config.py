"""Render configuration (the port's copy of l2n_tpu.config).

The same JSON-serialisable dataclass as the JAX package's: the same fields
and defaults, properties, `validate()` messages and JSON round-trip, so a
config written by either package (the goldens store theirs as JSON) loads
in the other with `from_json(cfg.to_json())`. The port keeps its own copy
because it imports nothing of the JAX package. The port renders every
field; `ops/kernels/common.check_supported` validates a config before a
step is built.

The reference hard-codes every knob (window 1280x720, fovy 45 degrees, 32
pixel tiles, 128 spheres in a world of size 1024, a path-length cap and a
Russian-roulette ceiling of 0.9); here each is a field.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

# Reference defaults (src/main.cpp + kernels).
DEFAULT_WIDTH = 1280   # src/main.cpp:120
DEFAULT_HEIGHT = 720   # src/main.cpp:121
DEFAULT_FOVY_DEG = 45.0  # src/main.cpp:827
DEFAULT_SPHERE_COUNT = 128  # src/main.cpp:656
DEFAULT_WORLD_SIZE = 1024.0  # src/main.cpp:657


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render; every field is a Python scalar,
    so a config is hashable and keys per-config caches."""

    # Image / projection. ndc_width/ndc_height: NDC denominators when the
    # config describes a slab of a larger framebuffer (0 = width/height).
    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    ndc_width: int = 0
    ndc_height: int = 0
    fovy_deg: float = DEFAULT_FOVY_DEG
    near: float = 0.01
    far: float = 100.0

    # Tile scheduler: (32, 128) tiles; tiles_per_step 0 = one row of tiles,
    # the reference's tileCountPerIteration; a fixed-seed shuffle.
    tile_height: int = 32
    tile_width: int = 128
    tiles_per_step: int = 0
    tile_shuffle_seed: int = 0
    spp_per_step: int = 1

    # Path tracing: at most max_bounces diffuse bounces (the reference's
    # pathLength <= 1 is 2 segments), Russian roulette survival
    # min(rr_ceiling, luminance), sphere i emissive when i % emissive_every
    # == 0, emission scale / (4 pi r^2).
    max_bounces: int = 2
    rr_ceiling: float = 0.9
    emissive_every: int = 16
    emission_scale: float = 8192.0
    ray_epsilon: float = 0.01
    env_mode: str = "mandelbrot"  # "mandelbrot" | "sun" | "none"
    env_scale: float = 3.0
    # Next event estimation and multiple importance sampling.
    nee: bool = False
    mis: bool = False

    # Scene.
    scene_kind: str = "sphere"    # "sphere" | "triangle"
    sphere_count: int = DEFAULT_SPHERE_COUNT
    world_size: float = DEFAULT_WORLD_SIZE
    scene_seed: int = 0
    disc_lat: int = 16
    disc_long: int = 8
    obj_path: str = ""            # OBJ scene of the triangle renderer

    # Shading: "procedural" (hashed-albedo Lambert) | "microfacet" |
    # "disney"; procedural bump mapping of strength normal_map.
    material_mode: str = "procedural"
    normal_map: float = 0.0
    normal_map_freq: float = 0.35

    # Homogeneous fog (collision sampling); 0 density = off.
    fog_density: float = 0.0
    fog_albedo: float = 0.9
    fog_sky_distance: float = 0.0

    # Ray generation: "fovy" (the GPU kernel's form) | "viewproj".
    ray_gen: str = "fovy"

    # RNG: "threefry" (counter-based, the default) | "tinymt" | "tauslcg"
    # (stateful per-pixel streams) | "tpu_hw" (the TPU core's hardware
    # generator in the JAX package; Philox4x32-10 on the card, rng/philox.py).
    rng: str = "threefry"
    seed: int = 0

    # Kernel options. wavefront: split the sphere path-tracing step into
    # pass A (primary + first scatter), compaction of the survivors, pass B
    # (bounce continuation over the dense survivors) and pass C (accumulate
    # + tonemap); the same image under threefry. Ignored by triangle scenes
    # and non-pathtracing AOVs.
    skip_empty_tiles: bool = True
    wavefront: bool = False
    spp_stack: int = 1
    fast_math: bool = False

    # Debug / AOV: "pathtracing" | "normal" | "ambient_occlusion" | "hit" |
    # "tex_coords" | "param_uv".
    aov: str = "pathtracing"

    # Display: pow(rgb / n, gamma).
    gamma: float = 0.45

    # ------------------------------------------------------------------------
    @property
    def rng_stateful(self) -> bool:
        """True when the sampler carries per-pixel state planes."""
        return self.rng in ("tinymt", "tauslcg")

    @property
    def tan_half_fovy(self) -> float:
        return math.tan(0.5 * math.radians(self.fovy_deg))

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def padded_width(self) -> int:
        """Framebuffer width rounded up to the tile grid (pad pixels render
        and are cropped at display)."""
        return self.tile_count_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tile_count_y * self.tile_height

    @property
    def tile_count_x(self) -> int:
        return -(-self.width // self.tile_width)

    @property
    def tile_count_y(self) -> int:
        return -(-self.height // self.tile_height)

    @property
    def tile_count(self) -> int:
        return self.tile_count_x * self.tile_count_y

    @property
    def effective_tiles_per_step(self) -> int:
        n = self.tiles_per_step if self.tiles_per_step > 0 else self.tile_count_x
        return min(n, self.tile_count)

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")
        if self.scene_kind not in ("sphere", "triangle"):
            raise ValueError(f"unknown scene_kind {self.scene_kind!r}")
        if self.obj_path and self.scene_kind != "triangle":
            raise ValueError("obj_path requires scene_kind='triangle'")
        if self.rng not in ("threefry", "tinymt", "tauslcg", "tpu_hw"):
            raise ValueError(f"unknown rng {self.rng!r}")
        if self.env_mode not in ("mandelbrot", "sun", "none"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.ray_gen not in ("fovy", "viewproj"):
            raise ValueError(f"unknown ray_gen {self.ray_gen!r}")
        if self.nee and self.rng not in ("threefry", "tpu_hw"):
            raise ValueError(
                "nee requires a stateless sampler (threefry or tpu_hw)")
        if self.wavefront and self.rng not in ("threefry", "tpu_hw"):
            raise ValueError(
                "wavefront requires a stateless sampler (threefry or "
                "tpu_hw): stateful per-pixel streams cannot resume across "
                "the compaction boundary")
        if self.mis and not self.nee:
            raise ValueError("mis requires nee")
        if self.material_mode not in ("procedural", "microfacet", "disney"):
            raise ValueError(f"unknown material_mode {self.material_mode!r}")
        if self.aov not in ("pathtracing", "normal", "ambient_occlusion",
                            "hit", "tex_coords", "param_uv"):
            raise ValueError(f"unknown aov {self.aov!r}")
        if self.spp_stack < 1:
            raise ValueError("spp_stack must be >= 1")
        if self.normal_map < 0.0 or self.normal_map_freq <= 0.0:
            raise ValueError("normal_map must be >= 0 and normal_map_freq "
                             "> 0")
        if self.fog_density < 0.0 or not (0.0 <= self.fog_albedo <= 1.0):
            raise ValueError("fog_density must be >= 0 and fog_albedo in "
                             "[0, 1]")
        if self.fog_density > 0.0:
            if self.rng not in ("threefry", "tpu_hw"):
                raise ValueError("fog requires a stateless sampler "
                                 "(threefry or tpu_hw)")
            if self.emissive_every <= 1:
                raise ValueError(
                    "fog requires emissive_every > 1: fog collisions mark "
                    "their vertex non-emissive via the index sentinel 1, "
                    "which must not be an emissive index")
            if self.wavefront:
                # The JAX package's message word for word (the configs
                # share their errors); its 26x is a TPU measurement, in
                # l2n_tpu/ops/kernels/wavefront.py, not the port's.
                raise ValueError(
                    "fog + wavefront is unsupported: the wavefront split "
                    "is a documented 26x-slower negative result kept for "
                    "the record (ops/kernels/wavefront.py docstring); "
                    "fog's collision sampling would split the vertex "
                    "resolve across its pass A/B boundary for a path "
                    "nobody should run — use the single-pass kernels")
        return self

    # JSON round-trip ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        data: dict[str, Any] = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known}).validate()

    def replace(self, **kw: Any) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
