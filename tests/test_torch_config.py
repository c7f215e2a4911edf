"""The port's own RenderConfig (l2n_tpu_torch/config.py) against the JAX
package's: the same fields and defaults, JSON, properties and validation
errors, and no module of the port importing jax or the JAX package."""

import ast
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu_torch.config import RenderConfig


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    yield
    _forget_port()


REPO = Path(__file__).resolve().parents[1]

CONFIGS = [
    {}, {"width": 256, "height": 128}, {"scene_kind": "triangle"},
    {"wavefront": True}, {"spp_per_step": 4, "max_bounces": 3},
    {"tiles_per_step": 17, "tile_height": 8, "tile_width": 32},
    {"rng": "tinymt", "seed": 7}, {"nee": True, "mis": True},
    {"env_mode": "none", "gamma": 1.0}, {"aov": "param_uv",
                                         "scene_kind": "triangle"},
    {"fog_density": 0.01, "fog_albedo": 0.5},
    {"obj_path": "scene.obj", "scene_kind": "triangle"},
    {"material_mode": "disney", "normal_map": 0.5, "fast_math": True},
]

PROPERTIES = ["rng_stateful", "tan_half_fovy", "aspect_ratio",
              "padded_width", "padded_height", "tile_count_x",
              "tile_count_y", "tile_count", "effective_tiles_per_step"]


def test_fields_and_defaults_match_jax():
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(RenderConfig)]
    jax_ = [(f.name, f.type, f.default) for f in dataclasses.fields(JRenderConfig)]
    assert port == jax_
    from l2n_tpu import config as jconfig
    from l2n_tpu_torch import config as tconfig
    for name in ("DEFAULT_WIDTH", "DEFAULT_HEIGHT", "DEFAULT_FOVY_DEG",
                 "DEFAULT_SPHERE_COUNT", "DEFAULT_WORLD_SIZE"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


@pytest.mark.parametrize("kw", CONFIGS)
def test_json_and_properties_match_jax(kw):
    port, jax_ = RenderConfig(**kw).validate(), JRenderConfig(**kw).validate()
    assert port.to_json() == jax_.to_json()
    assert RenderConfig.from_json(jax_.to_json()) == port
    assert JRenderConfig.from_json(port.to_json()) == jax_
    for name in PROPERTIES:
        assert getattr(port, name) == getattr(jax_, name), name
    assert (port.replace(width=99).to_json()
            == jax_.replace(width=99).to_json())
    assert hash(port) == hash(RenderConfig(**kw))


@pytest.mark.parametrize("kw", [
    {"width": 0}, {"max_bounces": 0}, {"scene_kind": "voxel"},
    {"obj_path": "a.obj"}, {"rng": "mt"}, {"env_mode": "hdr"},
    {"ray_gen": "ortho"}, {"nee": True, "rng": "tinymt"},
    {"wavefront": True, "rng": "tauslcg"}, {"mis": True},
    {"material_mode": "glass"}, {"aov": "depth"}, {"spp_stack": 0},
    {"normal_map": -1.0}, {"fog_albedo": 2.0},
    {"fog_density": 0.1, "rng": "tinymt"},
    {"fog_density": 0.1, "emissive_every": 1},
    {"fog_density": 0.1, "wavefront": True}])
def test_validate_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JRenderConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        RenderConfig(**kw).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["sphere_pt_256x128_4spp.npz",
                                  "triangle_pt_256x128_4spp.npz"])
def test_golden_configs_load_unchanged(name):
    with np.load(REPO / "tests" / "golden" / name) as data:
        text = bytes(data["config"]).decode()
    assert RenderConfig.from_json(text).to_json() == \
        JRenderConfig.from_json(text).to_json()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every module of the port and chip_smoke.py, imports inside functions
    included: nothing of jax, nothing of l2n_tpu."""
    files = sorted((REPO / "l2n_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "l2n_tpu")]
    assert bad == []
