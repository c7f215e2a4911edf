"""The application: camera persistence + programs + frame loop
(counterpart of l2n_tpu.app.application).

Load the cached camera pose, build the render programs (spherePT and
trianglePT), then per frame: render step, present, apply controller input,
clear accumulation on camera move; save the pose on exit.

    python -m l2n_tpu_torch.app.application --frames 230 --out frames \\
        --every 229 --backend cuda
    python -m l2n_tpu_torch.app.application --renderer trianglePT ...
    python -m l2n_tpu_torch.app.application --obj scene.obj ...
    python -m l2n_tpu_torch.app.application --demo-scene torus-field ...
    python -m l2n_tpu_torch.app.application --config cfg.json ...
    python -m l2n_tpu_torch.app.application --ansi ...  # terminal preview

A `--config` JSON holds RenderConfig fields (l2n_tpu_torch/config.py);
`{"wavefront": true}` renders spherePT through the wavefront step, and
`{"rng": "tinymt"}` (or "tauslcg", or "tpu_hw": Philox on the card) picks
the sampler. `Application.save_session` / `load_session` checkpoint and
resume a render (utils/checkpoint.py: the JAX package's session files).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Iterable

from l2n_tpu_torch.camera import Camera, ControllerInput, ViewController
from l2n_tpu_torch.camera.cache import load_view_matrix, save_view_matrix
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
from l2n_tpu_torch.render.renderer import Renderer
from l2n_tpu_torch.scene.obj import load_obj
from l2n_tpu_torch.scene.procgen import torus_field_obj, trefoil_obj
from l2n_tpu_torch.utils.checkpoint import load_session, save_session
from l2n_tpu_torch.utils.profiling import log_metrics

InputSource = Callable[[int], ControllerInput | None]


class Application:
    def __init__(self, cfg: RenderConfig | None = None,
                 workdir: str | Path = ".", backend: str = "cuda",
                 device=None,
                 renderer_names: Iterable[str] = ("spherePT", "trianglePT"),
                 initial_renderer: str | None = None, triangle_scene=None):
        """`triangle_scene` (a TriangleScene) replaces the tessellated
        spheres of the trianglePT renderer, e.g. an OBJ via
        scene.obj.load_obj."""
        self.cfg = (cfg or RenderConfig()).validate()
        self.workdir = Path(workdir)
        programs = {}
        for name in renderer_names:
            if name == "spherePT":
                programs[name] = SphereProgram(self.cfg, backend=backend,
                                               device=device)
            elif name == "trianglePT":
                programs[name] = TriangleProgram(
                    self.cfg, scene=triangle_scene, backend=backend,
                    device=device)
            else:
                raise ValueError(f"unknown renderer {name!r}")
        self.renderer = Renderer(programs, initial_renderer)
        view = load_view_matrix(self.workdir)
        # Camera speed = worldSize / 10.
        self.controller = ViewController(speed=self.cfg.world_size / 10.0,
                                         view_matrix=view)

    @property
    def camera(self) -> Camera:
        return Camera.from_config(self.cfg, self.controller.view_matrix)

    def switch_renderer(self, name: str) -> None:
        self.renderer.switch(name)

    def run(self, frames: int, display=None,
            input_source: InputSource | None = None,
            metrics_every: int = 0, save_camera: bool = True):
        """Render `frames` progressive steps; returns the final FrameState."""
        last = time.perf_counter()
        try:
            for frame in range(frames):
                self.renderer.step(self.camera)
                if display is not None:
                    display.present(self.renderer.display(), frame)
                if metrics_every and (frame + 1) % metrics_every == 0:
                    log_metrics(frame + 1, self.renderer.metrics())
                now = time.perf_counter()
                dt, last = now - last, now
                inp = input_source(frame) if input_source else None
                if inp is not None and self.controller.update(inp, dt):
                    self.renderer.on_camera_moved()
        finally:
            if display is not None:
                display.close()
            if save_camera:
                save_view_matrix(self.controller.view_matrix, self.workdir)
        return self.renderer.state

    # -- session checkpoints ----------------------------------------------
    def save_session(self, path: str | Path) -> Path:
        return save_session(path, self.cfg, self.renderer.state,
                            self.controller.view_matrix)

    def load_session(self, path: str | Path) -> None:
        """Resume a saved session: its config must equal this one's; its
        planes are copied into the live buffers."""
        cfg, state, view = load_session(path, device="cpu")
        if cfg != self.cfg:
            raise ValueError("session config does not match application "
                             "config")
        self.renderer.load_state(state)
        self.controller.set_view_matrix(view)


def main(argv: list[str] | None = None) -> int:
    """CLI: headless render to a PNG sequence."""
    import argparse

    from l2n_tpu_torch.app.display import AnsiDisplay, PngSequenceDisplay

    p = argparse.ArgumentParser(description="l2n_tpu_torch progressive "
                                            "renderer")
    p.add_argument("--config", type=Path, help="RenderConfig JSON file")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--out", type=Path, default=Path("frames"))
    p.add_argument("--every", type=int, default=16, help="PNG every N frames")
    p.add_argument("--renderer", default=None,
                   choices=["spherePT", "trianglePT"])
    p.add_argument("--obj", type=Path, default=None,
                   help="render this OBJ file with the triangle renderer")
    p.add_argument("--demo-scene", default=None,
                   choices=["torus-field", "trefoil"],
                   help="procedurally generated OBJ demo scene "
                        "(scene.procgen): the 24-tori field or the "
                        "70k-triangle trefoil knot")
    p.add_argument("--ansi", action="store_true", help="terminal preview")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda for --backend cuda, "
                        "cpu for --backend torch)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = (RenderConfig.from_json(args.config.read_text())
           if args.config else RenderConfig())
    triangle_scene = None
    renderer = args.renderer
    renderer_names = ("spherePT", "trianglePT")
    if args.demo_scene is not None:
        if args.obj is not None:
            p.error("--demo-scene and --obj are mutually exclusive")
        gen = {"torus-field": torus_field_obj, "trefoil": trefoil_obj}
        triangle_scene = load_obj(gen[args.demo_scene]())
        renderer = "trianglePT"
        renderer_names = ("trianglePT",)
        cfg = cfg.replace(scene_kind="triangle")
    if args.obj is not None:
        renderer = "trianglePT"
        renderer_names = ("trianglePT",)
        # obj_path rides in the config (TriangleProgram loads it).
        cfg = cfg.replace(scene_kind="triangle", obj_path=str(args.obj))
    app = Application(cfg, backend=args.backend, device=args.device,
                      renderer_names=renderer_names,
                      initial_renderer=renderer,
                      triangle_scene=triangle_scene)
    display = (AnsiDisplay() if args.ansi
               else PngSequenceDisplay(args.out, every=args.every))
    app.run(args.frames, display=display, metrics_every=32)
    print(f"rendered {args.frames} {app.renderer.current} steps on "
          f"{app.renderer.program.device}; "
          f"metrics: {app.renderer.metrics()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
