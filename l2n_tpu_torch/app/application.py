"""The application: camera persistence + program + frame loop (counterpart
of l2n_tpu.app.application for the sphere renderer).

Load the cached camera pose, build the sphere program, then per frame:
render step, present, apply controller input, clear accumulation on camera
move; save the pose on exit.

    python -m l2n_tpu_torch.app.application --frames 230 --out frames \\
        --every 229 --backend cuda
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Iterable

from l2n_tpu.config import RenderConfig
from l2n_tpu_torch.camera import Camera, ControllerInput, ViewController
from l2n_tpu_torch.camera.cache import load_view_matrix, save_view_matrix
from l2n_tpu_torch.render.program import SphereProgram
from l2n_tpu_torch.render.renderer import Renderer

_log = logging.getLogger("l2n_tpu_torch.app")

InputSource = Callable[[int], ControllerInput | None]


class Application:
    def __init__(self, cfg: RenderConfig | None = None,
                 workdir: str | Path = ".", backend: str = "cuda",
                 device=None, renderer_names: Iterable[str] = ("spherePT",),
                 initial_renderer: str | None = None):
        self.cfg = (cfg or RenderConfig()).validate()
        self.workdir = Path(workdir)
        programs = {}
        for name in renderer_names:
            if name == "spherePT":
                programs[name] = SphereProgram(self.cfg, backend=backend,
                                               device=device)
            elif name == "trianglePT":
                raise NotImplementedError(
                    "the trianglePT renderer is ROADMAP Queue 1 #8")
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
                    _log.info("frame %d: %s", frame + 1,
                              self.renderer.metrics())
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


def main(argv: list[str] | None = None) -> int:
    """CLI: headless render to a PNG sequence."""
    import argparse

    from l2n_tpu_torch.app.display import PngSequenceDisplay

    p = argparse.ArgumentParser(description="l2n_tpu_torch progressive "
                                            "renderer (sphere scene)")
    p.add_argument("--config", type=Path, help="RenderConfig JSON file")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--out", type=Path, default=Path("frames"))
    p.add_argument("--every", type=int, default=16, help="PNG every N frames")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda for --backend cuda, "
                        "cpu for --backend torch)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = (RenderConfig.from_json(args.config.read_text())
           if args.config else RenderConfig())
    app = Application(cfg, backend=args.backend, device=args.device)
    display = PngSequenceDisplay(args.out, every=args.every)
    app.run(args.frames, display=display, metrics_every=32)
    print(f"rendered {args.frames} steps on {app.renderer.program.device}; "
          f"metrics: {app.renderer.metrics()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
