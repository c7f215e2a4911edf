"""Interactive terminal viewer (counterpart of l2n_tpu.app.interactive).

  * the framebuffer is presented with 24-bit ANSI half-blocks every frame
    (app/display.AnsiDisplay);
  * the keyboard is read raw (termios cbreak + select) and mouse drags
    arrive via xterm SGR mouse reporting, both translated into the same
    `ControllerInput` records the scripted app uses;
  * runtime tunables: tiles-per-step (+ / -), renderer switch (t), session
    save (p, to l2n_session.npz in the working directory). A tiles-per-step
    value is a program of its own, built once and cached per (renderer,
    tiles per step); the swap KEEPS the state buffers, so the accumulation
    goes on, as in the reference.

Run (on the card unless --backend torch):

    python -m l2n_tpu_torch.app.interactive [--backend cuda|torch]
        [--config cfg.json] [--obj scene.obj | --demo-scene torus-field]

Keys: w/a/s/d move, arrows up/down, q/e roll, mouse-drag look,
      +/- tiles per step, t switch renderer, p save session, x quit.
"""

from __future__ import annotations

import dataclasses
import re
import time
from pathlib import Path

from l2n_tpu_torch.camera import Camera, ControllerInput, ViewController
from l2n_tpu_torch.camera.cache import load_view_matrix, save_view_matrix
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
from l2n_tpu_torch.render.renderer import Renderer
from l2n_tpu_torch.utils.checkpoint import save_session


@dataclasses.dataclass
class Commands:
    """Non-camera commands decoded from one input chunk."""

    quit: bool = False
    switch_renderer: bool = False
    tiles_scale: float = 1.0   # multiplier for tiles_per_step
    save_session: bool = False


_SGR_MOUSE = re.compile(rb"\x1b\[<(\d+);(\d+);(\d+)([Mm])")


class KeyTranslator:
    """Stateful translator: raw terminal bytes -> (ControllerInput,
    Commands). Drives identically from a real TTY or from byte strings."""

    def __init__(self):
        self._dragging = False
        self._last_xy: tuple[int, int] | None = None

    def translate(self, data: bytes) -> tuple[ControllerInput, Commands]:
        inp = ControllerInput()
        cmd = Commands()

        # Mouse (SGR extended reporting): button 0 press 'M'/release 'm';
        # motion-while-held reports button 32.
        pos = 0
        cleaned = b""
        for m in _SGR_MOUSE.finditer(data):
            cleaned += data[pos:m.start()]
            pos = m.end()
            btn, x, y = int(m.group(1)), int(m.group(2)), int(m.group(3))
            press = m.group(4) == b"M"
            if btn == 0:
                self._dragging = press
                self._last_xy = (x, y) if press else None
            elif btn == 32 and self._dragging and self._last_xy:
                lx, ly = self._last_xy
                inp.cursor_dx += float(x - lx)
                inp.cursor_dy += float(y - ly)
                self._last_xy = (x, y)
        cleaned += data[pos:]
        inp.dragging = self._dragging

        i = 0
        while i < len(cleaned):
            b = cleaned[i:i + 1]
            if b == b"\x1b" and cleaned[i + 1:i + 2] == b"[":
                code = cleaned[i + 2:i + 3]
                if code == b"A":
                    inp.up = True
                elif code == b"B":
                    inp.down = True
                i += 3
                continue
            if b in (b"w", b"W"):
                inp.forward = True
            elif b in (b"s", b"S"):
                inp.backward = True
            elif b in (b"a", b"A"):
                inp.left = True
            elif b in (b"d", b"D"):
                inp.right = True
            elif b in (b"q", b"Q"):
                inp.roll_left = True
            elif b in (b"e", b"E"):
                inp.roll_right = True
            elif b in (b"+", b"="):
                cmd.tiles_scale *= 2.0
            elif b == b"-":
                cmd.tiles_scale *= 0.5
            elif b in (b"t", b"T"):
                cmd.switch_renderer = True
            elif b in (b"p", b"P"):
                cmd.save_session = True
            elif b in (b"x", b"X", b"\x03"):  # x or Ctrl-C
                cmd.quit = True
            i += 1
        return inp, cmd


class TerminalInput:  # pragma: no cover - needs a real TTY
    """Raw-mode stdin with xterm SGR mouse reporting enabled."""

    def __init__(self):
        import sys
        self._fd = sys.stdin.fileno()

    def __enter__(self):
        import sys
        import termios
        import tty
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        sys.stdout.write("\x1b[?1002h\x1b[?1006h")  # drag tracking, SGR mode
        sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        import sys
        import termios
        sys.stdout.write("\x1b[?1002l\x1b[?1006l")
        sys.stdout.flush()
        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> bytes:
        import os
        import select
        data = b""
        while select.select([self._fd], [], [], 0)[0]:
            data += os.read(self._fd, 1024)
        return data


class InteractiveApp:
    """Frame loop with live tunables; programs are built lazily per
    (renderer, tiles_per_step) and cached, and the state buffers persist
    across swaps."""

    def __init__(self, cfg: RenderConfig | None = None,
                 workdir: str | Path = ".", backend: str = "cuda",
                 device=None, triangle_scene=None):
        """`triangle_scene` pre-seeds the trianglePT renderer's scene —
        e.g. an OBJ file via scene.obj.load_obj — and makes it the
        startup renderer (as application.py's --obj)."""
        self.cfg = (cfg or RenderConfig()).validate()
        self.workdir = Path(workdir)
        self.backend = backend
        self.device = device
        self._programs: dict[tuple[str, int], object] = {}
        self._scenes: dict[str, object] = {}
        self.tiles_per_step = self.cfg.effective_tiles_per_step
        name = "spherePT"
        if triangle_scene is not None:
            self._scenes["trianglePT"] = triangle_scene
            self.cfg = self.cfg.replace(scene_kind="triangle").validate()
            name = "trianglePT"
        self.renderer = Renderer({name: self._program(name)}, name)
        self.controller = ViewController(
            speed=self.cfg.world_size / 10.0,
            view_matrix=load_view_matrix(self.workdir))

    # -- program cache -------------------------------------------------------
    def _program(self, name: str):
        key = (name, self.tiles_per_step)
        prog = self._programs.get(key)
        if prog is None:
            cfg = self.cfg.replace(tiles_per_step=self.tiles_per_step)
            cls = SphereProgram if name == "spherePT" else TriangleProgram
            prog = cls(cfg, scene=self._scenes.get(name),
                       backend=self.backend, device=self.device)
            self._scenes[name] = prog.scene
            self._programs[key] = prog
        return prog

    def set_tiles_per_step(self, n: int) -> None:
        n = max(1, min(int(n), self.cfg.tile_count))
        if n == self.tiles_per_step:
            return
        self.tiles_per_step = n
        self._swap_program(self.renderer.current)

    def switch_renderer(self) -> None:
        name = ("trianglePT" if self.renderer.current == "spherePT"
                else "spherePT")
        self._swap_program(name)
        # A renderer switch clears the accumulation.
        self.renderer.on_camera_moved()

    def _swap_program(self, name: str) -> None:
        # The renderer's state (its buffers) stays: only the program moves.
        self.renderer.programs[name] = self._program(name)
        self.renderer.current = name

    # -- commands ------------------------------------------------------------
    def apply(self, inp: ControllerInput, cmd: Commands, dt: float) -> bool:
        """Apply one frame of translated input; returns False to quit."""
        if cmd.quit:
            return False
        if cmd.switch_renderer:
            self.switch_renderer()
        if cmd.tiles_scale != 1.0:
            self.set_tiles_per_step(
                round(self.tiles_per_step * cmd.tiles_scale))
        if cmd.save_session:
            save_session(self.workdir / "l2n_session.npz",
                         self.renderer.cfg, self.renderer.state,
                         self.controller.view_matrix)
        if self.controller.update(inp, dt):
            self.renderer.on_camera_moved()
        return True

    @property
    def camera(self) -> Camera:
        return Camera.from_config(self.cfg, self.controller.view_matrix)

    def status_line(self) -> str:
        m = self.renderer.metrics()
        spp = float(self.renderer.state.accum[3].max())
        return (f"{self.renderer.current}  {m['ms_per_step']:.2f} ms/step "
                f"({m['fps']:.0f} FPS)  {m['spp_per_sec']:.1f} spp/s  "
                f"accum {spp:.0f} spp  tiles/step {self.tiles_per_step}  "
                f"[wasd/arrows/qe move, drag look, +/- tiles, t renderer, "
                f"p save, x quit]")

    def run(self, display, input_poll, max_frames: int | None = None) -> int:
        """The frame loop. `input_poll() -> bytes`."""
        translator = KeyTranslator()
        last = time.perf_counter()
        frame = 0
        while max_frames is None or frame < max_frames:
            self.renderer.step(self.camera)
            display.present(self.renderer.display(), frame)
            print(self.status_line(), flush=True)
            now = time.perf_counter()
            dt, last = now - last, now
            inp, cmd = translator.translate(input_poll())
            if not self.apply(inp, cmd, dt):
                break
            frame += 1
        save_view_matrix(self.controller.view_matrix, self.workdir)
        return frame


def main(argv: list[str] | None = None) -> int:  # pragma: no cover
    import argparse

    from l2n_tpu_torch.app.display import AnsiDisplay
    from l2n_tpu_torch.scene.obj import load_obj
    from l2n_tpu_torch.scene.procgen import torus_field_obj, trefoil_obj

    p = argparse.ArgumentParser(description="l2n_tpu_torch interactive "
                                            "viewer")
    p.add_argument("--config", type=Path, help="RenderConfig JSON file")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--obj", type=Path, default=None,
                   help="view this OBJ file with the triangle renderer")
    p.add_argument("--demo-scene", default=None,
                   choices=["torus-field", "trefoil"],
                   help="procedurally generated OBJ demo scene "
                        "(scene.procgen)")
    args = p.parse_args(argv)

    cfg = (RenderConfig.from_json(args.config.read_text())
           if args.config else RenderConfig())
    triangle_scene = None
    if args.demo_scene is not None:
        if args.obj is not None:
            p.error("--demo-scene and --obj are mutually exclusive")
        gen = {"torus-field": torus_field_obj, "trefoil": trefoil_obj}
        triangle_scene = load_obj(gen[args.demo_scene]())
        cfg = cfg.replace(scene_kind="triangle")
    if args.obj is not None:
        triangle_scene = load_obj(args.obj)
        # Recorded in the config so session saves know the scene source.
        cfg = cfg.replace(scene_kind="triangle", obj_path=str(args.obj))
    app = InteractiveApp(cfg, backend=args.backend,
                         triangle_scene=triangle_scene)
    display = AnsiDisplay()
    with TerminalInput() as term:
        app.run(display, term.poll, max_frames=args.max_frames)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
