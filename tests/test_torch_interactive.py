"""l2n_tpu_torch's interactive viewer and display sinks on the CPU
(backend="torch"), held against the JAX package's app/interactive.py and
app/display.py: the same input translation on tests/test_interactive.py's
byte streams, the same ANSI bytes, and the same live tunables; a session
saved with `p` loads in the JAX package.
"""

import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from l2n_tpu.app.display import AnsiDisplay as JAnsiDisplay
from l2n_tpu.app.interactive import KeyTranslator as JKeyTranslator
from l2n_tpu.utils.checkpoint import load_session as jload_session
from l2n_tpu_torch.app.display import AnsiDisplay, MatplotlibDisplay
from l2n_tpu_torch.app.interactive import InteractiveApp, KeyTranslator
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
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


# tests/test_interactive.py's byte streams, each fed in order to one
# translator (the mouse drag spans chunks).
STREAMS = {
    "movement": [b"w", b"sad", b"qe"],
    "arrows": [b"\x1b[A", b"\x1b[B"],
    "drag": [b"\x1b[<0;10;5M", b"\x1b[<32;14;8M", b"\x1b[<0;14;8m"],
    "commands": [b"+", b"--", b"t", b"p", b"x", b"\x03"],
    "mixed": [b"w\x1b[<0;3;3M\x1b[<32;5;4Md+x"],
    "upper_and_unknown": [b"WSADQE=TPX", b"zz\x1b[C?"],
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_key_translator_matches_jax(name):
    ours, theirs = KeyTranslator(), JKeyTranslator()
    for chunk in STREAMS[name]:
        inp, cmd = ours.translate(chunk)
        jinp, jcmd = theirs.translate(chunk)
        assert dataclasses.asdict(inp) == dataclasses.asdict(jinp)
        assert dataclasses.asdict(cmd) == dataclasses.asdict(jcmd)


@pytest.mark.parametrize("shape,max_cols", [((16, 32, 3), 100),
                                            ((64, 250, 3), 100),
                                            ((9, 40, 3), 7)])
def test_ansi_display_bytes_match_jax(shape, max_cols):
    img = np.random.default_rng(7).random(shape).astype(np.float32) * 1.2
    img[0, 0] = -0.5
    got, want = io.StringIO(), io.StringIO()
    AnsiDisplay(max_cols, got).present(img, 3)
    JAnsiDisplay(max_cols, want).present(img, 3)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith("\x1b[H\x1b[2J frame 3")


def _tiny_cfg():
    """tests/test_interactive.py's config."""
    return RenderConfig(width=128, height=64, tile_height=32, tile_width=128,
                        sphere_count=8, disc_lat=8, disc_long=4,
                        tiles_per_step=1).validate()


def _app(tmp_path):
    return InteractiveApp(_tiny_cfg(), workdir=tmp_path, backend="torch")


def test_tiles_per_step_keeps_accumulation(tmp_path):
    app = _app(tmp_path)
    app.renderer.step(app.camera)
    accum = app.renderer.state.accum
    assert float(accum[3].sum()) == 128 * 32
    app.set_tiles_per_step(2)
    assert app.tiles_per_step == 2
    assert app.renderer.cfg.effective_tiles_per_step == 2
    app.renderer.step(app.camera)
    # The same buffers go on accumulating: one more tile, then two.
    assert app.renderer.state.accum is accum
    assert float(accum[3].sum()) == 3 * 128 * 32
    app.set_tiles_per_step(1)  # the cached program comes back
    assert app.renderer.program is app._programs[("spherePT", 1)]


def test_switch_and_move_clear_accumulation(tmp_path):
    app = _app(tmp_path)
    app.renderer.step(app.camera)
    app.switch_renderer()
    assert app.renderer.current == "trianglePT"
    assert float(app.renderer.state.accum.abs().sum()) == 0.0
    app.renderer.step(app.camera)  # the triangle program runs
    assert float(app.renderer.state.accum[3].sum()) > 0
    inp, cmd = KeyTranslator().translate(b"w")
    assert app.apply(inp, cmd, dt=0.1)
    assert float(app.renderer.state.accum.abs().sum()) == 0.0


def test_save_session_key_loads_in_jax(tmp_path):
    app = _app(tmp_path)
    for _ in range(2):
        app.renderer.step(app.camera)
    inp, cmd = KeyTranslator().translate(b"p")
    assert app.apply(inp, cmd, dt=0.0)
    cfg, state, view = jload_session(tmp_path / "l2n_session.npz")
    assert cfg.to_json() == app.renderer.cfg.to_json()
    np.testing.assert_array_equal(np.asarray(state.accum),
                                  app.renderer.state.accum.numpy())
    assert int(state.iteration) == 2
    np.testing.assert_array_equal(view, app.controller.view_matrix)


def test_frame_loop_with_scripted_input(tmp_path, capsys):
    """tests/test_interactive.py's script into an AnsiDisplay: quit on 'x'
    after 5 frames, a '+' and a 't' on the way."""
    app = _app(tmp_path)
    it = iter([b"", b"w", b"+", b"t", b"x"])
    stream = io.StringIO()
    frames = app.run(AnsiDisplay(stream=stream), lambda: next(it, b"x"),
                     max_frames=10)
    assert frames == 4
    assert stream.getvalue().count("\x1b[H\x1b[2J frame") == 5
    assert app.tiles_per_step == 2 and app.renderer.current == "trianglePT"
    assert (tmp_path / "l2n_cache.json").exists()
    assert "tiles/step" in capsys.readouterr().out


def test_matplotlib_display_under_agg():
    pytest.importorskip("matplotlib")
    d = MatplotlibDisplay(backend="Agg")
    img = np.random.default_rng(0).random((16, 32, 3)).astype(np.float32)
    d.present(img, 0)
    d.present(img * 0.5, 1)
    assert d.ax.get_title() == "frame 1"
    d.close()
