"""Display sinks (counterpart of l2n_tpu.app.display): a headless PNG
sequence, an ANSI terminal preview, and a matplotlib window where
matplotlib is installed (the card's machine has none: it is imported only
when that display is made)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from l2n_tpu_torch.utils.image import tonemap_to_u8, write_png


class PngSequenceDisplay:
    """Write frame_%05d.png into a directory every `every` frames."""

    def __init__(self, directory: str | Path, every: int = 1):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.every = max(1, every)

    def present(self, image: np.ndarray, frame: int) -> None:
        if frame % self.every == 0:
            write_png(self.directory / f"frame_{frame:05d}.png", image)

    def close(self) -> None:
        pass


class AnsiDisplay:
    """Terminal preview with 24-bit background half-blocks (2 rows/char);
    the JAX class's bytes for the same image."""

    def __init__(self, max_cols: int = 100, stream=None):
        self.max_cols = max_cols
        self.stream = stream or sys.stdout

    def present(self, image: np.ndarray, frame: int) -> None:
        img = tonemap_to_u8(image)[::-1]  # PNG-style top-first
        h, w, _ = img.shape
        step = max(1, w // self.max_cols)
        img = img[::2 * step, ::step]
        out = [f"\x1b[H\x1b[2J frame {frame}"]
        for row in img:
            line = []
            for r, g, b in row:
                line.append(f"\x1b[48;2;{r};{g};{b}m ")
            out.append("".join(line) + "\x1b[0m")
        self.stream.write("\n".join(out) + "\n")
        self.stream.flush()

    def close(self) -> None:
        pass


class MatplotlibDisplay:
    """Interactive window when matplotlib is importable (any backend —
    under Agg it renders offscreen, which is how tests exercise it)."""

    def __init__(self, backend: str | None = None):
        import matplotlib
        if backend:
            matplotlib.use(backend)
        import matplotlib.pyplot as plt
        self.plt = plt
        self.fig, self.ax = plt.subplots()
        self.im = None

    def present(self, image: np.ndarray, frame: int) -> None:
        img = np.clip(image[::-1], 0, 1)
        if self.im is None:
            self.im = self.ax.imshow(img)
            self.plt.ion()
            self.plt.show()
        else:
            self.im.set_data(img)
        self.ax.set_title(f"frame {frame}")
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    def close(self) -> None:
        self.plt.close(self.fig)
