"""Display sink: headless PNG sequence (counterpart of the PNG sink of
l2n_tpu.app.display)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from l2n_tpu_torch.utils.image import write_png


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
