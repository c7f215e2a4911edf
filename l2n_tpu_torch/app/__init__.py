"""Application layer: the headless CLI, the display sinks (PNG sequence,
ANSI terminal preview, matplotlib window) and the interactive viewer."""

from l2n_tpu_torch.app.application import Application  # noqa: F401
from l2n_tpu_torch.app.display import AnsiDisplay, PngSequenceDisplay  # noqa: F401
