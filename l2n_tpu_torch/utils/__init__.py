"""Utilities: image IO, metrics and profiling, validation, session
checkpoints."""

from l2n_tpu_torch.utils.image import write_png, tonemap_to_u8  # noqa: F401
