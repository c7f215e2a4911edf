"""Runtime validation (counterpart of l2n_tpu.utils.validate).

  * `check_frame_state` — NaN/Inf audit of the frame state planes (the
    progressive estimator must stay finite; a NaN accumulates forever) and
    of the sample counts, which never go negative;
  * `debug_mode()` — the port's stand-in for the JAX package's NaN
    debugging plus interpreted kernels (compute-sanitizer does not run on
    the card's machine): every kernel launch synchronizes its device, which
    raises on a CUDA error of the launch or its run, and every render step
    audits its frame state with `check_frame_state` and raises
    FloatingPointError on a NaN, an Inf or a negative count. The kernels
    stay the kernels: nothing is swapped for its plain version;
  * `rmse_vs_oracle` — a backend held against backend="torch" on the same
    device and the same seeds. The plain path is the port's oracle, bit-
    equal to the JAX package's XLA step run op by op.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.ops.kernels.common import set_debug_checks
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.step import build_render_step, resolve_device


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    nan_count: int
    inf_count: int
    negative_samples: int  # accum sample counts must never go negative

    @property
    def ok(self) -> bool:
        return self.nan_count == 0 and self.inf_count == 0 \
            and self.negative_samples == 0


def check_frame_state(state) -> ValidationReport:
    """Audit the accum/output planes for non-finite values and accum's
    sample counts for negative ones (on the planes' device)."""
    nans = infs = 0
    for plane in (state.accum, state.output):
        nans += int(torch.isnan(plane).sum())
        infs += int(torch.isinf(plane).sum())
    neg = int((state.accum[3] < 0).sum())
    return ValidationReport(nan_count=nans, inf_count=infs,
                            negative_samples=neg)


@contextlib.contextmanager
def debug_mode():
    """Checked launches and audited steps (module doc) inside the block."""
    prev = set_debug_checks(True)
    try:
        yield
    finally:
        set_debug_checks(prev)


def rmse_vs_oracle(cfg, scene, steps: int = 4, backend: str = "cuda",
                   camera=None, device=None) -> dict[str, float]:
    """Render `steps` with `backend` and with backend="torch" on the same
    device from identical fresh states; return accumulation-domain parity
    statistics (the JAX function's keys)."""
    device = resolve_device(backend, device)
    packed = (camera or Camera.from_config(cfg)).packed()
    test_step = build_render_step(cfg, scene, backend=backend, device=device)
    oracle_step = build_render_step(cfg, scene, backend="torch",
                                    device=device)
    st_a = init_frame_state(cfg, device)
    st_b = init_frame_state(cfg, device)
    for _ in range(steps):
        st_a = test_step(st_a, packed)
        st_b = oracle_step(st_b, packed)
    a, b = st_a.accum.cpu().numpy(), st_b.accum.cpu().numpy()
    diff = np.abs(a - b)
    return {
        "rmse": float(np.sqrt((diff ** 2).mean())),
        "max_abs": float(diff.max()),
        "diverging_fraction": float((diff > 1e-3).mean()),
        "coverage_match": bool((a[3] == b[3]).all()),
    }
