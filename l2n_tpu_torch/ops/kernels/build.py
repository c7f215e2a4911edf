"""Build and load the CUDA kernels (counterpart of l2n_tpu.native's
build-on-demand).

All of `l2n_tpu_torch/csrc/*.cu` compile with nvcc, in one command, into one
shared library with a plain C interface, loaded through ctypes. The library
goes to `l2n_tpu_torch/build/` (git-ignored), named by a digest of the
sources, headers and flags, so a checkout builds it at first use and an
edit rebuilds it. Nothing is built when a module is imported.

Flags: sm_90a (Hopper), no fused multiply-add contraction (`-fmad=false`,
like the native twin's `-ffp-contract=off`: contracting the sphere sweep
moves decision-boundary pixels against the reference), and never
`--use_fast_math` (the sweeps rely on IEEE sqrt of a negative being NaN).
`-Xptxas -v` only reports registers and spills into the build log.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> tuple[Path, float]:
    """Compile the library if it is missing; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    out = BUILD_DIR / f"libl2n_kernels-{_digest()}.so"
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *map(str, sorted(CSRC.glob("*.cu"))),
           "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}); see {log}:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    lib.l2n_sphere_pt.argtypes = [p, p, p, p, p, p, p]
    lib.l2n_sphere_pt.restype = ctypes.c_int
    lib.l2n_uv_demo.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p]
    lib.l2n_uv_demo.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build()
    return _declare(ctypes.CDLL(str(path)))
