"""Build and load the CUDA kernels (counterpart of l2n_tpu.native's
build-on-demand).

Each of `l2n_tpu_torch/csrc/*.cu` compiles with its own nvcc process, all
started together, and one more nvcc links the objects into one shared
library with a plain C interface, loaded through ctypes. The library goes
to `l2n_tpu_torch/build/` (git-ignored), named by a digest of the sources,
headers and flags, so a checkout builds it at first use and an edit
rebuilds it. Nothing is built when a module is imported.

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

from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_KERNELS_LOAD = Site("kernels.load")
_KERNELS_BUILD = Site("kernels.build")

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
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
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{out.stem}-{src.stem}.{tag}.o") for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = []
    for cmd, proc in zip(cmds, procs):
        so, se = proc.communicate()
        results.append((cmd, proc.returncode, so, se))
    tmp = out.with_suffix(f".{tag}")
    if all(rc == 0 for _, rc, _, _ in results):
        cmd = [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        results.append((cmd, link.returncode, link.stdout, link.stderr))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = out.with_suffix(".log")
    log.write_text("".join(" ".join(cmd) + "\n" + so + se
                           for cmd, _, so, se in results))
    failed = [(rc, se) for _, rc, _, se in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0][0]}); see {log}:\n"
                           + failed[0][1][-4000:])
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "sphere_pt": [p] * 9,
        "uv_demo": [i, i, p, p, p],
        "triangle_pt": [p, p, i, i] + [p] * 19,
        "wavefront_pass_a": [p] * 11,
        "wavefront_pass_b": [p, p, i, i] + [p] * 7,
        "wavefront_pass_c": [p] * 8,
        "philox_bits": [p, i, i, p, p],
        "cond_cost": [p, i, i, i, i, i, p, p],
        "sweep_vpu": [p] * 6 + [i, i, i, p, p, p],
        "sweep_vpu2": [p] * 6 + [i, i, i, p, p, p],
        "sweep_shape": [i, i, i, p],
        "sweep_mma": [p, p, p, i, i, i, p, p, p, p, p],
        "onehot_carry": [p, p, i, i, p, p],
        "onehot_gather": [p, p, i, p, i, p, p],
        "onehot_shape": [i, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, f"l2n_{name}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    with _KERNELS_LOAD:
        with _KERNELS_BUILD:
            path, _ = build()
        return _declare(ctypes.CDLL(str(path)))
