"""Sphere-sweep formulations on the card (counterpart of
benchmarks/sweep_variants.py).

Each kernel runs REPEATS nearest-hit sweeps over n spheres for every lane
of (blocks, 32, 128) rays, the direction's x scaled by 1 + 1e-4 r in repeat
r, and accumulates t, the winner's cx and r2 and its index from `bias`:

  * `sweep_vpu` — the production sweep, the winner's attributes carried
    through every candidate;
  * `sweep_vpu2` — (t, index) only, the attributes gathered afterwards
    (bit-equal to `sweep_vpu`);
  * `sweep_mma` — the JAX mxu kernel's algebra (not bit-equal to
    `sweep_vpu`, by design), its dot products on the tensor cores. Its
    plain version takes the dot products exact and rounded once; the
    kernel rejects on the tensor cores (3xTF32) only the candidates whose
    line provably misses and resolves the rest exactly, so it equals the
    plain version to the bit. `exact_dots=False` sums float32 products
    instead, as the JAX kernel's float32 dot does.

Each wrapper launches csrc/sweep_variants.cu on CUDA tensors and runs its
`*_plain` version on CPU tensors. The kernels walk the spheres once per
chunk of repeats (`launch_shape` gives the chunk, block, grid and the
blocks an SM holds).

CAVEAT (benchmarks/PROFILE.md, "methodology"): an isolated harness's
absolute rate need not be the fused kernel's; the chained repeats
serialize what a path-tracing kernel overlaps. Compare the three here with
each other, and with `sphere_pt`'s in-kernel rate only with that caveat.

    python3 -m l2n_tpu_torch.probes.sweep_variants [--device cuda|cpu]

runs BLOCKS blocks of rays, SPHERES spheres and REPEATS repeats (the JAX
probe's sizes) and prints, per variant, ms per call and ps per (lane x candidate), and the
largest |variant - vpu|. The JAX probe's rows_per_chunk (rows concatenated
onto TPU lanes for its matrix unit) is a TPU layout with no counterpart:
the mma variant runs once.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.sampling import sqrt
from l2n_tpu_torch.ops.kernels import build
from l2n_tpu_torch.ops.kernels.common import check_tensor, launch_raw
from l2n_tpu_torch.probes import elapsed_ms, probe_device
from l2n_tpu_torch.scene.spheres import compute_spheres

REPEATS = 16
BLOCKS = 64
SPHERES = 128
TH, TW = 32, 128
BIG = 3.0e38


def inputs(seed: int = 0, blocks: int = BLOCKS) -> dict:
    """The probe's inputs as numpy arrays, built as
    benchmarks/sweep_variants.py:238-253 builds them: o, d (3, blocks, 32,
    128) float32 (d unit length), the 128 spheres of the default scene as
    cx, cy, cz, r2 (128,) float32, and cmat (8, 128) = rows cx, cy, cz, r2,
    |c|^2 - r^2, 0, 0, 0."""
    cfg = RenderConfig().validate()
    scene = compute_spheres(128, 1024.0, cfg.scene_seed)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-400, 400, (3, blocks, TH, TW)).astype(np.float32)
    d = rng.normal(size=(3, blocks, TH, TW))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cx, cy, cz, r2 = (t.numpy() for t in (scene.center_x, scene.center_y,
                                          scene.center_z, scene.sqr_radius))
    zero = r2 * 0
    cmat = np.stack([cx, cy, cz, r2, cx * cx + cy * cy + cz * cz - r2, zero,
                     zero, zero], axis=0)
    return {"o": o, "d": d.astype(np.float32), "cx": cx, "cy": cy, "cz": cz,
            "r2": r2, "cmat": cmat}


def _check_rays(o, d, bias, repeats: int):
    """(lanes, device) after checking the ray planes and bias."""
    dev = o.device if isinstance(o, torch.Tensor) else None
    blocks = o.shape[1] if isinstance(o, torch.Tensor) and o.dim() == 4 else -1
    check_tensor("o", o, torch.float32, (3, blocks, TH, TW), dev)
    check_tensor("d", d, torch.float32, (3, blocks, TH, TW), dev)
    check_tensor("bias", bias, torch.float32, (blocks, TH, TW), dev)
    if blocks <= 0 or repeats < 0:
        raise ValueError("sweep: blocks must be positive, repeats >= 0")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sweep: no kernel for device {dev}")
    return blocks * TH * TW, dev


def _check_spheres(cx, cy, cz, r2, dev) -> int:
    n = cx.shape[0] if isinstance(cx, torch.Tensor) and cx.dim() == 1 else -1
    for name, t in (("cx", cx), ("cy", cy), ("cz", cz), ("r2", r2)):
        check_tensor(name, t, torch.float32, (n,), dev)
    if n <= 0:
        raise ValueError("sweep: at least one sphere")
    return n


def _scale(r: int, dev) -> torch.Tensor:
    """1 + 1e-4 r in float32 (benchmarks/sweep_variants.py:58)."""
    f32 = torch.float32
    return (torch.ones((), dtype=f32, device=dev)
            + torch.tensor(1e-4, dtype=f32, device=dev)
            * torch.tensor(float(r), dtype=f32, device=dev))


def _two_root_t(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2, big):
    rox, roy, roz = ox - cx, oy - cy, oz - cz
    hb = rox * dx + roy * dy + roz * dz
    c = rox * rox + roy * roy + roz * roz - r2
    sq = sqrt(hb * hb - c)
    t1 = -hb - sq
    t2 = -hb + sq
    t = torch.where(t1 >= 0.0, t1, t2)
    return torch.where(t >= 0.0, t, big)


def _sweep_plain(o, d, spheres, bias, repeats: int, carry: bool):
    """sweep_vpu (carry) / sweep_vpu2 in lockstep over the lanes, one
    candidate at a time."""
    dev = o.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cx, cy, cz, r2 = spheres
    ox, oy, oz = o
    acc = bias
    for r in range(repeats):
        dx, dy, dz = d[0] * _scale(r, dev), d[1], d[2]
        best_t = torch.full_like(acc, BIG)
        best_i = torch.full(acc.shape, -1, dtype=torch.int32, device=dev)
        bcx, br2 = torch.zeros_like(acc), torch.zeros_like(acc)
        for j in range(cx.shape[0]):
            t = _two_root_t(ox, oy, oz, dx, dy, dz, cx[j], cy[j], cz[j],
                            r2[j], big)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, j, best_i)
            if carry:  # cy, cz never reach the output
                bcx = torch.where(better, cx[j], bcx)
                br2 = torch.where(better, r2[j], br2)
        if not carry:
            hit = best_i >= 0
            at = best_i.clamp(min=0).long()
            bcx = torch.where(hit, cx[at], zero)
            br2 = torch.where(hit, r2[at], zero)
        acc = (acc + torch.where(best_t < big, best_t, zero) + bcx * 1e-6
               + br2 * 1e-9 + best_i.to(torch.float32) * 1e-3)
    return acc


def sweep_vpu(o, d, cx, cy, cz, r2, bias, repeats: int = REPEATS):
    """(blocks, 32, 128) float32: the carry sweep (see module doc)."""
    return _sweep("sweep_vpu", o, d, cx, cy, cz, r2, bias, repeats)


def sweep_vpu2(o, d, cx, cy, cz, r2, bias, repeats: int = REPEATS):
    """(blocks, 32, 128) float32: the (t, index) sweep and gather."""
    return _sweep("sweep_vpu2", o, d, cx, cy, cz, r2, bias, repeats)


def _sweep(name, o, d, cx, cy, cz, r2, bias, repeats):
    lanes, dev = _check_rays(o, d, bias, repeats)
    n = _check_spheres(cx, cy, cz, r2, dev)
    if dev.type == "cpu":
        plain = sweep_vpu_plain if name == "sweep_vpu" else sweep_vpu2_plain
        return plain(o, d, cx, cy, cz, r2, bias, repeats)
    out = torch.empty_like(bias)
    launch_raw(name, dev, o, d, cx, cy, cz, r2, n, lanes, repeats, bias, out)
    return out


def launch_shape(name: str, lanes: int, n: int = SPHERES
                 ) -> tuple[int, int, int, int]:
    """(repeats per chunk, threads per block, blocks, blocks per SM) of the
    kernel `name` (sweep_vpu, sweep_vpu2 or sweep_mma) at `lanes` lanes and
    n spheres, from the built library and the current card."""
    kind = ("sweep_vpu2", "sweep_vpu", "sweep_mma").index(name)
    shape = np.zeros(4, np.int32)
    rc = build.load().l2n_sweep_shape(kind, lanes, n, shape.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"sweep launch shape: CUDA error {rc}")
    return tuple(int(v) for v in shape)


def sweep_vpu_plain(o, d, cx, cy, cz, r2, bias, repeats: int = REPEATS):
    """The plain torch version of `sweep_vpu`."""
    _check_rays(o, d, bias, repeats)
    _check_spheres(cx, cy, cz, r2, o.device)
    return _sweep_plain(o, d, (cx, cy, cz, r2), bias, repeats, carry=True)


def sweep_vpu2_plain(o, d, cx, cy, cz, r2, bias, repeats: int = REPEATS):
    """The plain torch version of `sweep_vpu2`."""
    _check_rays(o, d, bias, repeats)
    _check_spheres(cx, cy, cz, r2, o.device)
    return _sweep_plain(o, d, (cx, cy, cz, r2), bias, repeats, carry=False)


def _check_cmat(cmat, dev) -> int:
    n = cmat.shape[1] if isinstance(cmat, torch.Tensor) and cmat.dim() == 2 \
        else -1
    check_tensor("cmat", cmat, torch.float32, (8, n), dev)
    if n <= 0 or n % 8:
        raise ValueError(f"sweep_mma: {n} spheres, expected a positive "
                         "multiple of 8 (the mma tile)")
    return n


def sweep_mma(o, d, cmat, bias, repeats: int = REPEATS, index=None,
              stats=None):
    """(blocks, 32, 128) float32: the tensor-core sweep. `index`, if given,
    a (repeats, blocks, 32, 128) int32 tensor that receives each repeat's
    winner (-1 on a miss), in place. `stats`, if given (the kernel only), a
    (4,) int64 tensor on the card that the kernel adds its counts to: the
    (lane, sphere) pairs whose miss test passed in a chunk of repeats, the
    candidates it resolved exactly, its resolve rounds (32 candidates a
    warp), and its (warp, chunk)s."""
    lanes, dev = _check_rays(o, d, bias, repeats)
    n = _check_cmat(cmat, dev)
    if index is not None:
        check_tensor("index", index, torch.int32, (repeats, *bias.shape), dev)
    if dev.type == "cpu":
        if stats is not None:
            raise ValueError("sweep_mma: stats count the kernel's work; the "
                             "plain version has none")
        return sweep_mma_plain(o, d, cmat, bias, repeats, index)
    if stats is not None:
        check_tensor("stats", stats, torch.int64, (4,), dev)
    out = torch.empty_like(bias)
    launch_raw("sweep_mma", dev, o, d, cmat, n, lanes, repeats, bias, out,
               index, stats)
    return out


def _dot(c, x, y, z, exact: bool) -> torch.Tensor:
    """(n, blocks, 32, 128) float32: the sphere centres `c` (n, 1, 1, 1) x3
    dotted with the lanes' (x, y, z). `exact`: rounded once to float32 (the
    products of float32 values are exact in float64, and their sum is
    rounded once more there before the float32 rounding), as the kernel's
    exact resolve takes it; else float32 products summed in float32."""
    if not exact:
        return (c[0] * x + c[1] * y) + c[2] * z
    f64 = torch.float64
    return ((c[0].to(f64) * x.to(f64) + c[1].to(f64) * y.to(f64))
            + c[2].to(f64) * z.to(f64)).to(torch.float32)


def sweep_mma_plain(o, d, cmat, bias, repeats: int = REPEATS, index=None,
                    exact_dots: bool = True):
    """The plain torch version of `sweep_mma`: the JAX mxu kernel's algebra
    (benchmarks/sweep_variants.py:170-198) in elementwise ops over (sphere,
    lane) planes, float32 but for the two dot products, which are the exact
    ones rounded to float32.
    `exact_dots=False` sums their float32 products in float32 instead, the
    JAX kernel's arithmetic: that moves the roots of grazing rays, and
    chip_smoke.py reports how far the kernel lies from it."""
    _check_rays(o, d, bias, repeats)
    n = _check_cmat(cmat, o.device)
    dev = o.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    col = lambda k: cmat[k].view(n, 1, 1, 1)  # noqa: E731
    centre, ccr = (col(0), col(1), col(2)), col(4)
    iota = torch.arange(n, dtype=torch.int32, device=dev).view(n, 1, 1, 1)
    ox, oy, oz = o
    oo = ox * ox + oy * oy + oz * oz
    oc = _dot(centre, ox, oy, oz, exact_dots)  # (n, blocks, 32, 128)
    acc = bias
    for r in range(repeats):
        dx, dy, dz = d[0] * _scale(r, dev), d[1], d[2]
        cd = _dot(centre, dx, dy, dz, exact_dots)
        od = ox * dx + oy * dy + oz * dz
        c = oo - (oc + oc) + ccr
        hb = od - cd
        sq = sqrt(hb * hb - c)
        t1 = -hb - sq
        t2 = -hb + sq
        t = torch.where(t1 >= 0.0, t1, t2)
        t = torch.where(t >= 0.0, t, big)
        best_t = t.amin(0)
        is_best = (t == best_t) & (best_t < big)
        best_i = torch.where(is_best, iota, n).amin(0)
        hit = best_i < n
        at = best_i.clamp(max=n - 1).long()
        w0 = torch.where(hit, cmat[0][at], zero)
        w3 = torch.where(hit, cmat[3][at], zero)
        idx = torch.where(hit, best_i, -1)
        acc = acc + (torch.where(best_t < big, best_t, zero) + w0 * 1e-6
                     + w3 * 1e-9 + idx.to(torch.float32) * 1e-3)
        if index is not None:
            index[r] = idx
    return acc


def run(name: str, call, bias: torch.Tensor, n: int, repeats: int):
    """(first output, ms per call): 8 chained calls (each output the next
    call's bias), best of 3, as benchmarks/sweep_variants.py:202-234, by
    the kernels' device time on a card (`elapsed_ms`)."""
    first = call(bias)
    state = {"out": bias}

    def chained():
        state["out"] = call(state["out"])

    best = elapsed_ms(chained, 8, bias.device, rounds=3)
    lanes = bias.numel() * repeats
    print(f"{name:10s}: {best:7.3f} ms  {best * 1e9 / (lanes * n):6.2f} "
          f"ps/(lane*cand)  [{lanes * n / 1e9:.2f} G cand/call]", flush=True)
    return first, best


def main(argv: list[str] | None = None) -> dict:
    """Times the three variants on the probe's inputs; returns {name:
    (output, ms per call)}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = probe_device(p.parse_args(argv).device)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in inputs(blocks=BLOCKS).items()}
    n = SPHERES
    spheres = [data[k][:n].contiguous() for k in ("cx", "cy", "cz", "r2")]
    cmat = data["cmat"][:, :n].contiguous()
    o, d, rep = data["o"], data["d"], REPEATS
    bias = torch.zeros((BLOCKS, TH, TW), dtype=torch.float32, device=dev)
    res = {
        "vpu": run("vpu", lambda b: sweep_vpu(o, d, *spheres, b, rep), bias,
                   n, rep),
        "vpu2carry": run("vpu2carry",
                         lambda b: sweep_vpu2(o, d, *spheres, b, rep), bias,
                         n, rep)}
    a = res["vpu"][0]
    print("max |vpu2 - vpu|:", float((res["vpu2carry"][0] - a).abs().max()))
    res["mma"] = run("mma", lambda b: sweep_mma(o, d, cmat, b, rep), bias, n,
                     rep)
    print("max |mma - vpu|:", float((res["mma"][0] - a).abs().max()))
    return res


if __name__ == "__main__":
    main()
