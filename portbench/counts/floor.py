"""The least work a path-tracing step must do, and the peaks it is
divided by: the yardstick of the kernels' roofline shares.

The work is counted by the reference (reference/tracer.py `Counts`) on the
cell's own inputs, never by the program, so that the bound reads the same
whatever implements the step:
  * per sample its draws, at the sampler's cost per pair, and its primary
    ray;
  * per segment the test of the primitive it hits and the hit's fixed work
    (a segment that misses tests nothing here; its sky is counted), per
    any-hit segment that hits its primitive's test, per diffuse vertex the
    scatter, per emissive hit the emission;
  * per sky evaluation the direction-box test, inside the box the plane
    point and every escape iteration;
  * per touched pixel the accumulate and tonemap, per sample its sum.
Bytes: the accumulation plane read and written and the display plane
written once per touched pixel, plus the scene read once.

Operation counts per item are frozen from the port's `chip_smoke.py`
(`OPS`, `PAIR_OPS`; read off csrc/pathtrace.cuh, sphere_pt.cuh and
triangle_pt.cuh), where every instruction counts as one operation. The
kernels build with -fmad=false, so the instruction rate is the peak.
"""

from __future__ import annotations

OPS = dict(
    ray=30,            # primary direction: NDC, camera transform, normalize
    sphere=24,         # a sphere candidate whose line meets the ray
    nearest_fixed=20,  # the winning sphere's hit point and normal
    anyhit=19,         # a sphere tested by the any-hit sweep
    moller=62,         # one Moller-Trumbore candidate with its valid test
    tri_fixed=27,      # the winning triangle's normal and barycentrics
    scatter=70,        # frame, cosine sample, albedo, roulette, cast origin
    emit=10,           # the emission term and its accumulation
    sky_box=8,         # the Mandelbrot direction-box test
    sky_setup=60,      # inside the box: sqrt, two arctangents, the point
    sky_iter=9,        # one escape iteration
    accumulate=30,     # accumulate and tonemap of one touched pixel
    sample_sum=3,      # sum += c per sample
)
# One draw pair: threefry a block of 20 rounds; Philox (rng "tpu_hw") half
# of a 98-operation block and two selects.
PHILOX_BLOCK_OPS = 98
PAIR_OPS = {"threefry": 125, "tpu_hw": PHILOX_BLOCK_OPS / 2 + 2}
# Per primitive kind: (its nearest-hit test, the hit's fixed work, its
# any-hit test).
PRIMITIVE = {"sphere": (OPS["sphere"], OPS["nearest_fixed"], OPS["anyhit"]),
             "triangle": (OPS["moller"], OPS["tri_fixed"], OPS["moller"])}
# Bytes per touched pixel: accum (4 floats) read and written, output (3
# floats) written.
PIXEL_BYTES = 44

# fp32 instructions per second outside the tensor cores of one H100 SXM:
# the data sheet's 67 TFLOP/s counts an FMA as two operations, so 33.5e12
# instructions; and its 3.35 TB/s of HBM3.
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12


def floor_ops(counts: dict, kind: str, rng: str) -> float:
    """Operations of the traced lanes in `counts` (reference/tracer.py
    Counts.totals(); `touches` the pixel touches they cover) for a scene of
    `kind` primitives drawing with sampler `rng`."""
    test, fixed, any_test = PRIMITIVE[kind]
    return (counts["samples"] * (OPS["ray"] + OPS["sample_sum"])
            + counts["pairs"] * PAIR_OPS[rng]
            + counts["hits"] * (test + fixed)
            + counts["any_hits"] * any_test
            + counts["scatters"] * OPS["scatter"]
            + counts["emissive"] * OPS["emit"]
            + counts["sky"] * OPS["sky_box"]
            + counts["sky_in"] * OPS["sky_setup"]
            + counts["sky_iters"] * OPS["sky_iter"]
            + counts["touches"] * OPS["accumulate"])


def scene_bytes(kind: str, objects: int, triangles: int = 0) -> int:
    """The scene read once: spheres' centre, r^2 and albedo (7 floats);
    triangles' vertex and two edges plus three corner normals (18 floats)
    and each mesh's albedo (3 floats)."""
    if kind == "sphere":
        return 7 * 4 * objects
    return 18 * 4 * triangles + 3 * 4 * objects


def bound_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(the least seconds, what bounds them: "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launch_bound(counts: dict, kind: str, rng: str, samples_per_launch: int,
                 pixels_per_launch: int, nbytes_scene: int):
    """(seconds, bound by) of one launch, whose samples do on average the
    work of the traced lanes in `counts`."""
    scale = samples_per_launch / max(counts["samples"], 1)
    ops = floor_ops(counts, kind, rng) * scale
    nbytes = pixels_per_launch * PIXEL_BYTES + nbytes_scene
    return bound_seconds(ops, nbytes)
