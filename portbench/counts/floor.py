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
  * per touched pixel the accumulate and tonemap, per sample its sum;
  * under NEE per vertex that samples a light the cone sample, its weight
    and its accumulation, per such sample under MIS its balance weight,
    per shadow cast that must be made and hits a primitive that
    primitive's test (as an any-hit segment: nothing for the candidates a
    bounded walk could skip, so the yardstick reads alike whether a
    shadow ray is a full nearest-hit walk or a bounded any-hit cast), and
    per emission a BSDF ray found its balance weight. NEE's draws are in
    the draw pairs.
Bytes: the accumulation plane read and written and the display plane
written once per touched pixel, plus the scene read once.

Operation counts per item are frozen from the port's `chip_smoke.py`
(`OPS`, `PAIR_OPS`; read off csrc/pathtrace.cuh, sphere_pt.cuh and
triangle_pt.cuh), where every instruction counts as one operation. The
kernels build with -fmad=false, so the instruction rate is the peak. NEE's
items are read off csrc/pathtrace.cuh at commit 30f40dc in the same way
(a max_nan as a compare and a select, a load, a conversion, sqrtf, a
division, sinf and cosf as one each).
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
    # nee_cone (:1017-1071) with next_event (:1078-1089) and the pdf of the
    # Lambert sample (:1192-1193): the pick (:929-933) 6, the bound's 4
    # loads, the vector to it and d2 8, cone_solid_angle (:937-941) 11,
    # its normalize 10, cos_t and sin_t 8, phi 1, frame_z (:785-805) 20,
    # the cone's local direction 4 and its world form 15, the shading
    # normal's normalize 10, cos_s 7, E 1, the weight 3, the Lambert eval 4,
    # add_light's test and accumulation (:953-961) 10, the visibility test
    # 3, the shadow origin 6, the pdf 5, the MIS flag 3
    nee_cone=139,
    nee_mis=9,         # balance (:944-946) of the NEE sample, p_nee (:1045)
    # mis_emission_weight's cone form (:1097-1114, :1120) and its product
    # (:1273-1274): E 1, the bound's 4 loads, r 3, the vector to the
    # centre 9, d2 5, cone_solid_angle 11, p_nee 4, the weight 4, the
    # product 1, the MIS test 1
    mis_emission=43,
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
    nee = (counts.get("nee", 0) * OPS["nee_cone"]
           + counts.get("nee_mis", 0) * OPS["nee_mis"]
           + counts.get("shadow_hits", 0) * any_test
           + counts.get("mis_emission", 0) * OPS["mis_emission"])
    return (counts["samples"] * (OPS["ray"] + OPS["sample_sum"])
            + counts["pairs"] * PAIR_OPS[rng]
            + counts["hits"] * (test + fixed)
            + counts["any_hits"] * any_test
            + counts["scatters"] * OPS["scatter"]
            + counts["emissive"] * OPS["emit"]
            + counts["sky"] * OPS["sky_box"]
            + counts["sky_in"] * OPS["sky_setup"]
            + counts["sky_iters"] * OPS["sky_iter"]
            + counts["touches"] * OPS["accumulate"] + nee)


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
