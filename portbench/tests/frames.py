"""Render fields that make a cell small enough for the plain path on the
CPU: one row of two 128 x 32 tiles, 16 spheres, meshes at 8 x 4."""

SMALL = {"width": 256, "height": 32, "sphere_count": 16, "disc_lat": 8,
         "disc_long": 4}

# Fewer steps per call of the triangle mixes: the plain brute-force sweep is
# slow on the CPU.
SMALL_MIX = {"tri32k.rows": {"steps_per_call": 4},
             "tri32k.converge": {"steps_per_call": 2},
             "tri32k-nee.converge": {"steps_per_call": 2}}

# SMALL's frame over a scene where NEE and MIS have work: at SMALL the one
# light of 16 meshes is far from everything the camera sees, no BSDF ray
# finds it, and a render without MIS differs by ~1e-6 of the image. With
# all 128 spheres at 4 x 4 and every 4th emissive, some 40 lanes a call
# weigh emission that BSDF rays found. One sample a step keeps it quick.
NEE_SMALL = dict(SMALL, sphere_count=128, disc_lat=4, disc_long=4,
                 emissive_every=4)
NEE_MIX = {"steps_per_call": 2, "spp_per_step": 1}
