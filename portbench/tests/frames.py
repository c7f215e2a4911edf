"""Render fields that make a cell small enough for the plain path on the
CPU: one row of two 128 x 32 tiles, 16 spheres, meshes at 8 x 4."""

SMALL = {"width": 256, "height": 32, "sphere_count": 16, "disc_lat": 8,
         "disc_long": 4}

# Fewer steps per call of the triangle mixes: the plain brute-force sweep is
# slow on the CPU.
SMALL_MIX = {"tri32k.rows": {"steps_per_call": 4},
             "tri32k.converge": {"steps_per_call": 2}}
