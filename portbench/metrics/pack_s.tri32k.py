"""pack_s.tri32k: seconds of the triangle scene's set-up on the host: the
tessellation and TriangleBuffers.from_scene (bounds, slab groups,
certain-hit data and shell buffers), to the buffers on the device."""


def read(run):
    return run.get("pack_s")
