"""triangle_pt_roofline: the least time of one scheduler step of
triangle_pt by the work count (counts/floor.py, counted by the reference
on this cell's inputs; harness.work_bound: a call's steps read the scene
once) over the device time per step (CUDA events around every call of the
traced run's window, over its steps), in percent."""


def read(run):
    floor, w = run["floor"], run["window"]
    if run["kernel"] != "triangle_pt" or floor is None or not w.device_ms:
        return None
    return 100.0 * floor["seconds"] / (w.device_ms * 1e-3 / w.launches)
