"""msamples_per_s: every sample the window rendered, in millions, over the
window's seconds (the window ends with a device synchronize)."""


def read(run):
    w = run["window"]
    if not w.samples or w.seconds <= 0:
        return None
    return w.samples / w.seconds / 1e6
