"""setup_s: seconds from the start of the process to the first timed call
(import, the kernel library's load or build, the scene, the warm-up)."""


def read(run):
    return run["setup_s"]
