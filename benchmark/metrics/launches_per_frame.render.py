"""Device launches (kernels, copies, fills) the profiler recorded over the traced
frames, a frame."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "render" or p is None:
        return None
    return p["launches"] / p["units"]
