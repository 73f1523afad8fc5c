"""Device launches the profiler recorded a train step."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "train" or p is None:
        return None
    return p["launches"] / p["units"]
