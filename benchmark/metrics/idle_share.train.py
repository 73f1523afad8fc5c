"""Share of the wall time of the traced steps, run unprofiled, in which the
device ran nothing: 100 * (1 - device ms / wall ms)."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "train" or p is None:
        return None
    return 100.0 * (1.0 - p["device_ms"] / p["wall_ms"])
