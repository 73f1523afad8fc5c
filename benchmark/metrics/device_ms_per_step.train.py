"""Device ms a train step (forward, recompute and backward) over the
traced steps."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "train" or p is None:
        return None
    return p["device_ms"] / p["units"]
