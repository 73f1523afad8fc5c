"""Device ms a frame of the program's hand-written kernels (the table
OWN_KERNELS in benchmark/modes/common.py)."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "render" or p is None:
        return None
    return p["own_ms"] / p["units"]
