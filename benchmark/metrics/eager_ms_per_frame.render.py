"""Device ms a frame of every device op outside the program's own kernels
(eager ATen ops: shading, the sort, the precull's slab tests)."""


def read(run):
    p = run.profile
    if run.traffic["mode"] != "render" or p is None:
        return None
    return (p["device_ms"] - p["own_ms"]) / p["units"]
