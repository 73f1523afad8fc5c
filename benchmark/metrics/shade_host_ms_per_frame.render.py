"""Host ms a frame in the loop bodies' own code, their intersect calls
left out: the self time of the program's `body` spans (the shading's
eager ops as the host issues them), over the window's last frames and
the traced span's unprofiled ones."""

from benchmark.metrics._units import ms_per_unit, window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    return ms_per_unit(tables, lambda p: p.endswith("/body"), "self_ns")
