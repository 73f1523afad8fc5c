"""Host ms a frame at the wavefront loop's compaction boundaries: the
program's `compact` and `expand` spans (packing the survivors into a
narrower state, scattering the narrow loop's outputs back). Over the
window's last frames and the traced span's unprofiled ones."""

from benchmark.metrics._units import ms_per_unit, window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    return ms_per_unit(
        tables, lambda p: p.endswith("/compact") or p.endswith("/expand"))
