"""Host ms a frame in the wavefront loop's tests (the program's
`loop_test` spans): each reads the live-lane count back, so the host
waits there for the card to finish the work queued before it. Over the
window's last frames and the traced span's unprofiled ones."""

from benchmark.metrics._units import ms_per_unit, window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    return ms_per_unit(tables, lambda p: p.endswith("/loop_test"))
