"""Device ms a frame in the culled curve walk (csrc/curve_intersect.cu):
the `device_ns` of the program's `curve_walk` spans (%globaltimer stamps
at the span's ends in the stream's order, on eager and graphed bodies
alike), over the window's last frames and the traced span's unprofiled
ones. None where no frame walked curves."""

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render_curves":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/curve_walk") and "device_ns" in row]
    if not rows:
        return None
    return sum(row["device_ns"] for row in rows) / len(tables) / 1e6
