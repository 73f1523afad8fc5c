"""Device ms a frame in the work-item intersector's candidate cull and
its stable per-group sort: the `device_ns` of the program's `precull`
spans (CUDA events at the span's ends on the card; while the card is
the bottleneck, the device time of the work issued inside), over the
window's last frames and the traced span's unprofiled ones. None where
no frame ran a precull or the spans carry no `device_ns`."""

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/precull") and "device_ns" in row]
    if not rows:
        return None
    return sum(row["device_ns"] for row in rows) / len(tables) / 1e6
