"""Device ms a frame in the worklist intersector (row 6: its precull and
csrc/worklist_intersect.cu): the `device_ns` of the program's `worklist`
spans (%globaltimer stamps at the span's ends in the stream's order),
over the window's last frames and the traced span's unprofiled ones (not
those of the cost count, benchmark/metrics/_worklist_cost.py). The
spans of camera rays, bounce rays and the light pdf's march steps all
count. None where no frame called the worklist."""

from benchmark.metrics._worklist_cost import window_frames


def read(run):
    if run.traffic["mode"] != "render_lights":
        return None
    tables = window_frames(run)
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/worklist") and "device_ns" in row]
    if not rows:
        return None
    return sum(row["device_ns"] for row in rows) / len(tables) / 1e6
