"""Device ms a frame in the light pdf's truncated march (its extra
closest-hit steps through the scene's intersector, and the terms they
add): the `device_ns` of the program's `light_march` spans (%globaltimer
stamps at the span's ends in the stream's order), over the window's last
frames and the traced span's unprofiled ones (not those of the cost
count, benchmark/metrics/_worklist_cost.py). None where no frame
marched."""

from benchmark.metrics._worklist_cost import window_frames


def read(run):
    if run.traffic["mode"] != "render_lights":
        return None
    tables = window_frames(run)
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/light_march") and "device_ns" in row]
    if not rows:
        return None
    return sum(row["device_ns"] for row in rows) / len(tables) / 1e6
