"""Share of the light pdf march's full-width queries that carry a live
ray: 100 x the `marching` counts of the program's `light_march` spans
(the lane-steps whose lane still marched when the step was issued) over
their `lanes` x `steps` (every step queries every lane of its body), in
the window's last frames and the traced span's unprofiled ones (not
those of the cost count, benchmark/metrics/_worklist_cost.py). The base
and the spans' `truncated` lanes go to standard error. None where no
frame marched."""

import sys

from benchmark.metrics._worklist_cost import window_frames


def read(run):
    if run.traffic["mode"] != "render_lights":
        return None
    tables = window_frames(run)
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/light_march") and "marching" in row]
    # lanes x steps of each call: the budget is the same every call
    queries = sum(row["lanes"] * row["steps"] // row["n"] for row in rows)
    if not queries:
        return None
    marching = sum(row["marching"] for row in rows)
    print(f"march_live_share.render: {marching} live of {queries} "
          f"lane-steps, {sum(row['truncated'] for row in rows)} of "
          f"{sum(row['lanes'] for row in rows)} lanes truncated, "
          f"{sum(row['emitter_hits'] for row in rows)} emitter hits over "
          f"{len(tables)} frames", file=sys.stderr)
    return 100.0 * marching / queries
