"""Share of the loop bodies that the shading kernel shaded: 100 x the
`shaded` counts of the program's `body` spans over their number, in the
window's last frames and the traced span's unprofiled ones, in the
render modes (`render`, `render_curves`). None where the program's body
spans carry no `shaded` count (a program without the kernel). The base
(bodies) goes to standard error."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] not in ("render", "render_curves"):
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/body") and "shaded" in row]
    bodies = sum(row["n"] for row in rows)
    if not bodies:
        return None
    shaded = sum(row["shaded"] for row in rows)
    print(f"fused_shade_share.render: {shaded} shaded of {bodies} bodies "
          f"over {len(tables)} frames", file=sys.stderr)
    return 100.0 * shaded / bodies
