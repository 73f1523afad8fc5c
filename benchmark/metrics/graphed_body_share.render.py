"""Share of the loop bodies that a CUDA graph ran: 100 x the `graphed`
counts of the program's `body` spans over their number, in the window's
last frames and the traced span's unprofiled ones. None where the
program's body spans carry no `graphed` count. The base (bodies) goes
to standard error."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/body") and "graphed" in row]
    bodies = sum(row["n"] for row in rows)
    if not bodies:
        return None
    graphed = sum(row["graphed"] for row in rows)
    print(f"graphed_body_share.render: {graphed} graphed of {bodies} bodies "
          f"over {len(tables)} frames", file=sys.stderr)
    return 100.0 * graphed / bodies
