"""Share of the lane slots the loop bodies ran that held a live path:
100 x the live lanes each body's loop test read over the state's width,
summed over the program's `body` spans of the window's last frames and
the traced span's unprofiled ones. The base (lane slots) goes to
standard error."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/body") and "width" in row]
    width = sum(row["width"] for row in rows)
    if not width:
        return None
    live = sum(row["live"] for row in rows)
    print(f"live_lane_share.render: {live} live of {width} lane slots "
          f"over {len(tables)} frames", file=sys.stderr)
    return 100.0 * live / width
