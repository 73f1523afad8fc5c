"""Share of the (ray, element) pairs that the culled curve walk tests:
100 x the `tested` counts of the program's `curve_walk` spans over their
`rays` x `elements` (every ray against every line and point, what the
plain sweep tests), in the window's last frames and the traced span's
unprofiled ones. The base goes to standard error. None where no frame
walked curves."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render_curves":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/curve_walk") and "tested" in row]
    # rays x elements of each call: the elements are the same every call
    pairs = sum(row["rays"] * row["elements"] // row["n"] for row in rows)
    if not pairs:
        return None
    tested = sum(row["tested"] for row in rows)
    print(f"curve_tested_share.render: {tested} tested of {pairs} (ray, "
          f"element) pairs over {len(tables)} frames", file=sys.stderr)
    return 100.0 * tested / pairs
