"""Share of the (ray group, work item) pairs that the candidate cull
keeps: 100 x the `candidates` counts (finite keys) of the program's
`precull` spans over their `groups` x `items`, in the window's last
frames and the traced span's unprofiled ones. The base (pairs) goes to
standard error. None where no frame ran a precull."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/precull") and "candidates" in row]
    pairs = sum(row["keys"] for row in rows)
    if not pairs:
        return None
    kept = sum(row["candidates"] for row in rows)
    print(f"candidate_share.render: {kept} candidates of {pairs} (group, "
          f"item) pairs over {len(tables)} frames", file=sys.stderr)
    return 100.0 * kept / pairs
