"""Share of the (ray group, work item) pairs whose item the candidate
cull slab-tests after its cluster test: 100 x the `tested` counts of the
program's `precull` spans over their `keys` (`groups` x `items`), in the
window's last frames and the traced span's unprofiled ones. Says how
often the cull's pruning by item clusters engages. None where no frame
ran a precull or the spans carry no `tested` count."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/precull") and "tested" in row]
    pairs = sum(row["keys"] for row in rows)
    if not pairs:
        return None
    tested = sum(row["tested"] for row in rows)
    spills = sum(row.get("spills", 0) for row in rows)
    print(f"cull_tested_share.render: {tested} tested of {pairs} (group, "
          f"item) pairs, {spills} groups past the shared list, over "
          f"{len(tables)} frames", file=sys.stderr)
    return 100.0 * tested / pairs
