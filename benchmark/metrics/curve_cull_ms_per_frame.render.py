"""Device ms a frame in the cull of the curve elements (the work items'
cull, csrc/candidate_cull.cu, over the lines' and points' boxes): the
`device_ns` of the program's `precull` spans in a scene of curves, over
the window's last frames and the traced span's unprofiled ones. Their
`spills` (groups past the cull's shared list) go to standard error. None
where no frame ran a precull."""

import sys

from benchmark.metrics._units import window_units


def read(run):
    if run.traffic["mode"] != "render_curves":
        return None
    tables = window_units(run, "frame")
    if tables is None:
        return None
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/precull") and "device_ns" in row]
    if not rows:
        return None
    print(f"curve_cull_ms_per_frame.render: {sum(r['n'] for r in rows)} "
          f"culls, {sum(r.get('spills', 0) for r in rows)} groups past the "
          f"shared list, over {len(tables)} frames", file=sys.stderr)
    return sum(row["device_ns"] for row in rows) / len(tables) / 1e6
