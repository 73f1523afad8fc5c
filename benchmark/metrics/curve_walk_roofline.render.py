"""The curve walk kernel's share of its roofline: 100 x the least time
its calls could take on an H100 SXM (benchmark/metrics/_curve_cost.py,
from each call's `rays` and `elements` in the program's `curve_walk`
spans) over the kernel's device time by its name in the device trace of
the same frames (`walk_kernel_s`, the render_curves mode's last profiled
frames). None without that trace or where no frame walked curves."""

import sys

from benchmark.metrics._curve_cost import bound_s


def read(run):
    if run.traffic["mode"] != "render_curves":
        return None
    kernel_s = run.counters.get("walk_kernel_s", 0.0)
    if kernel_s <= 0 or "setup_s" not in run.end_to_end:
        return None
    from julia_raytracer_tpu_torch.utils import timing

    units = getattr(timing, "units", None)
    if units is None:
        return None
    t0_ns = (run.t_start + run.end_to_end["setup_s"]) * 1e9
    tables = [u["table"] for u in units() if u["name"] == "frame"
              and u["profiled"] and u["start_ns"] >= t0_ns]
    # the frames of the session that timed the kernel: the last ones
    tables = tables[-run.counters["walk_kernel_units"]:]
    rows = [row for t in tables for path, row in t.items()
            if path.endswith("/curve_walk")]
    if not rows:
        return None
    bound = bound_s(sum(r["rays"] for r in rows),
                    sum(r["elements"] for r in rows))
    print(f"curve_walk_roofline.render: {sum(r['n'] for r in rows)} calls, "
          f"bound {bound * 1e3:.4f} ms against {kernel_s * 1e3:.4f} ms of "
          f"the kernel over {len(tables)} frames", file=sys.stderr)
    return 100.0 * bound / kernel_s
