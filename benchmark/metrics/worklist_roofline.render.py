"""The worklist kernel's share of its roofline: 100 x the least time its
calls could take on an H100 SXM (benchmark/metrics/_worklist_cost.py, the
program's cost model of each call) over the kernel's device time by its
name in the device trace of the same frames (the render_lights mode's
last profiled frames). None without that trace or where no frame called
the kernel."""

import sys

from benchmark.metrics._worklist_cost import bound_s


def read(run):
    if run.traffic["mode"] != "render_lights":
        return None
    kernel_s = run.counters.get("worklist_kernel_s", 0.0)
    if kernel_s <= 0 or not run.counters.get("worklist_calls"):
        return None
    bound = bound_s(run.counters["worklist_ops"],
                    run.counters["worklist_bytes"])
    print(f"worklist_roofline.render: {run.counters['worklist_calls']:.0f} "
          f"calls, bound {bound * 1e3:.4f} ms against "
          f"{kernel_s * 1e3:.4f} ms of the kernel over "
          f"{run.counters['worklist_units']} frames", file=sys.stderr)
    return 100.0 * bound / kernel_s
