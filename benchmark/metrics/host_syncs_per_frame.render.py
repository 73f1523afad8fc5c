"""The program's host syncs a frame over the traced frames (unprofiled):
the delta of trace_wavefront.host_syncs + regroup_intersect.host_syncs."""


def read(run):
    c = run.counters
    if run.traffic["mode"] != "render" or "host_syncs" not in c:
        return None
    return c["host_syncs"] / c["units"]
