"""The worklist kernel's least work in the frames of the traced span
(csrc/worklist_intersect.cu in the program, row 6), from the program's
own cost model: each call under utils/roofline.py count_cost reports
ops/worklist_intersect.py call_cost, which is
utils/kernel_flops.py worklist_intersect_cost of the (ray, cluster)
pairs the call needs (needed_pairs: the clusters of each ray's lists
whose box it enters before its closest hit, whatever the walk), a
triangle test (40 fp32 operations) for each of their triangles, the rays
in and the hits out, and the packed tables and the lists read once a
call. The least time on an H100 SXM is the larger of the bytes at 3.35
TB/s and the operations at 67 TFLOP/s.

`measure` runs after the window, at the end of the render_lights mode's
traced span."""

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# the kernel in the device trace
KERNEL = "::worklist_intersect_kernel("


def measure(run, one_unit, units: int) -> None:
    """The kernel's device time: `units` frames under a torch.profiler
    session that traces the device alone (a session that records no
    device time is tried again, up to three in all). Its least work: as
    many frames again, each under count_cost, not profiled (a profiler
    session over them would record every op of the count); the readers
    of the window's frames leave them out ("worklist_cost_units"). Sets
    run.counters "worklist_kernel_s" (the device seconds of the ops named
    KERNEL), "worklist_units", and "worklist_calls", "worklist_ops" and
    "worklist_bytes" (the calls' model)."""
    import torch

    from julia_raytracer_tpu_torch.utils import roofline

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(units):
                one_unit()
            run.sync()
        events = [e for e in prof.events() if e.device_type == cuda]
        if events:
            run.counters.update(worklist_units=units, worklist_kernel_s=sum(
                e.time_range.elapsed_us() for e in events
                if KERNEL in e.name) / 1e6)
            break
    else:
        return
    calls = ops = n_bytes = 0.0
    for _ in range(units):
        _, counter = roofline.count_cost(one_unit)
        c, o, b = counter.kernels.get("worklist_intersect", (0, 0, 0))
        calls, ops, n_bytes = calls + c, ops + o, n_bytes + b
    run.counters.update(worklist_cost_units=units, worklist_calls=calls,
                        worklist_ops=ops, worklist_bytes=n_bytes)


def window_frames(run):
    """The window readers' frames (metrics/_units.py window_units) less
    the frames that `measure` ran under the cost count, the last ones;
    None where there are none."""
    from benchmark.metrics._units import window_units

    tables = window_units(run, "frame")
    drop = run.counters.get("worklist_cost_units", 0)
    if tables is None or len(tables) <= drop:
        return None
    return tables[:len(tables) - drop]


def bound_s(ops: float, n_bytes: float) -> float:
    """The least seconds on the card for that work."""
    return max(n_bytes / PEAK_BYTES_S, ops / PEAK_OPS_S)
