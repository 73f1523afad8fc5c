"""Host ms a train step in its backward pass (the program's
`train_step/backward` span around torch.autograd.grad, the checkpoint's
recompute included), over the window's last steps and the traced span's
unprofiled ones."""

from benchmark.metrics._units import ms_per_unit, window_units


def read(run):
    if run.traffic["mode"] != "train":
        return None
    tables = window_units(run, "train_step")
    if tables is None:
        return None
    return ms_per_unit(tables, lambda p: p == "train_step/backward")
