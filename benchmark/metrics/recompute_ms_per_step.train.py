"""Host ms a train step recomputing the fixed-trip loop's bodies in the
backward pass (the program's `body` spans under `train_step/backward`,
on autograd's thread on the card), over the window's last steps and the
traced span's unprofiled ones."""

from benchmark.metrics._units import ms_per_unit, window_units


def read(run):
    if run.traffic["mode"] != "train":
        return None
    tables = window_units(run, "train_step")
    if tables is None:
        return None
    return ms_per_unit(tables, lambda p: p.startswith("train_step/backward/")
                       and p.endswith("/body"))
