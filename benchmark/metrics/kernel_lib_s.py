"""Seconds of set-up the program spent on its kernel libraries: its
`lib_build` (nvcc or g++, a checkout's first run) and `lib_load` (the
ctypes load) spans, from its set-up table."""


def read(run):
    from julia_raytracer_tpu_torch.utils import timing

    setup = getattr(timing, "setup", None)
    if setup is None:
        return None
    rows = [row for name, row in setup().items()
            if name in ("lib_build", "lib_load")]
    if not rows:
        return None
    return sum(row["ns"] for row in rows) / 1e9
