"""What the span readers share: the program's closed units (its frames
or train steps, julia_raytracer_tpu_torch/utils/timing.py) that started
in the run's window or after it, with no profiler session active: the
window's last frames or steps and the traced span's unprofiled ones."""


def window_units(run, name: str) -> list[dict] | None:
    """The tables ({span path: row}) of those units named `name`; None
    where the program keeps no units (a tree whose timing module has no
    `units`) or none qualify."""
    if "setup_s" not in run.end_to_end:
        return None
    from julia_raytracer_tpu_torch.utils import timing

    units = getattr(timing, "units", None)
    if units is None:
        return None
    # the window's start on the program's clock (perf_counter ns)
    t0_ns = (run.t_start + run.end_to_end["setup_s"]) * 1e9
    tables = [u["table"] for u in units() if u["name"] == name
              and not u["profiled"] and u["start_ns"] >= t0_ns]
    return tables or None


def ms_per_unit(tables: list[dict], keep, field: str = "ns") -> float:
    """Sum of `field` over the rows whose path `keep` accepts, in ms a
    unit."""
    total = sum(row[field] for t in tables for path, row in t.items()
                if keep(path))
    return total / len(tables) / 1e6
