"""Run one cell of the benchmark of julia_raytracer_tpu_torch on the card.

    python3 benchmark/run.py --workload cornell-path8 --seed 7 --seconds 30 --trace 0

Reads the cell from BENCHMARK.json at the checkout's root, its
configuration from the file the cell's configuration names, its traffic
from benchmark/workloads/<traffic>.json, and the limits of its output
check from benchmark/limits/<cell>.json. The traffic's `mode` names the
mode (benchmark/modes/<mode>.py). With --trace 0 the result carries
the cell's end-to-end metrics; with --trace 1 its per-layer metrics,
each read by benchmark/metrics/<metric>.py. The last line of standard
output is one JSON object; the numbers the output check compared, each
with its limit, are the last lines of standard error, after the set-up's
host-clock spans.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and if the JAX package or JAX is loaded once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FORBIDDEN = ("jax", "jaxlib", "flax", "julia_raytracer_tpu")


def _caches() -> None:
    """The program's scene cache under TMPDIR (inside the checkout where
    TMPDIR is unset). Its only other cache, the nvcc build directory, is
    julia_raytracer_tpu_torch/csrc/_build in the checkout."""
    tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_cache", "tmp")
    os.environ["JRT_CACHE_DIR"] = os.path.join(tmp, "jrt_scene_cache")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None, device: str | None = None,
         traffic_overrides: dict | None = None) -> int:
    """The command line's entry. `device` and `traffic_overrides` are for
    the benchmark's own tests: they skip the look for a card and shrink
    the traffic; the command line never passes them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(ROOT, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    from benchmark.modes.common import Run, load_json

    traffic = dict(load_json("workloads", cell["traffic"]))
    traffic.update(traffic_overrides or {})
    limits = load_json("limits", args.workload)

    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("run.py: no CUDA device is available", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            print(f"run.py: {cell['chips']} CUDA devices wanted, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 3
        device = "cuda"
    run = Run(workload=args.workload, config=config, traffic=traffic,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=T_START, limits=limits)
    mode = importlib.import_module("benchmark.modes." + traffic["mode"])
    mode.run(run)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4

    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not _applies(m, args.workload):
                continue
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if _applies(m, args.workload)}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": all(c[3] for c in run.checks) and bool(run.checks),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in run.checks}
    print("spans: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.spans.items()),
          file=sys.stderr)
    for name, value, limit, ok in run.checks:
        print(f"check {name}: {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root first, and not the script's own folder
    sys.path[0] = ROOT
    sys.exit(main())
