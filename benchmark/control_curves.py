"""The output check's control and a planted fault for a cell of the
render_curves mode (scenes of lines and points), read on the card at the
cell's own size (the benchmark's runs do not run this):

    python3 benchmark/control_curves.py --workload tree-path8 --seeds 11,12,13 --frames 730

benchmark/control.py's render control, over the plain reference that
traces lines and points (benchmark/reference/curves.py): `control`, the
reference put in the program's place and run in bfloat16, the precision
below the configuration's float32, compared with the float32 reference
by the cell's own numbers; `altered`, the float32 reference in the
program's place with its radiance read 2% high. Prints one JSON line a
seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(config: dict, traffic: dict, seed: int, frames: int,
            device: str) -> dict:
    import torch

    from benchmark.modes import render, render_curves
    from benchmark.modes.common import build_scene

    desc = build_scene(config)
    width = height = traffic["resolution"]
    if desc["camera"]["aspect"] != 1.0:
        raise ValueError("the control sizes square frames only")
    pixels = render.check_pixels(seed, width * height, traffic["check_pixels"])

    def ref(dtype=None):
        return render_curves.reference(desc, traffic, pixels, frames, seed,
                                       width, height, device, dtype)

    def as_program(mean, hits, gain=1.0):
        return {"image": mean[:, :4] * [gain, gain, gain, 1.0],
                "albedo": mean[:, 4:7], "normal": mean[:, 7:], "hits": hits}

    want = ref()
    return {"control": render.compare(as_program(*ref(torch.bfloat16)),
                                      *want, frames),
            "altered": render.compare(as_program(*want, gain=1.02), *want,
                                      frames)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control_curves.py: no CUDA device is available",
              file=sys.stderr)
        return 3
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    from benchmark.modes.common import load_json

    traffic = load_json("workloads", cell["traffic"])
    if traffic["mode"] != "render_curves":
        print(f"control_curves.py: {args.workload} is not a render_curves "
              "cell (benchmark/control.py reads the others)", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control(config, traffic, seed, args.frames, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root first, and not the script's own folder
    sys.path[0] = ROOT
    sys.exit(main())
