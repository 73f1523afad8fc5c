"""The output check's control and planted faults, read on the card at a
cell's own size (the benchmark's runs do not run this):

    python3 benchmark/control.py --workload cornell-path8 --seeds 11,12,13 --frames 150
    python3 benchmark/control.py --workload cornell-train --seeds 11,12,13

The control is the plain reference put in the program's place and run in
bfloat16, the precision below the configuration's float32, compared with
the float32 reference by the cell's own numbers. For a train cell two
planted faults are read the same way, each in the float32 reference put
in the program's place: `half` (the step's loss and gradients over the
first half of the pixels, the mean taken over them), `altered` (each
step's loss read 1% high) and `unchanged` (each step's loss right, its
tables returned unchanged). Prints one JSON line a seed and reading.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render_control(config: dict, traffic: dict, seed: int,
                   frames: int, device: str) -> dict:
    import torch

    from benchmark.modes import render
    from benchmark.modes.common import build_scene

    desc = build_scene(config)
    width, height = traffic["resolution"], traffic["resolution"]
    if desc["camera"]["aspect"] != 1.0:
        raise ValueError("the control sizes square frames only")
    pixels = render.check_pixels(seed, width * height, traffic["check_pixels"])
    ref = render.reference(desc, traffic, pixels, frames, seed, width, height,
                           device)
    low = render.reference(desc, traffic, pixels, frames, seed, width, height,
                           device, torch.bfloat16)
    prog = {"image": low[0][:, :4], "albedo": low[0][:, 4:7],
            "normal": low[0][:, 7:], "hits": low[1]}
    return {"control": render.compare(prog, ref[0], ref[1], frames)}


def train_control(config: dict, traffic: dict, seed: int,
                  device: str) -> dict:
    import torch

    from benchmark.modes import train
    from benchmark.modes.common import build_scene

    desc = build_scene(config)
    width = height = traffic["resolution"]
    k = traffic["check_steps"]
    color0, emission0 = train.start_tables(desc, seed, traffic["perturb"])
    target = torch.as_tensor(train.target_image(seed, width, height),
                             device=device)

    def judged(losses, tables):
        """The output check's numbers of a run that returned `losses` and
        `tables`, judged as the benchmark judges the program's."""
        starts = [(color0, emission0)] + tables[1:k]
        ref = train.reference(desc, traffic, target, starts, seed, width,
                              height, device)
        got = train.judge(losses, tables, *ref, traffic["lr"])
        del got["steps"]
        return got

    def in_place(**kw):
        return train.trajectory(desc, traffic, target, color0, emission0,
                                seed, width, height, device, **kw)

    out = {"control": judged(*in_place(dtype=torch.bfloat16)),
           "half": judged(*in_place(half=True))}
    losses, tables = in_place()
    out["altered"] = judged([x * 1.01 for x in losses], tables)
    # the loss of each step taken right, the tables returned unchanged
    still = [tables[0]] * (k + 1)
    ref = train.reference(desc, traffic, target, still[:k], seed, width,
                          height, device)
    out["unchanged"] = judged(ref[0], still)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA device is available", file=sys.stderr)
        return 3
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    from benchmark.modes.common import load_json

    traffic = load_json("workloads", cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if traffic["mode"] == "render":
            got = render_control(config, traffic, seed, args.frames,
                                 args.device)
        else:
            got = train_control(config, traffic, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root first, and not the script's own folder
    sys.path[0] = ROOT
    sys.exit(main())
