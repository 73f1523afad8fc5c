"""The output check's control and planted faults for a cell of the
render_lights mode (scenes of many emissive quads), read on the card at
the cell's own size (the benchmark's runs do not run this):

    python3 benchmark/control_lights.py --workload manylights-path8 --seeds 4145876873,2772182231,859302640 --frames 100

Over the plain reference whose light pdf works in blocks
(benchmark/reference/lights.py), with each light's quads listed in the
program's order, compared with the float32 reference by the cell's own
numbers: `control`, the reference put in the program's place and run in
bfloat16, the precision below the configuration's float32; `altered`,
the float32 reference in the program's place with its radiance read 2%
high; `march0`, the program itself with the light pdf's march cut to no
extra step (each direction's pdf from its first hit alone), `frames`
frames from the first. Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(config: dict, traffic: dict, seed: int, frames: int,
            device: str) -> dict:
    import torch

    from benchmark.modes import render, render_lights
    from benchmark.modes.common import build_scene, to_program_scene
    from julia_raytracer_tpu_torch.render.renderer import (
        Renderer, make_trace_state,
    )

    desc = build_scene(config)
    if desc["camera"]["aspect"] != 1.0:
        raise ValueError("the control sizes square frames only")
    width = height = traffic["resolution"]
    pixels = render.check_pixels(seed, width * height, traffic["check_pixels"])

    # the planted fault: the program with no extra march step
    scene = to_program_scene(desc)
    p = render_lights.params(traffic, seed, light_pdf_extra_steps=0)
    renderer = Renderer(scene, p, device=device)
    state = make_trace_state(scene, p, device=device)
    for _ in range(frames):
        renderer.trace_samples(state)
    cut = render_lights.program_pixels(state, pixels)
    order = render_lights.light_order(renderer)
    del renderer, state
    if device == "cuda":
        torch.cuda.empty_cache()

    def ref(dtype=None):
        return render_lights.reference(desc, traffic, pixels, frames, seed,
                                       width, height, device, order, dtype)

    def as_program(mean, hits, gain=1.0):
        return {"image": mean[:, :4] * [gain, gain, gain, 1.0],
                "albedo": mean[:, 4:7], "normal": mean[:, 7:], "hits": hits}

    want = ref()
    return {"control": render.compare(as_program(*ref(torch.bfloat16)),
                                      *want, frames),
            "altered": render.compare(as_program(*want, gain=1.02), *want,
                                      frames),
            "march0": render.compare(cut, *want, frames)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control_lights.py: no CUDA device is available",
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
    if traffic["mode"] != "render_lights":
        print(f"control_lights.py: {args.workload} is not a render_lights "
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
