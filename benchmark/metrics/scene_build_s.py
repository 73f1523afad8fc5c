"""Seconds of the host-clock span around the program's Renderer(...) build
(flatten, BVH, lights, tables, kernel choice; the device scene's upload)."""


def read(run):
    return run.spans.get("scene_build")
