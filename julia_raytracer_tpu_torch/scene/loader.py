"""Scene lookup helpers (the part of julia_raytracer_tpu/scene/loader.py
the renderer needs). Loading Yocto JSON/PLY scenes from disk is not
ported yet (ROADMAP.md queue 1, item 7)."""

from __future__ import annotations

from julia_raytracer_tpu_torch.scene.types import INVALID_ID, SceneData


def find_camera(scene: SceneData, name: str) -> int:
    """Camera lookup with Yocto fallback names; a 0-based index, or
    INVALID_ID when the scene has no camera."""
    if not scene.cameras:
        return INVALID_ID
    for candidate in [name, "default", "camera", "camera0", "camera1"]:
        for i, cam in enumerate(scene.cameras):
            if cam.name == candidate:
                return i
    return 0
