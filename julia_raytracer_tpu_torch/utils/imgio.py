"""Host-side image loading for scene textures: PNG (LDR, sRGB) and
Radiance HDR (linear). The loading half of
julia_raytracer_tpu/utils/imgio.py, copied.

The decoders are imported lazily, as in the JAX package: PIL for PNG,
OpenCV (cv2) for HDR. A scene with textures loads only where they are
installed.
"""

from __future__ import annotations

import numpy as np


def load_png_rgba(path: str) -> np.ndarray:
    """PNG -> uint8 [H, W, 4] (RGBA)."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def load_hdr_rgba(path: str) -> np.ndarray:
    """Radiance .hdr -> float32 [H, W, 4] (linear, alpha=1)."""
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if bgr is None:
        raise IOError(f"failed to load HDR image: {path}")
    rgb = np.asarray(bgr, dtype=np.float32)[..., ::-1]
    alpha = np.ones(rgb.shape[:2] + (1,), dtype=np.float32)
    return np.concatenate([rgb, alpha], axis=-1)
