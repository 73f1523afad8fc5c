"""Camera ray generation (thin-lens + orthographic), port of
julia_raytracer_tpu/ops/camera.py: pixel jitter, tent filter, lens disk."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.utils.vecmath import (
    normalize, transform_direction, transform_point,
)


class CameraArrays(NamedTuple):
    frame: torch.Tensor  # f32 [4, 3]
    lens: torch.Tensor  # f32 0-d
    film: torch.Tensor
    aspect: torch.Tensor
    focus: torch.Tensor
    aperture: torch.Tensor
    orthographic: bool


def sample_disk(ruv):
    """Polar disk sample."""
    r = torch.sqrt(ruv[..., 1])
    phi = 2.0 * math.pi * ruv[..., 0]
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r], dim=-1)


def eval_camera(cam: CameraArrays, image_uv, lens_uv):
    """image_uv, lens_uv: [N, 2] -> (origin [N,3], direction [N,3])."""
    film_x = torch.where(cam.aspect >= 1.0, cam.film, cam.film * cam.aspect)
    film_y = torch.where(cam.aspect >= 1.0, cam.film / cam.aspect, cam.film)
    zeros = torch.zeros_like(lens_uv[..., 0])

    if not cam.orthographic:
        q = torch.stack(
            [
                film_x * (0.5 - image_uv[..., 0]),
                film_y * (image_uv[..., 1] - 0.5),
                cam.lens.expand_as(image_uv[..., 0]),
            ],
            dim=-1,
        )
        dc = -normalize(q)
        e = torch.stack(
            [
                lens_uv[..., 0] * cam.aperture / 2.0,
                lens_uv[..., 1] * cam.aperture / 2.0,
                zeros,
            ],
            dim=-1,
        )
        p = dc * (cam.focus / torch.abs(dc[..., 2]))[..., None]
        d = normalize(p - e)
    else:
        scale = 1.0 / cam.lens
        qx = film_x * (0.5 - image_uv[..., 0]) * scale
        qy = film_y * (image_uv[..., 1] - 0.5) * scale
        e = torch.stack(
            [
                -qx + lens_uv[..., 0] * cam.aperture / 2.0,
                -qy + lens_uv[..., 1] * cam.aperture / 2.0,
                zeros,
            ],
            dim=-1,
        )
        p = torch.stack([-qx, -qy, -cam.focus.expand_as(qx)], dim=-1)
        d = normalize(p - e)
    origin = transform_point(cam.frame, e)
    direction = transform_direction(cam.frame, d)
    return origin, direction


def sample_camera(cam: CameraArrays, ij, image_size, puv, luv, tent: bool):
    """Pixel-jittered camera ray.

    ij: [N, 2] integer pixel coords; image_size: (w, h); puv/luv: [N, 2]
    uniforms. With `tent`, puv is warped by the tent filter."""
    w, h = image_size
    if tent:
        f = torch.where(
            puv < 0.5,
            torch.sqrt(2.0 * puv) - 1.0,
            1.0 - torch.sqrt(2.0 - 2.0 * puv),
        )
        puv = 2.0 * f + 0.5
    uv = torch.stack(
        [
            (ij[..., 0].to(torch.float32) + puv[..., 0]) / w,
            (ij[..., 1].to(torch.float32) + puv[..., 1]) / h,
        ],
        dim=-1,
    )
    return eval_camera(cam, uv, sample_disk(luv))
