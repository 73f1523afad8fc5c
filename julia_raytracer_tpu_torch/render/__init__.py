"""Renderer layer: lights, BSDF dispatch, integrators, accumulation state."""
