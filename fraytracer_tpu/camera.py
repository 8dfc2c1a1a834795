"""Pinhole camera: orthonormal frame + batched pixel→ray generation.

Re-expression of the reference camera (``Camera.fs``) with two deliberate
fixes (SURVEY.md §7 non-goals):

* field-of-view is taken in **degrees** and converted properly — the
  reference's ``Lens.create`` (Camera.fs:10-14) interprets its argument as
  radians while the driver passes ``60.0`` (Program.fs:21), silently
  producing a negative near-plane;
* the near-plane half-size is ``tan(fov/2)`` (correct pinhole geometry)
  rather than ``sin(fov/2)``.

The camera is a pytree of jnp leaves, so camera parameters are themselves
differentiable (pose/fov optimization in inverse rendering).
Also provides an orthographic camera (BASELINE config 1).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from .types import Rays, normalize, pytree_dataclass

Array = jax.Array


@pytree_dataclass
class Camera:
    """Pinhole camera frame (reference ``Camera`` record, Camera.fs:16-22):
    position + forward + up/right scaled by the near-plane half-size.
    ``ortho_scale > 0`` switches to an orthographic projection with that
    world-space half-height."""

    position: Array       # [3]
    forward: Array        # [3] unit
    up_scaled: Array      # [3] up * near_plane_half_size
    right_scaled: Array   # [3] right * near_plane_half_size
    ortho_scale: Array    # [] 0.0 → perspective


def look_at(position, target, up=(0.0, 1.0, 0.0), fov_degrees: float = 60.0,
            ortho_scale: float = 0.0) -> Camera:
    """Build a camera frame (reference ``Camera.lookAt``, Camera.fs:33-42).
    Left-handed like the reference: right = up × forward."""
    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    forward = normalize(target - position)
    right = normalize(jnp.cross(up, forward))
    true_up = jnp.cross(forward, right)
    # Orthographic cameras keep unit up/right; the world-space extent comes
    # from ortho_scale at ray-generation time.
    half = 1.0 if ortho_scale > 0.0 else math.tan(
        math.radians(float(fov_degrees)) * 0.5)
    return Camera(
        position=position,
        forward=forward,
        up_scaled=true_up * jnp.float32(half),
        right_scaled=right * jnp.float32(half),
        ortho_scale=jnp.float32(ortho_scale),
    )


def pixel_grid_uv(width: int, height: int):
    """Uniform pixel coordinates for an image grid, row 0 = top.

    Like the reference's ``ImageSize.getUniformPixelPos`` (Image.fs:17-23),
    divides by max(W, H) so the scale is uniform (aspect preserved), but
    samples pixel *centers* (+0.5).  Returns (u, v) arrays [H, W] with v
    increasing upward.
    """
    m = float(max(width, height))
    x = (jnp.arange(width, dtype=jnp.float32) + 0.5) / m
    y = (jnp.arange(height, dtype=jnp.float32)[::-1] + 0.5) / m
    u = jnp.broadcast_to(x[None, :], (height, width))
    v = jnp.broadcast_to(y[:, None], (height, width))
    return u, v


def camera_rays(camera: Camera, width: int, height: int,
                epsilon, length) -> Rays:
    """Generate the full [H, W] primary-ray batch (reference
    ``Camera.uniformPixelToRay``, Camera.fs:44-54, vectorized)."""
    u, v = pixel_grid_uv(width, height)
    # NDC in [-1, 1] along the max dimension, so fov spans the full image
    # width: edge ray angle = atan(tan(fov/2)) = fov/2.
    ndc_u = 2.0 * (u - 0.5 * width / max(width, height))
    ndc_v = 2.0 * (v - 0.5 * height / max(width, height))
    offset = (ndc_u[..., None] * camera.right_scaled
              + ndc_v[..., None] * camera.up_scaled)

    is_ortho = camera.ortho_scale > 0.0
    persp_dir = normalize(camera.forward + offset)
    persp_origin = jnp.broadcast_to(camera.position, (height, width, 3))
    ortho_origin = camera.position + offset * camera.ortho_scale
    ortho_dir = jnp.broadcast_to(camera.forward, (height, width, 3))

    origin = jnp.where(is_ortho, ortho_origin, persp_origin)
    direction = jnp.where(is_ortho, ortho_dir, persp_dir)
    return Rays(
        origin=origin,
        direction=direction,
        length=jnp.full((height, width), length, jnp.float32),
        epsilon=jnp.full((height, width), epsilon, jnp.float32),
    )
