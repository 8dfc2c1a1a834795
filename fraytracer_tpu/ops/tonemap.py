"""Tone mapping: auto-exposure → gamma → dithered 8-bit quantization.

Vectorized re-expression of the reference's output pipeline
(``Image.toColors``, Image.fs:37-50 + ``FColor.fs:43-55``):

* auto-exposure: divide by the global max channel, clamped ≥ 0.01
  (Image.fs:40-43) — on one device this is one ``jnp.max`` reduction; across chips
  it is an ``all-reduce max`` (see ``parallel/``), the one real sync point
  in the pipeline (SURVEY.md §3.3),
* gamma: per-channel ``pow(c, 1/γ)`` (FColor.gammaInverse, FColor.fs:50-55),
* dithered quantization: ``c · 254.5 + U[0,1)`` rounded and clamped to 255
  (FColor.toColor, FColor.fs:43-48) with a counter-based JAX PRNG replacing
  the mutable ``System.Random``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def auto_exposure_scale(image: Array) -> Array:
    """Global max channel clamped ≥ 0.01 (Image.fs:40-43)."""
    return jnp.maximum(jnp.max(image), 0.01)


def tonemap(image: Array, key: Array, gamma: float = 2.2,
            max_value: Array | None = None) -> Array:
    """Linear RGB [..., 3] → dithered uint8 [..., 3].

    ``max_value`` lets multi-chip renderers pass in an all-reduced global
    max; defaults to this image's own max.
    """
    if max_value is None:
        max_value = auto_exposure_scale(image)
    normalized = image / max_value
    gamma_mapped = jnp.power(jnp.maximum(normalized, 0.0),
                             jnp.float32(1.0 / gamma))
    dither = jax.random.uniform(key, image.shape, jnp.float32)
    q = jnp.floor(gamma_mapped * 254.5 + dither + 0.5)
    return jnp.clip(q, 0, 255).astype(jnp.uint8)
