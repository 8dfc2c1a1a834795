"""Spectral ray optics: wavelength bins, dispersive IOR, Fresnel equations.

Implements the reference's *stated but unrealized* spectral capability
(``README.md:7``: "a ray-test consists of a start-position, a direction and a
wave-length and produces an intensity, e.g. optical dispersion") whose only
code traces are the vestigial ``Light.fs`` (Fresnel equations, visible
spectrum bands, ``Light.fs:12-59``) and the commented-out refraction-index
catalogue ``Materials.fs:6-60``.  BASELINE config 3 pins it down: 8
wavelength bins with dispersive glass.

Everything is batched over rays; wavelengths are bin *indices* into static
tables so a ray carries one int32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import dot

Array = jax.Array

# 8 visible-spectrum bins (BASELINE config 3).  Bin centers in micrometres,
# violet → red; spans the reference's THz bands (Light.fs:19-26: 789 THz
# violet … 400 THz red ⇒ 380 nm … 750 nm).
NUM_BINS = 8
WAVELENGTHS_UM = np.linspace(0.40, 0.70, NUM_BINS).astype(np.float32)

# Per-bin linear-RGB response, a coarse CIE-style fit: each row is the RGB
# color of monochromatic light at that bin center, scaled so the rows sum
# to ~(1,1,1) — an equal-energy spectrum reconstructs white.
def _bin_rgb_table() -> np.ndarray:
    lam = WAVELENGTHS_UM * 1000.0  # nm

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    # Gaussian-lobe fit of CIE-1931-like RGB primaries
    r = 1.056 * g(lam, 599.8, 37.9, 31.0) + 0.362 * g(lam, 442.0, 16.0, 26.7) \
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    gch = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    b = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    rgb = np.stack([r, gch, b], axis=-1)
    rgb = np.maximum(rgb, 0.0)
    rgb /= np.maximum(rgb.sum(axis=0, keepdims=True), 1e-6)  # columns sum→1
    return rgb.astype(np.float32)


BIN_RGB = _bin_rgb_table()  # [NUM_BINS, 3]


def bin_rgb(wl: Array) -> Array:
    """RGB filter of wavelength-bin indices ``wl [...]`` → ``[..., 3]``."""
    return jnp.asarray(BIN_RGB)[wl]


def cauchy_ior(ior_ab: Array, wl: Array) -> Array:
    """Dispersive refractive index n(λ) = A + B/λ² (λ in µm).

    ``ior_ab [..., 2]`` are per-material Cauchy coefficients (the device-side
    realization of the reference's refraction-index catalogue,
    Materials.fs:6-60); ``wl [...]`` are bin indices.
    """
    lam = jnp.asarray(WAVELENGTHS_UM)[wl]
    return ior_ab[..., 0] + ior_ab[..., 1] / (lam * lam)


def fresnel(direction: Array, normal: Array, n1: Array, n2: Array):
    """Fresnel reflectance + reflected/refracted directions (batched).

    The physically-correct form of the reference's ``Light.fresnel``
    (Light.fs:28-59): s/p-polarized reflectance averaged, mirror reflection
    ``d - 2(d·n)n``, Snell refraction, with total internal reflection
    handled (reflectance → 1, refracted direction invalid/unused).

    Args: ``direction [...,3]`` unit incident (pointing *into* the surface),
    ``normal [...,3]`` unit, oriented against the incident ray
    (``d·n < 0``), ``n1``/``n2 [...]`` media indices (incident/transmit).
    Returns ``(R [...], reflect_dir [...,3], refract_dir [...,3],
    tir [...])``.
    """
    cosi = -dot(direction, normal)                    # > 0 by orientation
    cosi = jnp.clip(cosi, 1e-6, 1.0)
    eta = n1 / n2
    sin2t = eta * eta * jnp.maximum(1.0 - cosi * cosi, 0.0)
    tir = sin2t > 1.0
    # floored above 0: sqrt's derivative at 0 is infinite, and the
    # clamp's zero cotangent times it is NaN on every TIR lane
    cost = jnp.sqrt(jnp.maximum(1.0 - sin2t, 1e-12))

    rs = ((n1 * cosi - n2 * cost) / (n1 * cosi + n2 * cost + 1e-12)) ** 2
    rp = ((n2 * cosi - n1 * cost) / (n2 * cosi + n1 * cost + 1e-12)) ** 2
    R = jnp.where(tir, 1.0, 0.5 * (rs + rp))

    reflect_dir = direction + 2.0 * cosi[..., None] * normal
    refract_dir = (eta[..., None] * direction
                   + (eta * cosi - cost)[..., None] * normal)
    return R, reflect_dir, refract_dir, tir


def schlick(direction: Array, normal: Array, n1: Array, n2: Array) -> Array:
    """Schlick's approximation of Fresnel reflectance (the reference's own
    TODO, Light.fs:61-62) — cheaper, used by the fast path if requested."""
    cosi = jnp.clip(-dot(direction, normal), 0.0, 1.0)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosi) ** 5
