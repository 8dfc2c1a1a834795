"""Spectral optics tests (BASELINE config 3; reference Light.fs:28-59
physics, Materials.fs dispersion data)."""
import numpy as np
import jax.numpy as jnp
import pytest

from fraytracer_tpu.ops import spectral


def test_bin_rgb_partitions_white():
    """An equal-energy spectrum across all bins reconstructs ~white."""
    total = spectral.BIN_RGB.sum(axis=0)
    np.testing.assert_allclose(total, [1.0, 1.0, 1.0], atol=1e-5)


def test_bin_rgb_hue_ordering():
    """Short wavelengths are blue-dominant, long are red-dominant."""
    first = spectral.BIN_RGB[0]   # 400 nm
    last = spectral.BIN_RGB[-1]   # 700 nm
    assert first[2] > first[0]    # blue > red at violet end
    assert last[0] > last[2]      # red > blue at red end


def test_cauchy_dispersion_monotone():
    """n(λ) decreases with wavelength for B > 0 (normal dispersion)."""
    ior_ab = jnp.array([1.5, 0.01])
    wl = jnp.arange(spectral.NUM_BINS)
    n = np.asarray(spectral.cauchy_ior(ior_ab, wl))
    assert np.all(np.diff(n) < 0)
    assert n[0] > 1.5 and n[-1] > 1.5


def test_fresnel_normal_incidence():
    """Head-on: R = ((n1-n2)/(n1+n2))²  (Light.fs:40-52 physics)."""
    d = jnp.array([[0.0, 0.0, 1.0]])
    n = jnp.array([[0.0, 0.0, -1.0]])
    R, refl, refr, tir = spectral.fresnel(d, n, jnp.array([1.0]),
                                          jnp.array([1.5]))
    np.testing.assert_allclose(float(R[0]), ((1 - 1.5) / (1 + 1.5)) ** 2,
                               atol=1e-4)
    assert not bool(tir[0])
    np.testing.assert_allclose(np.asarray(refl[0]), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(refr[0]), [0, 0, 1], atol=1e-6)


def test_fresnel_grazing_reflectance_to_one():
    theta = np.radians(89.5)
    d = jnp.array([[np.sin(theta), 0.0, np.cos(theta)]], jnp.float32)
    n = jnp.array([[0.0, 0.0, -1.0]])
    R, *_ = spectral.fresnel(d, n, jnp.array([1.0]), jnp.array([1.5]))
    assert float(R[0]) > 0.9


def test_total_internal_reflection():
    """Glass→air beyond the critical angle (~41.8° for n=1.5)."""
    theta = np.radians(60.0)
    d = jnp.array([[np.sin(theta), 0.0, np.cos(theta)]], jnp.float32)
    n = jnp.array([[0.0, 0.0, -1.0]])
    R, _refl, _refr, tir = spectral.fresnel(d, n, jnp.array([1.5]),
                                            jnp.array([1.0]))
    assert bool(tir[0])
    np.testing.assert_allclose(float(R[0]), 1.0, atol=1e-6)


@pytest.mark.parametrize("theta_deg, n1, n2", [
    (60.0, 1.5, 1.0), (30.0, 1.0, 1.5)])
def test_fresnel_gradients_finite(theta_deg, n1, n2):
    """Gradients of every Fresnel output w.r.t. the direction and both
    indices stay finite, on a total-internal-reflection lane too (the
    refracted cosine there is clamped, not differentiated through 0)."""
    import jax
    theta = np.radians(theta_deg)
    d = jnp.array([[np.sin(theta), 0.0, np.cos(theta)]], jnp.float32)
    n = jnp.array([[0.0, 0.0, -1.0]])

    def f(d, a, b):
        R, refl, refr, _ = spectral.fresnel(d, n, a, b)
        return jnp.sum(R) + jnp.sum(refl) + jnp.sum(refr)

    grads = jax.grad(f, argnums=(0, 1, 2))(
        d, jnp.array([n1]), jnp.array([n2]))
    for g in grads:
        assert np.isfinite(np.asarray(g)).all()


def test_snell_refraction_angle():
    """sin θt = (n1/n2) sin θi."""
    theta_i = np.radians(30.0)
    d = jnp.array([[np.sin(theta_i), 0.0, np.cos(theta_i)]], jnp.float32)
    n = jnp.array([[0.0, 0.0, -1.0]])
    _R, _refl, refr, _ = spectral.fresnel(d, n, jnp.array([1.0]),
                                          jnp.array([1.5]))
    refr = np.asarray(refr[0])
    refr = refr / np.linalg.norm(refr)
    sin_t = abs(refr[0])
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, atol=1e-4)


def test_reflection_is_mirror():
    """Incident at 45°: reflected direction mirrors across the normal."""
    d = jnp.array([[np.sqrt(0.5), 0.0, np.sqrt(0.5)]], jnp.float32)
    n = jnp.array([[0.0, 0.0, -1.0]])
    _R, refl, *_ = spectral.fresnel(d, n, jnp.array([1.0]), jnp.array([1.5]))
    np.testing.assert_allclose(np.asarray(refl[0]),
                               [np.sqrt(0.5), 0, -np.sqrt(0.5)], atol=1e-5)


def test_schlick_close_to_fresnel():
    for deg in (0.0, 30.0, 60.0):
        th = np.radians(deg)
        d = jnp.array([[np.sin(th), 0.0, np.cos(th)]], jnp.float32)
        n = jnp.array([[0.0, 0.0, -1.0]])
        R, *_ = spectral.fresnel(d, n, jnp.array([1.0]), jnp.array([1.5]))
        Rs = spectral.schlick(d, n, jnp.array([1.0]), jnp.array([1.5]))
        assert abs(float(R[0]) - float(Rs[0])) < 0.03
