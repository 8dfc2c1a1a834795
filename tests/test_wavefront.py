"""Wavefront spectral integrator tests (BASELINE configs 3-4): diffuse
equivalence with the plain renderer, mirror reflection, dispersion."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import fraytracer_tpu as ft
from fraytracer_tpu.ops.march import MarchConfig
from fraytracer_tpu.ops.wavefront import WavefrontConfig, render_spectral

MARCH = MarchConfig(max_steps=128)


def test_diffuse_scene_matches_plain_render():
    """With only solid materials, the spectral wavefront must reproduce the
    plain renderer (bin filters sum to 1; depth never matters)."""
    scene = ft.flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0, 0), 1.0, material=ft.solid(0.8, 0.3, 0.2)),
            ft.box((1.4, 0, 0), (0.4, 0.4, 0.4), 0.05,
                   material=ft.solid(0.2, 0.4, 0.9)),
        ),
        background=(0.1, 0.1, 0.1),
        lights=(ft.directional_light((-0.4, -1, 0.8), (0.6, 0.6, 0.6)),),
    ))
    cam = ft.look_at((0, 0, -6), (0, 0, 0))
    W = H = 24
    plain = np.asarray(ft.render(
        scene, cam, ft.RenderConfig(width=W, height=H, epsilon=0.01,
                                    length=30.0, march=MARCH)))
    spec = np.asarray(render_spectral(
        scene, cam, W, H, WavefrontConfig(depth=2, epsilon=0.01,
                                          length=30.0, march=MARCH)))
    np.testing.assert_allclose(spec, plain, atol=2e-5)


def test_spectral_benchmark_scene_smoke():
    """The glass+mirror benchmark variant renders finite, reports a
    plausible ray count (> primary), and actually spawns bounce rays."""
    from fraytracer_tpu.ops.wavefront import render_spectral_with_stats
    from fraytracer_tpu.scene.generators import spectral_csg_scene
    scene = ft.flatten(spectral_csg_scene(seed=19, n_tori=64))
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    W = H = 32
    img, n = render_spectral_with_stats(
        scene, cam, W, H, WavefrontConfig(depth=3, epsilon=0.01,
                                          length=30.0, march=MARCH))
    img = np.asarray(img)
    assert np.isfinite(img).all() and img.min() >= 0.0
    # primary round = W*H rays; specular tori must add bounce rays
    assert float(n) > W * H * 1.05


def test_spectral_gradients_finite():
    """jax.grad through the glass+mirror benchmark variant is finite and
    reaches geometry and glass indices — including through the total
    internal reflection lanes of the inner bounces."""
    from fraytracer_tpu.scene.generators import spectral_csg_scene
    scene = ft.flatten(spectral_csg_scene(seed=19, n_tori=64))
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    cfg = WavefrontConfig(depth=4, epsilon=0.01, length=30.0, march=MARCH)
    g = jax.grad(lambda s: jnp.sum(
        render_spectral(s, cam, 24, 24, cfg) ** 2))(scene)
    for name, leaf in (("torus", g.prim_params["torus"]),
                       ("ior", g.mat_ior)):
        a = np.asarray(leaf)
        assert np.isfinite(a).all(), name
        assert np.abs(a).max() > 0, name


def test_mirror_reflects_scene():
    """A mirror floor under a red sphere shows red in the reflection."""
    scene = ft.flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0.8, 0), 0.8, material=ft.solid(0.9, 0.1, 0.1)),
            ft.plane((0, 1, 0), 0.0, material=ft.mirror(0.9)),
        ),
        background=(0.05, 0.05, 0.05),
        lights=(ft.directional_light((0.2, -1, 0.3), (1.0, 1.0, 1.0)),),
    ))
    cam = ft.look_at((0, 1.2, -5), (0, 0.4, 0))
    W = H = 32
    cfg = WavefrontConfig(depth=3, epsilon=0.005, length=40.0, march=MARCH)
    img1 = np.asarray(render_spectral(
        scene, cam, W, H, WavefrontConfig(depth=1, epsilon=0.005,
                                          length=40.0, march=MARCH)))
    img3 = np.asarray(render_spectral(scene, cam, W, H, cfg))
    # depth-3 adds reflected energy below the horizon (lower half) that
    # depth-1 cannot have
    lower1, lower3 = img1[20:], img3[20:]
    added = (lower3 - lower1)
    assert float(added.max()) > 0.01
    # and the added reflection is red-dominant somewhere (red sphere)
    red_excess = added[..., 0] - added[..., 2]
    assert float(red_excess.max()) > 0.005
    assert np.all(np.isfinite(img3))


def test_dielectric_disperses_wavelengths():
    """Dispersion separates wavelength bins: viewed through a glass sphere,
    an emissive white bar lands on different image points per bin, so some
    pixels receive only a subset of bins → strong chroma.  With dispersion
    set to 0 the same scene shows much less chroma."""
    def build(dispersion):
        return ft.flatten(ft.Scene(
            root=ft.union(
                ft.sphere((0, 0, 0), 1.0,
                          material=ft.dielectric(ior=1.5,
                                                 dispersion=dispersion)),
                ft.box((0, 0, 3.0), (0.15, 2.0, 0.05),
                       material=ft.emissive(5.0, 5.0, 5.0)),
            ),
            background=(0.0, 0.0, 0.0),
        ))
    cam = ft.look_at((0, 0, -6), (0, 0, 0))
    W = H = 48
    cfg = WavefrontConfig(depth=4, epsilon=0.005, length=40.0, march=MARCH)
    img_disp = np.asarray(render_spectral(build(0.08), cam, W, H, cfg))
    img_flat = np.asarray(render_spectral(build(0.0), cam, W, H, cfg))
    assert np.all(np.isfinite(img_disp))
    chroma_disp = (img_disp.max(-1) - img_disp.min(-1)).max()
    chroma_flat = (img_flat.max(-1) - img_flat.min(-1)).max()
    assert chroma_disp > 2.0 * chroma_flat + 1e-3, (chroma_disp, chroma_flat)


def test_energy_conservation_bound():
    """No bounce may create energy: total image energy with a mirror is
    bounded by the same scene fully diffuse."""
    def build(mat):
        return ft.flatten(ft.Scene(
            root=ft.sphere((0, 0, 0), 1.0, material=mat),
            background=(0.1, 0.1, 0.1),
            lights=(ft.directional_light((0, 0, 1), (1.0, 1.0, 1.0)),),
        ))
    cam = ft.look_at((0, 0, -5), (0, 0, 0))
    cfg = WavefrontConfig(depth=4, epsilon=0.01, length=30.0, march=MARCH)
    diffuse = np.asarray(render_spectral(build(ft.solid(1, 1, 1)), cam,
                                         16, 16, cfg))
    mirrored = np.asarray(render_spectral(build(ft.mirror(0.95)), cam,
                                          16, 16, cfg))
    assert mirrored.sum() <= diffuse.sum() * 1.05


def test_inactive_queue_is_stable():
    """Empty scene: all rays miss in round 1; later rounds are no-ops."""
    scene = ft.flatten(ft.Scene(root=ft.sphere((99, 99, 99), 0.1),
                                background=(0.2, 0.3, 0.4)))
    cam = ft.look_at((0, 0, -5), (0, 0, 0))
    img = np.asarray(render_spectral(
        scene, cam, 8, 8,
        WavefrontConfig(depth=4, epsilon=0.01, length=20.0, march=MARCH)))
    np.testing.assert_allclose(
        img, np.broadcast_to([0.2, 0.3, 0.4], (8, 8, 3)), atol=2e-5)


def test_block_compact_key_prefers_dense_active_blocks():
    """Block-granular overflow policy (advisor r4 low): when class-0 lanes
    span more blocks than capacity, the kept set must be the DENSEST
    active blocks — a count-based key, not the per-block min class (which
    ranked a 1-active/127-dead block equal to a fully active one and then
    dropped by position)."""
    import jax.numpy as jnp
    from fraytracer_tpu.ops.wavefront import block_compact_key
    B = 4          # small block for the test
    # blocks: [all class0] [1×class0+3 dead] [all class0] [all low] [dead]
    klass = jnp.asarray(
        [0, 0, 0, 0,   0, 2, 2, 2,   0, 0, 0, 0,   1, 1, 1, 1,  2, 2, 2, 2],
        jnp.int32)
    key = block_compact_key(klass, B)
    order = np.argsort(np.asarray(key), kind="stable")
    # capacity 2 blocks: must keep the two fully-active blocks (0 and 2)
    assert set(order[:2].tolist()) == {0, 2}
    # low-throughput block outranks the sparse active one? No: one
    # meaningful lane (weight 2) + dead vs four low lanes (weight 1 each):
    # 2 < 4 → the low block ranks ahead — energy-count semantics
    assert order[2] == 3 and order[3] == 1 and order[4] == 4
    # fully dead block is always last
    assert np.asarray(key)[4] == 0 and (np.asarray(key)[:4] < 0).all()


@pytest.mark.parametrize("layout", ["bounce", "first_round"])
def test_compact_queue_blocks_match_lane_partition(layout):
    """Block-granular queue compaction (the compiled-kernel path of
    ``_bounce`` and of the spectral first round) keeps exactly the blocks
    the lane partition ranks first — the ``block_compact_key`` order,
    stable among equal keys — and moves each kept block whole."""
    from fraytracer_tpu.ops.march import BLOCK
    from fraytracer_tpu.ops.wavefront import (RayQueue, block_compact_key,
                                              compact_queue)
    rng = np.random.default_rng(0 if layout == "bounce" else 1)
    C = 4 * BLOCK
    if layout == "bounce":
        # children A then B of one round: scattered survivors
        active = rng.uniform(size=2 * C) < 0.3
    else:
        # first round: reflection children of every pixel, then mostly
        # dead refraction children (pixel-major bins)
        active = np.concatenate([rng.uniform(size=C) < 0.6,
                                 rng.uniform(size=C) < 0.05])
    thr = rng.uniform(0.0, 0.2, size=2 * C).astype(np.float32)
    low = active & (thr < 0.05)
    klass = np.where(active, low.astype(np.int32), 2).astype(np.int32)
    lanes = np.arange(2 * C)
    q = RayQueue(
        origin=jnp.asarray(np.stack([lanes] * 3, -1), jnp.float32),
        direction=jnp.zeros((2 * C, 3), jnp.float32),
        pixel=jnp.asarray(lanes, jnp.int32),
        wl=jnp.zeros((2 * C,), jnp.int32),
        throughput=jnp.asarray(thr),
        length=jnp.ones((2 * C,), jnp.float32),
        inside=jnp.zeros((2 * C,), bool),
        active=jnp.asarray(active))
    out = compact_queue(q, jnp.asarray(klass), C, blocks=True)
    # predicted: rank the 2C/BLOCK blocks by their lane-class weight,
    # stable; keep the best C/BLOCK, in that order
    key = np.asarray(block_compact_key(jnp.asarray(klass), BLOCK))
    np.testing.assert_array_equal(
        key, -(2 - klass.reshape(-1, BLOCK)).sum(axis=1))
    keep = np.argsort(key, kind="stable")[:C // BLOCK]
    want = (keep[:, None] * BLOCK + np.arange(BLOCK)[None]).reshape(-1)
    np.testing.assert_array_equal(np.asarray(out.pixel), want)
    np.testing.assert_array_equal(np.asarray(out.active), active[want])
    np.testing.assert_array_equal(np.asarray(out.origin)[:, 0], want)
    # the lane path keeps every class-0 lane first, in order
    lane_out = compact_queue(q, jnp.asarray(klass), C, blocks=False)
    first = np.where(klass == 0)[0][:C]
    np.testing.assert_array_equal(
        np.asarray(lane_out.pixel)[:len(first)], first)
