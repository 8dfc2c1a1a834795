"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY.md §4.5):
sharded render == single-device render; gradient psum training step."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import fraytracer_tpu as ft
from fraytracer_tpu.ops.march import MarchConfig
from fraytracer_tpu.parallel.mesh import (exposure_max_sharded, make_mesh,
                                          make_train_step, render_sharded)
from fraytracer_tpu.scene.generators import torus_csg_scene

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CFG = ft.RenderConfig(width=16, height=32, epsilon=0.02, length=30.0,
                      march=MarchConfig(max_steps=64))


@pytest.fixture(scope="module")
def scene():
    return ft.flatten(torus_csg_scene(seed=19, n_tori=24))


@pytest.fixture(scope="module")
def camera():
    return ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)


def test_sharded_render_matches_single(scene, camera):
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene, camera, CFG, mesh))
    single = np.asarray(ft.render(scene, camera, CFG))
    np.testing.assert_allclose(sharded, single, atol=1e-5)


def test_sharded_render_various_mesh_sizes(scene, camera):
    for n in (1, 2, 4):
        mesh = make_mesh(n)
        out = np.asarray(render_sharded(scene, camera, CFG, mesh))
        assert out.shape == (32, 16, 3)


def test_rows_must_divide(scene, camera):
    mesh = make_mesh(8)
    bad = ft.RenderConfig(width=16, height=30, epsilon=0.02, length=30.0)
    with pytest.raises(ValueError):
        render_sharded(scene, camera, bad, mesh)


def test_exposure_allreduce_max(scene, camera):
    mesh = make_mesh(8)
    img = render_sharded(scene, camera, CFG, mesh)
    got = float(exposure_max_sharded(img, mesh))
    want = float(jnp.max(img))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_step_decreases_loss_and_stays_replicated(scene, camera):
    mesh = make_mesh(8)
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    step = make_train_step(CFG, mesh, lr=1e-4)
    s1, l1 = step(scene, camera, target)
    s2, l2 = step(s1, camera, target)
    assert float(l2) < float(l1)
    assert bool(jnp.all(jnp.isfinite(l2)))
    # updated scene params differ from the originals (grads flowed)
    assert float(jnp.sum(jnp.abs(
        s1.mat_albedo - scene.mat_albedo))) > 0


def test_train_step_matches_single_device(scene, camera):
    """Sharded psum-gradient step == single-device step (same math)."""
    mesh = make_mesh(8)
    target = jnp.full((CFG.height, CFG.width, 3), 0.05, jnp.float32)
    lr = 1e-4
    step = make_train_step(CFG, mesh, lr=lr)
    s_sharded, l_sharded = step(scene, camera, target)

    def loss_fn(s):
        img = ft.render(s, camera, CFG)
        return jnp.sum((img - target) ** 2)

    l_single, g = jax.value_and_grad(loss_fn)(scene)
    np.testing.assert_allclose(float(l_sharded), float(l_single), rtol=1e-4)
    want_albedo = scene.mat_albedo - lr * g.mat_albedo
    np.testing.assert_allclose(np.asarray(s_sharded.mat_albedo),
                               np.asarray(want_albedo), atol=1e-5)


def test_train_step_chunked_overlap_matches_monolithic(scene, camera):
    """The chunked backward (per-chunk psum overlapped with later chunks'
    compute, the north-star collective-overlap mechanism) produces the
    same gradients/update as the monolithic all-at-once psum — only the
    floating-point summation order differs."""
    mesh = make_mesh(8)
    target = jnp.full((CFG.height, CFG.width, 3), 0.05, jnp.float32)
    lr = 1e-4
    s_mono, l_mono = make_train_step(CFG, mesh, lr=lr, grad_chunks=1)(
        scene, camera, target)
    s_chunk, l_chunk = make_train_step(CFG, mesh, lr=lr, grad_chunks=4)(
        scene, camera, target)
    np.testing.assert_allclose(float(l_chunk), float(l_mono), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_chunk.prim_params),
                    jax.tree.leaves(s_mono.prim_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_chunk.mat_albedo),
                               np.asarray(s_mono.mat_albedo), atol=1e-6)


def test_spectral_sharded_matches_single(scene, camera):
    from fraytracer_tpu.ops.wavefront import WavefrontConfig, render_spectral
    from fraytracer_tpu.parallel.mesh import render_spectral_sharded
    wcfg = WavefrontConfig(depth=2, epsilon=0.02, length=30.0,
                           march=MarchConfig(max_steps=48))
    mesh = make_mesh(8)
    sharded, _counts = render_spectral_sharded(
        scene, camera, 16, 32, wcfg, mesh)
    single = np.asarray(render_spectral(scene, camera, 16, 32, wcfg))
    np.testing.assert_allclose(np.asarray(sharded), single, atol=1e-5)


def test_spectral_rebalanced_matches_and_balances(camera):
    """Cross-chip wavefront rebalancing (SURVEY §2c ray redistribution):
    the rebalanced render must produce the same image, and the live-ray
    load entering later rounds must be measurably more even across the
    mesh than with device-local queues."""
    from fraytracer_tpu.ops.wavefront import WavefrontConfig
    from fraytracer_tpu.parallel.mesh import render_spectral_sharded

    # asymmetric scene: a dielectric sphere near the top rows spawns
    # secondary rays on few devices only -> device-local queues imbalance
    sc = ft.flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0.9, 0), 0.8, material=ft.dielectric(ior=1.5)),
            ft.plane((0, 1, 0), -1.4, material=ft.solid(0.7, 0.7, 0.7)),
        ),
        lights=[ft.directional_light((0.3, -1.0, 0.5), (1.0, 1.0, 1.0))],
        background=(0.05, 0.05, 0.08)))
    wcfg = WavefrontConfig(depth=3, epsilon=1e-3, length=30.0,
                           march=MarchConfig(max_steps=96))
    mesh = make_mesh(8)
    img_local, c_local = render_spectral_sharded(
        sc, camera, 16, 32, wcfg, mesh, rebalance=False)
    img_reb, c_reb = render_spectral_sharded(
        sc, camera, 16, 32, wcfg, mesh, rebalance=True)
    np.testing.assert_allclose(np.asarray(img_reb), np.asarray(img_local),
                               atol=1e-5)

    def imbalance(counts):  # max/mean of per-device live rays, round >= 1
        c = np.asarray(counts, np.float64)[:, 1:]
        tot = c.sum(axis=0)
        live = tot > 0
        return float((c.max(axis=0)[live]
                      / (tot[live] / c.shape[0])).max())
    assert imbalance(c_reb) <= imbalance(c_local) + 1e-6
    # secondary rounds exist and the rebalanced load is near-perfectly even
    assert np.asarray(c_local)[:, 1].sum() > 0
    assert imbalance(c_reb) < 1.5


def test_sharded_render_with_pallas_backend(scene, camera):
    """shard_map composes with the pallas kernel (interpret mode on the
    virtual CPU mesh)."""
    cfg = ft.RenderConfig(
        width=16, height=32, epsilon=0.02, length=30.0,
        march=MarchConfig(max_steps=64, backend="pallas_interpret"))
    mesh = make_mesh(4)
    sharded = np.asarray(render_sharded(scene, camera, cfg, mesh))
    single = np.asarray(ft.render(scene, camera, ft.RenderConfig(
        width=16, height=32, epsilon=0.02, length=30.0,
        march=MarchConfig(max_steps=64))))
    np.testing.assert_allclose(sharded, single, atol=1e-4)


def test_sharded_kernel_render_marches_the_single_render_tiles(scene,
                                                               camera):
    """On the kernel path each shard marches its rows in the whole-image
    render's screen blocks (32-row shards of a 64² frame hold whole 32×32
    blocks), so the sharded image is the one-device image; the jitted
    sharded program is built once per (config, mesh)."""
    from fraytracer_tpu.parallel.mesh import _render_sharded_fn
    cfg = ft.RenderConfig(
        width=64, height=64, epsilon=0.02, length=30.0,
        march=MarchConfig(max_steps=64, backend="pallas_interpret"))
    mesh = make_mesh(2)
    single = np.asarray(ft.render(scene, camera, cfg))
    assert (single > 0).any(axis=-1).mean() > 0.1
    sharded = np.asarray(render_sharded(scene, camera, cfg, mesh))
    np.testing.assert_allclose(sharded, single, atol=1e-6)
    hits = _render_sharded_fn.cache_info().hits
    render_sharded(scene, camera, cfg, mesh)
    assert _render_sharded_fn.cache_info().hits == hits + 1
