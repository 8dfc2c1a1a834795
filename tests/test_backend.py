"""March backend selection, the GPU kernel's lowering, block takes and the
scripts' compile cache — all checked on the CPU.

The Triton-route kernels lower to Triton IR on any host (only turning that
IR into GPU code needs the card), so lowering them here for the ``cuda``
platform catches unsupported operations and non-power-of-two blocks
before a chip run does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fraytracer_tpu as ft
from fraytracer_tpu.ops.march import (BLOCK, MarchConfig, block_take, march,
                                      march_occlusion, march_surface,
                                      resolve_backend)
from fraytracer_tpu.scene.generators import torus_csg_scene
from fraytracer_tpu.utils.compile_cache import (REPO_CACHE,
                                                compile_cache_dir)


@pytest.mark.parametrize("platform, want", [
    ("cpu", "jnp"), ("gpu", "pallas")])
def test_auto_backend_follows_platform(platform, want):
    assert resolve_backend("auto", platform) == want


def test_auto_backend_rejects_unknown_platform():
    with pytest.raises(ValueError, match="no march backend"):
        resolve_backend("auto", "metal")
    with pytest.raises(ValueError, match="unknown march backend"):
        resolve_backend("mosaic")
    # explicit choices pass through on any platform
    for b in ("jnp", "pallas", "pallas_interpret"):
        assert resolve_backend(b, "cpu") == b
    # the default config marches with jnp on this (CPU) host
    assert MarchConfig().backend == "auto"
    assert resolve_backend(MarchConfig().backend) == "jnp"


def test_compile_cache_dir_honours_env():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) \
        == "/x/cache"
    assert compile_cache_dir({}) == REPO_CACHE
    assert REPO_CACHE.endswith(".jax_cache")


def test_block_take_moves_whole_blocks():
    n = 4 * BLOCK
    x = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    idx = jnp.asarray([2, 0, 2], jnp.int32)
    out = np.asarray(block_take(x, idx))
    xb = np.asarray(x).reshape(4, BLOCK, 3)
    np.testing.assert_array_equal(out.reshape(3, BLOCK, 3), xb[[2, 0, 2]])
    flags = jnp.arange(n) % 3 == 0
    np.testing.assert_array_equal(
        np.asarray(block_take(flags, idx)).reshape(3, BLOCK),
        np.asarray(flags).reshape(4, BLOCK)[[2, 0, 2]])


def _rays(w, h):
    cam = ft.look_at((0, 0, -10), (0, 0, 0))
    rays = ft.camera_rays(cam, w, h, 0.01, 30.0)
    return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)


_GPU = MarchConfig(backend="pallas", max_steps=64)


def _smooth_scene():
    return ft.flatten(ft.Scene(root=ft.union(
        ft.smooth_union(0.3, ft.sphere((0, 0, 0), 1.0),
                        ft.sphere((0.8, 0.3, 0), 0.7)),
        ft.capsule((-2, -1, 0), (-2, 1, 0), 0.3),
        ft.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2),
        ft.triangle((-1, 1.5, 0), (1, 1.5, 0), (0, 2.5, 0.5), 0.1),
        ft.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05),
        ft.cone((2, -2.5, 0), (2, -1, 0), 0.6, 0.1),
        ft.plane((0, 1, 0), -3.5))))


@pytest.mark.parametrize("case", [
    "march_culled", "march_dense_signed", "occlusion_apex",
    "surface_slot", "surface_ad", "early_out_debug"])
def test_kernels_lower_for_gpu(case):
    """Every kernel variant lowers through the Triton route for the GPU
    (power-of-two blocks, supported primitives) and names itself."""
    tori = ft.flatten(torus_csg_scene(seed=19, n_tori=64))
    rays = _rays(32, 32)
    sign = jnp.where(jnp.arange(1024) % 2 == 0, 1.0, -1.0)
    relaxed = dataclasses.replace(_GPU, relax_omega=1.4)
    fns = {
        "march_culled": (tori, lambda s, r: march(s, r, relaxed).t),
        "march_dense_signed": (
            tori, lambda s, r: march(s, r, dataclasses.replace(
                _GPU, cull=False), sign=sign).t),
        "occlusion_apex": (tori, lambda s, r: march_occlusion(
            s, r, relaxed, cone_apex=jnp.asarray([0.0, 0.5, -2.0]))),
        "surface_slot": (tori, lambda s, r: march_surface(s, r, _GPU)[1]),
        "surface_ad": (_smooth_scene(),
                       lambda s, r: march_surface(s, r, _GPU)[1]),
        "early_out_debug": (tori, lambda s, r: march(
            s, r, dataclasses.replace(_GPU, cull_early_out=True,
                                      debug_window_stats=True)).steps),
    }
    scene, fn = fns[case]
    text = jax.jit(fn).trace(scene, rays).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text
    name = "fray_occlusion" if case.startswith("occlusion") else "fray_march"
    assert name in text
    if case.startswith("surface"):
        assert "fray_surface" in text


def test_parity_gpu_program_block():
    """The GPU launches BLOCK_RAYS-ray programs (interpret mode defaults to
    one program per culling tile).  Per-program windows move hit points
    only within the epsilon shell: the hit set equals the jnp march's."""
    from fraytracer_tpu.ops.pallas.march_kernel import (BLOCK_RAYS,
                                                        pallas_march_raw)
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=64))
    rays = _rays(32, 32)
    cfg = MarchConfig(backend="pallas_interpret", max_steps=128)
    ref = march(scene, rays, MarchConfig(backend="jnp", max_steps=128))
    got = pallas_march_raw(scene, rays, cfg, interpret=True,
                           block=BLOCK_RAYS)
    hits = np.asarray(ref.hit)
    assert hits.mean() > 0.1
    np.testing.assert_array_equal(np.asarray(got.hit), hits)
    dt = np.abs(np.asarray(got.t) - np.asarray(ref.t))[hits]
    assert dt.max() < 0.01


def _point_shadow_rays(n=1024, light=(-0.5, 0.0, -2.0)):
    """Shadow rays toward a point light: origins on a shell around the
    scene, each budget ending at the light, a fifth of the lanes idle."""
    rng = np.random.default_rng(3)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.2
    diff = np.asarray(light) - o
    dist = np.linalg.norm(diff, axis=-1)
    act = rng.uniform(size=n) > 0.2
    return ft.types.Rays(
        origin=jnp.asarray(o, jnp.float32),
        direction=jnp.asarray(diff / dist[:, None], jnp.float32),
        length=jnp.asarray(np.where(act, dist, 0.0), jnp.float32),
        epsilon=jnp.full((n,), 0.01, jnp.float32))


@pytest.mark.parametrize("case", [
    "surface_slot", "surface_ad", "occlusion", "occlusion_apex"])
def test_gpu_program_block_surface_and_occlusion(case):
    """The surface and occlusion kernels at the GPU's BLOCK_RAYS-ray
    programs: surface normals and materials equal a dense evaluation at
    the kernel's hit points (slot mode on the culled tori, AD mode on a
    smooth-union scene); occlusion finds the march's hit set at the same
    block, and with a converging cone flips at most a hair of grazing
    lanes."""
    from fraytracer_tpu.ops import sdf
    from fraytracer_tpu.ops.pallas.march_kernel import (BLOCK_RAYS,
                                                        pallas_march_raw)
    cfg = MarchConfig(backend="pallas_interpret", max_steps=128,
                      relax_omega=1.4)

    def run(scene, rays, **kw):
        return pallas_march_raw(scene, rays, cfg, interpret=True,
                                block=BLOCK_RAYS, **kw)

    if case.startswith("surface"):
        scene = ft.flatten(torus_csg_scene(seed=19, n_tori=64))
        if case == "surface_ad":
            scene = ft.flatten(ft.Scene(root=ft.union(
                ft.smooth_union(
                    0.3, ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 0, 0)),
                    ft.sphere((0.8, 0.3, 0), 0.7, material=ft.solid(0, 1, 0))),
                ft.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2,
                         material=ft.solid(0, 0, 1)),
                ft.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05,
                       material=ft.solid(1, 1, 0)))))
        rays = _rays(32, 32)
        res, normal, midx, _code = run(scene, rays, want_surface=True)
        ref = march(scene, rays, MarchConfig(backend="jnp", max_steps=128))
        hits = np.asarray(res.hit)
        assert hits.mean() > 0.03
        np.testing.assert_array_equal(hits, np.asarray(ref.hit))
        pos = rays.at(res.t - rays.epsilon)
        np.testing.assert_allclose(
            np.asarray(normal)[hits],
            np.asarray(sdf.scene_normal(scene, pos))[hits], atol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(midx)[hits],
            np.asarray(sdf.material_at(scene, pos)[0])[hits])
        return
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=96))
    light = jnp.asarray([-0.5, 0.0, -2.0])
    rays = _point_shadow_rays()
    full = np.asarray(run(scene, rays).hit)
    assert 0.05 < full.mean() < 0.95
    if case == "occlusion":
        np.testing.assert_array_equal(
            np.asarray(run(scene, rays, occlusion=True)), full)
    else:
        occ = np.asarray(run(scene, rays, occlusion=True, cone_apex=light))
        assert (occ != full).mean() <= 0.005
