"""Fused in-kernel surface pass (normals + CSG-aware materials): parity with
the dense path, plus gradient correctness of the fused custom VJP."""
import numpy as np
import jax
import jax.numpy as jnp

import fraytracer_tpu as ft
from fraytracer_tpu.ops import sdf
from fraytracer_tpu.ops.march import MarchConfig, march, march_surface
from fraytracer_tpu.scene.generators import torus_csg_scene

PAL = MarchConfig(backend="pallas_interpret", max_steps=128)
PAL_NOFUSE = MarchConfig(backend="pallas_interpret", max_steps=128,
                         fuse_surface=False)
JNP = MarchConfig(backend="jnp", max_steps=128)


def flat_camera_rays(w, h, eps=0.01, length=30.0):
    cam = ft.look_at((0, 0, -10), (0, 0, 0))
    rays = ft.camera_rays(cam, w, h, eps, length)
    return jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)


def test_fused_surface_matches_dense():
    """Kernel normals/materials == dense jnp normals/materials at the same
    hit points (same t: both paths march identically)."""
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=48))
    rays = flat_camera_rays(32, 32)
    res, normal, midx = march_surface(scene, rays, PAL)
    hits = np.asarray(res.hit)
    assert hits.mean() > 0.05

    pos = rays.at(res.t - rays.epsilon)
    n_ref = sdf.scene_normal(scene, pos)
    m_ref, _alb = sdf.material_at(scene, pos)

    np.testing.assert_allclose(np.asarray(normal)[hits],
                               np.asarray(n_ref)[hits], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(midx)[hits],
                                  np.asarray(m_ref)[hits])
    np.testing.assert_array_equal(np.asarray(midx)[~hits],
                                  -np.ones(int((~hits).sum()), np.int32))


def test_fused_surface_all_kinds():
    """Surface pass covers every primitive kind's in-kernel gradient."""
    scene = ft.flatten(ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 0.8, material=ft.solid(1, 0, 0)),
        ft.capsule((-2, -1, 0), (-2, 1, 0), 0.3, material=ft.solid(0, 1, 0)),
        ft.torus((2, 0, 0), (0, 1, 0.3), 0.7, 0.2,
                 material=ft.solid(0, 0, 1)),
        ft.triangle((-1, 1.5, 0), (1, 1.5, 0), (0, 2.5, 0.5), 0.1),
        ft.box((0, -2, 0), (0.6, 0.4, 0.5), 0.05),
        ft.cone((2, -2.5, 0), (2, -1, 0), 0.6, 0.1),
    )))
    rays = flat_camera_rays(24, 24, length=40.0)
    res, normal, midx = march_surface(scene, rays, PAL)
    hits = np.asarray(res.hit)
    assert hits.any()
    pos = rays.at(res.t - rays.epsilon)
    n_ref = sdf.scene_normal(scene, pos)
    m_ref, _ = sdf.material_at(scene, pos)
    np.testing.assert_allclose(np.asarray(normal)[hits],
                               np.asarray(n_ref)[hits], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(midx)[hits],
                                  np.asarray(m_ref)[hits])


def test_fused_render_matches_nonfused():
    """End-to-end render: fused surface pass == point_eval surface path."""
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=96))
    cam = ft.look_at((0, 0, -10), (0, 0, 0))
    a = np.asarray(ft.render(scene, cam, ft.RenderConfig(
        width=64, height=64, march=PAL)))
    b = np.asarray(ft.render(scene, cam, ft.RenderConfig(
        width=64, height=64, march=PAL_NOFUSE)))
    assert np.abs(a - b).max() < 1e-4


def test_csg_material_subtract_keeps_a():
    """Materials on a subtract's b operand never win — the reference keeps
    the object's material in carved regions (SdfObject.fs:50-54)."""
    red, blue = ft.solid(1, 0, 0), ft.solid(0, 0, 1)
    scene = ft.flatten(ft.Scene(root=ft.subtract(
        ft.sphere((0, 0, 0), 1.0, material=red),
        ft.sphere((0, 0, -1.0), 0.6, material=blue),  # carves the front
    )))
    # ray down +z hits the carved bowl: nearest prim is the blue cutter,
    # but its material must NOT win (CSG-aware argmin)
    rays = ft.make_rays([0, 0, -5.0], [0, 0, 1.0], 100.0, 1e-3)
    rays = jax.tree.map(lambda x: x[None], rays)
    for cfg in (JNP, PAL):
        res, _n, midx = march_surface(scene, rays, cfg)
        assert bool(res.hit[0])
        assert int(midx[0]) == 0  # red (material index 0)


def test_sign_march_pallas_matches_jnp():
    """Inside-marching (sign=-1) through the Pallas kernel: refraction
    transmission rays must find the same exit surface as the jnp path.
    A containing primitive can never be window-skipped (its bound contains
    the point), so the capped march is exact for negative distances."""
    scene = ft.flatten(ft.Scene(root=ft.union(
        ft.sphere((0, 0, 0), 1.0, material=ft.solid(1, 1, 1)),
        ft.sphere((3, 0, 0), 0.5),
    )))
    # rays starting inside the unit sphere, marching outward
    origins = np.array([[0.0, 0.0, 0.0], [0.2, 0.1, -0.5],
                        [0.0, 0.0, 0.9]], np.float32)
    dirs = np.array([[0, 0, 1.0], [0, 0, 1.0], [0, 0, 1.0]], np.float32)
    rays = ft.make_rays(origins, dirs, 100.0, 1e-3)
    sign = -jnp.ones(3, jnp.float32)
    r_j = march(scene, rays, JNP, sign=sign)
    r_p = march(scene, rays, PAL, sign=sign)
    np.testing.assert_array_equal(np.asarray(r_j.hit), np.asarray(r_p.hit))
    np.testing.assert_allclose(np.asarray(r_p.t), np.asarray(r_j.t),
                               atol=1e-5)

    # fused surface on sign lanes: outward normal + material at the exit
    res, nrm, midx = march_surface(scene, rays, PAL, sign=sign)
    assert bool(np.asarray(res.hit).all())
    pos = rays.at(res.t - rays.epsilon)
    n_ref = np.asarray(sdf.scene_normal(scene, pos))
    np.testing.assert_allclose(np.asarray(nrm), n_ref, atol=1e-4)


def test_spectral_render_pallas_matches_jnp():
    """The wavefront integrator (sign lanes, fused surface, coherent
    compaction) through the pallas backend == jnp backend."""
    import dataclasses
    from fraytracer_tpu.ops.wavefront import WavefrontConfig, render_spectral
    scene = ft.flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0.2, 0), 0.9,
                      material=ft.dielectric(ior=1.5)),
            ft.plane((0, 1, 0), -1.2, material=ft.solid(0.7, 0.7, 0.7)),
        ),
        lights=[ft.directional_light((0.3, -1.0, 0.5), (1.0, 1.0, 1.0))],
        background=(0.05, 0.05, 0.08)))
    cam = ft.look_at((0, 0.3, -4), (0, 0, 0))
    wj = WavefrontConfig(depth=3, epsilon=1e-3, march=JNP)
    wp = dataclasses.replace(wj, march=PAL)
    a = np.asarray(render_spectral(scene, cam, 24, 24, wj))
    b = np.asarray(render_spectral(scene, cam, 24, 24, wp))
    # hit points drift within the epsilon shell between the two sound
    # marches; refraction directions amplify that on curved glass
    assert np.abs(a - b).max() < 5e-2
    assert np.abs(a - b).mean() < 2e-3


def test_fused_gradients_match_nonfused():
    """The fused custom VJP reproduces the unfused (march -> dense normal)
    gradient chain: d(shaded pixel)/d(sphere radius) must agree."""
    scene = ft.flatten(ft.Scene(
        root=ft.sphere((0, 0, 0), 1.0, material=ft.solid(0.8, 0.5, 0.2)),
        lights=[ft.directional_light((0.3, -1.0, 0.5), (1.0, 1.0, 1.0))]))
    rays = ft.make_rays([[0.2, 0.1, -5.0]], [[0, 0, 1.0]], 100.0, 1e-3)

    def loss(r, cfg):
        s = scene.replace(prim_params={
            "sphere": scene.prim_params["sphere"].at[0, 3].set(r)})
        res, normal, midx = march_surface(s, rays, cfg)
        # shading-like scalar touching both t and normal
        pos = rays.at(res.t - rays.epsilon)
        ldir = jnp.asarray([0.0, 1.0, 0.0])
        return jnp.sum(jnp.where(res.hit,
                                 jnp.sum(normal * ldir, -1) + 0.1 * res.t,
                                 0.0)) + 0.0 * jnp.sum(pos)

    g_fused = jax.grad(lambda r: loss(r, PAL))(jnp.float32(1.0))
    g_dense = jax.grad(lambda r: loss(r, JNP))(jnp.float32(1.0))
    np.testing.assert_allclose(float(g_fused), float(g_dense), rtol=1e-3,
                               atol=1e-5)
    assert abs(float(g_fused)) > 1e-4  # non-trivial gradient


def test_resolve_material_block_tier_matches_lane_tier():
    """The block-granular repair tier (kernel backends, bad lanes in
    ≤ BCAP blocks) must produce exactly the lane-tier / dense result —
    the global material argmin on every bad hit lane (SdfObject.fs:26-46)."""
    import jax.numpy as jnp
    from fraytracer_tpu.ops import sdf
    from fraytracer_tpu.ops.shade import resolve_material
    rng = np.random.default_rng(3)
    scene = ft.flatten(ft.Scene(root=ft.union(
        ft.sphere((-1.5, 0, 0), 0.8, material=ft.solid(1, 0, 0)),
        ft.sphere((1.5, 0, 0), 0.8, material=ft.solid(0, 1, 0)),
        ft.sphere((0, 1.5, 0), 0.5),   # material-less
    )))
    n = 4096  # 4 blocks
    pos = jnp.asarray(rng.uniform(-2.5, 2.5, size=(n, 3)), jnp.float32)
    hit = jnp.asarray(rng.uniform(size=n) > 0.5)
    # bad lanes confined to two blocks (block tier); plus an all-good block
    midx = jnp.asarray(rng.integers(0, 2, size=n), jnp.int32)
    bad = np.zeros(n, bool)
    bad[100:180] = True      # block 0
    bad[2100:2120] = True    # block 2
    midx = jnp.where(jnp.asarray(bad), -1, midx)
    ref = np.asarray(resolve_material(scene, pos, hit, midx,
                                      blocks=False))
    blk = np.asarray(resolve_material(scene, pos, hit, midx,
                                      blocks=True))
    np.testing.assert_array_equal(blk, ref)
    # ground truth on the repaired lanes
    m_true = np.asarray(sdf.material_at(scene, pos)[0])
    fixed = np.asarray(hit) & bad
    np.testing.assert_array_equal(blk[fixed], m_true[fixed])
    # overflow (> BCAP blocks bad) falls back to the lane tiers
    bad_all = jnp.where(jnp.asarray(np.ones(n, bool)), -1, midx)
    ref2 = np.asarray(resolve_material(scene, pos, hit, bad_all,
                                       blocks=False))
    blk2 = np.asarray(resolve_material(scene, pos, hit, bad_all,
                                       blocks=True))
    np.testing.assert_array_equal(blk2, ref2)


def test_resolve_material_block_tier_equals_dense():
    """The block tier repairs every bad hit lane of a kernel-layout batch
    (whole BLOCK-ray blocks) to the dense global material argmin
    (SdfObject.fs:26-46) and leaves every other lane untouched."""
    import jax.numpy as jnp
    from fraytracer_tpu.ops import sdf
    from fraytracer_tpu.ops.march import BLOCK
    from fraytracer_tpu.ops.shade import resolve_material
    rng = np.random.default_rng(8)
    scene = ft.flatten(ft.Scene(root=ft.subtract(
        ft.union(ft.sphere((-1, 0, 0), 1.0, material=ft.solid(1, 0, 0)),
                 ft.box((1, 0, 0), (0.7, 0.7, 0.7), 0.05,
                        material=ft.solid(0, 0, 1))),
        ft.sphere((0, 0, -1), 0.8))))    # material-less cutter
    n = 8 * BLOCK
    pos = jnp.asarray(rng.uniform(-2, 2, size=(n, 3)), jnp.float32)
    hit = jnp.asarray(rng.uniform(size=n) > 0.3)
    dense = np.asarray(sdf.material_at(scene, pos)[0])
    bad = np.zeros(n, bool)
    bad[3 * BLOCK + 7:3 * BLOCK + 300] = True   # one block
    bad[6 * BLOCK:6 * BLOCK + 5] = True         # and another
    midx = jnp.where(jnp.asarray(bad), -1, jnp.asarray(dense))
    out = np.asarray(resolve_material(scene, pos, hit, midx, blocks=True))
    fixed = np.asarray(hit) & bad
    assert fixed.sum() > 100
    np.testing.assert_array_equal(out[fixed], dense[fixed])
    np.testing.assert_array_equal(out[~fixed], np.asarray(midx)[~fixed])
