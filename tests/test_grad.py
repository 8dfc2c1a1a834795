"""Differentiability tests (SURVEY.md §4.4): implicit-diff march gradients
vs finite differences, and end-to-end pixel gradients w.r.t. scene params."""
import numpy as np
import jax
import jax.numpy as jnp

import fraytracer_tpu as ft
from fraytracer_tpu.ops.march import MarchConfig, march

CFG = MarchConfig(bound_skip=False, max_steps=256)


def sphere_scene(radius=1.0, cz=0.0):
    return ft.flatten(ft.Scene(
        root=ft.sphere((0.0, 0.0, cz), radius, material=ft.solid(1, 1, 1)),
        background=(0.1, 0.1, 0.1),
        lights=(ft.directional_light((0, 0, 1), (1.0, 1.0, 1.0)),),
    ))


def test_dt_dradius_matches_analytic():
    """Head-on ray onto a sphere: t* = |o - c| - r ⇒ dt*/dr = -1."""
    rays = ft.make_rays([0, 0, -5.0], [0, 0, 1.0], 100.0, 1e-4)

    def t_of_radius(r):
        scene = sphere_scene()
        scene = scene.replace(prim_params={
            "sphere": scene.prim_params["sphere"].at[0, 3].set(r)})
        return march(scene, rays, CFG).t

    g = jax.grad(lambda r: jnp.sum(t_of_radius(r)))(jnp.float32(1.0))
    np.testing.assert_allclose(float(g), -1.0, atol=1e-3)


def test_dt_dcenter_matches_analytic():
    """dt*/dcz = +1 for a head-on ray marching in +z (moving the sphere
    away moves the hit farther)."""
    rays = ft.make_rays([0, 0, -5.0], [0, 0, 1.0], 100.0, 1e-4)

    def t_of_cz(cz):
        scene = sphere_scene()
        scene = scene.replace(prim_params={
            "sphere": scene.prim_params["sphere"].at[0, 2].set(cz)})
        return march(scene, rays, CFG).t

    g = jax.grad(lambda c: jnp.sum(t_of_cz(c)))(jnp.float32(0.0))
    np.testing.assert_allclose(float(g), 1.0, atol=1e-3)


def test_dt_dorigin_and_direction():
    """dt/doz = -1/(d·n) = -1 head-on; oblique rays via FD."""
    def t_of(oz):
        rays = ft.make_rays(jnp.stack([jnp.float32(0), jnp.float32(0), oz]),
                            [0, 0, 1.0], 100.0, 1e-4)
        return march(sphere_scene(), rays, CFG).t

    g = jax.grad(t_of)(jnp.float32(-5.0))
    np.testing.assert_allclose(float(g), -1.0, atol=1e-3)


def test_grad_vs_finite_difference_offaxis(rng):
    """Implicit-diff grads match central finite differences for an
    off-axis ray on a CSG scene."""
    base = np.float32(0.8)
    rays = ft.make_rays([0.3, 0.2, -4.0],
                        np.array([0.05, -0.03, 1.0]) / np.linalg.norm(
                            [0.05, -0.03, 1.0]),
                        100.0, 1e-4)

    def t_of_r(r):
        s = ft.Scene(root=ft.subtract(
            ft.sphere((0, 0, 0), 1.2, material=ft.solid(1, 1, 1)),
            ft.sphere((0.5, 0.3, -0.8), 0.6)))
        flat = ft.flatten(s)
        flat = flat.replace(prim_params={
            "sphere": flat.prim_params["sphere"].at[0, 3].set(r)})
        return march(flat, rays, CFG).t

    g = jax.grad(lambda r: jnp.sum(t_of_r(r)))(jnp.float32(base))
    h = 1e-3
    fd = (float(t_of_r(jnp.float32(base + h)))
          - float(t_of_r(jnp.float32(base - h)))) / (2 * h)
    np.testing.assert_allclose(float(g), fd, rtol=0.05, atol=5e-3)


def test_pixel_gradient_flows_to_all_param_groups():
    """End-to-end: d(image)/d(everything) is finite and nonzero for
    geometry, materials, lights and background."""
    scene = ft.flatten(ft.Scene(
        root=ft.union(
            ft.sphere((0, 0, 0), 1.0, material=ft.solid(0.8, 0.2, 0.2)),
            ft.box((1.2, 0, 0), (0.4, 0.4, 0.4), 0.05,
                   material=ft.solid(0.2, 0.8, 0.2)),
        ),
        background=(0.1, 0.1, 0.1),
        lights=(ft.directional_light((-0.5, -1, 1), (0.5, 0.5, 0.5)),
                ft.point_light((0, 2, -3), (5.0, 5.0, 5.0))),
    ))
    camera = ft.look_at((0, 0, -6), (0, 0, 0))
    cfg = ft.RenderConfig(width=24, height=24, epsilon=0.01, length=30.0,
                          march=MarchConfig(max_steps=128))

    def loss(s):
        img = ft.render(s, camera, cfg)
        return jnp.sum(img ** 2)

    g = jax.grad(loss)(scene)
    leaves = jax.tree.leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(l))) for l in leaves
               if jnp.issubdtype(l.dtype, jnp.floating))
    assert float(jnp.sum(jnp.abs(g.prim_params["sphere"]))) > 0
    assert float(jnp.sum(jnp.abs(g.prim_params["box"]))) > 0
    assert float(jnp.sum(jnp.abs(g.mat_albedo))) > 0
    assert float(jnp.sum(jnp.abs(g.light_color))) > 0
    assert float(jnp.sum(jnp.abs(g.background))) > 0


def test_inverse_rendering_descends():
    """BASELINE config 5 (miniature): gradient descent on sphere radius
    recovers the target radius."""
    camera = ft.look_at((0, 0, -5), (0, 0, 0))
    cfg = ft.RenderConfig(width=24, height=24, epsilon=0.01, length=20.0,
                          march=MarchConfig(max_steps=128))

    def make(r):
        flat = sphere_scene()
        return flat.replace(prim_params={
            "sphere": flat.prim_params["sphere"].at[0, 3].set(r)})

    target = ft.render(make(jnp.float32(1.0)), camera, cfg)

    @jax.jit
    def step(r):
        def loss(r):
            img = ft.render(make(r), camera, cfg)
            return jnp.mean((img - target) ** 2)
        l, g = jax.value_and_grad(loss)(r)
        return r - 2.0 * g, l

    r = jnp.float32(0.7)
    l0 = None
    for i in range(40):
        r, l = step(r)
        if l0 is None:
            l0 = float(l)
    # Interior-shading gradients drive r steadily toward the target (the
    # silhouette coverage term is inherently non-differentiable, so
    # convergence is asymptotic, not exact).
    assert float(l) < 0.7 * l0
    assert 0.78 < float(r) < 1.1



def test_min_denom_silhouette_envelope():
    """Quantify the min_denom grazing-incidence clamp (ops/march.py): for
    a unit sphere the exact sensitivity of the hit distance to the radius
    is dt*/dr = -1/cos(theta) with cos(theta) = sqrt(1 - b^2/r^2) at impact
    parameter b.  The implicit-diff VJP clamps the denominator at
    min_denom, so

    * away from the silhouette (cos >= 2*min_denom) gradients are exact;
    * inside the clamp band the gradient saturates at -1/min_denom —
      the documented error envelope for inverse rendering (config 5).
    """
    import numpy as np
    from fraytracer_tpu.ops.march import MarchConfig, march

    MD = 0.05
    cfg = MarchConfig(backend="jnp", max_steps=4096, min_denom=MD,
                      bound_skip=False)
    scene = ft.flatten(ft.Scene(root=ft.sphere((0.0, 0.0, 0.0), 1.0)))

    def t_of(r, b):
        s = scene.replace(prim_params={
            "sphere": scene.prim_params["sphere"].at[0, 3].set(r)})
        rays = ft.make_rays([[b, 0.0, -5.0]], [[0.0, 0.0, 1.0]],
                            100.0, 1e-5)
        return jnp.sum(march(s, rays, cfg).t)

    for b in (0.0, 0.5, 0.9, 0.99, 0.999, 0.99999):
        cos = float(np.sqrt(max(1.0 - b * b, 0.0)))
        g = float(jax.grad(t_of)(jnp.float32(1.0), jnp.float32(b)))
        expected = -1.0 / max(cos, MD)
        # the epsilon shell shifts the effective cos by O(eps); compare
        # against the clamp model with a matching tolerance
        assert abs(g - expected) < 0.03 * abs(expected) + 2e-2, \
            (b, cos, g, expected)
        assert abs(g) <= 1.0 / MD + 1e-3  # saturation bound always holds


def test_grad_through_pallas_render_with_block_repair():
    """jax.grad of a full pallas-backend render at a size where the
    block-granular material repair tier is live (n % 1024 == 0): the
    repair must not put a Pallas gather on the AD path (r5 regression:
    pallas_call has no JVP rule)."""
    import jax
    import jax.numpy as jnp
    from fraytracer_tpu.ops.march import MarchConfig
    from fraytracer_tpu.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=48))
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    cfg = ft.RenderConfig(width=64, height=64,
                          march=MarchConfig(backend="pallas_interpret",
                                            max_steps=96))

    def loss(s):
        return jnp.sum(ft.render(s, cam, cfg) ** 2)

    g = jax.grad(loss)(scene)
    leaves = jax.tree.leaves(g.prim_params)
    assert all(bool(jnp.isfinite(x).all()) for x in leaves)
    assert any(float(jnp.abs(x).sum()) > 0 for x in leaves)


def test_tiled_leaf_backward_matches_perlane():
    """The one-hot leaf backward (_surf_bwd_tail_tiled, live when the
    batch tiles at 4096 lanes) must give the same scene gradients as the
    per-lane path — same formula, different select machinery (r5)."""
    import jax
    import jax.numpy as jnp
    from fraytracer_tpu.ops.march import (MarchConfig, march_surface,
                                          _tiled_leaf_select)
    from fraytracer_tpu.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=48))
    cam_ = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    rays = ft.camera_rays(cam_, 64, 64, 0.01, 30.0)   # 4096 = one tile
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    cfg = MarchConfig(backend="pallas_interpret", max_steps=96,
                      cull=True, cull_threshold=32, cull_m=64)

    def loss(s):
        res, nrm, _m = march_surface(s, flat, cfg)
        return (jnp.sum(jnp.where(res.hit, res.t, 0.0))
                + jnp.sum(jnp.where(res.hit[..., None], nrm * 0.3, 0.0)))

    g_tiled = jax.grad(loss)(scene)

    # force the per-lane path by monkeypatching the selector off
    import fraytracer_tpu.ops.march as M
    orig = M._tiled_leaf_select
    M._tiled_leaf_select = lambda code: None
    try:
        g_lane = jax.grad(loss)(scene)
    finally:
        M._tiled_leaf_select = orig
    for k in g_tiled.prim_params:
        a = np.asarray(g_tiled.prim_params[k])
        b = np.asarray(g_lane.prim_params[k])
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() / scale < 1e-5, (k, np.abs(a - b).max())


def test_tiled_leaf_backward_matches_perlane_signed():
    """Same parity on the sign=-1 (inside-marching, refraction) path:
    the t chain uses the march-signed distance, the normal chain the
    outward gradient — the merged-VJP tiled backward must preserve both."""
    import jax
    import jax.numpy as jnp
    from fraytracer_tpu.ops.march import MarchConfig, march_surface
    from fraytracer_tpu.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=48))
    n = 4096
    rng = np.random.default_rng(4)
    # rays starting inside the root sphere marching outward (sign=-1 on
    # a subset simulates inside-dielectric transmission)
    o = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = ft.types.Rays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                         length=jnp.full((n,), 20.0, jnp.float32),
                         epsilon=jnp.full((n,), 0.01, jnp.float32))
    sign = jnp.where(jnp.asarray(rng.uniform(size=n) > 0.5), 1.0, -1.0)
    cfg = MarchConfig(backend="pallas_interpret", max_steps=96,
                      cull=True, cull_threshold=32, cull_m=64)

    def loss(s):
        res, nrm, _m = march_surface(s, rays, cfg, sign=sign)
        return (jnp.sum(jnp.where(res.hit, res.t, 0.0))
                + jnp.sum(jnp.where(res.hit[..., None], nrm * 0.3, 0.0)))

    g_tiled = jax.grad(loss)(scene)
    import fraytracer_tpu.ops.march as M
    orig = M._tiled_leaf_select
    M._tiled_leaf_select = lambda code: None
    try:
        g_lane = jax.grad(loss)(scene)
    finally:
        M._tiled_leaf_select = orig
    for k in g_tiled.prim_params:
        a = np.asarray(g_tiled.prim_params[k])
        b = np.asarray(g_lane.prim_params[k])
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() / scale < 1e-5, (k, np.abs(a - b).max())


def test_clamped_lane_fraction_bounded_on_benchmark():
    """VERDICT r4 #6: the silhouette-gradient clamp (min_denom=0.05)
    biases only grazing lanes — on the benchmark-style scene that is a
    small sliver of hits (measured 0.44% at 128²/100 tori; bounded at 2%
    here so a geometry/clamp regression trips)."""
    import jax
    import jax.numpy as jnp
    from fraytracer_tpu import camera as cam
    from fraytracer_tpu.ops import sdf
    from fraytracer_tpu.ops.march import MarchConfig, march
    from fraytracer_tpu.types import dot
    from fraytracer_tpu.scene.generators import torus_csg_scene
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=100))
    camera = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    cfg = MarchConfig(max_steps=192, backend="jnp")
    rays = cam.camera_rays(camera, 128, 128, 0.01, 30.0)
    rays = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    res = march(scene, rays, cfg)
    x0 = rays.at(res.t)
    g = jax.grad(lambda q: jnp.sum(sdf.scene_distance(scene, q)))(x0)
    den = np.abs(np.asarray(dot(g, rays.direction)))
    h = np.asarray(res.hit)
    assert h.sum() > 1000, "sanity"
    frac = ((den < cfg.min_denom) & h).sum() / h.sum()
    assert frac < 0.02, frac
