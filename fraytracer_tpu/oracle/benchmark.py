"""End-to-end oracle gate on THE benchmark scene.

The seed-19 1000-torus CSG scene (Program.fs:67-83) rendered through the
full shading pipeline — hits, occlusion bits, and final pre-quantization
colors — against the scalar float64 oracle at a small size, decomposed so
every pixel is covered by an asserted bound.  Shared by the CPU test suite
(tests/test_benchmark_oracle.py, jnp march) and ``chip_smoke.py`` (the
compiled kernel on the GPU).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import camera as _camera
from ..render import RenderConfig, render
from ..ops import shade
from ..ops.march import MarchConfig, march
from ..scene.flatten import flatten
from ..scene.generators import torus_csg_scene
from ..types import Rays
from .cpu_ref import Oracle


def check_benchmark_frame(march_cfg: MarchConfig, size: int = 64) -> dict:
    """Render the benchmark scene at ``size``² with ``march_cfg`` and
    assert it against the f64 oracle; returns the pixel-class fractions."""
    W = H = size
    EPS = 0.01
    CAM = (0.0, 0.0, -10.0)
    scene = torus_csg_scene(seed=19, n_tori=1000)
    fscene = flatten(scene)
    cfg = RenderConfig(width=W, height=H, epsilon=EPS, length=30.0,
                       march=march_cfg)
    cam = _camera.look_at(CAM, (0, 0, 0), fov_degrees=60.0)
    img = np.asarray(render(fscene, cam, cfg))
    want, aux = Oracle(scene).render(
        CAM, (0, 0, 0), fov_degrees=60.0, width=W, height=H,
        epsilon=EPS, length=30.0, return_aux=True)

    rays = _camera.camera_rays(cam, W, H, EPS, 30.0)
    res = march(fscene, rays, cfg.march)
    hit_j = np.asarray(res.hit)
    t_j = np.asarray(res.t)
    sh = shade.surface_hit(fscene, rays, cfg.march)
    occ_j = []
    for i in range(fscene.num_lights):
        ldir, budget, _ = shade.light_dir_and_dist(fscene, i, sh.position)
        cos = jnp.sum(sh.normal * ldir, -1)
        facing = sh.hit & (cos > 0.0)
        sr = Rays(origin=sh.position, direction=ldir,
                  length=jnp.where(facing, budget, 0.0),
                  epsilon=rays.epsilon)
        occ_j.append(np.asarray(march(fscene, sr, cfg.march).hit))

    hit_o = np.array([[aux[y][x]["hit"] for x in range(W)]
                      for y in range(H)])
    t_o = np.array([[aux[y][x]["t"] for x in range(W)] for y in range(H)])
    min_o = np.array([[aux[y][x]["min_d"] for x in range(W)]
                      for y in range(H)])

    assert hit_o.mean() > 0.25, "oracle sees the torus blob"

    # 1) hit/miss flips: rare and grazing only (the 1000-tori CSG scene
    # has many near-tangent rays, so the budget is a bit looser than the
    # small-scene gate but every flip must still be an epsilon-shell ray)
    flips = hit_j != hit_o
    assert flips.mean() < 0.02, f"{flips.mean():.4f} hit flips"
    if flips.any():
        assert np.abs(min_o[flips] - EPS).max() < 5e-3, \
            "a hit/miss flip that was not a grazing ray"

    # 2) both-hit pixels inside the 3-epsilon shell — except for
    # "shell-divergent" rays: in this graze-heavy scene an f32 march can
    # skim past a surface the f64 oracle catches (or vice versa) and hit a
    # FARTHER surface, so |Δt| is then the distance between two different
    # surfaces.  Those are bounded in count and excluded from `clean`.
    both = hit_j & hit_o
    dt = np.abs(t_j - t_o)
    divergent = both & (dt > 3 * EPS)
    assert divergent.mean() < 0.02, f"{divergent.mean():.4f} divergent"
    agree = both & ~divergent
    assert dt[agree].max() < 3 * EPS

    # 3) occlusion flips: rare and grazing
    occ_flip = np.zeros((H, W), bool)
    for i in range(fscene.num_lights):
        occ_o = np.array([[bool(aux[y][x]["occluded"][i])
                           if len(aux[y][x]["occluded"]) > i else False
                           for x in range(W)] for y in range(H)])
        smin_o = np.array([[aux[y][x]["shadow_min_d"][i]
                            if len(aux[y][x]["shadow_min_d"]) > i
                            else np.inf
                            for x in range(W)] for y in range(H)])
        f = agree & (occ_j[i] != occ_o)
        occ_flip |= f
        # smin == inf marks pixels the ORACLE never shadow-marched
        # (cos ≤ 0 there): a facing-bit flip from near-perpendicular
        # normals, counted in occ_flip but not a marching divergence
        marched = f & np.isfinite(smin_o)
        if marched.any():
            assert np.abs(smin_o[marched] - EPS).max() < 5e-3, \
                "an occlusion flip that was not a grazing shadow ray"
    assert occ_flip.mean() < 0.03

    # 4) pixels where the f32 march resolved the same surface to f32
    # resolution meet the BASELINE atol; the deep CSG scene accumulates
    # more marching noise than the small-scene gate (30-60 steps of f32
    # accumulation), so the strict class is smaller — the shell class
    # below covers the rest with a curvature-scale bound
    diff = np.abs(img - want).max(axis=-1)
    clean = (~flips) & (~occ_flip) & ~divergent \
        & ((~both) | (dt <= 2e-6 * (1 + t_o)))
    assert clean.mean() > 0.6, f"only {clean.mean():.2f} clean pixels"
    assert diff[clean].max() < 1e-4, (
        f"clean-pixel error {diff[clean].max():.2e}")
    # same-surface shell pixels: color drift bounded by shell × shading
    # Lipschitz (normals/albedo of the same leaf)
    shell = agree & (~flips) & (~occ_flip) & ~clean
    if shell.any():
        assert np.percentile(diff[shell], 99) < 3e-2
    assert float(np.median(diff)) < 1e-5
    return {"hit_flips": float(flips.mean()),
            "divergent": float(divergent.mean()),
            "occlusion_flips": float(occ_flip.mean()),
            "clean": float(clean.mean()),
            "median_abs_diff": float(np.median(diff))}
