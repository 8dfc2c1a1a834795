#!/usr/bin/env python
"""10,000-primitive scaling benchmark (VERDICT r4 #5).

The reference's grid has O(1) lookup with an O(cells·K) one-time build
(SdfBoundary.fs:225-282); this repo rebuilds per-tile candidate tables
every march.  This measures the 10× scene scale: sustained frame rate,
host-side candidate-prep time, and the conservative candidate counts
that size the tables (picked empirically per scene, with headroom,
exactly as a user of the API would).

``run(size, tori)`` returns the record; bench.py calls it in its own
process (one process per card) and merges it under namespaced keys.  Run
alone it prints ONE JSON line.

Usage: python tools/bench_10k.py [size] [tori]
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import fraytracer_tpu as ft
from fraytracer_tpu import camera as cam
from fraytracer_tpu.ops import sdf as _sdf
from fraytracer_tpu.ops.march import (MarchConfig, bound_skip_start,
                                      march_surface, uses_kernel)
from fraytracer_tpu.ops.pallas.march_kernel import (CAND_UNROLL, RAY_TILE,
                                                    _cand_mask,
                                                    _cone_candidates,
                                                    _pair_m, _prep_rows,
                                                    _tile_cones)
from fraytracer_tpu.ops.shade import light_dir_and_dist
from fraytracer_tpu.render import _auto_block, _block_perm
from fraytracer_tpu.scene.generators import torus_csg_scene
from fraytracer_tpu.types import Rays

K = 8


def log(msg):
    print(f"[10k] {msg}", file=sys.stderr, flush=True)


def cand_counts(scene, sh, apex):
    tile = RAY_TILE
    grid = sh.origin.shape[0] // tile
    t0, miss0, t_exit = bound_skip_start(scene, sh)
    length = jnp.minimum(sh.length, t_exit)
    length = jnp.where(miss0, 0.0, length)
    thi = jnp.where(length > 0.0, length, t0)
    cones = _tile_cones(sh.origin, sh.direction, t0, thi, sh.epsilon,
                        grid, tile, conv_apex=apex)
    conesf = _tile_cones(sh.origin, sh.direction, t0, thi, sh.epsilon,
                         grid * 4, tile // 4, conv_apex=apex)
    kb = _sdf._prim_bound_rows("torus", scene.prim_params["torus"])
    cm = jnp.any(_cand_mask(kb, conesf, apex is not None)
                 .reshape(grid, 4, -1), axis=1)
    sel = _cone_candidates(kb, cones, 8, converging=apex is not None,
                           cand=cm)
    return int(jnp.max(sel.count))


def round_up(x, q=128):
    return int(-(-x // q) * q)


def run(size: int = 1024, tori: int = 10000) -> dict:
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=tori))
    camera = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0),
                        fov_degrees=60.0)
    base = MarchConfig(max_steps=192, bound_skip=True, relax_omega=1.4)
    rays = cam.camera_rays(camera, size, size, 0.01, 30.0)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    perm, _inv = _block_perm(size, size, _auto_block(size, size))
    flat = jax.tree.map(lambda x: x[perm], flat)

    if not uses_kernel(base):
        # CPU smoke: tiny render only
        cfg = ft.RenderConfig(width=64, height=64, march=base)
        img = ft.render(scene, camera, cfg)
        jax.block_until_ready(img)
        return {"tori10k_ok": True, "tori10k_backend": "jnp"}

    # empirical table sizing with 30% headroom (a user would do the same:
    # counts are cheap host jnp; overflow falls back to the exact dense
    # march, so headroom trades memory for never taking that path)
    c_prim = cand_counts(scene, flat, None)
    m_prim = round_up(int(c_prim * 1.3))
    log(f"primary max count {c_prim} -> cull_m {m_prim}")
    mcfg0 = dataclasses.replace(base, cull_m=m_prim)
    res, nrm, _midx = jax.jit(
        lambda s, r: march_surface(s, r, mcfg0))(scene, flat)
    pos = flat.at(res.t - flat.epsilon)
    m_shadow = 0
    for li in range(scene.num_lights):
        ldir, budget, _sc = light_dir_and_dist(scene, li, pos)
        cosn = jnp.sum(nrm * ldir, axis=-1)
        facing = res.hit & (cosn > 0.0)
        sh = Rays(origin=pos, direction=ldir,
                  length=jnp.where(facing, budget, 0.0),
                  epsilon=flat.epsilon)
        apex = scene.light_vec[li] if scene.light_kind[li] == 1 else None
        m_shadow = max(m_shadow, cand_counts(scene, sh, apex))
    m_sh = round_up(int(m_shadow * 1.3))
    log(f"shadow max count {m_shadow} -> cull_m_shadow {m_sh}")

    mcfg = dataclasses.replace(base, cull_m=m_prim, cull_m_shadow=m_sh)
    cfg = ft.RenderConfig(width=size, height=size, epsilon=0.01,
                          length=30.0, march=mcfg)

    render = jax.jit(
        lambda s, c: (lambda img, n: (jnp.sum(img), n))(
            *ft.render_with_stats(s, c, cfg)))
    t0 = time.perf_counter()
    chk, n_rays = render(scene, camera)
    float(chk)
    compile_s = time.perf_counter() - t0
    log(f"compile {compile_s:.0f}s")

    @jax.jit
    def render_k(s, c):
        def body(i, acc):
            pp = dict(s.prim_params)
            k0 = next(iter(pp))
            pp[k0] = pp[k0] + acc * 1e-38
            img, n = ft.render_with_stats(s.replace(prim_params=pp), c, cfg)
            return acc + jnp.sum(img) * 1e-6
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    float(render_k(scene, camera))
    best = 1e30
    for _ in range(3):
        t0 = time.perf_counter()
        float(render_k(scene, camera))
        best = min(best, (time.perf_counter() - t0) / K)
    n_rays = float(n_rays)
    log(f"frame {best*1e3:.1f} ms, {n_rays:.0f} rays")

    # host-side candidate prep alone (cones + membership + sort + table
    # gathers), in-jit loop — the piece that scales with K
    kparams = jax.lax.stop_gradient(scene.prim_params["torus"])

    def prep(s, r):
        tile = RAY_TILE
        grid = r.origin.shape[0] // tile
        t0_, miss0, t_exit = bound_skip_start(s, r)
        length = jnp.minimum(r.length, t_exit)
        length = jnp.where(miss0, 0.0, length)
        thi = jnp.where(length > 0.0, length, t0_)
        cones = _tile_cones(r.origin, r.direction, t0_, thi, r.epsilon,
                            grid, tile)
        conesf = _tile_cones(r.origin, r.direction, t0_, thi, r.epsilon,
                             grid * 4, tile // 4)
        kb = _sdf._prim_bound_rows("torus", s.prim_params["torus"])
        cm = jnp.any(_cand_mask(kb, conesf, False)
                     .reshape(grid, 4, -1), axis=1)
        m = _pair_m(m_prim, kb.shape[0])
        sel = _cone_candidates(kb, cones, m, cand=cm)
        table = _prep_rows("torus", kparams)[sel.idx]
        lo_c = jnp.max(sel.lo_key.reshape(grid, -1, CAND_UNROLL), axis=-1)
        return jnp.sum(table) + jnp.sum(lo_c) + jnp.sum(sel.idx)

    @jax.jit
    def prep_k(s, r):
        def body(i, acc):
            r2 = r.replace(origin=r.origin + acc * 1e-38)
            return acc + prep(s, r2) * 1e-12
        return jax.lax.fori_loop(0, 16, body, jnp.float32(0.0))

    float(prep_k(scene, flat))
    t0 = time.perf_counter()
    float(prep_k(scene, flat))
    prep_ms = (time.perf_counter() - t0) / 16 * 1e3
    log(f"prep {prep_ms:.2f} ms")

    return {
        "tori10k_rays_per_sec": n_rays / best,
        "tori10k_fwd_time_s": best,
        "tori10k_n_rays": n_rays,
        "tori10k_n_tori": tori,
        "tori10k_image_size": size,
        "tori10k_cull_m": m_prim,
        "tori10k_cull_m_shadow": m_sh,
        "tori10k_cand_max_primary": c_prim,
        "tori10k_cand_max_shadow": m_shadow,
        "tori10k_prep_ms_primary": round(prep_ms, 2),
        "tori10k_compile_s": round(compile_s, 1),
    }


if __name__ == "__main__":
    from fraytracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    print(json.dumps(run(int(sys.argv[1]) if len(sys.argv) > 1 else 1024,
                         int(sys.argv[2]) if len(sys.argv) > 2 else 10000)))
