#!/usr/bin/env python
"""On-card A/B of the hand-written kernels against plain XLA, and the
launch-shape sweep of the march kernel.

Measures, on the benchmark frame (seed-19 1000-torus scene, 1024², two
lights, epsilon 0.01, budget 30, omega 1.4), each after compile:

* forward frame with the Pallas march kernel vs the plain ``jnp`` march
  that XLA compiles (``MarchConfig(backend="jnp")``), and the primary
  march alone both ways;
* the fused surface kernel vs ``point_eval.culled_surface_eval``
  (``fuse_surface=False``), in the forward frame and in fwd+bwd;
* compile seconds of the march, surface and occlusion programs;
* the forward frame over program blocks × warps × culling tiles
  (``BLOCK_RAYS``, ``NUM_WARPS``, ``RAY_TILE`` of ops/pallas/march_kernel).

Needs a GPU.  ``--section`` picks one part (``ab``: compile seconds and
the march pairs; ``surface``: the surface pairs; ``sweep``: the launch
shapes), so parts can run in separate processes, e.g. under different
``XLA_FLAGS``.  Writes ``chiprun_out/kernel_ab_<section>.json`` and prints
one line per number.

Usage: python tools/kernel_ab.py [--section ab|surface|sweep]
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fraytracer_tpu as ft  # noqa: E402
from fraytracer_tpu.ops import march as M  # noqa: E402
from fraytracer_tpu.ops.pallas import march_kernel as K  # noqa: E402
from fraytracer_tpu.scene.generators import torus_csg_scene  # noqa: E402
from fraytracer_tpu.utils.compile_cache import enable_compile_cache  # noqa


def best_of(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def compile_s(fn, *args):
    t0 = time.perf_counter()
    jax.jit(fn).lower(*args).compile()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", choices=("ab", "surface", "sweep"),
                    default="ab")
    ap.add_argument("--shapes", default="",
                    help="sweep only these tile:block:warps shapes, "
                         "comma-separated (e.g. 1024:64:2,1024:32:1)")
    args = ap.parse_args()
    section = args.section
    assert jax.devices()[0].platform == "gpu", jax.devices()
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "xla_flags": os.environ.get("XLA_FLAGS", "")}

    def put(key, val):
        out[key] = val
        print(f"{key}: {val} [{card}]", flush=True)

    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=1000))
    cam = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0), fov_degrees=60.0)
    base = M.MarchConfig(max_steps=192, relax_omega=1.4)

    def rcfg(**kw):
        return ft.RenderConfig(width=1024, height=1024, epsilon=0.01,
                               length=30.0,
                               march=dataclasses.replace(base, **kw))

    def frame(cfg):
        return jax.jit(lambda s, c: ft.render(s, c, cfg))

    def fwd_bwd(cfg):
        return jax.jit(jax.grad(
            lambda s, c: jnp.sum(ft.render(s, c, cfg) ** 2)))

    rays = ft.camera_rays(cam, 1024, 1024, 0.01, 30.0)
    from fraytracer_tpu.render import _auto_block, _block_perm
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    perm, _ = _block_perm(1024, 1024, _auto_block(1024, 1024))
    flat = jax.tree.map(lambda x: x[perm], flat)

    if section == "ab":
        ab(put, scene, cam, flat, base, rcfg, frame)
    elif section == "surface":
        # the fused surface kernel vs culled_surface_eval
        for name, kw in (("fused", {}), ("unfused", {"fuse_surface": False})):
            put(f"frame_ms_{name}_surface", 1e3 * best_of(
                frame(rcfg(**kw)), scene, cam))
            put(f"fwd_bwd_ms_{name}_surface", 1e3 * best_of(
                fwd_bwd(rcfg(**kw)), scene, cam, reps=5))
    else:
        shapes = [tuple(int(v) for v in sh.split(":"))
                  for sh in args.shapes.split(",") if sh]
        sweep(put, scene, cam, rcfg, frame, shapes)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"kernel_ab_{section}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def ab(put, scene, cam, flat, kern, rcfg, frame):
    """Compile seconds per program, and the march kernel vs the plain jnp
    march (primary march alone and the whole frame)."""
    put("compile_s_march", round(compile_s(
        lambda s, r: M.march(s, r, kern).t, scene, flat), 2))
    put("compile_s_march_surface", round(compile_s(
        lambda s, r: M.march_surface(s, r, kern)[1], scene, flat), 2))
    put("compile_s_occlusion", round(compile_s(
        lambda s, r: M.march_occlusion(s, r, kern), scene, flat), 2))
    put("primary_march_ms_kernel", 1e3 * best_of(
        jax.jit(lambda s, r: M.march(s, r, kern).t), scene, flat))
    put("primary_march_ms_jnp", 1e3 * best_of(
        jax.jit(lambda s, r: M.march(s, r, dataclasses.replace(
            kern, backend="jnp")).t), scene, flat, reps=2))
    put("frame_ms_kernel", 1e3 * best_of(frame(rcfg()), scene, cam))
    put("frame_ms_jnp", 1e3 * best_of(
        frame(rcfg(backend="jnp")), scene, cam, reps=2))


def sweep(put, scene, cam, rcfg, frame, shapes=()):
    """Forward frame over program blocks x warps, then the best of those
    with 256-ray culling tiles (module constants are read at trace
    time); or over the given (tile, block, warps) ``shapes`` only."""
    def variant(tile, block, warps):
        K.RAY_TILE, K.BLOCK_RAYS, K.NUM_WARPS = tile, block, warps
        K._build_kernel.cache_clear()
        jax.clear_caches()
        ms = 1e3 * best_of(frame(rcfg()), scene, cam)
        put(f"sweep_frame_ms_tile{tile}_block{block}_warps{warps}", ms)
        return ms

    results = {}
    if shapes:
        for shape in shapes:
            results[shape] = variant(*shape)
        put("sweep_best", dict(zip(("tile", "block", "warps"),
                                   min(results, key=results.get))))
        return
    for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8)):
        results[(1024, block, warps)] = variant(1024, block, warps)
    _t, block, warps = min(results, key=results.get)
    if block <= 256:
        results[(256, block, warps)] = variant(256, block, warps)
    put("sweep_best", dict(zip(("tile", "block", "warps"),
                               min(results, key=results.get))))


if __name__ == "__main__":
    sys.exit(main())
