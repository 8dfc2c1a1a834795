#!/usr/bin/env python
"""Sharded-render scaling report on the virtual 8-device CPU mesh.

This measures no device: it runs on the CPU backend, whose 8 virtual
devices share the host's cores.  What it reports is the overhead the
sharded code path adds on a virtual mesh: the wall-time
ratio of ``render_sharded`` over an N-device mesh to the plain
single-device render of the same frame.  All virtual devices share the
same host cores, so perfect sharding machinery gives a ratio ≈ 1.0; a
ratio ≫ 1 means the shard_map path (collectives, layout, dispatch) is
adding real cost that WOULD eat into multi-chip linear scaling.

Prints one JSON line:
  {"virtual8_sharding_overhead": r, "t_single_s": ..., "t_sharded_s": ...,
   "mesh_devices": 8, ...}
"""
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fraytracer_tpu as ft  # noqa: E402
from fraytracer_tpu.ops.march import MarchConfig  # noqa: E402
from fraytracer_tpu.parallel import mesh as pmesh  # noqa: E402
from fraytracer_tpu.scene.generators import torus_csg_scene  # noqa: E402


def _time(fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    best = 1e30
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main() -> int:
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    tori = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=tori))
    cam = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60.0)
    cfg = ft.RenderConfig(width=size, height=size,
                          march=MarchConfig(backend="jnp", max_steps=128),
                          tile_rays=0)

    t_single, img_1 = _time(lambda: ft.render(scene, cam, cfg))

    mesh8 = pmesh.make_mesh(8)
    t_shard, img_8 = _time(
        lambda: pmesh.render_sharded(scene, cam, cfg, mesh8))

    # BASELINE.md correctness bar is atol 1e-5; XLA may reassociate float
    # reductions differently under sharding (one-ulp-scale drift)
    np.testing.assert_allclose(np.asarray(img_8), np.asarray(img_1),
                               atol=1e-5)
    print(json.dumps({
        "virtual8_sharding_overhead": round(t_shard / t_single, 4),
        "t_single_s": round(t_single, 4),
        "t_sharded_s": round(t_shard, 4),
        "mesh_devices": 8,
        # namespaced: bench.py merges this dict into the headline record and
        # bare "image_size"/"n_tori" would clobber the benchmark workload
        # fields (round-4 reporting bug)
        "scaling_image_size": size,
        "scaling_n_tori": tori,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
