#!/usr/bin/env python
"""Reduced check of the XLA GPU fault that ``types.sum3`` works around.

Under ``jax.grad`` through the culled march, XLA's GPU compiler fused the
torus-axis normalisation ``n / sqrt(sum(n * n, -1))`` over 3-wide rows
into a Triton normalization kernel (``triton_softmax_*``) that failed to
launch on an H100 (CUDA_ERROR_INVALID_VALUE).  ``types.sum3`` writes
3-wide sums as explicit adds, which never take that route.

Cases, each compiled and run on its own:

* ``rows``: the bare pattern, ``grad`` of a row normalisation of a
  ``[1000, 3]`` array, with no march around it;
* ``march_t``: ``grad`` of the summed hit t of the culled march at 256²
  on the benchmark scene;
* ``unfused_render``: ``grad`` of a 256² render with the unfused surface
  pass (``fuse_surface=False``).

``--plain-sum`` swaps ``types.sum3`` for ``jnp.sum(axis=-1)`` (the
reduction as it was written before the workaround), to see whether the
installed XLA still fails on it.  Prints ``CASE <name> OK`` or
``CASE <name> FAIL <first line of the error>`` per case and exits 1 if
any case failed.  Needs a GPU.

Usage: python tools/row_norm_grad_check.py [--plain-sum]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fraytracer_tpu as ft  # noqa: E402
from fraytracer_tpu import types as T  # noqa: E402
from fraytracer_tpu.ops.march import MarchConfig, march  # noqa: E402
from fraytracer_tpu.scene.generators import torus_csg_scene  # noqa: E402

SIZE = 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain-sum", action="store_true",
                    help="write 3-wide sums as jnp.sum (no workaround)")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 2
    if args.plain_sum:
        T.sum3 = lambda v: jnp.sum(v, axis=-1)

    scene = ft.flatten(torus_csg_scene(seed=19, n_tori=1000))
    cam = ft.look_at((0.0, 0.0, -10.0), (0.0, 0.0, 0.0), fov_degrees=60.0)
    mc = MarchConfig(max_steps=192, relax_omega=1.4)
    rays = ft.camera_rays(cam, SIZE, SIZE, 0.01, 30.0)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), rays)
    ucfg = ft.RenderConfig(width=SIZE, height=SIZE, epsilon=0.01,
                           length=30.0, march=MarchConfig(
                               max_steps=192, relax_omega=1.4,
                               fuse_surface=False))
    axes = scene.prim_params["torus"][:, 3:6]

    cases = {
        "rows": (lambda a: jnp.sum(T.normalize(a) * a[::-1]), axes),
        "march_t": (lambda s: jnp.sum(march(s, flat, mc).t), scene),
        "unfused_render": (
            lambda s: jnp.sum(ft.render(s, cam, ucfg) ** 2), scene),
    }
    failed = 0
    for name, (fn, arg) in cases.items():
        try:
            jax.block_until_ready(jax.jit(jax.grad(fn))(arg))
            print("CASE", name, "OK", flush=True)
        except jax.errors.JaxRuntimeError as e:
            failed += 1
            print("CASE", name, "FAIL", str(e).splitlines()[0][:300],
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
