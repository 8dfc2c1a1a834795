"""Console driver: the batched equivalent of the reference's
``FrayTracer.Console`` (Program.fs:14-100), generalized into a small CLI.

Where the reference hardcodes every parameter (seed, fov, size, scene, ε,
budget, γ — Program.fs:14-99), this exposes them as flags (SURVEY.md §5
config requirement).  Subcommands:

* ``render`` — render a named scene to .png/.bmp, printing the timing line
  like the reference does (Program.fs:87-96)
* ``spectral`` — wavefront spectral render (dispersion/reflection/refraction)
* ``bench``  — thin wrapper over bench.py's measurement
* ``fit``    — inverse rendering: fit scene params to a target image
"""
from __future__ import annotations

import argparse
import sys
import time


def _scene_by_name(name: str, seed: int, n: int):
    from .scene import generators as G
    if name == "torus-csg":
        return G.torus_csg_scene(seed=seed, n_tori=n)
    if name == "csg-demo":
        return G.csg_demo_scene(seed=seed)
    if name == "glass":
        from .models import glass_demo_scene
        return glass_demo_scene()
    raise SystemExit(f"unknown scene {name!r} (torus-csg, csg-demo, glass)")


def cmd_render(args) -> int:
    import jax

    import fraytracer_tpu as ft
    from .image.io import save_image
    from .ops.march import MarchConfig

    scene = ft.flatten(_scene_by_name(args.scene, args.seed, args.tori))
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov)
    cfg = ft.RenderConfig(width=args.size, height=args.size,
                          epsilon=args.epsilon, length=args.length,
                          gamma=args.gamma,
                          march=MarchConfig(max_steps=args.max_steps,
                                            relax_omega=1.4))
    print("Rendering...", flush=True)
    t0 = time.perf_counter()
    img = ft.render(scene, camera, cfg)
    img.block_until_ready()
    print(f"Time = {time.perf_counter() - t0:.2f} sec")

    out = ft.tonemap(img, jax.random.key(args.seed), cfg.gamma)
    save_image(args.out, out)
    print(f"Wrote {args.out}")
    return 0


def cmd_spectral(args) -> int:
    import jax

    import fraytracer_tpu as ft
    from .image.io import save_image
    from .ops.march import MarchConfig
    from .ops.wavefront import WavefrontConfig, render_spectral

    scene = ft.flatten(_scene_by_name(args.scene, args.seed, args.tori))
    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov)
    cfg = WavefrontConfig(depth=args.depth, epsilon=args.epsilon,
                          length=args.length,
                          march=MarchConfig(max_steps=args.max_steps,
                                            relax_omega=1.4))
    print(f"Spectral rendering (depth {args.depth}, "
          f"{cfg.num_bins} bins)...", flush=True)
    t0 = time.perf_counter()
    img = render_spectral(scene, camera, args.size, args.size, cfg)
    img.block_until_ready()
    print(f"Time = {time.perf_counter() - t0:.2f} sec")
    out = ft.tonemap(img, jax.random.key(args.seed), args.gamma)
    save_image(args.out, out)
    print(f"Wrote {args.out}")
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering (BASELINE config 5): perturb every floating scene
    parameter, descend the image L2 back to the target, exercising the
    checkpoint save/resume round trip mid-run and writing a loss-curve +
    parameter-recovery artifact (JSON)."""
    import json
    import time

    import jax
    import jax.numpy as jnp

    import fraytracer_tpu as ft
    from .ops.march import MarchConfig, resolve_backend
    from .utils.checkpoint import load_scene, save_scene

    camera = ft.look_at(tuple(args.camera), tuple(args.target),
                        fov_degrees=args.fov)
    cfg = ft.RenderConfig(width=args.size, height=args.size,
                          epsilon=args.epsilon, length=args.length,
                          march=MarchConfig(max_steps=args.max_steps))

    target_scene = ft.flatten(_scene_by_name(args.scene, args.seed,
                                             args.tori))
    target = ft.render(target_scene, camera, cfg)
    # perturb geometry, then descend back
    init = jax.tree.map(
        lambda x: x + args.perturb * jax.random.normal(
            jax.random.key(7), x.shape, x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating) else x,
        target_scene.prim_params)
    scene = target_scene.replace(prim_params=init)

    def param_err(s):
        return float(sum(
            jnp.sum(jnp.abs(a - b)) for a, b in
            zip(jax.tree.leaves(s.prim_params),
                jax.tree.leaves(target_scene.prim_params))))

    @jax.jit
    def step(s):
        def loss(s):
            return jnp.mean((ft.render(s, camera, cfg) - target) ** 2)
        l, g = jax.value_and_grad(loss)(s)
        new = jax.tree.map(
            lambda p, gg: p - args.lr * gg
            if jnp.issubdtype(p.dtype, jnp.floating) else p, s, g)
        return new, l

    err0 = param_err(scene)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        scene, l = step(scene)
        losses.append(float(l))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(l):.6f}", flush=True)
        if args.checkpoint and i == args.steps // 2:
            # checkpoint/resume round trip mid-run (utils/checkpoint)
            save_scene(args.checkpoint, scene)
            scene = load_scene(args.checkpoint)
            print(f"checkpointed + resumed at step {i}", flush=True)
    wall = time.perf_counter() - t0

    err1 = param_err(scene)
    n_params = sum(int(x.size) for x in jax.tree.leaves(scene.prim_params))
    report = {
        "backend": resolve_backend(cfg.march.backend),
        "size": args.size, "scene": args.scene,
        "tori": args.tori, "steps": args.steps, "lr": args.lr,
        "perturb": args.perturb, "n_params": n_params,
        "loss_first": losses[0], "loss_last": losses[-1],
        "param_l1_before": err0, "param_l1_after": err1,
        "param_recovery": 1.0 - err1 / max(err0, 1e-12),
        "wall_s": round(wall, 2), "losses": losses,
    }
    if args.out_report:
        with open(args.out_report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out_report}", flush=True)
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f}, param L1 "
          f"{err0:.4f} -> {err1:.4f} "
          f"({report['param_recovery']*100:.1f}% recovered)", flush=True)
    return 0


def cmd_bench(args) -> int:
    import subprocess
    cmd = [sys.executable, "bench.py"]
    if args.quick:
        cmd.append("--quick")
    return subprocess.call(cmd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fraytracer",
                                description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU even where a GPU is present")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="torus-csg")
        sp.add_argument("--seed", type=int, default=19)
        sp.add_argument("--tori", type=int, default=1000)
        sp.add_argument("--size", type=int, default=512)
        sp.add_argument("--epsilon", type=float, default=0.01)
        sp.add_argument("--length", type=float, default=30.0)
        sp.add_argument("--gamma", type=float, default=2.2)
        sp.add_argument("--fov", type=float, default=60.0)
        sp.add_argument("--max-steps", type=int, default=192)
        sp.add_argument("--camera", type=float, nargs=3,
                        default=[0.0, 0.0, -10.0])
        sp.add_argument("--target", type=float, nargs=3,
                        default=[0.0, 0.0, 0.0])

    sp = sub.add_parser("render", help="render a scene to an image file")
    common(sp)
    sp.add_argument("--out", default="result.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("spectral", help="spectral wavefront render")
    common(sp)
    sp.add_argument("--depth", type=int, default=4)
    sp.add_argument("--out", default="spectral.png")
    sp.set_defaults(fn=cmd_spectral)

    sp = sub.add_parser("fit", help="inverse rendering demo")
    common(sp)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--lr", type=float, default=0.5)
    sp.add_argument("--perturb", type=float, default=0.05)
    sp.add_argument("--checkpoint", default="",
                    help="npz path: save+resume mid-run (empty = skip)")
    sp.add_argument("--out-report", default="",
                    help="JSON loss-curve/recovery artifact path")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("bench", help="run the benchmark")
    sp.add_argument("--quick", action="store_true")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
