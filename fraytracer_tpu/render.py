"""Top-level render API.

The batched equivalent of the reference's ``Image.render`` + ``SdfScene.trace``
pipeline (Image.fs:26-35, SdfScene.fs:7-28): one jitted function maps the
whole [H, W] pixel grid → camera rays → masked march → shading.  There is no
per-pixel parallel loop to manage (the reference's ``Array2D.Parallel.init``,
Array2D.fs:30-38) — parallelism is XLA's across the batch on one chip and the
device mesh across chips (``parallel/``).
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import camera as cam
from .ops import shade, tonemap
from .ops.march import MarchConfig, uses_kernel
from .scene.flatten import FlatScene, flatten
from .scene.nodes import Scene
from .types import Rays

Array = jax.Array


@dataclasses.dataclass(frozen=True, eq=True)
class RenderConfig:
    """Static render configuration (the reference's hardcoded literals in
    Program.fs:14-99, made explicit per SURVEY.md §5)."""

    width: int = 1024
    height: int = 1024
    epsilon: float = 0.01       # hit threshold (Program.fs:85)
    length: float = 30.0        # ray travel budget (Program.fs:93)
    gamma: float = 2.2          # tone-map gamma (Program.fs:99)
    march: MarchConfig = MarchConfig()
    # Rays per tile for the *jnp* backend, whose march materializes a
    # [tile, K] primitive distance matrix per step; tiling keeps peak
    # device memory bounded (a 1024² image against 1000 primitives
    # untiled would need ~4 GB per temporary).  0 → no tiling.
    tile_rays: int = 65536
    # Rays per tile for the kernel backends (both directions).  The kernel
    # needs no forward tiling (its state is O(rays)); the implicit-diff
    # backward gathers [tile/1024, 1024, cull_m] candidate matrices, which
    # 0 (untiled) keeps at ~0.5 GB at 1024².
    tile_rays_pallas: int = 0


def render_rays(scene: FlatScene, rays: Rays,
                march_cfg: MarchConfig = MarchConfig()) -> Array:
    """Trace an arbitrary ray batch → linear RGB [..., 3]."""
    return shade.trace(scene, rays, march_cfg)


def _trace_tiled(scene: FlatScene, rays: Rays, march_cfg: MarchConfig,
                 tile_rays: int) -> Array:
    """Trace a flat ray batch in fixed-size tiles via ``lax.map`` so peak
    memory is bounded by [tile, K] regardless of image size.  Tiles play the
    role of the reference's per-row parallel chunks (Array2D.fs:30-38) —
    here they bound HBM instead of feeding a thread pool."""
    n = rays.origin.shape[0]
    if tile_rays <= 0 or n <= tile_rays:
        return shade.trace(scene, rays, march_cfg)
    pad = (-n) % tile_rays
    if pad:
        def pad_leaf(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)
        rays = jax.tree.map(pad_leaf, rays)
        # padded lanes: zero budget → inactive in the march
        rays = rays.replace(length=rays.length.at[n:].set(0.0))
    chunked = jax.tree.map(
        lambda x: x.reshape((-1, tile_rays) + x.shape[1:]), rays)
    # Remat each tile: without it the backward pass stacks every tile's
    # [tile, K] residuals (equivalent to the untiled memory footprint);
    # with it the backward recomputes per tile — classic compute-for-HBM
    # trade (jax.checkpoint).
    traced = jax.checkpoint(
        lambda s, r: shade.trace(s, r, march_cfg))
    out = jax.lax.map(lambda r: traced(scene, r), chunked)
    out = out.reshape((-1, 3))
    return out[:n] if pad else out


def _auto_block(height: int, width: int) -> int:
    """Screen-block edge matching the kernel's culling tile: one square
    b×b block per tile (b² = RAY_TILE) keeps the tile's ray cone as
    narrow as possible."""
    from .ops.pallas.march_kernel import RAY_TILE
    b = 1 << (int(RAY_TILE ** 0.5).bit_length() - 1)
    while height % b or width % b:
        b //= 2
    return max(b, 1)


@functools.lru_cache(maxsize=16)
def _block_perm(height: int, width: int, b: int = 32):
    """Pixel permutation into b×b screen blocks (and its inverse).

    The kernel march culls primitives per ray tile; tiles of spatially
    coherent pixels (square blocks sized to the tile) have narrow ray
    cones → small candidate lists.  Row-major order would make each tile
    a thin full-width strip with a uselessly wide cone.

    Index form, for host tools; the jitted render path applies the same
    permutation as reshape+transpose (``_to_blocks``/``_from_blocks``).
    """
    idx = np.arange(height * width).reshape(height, width)
    blocks = (idx.reshape(height // b, b, width // b, b)
              .transpose(0, 2, 1, 3).reshape(-1))
    inv = np.argsort(blocks)
    # numpy (not jnp): jnp arrays materialized inside a jit trace must not
    # be cached across traces (tracer leak)
    return blocks, inv


def _to_blocks(x: Array, height: int, width: int, b: int) -> Array:
    """[H, W, ...] → flat [H·W, ...] in b×b-block order (pure transpose)."""
    t = x.reshape((height // b, b, width // b, b) + x.shape[2:])
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.transpose(order).reshape((height * width,) + x.shape[2:])


def _from_blocks(x: Array, height: int, width: int, b: int) -> Array:
    """flat [H·W, ...] in block order → [H, W, ...] (pure transpose)."""
    t = x.reshape((height // b, width // b, b, b) + x.shape[1:])
    order = (0, 2, 1, 3) + tuple(range(4, t.ndim))
    return t.transpose(order).reshape((height, width) + x.shape[1:])


def trace_image(scene: FlatScene, rays: Rays, cfg: RenderConfig) -> Array:
    """Trace an ``[H, W]`` grid of rays → linear RGB ``[H, W, 3]``.

    On the kernel path the rays march in square screen blocks, one per
    culling tile (``_auto_block``), so each tile's cone stays narrow; a
    row block of an image (a shard of ``render_sharded``) whose height
    the block edge divides marches exactly the tiles the whole-image
    render marches there."""
    h, w = rays.origin.shape[:2]
    pallas = uses_kernel(cfg.march)
    blocked = pallas and h % 32 == 0 and w % 32 == 0
    if blocked:
        b = _auto_block(h, w)
        flat_rays = jax.tree.map(lambda x: _to_blocks(x, h, w, b), rays)
    else:
        flat_rays = jax.tree.map(
            lambda x: x.reshape((w * h,) + x.shape[2:]), rays)

    tile = cfg.tile_rays_pallas if pallas else cfg.tile_rays
    colors = _trace_tiled(scene, flat_rays, cfg.march, tile)
    if blocked:
        return _from_blocks(colors, h, w, b)
    return colors.reshape(h, w, 3)


@partial(jax.jit, static_argnames=("cfg",))
def render(scene: FlatScene, camera: cam.Camera,
           cfg: RenderConfig = RenderConfig()) -> Array:
    """Render the full image → linear RGB float32 [H, W, 3] (row 0 = top)."""
    rays = cam.camera_rays(camera, cfg.width, cfg.height,
                           cfg.epsilon, cfg.length)
    return trace_image(scene, rays, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def render_with_stats(scene: FlatScene, camera: cam.Camera,
                      cfg: RenderConfig = RenderConfig()):
    """``render`` + the number of rays actually marched (primary + shadow
    per facing hit) from the same compiled pipeline — the benchmark uses
    this so the count does not require a second full compilation.
    Returns ``(image [H, W, 3], n_rays scalar f32)``."""
    rays = cam.camera_rays(camera, cfg.width, cfg.height,
                           cfg.epsilon, cfg.length)
    pallas = uses_kernel(cfg.march)
    blocked = pallas and cfg.height % 32 == 0 and cfg.width % 32 == 0
    if blocked:
        b = _auto_block(cfg.height, cfg.width)
        flat_rays = jax.tree.map(
            lambda x: _to_blocks(x, cfg.height, cfg.width, b), rays)
    else:
        flat_rays = jax.tree.map(
            lambda x: x.reshape((cfg.width * cfg.height,) + x.shape[2:]),
            rays)

    tile = cfg.tile_rays_pallas if pallas else cfg.tile_rays
    n = flat_rays.origin.shape[0]
    if tile <= 0 or n <= tile:
        colors, n_rays = shade.trace_with_stats(scene, flat_rays, cfg.march)
    else:
        pad = (-n) % tile
        if pad:
            def pad_leaf(x):
                widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
                return jnp.pad(x, widths)
            flat_rays = jax.tree.map(pad_leaf, flat_rays)
            flat_rays = flat_rays.replace(
                length=flat_rays.length.at[n:].set(0.0))
        chunked = jax.tree.map(
            lambda x: x.reshape((-1, tile) + x.shape[1:]), flat_rays)
        traced = jax.checkpoint(
            lambda s, r: shade.trace_with_stats(s, r, cfg.march))
        colors, counts = jax.lax.map(lambda r: traced(scene, r), chunked)
        colors = colors.reshape((-1, 3))[:n]
        # padded lanes each contribute exactly 1 to the primary count
        n_rays = jnp.sum(counts) - jnp.float32(pad)
    if blocked:
        return _from_blocks(colors, cfg.height, cfg.width, b), n_rays
    return colors.reshape(cfg.height, cfg.width, 3), n_rays


@partial(jax.jit, static_argnames=("cfg",))
def render_image(scene: FlatScene, camera: cam.Camera, key: Array,
                 cfg: RenderConfig = RenderConfig()) -> Array:
    """Render + tone map → dithered uint8 [H, W, 3] (Image.fs:37-50)."""
    linear = render(scene, camera, cfg)
    return tonemap.tonemap(linear, key, cfg.gamma)


def render_scene(scene: Scene, camera: cam.Camera,
                 cfg: RenderConfig = RenderConfig()) -> Array:
    """Convenience: flatten a builder Scene and render linear RGB."""
    return render(flatten(scene), camera, cfg)
