"""Lambert + hard-shadow integrator over batched hits.

Vectorized re-expression of the reference's scene integrator
(``SdfScene.trace``, SdfScene.fs:7-28) and light closures (``SdfLight.fs``):

* miss → background color,
* hit  → ``albedo · (background + Σ_lights 1[facing ∧ unoccluded] · I · cosθ)
  / π`` — background doubles as the ambient term (SdfScene.fs:12),
* directional light: unoccluded intensity = color, shadow-ray budget
  ``shadow_length`` (the reference's hardcoded 1000, SdfLight.fs:14),
* point light: intensity = color / dist², shadow-ray budget = distance
  (SdfLight.fs:23-42).  The reference's non-unit shadow direction bug
  (SdfLight.fs:30) is fixed: shadow rays use unit directions.

Shadow rays are batched per light (the light loop unrolls — light count and
kinds are static) so each light costs exactly one extra masked march over
the whole pixel batch, mirroring the ≤3-traces-per-pixel structure of the
reference workload (SURVEY.md §3.1).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.flatten import FlatScene
from ..scene.nodes import LIGHT_DIRECTIONAL, LIGHT_POINT
from ..types import Rays, SurfaceHit, dot, normalize
from . import sdf
from .march import (BLOCK, MarchConfig, block_take, march,
                    march_occlusion, march_surface, occlusion_compacted,
                    uses_kernel)

Array = jax.Array


def resolve_material(scene: FlatScene, pos: Array, hit: Array,
                     midx: Array, blocks: bool = False) -> Array:
    """Repair ``midx == -1`` on *hit* lanes from the fused surface pass.

    The kernel's material argmin only sees the tile's cone-selected
    candidate list; a hit on a material-less surface (e.g. a CSG cutter)
    whose nearest material-bearing primitive lies outside that list
    reports -1 (advisor round 2, medium).  The reference's contract is a
    *global* argmin over visible material primitives (SdfObject.fs:26-46).

    Repairs are tiered: none (free); with ``blocks`` (the kernel paths,
    whose rays come in screen-block order), bad lanes in ≤ BCAP blocks of
    BLOCK rays → take those blocks and dense-evaluate them (bad lanes are
    spatially clustered on cutter surfaces, and a block-granular top_k
    runs over n/BLOCK keys instead of the per-lane top_k the lane tier
    pays); then ≤ CAP bad lanes → lane gather; else the full dense
    sweep."""
    bad = hit & (midx < 0)
    # the repair only computes an integer index — detach everything so no
    # AD path runs through the selection
    flatpos = jax.lax.stop_gradient(pos).reshape(-1, 3)
    flatbad = bad.reshape(-1)
    flatm = midx.reshape(-1)
    n = flatpos.shape[0]
    CAP = min(4096, n)

    def dense(_):
        ch = min(16384, n)
        pad = (-n) % ch
        fp = jnp.pad(flatpos, ((0, pad), (0, 0)))
        m = jax.lax.map(lambda p: sdf.material_at(scene, p)[0],
                        fp.reshape(-1, ch, 3))
        return jnp.where(flatbad, m.reshape(-1)[:n], flatm)

    def capped(_):
        _v, idx = jax.lax.top_k(flatbad.astype(jnp.int32), CAP)
        pts = flatpos[idx]
        m = sdf.material_at(scene, pts)[0]
        fixed = flatm.at[idx].set(
            jnp.where(flatbad[idx], m, flatm[idx]))
        return fixed

    def lane_tiers(_):
        nbad = jnp.sum(flatbad.astype(jnp.int32))
        return jax.lax.cond(
            nbad == 0, lambda _: flatm,
            lambda _: jax.lax.cond(nbad <= CAP, capped, dense, None), None)

    if blocks and n % BLOCK == 0 and n // BLOCK > 1:
        nb = n // BLOCK
        BCAP = min(16, nb)
        anyb = jnp.any(flatbad.reshape(nb, BLOCK), axis=1)
        nbb = jnp.sum(anyb.astype(jnp.int32))

        def block_repair(_):
            _v, bidx = jax.lax.top_k(anyb.astype(jnp.int32), BCAP)
            bidx = bidx.astype(jnp.int32)
            pts = block_take(flatpos, bidx)
            m = sdf.material_at(scene, pts)[0].reshape(BCAP, BLOCK)
            cur = flatm.reshape(nb, BLOCK)
            badb = flatbad.reshape(nb, BLOCK)[bidx]
            new = jnp.where(badb, m, cur[bidx])
            return cur.at[bidx].set(new).reshape(-1)

        out = jax.lax.cond(
            nbb == 0, lambda _: flatm,
            lambda _: jax.lax.cond(nbb <= BCAP, block_repair,
                                   lane_tiers, None), None)
    else:
        out = lane_tiers(None)
    return out.reshape(midx.shape)


def surface_hit(scene: FlatScene, rays: Rays,
                cfg: MarchConfig = MarchConfig()) -> SurfaceHit:
    """March + assemble shading-ready hit info (reference
    ``SdfObject.tryTrace``, SdfObject.fs:66-78): position backed off by
    epsilon along the ray, analytic unit normal there, and the winning
    material's albedo (CSG-aware argmin, SdfObject.fs:26-64)."""
    if uses_kernel(cfg) and cfg.fuse_surface:
        # fast path: normals + material argmin from the surface kernel
        res, normal, midx = march_surface(scene, rays, cfg)
        pos = rays.at(res.t - rays.epsilon)
        midx = resolve_material(scene, pos, res.hit, midx, blocks=True)
        albedo = sdf.albedo_of(scene, jnp.maximum(midx, 0), pos)
        return SurfaceHit(hit=res.hit, position=pos, normal=normal,
                          color=albedo, material=midx, t=res.t)
    res = march(scene, rays, cfg)
    # Back off by epsilon (Ray.move -epsilon, SdfObject.fs:73): shading and
    # normal are evaluated at the backed-off point, like the reference's
    # normalFromRay (SdfForm.fs:114-115).
    pos = rays.at(res.t - rays.epsilon)
    out = None
    if cfg.cull and uses_kernel(cfg):
        # big-scene fast path: normals/materials over per-tile candidate
        # lists instead of every primitive (ops/point_eval.py)
        from .point_eval import culled_surface_eval
        batch = res.hit.shape
        out = culled_surface_eval(
            scene, pos.reshape(-1, 3), res.hit.reshape(-1),
            m=cfg.cull_m, threshold=cfg.cull_threshold)
        if out is not None:
            normal = out[0].reshape(batch + (3,))
            midx = out[1].reshape(batch)
            albedo = out[2].reshape(batch + (3,))
    if out is None:
        normal = sdf.scene_normal(scene, pos)
        midx, albedo = sdf.material_at(scene, pos)
    midx = jnp.where(res.hit, midx, -1)
    return SurfaceHit(hit=res.hit, position=pos, normal=normal,
                      color=albedo, material=midx, t=res.t)


def light_dir_and_dist(scene: FlatScene, i: int, pos: Array):
    """Unit direction from ``pos`` toward light ``i`` and the shadow budget.
    Returns (dir [...,3], budget [...], intensity_scale [...])."""
    kind = scene.light_kind[i]
    vec = scene.light_vec[i]
    if kind == LIGHT_DIRECTIONAL:
        d = -vec / jnp.sqrt(jnp.maximum(jnp.sum(vec * vec), 1e-20))
        ldir = jnp.broadcast_to(d, pos.shape)
        budget = jnp.broadcast_to(scene.light_shadow_len[i], pos.shape[:-1])
        scale = jnp.ones(pos.shape[:-1], jnp.float32)
        return ldir, budget, scale
    if kind == LIGHT_POINT:
        diff = vec - pos
        dist2 = jnp.maximum(dot(diff, diff), 1e-12)
        dist = jnp.sqrt(dist2)
        return diff / dist[..., None], dist, 1.0 / dist2
    raise ValueError(f"bad light kind {kind}")


def shade(scene: FlatScene, rays: Rays, hit: SurfaceHit,
          cfg: MarchConfig = MarchConfig()) -> Array:
    """Shade a batch of surface hits → linear RGB ``[..., 3]``.

    Shadow rays march per light, in the pixel-tile order of the primary
    rays.  (Dead ends tried on the benchmark: batching all lights into
    one kernel call serializes against its own candidate prep; re-tiling
    shadow rays by hit-point Morton locality costs more in sorts/gathers
    and mixed tiles than it saves in cull width.)
    """
    return shade_with_stats(scene, rays, hit, cfg)[0]


def shade_with_stats(scene: FlatScene, rays: Rays, hit: SurfaceHit,
                     cfg: MarchConfig = MarchConfig()):
    """``shade`` + the number of shadow rays actually marched (facing
    lanes per light — the reference's ≤3-traces-per-pixel accounting,
    SURVEY.md §3.1).  Returns ``(color [..., 3], n_shadow scalar f32)``."""
    light_acc = jnp.broadcast_to(scene.background, hit.position.shape)
    n_shadow = jnp.float32(0.0)

    for i in range(scene.num_lights):
        ldir, budget, scale = light_dir_and_dist(scene, i, hit.position)
        cos = dot(hit.normal, ldir)
        facing = hit.hit & (cos > 0.0)
        shadow_rays = Rays(
            origin=hit.position,
            direction=ldir,
            # only march facing lanes: zero budget de-activates the rest
            length=jnp.where(facing, budget, 0.0),
            epsilon=rays.epsilon,
        )
        # point-light shadow rays all terminate AT the light (budget =
        # distance): hand the kernel that apex so candidate selection uses
        # the exact converging cone instead of a bounding ball.  The
        # axial sort key is the origin's position along the light axis
        # (distance to the light for point lights).
        if scene.light_kind[i] == LIGHT_POINT:
            apex = jax.lax.stop_gradient(scene.light_vec[i])
            akey = budget                      # = |pos - light|
        else:
            apex = None
            akey = dot(hit.position, ldir)     # ldir constant per lane
        if cfg.shadow_compact and uses_kernel(cfg):
            occluded = occlusion_compacted(scene, shadow_rays, facing, cfg,
                                           cone_apex=apex, axial_key=akey)
        else:
            occluded = march_occlusion(scene, shadow_rays, cfg,
                                       cone_apex=apex, axial_key=akey)
        n_shadow = n_shadow + jnp.sum(facing.astype(jnp.float32))
        contrib = (scene.light_color[i] * scale[..., None]
                   * cos[..., None])
        light_acc = light_acc + jnp.where(
            (facing & ~occluded)[..., None], contrib, 0.0)

    lit = hit.color * light_acc * jnp.float32(1.0 / math.pi)
    # add emission (wavefront/spectral materials; zero for plain solids)
    emission = jnp.where(hit.material[..., None] >= 0,
                         scene.mat_emission[jnp.maximum(hit.material, 0)],
                         0.0)
    shaded = lit + emission
    return jnp.where(hit.hit[..., None], shaded, scene.background), n_shadow


def trace(scene: FlatScene, rays: Rays,
          cfg: MarchConfig = MarchConfig()) -> Array:
    """Full primary trace: march → surface info → shade.  The batched
    equivalent of ``SdfScene.trace scene ray`` (SdfScene.fs:7-28)."""
    hit = surface_hit(scene, rays, cfg)
    return shade(scene, rays, hit, cfg)


def trace_with_stats(scene: FlatScene, rays: Rays,
                     cfg: MarchConfig = MarchConfig()):
    """``trace`` + the total rays marched (primary + shadow), so the
    benchmark's ray count comes out of the *same* compiled pipeline it
    times instead of a second full compilation (round-2 timeout cause).
    Returns ``(color [..., 3], n_rays scalar f32)``."""
    hit = surface_hit(scene, rays, cfg)
    color, n_shadow = shade_with_stats(scene, rays, hit, cfg)
    n_primary = jnp.float32(np.prod(hit.hit.shape))
    return color, n_primary + n_shadow
