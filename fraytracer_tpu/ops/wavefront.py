"""Wavefront spectral path integrator: secondary rays as an iterative queue.

This realizes the reference's "materials may create subsequent rays" design
goal (``README.md:10-12``) — whose only realized instance is the shadow-ray
recursion in ``SdfLight.fs:10-21`` — as an **iterative wavefront**
(SURVEY.md §5 "long-context analog", BASELINE config 4: depth-4 bounce queue):

* a fixed-capacity flat ray buffer (structure-of-arrays) replaces recursion;
* each bounce round marches *all* active rays in lockstep (one masked march),
  shades diffuse hits with next-event light sampling, and spawns Fresnel
  reflection/refraction children for specular/dielectric hits;
* children (up to 2 per ray) are written to a double-width buffer and
  **compacted by throughput** back to capacity — a sort-based compaction, no
  dynamic shapes under jit;
* per-ray wavelength bins (BASELINE config 3) drive dispersive refraction;
  contributions accumulate into the RGB image via the bin response filters.

Cross-chip: rays are data-parallel; the parallel layer shards the pixel
batch and this module runs unchanged per shard.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.flatten import FlatScene
from ..scene.nodes import MAT_DIELECTRIC, MAT_MIRROR, MAT_SOLID
from ..types import Rays, dot, normalize, pytree_dataclass
from . import sdf, spectral
from .march import (BLOCK, MarchConfig, block_take, march_occlusion,
                    march_surface, resolve_backend, uses_kernel)
from .shade import light_dir_and_dist, resolve_material

Array = jax.Array


@pytree_dataclass
class RayQueue:
    """Fixed-capacity wavefront ray buffer (SoA).  ``pixel`` indexes the
    flat image; ``wl`` is the wavelength-bin index; ``throughput`` the
    scalar path weight for that bin; ``inside`` tracks the medium for
    refraction; inactive lanes have ``active=False`` and zero budget."""

    origin: Array      # [C, 3]
    direction: Array   # [C, 3]
    pixel: Array       # [C] int32
    wl: Array          # [C] int32 wavelength bin
    throughput: Array  # [C] float32
    length: Array      # [C] float32 remaining budget
    inside: Array      # [C] bool — currently inside a dielectric
    active: Array      # [C] bool


@dataclasses.dataclass(frozen=True, eq=True)
class WavefrontConfig:
    """Static wavefront parameters (BASELINE configs 3-4)."""

    depth: int = 4                  # bounce rounds
    num_bins: int = spectral.NUM_BINS
    epsilon: float = 0.01
    length: float = 30.0
    march: MarchConfig = MarchConfig()
    min_throughput: float = 1e-3    # kill paths below this weight
    # children below this weight are first to drop on queue overflow (they
    # still render when capacity allows); see _bounce compaction
    overflow_drop_threshold: float = 0.05
    # candidate-table slots for bounce-round marches AND their shadow
    # occlusions: secondary tiles diverge until the cone test collapses
    # to a bounding ball, so conservative counts approach the group size
    # — sized so the full-table re-march never fires mid-frame (sharing
    # cull_m_shadow with the camera path once put every bounce round on
    # that re-march)
    bounce_cull_m: int = 1024


def block_compact_key(klass: Array, block: int) -> Array:
    """Per-block sort key for block-granular queue compaction.

    ``klass [2C]`` ∈ {0: active+meaningful, 1: active+low-throughput,
    2: dead}.  Blocks are ranked by how much shippable energy they carry:
    key = −Σ(2 − klass) — fully-meaningful blocks first, fully-dead last.
    A density (count-based) key, NOT the min-lane class: ranking by the
    best lane in the block kept sparse blocks (one live lane + 127 dead)
    ahead of dense ones, so when class-0 lanes spanned more than C/block
    blocks the drop discarded dense active blocks (advisor r4 low)."""
    w = 2 - klass.reshape(-1, block)
    return -jnp.sum(w, axis=1)


def compact_queue(both: RayQueue, klass: Array, capacity: int,
                  blocks: bool) -> RayQueue:
    """Compact the 2C child buffer ``both`` to ``capacity`` lanes by the
    stable three-class partition ``klass`` (see ``_bounce``).

    ``blocks`` (the compiled-kernel path) keeps whole BLOCK-ray blocks,
    ranked by :func:`block_compact_key`, in their original order among
    equals — children stay in screen-block order, so the march kernel's
    per-tile cones keep working across bounces.  A kept block may carry
    dead lanes (they march as no-ops); on overflow the densest active
    blocks are kept.  Otherwise the partition is applied per lane."""
    if blocks and capacity % BLOCK == 0:
        keep = jnp.argsort(block_compact_key(klass, BLOCK),
                           stable=True)[:capacity // BLOCK]
        return jax.tree.map(lambda x: block_take(x, keep), both)
    order = jnp.argsort(klass, stable=True)[:capacity]
    return jax.tree.map(lambda x: x[order], both)


def _shade_local(scene: FlatScene, pos: Array, normal: Array,
                 eps: Array, cfg: WavefrontConfig):
    """Direct lighting at hit points (Lambert + hard shadows), RGB [...,3],
    plus the number of shadow rays marched.  Same math as ops.shade
    (SdfScene.fs:7-28) on arbitrary point batches."""
    from ..scene.nodes import LIGHT_POINT as _LP
    light_acc = jnp.broadcast_to(scene.background, pos.shape)
    n_shadow = jnp.float32(0.0)
    for i in range(scene.num_lights):
        ldir, budget, scale = light_dir_and_dist(scene, i, pos)
        cos = dot(normal, ldir)
        facing = cos > 0.0
        shadow = Rays(origin=pos, direction=ldir,
                      length=jnp.where(facing, budget, 0.0), epsilon=eps)
        if scene.light_kind[i] == _LP:
            apex = jax.lax.stop_gradient(scene.light_vec[i])
            akey = budget
        else:
            apex = None
            akey = dot(pos, ldir)
        occluded = march_occlusion(scene, shadow, cfg.march,
                                   cone_apex=apex, axial_key=akey)
        n_shadow = n_shadow + jnp.sum(facing.astype(jnp.float32))
        contrib = scene.light_color[i] * scale[..., None] * cos[..., None]
        light_acc = light_acc + jnp.where((facing & ~occluded)[..., None],
                                          contrib, 0.0)
    return light_acc, n_shadow


def _bounce(scene: FlatScene, q: RayQueue, image: Array,
            cfg: WavefrontConfig, is_last: bool):
    """One wavefront round: march → shade/accumulate → spawn children →
    compact.  Returns (new_queue, new_image, n_rays_marched)."""
    C = q.origin.shape[0]
    eps = jnp.full((C,), cfg.epsilon, jnp.float32)
    rays = Rays(origin=q.origin, direction=q.direction,
                length=jnp.where(q.active, q.length, 0.0), epsilon=eps)
    # rays inside a dielectric march the *negated* SDF toward the exit
    # surface (transmission); outside rays march normally
    sign = jnp.where(q.inside, -1.0, 1.0)
    # bounce rays diverge off curved geometry → near-omnidirectional tiles
    # whose conservative candidate count can reach the group size: use the
    # bounce-sized table so the dense-fallback cond never fires mid-frame
    mcfg = dataclasses.replace(
        cfg.march, cull_m=max(cfg.march.cull_m, cfg.bounce_cull_m),
        cull_m_shadow=max(cfg.march.cull_m_shadow, cfg.bounce_cull_m))
    # fused march+surface: normals and the material argmin come out of the
    # march kernel itself (culled), not a dense [N, K] second pass
    res, nrm, midx = march_surface(scene, rays, mcfg, sign=sign)
    hit = res.hit & q.active
    missed = q.active & ~res.hit
    n_marched = jnp.sum(q.active.astype(jnp.float32))

    # Surface frame at hits (backed off by epsilon, SdfObject.fs:73)
    pos = rays.at(res.t - eps)
    # repair culled-argmin material misses on cutter surfaces (shade.py)
    midx = jnp.maximum(resolve_material(scene, pos, hit, midx,
                                        blocks=uses_kernel(cfg.march)), 0)
    albedo = sdf.albedo_of(scene, midx, pos)
    mat_kind = jnp.asarray(np.asarray(scene.mat_kind, np.int32))[midx]

    filt = spectral.bin_rgb(q.wl) * jnp.float32(cfg.num_bins)  # [C,3]
    w = q.throughput[..., None] * filt                          # [C,3]

    # ---- miss → background (SdfScene.fs:10) --------------------------------
    bg_contrib = jnp.where(missed[..., None], w * scene.background, 0.0)

    # ---- diffuse shading term ---------------------------------------------
    # bounce-round shadow origins sit on scattered secondary surfaces —
    # their occlusion tables need the bounce sizing too
    light_rgb, n_shadow = _shade_local(
        scene, pos, nrm, eps, dataclasses.replace(cfg, march=mcfg))
    n_marched = n_marched + n_shadow
    emission = scene.mat_emission[midx]
    lambert = albedo * light_rgb * jnp.float32(1.0 / math.pi) + emission

    is_solid = mat_kind == MAT_SOLID
    is_mirror = mat_kind == MAT_MIRROR
    is_diel = mat_kind == MAT_DIELECTRIC
    refl = scene.mat_reflectivity[midx]

    # solids emit their full shade; mirrors emit the (1-ρ) diffuse part;
    # dielectrics are pure specular (no diffuse term)
    diffuse_w = jnp.where(is_solid, 1.0, jnp.where(is_mirror, 1.0 - refl, 0.0))
    hit_contrib = jnp.where(hit[..., None], w * lambert * diffuse_w[..., None],
                            0.0)

    image = image.at[q.pixel].add(bg_contrib + hit_contrib)
    if is_last:
        # terminal round: drop unfinished specular energy (bounded bias,
        # like any fixed-depth path truncation)
        return q, image, n_marched

    # ---- children ----------------------------------------------------------
    # orient the shading normal against the incident ray for Fresnel
    n_face = jnp.where(dot(nrm, q.direction)[..., None] > 0.0, -nrm, nrm)
    ior = spectral.cauchy_ior(scene.mat_ior[midx], q.wl)
    n1 = jnp.where(q.inside, ior, 1.0)
    n2 = jnp.where(q.inside, 1.0, ior)
    R, refl_dir, refr_dir, tir = spectral.fresnel(q.direction, n_face, n1, n2)

    remaining = jnp.maximum(q.length - res.t, 0.0)

    # Children spawn from the true surface point with a 3·epsilon offset —
    # anything less can leave the child within the epsilon hit shell of the
    # surface it just left, terminating it instantly.
    surf = rays.at(res.t)

    # child A: reflection (mirror ρ, dielectric Fresnel R)
    refl_T = q.throughput * jnp.where(is_mirror, refl, jnp.where(is_diel, R, 0.0))
    child_a_active = hit & (is_mirror | is_diel) & (refl_T > cfg.min_throughput)
    # reflected rays leave the surface: offset along the face normal
    a_origin = surf + 3.0 * eps[..., None] * n_face

    # child B: refraction (dielectric only, no TIR).  The RGB transmission
    # tint is sampled at the ray's wavelength bin: project tint onto the
    # bin's RGB response.
    bfilt = spectral.bin_rgb(q.wl)
    tint = (jnp.sum(bfilt * scene.mat_tint[midx], axis=-1)
            / jnp.maximum(jnp.sum(bfilt, axis=-1), 1e-6))
    refr_T = q.throughput * jnp.where(is_diel, (1.0 - R) * tint, 0.0)
    child_b_active = hit & is_diel & ~tir & (refr_T > cfg.min_throughput)
    b_origin = surf - 3.0 * eps[..., None] * n_face
    refr_dir = normalize(refr_dir)

    def mk(origin, direction, T, active, inside):
        return RayQueue(
            origin=origin, direction=direction, pixel=q.pixel, wl=q.wl,
            throughput=jnp.where(active, T, 0.0),
            length=jnp.where(active, remaining, 0.0),
            inside=inside, active=active)

    child_a = mk(a_origin, refl_dir, refl_T, child_a_active, q.inside)
    child_b = mk(b_origin, refr_dir, refr_T, child_b_active, ~q.inside)

    # ---- compaction: 2C → C (sort-based, static shapes) --------------------
    # Stable three-class partition: (0) active children with meaningful
    # throughput, in original order — children inherit the parents' pixel
    # order, so the compacted queue stays spatially coherent and the march
    # kernel's per-tile cone culling keeps working across bounces; (1)
    # active but below ``overflow_drop_threshold`` throughput; (2) dead.
    # On overflow (> C active children, i.e. a fully specular frame) the
    # tail dropped is therefore the *lowest-energy* block, not whichever
    # refraction children happened to sort last (advisor round 2: the pure
    # actives-first partition biased rendered energy by discarding
    # possibly-high-energy refractions while keeping negligible
    # reflections).
    both = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                        child_a, child_b)
    low = both.active & (both.throughput < cfg.overflow_drop_threshold)
    klass = (~both.active).astype(jnp.int32) * 2 + low.astype(jnp.int32)
    new_q = compact_queue(both, klass, C, _block_compaction(cfg))
    return new_q, image, n_marched


def _block_compaction(cfg: WavefrontConfig) -> bool:
    """Block-granular queue compaction runs with the compiled kernel."""
    return resolve_backend(cfg.march.backend) == "pallas"


@partial(jax.jit, static_argnames=("width", "height", "cfg"))
def render_spectral_with_stats(scene: FlatScene, camera, width: int,
                               height: int,
                               cfg: WavefrontConfig = WavefrontConfig()):
    """Spectral wavefront render → (linear RGB [H, W, 3], rays marched).

    **Shared primary round**: camera rays are identical for every
    wavelength bin (dispersion begins at the first specular surface), so
    round 0 marches ONE ray per pixel and accumulates the diffuse/miss
    terms with the summed bin weight — exactly the per-bin result, at 1/B
    of the march cost.  Specular hits then spawn per-bin Fresnel children
    (per-bin IOR → dispersion) into the wavefront queue; rounds 1..depth-1
    run the queue as before.  Scenes with no mirror/dielectric materials
    (a static property) skip the queue entirely — matching the reference,
    whose only realized secondary rays are shadows (SdfLight.fs:10-21),
    while dielectric scenes exercise the full README.md:7 optics.
    """
    from ..camera import camera_rays  # local import to avoid cycle

    base = camera_rays(camera, width, height, cfg.epsilon, cfg.length)
    npix = width * height
    B = cfg.num_bins
    # screen-block ordering (pure transpose — render.py._to_blocks): the
    # march kernel's per-tile cones need spatially coherent tiles; raster
    # order makes every tile a full-width strip (measured 4× slower)
    blocked = (uses_kernel(cfg.march)
               and height % 32 == 0 and width % 32 == 0)
    if blocked:
        from ..render import _auto_block, _from_blocks, _to_blocks
        bsz = _auto_block(height, width)
        o0 = _to_blocks(base.origin, height, width, bsz)
        d0 = _to_blocks(base.direction, height, width, bsz)
    else:
        o0 = base.origin.reshape(npix, 3)
        d0 = base.direction.reshape(npix, 3)
    rays0 = Rays(origin=o0, direction=d0,
                 length=jnp.full((npix,), cfg.length, jnp.float32),
                 epsilon=jnp.full((npix,), cfg.epsilon, jnp.float32))

    # ---- round 0: one march shared by all bins --------------------------
    res, nrm, midx = march_surface(scene, rays0, cfg.march)
    hit = res.hit
    missed = ~hit
    n_rays = jnp.float32(npix)
    eps = rays0.epsilon
    pos = rays0.at(res.t - eps)
    midx = jnp.maximum(resolve_material(scene, pos, hit, midx,
                                        blocks=uses_kernel(cfg.march)), 0)
    albedo = sdf.albedo_of(scene, midx, pos)
    mat_kind = jnp.asarray(np.asarray(scene.mat_kind, np.int32))[midx]

    # summed per-bin weight: Σ_b (1/B)·(bin_rgb·B) = Σ_b bin_rgb ≈ (1,1,1)
    w0 = jnp.asarray(spectral.BIN_RGB.sum(axis=0))            # [3]

    light_rgb, n_shadow = _shade_local(scene, pos, nrm, eps, cfg)
    n_rays = n_rays + n_shadow
    emission = scene.mat_emission[midx]
    lambert = albedo * light_rgb * jnp.float32(1.0 / math.pi) + emission
    is_solid = mat_kind == MAT_SOLID
    is_mirror = mat_kind == MAT_MIRROR
    is_diel = mat_kind == MAT_DIELECTRIC
    refl = scene.mat_reflectivity[midx]
    diffuse_w = jnp.where(is_solid, 1.0,
                          jnp.where(is_mirror, 1.0 - refl, 0.0))
    image = jnp.where(missed[..., None], w0 * scene.background,
                      w0 * lambert * diffuse_w[..., None])    # [npix, 3]

    def finish(img):
        # the image buffer lives in screen-block order (aligned with the
        # rays; children carry block-order pixel ids) — unblock at the end
        if blocked:
            return _from_blocks(img, height, width, bsz)
        return img.reshape(height, width, 3)

    has_specular = any(k in (MAT_MIRROR, MAT_DIELECTRIC)
                       for k in scene.mat_kind)
    if not has_specular or cfg.depth <= 1:
        return finish(image), n_rays

    # ---- per-bin specular children from the shared hits -----------------
    # PIXEL-MAJOR layout: each parent's B wavelength children are
    # ADJACENT (index = pixel·B + bin).  Dispersion spreads the bins only
    # slightly, so a 4096-lane kernel tile holds 512 neighboring parents
    # instead of 4096 unrelated ones — the difference between a usable
    # bounce cone and a bounding ball.  jnp.repeat(x, B, axis=0) is a
    # broadcast+reshape, not a gather.
    n_face = jnp.where(dot(nrm, rays0.direction)[..., None] > 0.0,
                       -nrm, nrm)

    def repB(x):
        return jnp.repeat(x, B, axis=0)

    wl = jnp.tile(jnp.arange(B, dtype=jnp.int32), (npix,))   # [npix*B]
    pixel = jnp.repeat(jnp.arange(npix, dtype=jnp.int32), B)
    ior_b = spectral.cauchy_ior(repB(scene.mat_ior[midx]), wl)

    dirB, nfB = repB(rays0.direction), repB(n_face)
    n1 = jnp.ones((B * npix,), jnp.float32)
    R, refl_dir, refr_dir, tir = spectral.fresnel(dirB, nfB, n1, ior_b)

    hitB, mirB, dielB = repB(hit), repB(is_mirror), repB(is_diel)
    reflB = repB(refl)
    remaining = repB(jnp.maximum(rays0.length - res.t, 0.0))
    surf = repB(rays0.at(res.t))
    epsB = repB(eps)

    T0 = jnp.float32(1.0 / B)
    refl_T = T0 * jnp.where(mirB, reflB, jnp.where(dielB, R, 0.0))
    a_act = hitB & (mirB | dielB) & (refl_T > cfg.min_throughput)
    a_origin = surf + 3.0 * epsB[..., None] * nfB

    bfilt = spectral.bin_rgb(wl)
    tintB = repB(scene.mat_tint[midx])
    tint = (jnp.sum(bfilt * tintB, axis=-1)
            / jnp.maximum(jnp.sum(bfilt, axis=-1), 1e-6))
    refr_T = T0 * jnp.where(dielB, (1.0 - R) * tint, 0.0)
    b_act = hitB & dielB & ~tir & (refr_T > cfg.min_throughput)
    b_origin = surf - 3.0 * epsB[..., None] * nfB
    refr_dir = normalize(refr_dir)

    def mk(origin, direction, T, active, inside):
        return RayQueue(
            origin=origin, direction=direction, pixel=pixel, wl=wl,
            throughput=jnp.where(active, T, 0.0),
            length=jnp.where(active, remaining, 0.0),
            inside=inside, active=active)

    child_a = mk(a_origin, refl_dir, refl_T, a_act,
                 jnp.zeros((B * npix,), bool))
    child_b = mk(b_origin, refr_dir, refr_T, b_act,
                 jnp.ones((B * npix,), bool))

    # compact 2·B·npix → C = B·npix (same 3-class partition as _bounce)
    both = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                        child_a, child_b)
    low = both.active & (both.throughput < cfg.overflow_drop_threshold)
    klass = (~both.active).astype(jnp.int32) * 2 + low.astype(jnp.int32)
    q = compact_queue(both, klass, B * npix, _block_compaction(cfg))

    for bounce in range(1, cfg.depth):
        q, image, n_m = _bounce(scene, q, image, cfg,
                                is_last=(bounce == cfg.depth - 1))
        n_rays = n_rays + n_m

    return finish(image), n_rays


def render_spectral(scene: FlatScene, camera, width: int, height: int,
                    cfg: WavefrontConfig = WavefrontConfig()) -> Array:
    """Spectral wavefront render → linear RGB [H, W, 3] (see
    render_spectral_with_stats).  With purely diffuse scenes this
    reproduces the plain render (the bin filters sum to 1);
    dielectric/mirror materials add dispersive refraction, reflection and
    TIR — the reference's end-goal optics (README.md:7, Light.fs)."""
    return render_spectral_with_stats(scene, camera, width, height, cfg)[0]
