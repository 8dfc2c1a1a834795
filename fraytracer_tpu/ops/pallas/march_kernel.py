"""Fused Pallas sphere-march kernel for the GPU (Triton route).

SURVEY.md §7 stage 3: the hot loop — (SDF eval over primitives → CSG
combine → masked step) iterated until every ray of a block converges —
fused into one kernel whose march state lives in registers.

Architecture:

* one Triton program marches a 1-D block of ``BLOCK_RAYS`` rays and runs
  the whole step loop itself; the block exits as soon as its last lane
  terminates;
* large homogeneous union groups are pruned per culling tile of
  ``RAY_TILE`` rays (several programs share one tile) by a conservative
  cone-vs-bounding-sphere test (the analog of the reference's uniform
  grid, SdfBoundary.fs:225-282), and the surviving candidates are sorted
  by their position along the tile's cone axis — this candidate prep is
  plain ``jnp`` (``_tile_cones``, ``_cand_mask``, ``_cone_candidates``);
* **each march step evaluates only an axial window of that list**: from
  the block's live t-range the kernel derives, per step, which candidate
  chunks can possibly be within ``window_clamp`` of any active ray point —
  everything provably behind or ahead is skipped, and the skipped mass
  contributes a per-lane lower-bound cap ``min(AH - t, t·cosθ - BH)`` so
  steps through empty space stay long.  This is the reference grid's
  "sorted nearest-first with precomputed lower bounds" idea
  (SdfBoundary.fs:266-282) re-expressed along the ray axis;
* window candidates evaluate ``CAND_UNROLL`` at a time as one
  ``[CAND_UNROLL, BLOCK_RAYS]`` block, each program loading its own tile's
  candidate rows and window keys from device memory;
* primitives outside culled groups (the CSG scene's bounding spheres)
  evaluate one at a time with broadcast scalar parameters;
* an optional fused **surface pass** runs once after the march: analytic
  normals (in-kernel AD of the same candidate evaluation) and the
  CSG-aware winning material (argmin over material-visible primitives,
  SdfObject.fs:26-64).

The kernel is generated per scene *structure* (plan + kind layout — static,
cached); parameters stay runtime arrays, so scene edits and gradients don't
recompile.  Every block dimension is a power of two, as the Triton route
requires; tables with other widths are read by index, never as a block.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...scene.flatten import FlatScene, Plan, PARAM_WIDTH, visible_materials
from ...types import MarchResult, Rays, dot, norm, normalize
from ..march import MarchConfig, bound_skip_start

Array = jax.Array

# Rays per culling tile: one candidate table (and one cone) per tile.  The
# render orders pixels in square screen blocks of this many rays
# (render._auto_block) so a tile's ray cone stays narrow.
RAY_TILE = 1024
# Rays per Triton program (a power of two dividing RAY_TILE) and the warps
# that run it: one warp per 32-ray program, whose candidate windows span
# only its own rays (the fastest shape of the tools/kernel_ab.py sweep on
# an H100; 256-ray culling tiles lost).  Interpret mode (CPU tests) runs
# one program per culling tile instead: the interpreter's cost grows with
# the number of programs.
BLOCK_RAYS = 32
NUM_WARPS = 1
# Candidates evaluated per window-loop iteration as one [CAND_UNROLL,
# BLOCK_RAYS] block; the windows are kept at this chunk granularity.
CAND_UNROLL = 8
# Chunks evaluated per early-out test when ``cull_early_out`` is on.
EO_STRIDE = 2
# Runs of at most this many non-culled primitives unroll at trace time;
# longer runs loop over rows.
UNROLL_RUN = 8
_BIG = 3.0e38


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Generic per-kind distance math.  Written once over an accessor ``g(j)``
# that yields the j-th parameter as either a scalar (one primitive) or a
# [CAND_UNROLL, 1] column (a candidate chunk); the ray coordinates
# (px, py, pz) broadcast against it.
# Same semantics as ops.sdf (reference formulas cited there).
# ---------------------------------------------------------------------------

def _d_sphere_gen(g, px, py, pz):
    dx = px - g(0)
    dy = py - g(1)
    dz = pz - g(2)
    return jnp.sqrt(dx * dx + dy * dy + dz * dz + 1e-20) - g(3)


def _d_capsule_gen(g, px, py, pz):
    ax, ay, az = g(0), g(1), g(2)
    bx, by, bz = g(3), g(4), g(5)
    r = g(6)
    bax, bay, baz = bx - ax, by - ay, bz - az
    pax, pay, paz = px - ax, py - ay, pz - az
    denom = jnp.maximum(bax * bax + bay * bay + baz * baz, 1e-20)
    h = jnp.clip((pax * bax + pay * bay + paz * baz) / denom, 0.0, 1.0)
    ex, ey, ez = pax - h * bax, pay - h * bay, paz - h * baz
    return jnp.sqrt(ex * ex + ey * ey + ez * ez + 1e-20) - r


def _d_torus_gen(g, px, py, pz, unit_axis=False):
    cx, cy, cz = g(0), g(1), g(2)
    nx, ny, nz = g(3), g(4), g(5)
    R, r = g(6), g(7)
    if not unit_axis:
        ninv = jax.lax.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    qx, qy, qz = px - cx, py - cy, pz - cz
    h = qx * nx + qy * ny + qz * nz
    q2 = qx * qx + qy * qy + qz * qz
    radial = jnp.sqrt(jnp.maximum(q2 - h * h, 1e-20)) - R
    return jnp.sqrt(h * h + radial * radial + 1e-20) - r


def _d_box_gen(g, px, py, pz):
    qx = jnp.abs(px - g(0)) - g(3)
    qy = jnp.abs(py - g(1)) - g(4)
    qz = jnp.abs(pz - g(2)) - g(5)
    ox = jnp.maximum(qx, 0.0)
    oy = jnp.maximum(qy, 0.0)
    oz = jnp.maximum(qz, 0.0)
    outside = jnp.sqrt(ox * ox + oy * oy + oz * oz + 1e-20)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    return outside + inside - g(6)


def _d_plane_gen(g, px, py, pz):
    return px * g(0) + py * g(1) + pz * g(2) - g(3)


def _d_cone_gen(g, px, py, pz):
    ax, ay, az = g(0), g(1), g(2)
    bx, by, bz = g(3), g(4), g(5)
    ra, rb = g(6), g(7)
    rba = rb - ra
    bax, bay, baz = bx - ax, by - ay, bz - az
    baba = jnp.maximum(bax * bax + bay * bay + baz * baz, 1e-20)
    pax, pay, paz = px - ax, py - ay, pz - az
    papa = pax * pax + pay * pay + paz * paz
    paba = (pax * bax + pay * bay + paz * baz) / baba
    x = jnp.sqrt(jnp.maximum(papa - paba * paba * baba, 1e-20))
    cax = jnp.maximum(0.0, x - jnp.where(paba < 0.5, ra, rb))
    cay = jnp.abs(paba - 0.5) - 0.5
    k = rba * rba + baba
    f = jnp.clip((rba * (x - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = x - ra - f * rba
    cby = paba - f
    s = jnp.where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0)
    return s * jnp.sqrt(jnp.minimum(cax * cax + cay * cay * baba,
                                    cbx * cbx + cby * cby * baba) + 1e-20)


def _d_triangle_gen(g, px, py, pz):
    v1x, v1y, v1z = g(0), g(1), g(2)
    v2x, v2y, v2z = g(3), g(4), g(5)
    v3x, v3y, v3z = g(6), g(7), g(8)
    r = g(9)
    e1x, e1y, e1z = v2x - v1x, v2y - v1y, v2z - v1z   # v21
    e2x, e2y, e2z = v3x - v2x, v3y - v2y, v3z - v2z   # v32
    e3x, e3y, e3z = v1x - v3x, v1y - v3y, v1z - v3z   # v13
    # nor = cross(v21, v13)
    nx = e1y * e3z - e1z * e3y
    ny = e1z * e3x - e1x * e3z
    nz = e1x * e3y - e1y * e3x

    p1x, p1y, p1z = px - v1x, py - v1y, pz - v1z
    p2x, p2y, p2z = px - v2x, py - v2y, pz - v2z
    p3x, p3y, p3z = px - v3x, py - v3y, pz - v3z

    def seg_d2(ex, ey, ez, qx, qy, qz):
        denom = jnp.maximum(ex * ex + ey * ey + ez * ez, 1e-20)
        h = jnp.clip((qx * ex + qy * ey + qz * ez) / denom, 0.0, 1.0)
        ux, uy, uz = qx - h * ex, qy - h * ey, qz - h * ez
        return ux * ux + uy * uy + uz * uz

    d2e = jnp.minimum(
        seg_d2(e1x, e1y, e1z, p1x, p1y, p1z),
        jnp.minimum(seg_d2(e2x, e2y, e2z, p2x, p2y, p2z),
                    seg_d2(e3x, e3y, e3z, p3x, p3y, p3z)))

    def half_sign(ex, ey, ez, qx, qy, qz):
        cx_ = ey * nz - ez * ny
        cy_ = ez * nx - ex * nz
        cz_ = ex * ny - ey * nx
        return jnp.sign(cx_ * qx + cy_ * qy + cz_ * qz)

    s = (half_sign(e1x, e1y, e1z, p1x, p1y, p1z)
         + half_sign(e2x, e2y, e2z, p2x, p2y, p2z)
         + half_sign(e3x, e3y, e3z, p3x, p3y, p3z))
    n2 = jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20)
    h = nx * p1x + ny * p1y + nz * p1z
    d2f = h * h / n2
    return jnp.sqrt(jnp.where(s >= 2.0, d2f, d2e) + 1e-20) - r


_GEN_FNS = {
    "sphere": _d_sphere_gen, "capsule": _d_capsule_gen,
    "torus": _d_torus_gen, "triangle": _d_triangle_gen,
    "box": _d_box_gen, "cone": _d_cone_gen, "plane": _d_plane_gen,
}


def _prep_rows(kind: str, params: Array) -> Array:
    """Host-side candidate-row preprocessing: fold per-step invariants into
    the gathered parameter table (torus: normalize the axis so the kernel
    skips the per-step rsqrt)."""
    if kind == "torus":
        n = normalize(params[:, 3:6])
        return jnp.concatenate([params[:, 0:3], n, params[:, 6:]], axis=-1)
    return params


# ---------------------------------------------------------------------------
# Plan → group-reduced form (static, per scene structure)
# ---------------------------------------------------------------------------

class _Group:
    """A plan node's primitive set with its reduction op.
    op ∈ {'min', 'max', 'sumexp'}; for 'sumexp', k is the smooth strength."""

    __slots__ = ("op", "slots", "k", "gid")

    def __init__(self, op, slots, k, gid):
        self.op, self.slots, self.k, self.gid = op, tuple(slots), k, gid


def _build_groups(plan: Plan):
    """Walk the plan; emit one _Group per node that reduces primitives and a
    nested eval tree referencing group ids.  Returns (groups, tree) where
    tree := ('g', gid) | (op, k, [tree...])."""
    groups: List[_Group] = []

    def visit(p: Plan):
        if p.op == "prim":
            g = _Group("min", p.prim_slots, 0.0, len(groups))
            groups.append(g)
            return ("g", g.gid)
        if p.op == "subtract":
            return ("subtract", 0.0, [visit(p.children[0]),
                                      visit(p.children[1])])
        kids = [visit(c) for c in p.children]
        if p.op in ("union", "intersect"):
            if p.prim_slots:
                op = "min" if p.op == "union" else "max"
                g = _Group(op, p.prim_slots, 0.0, len(groups))
                groups.append(g)
                kids.append(("g", g.gid))
            if len(kids) == 1:
                return kids[0]
            return (p.op, 0.0, kids)
        if p.op == "smooth_union":
            if p.prim_slots:
                g = _Group("sumexp", p.prim_slots, p.k, len(groups))
                groups.append(g)
                kids.append(("g", g.gid))
            return ("smooth_union", p.k, kids)
        raise ValueError(p.op)

    tree = visit(plan)
    return groups, tree


# ---------------------------------------------------------------------------
# Static cull-pair selection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _cull_pairs(kind_counts: Tuple[Tuple[str, int], ...], plan: Plan,
                threshold: int):
    """Static selection of (group, kind) pairs worth cone-culling: 'min'
    groups whose slots form a contiguous, group-uniform row range of one
    kind with ≥ threshold primitives.  Returns tuples
    (gid, kind, kind_index, row_lo, row_hi)."""
    groups, _tree = _build_groups(plan)
    kind_index = {k: i for i, (k, _) in enumerate(kind_counts)}
    offsets, off = {}, 0
    for k, c in kind_counts:
        offsets[k] = off
        off += c
    slot_gid = np.full(off, -1, np.int32)
    for g in groups:
        slot_gid[list(g.slots)] = g.gid

    pairs = []
    for g in groups:
        # 'min' (union) groups cull via windows+caps; 'max' (intersect)
        # groups via the symmetric skip bounds + excluded-member floor —
        # in BOTH surface modes (the AD-mode surface pass gained its max
        # window variant in round 5; previously any smooth union in the
        # scene silently dropped intersect culling to the dense sweep)
        if g.op == "sumexp":
            continue
        slots = np.sort(np.asarray(g.slots))
        for kind, cnt in kind_counts:
            lo = offsets[kind]
            in_kind = slots[(slots >= lo) & (slots < lo + cnt)]
            if len(in_kind) < threshold:
                continue
            r0, r1 = int(in_kind.min()) - lo, int(in_kind.max()) + 1 - lo
            # contiguity + uniformity: every row in range belongs to g
            if len(in_kind) != r1 - r0:
                continue
            if not (slot_gid[lo + r0:lo + r1] == g.gid).all():
                continue
            pairs.append((g.gid, kind, kind_index[kind], r0, r1))
    return tuple(pairs)


# ---------------------------------------------------------------------------
# Per-tile cones + axially-sorted candidate selection (host side)
# ---------------------------------------------------------------------------

class TileCones(NamedTuple):
    """Per-ray-tile bounding cone statistics (all [G] or [G, 3])."""

    apex: Array        # [G, 3] mean active origin (or the converging apex)
    axis: Array        # [G, 3] unit mean direction
    cos_half: Array    # [G] cone half-angle cosine, clipped ≥ 1e-3 (width)
    cos_lo: Array      # [G] unclipped-above-0 min direction·axis (sound
    #                    lower bound for axial-projection arguments)
    t_min: Array       # [G] smallest march-entry t over active lanes
    max_len: Array     # [G] largest march-exit t over active lanes
    margin: Array      # [G] lateral slack: origin spread + 2·eps
    any_active: Array  # [G] bool
    o_off_lo: Array    # [G] min over active lanes of (origin-apex)·axis
    o_off_hi: Array    # [G] max of the same
    eps_max: Array     # [G] largest epsilon over active lanes
    ax_lo: Array       # [G] exact min reachable axial coord (oa + t·ca
    #                    over t ∈ [lo, hi], active lanes)
    ax_hi: Array       # [G] exact max reachable axial coord
    tan_conv: Array    # [G] converging-cone tangent (apex mode; else -1)
    tan_neg: Array     # [G] negative-side converging tangent: lanes whose
    #                    origins sit PAST the apex along the axis march
    #                    through α<0, where lateral reach is |α|·tan_neg
    #                    (0 when no such lane — the α·tan_conv bound alone
    #                    is then complete)


def _tile_cones(origin: Array, direction: Array, t_lo: Array, t_hi: Array,
                epsilon: Array, grid: int,
                tile: int = RAY_TILE,
                conv_apex: Array | None = None) -> TileCones:
    """Per-ray-tile bounding cones.

    Built from the *pre-bound-skip* origins plus the march range
    ``[t_lo, t_hi]`` measured along each ray from that origin.  Computing
    the cone from advanced origins would be wrong at the root-bound
    silhouette: tiles mixing hit and miss lanes would see origins spread
    across the whole bounding sphere, inflating ``margin`` until every
    primitive is a candidate.  Inactive lanes (t_hi<=t_lo: provable miss,
    padding) are masked out of every statistic.

    ``conv_apex`` ([3]): every ray provably ENDS at this point (point-light
    shadow rays, SdfLight.fs:23-42: budget = distance to the light).  The
    cone is then anchored at the light instead of the mean origin: each
    ray's reachable set is the straight segment from its origin to the
    apex, so the lateral reach at axial coordinate α (measured from the
    apex along ``axis`` = −mean direction) is EXACTLY bounded by
    ``α · tan_conv`` with ``tan_conv = max_i λ(o_i)/α(o_i)`` — no
    origin-spread margin at all.  Without this, near-omnidirectional
    shadow tiles fall back to a bounding-ball test and admit most of the
    group as candidates (measured: 196 window candidates/step at the
    benchmark point light vs ~34 for primary rays)."""
    o = origin.reshape(grid, tile, 3)
    d = direction.reshape(grid, tile, 3)
    lo = t_lo.reshape(grid, tile)
    hi = t_hi.reshape(grid, tile)
    ep = epsilon.reshape(grid, tile)

    act = (hi > lo).astype(jnp.float32)                          # [G,T]
    n_act = jnp.sum(act, axis=1)
    any_active = n_act > 0.0
    safe_n = jnp.maximum(n_act, 1.0)

    if conv_apex is None:
        apex = jnp.sum(o * act[..., None], axis=1) / safe_n[:, None]
    else:
        apex = jnp.broadcast_to(conv_apex, (grid, 3))             # [G,3]
    axis = jnp.sum(d * act[..., None], axis=1)
    if conv_apex is not None:
        axis = -axis            # point from the light back toward origins
    alen = norm(axis, 0.0)[:, None]
    axis = jnp.where(alen > 1e-12, axis / jnp.maximum(alen, 1e-12),
                     jnp.array([0.0, 0.0, 1.0]))
    # lateral slack: only the component of the origin spread PERPENDICULAR
    # to the cone axis widens the reachable set laterally — the parallel
    # component is carried exactly per lane (oa) and by o_off_lo/hi.  Using
    # the full 3-D spread here made shadow tiles spanning depth along the
    # light direction inflate every candidate radius by scene scale.
    o_rel = o - apex[:, None, :]
    o_par = dot(o_rel, axis[:, None, :])
    rho2 = jnp.maximum(dot(o_rel, o_rel) - o_par * o_par, 0.0)
    rho = jnp.sqrt(jnp.max(jnp.where(act > 0.0, rho2, 0.0), axis=1))
    cosd = dot(d, axis[:, None, :])
    cos_min = jnp.min(jnp.where(act > 0.0, cosd, 1.0), axis=1)
    # cone-width cosine: clipped away from 0 (the sin/cos split below needs
    # it); axial-projection cosine: UNCLIPPED below zero — a lane with
    # direction·axis < 0 marches its axial coordinate *down* to
    # oa + t·cos_min, so flooring at 0 would overestimate the minimum axial
    # position and let backward-pointing lanes march through skipped
    # primitives (advisor round 2, high).  All consumers (candidate entry
    # bound, per-step behind-skip, cap) are sound for negative cos_lo.
    cos_half = jnp.clip(cos_min, 1e-3, 1.0)
    cos_lo = jnp.minimum(cos_min, 1.0)
    o_off = dot(o - apex[:, None, :], axis[:, None, :])
    o_off_lo = jnp.min(jnp.where(act > 0.0, o_off, _BIG), axis=1)
    o_off_hi = jnp.max(jnp.where(act > 0.0, o_off, -_BIG), axis=1)
    o_off_lo = jnp.where(any_active, o_off_lo, 0.0)
    o_off_hi = jnp.where(any_active, o_off_hi, 0.0)
    t_min = jnp.min(jnp.where(act > 0.0, lo, jnp.inf), axis=1)
    t_min = jnp.where(any_active, t_min, 0.0)
    max_len = jnp.max(jnp.where(act > 0.0, hi, 0.0), axis=1)
    eps_max = jnp.max(ep * act, axis=1)
    # exact axial reach: per lane the axial coordinate oa + t·cosd is
    # monotone in t, so its extremes over [lo, hi] sit at the endpoints
    ax0 = o_par + lo * cosd
    ax1 = o_par + hi * cosd
    ax_min_l = jnp.minimum(ax0, ax1)
    ax_max_l = jnp.maximum(ax0, ax1)
    ax_lo = jnp.min(jnp.where(act > 0.0, ax_min_l, _BIG), axis=1)
    ax_hi = jnp.max(jnp.where(act > 0.0, ax_max_l, -_BIG), axis=1)
    ax_lo = jnp.where(any_active, ax_lo, 0.0)
    ax_hi = jnp.where(any_active, ax_hi, 0.0)
    if conv_apex is None:
        margin = rho + 2.0 * eps_max + 1e-3
        tan_conv = jnp.full(margin.shape, -1.0)
        tan_neg = jnp.zeros_like(margin)
    else:
        # converging mode: every lane's reachable set is the straight
        # segment from its origin to the apex, so lateral reach at axial
        # coordinate α is a TWO-SIDED envelope (advisor r4 high — the
        # one-sided α·tan bound gave zero reach on the α<0 half-space and
        # excluded real occluders between far-side origins and a point
        # light): lanes with o_par ≥ 0 live in α ∈ [0, o_par] with
        # λ(α) = α·λ_i/o_par_i ≤ α·tan_conv; lanes with o_par < 0 live in
        # α ∈ [o_par, 0] with λ(α) = |α|·λ_i/|o_par_i| ≤ |α|·tan_neg.
        # Near-apex denominators clamp at 1e-6 → huge tangents →
        # conservative.  The origin spread is carried entirely by the
        # tangents, not a radius margin.
        lam = jnp.sqrt(rho2)                                     # [G,T]
        pos_side = o_par >= 0.0
        tan_p = lam / jnp.maximum(o_par, 1e-6)
        tan_n = lam / jnp.maximum(-o_par, 1e-6)
        margin = 2.0 * eps_max + 1e-3
        tan_conv = jnp.max(
            jnp.where((act > 0.0) & pos_side, tan_p, 0.0), axis=1)
        tan_neg = jnp.max(
            jnp.where((act > 0.0) & ~pos_side, tan_n, 0.0), axis=1)
    return TileCones(apex, axis, cos_half, cos_lo, t_min, max_len, margin,
                     any_active, o_off_lo, o_off_hi, eps_max,
                     ax_lo, ax_hi, tan_conv, tan_neg)


class CandSelect(NamedTuple):
    """Axially-sorted per-tile candidate selection."""

    idx: Array      # [G, M] int32 candidate rows, ascending axial position
    count: Array    # [G] int32 true candidate count (may exceed M: overflow)
    lo_key: Array   # [G, M] f32: axial far edge  (a + r - o_off_lo + slack)
    hi_key: Array   # [G, M] f32: axial near edge (a - r - o_off_hi - slack)


def _cand_mask(bounds: Array, cones: TileCones,
               converging: bool = False) -> Array:
    """Conservative per-tile candidacy mask [G, Kg] (the membership test of
    :func:`_cone_candidates`, reusable at sub-tile granularity).

    Lateral wedge test.  Every reachable point x = o_i + t·d_i has, in
    apex coordinates (axial α, lateral λ): λ(x) ≤ rho_perp + t·sin_half
    (margin carries rho_perp + 2eps) and α(x) = o_par_i + t·cos(d_i,axis)
    with cos ∈ [cos_lo, 1], so at axial position α the largest t any lane
    can have is t_reach(α) = min(max_len, (α−o_off_lo)/cos_lo) for
    cos_lo > 0 and max_len otherwise (backward-pointing lanes decouple t
    from α).  A candidate sphere at (a, p, radius r) can only touch the
    wedge if p ≤ r + sin_half·t_reach(a + r).  This is the cone test for
    coherent camera tiles (rho_perp ≈ 0, cos_lo ≈ 1) but stays sound for
    tiles with axially spread origins (shadow tiles) and for divergent
    tiles with cos_lo ≤ 0, where it degrades gracefully to a
    cylinder/ball.  The axial range uses the EXACT per-tile reach
    [ax_lo, ax_hi] of oa + t·ca over the march interval."""
    c = bounds[None, :, 0:3]
    r = bounds[None, :, 3] + cones.margin[:, None]
    v = c - cones.apex[:, None, :]
    a = dot(v, cones.axis[:, None, :])
    v2 = dot(v, v)
    p = jnp.sqrt(jnp.maximum(v2 - a * a, 0.0))
    near = v2 <= r * r
    sin_half = jnp.sqrt(jnp.maximum(1.0 - cones.cos_half ** 2, 0.0))
    ml = cones.max_len[:, None]
    t_reach = jnp.where(
        cones.cos_lo[:, None] > 0.0,
        jnp.clip((a + r - cones.o_off_lo[:, None])
                 / jnp.maximum(cones.cos_lo, 1e-6)[:, None], 0.0, ml),
        ml)
    wedge_ok = near | (p <= r + sin_half[:, None] * t_reach)
    if converging:
        # two-sided converging envelope (see _tile_cones): a candidate
        # spanning α ∈ [a−r, a+r] can reach lateral
        # max(max(a+r,0)·tan_conv, max(r−a,0)·tan_neg)
        reach = jnp.maximum(
            jnp.maximum(a + r, 0.0) * cones.tan_conv[:, None],
            jnp.maximum(r - a, 0.0) * cones.tan_neg[:, None])
        lateral_ok = near | (p <= r + reach)
    else:
        lateral_ok = wedge_ok
    return lateral_ok \
        & (a + r >= cones.ax_lo[:, None]) \
        & (a - r <= cones.ax_hi[:, None]) \
        & cones.any_active[:, None]


def _cone_candidates(bounds: Array, cones: TileCones,
                     m_slots: int, converging: bool = False,
                     cand: Array | None = None) -> CandSelect:
    """Conservative cone-vs-bounding-sphere candidate selection, sorted by
    axial position along the tile cone.

    ``bounds [Kg, 4]``.  A primitive is a candidate iff its
    (margin-inflated) bounding sphere can come within epsilon of ANY ray
    point of the tile — the same conservative role as the reference's
    per-cell lower-bound filter (SdfBoundary.fs:248-264).  The march range
    along the axis is bounded with the *unclipped* direction cosine
    ``cos_lo`` (sound for divergent tiles) plus the origin axial offsets.

    The returned ``lo_key``/``hi_key`` drive the kernel's per-step axial
    window: a candidate is provably ≥ clamp away from every active ray
    point whenever ``lo_key < τ_lo·cos_lo - clamp`` (entirely behind) or
    ``hi_key > τ_hi + clamp`` (entirely ahead); see the kernel docstring
    for the derivation.  Non-candidates sort to the end with keys ≈ +BIG
    (always "ahead" → never evaluated).

    ``cand`` optionally OVERRIDES the membership mask (e.g. the union of
    finer sub-tile masks from :func:`_cand_mask` — sub-cones have less
    origin/direction spread, so their union admits far fewer candidates
    than this tile-level test would); keys are always computed w.r.t.
    THIS cone's apex/axis (the kernel's windows use the tile frame)."""
    c = bounds[None, :, 0:3]                     # [1,Kg,3]
    r_act = bounds[None, :, 3]                   # [1,Kg]
    r = r_act + cones.margin[:, None]            # [G,Kg] inflated
    v = c - cones.apex[:, None, :]
    a = dot(v, cones.axis[:, None, :])   # [G,Kg]
    v2 = dot(v, v)
    p = jnp.sqrt(jnp.maximum(v2 - a * a, 0.0))
    if cand is None:
        cand = _cand_mask(bounds, cones, converging)
    count = jnp.sum(cand.astype(jnp.int32), axis=-1)

    m = min(m_slots, bounds.shape[0])
    key = jnp.where(cand, a, _BIG)
    neg_key, idx = jax.lax.top_k(-key, m)        # ascending by axial a
    a_g = -neg_key                               # [G, m]
    r_g = bounds[:, 3][idx]
    # axial extent keys in apex coordinates; the kernel compares them
    # against per-lane exact axial positions (oa + t·cosd bounds), so no
    # origin-spread slack is baked in here
    lo_key = a_g + r_g + 1e-3
    hi_key = a_g - r_g - 1e-3
    return CandSelect(idx.astype(jnp.int32), count, lo_key, hi_key)


# ---------------------------------------------------------------------------
# Kernel builder
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    """One culled pair's per-tile tables (kernel refs)."""

    cand: object   # [G, P+2, M]: parameter rows, then material, then slot
    keys: object   # [G, 2, NCH]: per-chunk far (lo_c) / near (hi_c) keys
    misc: object   # [G, 4]: count, cos_lo, march clamp, surface margin
    hsuf: object   # [G, NCH]: per-chunk suffix-min of the near keys


def _pair_window(pr: _Pair, tile, nch: int, ca, clamp, t, oa, lane_mask):
    """Per-step axial candidate window for one culled pair, at CAND_UNROLL
    chunk granularity.

    Every ray point's axial coordinate (along the tile cone axis, from
    the apex) is computed EXACTLY per lane: ``p_ax = oa + τ·ca`` with
    ``oa`` the lane's origin offset and ``ca = d·axis`` the lane's own
    direction cosine (both kernel inputs) — valid for any direction
    distribution, including the divergent/backward lanes of shadow tiles.
    Per step the live axial range is

        plo = min over active lanes of p_ax
        phi = max over active lanes of p_ax

    over the program's own block.  ``keys [G, 2, NCH]`` holds per-chunk
    extremes of the candidate axial keys: row 0 = max over the chunk of
    (a + r) = ``lo_c``, row 1 = min over the chunk of (a − r) = ``hi_c``;
    chunks past ``nch`` only pad the row to a power of two.  Soundness
    (clamp > epsilon everywhere):

    * behind chunk: ``lo_c < plo - clamp`` ⇒ every candidate in it has
      ``a + r < p_ax - clamp`` for every active lane ⇒ distance > clamp;
      per lane further bounded below by ``p_ax - BH``;
    * ahead chunk: ``hi_c > phi + clamp`` ⇒ distance > clamp; per lane
      bounded below by ``AH - p_ax``.

    The march steps by ``min(window min, cap)`` — never more than the true
    scene distance, and a skipped primitive can never be within epsilon
    (clamp ≥ 8·epsilon), so hits and misses are exactly those of the
    unpruned march.  Returns chunk-granular
    ``(w_lo, w_hi, cap, phi, skip_lb)``.
    """
    width = _pow2(nch)
    lo_c = pr.keys[tile, 0, pl.ds(0, width)]
    hi_c = pr.keys[tile, 1, pl.ds(0, width)]
    p_ax = oa + t * ca
    plo = jnp.min(jnp.where(lane_mask, p_ax, _BIG))
    phi = jnp.max(jnp.where(lane_mask, p_ax, -_BIG))
    idxv = jax.lax.broadcasted_iota(jnp.int32, (width,), 0)
    real = idxv < nch
    behind = real & (lo_c < plo - clamp)
    ahead = real & (hi_c > phi + clamp)
    rel = real & jnp.logical_not(behind) & jnp.logical_not(ahead)
    w_lo = jnp.min(jnp.where(rel, idxv, nch))
    w_hi = jnp.max(jnp.where(rel, idxv + 1, 0))
    BH = jnp.max(jnp.where(behind, lo_c, -_BIG))
    AH = jnp.min(jnp.where(ahead, hi_c, _BIG))
    cap = jnp.minimum(AH - p_ax, p_ax - BH)
    # max-group ('intersect') skip bounds: the BEST lower bound over the
    # skipped candidates' distances — max_j d_j ≥ p_ax − min(behind lo_c)
    # and ≥ max(ahead hi_c) − p_ax (−BIG when the class is empty)
    BHmin = jnp.min(jnp.where(behind, lo_c, _BIG))
    AHmax = jnp.max(jnp.where(ahead, hi_c, -_BIG))
    any_behind = jnp.max(jnp.where(behind, 1.0, 0.0)) > 0.0
    any_ahead = jnp.max(jnp.where(ahead, 1.0, 0.0)) > 0.0
    skip_lb = jnp.maximum(
        jnp.where(any_behind, p_ax - BHmin, -_BIG),
        jnp.where(any_ahead, AHmax - p_ax, -_BIG))
    return w_lo, w_hi, cap, phi, skip_lb


def _pair_m(cull_m: int, group: int) -> int:
    """Candidate-table slots for one culled pair: ``min(cull_m, group)``
    rounded up to whole CAND_UNROLL chunks (never below one chunk)."""
    m_arm = min(cull_m, group)
    return max(CAND_UNROLL,
               -(-m_arm // CAND_UNROLL) * CAND_UNROLL)


def _cand_cols(pr: _Pair, tile, c0, n_cols: int):
    """Rows ``0..n_cols-1`` of one candidate chunk as [CAND_UNROLL, 1]
    columns (loaded once, outside any in-kernel AD)."""
    return [pr.cand[tile, j, pl.ds(c0, CAND_UNROLL)][:, None]
            for j in range(n_cols)]


def _eval_prepped(kind: str, g, px, py, pz):
    """Distance over a candidate-table accessor (rows from _prep_rows)."""
    if kind == "torus":
        return _GEN_FNS[kind](g, px, py, pz, unit_axis=True)
    return _GEN_FNS[kind](g, px, py, pz)


def _dense_runs(kind_counts, slot_gid, cull_pairs):
    """Maximal runs of non-culled rows of one kind owned by one group:
    ``(kind, kind_index, row_lo, row_hi, gid, first_slot)``."""
    culled = {}
    for (_gid, kind, _ki, r0, r1) in cull_pairs:
        culled.setdefault(kind, []).append((r0, r1))
    runs, off = [], 0
    for ki, (kind, cnt) in enumerate(kind_counts):
        r = 0
        while r < cnt:
            hit = [hi for lo, hi in culled.get(kind, []) if lo <= r < hi]
            if hit:
                r = hit[0]
                continue
            gid = int(slot_gid[off + r])
            r1 = r + 1
            while (r1 < cnt and int(slot_gid[off + r1]) == gid
                   and not any(lo <= r1 < hi
                               for lo, hi in culled.get(kind, []))):
                r1 += 1
            runs.append((kind, ki, r, r1, gid, off + r))
            r = r1
        off += cnt
    return runs


@functools.lru_cache(maxsize=32)
def _build_kernel(kind_counts: Tuple[Tuple[str, int], ...], plan: Plan,
                  max_steps: int, cull_pairs: Tuple = (), cull_m: int = 0,
                  omega: float = 1.0, mode: str = "march",
                  mat_vis: Tuple[int, ...] = (), has_sign: bool = False,
                  debug_window: bool = False, step_unroll: int = 1,
                  early_out: bool = False, block: int = BLOCK_RAYS):
    """Build the kernel body for a scene structure.  Cached.

    ``mode`` selects the program: ``"march"`` = the sphere-trace loop
    (t/hit/d/steps outputs); ``"occlusion"`` = the same loop with only
    hit/steps outputs; ``"surface"`` = the one-shot surface pass at given
    hit points (winning-leaf slot + material in slot mode, in-kernel AD
    normals + material otherwise).  The march and the surface pass are
    separate programs: each stays small, which keeps compile time and
    register use down.  Candidate-list overflow has no in-kernel fallback
    — the host wraps the kernel in a ``lax.cond`` re-march with
    full-group tables instead (see ``pallas_march_raw``).

    Returns ``(kernel, slot_mode)``."""
    groups, tree = _build_groups(plan)
    n_kinds = len(kind_counts)
    n_slots = sum(c for _, c in kind_counts)
    slot_gid = np.full(n_slots, -1, np.int32)
    for g in groups:
        slot_gid[list(g.slots)] = g.gid
    runs = _dense_runs(kind_counts, slot_gid, cull_pairs)
    # surface strategy: CSG min/max selects one leaf -> track its slot;
    # smooth unions blend leaves and need the in-kernel AD variant
    slot_mode = not any(g.op == "sumexp" for g in groups)
    n_pairs = len(cull_pairs)
    # candidate slots per pair, in whole unroll chunks, rounded UP so a
    # cull_m >= group size always yields m >= group (overflow impossible —
    # the recursive big-table fallback relies on this to terminate);
    # chunk-edge extras evaluate real or duplicated primitives — harmless
    # for a min reduction
    pair_m = [_pair_m(cull_m, r1 - r0)
              for (_g, _k, _ki, r0, r1) in cull_pairs]
    shp = (block,)
    tiles_per = RAY_TILE // block

    # ---- group accumulator helpers -------------------------------------

    def accs_init():
        accs = []
        for g in groups:
            if g.op == "min":
                accs.append(jnp.full(shp, _BIG))
            elif g.op == "max":
                accs.append(jnp.full(shp, -_BIG))
            else:
                accs.append(jnp.zeros(shp))
        return accs

    def fold(op, acc, val):
        if op == "min":
            return jnp.minimum(acc, val)
        if op == "max":
            return jnp.maximum(acc, val)
        return acc + val

    def resolve_groups(accs):
        out = []
        for g, a in zip(groups, accs):
            if g.op == "sumexp":
                out.append(-g.k * jnp.log(jnp.maximum(a, 1e-30)))
            else:
                out.append(a)
        return out

    def ev_tree(gvals, t):
        if t[0] == "g":
            return gvals[t[1]]
        op, k, kids = t
        vals = [ev_tree(gvals, x) for x in kids]
        if op == "subtract":
            return jnp.maximum(vals[0], -vals[1])
        if op == "union":
            out = vals[0]
            for v in vals[1:]:
                out = jnp.minimum(out, v)
            return out
        if op == "intersect":
            out = vals[0]
            for v in vals[1:]:
                out = jnp.maximum(out, v)
            return out
        if op == "smooth_union":
            s = jnp.zeros_like(vals[0])
            for v in vals:
                s = s + jnp.exp(-v / k)
            return -k * jnp.log(jnp.maximum(s, 1e-30))
        raise ValueError(op)

    def run_loop(ctx, run, body, carry):
        """Fold ``body(carry, d_fn, slot)`` over one dense run:
        ``d_fn(px, py, pz)`` evaluates that row (broadcast scalars) and
        ``slot`` is its global slot."""
        kind, ki, r0, r1, _gid, s0 = run
        pref = ctx["params"][ki]
        fn = _GEN_FNS[kind]
        P = PARAM_WIDTH[kind]

        def at(row, c):
            s = [pref[row, j] for j in range(P)]
            return body(c, lambda x, y, z: fn(lambda j: s[j], x, y, z),
                        s0 + (row - r0))

        if r1 - r0 <= UNROLL_RUN:
            for row in range(r0, r1):
                carry = at(row, carry)
            return carry
        return jax.lax.fori_loop(r0, r1, at, carry)

    # ---- march-time scene distance --------------------------------------

    def scene_distance(ctx, px, py, pz, t, oa, ca, active, eps_v):
        accs = accs_init()
        wsum = jnp.float32(0.0)
        tile = ctx["tile"]
        for pi, (gid, kind, ki, row_lo, row_hi) in enumerate(cull_pairs):
            pr = ctx["pairs"][pi]
            count_c, _cos_lo, clamp, _surf = ctx["consts"][pi]
            P = PARAM_WIDTH[kind]
            m = pair_m[pi]
            nch = m // CAND_UNROLL
            g_op = groups[gid].op   # 'min' (union) or 'max' (intersect)
            g_size = row_hi - row_lo
            w_lo, cb_hi, cap, phi, skip_lb = _pair_window(
                pr, tile, nch, ca, clamp, t, oa, active > 0.0)
            # running-min early-out (the reference's sorted nearest-first
            # union scan, SdfForm.fs:22-34 + SdfBoundary.fs:266-268): stop
            # the ascending axial scan once every remaining candidate
            # provably cannot beat any lane's accumulated min.  Candidate
            # k's distance to a lane at axial p is >= hi_key_k - p (sound
            # even inside bounds: d_prim(x) >= |x-c| - r >= (a - r) - p_ax),
            # so with H_cb = min_{k >= cb·U} hi_key_k (per-chunk suffix-min)
            # the scan can stop when max_lanes(acc + p_hi) <= H_cb — the
            # group min is EXACTLY unchanged.  EO_STRIDE chunks evaluate
            # per test; overshoot reads clamp to the last chunk (min-fold
            # idempotent, candidates past the window are ≥ cap away).
            use_eo = early_out and g_op == "min"
            stride = EO_STRIDE if use_eo else 1
            last_cb = nch - 1
            red0 = _BIG if g_op == "min" else -_BIG

            def wcond(carry, pr=pr, cb_hi=cb_hi, phi=phi, use_eo=use_eo,
                      last_cb=last_cb):
                cb, _acc, amax = carry
                if not use_eo:
                    return cb < cb_hi
                cbl = jnp.minimum(cb, last_cb)
                return jnp.logical_and(
                    cb < cb_hi, amax + phi > pr.hsuf[tile, cbl])

            def wbody(carry, pr=pr, kind=kind, P=P, g_op=g_op,
                      stride=stride, use_eo=use_eo, last_cb=last_cb):
                cb, acc, amax = carry
                for ks in range(stride):
                    cbk = jnp.minimum(cb + ks, last_cb) if ks else cb
                    cols = _cand_cols(pr, tile, cbk * CAND_UNROLL, P)
                    d = _eval_prepped(kind, lambda j: cols[j],
                                      px[None], py[None], pz[None])
                    if g_op == "min":
                        acc = jnp.minimum(acc, jnp.min(d, axis=0))
                    else:
                        acc = jnp.maximum(acc, jnp.max(d, axis=0))
                if use_eo:
                    amax = jnp.max(jnp.where(active > 0.0, acc, -_BIG))
                # without the early-out the carried max is never read:
                # pass it through (a constant loop output cannot lower)
                return cb + stride, acc, amax

            _cb, win, _am = jax.lax.while_loop(
                wcond, wbody, (w_lo, jnp.full(shp, red0), jnp.float32(_BIG)))
            wsum = wsum + (jnp.maximum(cb_hi - w_lo, 0)
                           * CAND_UNROLL).astype(jnp.float32)
            if g_op == "min":
                gval = jnp.minimum(win, cap)
            else:
                # intersect (max) group, the reference's boundary
                # max-distance pruning re-expressed (SdfForm.fs:51-67):
                # skipped window chunks contribute their best lower bound;
                # a member excluded from the candidate table entirely is
                # > margin ≥ 2·eps from every reachable point, so the group
                # value is floored there (no hit can fire and the step
                # stays conservative — a LOWER bound of the true max)
                excl = jnp.where(count_c < float(g_size), 2.0 * eps_v, -_BIG)
                gval = jnp.maximum(jnp.maximum(win, skip_lb), excl)
            accs[gid] = fold(g_op, accs[gid], gval)

        for run in runs:
            gid = run[4]
            g = groups[gid]

            def body(acc, d_fn, _slot, g=g):
                d = d_fn(px, py, pz)
                if g.op == "sumexp":
                    d = jnp.exp(-d / g.k)
                return fold(g.op, acc, d)

            accs[gid] = run_loop(ctx, run, body, accs[gid])

        return ev_tree(resolve_groups(accs), tree), wsum

    # ---- surface pass (slot mode): winning leaf + material ---------------

    def surface_eval_slot(ctx, px, py, pz, hitm):
        """Slot-mode surface pass: CSG min/max selects exactly one leaf, so
        track the winning leaf's signed slot code through the plan tree,
        then recover its gradient with ONE masked-cotangent vjp sweep over
        the candidate lists (cotangent 1 on candidates whose slot equals
        the winner — the broadcast-transpose sums exactly the winner's
        gradient).  Returns (gx, gy, gz, material_index, code) with the CSG
        sign applied."""
        tile = ctx["tile"]
        vs = []          # per group: [value, slot_code]
        for g in groups:
            init_v = _BIG if g.op == "min" else -_BIG
            vs.append([jnp.full(shp, init_v), jnp.zeros(shp)])
        md = jnp.full(shp, _BIG)     # material argmin distance
        ms = jnp.full(shp, -1.0)     # material index (f32)

        for pi, (gid, kind, ki, row_lo, row_hi) in enumerate(cull_pairs):
            pr = ctx["pairs"][pi]
            count = ctx["consts"][pi][0]
            P = PARAM_WIDTH[kind]
            m = pair_m[pi]
            mn = groups[gid].op == "min"
            # one loop over the whole candidate list: the material winner
            # can be far from the hit (cutter surfaces), and it subsumes
            # the hit-shell window for the leaf arg-extremum
            n_c = jnp.minimum(count, float(m)).astype(jnp.int32)

            def body(cb, carry, pr=pr, kind=kind, P=P, mn=mn):
                bd, bs, md_, ms_ = carry
                cols = _cand_cols(pr, tile, cb * CAND_UNROLL, P + 2)
                d = _eval_prepped(kind, lambda j: cols[j],
                                  px[None], py[None], pz[None])
                matc, slotc = cols[P], cols[P + 1]
                ck = jax.lax.broadcasted_iota(jnp.int32, d.shape, 0)
                # leaf arg-extremum within the chunk; first-in-scan-order
                # tie-break
                dext = jnp.min(d, axis=0) if mn else jnp.max(d, axis=0)
                hit_ext = (d <= dext[None]) if mn else (d >= dext[None])
                kfst = jnp.min(jnp.where(hit_ext, ck, CAND_UNROLL), axis=0)
                swin = jnp.sum(jnp.where(ck == kfst[None], slotc, 0.0),
                               axis=0)
                better = ((dext < bd) if mn else (dext > bd)) & hitm
                bd = jnp.where(better, dext, bd)
                bs = jnp.where(better, swin + 1.0, bs)
                # material argmin over mat>=0 candidates (always a MIN —
                # SdfObject.fs:26-46 — whatever the group op)
                dm = jnp.where(matc >= 0.0, d, _BIG)
                dmm = jnp.min(dm, axis=0)
                mfst = jnp.min(jnp.where(dm <= dmm[None], ck, CAND_UNROLL),
                               axis=0)
                mwin = jnp.sum(jnp.where(ck == mfst[None], matc, 0.0),
                               axis=0)
                mb = dmm < md_
                md_ = jnp.where(mb, dmm, md_)
                ms_ = jnp.where(mb, mwin, ms_)
                return bd, bs, md_, ms_

            init = (jnp.full(shp, _BIG if mn else -_BIG), jnp.zeros(shp),
                    md, ms)
            bd, bs, md, ms = jax.lax.fori_loop(
                0, (n_c + CAND_UNROLL - 1) // CAND_UNROLL, body, init)
            if not mn:
                # excluded-member floor, mirroring the march's 'excl': when
                # the cone excluded members (count < group size), every
                # excluded distance is > margin ≥ 2·eps from the reachable
                # set, so the true group max exceeds the hit shell there —
                # floor the scanned max at 2·eps with code 0 ("no leaf") so
                # an underestimated culled max cannot win the CSG tree with
                # a fabricated winning leaf.
                eps2 = 2.0 * ctx["eps"]
                low = (count < float(row_hi - row_lo)) & (bd < eps2)
                bd = jnp.where(low, eps2, bd)
                bs = jnp.where(low, 0.0, bs)
            better = (bd < vs[gid][0]) if mn else (bd > vs[gid][0])
            vs[gid] = [jnp.where(better, bd, vs[gid][0]),
                       jnp.where(better, bs, vs[gid][1])]

        for run in runs:
            gid = run[4]
            mn = groups[gid].op == "min"

            def body(carry, d_fn, slot, mn=mn):
                v, c, md_, ms_ = carry
                d = d_fn(px, py, pz)
                better = (d < v) if mn else (d > v)
                v = jnp.where(better, d, v)
                c = jnp.where(better, slot + 1.0, c)
                mat = ctx["mat"][slot]
                mb = (d < md_) & (mat >= 0.0)
                return v, c, jnp.where(mb, d, md_), jnp.where(mb, mat, ms_)

            v, c, md, ms = run_loop(ctx, run, body,
                                    (vs[gid][0], vs[gid][1], md, ms))
            vs[gid] = [v, c]

        def ev_s(node):
            if node[0] == "g":
                return tuple(vs[node[1]])
            op, _k, kids = node
            vals = [ev_s(x) for x in kids]
            if op == "subtract":
                (va, ca_), (vb, cb_) = vals
                sel = va > -vb
                return (jnp.maximum(va, -vb), jnp.where(sel, ca_, -cb_))
            out = vals[0]
            for v in vals[1:]:
                sel = (out[0] <= v[0]) if op == "union" else \
                    (out[0] >= v[0])
                out = (jnp.where(sel, out[0], v[0]),
                       jnp.where(sel, out[1], v[1]))
            return out

        _v, code = ev_s(tree)

        # ---- winner-gradient sweep (normals) -----------------------------
        target = jnp.abs(code) - 1.0      # winning global slot, -1 = none
        sgn = jnp.sign(code)              # subtract flips the b-side sign
        grad = (jnp.zeros(shp), jnp.zeros(shp), jnp.zeros(shp))

        for pi, (gid, kind, ki, row_lo, row_hi) in enumerate(cull_pairs):
            pr = ctx["pairs"][pi]
            count = ctx["consts"][pi][0]
            P = PARAM_WIDTH[kind]
            n_c = jnp.minimum(count, float(pair_m[pi])).astype(jnp.int32)

            def nbody(cb, carry, pr=pr, kind=kind, P=P):
                cols = _cand_cols(pr, tile, cb * CAND_UNROLL, P + 2)
                slotc = cols[P + 1]
                _d, vjpf = jax.vjp(
                    lambda a, b, c: _eval_prepped(
                        kind, lambda j: cols[j], a[None], b[None], c[None]),
                    px, py, pz)
                # duplicate padded rows can double-count the winner's
                # gradient — harmless, the direction is normalized
                ct = jnp.where(slotc == target[None], 1.0, 0.0)
                gg = vjpf(ct)
                return tuple(x + y for x, y in zip(carry, gg))

            grad = jax.lax.fori_loop(
                0, (n_c + CAND_UNROLL - 1) // CAND_UNROLL, nbody, grad)

        for run in runs:
            def gbody(carry, d_fn, slot):
                _d, vjpf = jax.vjp(d_fn, px, py, pz)
                gg = vjpf(jnp.ones(shp))
                sel = target == slot
                return tuple(jnp.where(sel, y, x) for x, y in zip(carry, gg))

            grad = run_loop(ctx, run, gbody, grad)

        gx, gy, gz = grad
        # the signed winning-leaf code is exported too: the implicit-diff
        # backward differentiates ONLY that leaf (ops/march._leaf_scene_d)
        return sgn * gx, sgn * gy, sgn * gz, ms, code

    # ---- surface pass (AD mode): value + gradient + material -------------

    def surface_eval(ctx, px, py, pz, t, oa, ca, hitm):
        """At the (backed-off) hit points: per-group (value, ∇value) plus
        the global material argmin over material-visible primitives.
        Window bounds come from the hit lanes' t-range with the hit-shell
        margin, so the local argmin — the only thing normals depend on —
        is always inside the window."""
        tile = ctx["tile"]
        ones = jnp.ones(shp)
        vg = []          # per group: (v, gx, gy, gz) or sumexp partials
        for g in groups:
            if g.op == "min":
                vg.append([jnp.full(shp, _BIG), jnp.zeros(shp),
                           jnp.zeros(shp), jnp.ones(shp)])
            elif g.op == "max":
                vg.append([jnp.full(shp, -_BIG), jnp.zeros(shp),
                           jnp.zeros(shp), jnp.ones(shp)])
            else:  # sumexp: (Σe, Σe·gx, Σe·gy, Σe·gz)
                vg.append([jnp.zeros(shp), jnp.zeros(shp),
                           jnp.zeros(shp), jnp.zeros(shp)])
        md = jnp.full(shp, _BIG)     # material argmin distance
        ms = jnp.full(shp, -1.0)     # material index (f32)

        def fold_vg(op, k, v, d, gx, gy, gz):
            if op in ("min", "max"):
                better = (d < v[0]) if op == "min" else (d > v[0])
                return [jnp.where(better, x, y)
                        for x, y in zip((d, gx, gy, gz), v)]
            e = jnp.exp(-d / k)
            return [v[0] + e, v[1] + e * gx, v[2] + e * gy, v[3] + e * gz]

        def val_grad(d_fn):
            d, vjp = jax.vjp(d_fn, px, py, pz)
            gx, gy, gz = vjp(ones)
            return d, gx, gy, gz

        for pi, (gid, kind, ki, row_lo, row_hi) in enumerate(cull_pairs):
            pr = ctx["pairs"][pi]
            count, _cos, _clamp, surf_clamp = ctx["consts"][pi]
            P = PARAM_WIDTH[kind]
            m = pair_m[pi]
            mn = groups[gid].op == "min"
            ex0 = _BIG if mn else -_BIG
            # normal window margin: the hit shell only (8·eps) — far
            # narrower than the march clamp; the arg-extremum the normal
            # depends on is within epsilon of a hit.  Sound for 'max'
            # groups too: at a hit lane owned by the group every member
            # satisfies d_j ≤ eps — containing members can never be
            # window-skipped and the argmax owner is inside the window.
            w_lo, w_hi, cap, _phi, skip_lb = _pair_window(
                pr, tile, m // CAND_UNROLL, ca, surf_clamp, t, oa, hitm)

            def cand_fn(c0, k, pr=pr, kind=kind, P=P):
                s = [pr.cand[tile, j, c0 + k] for j in range(P)]
                return lambda x, y, z: _eval_prepped(
                    kind, lambda j: s[j], x, y, z)

            def body(cb, carry, cand_fn=cand_fn, mn=mn, ex0=ex0):
                c0 = cb * CAND_UNROLL
                fns = [cand_fn(c0, k) for k in range(CAND_UNROLL)]
                ds = [f(px, py, pz) for f in fns]
                dext = jnp.full(shp, ex0)
                for d in ds:
                    dext = jnp.minimum(dext, d) if mn \
                        else jnp.maximum(dext, d)
                # gradient + select only when some hit lane actually
                # improves — fires for the few chunks holding the block's
                # true surface owners, so the pass costs ~one d-eval per
                # window candidate, not a full AD sweep
                imp = (dext < carry[0]) if mn else (dext > carry[0])
                any_better = jnp.max(jnp.where(imp & hitm, 1.0, 0.0)) > 0.0

                def upd(carry):
                    bd, bgx, bgy, bgz = carry
                    for f, d in zip(fns, ds):
                        better = ((d < bd) if mn else (d > bd)) & hitm
                        dv, gx, gy, gz = val_grad(f)
                        bd = jnp.where(better, dv, bd)
                        bgx = jnp.where(better, gx, bgx)
                        bgy = jnp.where(better, gy, bgy)
                        bgz = jnp.where(better, gz, bgz)
                    return bd, bgx, bgy, bgz

                return jax.lax.cond(any_better, upd, lambda c: c, carry)

            init = (jnp.full(shp, ex0), jnp.zeros(shp), jnp.zeros(shp),
                    jnp.ones(shp))
            bd, bgx, bgy, bgz = jax.lax.fori_loop(w_lo, w_hi, body, init)
            if mn:
                # window-skipped mass lower-bounds the group min
                repl, rv = cap < bd, cap
            else:
                # 'max' group: window-skipped chunks raise the max at
                # least to skip_lb, and cone-excluded members (count <
                # group size) to 2·eps — mirror the march's bounds so the
                # group value loses/wins the tree exactly like the march's
                # (zero-gradient there: no leaf owns it)
                excl = jnp.where(count < float(row_hi - row_lo),
                                 2.0 * ctx["eps"], -_BIG)
                floor = jnp.maximum(skip_lb, excl)
                repl, rv = floor > bd, floor
            bd = jnp.where(repl, rv, bd)
            bgx = jnp.where(repl, 0.0, bgx)
            bgy = jnp.where(repl, 0.0, bgy)
            bgz = jnp.where(repl, 1.0, bgz)

            # material argmin: the winner can be arbitrarily far from the
            # hit (a hit on a material-less cutter surface takes the
            # nearest visible material, SdfObject.fs:26-46), so loop over
            # the *whole* candidate list, CAND_UNROLL at a time
            n_mat = jnp.minimum(count, float(m)).astype(jnp.int32)

            def mbody(cb, carry, pr=pr, kind=kind, P=P):
                md_, ms_ = carry
                cols = _cand_cols(pr, tile, cb * CAND_UNROLL, P + 1)
                d = _eval_prepped(kind, lambda j: cols[j],
                                  px[None], py[None], pz[None])
                matc = cols[P]
                ck = jax.lax.broadcasted_iota(jnp.int32, d.shape, 0)
                dm = jnp.where(matc >= 0.0, d, _BIG)
                dmm = jnp.min(dm, axis=0)
                mfst = jnp.min(jnp.where(dm <= dmm[None], ck, CAND_UNROLL),
                               axis=0)
                mwin = jnp.sum(jnp.where(ck == mfst[None], matc, 0.0),
                               axis=0)
                mb = dmm < md_
                return jnp.where(mb, dmm, md_), jnp.where(mb, mwin, ms_)

            md, ms = jax.lax.fori_loop(
                0, (n_mat + CAND_UNROLL - 1) // CAND_UNROLL, mbody, (md, ms))
            vg[gid] = fold_vg(groups[gid].op, 0.0, vg[gid],
                              bd, bgx, bgy, bgz)

        for run in runs:
            gid = run[4]
            g = groups[gid]

            def body(carry, d_fn, slot, g=g):
                v, md_, ms_ = carry
                d, gx, gy, gz = val_grad(d_fn)
                v = fold_vg(g.op, g.k, list(v), d, gx, gy, gz)
                mat = ctx["mat"][slot]
                mb = (d < md_) & (mat >= 0.0)
                return (tuple(v), jnp.where(mb, d, md_),
                        jnp.where(mb, mat, ms_))

            v, md, ms = run_loop(ctx, run, body, (tuple(vg[gid]), md, ms))
            vg[gid] = list(v)

        # resolve sumexp groups into (value, grad)
        gvals = []
        for g, v in zip(groups, vg):
            if g.op == "sumexp":
                s = jnp.maximum(v[0], 1e-30)
                gvals.append((-g.k * jnp.log(s), v[1] / s, v[2] / s,
                              v[3] / s))
            else:
                gvals.append(tuple(v))

        def ev_g(node):
            if node[0] == "g":
                return gvals[node[1]]
            op, k, kids = node
            vals = [ev_g(x) for x in kids]
            if op == "subtract":
                (va, ax, ay, az), (vb, bx, by, bz) = vals
                sel = va > -vb
                return (jnp.maximum(va, -vb), jnp.where(sel, ax, -bx),
                        jnp.where(sel, ay, -by), jnp.where(sel, az, -bz))
            if op in ("union", "intersect"):
                out = vals[0]
                for v in vals[1:]:
                    sel = (out[0] <= v[0]) if op == "union" \
                        else (out[0] >= v[0])
                    out = tuple(jnp.where(sel, a, b)
                                for a, b in zip(out, v))
                return out
            if op == "smooth_union":
                s = jnp.zeros(shp)
                sx = jnp.zeros(shp)
                sy = jnp.zeros(shp)
                sz = jnp.zeros(shp)
                for (v, gx, gy, gz) in vals:
                    e = jnp.exp(-v / k)
                    s, sx = s + e, sx + e * gx
                    sy, sz = sy + e * gy, sz + e * gz
                s = jnp.maximum(s, 1e-30)
                return (-k * jnp.log(s), sx / s, sy / s, sz / s)
            raise ValueError(op)

        _v, gx, gy, gz = ev_g(tree)
        # AD mode (smooth unions blend leaves): no single winning leaf —
        # code 0 marks "no leaf", the backward keeps the culled/dense path
        return gx, gy, gz, ms, jnp.zeros(shp)

    # ---- the kernels -----------------------------------------------------

    has_oa = n_pairs > 0
    # culled scenes add TWO per-lane axial inputs: oa = (o-apex)·axis and
    # ca = d·axis — together they give the kernel the EXACT per-lane axial
    # coordinate p_ax = oa + t·ca (see _pair_window)
    n_ray = 9 + int(has_sign and mode != "surface") + 2 * int(has_oa)

    def _context(refs, eps):
        """Scene tables + this program's culling tile and pair constants."""
        params = refs[n_ray:n_ray + n_kinds]
        mat = refs[n_ray + n_kinds]
        pflat = refs[n_ray + 1 + n_kinds:n_ray + 1 + n_kinds + 4 * n_pairs]
        pairs = [_Pair(*pflat[4 * i:4 * i + 4]) for i in range(n_pairs)]
        tile = pl.program_id(0) // tiles_per
        consts = [tuple(p.misc[tile, j] for j in range(4)) for p in pairs]
        ctx = dict(params=params, mat=mat, pairs=pairs, tile=tile,
                   consts=consts, eps=eps)
        return ctx, refs[n_ray + 1 + n_kinds + 4 * n_pairs:]

    def surf_kernel(*refs):
        """One-shot surface pass at given (t, hit) points."""
        (ox, oy, oz, dxr, dyr, dzr, tt, ep, hitref) = refs[:9]
        oa = refs[9][...] if has_oa else None
        ca = refs[10][...] if has_oa else None
        eps = ep[...]
        ctx, outs = _context(refs, eps)
        t = tt[...]
        hitm = hitref[...] > 0
        ts = t - eps                      # backed-off (SdfObject.fs:73)
        px = ox[...] + ts * dxr[...]
        py = oy[...] + ts * dyr[...]
        pz = oz[...] + ts * dzr[...]
        nx_out, ny_out, nz_out, mat_out, code_out = outs
        if slot_mode:
            gx, gy, gz, ms, code = surface_eval_slot(ctx, px, py, pz, hitm)
        else:
            gx, gy, gz, ms, code = surface_eval(ctx, px, py, pz, t, oa, ca,
                                                hitm)
        inv = jax.lax.rsqrt(gx * gx + gy * gy + gz * gz + 1e-20)
        nx_out[...] = jnp.where(hitm, gx * inv, 0.0)
        ny_out[...] = jnp.where(hitm, gy * inv, 0.0)
        nz_out[...] = jnp.where(hitm, gz * inv, 1.0)
        mat_out[...] = jnp.where(hitm, ms, -1.0).astype(jnp.int32)
        code_out[...] = jnp.where(hitm, code, 0.0)

    if mode == "surface":
        return surf_kernel, slot_mode

    occl = mode == "occlusion"
    relaxed = omega > 1.0

    def kernel(*refs):
        (ox, oy, oz, dxr, dyr, dzr, ln, ep, tinit) = refs[:9]
        k = 9
        sgn = None
        if has_sign:
            sgn = refs[k][...]
            k += 1
        oa = refs[k][...] if has_oa else None
        ca = refs[k + 1][...] if has_oa else None
        eps = ep[...]
        ctx, outs = _context(refs, eps)
        if occl:
            # any-hit occlusion (shadow rays, SdfLight.fs:10-21): identical
            # stepping/termination → identical hit set, but no t/d outputs
            # and no last-distance bookkeeping in the loop
            hit_out, steps_out = outs[:2]
        else:
            t_out, hit_out, d_out, steps_out = outs[:4]

        origin = (ox[...], oy[...], oz[...])
        direc = (dxr[...], dyr[...], dzr[...])
        length = ln[...]
        t0 = tinit[...]

        def dist_at(t, active):
            px = origin[0] + t * direc[0]
            py = origin[1] + t * direc[1]
            pz = origin[2] + t * direc[2]
            d, w = scene_distance(ctx, px, py, pz, t, oa, ca, active, eps)
            # per-lane sign: -1 marches *inside* the solid toward the exit
            # surface (refraction transmission).  Sound under the window
            # cap: a containing primitive's bound always contains the
            # point, so it can never be window-skipped, and the capped
            # union min equals the true (negative) distance there.
            return (sgn * d if sgn is not None else d), w

        # active/hit are carried as float 0/1 masks
        def cond(state):
            active, i = state[1], state[-1]
            return jnp.logical_and(jnp.max(active) > 0.0, i < max_steps)

        def body(state):
            if relaxed:
                (t, active, hit, d_out_prev, d_start, step_taken, stp,
                 wsum, i) = state
            else:
                t, active, hit, d_out_prev, stp, wsum, i = state
            d, w = dist_at(t, active)
            stp = stp + active        # per-lane march-eval count
            wsum = wsum + w
            if relaxed:
                # overstep: the omega-relaxed step left the union of the
                # two safety spheres → revert to the conservative landing
                # point and re-evaluate there next iteration
                over = active * jnp.where(step_taken > d_start + d, 1.0, 0.0)
                ok = 1.0 - over
                is_hit = active * ok * jnp.where(d < eps, 1.0, 0.0)
                hit = jnp.maximum(hit, is_hit)
                # a relaxed step that would cross the budget could kill the
                # ray before the overstep fallback can revert it; fall back
                # to the conservative step there (sound: if even t+d
                # crosses, the conservative march dies at the same point)
                step_rel = omega * d
                step_new = jnp.where(t + step_rel >= length, d, step_rel)
                t_cons = t - step_taken + d_start
                adv = active * ok * (1.0 - is_hit) * step_new
                t_new = over * t_cons + ok * (t + adv)
                not_exhausted = jnp.where(t_new < length, 1.0, 0.0)
                active = active * jnp.maximum(
                    over, (1.0 - is_hit) * not_exhausted)
                if occl:
                    d_out_ = d_out_prev
                else:
                    keep = jnp.maximum(active * ok, is_hit)
                    d_out_ = keep * d + (1.0 - keep) * d_out_prev
                d_start_n = over * d_start + ok * d
                step_taken_n = over * d_start + ok * adv
                return (t_new, active, hit, d_out_, d_start_n,
                        step_taken_n, stp, wsum, i + 1)
            is_hit = active * jnp.where(d < eps, 1.0, 0.0)
            hit = jnp.maximum(hit, is_hit)
            step = active * (1.0 - is_hit) * d
            t_new = t + step
            not_exhausted = jnp.where(t_new < length, 1.0, 0.0)
            active = active * (1.0 - is_hit) * not_exhausted
            if occl:
                d_out_ = d_out_prev
            else:
                keep = jnp.maximum(active, is_hit)
                d_out_ = keep * d + (1.0 - keep) * d_out_prev
            return t_new, active, hit, d_out_, stp, wsum, i + 1

        # N march steps per while iteration: each unrolled sub-step is the
        # unchanged masked body (inactive lanes are no-ops), so results
        # are bit-identical; only the max_steps safety net is honored per
        # quantum.
        def body_n(state):
            for _ in range(max(step_unroll, 1)):
                state = body(state)
            return state

        active0 = jnp.where((length > 0.0) & (t0 < length), 1.0, 0.0)
        d_init = jnp.zeros(shp) if occl else jnp.full(shp, _BIG)
        stp0 = jnp.zeros(shp)
        if relaxed:
            init = (t0, active0, jnp.zeros(shp), d_init,
                    jnp.full(shp, _BIG),   # d_start (no overstep)
                    jnp.zeros(shp),        # step_taken
                    stp0, jnp.float32(0.0), jnp.int32(0))
            t, _active, hit, d, _ds, _st, stp, wsum, _i = \
                jax.lax.while_loop(cond, body_n, init)
        else:
            init = (t0, active0, jnp.zeros(shp), d_init, stp0,
                    jnp.float32(0.0), jnp.int32(0))
            t, _active, hit, d, stp, wsum, _i = jax.lax.while_loop(
                cond, body_n, init)

        hit_out[...] = (hit > 0.0).astype(jnp.int32)
        if not occl:
            t_out[...] = t
            d_out[...] = d
        if debug_window:
            # summed per-step window width of this program's block
            steps_out[...] = jnp.full(shp, wsum).astype(jnp.int32)
        else:
            # per-lane march-eval count (the step histogram in
            # utils/profiling measures rays, not blocks)
            steps_out[...] = stp.astype(jnp.int32)

    return kernel, slot_mode


def slot_surface_mode(plan: Plan) -> bool:
    """True when the fused surface pass reports the winning leaf's slot
    (no smooth unions in the plan) for host-side closed-form normals."""
    groups, _tree = _build_groups(plan)
    return not any(g.op == "sumexp" for g in groups)


def pallas_march_raw(scene: FlatScene, rays: Rays, cfg: MarchConfig,
                     interpret: bool = False, want_surface: bool = False,
                     sign: Array | None = None, occlusion: bool = False,
                     cone_apex: Array | None = None,
                     block: int | None = None):
    """March ``rays`` (flat batch [N]) with the fused Pallas kernel.

    ``occlusion=True`` runs the any-hit variant (identical hit set, no
    t/d outputs — shadow rays, SdfLight.fs:10-21) and returns only the
    hit mask ``[N] bool``.

    Handles the root-bound skip host-side (rays start at the per-lane entry
    parameter ``t0``; the kernel marches the *absolute* ray parameter so
    per-tile axial windows stay consistent with the original origins), pads
    N to the culling-tile size, and reassembles a MarchResult.

    ``want_surface=True`` additionally runs the fused surface pass and
    returns ``(MarchResult, normal [N,3], material_index [N], code [N])``
    — the CSG-aware argmin material (SdfObject.fs:26-64), the analytic
    normal (replacing SdfForm.fs:106-115) and the signed winning-leaf code.
    Non-differentiable (gradients flow through ops.march's implicit-diff
    custom VJPs).

    ``block`` is the rays per program: BLOCK_RAYS compiled, RAY_TILE
    interpreted, unless given.  Each program's march windows span its own
    block, so the block size moves hit points within the epsilon shell,
    never the hit set.
    """
    assert rays.origin.ndim == 2, "pallas_march_raw wants a flat ray batch"
    n = rays.origin.shape[0]

    t0 = jnp.zeros((n,), jnp.float32)
    miss0 = jnp.zeros((n,), bool)
    length = rays.length
    if cfg.bound_skip:
        t0, miss0, t_exit = bound_skip_start(scene, rays, sign)
        # no hit can occur past the root-bound exit: clamp the budget
        # (directional shadow rays carry the reference's budget of 1000,
        # SdfLight.fs:14 — they stop as soon as they escape the scene)
        length = jnp.minimum(length, t_exit)
    length = jnp.where(miss0, 0.0, length)

    tile = RAY_TILE
    if block is None:
        block = RAY_TILE if interpret else BLOCK_RAYS
    pad = (-n) % tile
    npad = n + pad
    grid = npad // tile

    def pad1(x, fill=0.0):
        return jnp.pad(x, ((0, pad),), constant_values=fill)

    ox = pad1(rays.origin[:, 0])
    oy = pad1(rays.origin[:, 1])
    oz = pad1(rays.origin[:, 2])
    dxx = pad1(rays.direction[:, 0])
    dyy = pad1(rays.direction[:, 1])
    dzz = pad1(rays.direction[:, 2], 1.0)
    ln = pad1(length, -1.0)       # padded lanes: inactive
    ep = pad1(rays.epsilon, 1.0)
    t0p = pad1(t0)

    pairs = ()
    if cfg.cull:
        pairs = _cull_pairs(scene.kind_counts, scene.plan,
                            cfg.cull_threshold)
    cull_m = cfg.cull_m if pairs else 0

    mat_vis = visible_materials(scene.plan, scene.prim_material)
    kernel, slot_mode = _build_kernel(
        scene.kind_counts, scene.plan, cfg.max_steps, pairs, cull_m,
        cfg.relax_omega, "occlusion" if occlusion else "march", mat_vis,
        has_sign=sign is not None, debug_window=cfg.debug_window_stats,
        step_unroll=cfg.step_unroll, early_out=cfg.cull_early_out,
        block=block)
    sign_in = [pad1(sign, 1.0)] if sign is not None else []

    # per-tile candidate tables + axial window keys for each culled pair
    cull_inputs = []
    oa_in = []
    overflow = None
    if pairs:
        from .. import sdf as _sdf
        offsets = scene.kind_offsets
        origin_p = jnp.pad(rays.origin, ((0, pad), (0, 0)))
        dir_p = jnp.pad(rays.direction, ((0, pad), (0, 0)))
        tlo_p = jnp.pad(t0, ((0, pad),))
        thi_p = pad1(jnp.where(length > 0.0, length, t0))
        eps_p = jnp.pad(rays.epsilon, ((0, pad),))
        cones = _tile_cones(origin_p, dir_p, tlo_p, thi_p, eps_p, grid,
                            tile, conv_apex=cone_apex)
        # sub-cone candidacy: membership tested on 4× finer sub-tiles
        # (less origin/direction spread → tighter wedges → fewer
        # candidates, especially for shadow tiles whose origins span the
        # surface) and OR-ed per culling tile; windows/keys stay in the
        # tile frame.  Sound: excluded ⟹ > margin ≥ 2·eps from every
        # reachable point of every sub-tile ⟹ of the tile.
        SUBF = 4
        cones_f = _tile_cones(origin_p, dir_p, tlo_p, thi_p, eps_p,
                              grid * SUBF, tile // SUBF,
                              conv_apex=cone_apex)
        # per-lane exact axial coordinates: origin offset (o - apex)·axis
        # plus direction cosine d·axis — the kernel's per-step windows use
        # p_ax = oa + t·ca exactly per lane, so neither origin spread nor
        # direction divergence (shadow tiles!) widens the windows
        oa_in = [
            dot(origin_p.reshape(grid, tile, 3) - cones.apex[:, None, :],
                cones.axis[:, None, :]).reshape(npad),
            dot(dir_p.reshape(grid, tile, 3),
                cones.axis[:, None, :]).reshape(npad),
        ]
        # skipped-candidate distance floor: must exceed the hit shell
        clamp_eff = jnp.maximum(jnp.float32(cfg.cull_window_clamp),
                                8.0 * cones.eps_max)              # [G]
        for (_gid, kind, _ki, row_lo, row_hi) in pairs:
            # must mirror _build_kernel's pair_m
            m = _pair_m(cull_m, row_hi - row_lo)
            kparams = jax.lax.stop_gradient(
                scene.prim_params[kind][row_lo:row_hi])
            kb = _sdf._prim_bound_rows(kind, kparams)
            cmask = jnp.any(
                _cand_mask(kb, cones_f, cone_apex is not None)
                .reshape(grid, SUBF, -1), axis=1)
            sel = _cone_candidates(kb, cones, m,
                                   converging=cone_apex is not None,
                                   cand=cmask)
            if m < row_hi - row_lo:
                # overflow possible → arm the host-side big-table
                # fallback; with m >= group size the count can never
                # exceed m and the cond is not emitted at all
                ovf = jnp.any(sel.count > m)
                overflow = ovf if overflow is None else (overflow | ovf)
            if sel.idx.shape[1] < m:
                # group smaller than the chunk-rounded table: pad with
                # duplicates of the LAST candidate column (mode="edge"),
                # keys at +BIG (always "ahead" → never evaluated; harmless
                # if a chunk edge touches them — min/normalization absorb)
                padn = m - sel.idx.shape[1]
                sel = CandSelect(
                    jnp.pad(sel.idx, ((0, 0), (0, padn)), mode="edge"),
                    sel.count,
                    jnp.pad(sel.lo_key, ((0, 0), (0, padn)),
                            constant_values=_BIG),
                    jnp.pad(sel.hi_key, ((0, 0), (0, padn)),
                            constant_values=_BIG))
            prepped = _prep_rows(kind, kparams)
            mats_np = np.array(
                [float(mat_vis[offsets[kind] + r])
                 for r in range(row_lo, row_hi)], np.float32)
            slots_np = np.arange(offsets[kind] + row_lo,
                                 offsets[kind] + row_hi, dtype=np.float32)
            # parameter-major table [G, P+2, m]: one chunk of one row is a
            # contiguous CAND_UNROLL-wide load
            table = jnp.concatenate(
                [prepped.T[:, sel.idx],                          # [P, G, m]
                 jnp.asarray(mats_np)[sel.idx][None],            # material
                 jnp.asarray(slots_np)[sel.idx][None]],          # slot
                axis=0).transpose(1, 0, 2)
            # chunk-granular window keys (see _pair_window): per chunk the
            # max far edge and min near edge, padded to a power of two
            nch = m // CAND_UNROLL
            wpad = _pow2(nch) - nch
            lo_c = jnp.max(sel.lo_key.reshape(grid, nch, CAND_UNROLL),
                           axis=-1)
            hi_c = jnp.min(sel.hi_key.reshape(grid, nch, CAND_UNROLL),
                           axis=-1)
            keys = jnp.pad(jnp.stack([lo_c, hi_c], axis=1),
                           ((0, 0), (0, 0), (0, wpad)),
                           constant_values=_BIG)            # [G, 2, NCH]
            # per-tile invariants: count, cos_lo, march window clamp,
            # surface window margin (hit shell only)
            misc = jnp.stack(
                [sel.count.astype(jnp.float32), cones.cos_lo, clamp_eff,
                 8.0 * cones.eps_max + 1e-3], axis=1)       # [G, 4]
            # per-chunk suffix-min of hi_key — the running-min early-out
            # bound (see scene_distance)
            suf = jax.lax.cummin(sel.hi_key[:, ::-1], axis=1)[:, ::-1]
            hsuf = jnp.pad(suf[:, ::CAND_UNROLL], ((0, 0), (0, wpad)),
                           constant_values=_BIG)            # [G, NCH]
            cull_inputs += [table, keys, misc, hsuf]

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec()
    params = [jax.lax.stop_gradient(scene.prim_params[k])
              for k, _ in scene.kind_counts]
    mat_in = jnp.asarray(np.asarray(mat_vis, np.float32))
    tables = [*params, mat_in, *cull_inputs]
    table_specs = [whole] * len(tables)
    programs = npad // block
    cparams = pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)

    f32, i32 = jnp.float32, jnp.int32
    if occlusion:
        out_shape = [jax.ShapeDtypeStruct((npad,), i32)] * 2
    else:
        out_shape = [jax.ShapeDtypeStruct((npad,), dt)
                     for dt in (f32, i32, f32, i32)]   # t, hit, d, steps
    n_ray = 9 + len(sign_in) + len(oa_in)
    outs = pl.pallas_call(
        kernel,
        grid=(programs,),
        in_specs=[ray_spec] * n_ray + table_specs,
        out_specs=[ray_spec] * len(out_shape),
        out_shape=out_shape,
        interpret=interpret,
        compiler_params=cparams,
        backend="triton",
        name="fray_occlusion" if occlusion else "fray_march",
    )(ox, oy, oz, dxx, dyy, dzz, ln, ep, t0p, *sign_in, *oa_in, *tables)

    if overflow is not None:
        # a tile's conservative candidate count exceeded its table: the
        # kernel's windows would be unsound for that frame.  Re-march with
        # full-group candidate tables (the recursive call has m >= every
        # group so its own cond vanishes) — exact, lazily evaluated inside
        # the cond branch, and the same kernel as the fast path
        max_group = max(r1 - r0 for (_g, _k, _ki, r0, r1) in pairs)
        cfg_big = dataclasses.replace(cfg, cull_m=max_group,
                                      cull_m_shadow=max_group)

        def _big_fallback(_):
            out = pallas_march_raw(scene, rays, cfg_big, interpret,
                                   want_surface=want_surface, sign=sign,
                                   occlusion=occlusion, cone_apex=cone_apex,
                                   block=block)
            if occlusion:
                return out
            if not want_surface:
                return (out.t, out.hit, out.distance, out.steps)
            res, normal, midx, code = out
            return (res.t, res.hit, res.distance, res.steps,
                    normal[:, 0], normal[:, 1], normal[:, 2], midx, code)
    else:
        _big_fallback = None

    if occlusion:
        hit = outs[0][:n].astype(bool) & ~miss0
        if _big_fallback is not None:
            hit = jax.lax.cond(overflow, _big_fallback, lambda _: hit, None)
        return hit

    t_k, hit_k, d_k, steps_k = [o[:n] for o in outs[:4]]
    hit = hit_k.astype(bool) & ~miss0
    fast = (t_k, hit, d_k, steps_k)

    if want_surface:
        # one-shot surface pass in its own (small) program — see the
        # _build_kernel docstring for why it is not fused into the march
        surf_kernel, _ = _build_kernel(
            scene.kind_counts, scene.plan, cfg.max_steps, pairs, cull_m,
            cfg.relax_omega, "surface", mat_vis, block=block)
        s_shape = [jax.ShapeDtypeStruct((npad,), dt)
                   for dt in (f32, f32, f32, i32, f32)]  # normal, mat, code
        souts = pl.pallas_call(
            surf_kernel,
            grid=(programs,),
            in_specs=[ray_spec] * (9 + len(oa_in)) + table_specs,
            out_specs=[ray_spec] * len(s_shape),
            out_shape=s_shape,
            interpret=interpret,
            compiler_params=cparams,
            backend="triton",
            name="fray_surface",
        )(ox, oy, oz, dxx, dyy, dzz, outs[0], ep, outs[1], *oa_in, *tables)
        nx, ny, nz, midx, code = [o[:n] for o in souts]
        fast = fast + (nx, ny, nz, jnp.where(hit, midx, -1), code)

    if _big_fallback is not None:
        # see the occlusion-path comment: exact full-table re-march in the
        # rarely-taken branch; costs nothing when cull_m is sized right
        fast = jax.lax.cond(overflow, _big_fallback, lambda _: fast, None)

    res = MarchResult(hit=fast[1], t=fast[0], distance=fast[2],
                      steps=fast[3])
    if not want_surface:
        return res
    normal = jnp.stack([fast[4], fast[5], fast[6]], axis=-1)
    return res, normal, fast[7], fast[8]
