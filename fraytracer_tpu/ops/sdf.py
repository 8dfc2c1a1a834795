"""Batched SDF evaluation over flattened scenes.

Batched replacement for the reference's closure-tree distance evaluation
(``SdfForm.fs``).  Every function here is shape-polymorphic over a leading
batch of query points ``p [..., 3]`` and vectorizes over *all* primitives of
each type at once: a single scene evaluation is a handful of large
elementwise ops + masked reductions, which XLA fuses into the march loop.

Key entry points:

* :func:`prim_distances`   — d[..., K] distances to every primitive
* :func:`scene_distance`   — d[...] CSG-combined scene distance
* :func:`scene_normal`     — analytic unit normal via ``jax.grad`` (replaces
  the reference's 4-tap forward differences, ``SdfForm.fs:106-115``)
* :func:`material_at`      — winning material index at a point (argmin over
  material-bearing primitives, semantics of ``SdfObject.fs:26-46``)
* :func:`prim_bounds` / :func:`root_bound` — bounding spheres for pruning
  (algebra of ``SdfBoundary.fs:7-63``)
"""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.flatten import FlatScene, Plan, KINDS
from ..types import dot, norm, normalize

Array = jax.Array

_BIG = 3.0e38  # effectively +inf in float32 without overflowing arithmetic


# ---------------------------------------------------------------------------
# Per-kind distance functions.  params: [K, P], p: [..., 3]  ->  [..., K]
# Each is an original vector-friendly formulation (branch-free, where-based) of
# the classic SDFs; reference semantics cited per function.
# ---------------------------------------------------------------------------

def _d_sphere(params: Array, p: Array) -> Array:
    """|p - c| - r  (reference SdfForm.fs:125-135)."""
    c, r = params[:, 0:3], params[:, 3]
    return norm(p[..., None, :] - c) - r


def _d_capsule(params: Array, p: Array) -> Array:
    """Distance to segment [a,b] minus radius (reference SdfForm.fs:145-170;
    the unclamped three-branch form there equals the clamped projection)."""
    a, b, r = params[:, 0:3], params[:, 3:6], params[:, 6]
    pa = p[..., None, :] - a            # [..., K, 3]
    ba = b - a                          # [K, 3]
    denom = jnp.maximum(dot(ba, ba), 1e-20)
    h = jnp.clip(dot(pa, ba) / denom, 0.0, 1.0)
    return norm(pa - h[..., None] * ba) - r


def _d_torus(params: Array, p: Array) -> Array:
    """Torus with center c, unit axis n, radii (R, r): the reference composes
    distance-to-plane and distance-to-axis-circle (SdfForm.fs:181-203); the
    equivalent branch-free form: sqrt(h² + (|q - h·n| - R)²) - r."""
    c, n = params[:, 0:3], params[:, 3:6]
    R, r = params[:, 6], params[:, 7]
    n = normalize(n)
    q = p[..., None, :] - c
    h = dot(q, n)                                    # signed dist to plane
    radial = norm(q - h[..., None] * n) - R          # dist to axis circle
    return jnp.sqrt(h * h + radial * radial + 1e-20) - r


def _d_triangle(params: Array, p: Array) -> Array:
    """Rounded triangle: Inigo Quilez point-triangle distance, branch-free
    (reference's optimized scalar version: SdfForm.fs:214-250)."""
    v1, v2, v3, r = params[:, 0:3], params[:, 3:6], params[:, 6:9], params[:, 9]
    v21, v32, v13 = v2 - v1, v3 - v2, v1 - v3        # [K, 3]
    nor = jnp.cross(v21, v13)                        # unnormalized face normal

    p1 = p[..., None, :] - v1
    p2 = p[..., None, :] - v2
    p3 = p[..., None, :] - v3

    def edge_d2(e, q):
        # squared distance from q to segment along e (rooted at segment start)
        denom = jnp.maximum(dot(e, e), 1e-20)
        h = jnp.clip(dot(q, e) / denom, 0.0, 1.0)
        diff = q - h[..., None] * e
        return dot(diff, diff)

    d2_edges = jnp.minimum(
        edge_d2(v21, p1), jnp.minimum(edge_d2(v32, p2), edge_d2(v13, p3)))

    # inside test: signs of the three edge half-planes (cross(edge, nor))
    s1 = jnp.sign(dot(jnp.cross(v21, nor), p1))
    s2 = jnp.sign(dot(jnp.cross(v32, nor), p2))
    s3 = jnp.sign(dot(jnp.cross(v13, nor), p3))
    inside = (s1 + s2 + s3) >= 2.0

    nor2 = jnp.maximum(dot(nor, nor), 1e-20)
    h = dot(nor, p1)
    d2_face = h * h / nor2

    return jnp.sqrt(jnp.where(inside, d2_face, d2_edges) + 1e-20) - r


def _d_box(params: Array, p: Array) -> Array:
    """Rounded axis-aligned box (new primitive; BASELINE config 2)."""
    c, half, r = params[:, 0:3], params[:, 3:6], params[:, 6]
    q = jnp.abs(p[..., None, :] - c) - half
    outside = norm(jnp.maximum(q, 0.0))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside - r


def _d_cone(params: Array, p: Array) -> Array:
    """Capped cone between disks (a, ra) and (b, rb) (new; BASELINE config 2).
    Branch-free formulation of the classic capped-cone SDF."""
    a, b = params[:, 0:3], params[:, 3:6]
    ra, rb = params[:, 6], params[:, 7]
    rba = rb - ra
    ba = b - a
    baba = jnp.maximum(dot(ba, ba), 1e-20)
    pa = p[..., None, :] - a
    papa = dot(pa, pa)
    paba = dot(pa, ba) / baba
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


def _d_plane(params: Array, p: Array) -> Array:
    """Half-space: dot(p, n) - offset (new primitive)."""
    n, off = params[:, 0:3], params[:, 3]
    return dot(p[..., None, :], n) - off


_DIST_FNS = {
    "sphere": _d_sphere, "capsule": _d_capsule, "torus": _d_torus,
    "triangle": _d_triangle, "box": _d_box, "cone": _d_cone, "plane": _d_plane,
}


# ---------------------------------------------------------------------------
# Scene evaluation
# ---------------------------------------------------------------------------

def prim_distances(scene: FlatScene, p: Array) -> Array:
    """Distances from ``p [..., 3]`` to every primitive → ``[..., K]`` in
    global slot order (kinds in canonical order, encounter order within)."""
    parts = []
    for kind, _cnt in scene.kind_counts:
        parts.append(_DIST_FNS[kind](scene.prim_params[kind], p))
    return jnp.concatenate(parts, axis=-1)


def combine(plan: Plan, d: Array) -> Array:
    """Apply the static CSG plan to the primitive distance matrix
    ``d [..., K]`` → ``[...]``.  Unrolls at trace time (plan is static)."""
    if plan.op == "prim":
        return d[..., plan.prim_slots[0]]
    if plan.op == "subtract":
        a = combine(plan.children[0], d)
        b = combine(plan.children[1], d)
        return jnp.maximum(a, -b)  # SdfForm.fs:42-49

    vals = [combine(c, d) for c in plan.children]
    if plan.op in ("union", "intersect"):
        if plan.prim_slots:
            sub = d[..., np.asarray(plan.prim_slots, np.int32)]
            red = jnp.min(sub, -1) if plan.op == "union" else jnp.max(sub, -1)
            vals.append(red)
        out = vals[0]
        f = jnp.minimum if plan.op == "union" else jnp.maximum
        for v in vals[1:]:
            out = f(out, v)
        return out
    if plan.op == "smooth_union":
        # -k * log(sum exp(-d/k))   (SdfForm.fs:69-91)
        k = jnp.float32(plan.k)
        terms = []
        if plan.prim_slots:
            terms.append(d[..., np.asarray(plan.prim_slots, np.int32)])
        if vals:
            terms.append(jnp.stack(vals, axis=-1))
        alld = jnp.concatenate(terms, axis=-1)
        return -k * jax.nn.logsumexp(-alld / k, axis=-1)
    raise ValueError(f"bad plan op {plan.op!r}")


def scene_distance(scene: FlatScene, p: Array) -> Array:
    """CSG-combined signed distance of the scene root at ``p [..., 3]``."""
    return combine(scene.plan, prim_distances(scene, p))


def scene_normal(scene: FlatScene, p: Array) -> Array:
    """Unit surface normal = normalized ∇_p scene_distance.

    Replaces the reference's forward-difference 4-tap normal
    (``SdfForm.fs:106-115``) with the exact analytic gradient via JAX AD —
    cheaper (one reverse sweep fused into the kernel) and exact.
    """
    g = jax.grad(lambda q: jnp.sum(scene_distance(scene, q)))(p)
    return normalize(g)


def albedo_of(scene: FlatScene, midx: Array, p: Array) -> Array:
    """Albedo of material ``midx [...]`` evaluated at position ``p [..., 3]``.

    Procedural materials (MAT_PROCEDURAL) evaluate their fbm color blend at
    ``p`` — the position-dependent material closure of the reference design
    (``SdfMaterial`` takes Position → Color, Types.fs:46-49).
    """
    from ..scene.nodes import MAT_PROCEDURAL
    albedo = scene.mat_albedo[midx]
    if MAT_PROCEDURAL in scene.mat_kind:
        from ..utils.noise import fbm
        is_proc = (jnp.asarray(np.asarray(scene.mat_kind, np.int32))[midx]
                   == MAT_PROCEDURAL)
        scale = scene.mat_reflectivity[midx]
        blend = 0.5 * (fbm(p * scale[..., None], octaves=3) + 1.0)
        proc_albedo = (albedo * (1.0 - blend[..., None])
                       + scene.mat_tint[midx] * blend[..., None])
        albedo = jnp.where(is_proc[..., None], proc_albedo, albedo)
    return albedo


def leaf_normal(scene: FlatScene, code: Array, p: Array) -> Array:
    """Unit surface normal from a winning-leaf code at points ``p``.

    ``code = sign·(global_slot + 1)`` names the single primitive whose
    (possibly negated, through subtract) gradient is the scene gradient at
    a CSG min/max surface point — the march kernel's fused surface pass
    emits it.  Differentiable w.r.t. both ``scene`` and ``p`` (the leaf
    choice itself is discrete and held fixed, exactly like the dense
    ``scene_normal``'s argmin branch).  ``code == 0`` lanes (misses)
    return (0, 0, 1).
    """
    slot = jnp.abs(code) - 1
    sgn = jnp.sign(code).astype(jnp.float32)
    g = jnp.zeros_like(p)
    off = 0
    for kind, cnt in scene.kind_counts:
        sel = (slot >= off) & (slot < off + cnt)
        idx = jnp.clip(slot - off, 0, cnt - 1)
        params = scene.prim_params[kind][idx]          # [..., P]
        fn = _DIST_FNS[kind]

        def one(pr, q, fn=fn):
            return fn(pr[None, :], q)[..., 0]

        gk = jax.grad(
            lambda q, params=params: jnp.sum(
                jax.vmap(one)(params.reshape(-1, params.shape[-1]),
                              q.reshape(-1, 3)))
        )(p)
        g = jnp.where(sel[..., None], gk, g)
        off += cnt
    n = normalize(g) * jnp.where(sgn < 0.0, -1.0, 1.0)[..., None]
    return jnp.where((code != 0)[..., None], n,
                     jnp.asarray([0.0, 0.0, 1.0], p.dtype))


def winning_leaf_code(scene: FlatScene, p: Array) -> Array:
    """Dense winning-leaf code at ``p``: ``sign·(global_slot + 1)`` of the
    single primitive selected by the CSG min/max tree (the same contract as
    the march kernel's fused slot-mode surface pass) — the host-side
    fallback used when a tile's candidate list overflows.  Only valid for
    plans without smooth unions (slot mode).  Ties break toward the lower
    global slot (first argmin)."""
    d = prim_distances(scene, p)
    shape = p.shape[:-1]

    def walk(plan) -> Tuple[Array, Array]:
        if plan.op == "prim":
            s = plan.prim_slots[0]
            return d[..., s], jnp.full(shape, float(s + 1))
        if plan.op == "subtract":
            va, ca = walk(plan.children[0])
            vb, cb = walk(plan.children[1])
            sel = va > -vb
            return jnp.maximum(va, -vb), jnp.where(sel, ca, -cb)
        if plan.op in ("union", "intersect"):
            vals = [walk(c) for c in plan.children]
            if plan.prim_slots:
                slots = np.asarray(plan.prim_slots, np.int32)
                sub = d[..., slots]
                if plan.op == "union":
                    win = jnp.argmin(sub, axis=-1)
                    red = jnp.min(sub, axis=-1)
                else:
                    win = jnp.argmax(sub, axis=-1)
                    red = jnp.max(sub, axis=-1)
                code = (jnp.asarray(slots)[win] + 1).astype(jnp.float32)
                vals.append((red, code))
            out = vals[0]
            for v in vals[1:]:
                sel = (out[0] <= v[0]) if plan.op == "union" \
                    else (out[0] >= v[0])
                out = (jnp.where(sel, out[0], v[0]),
                       jnp.where(sel, out[1], v[1]))
            return out
        raise ValueError(f"winning_leaf_code: unsupported op {plan.op!r}")

    _v, code = walk(scene.plan)
    return code


def material_at(scene: FlatScene, p: Array) -> Tuple[Array, Array]:
    """Winning material at ``p``: argmin of distance over *CSG-visible*
    material-bearing primitives (the reference's second spatial lookup,
    ``SdfObject.fs:26-46``; subtract keeps the a-operand's material,
    ``SdfObject.fs:50-64`` — see ``flatten.visible_materials``).
    Returns (material_index [...], albedo [..., 3])."""
    d = prim_distances(scene, p)
    slots = scene.visible_material_slots()
    if slots.size == 0:
        midx = jnp.zeros(p.shape[:-1], jnp.int32)
    else:
        sub = d[..., slots]
        win = jnp.argmin(sub, axis=-1)
        mat_of_slot = np.asarray(
            [scene.prim_material[s] for s in slots], np.int32)
        midx = jnp.asarray(mat_of_slot)[win]
    return midx, albedo_of(scene, midx, p)


# ---------------------------------------------------------------------------
# Bounding spheres (reference SdfBoundary.fs algebra)
# ---------------------------------------------------------------------------

def _prim_bound_rows(kind: str, params: Array) -> Array:
    """Per-primitive bounding sphere [K, 4] = (center, radius).  Conservative
    versions of the reference's exact per-primitive boundaries
    (``SdfForm.fs``: sphere :131-134, capsule :166-169, torus :197-201,
    triangle circumsphere :252-263)."""
    if kind == "sphere":
        return params  # (c, r)
    if kind == "capsule":
        a, b, r = params[:, 0:3], params[:, 3:6], params[:, 6]
        c = 0.5 * (a + b)
        rad = r + 0.5 * norm(b - a)
        return jnp.concatenate([c, rad[:, None]], axis=-1)
    if kind == "torus":
        c = params[:, 0:3]
        rad = params[:, 6] + params[:, 7]
        return jnp.concatenate([c, rad[:, None]], axis=-1)
    if kind == "triangle":
        v1, v2, v3, r = params[:, 0:3], params[:, 3:6], params[:, 6:9], params[:, 9]
        c = (v1 + v2 + v3) / 3.0
        rad = jnp.maximum(norm(v1 - c), jnp.maximum(norm(v2 - c), norm(v3 - c))) + r
        return jnp.concatenate([c, rad[:, None]], axis=-1)
    if kind == "box":
        c, half, r = params[:, 0:3], params[:, 3:6], params[:, 6]
        rad = norm(half) + r
        return jnp.concatenate([c, rad[:, None]], axis=-1)
    if kind == "cone":
        a, b = params[:, 0:3], params[:, 3:6]
        ra, rb = params[:, 6], params[:, 7]
        c = 0.5 * (a + b)
        rad = 0.5 * norm(b - a) + jnp.maximum(ra, rb)
        return jnp.concatenate([c, rad[:, None]], axis=-1)
    if kind == "plane":
        z = jnp.zeros((params.shape[0], 3), params.dtype)
        return jnp.concatenate([z, jnp.full((params.shape[0], 1), _BIG)], -1)
    raise ValueError(kind)


def prim_bounds(scene: FlatScene) -> Array:
    """Bounding spheres of every primitive, [K, 4] in slot order."""
    rows = [
        _prim_bound_rows(kind, scene.prim_params[kind])
        for kind, _ in scene.kind_counts
    ]
    return jnp.concatenate(rows, axis=0)


def _bound_union2(a: Array, b: Array) -> Array:
    """Enclosing sphere of two spheres (reference SdfBoundary.union,
    SdfBoundary.fs:7-22), rows [4] = (center, radius), with containment
    short-circuits expressed as where-selects."""
    ca, ra = a[0:3], a[3]
    cb, rb = b[0:3], b[3]
    d = norm(cb - ca)
    a_contains_b = ra >= d + rb
    b_contains_a = rb >= d + ra
    R = 0.5 * (d + ra + rb)
    t = jnp.where(d > 1e-12, (R - ra) / jnp.maximum(d, 1e-12), 0.0)
    c = ca + jnp.clip(t, 0.0, 1.0) * (cb - ca)
    merged = jnp.concatenate([c, R[None]])
    return jnp.where(a_contains_b, a, jnp.where(b_contains_a, b, merged))


def _bound_intersect2(a: Array, b: Array) -> Array:
    """Conservative bound of an intersection: the smaller input sphere
    (simpler than the reference's lens-circle formula SdfBoundary.fs:29-49
    and always conservative)."""
    return jnp.where(a[3] <= b[3], a, b)


def _bound_union_many(rows: Array) -> Array:
    """Vectorized conservative enclosing sphere of ``rows [N, 4]``:
    center = midpoint of the AABB of the input spheres, radius = max over
    inputs of (|cᵢ - center| + rᵢ).  O(1) graph depth (the reference's
    pairwise ``unionMany`` reduce, SdfBoundary.fs:24-27, would unroll into an
    O(N) op chain — ruinous for XLA compile time at N=1000)."""
    c, r = rows[:, 0:3], rows[:, 3]
    lo = jnp.min(c - r[:, None], axis=0)
    hi = jnp.max(c + r[:, None], axis=0)
    center = 0.5 * (lo + hi)
    radius = jnp.max(norm(c - center) + r)
    return jnp.concatenate([center, radius[None]])


def plan_bound(scene: FlatScene, plan: Plan, pb: Array) -> Array:
    """Bounding sphere [4] of a plan node given primitive bounds ``pb [K,4]``.
    union → enclosing sphere of children (SdfBoundary.unionMany,
    SdfBoundary.fs:24-27, vectorized); intersect → smallest child;
    subtract → bound of a (SdfForm.fs:48)."""
    if plan.op == "prim":
        return pb[plan.prim_slots[0]]
    if plan.op == "subtract":
        return plan_bound(scene, plan.children[0], pb)
    bounds = [plan_bound(scene, c, pb) for c in plan.children]
    if plan.prim_slots:
        bounds.append(None)  # placeholder; handled vectorized below
    if plan.op == "intersect":
        rows = [b for b in bounds if b is not None]
        if plan.prim_slots:
            sub = pb[np.asarray(plan.prim_slots, np.int32)]
            smallest = sub[jnp.argmin(sub[:, 3])]
            rows.append(smallest)
        out = rows[0]
        for bnd in rows[1:]:
            out = _bound_intersect2(out, bnd)
        return out
    # union / smooth_union: one vectorized enclosing sphere over everything
    rows = [b[None, :] for b in bounds if b is not None]
    if plan.prim_slots:
        rows.append(pb[np.asarray(plan.prim_slots, np.int32)])
    out = _bound_union_many(jnp.concatenate(rows, axis=0))
    if plan.op == "smooth_union":
        # exp smooth-min can undershoot the true min by up to k*log(n)
        n = len(plan.children) + len(plan.prim_slots)
        out = out.at[3].add(jnp.float32(plan.k * np.log(max(n, 2))))
    return out


def root_bound(scene: FlatScene) -> Array:
    """Bounding sphere (center[3], radius) of the whole scene, used to skip
    empty space before marching (and by sharded renderers for ray culling)."""
    return jax.lax.stop_gradient(
        plan_bound(scene, scene.plan, prim_bounds(scene)))


def bound_min_distance(bound: Array, p: Array) -> Array:
    """Lower bound on distance from ``p`` to anything inside ``bound``
    (reference SdfBoundary.getMinDistance, SdfBoundary.fs:58-61)."""
    return norm(p - bound[0:3]) - bound[3]
