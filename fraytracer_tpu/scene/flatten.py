"""Scene flattening: builder tree → flat tagged parameter arrays (pytree).

This is the central representational shift of this build (SURVEY.md §7):
the reference's ``SdfForm`` closure *tree* (``Types.fs:40-44``, combinators in
``SdfForm.fs``) becomes

* **dynamic data** — per-primitive-type parameter matrices ``[K_t, P_t]``,
  material parameter arrays and light arrays, all ``jnp`` leaves of a pytree.
  These are the *differentiable* degrees of freedom: gradients of pixels with
  respect to every scene parameter flow through them.
* **static structure** — a hashable :class:`Plan` describing how per-primitive
  distances combine (union/intersect/subtract/smooth-union) plus the
  slot-assignment of primitives.  Static structure is jit-cache key material;
  the combine loop unrolls at trace time into a handful of masked reductions.

The reference's two spatial-lookup grids (``SdfBoundary.fs:225-282``,
``SdfObject.fs:26``) have no direct analog here: pruning is done with
bounding-sphere tests around and *inside* the march kernel (see ``ops/``),
not with per-query pointer-chasing grids.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import pytree_dataclass, static_field
from . import nodes as N

__all__ = ["Plan", "FlatScene", "flatten", "KINDS", "PARAM_WIDTH"]

# Canonical primitive kind order == global slot order. Primitives are grouped
# by kind so each kind evaluates as one vectorized batch over its [K_t, P_t]
# parameter matrix, then concatenated into the global distance
# matrix d[..., K].
KINDS: Tuple[str, ...] = (
    "sphere", "capsule", "torus", "triangle", "box", "cone", "plane",
)

PARAM_WIDTH: Dict[str, int] = {
    "sphere": 4, "capsule": 7, "torus": 8, "triangle": 10,
    "box": 7, "cone": 8, "plane": 4,
}


@dataclasses.dataclass(frozen=True, eq=True)
class Plan:
    """Static CSG combine plan node (hashable → usable as jit aux data).

    ``op`` ∈ {'prim', 'union', 'smooth_union', 'intersect', 'subtract'}.
    ``prim_slots`` are leaf-primitive children given as global slot indices
    (reduced with one masked min/max); ``children`` are interior sub-plans.
    For 'subtract', operands are ordered: (a, then b) across
    ``prim_slots + children`` with exactly two operands total.
    """

    op: str
    prim_slots: Tuple[int, ...] = ()
    children: Tuple["Plan", ...] = ()
    k: float = 0.0


@pytree_dataclass
class FlatScene:
    """Flattened scene: SoA parameter arrays + static topology.

    Dynamic leaves (differentiable): ``prim_params`` (dict kind → [K_t,P_t]),
    material arrays ``mat_*``, light arrays ``light_*``, ``background``.
    Static aux data: the combine ``plan``, per-kind counts, and the
    per-primitive material assignment.
    """

    prim_params: Dict[str, jax.Array]          # kind -> [K_t, P_t] float32
    mat_albedo: jax.Array                      # [M, 3]
    mat_emission: jax.Array                    # [M, 3]
    mat_reflectivity: jax.Array                # [M]
    mat_ior: jax.Array                         # [M, 2] Cauchy (A, B)
    mat_tint: jax.Array                        # [M, 3]
    light_vec: jax.Array                       # [L, 3] direction or position
    light_color: jax.Array                     # [L, 3]
    light_shadow_len: jax.Array                # [L]
    background: jax.Array                      # [3]

    # --- static structure (not traced; part of the jit cache key) ---
    plan: Plan = static_field()
    kind_counts: Tuple[Tuple[str, int], ...] = static_field()
    prim_material: Tuple[int, ...] = static_field()   # -1 = none
    mat_kind: Tuple[int, ...] = static_field()        # per material
    light_kind: Tuple[int, ...] = static_field()

    @property
    def num_prims(self) -> int:
        return sum(c for _, c in self.kind_counts)

    @property
    def num_materials(self) -> int:
        return len(self.mat_kind)

    @property
    def num_lights(self) -> int:
        return len(self.light_kind)

    @property
    def kind_offsets(self) -> Dict[str, int]:
        off, out = 0, {}
        for k, c in self.kind_counts:
            out[k] = off
            off += c
        return out

    def material_slots(self) -> np.ndarray:
        """Global slot indices of material-bearing primitives (static)."""
        return np.array([i for i, m in enumerate(self.prim_material) if m >= 0],
                        dtype=np.int32)

    def visible_material(self) -> Tuple[int, ...]:
        """CSG-aware material visibility per slot (-1 = not visible); see
        :func:`visible_materials`."""
        return visible_materials(self.plan, self.prim_material)

    def visible_material_slots(self) -> np.ndarray:
        """Slots whose material participates in the argmin (static)."""
        vis = self.visible_material()
        return np.array([i for i, m in enumerate(vis) if m >= 0], np.int32)


@functools.lru_cache(maxsize=128)
def visible_materials(plan: Plan,
                      prim_material: Tuple[int, ...]) -> Tuple[int, ...]:
    """CSG-aware material visibility per global slot (-1 = none visible).

    The reference resolves the winning material per union scope and keeps
    the *a* operand's material under subtract/intersect
    (``SdfObject.fs:50-64``: ``subtract object form`` / ``intersect object
    forms`` carve an object with bare forms).  Equivalent static rule on
    the flat plan: a primitive's material participates in the argmin iff
    the path from the root reaches it without passing through a subtract's
    *b* operand.  (All intersect operands keep visibility: in the
    reference only one operand of an intersect can carry materials, so
    this is a faithful superset.)
    """
    vis = [-1] * len(prim_material)

    def walk(p: Plan, flag: bool):
        if flag:
            for s in p.prim_slots:
                vis[s] = prim_material[s]
        if p.op == "subtract":
            walk(p.children[0], flag)
            walk(p.children[1], False)
            return
        for c in p.children:
            walk(c, flag)

    walk(plan, True)
    return tuple(vis)


def flatten(scene: N.Scene) -> FlatScene:
    """Lower a builder :class:`~fraytracer_tpu.scene.nodes.Scene` to a
    :class:`FlatScene`.

    Performs the same job as the reference's scene-construction stack
    (``Program.fs:67-83`` → ``SdfObject.union`` → ``buildSpatialLookup``) but
    produces arrays instead of closures+grids.  Deduplicates materials by
    value.
    """
    prims_by_kind: Dict[str, list] = {k: [] for k in KINDS}
    prim_entries: list = []  # (kind, index_within_kind, material_id)
    materials: list = []
    mat_index: Dict[N.Material, int] = {}

    def get_mat(m: Optional[N.Material]) -> int:
        if m is None:
            return -1
        if m not in mat_index:
            mat_index[m] = len(materials)
            materials.append(m)
        return mat_index[m]

    def visit(node: N.SdfNode) -> Plan:
        if isinstance(node, N.Prim):
            if node.kind not in PARAM_WIDTH:
                raise ValueError(f"unknown primitive kind {node.kind!r}")
            if len(node.params) != PARAM_WIDTH[node.kind]:
                raise ValueError(
                    f"{node.kind} expects {PARAM_WIDTH[node.kind]} params, "
                    f"got {len(node.params)}")
            idx_in_kind = len(prims_by_kind[node.kind])
            prims_by_kind[node.kind].append(np.asarray(node.params, np.float32))
            entry_id = len(prim_entries)
            prim_entries.append((node.kind, idx_in_kind, get_mat(node.material)))
            return Plan("prim", prim_slots=(entry_id,))  # provisional id
        if isinstance(node, N.Union):
            return _nary("union", node.children)
        if isinstance(node, N.SmoothUnion):
            p = _nary("smooth_union", node.children)
            return dataclasses.replace(p, k=node.k)
        if isinstance(node, N.Intersect):
            return _nary("intersect", node.children)
        if isinstance(node, N.Subtract):
            # subtract keeps both operands as ordered child plans (a, b) —
            # prims stay wrapped as 'prim' plans so order is unambiguous.
            return Plan("subtract", children=(visit(node.a), visit(node.b)))
        raise TypeError(f"not an SdfNode: {node!r}")

    def _nary(op: str, children) -> Plan:
        slots, subs = [], []
        for c in children:
            p = visit(c)
            if p.op == "prim":
                slots.append(p.prim_slots[0])
            else:
                subs.append(p)
        return Plan(op, prim_slots=tuple(slots), children=tuple(subs))

    plan_provisional = visit(scene.root)

    # Assign final global slots: group primitives by kind (canonical order),
    # preserving encounter order within a kind.  entry_id -> slot.
    entry_to_slot = {}
    slot = 0
    kind_counts = []
    for kind in KINDS:
        cnt = 0
        for entry_id, (k, idx, _m) in enumerate(prim_entries):
            if k == kind:
                entry_to_slot[entry_id] = slot
                slot += 1
                cnt += 1
        if cnt:
            kind_counts.append((kind, cnt))

    def remap(p: Plan) -> Plan:
        return Plan(p.op,
                    prim_slots=tuple(entry_to_slot[s] for s in p.prim_slots),
                    children=tuple(remap(c) for c in p.children),
                    k=p.k)

    plan = remap(plan_provisional)

    prim_material_by_slot = [0] * len(prim_entries)
    for entry_id, (_k, _i, m) in enumerate(prim_entries):
        prim_material_by_slot[entry_to_slot[entry_id]] = m

    if not materials:
        materials.append(N.solid(1.0, 1.0, 1.0))

    prim_params = {
        kind: jnp.asarray(np.stack(prims_by_kind[kind], axis=0))
        for kind, _ in kind_counts
    }
    mat_albedo = jnp.asarray(np.array([m.albedo for m in materials], np.float32))
    mat_emission = jnp.asarray(np.array([m.emission for m in materials], np.float32))
    mat_reflectivity = jnp.asarray(
        np.array([m.reflectivity for m in materials], np.float32))
    mat_ior = jnp.asarray(
        np.array([[m.ior_a, m.ior_b] for m in materials], np.float32))
    mat_tint = jnp.asarray(np.array([m.tint for m in materials], np.float32))

    lights = scene.lights
    light_vec = jnp.asarray(
        np.array([l.vec for l in lights], np.float32).reshape(len(lights), 3))
    light_color = jnp.asarray(
        np.array([l.color for l in lights], np.float32).reshape(len(lights), 3))
    light_shadow_len = jnp.asarray(
        np.array([l.shadow_length for l in lights], np.float32))

    return FlatScene(
        prim_params=prim_params,
        mat_albedo=mat_albedo,
        mat_emission=mat_emission,
        mat_reflectivity=mat_reflectivity,
        mat_ior=mat_ior,
        mat_tint=mat_tint,
        light_vec=light_vec,
        light_color=light_color,
        light_shadow_len=light_shadow_len,
        background=jnp.asarray(np.asarray(scene.background, np.float32)),
        plan=plan,
        kind_counts=tuple(kind_counts),
        prim_material=tuple(prim_material_by_slot),
        mat_kind=tuple(m.kind for m in materials),
        light_kind=tuple(l.kind for l in lights),
    )


