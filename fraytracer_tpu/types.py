"""Core value types of the batched SDF renderer.

Batch-first reinterpretation of the reference's domain records
(``/root/reference/src/FrayTracer/Types.fs:9-79``): instead of per-ray structs
and per-scene closures, everything is a **batch**.  A ``Rays`` value holds a
structure-of-arrays bundle of many rays at once; trace results are likewise
batched and masked (a ``hit`` boolean replaces the F# ``voption``).

All containers are registered JAX pytrees (:func:`pytree_dataclass`) so
they flow through ``jit`` / ``grad`` / ``vmap`` / ``shard_map`` unchanged.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array


def static_field(**kwargs):
    """A :func:`pytree_dataclass` field held as static aux data (hashable,
    part of the jit cache key) rather than as a pytree leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree: fields made with
    :func:`static_field` are aux data, all others are leaves.  Adds
    ``replace(**changes)`` (``dataclasses.replace``)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls


@pytree_dataclass
class Rays:
    """A batch of rays (structure-of-arrays).

    Mirrors the semantics of the reference ``Ray`` record
    (``Types.fs:10-17``): ``origin`` + unit ``direction``, a remaining travel
    budget ``length`` (decremented as the ray marches), and the hit threshold
    ``epsilon``.  Shapes: ``origin``/``direction`` are ``[..., 3]``;
    ``length``/``epsilon`` broadcast against the batch ``[...]``.
    """

    origin: Array      # [..., 3] float32
    direction: Array   # [..., 3] float32, unit norm
    length: Array      # [...]    float32 remaining travel budget
    epsilon: Array     # [...]    float32 hit threshold

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]

    def at(self, t: Array) -> Array:
        """Point ``origin + t * direction`` (reference ``Ray.get``, Ray.fs:6-7)."""
        return self.origin + t[..., None] * self.direction

    def move(self, t: Array) -> "Rays":
        """Advance origins by ``t`` and decrement the budget
        (reference ``Ray.move``, Ray.fs:9-13)."""
        return self.replace(origin=self.at(t), length=self.length - t)


def make_rays(origin, direction, length, epsilon) -> Rays:
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    batch = jnp.broadcast_shapes(origin.shape[:-1], direction.shape[:-1])
    return Rays(
        origin=jnp.broadcast_to(origin, batch + (3,)),
        direction=jnp.broadcast_to(direction, batch + (3,)),
        length=jnp.broadcast_to(jnp.asarray(length, jnp.float32), batch),
        epsilon=jnp.broadcast_to(jnp.asarray(epsilon, jnp.float32), batch),
    )


@pytree_dataclass
class MarchResult:
    """Result of sphere-tracing a batch of rays against a scene.

    Replaces the reference's ``SdfFormTraceResult`` option (``Types.fs:33-37``):
    ``hit`` masks which lanes converged; ``t`` is the travel distance at the
    hit (undefined-but-finite on miss lanes); ``distance`` is the final SDF
    value; ``steps`` the number of march iterations taken (for profiling).
    """

    hit: Array       # [...] bool
    t: Array         # [...] float32 travelled distance along the ray
    distance: Array  # [...] float32 SDF value at termination
    steps: Array     # [...] int32


@pytree_dataclass
class SurfaceHit:
    """Shading-ready hit info (reference ``SdfObjectTraceResult``,
    ``Types.fs:57-65``): backed-off position, unit normal, surface albedo and
    the winning material index (argmin over the material-bearing leaves,
    semantics of ``SdfObject.fs:26-46``)."""

    hit: Array        # [...] bool
    position: Array   # [..., 3] hit position backed off by epsilon
    normal: Array     # [..., 3] unit surface normal
    color: Array      # [..., 3] surface albedo at the hit
    material: Array   # [...] int32 winning material index (-1 on miss)
    t: Array          # [...] float32


def sum3(v: Array) -> Array:
    """Sum over the trailing axis, as explicit adds when it has 3 entries.

    XLA's GPU compiler turns a trailing-axis reduce whose result is
    broadcast back over the row (``v / |v|``) into a Triton normalization
    kernel, and for 3-wide rows that kernel fails to launch on the H100
    (CUDA_ERROR_INVALID_VALUE).  Elementwise adds never take that route;
    they add in the reduce's order."""
    if v.shape[-1] == 3:
        return v[..., 0] + v[..., 1] + v[..., 2]
    return jnp.sum(v, axis=-1)


def dot(a: Array, b: Array) -> Array:
    """Batched 3-vector dot product over the trailing axis."""
    return sum3(a * b)


def norm(v: Array, eps: float = 1e-20) -> Array:
    """Safe Euclidean norm over the trailing axis (grad-safe at 0)."""
    return jnp.sqrt(sum3(v * v) + eps)


def normalize(v: Array, eps: float = 1e-20) -> Array:
    """Unit vector over the trailing axis (grad-safe at 0)."""
    return v / norm(v, eps)[..., None]


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)
