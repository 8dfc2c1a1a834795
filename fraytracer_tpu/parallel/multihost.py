"""Multi-host (multi-controller SPMD) entry points.

The reference is strictly single-process (SURVEY.md §2c); scaling beyond
one host is a new capability: ``jax.distributed.initialize`` + the same
``shard_map`` render/train code from :mod:`.mesh`, with the global mesh
spanning all hosts' devices.  Image rows shard across the global device
set; each host renders (and keeps) its local rows; only the final
assembled frame is gathered — and only when a host actually needs the full
image (BMP/PNG write), via ``process_allgather``.

On a single host these helpers degrade gracefully to the local device set,
so the same script runs everywhere (standard JAX multi-controller
practice; nothing in the reference to cite).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the multi-controller runtime.

    With no arguments, JAX auto-detects cluster environments (e.g. SLURM) and
    failures degrade to a single-process run.  With explicit arguments the
    caller demanded a multi-process cluster, so failures (most commonly:
    the JAX backend was already initialized by an earlier array op — call
    this before touching any device) propagate instead of silently
    producing a 1-process world.
    """
    # NOTE: do not probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run.  The
    # distributed-client handle is the side-effect-free "already
    # initialized" signal; it lives in a private module with no stability
    # guarantee, so treat it as an optimization only and fall back to
    # calling initialize() and tolerating "already initialized" errors.
    try:
        from jax._src import distributed as _dist
        if _dist.global_state.client is not None:
            return  # already initialized
    except (ImportError, AttributeError):
        pass  # private API moved: rely on the RuntimeError fallback below
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError):
            # single-process run (no cluster env) or already initialized:
            # nothing to do
            pass
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def global_mesh():
    """1-D mesh over every device of every host (the fast interconnect
    within a host, the network across hosts — XLA routes the
    collectives)."""
    return make_mesh(devices=jax.devices())


def gather_image_to_host(image) -> np.ndarray:
    """Assemble the full frame on every host (the one cross-host gather in
    the pipeline, used only for file output).  Uses
    ``jax.experimental.multihost_utils.process_allgather`` when running
    multi-process; identity on a single host."""
    if jax.process_count() == 1:
        return np.asarray(image)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(image, tiled=True))
