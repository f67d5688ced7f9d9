"""Device-mesh helpers for multi-chip / multi-host scans.

The reference is single-device with no communication layer (SURVEY.md §2
"parallelism strategies"); this module adds two scaling axes:

* ``db`` — database axis: sequences are embarrassingly parallel, the
  primary sharding for pod-scale scans;
* ``sp`` — sequence axis: residue blocks of very long sequences, scanned
  as a wavefront pipeline with boundary-carry exchange between devices
  (parallel.seqblocks).

Multi-host: call :func:`init_distributed` first (jax.distributed), then
the same SPMD program runs unchanged.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DB_AXIS = "db"
SP_AXIS = "sp"


def make_scan_mesh(db: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (db, sp) mesh. Defaults: all devices on the db axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if db is None:
        if n % sp != 0:
            raise ValueError(f"{n} devices not divisible by sp={sp}")
        db = n // sp
    if db * sp > n:
        raise ValueError(f"mesh {db}x{sp} needs more than the {n} available devices")
    arr = np.asarray(devices[: db * sp]).reshape(db, sp)
    return Mesh(arr, axis_names=(DB_AXIS, SP_AXIS))


def db_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-sequences sharding: rows split across the db axis."""
    return NamedSharding(mesh, PartitionSpec(DB_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def init_distributed(**kwargs) -> None:
    """Multi-host entry: initialize the JAX distributed runtime.

    The replacement for the reference's absent NCCL/MPI layer —
    after this, ``jax.devices()`` spans every host's devices and the same jitted
    scan program shards over it (SPMD).
    """
    jax.distributed.initialize(**kwargs)
