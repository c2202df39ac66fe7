"""Device mesh construction for hash-range sharding.

Reference status: the reference is a single process with no communication
layer at all (SURVEY.md §2.2); every component here is the multi-device
equivalent mandated by the north star — a 1-D `jax.sharding.Mesh` over
the "shard" axis, Bloom bit-arrays and tables owned by hash range,
`shard_map` + `lax.all_to_all` k-mer routing between devices.

Multi-host: `jax.distributed.initialize` is the caller's responsibility
(CLI flag) — the mesh code below is process-count agnostic; with multiple
hosts jax.devices() spans the slice and each host feeds its own batch
shard (data-parallel input, SURVEY.md §2.2 DP row).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"


def make_mesh(n_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    n = n_shards or len(devs)
    if n & (n - 1):
        raise ValueError(f"n_shards must be a power of two, got {n}")
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (AXIS,))


def shard_rows(mesh: Mesh):
    """Sharding that splits the leading axis across the mesh."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def fetch(a) -> np.ndarray:
    """Materialize a (possibly multi-host global) jax array on this host.

    Single-process: plain np.asarray. Multi-host: process_allgather —
    every process must call this collectively (SPMD host phases)."""
    if isinstance(a, np.ndarray):
        return a
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)
