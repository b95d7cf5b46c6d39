"""Device mesh construction and sharding helpers.

The distributed backbone the reference lacks (SURVEY.md §2.3): instead of one
pthread per satellite channel and HTTP loopback between processes, the
framework lays captures out on a `jax.sharding.Mesh` with named axes
('antenna', 'time') and lets XLA insert the collectives (NCCL on GPUs).

- antenna axis: one shard per antenna stream (multi-SDR captures,
  worker.py:613-627's test1..3.bin pattern) — fusion via psum/all_gather.
- time axis: long captures split into contiguous time blocks
  (the ring-buffer streaming axis of sdrrcv.c re-expressed as sharding)
  with overlap-save halos exchanged via ppermute (parallel/halo.py).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ANTENNA_AXIS = "antenna"
TIME_AXIS = "time"


def make_mesh(n_antenna: int = 1, n_time: int | None = None,
              devices=None) -> Mesh:
    """Mesh over (antenna, time). n_time defaults to len(devices)/n_antenna."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_time is None:
        if n_dev % n_antenna:
            raise ValueError(f"{n_dev} devices not divisible by "
                             f"n_antenna={n_antenna}")
        n_time = n_dev // n_antenna
    if n_antenna * n_time != n_dev:
        raise ValueError(f"mesh {n_antenna}x{n_time} != {n_dev} devices")
    dev_array = np.asarray(devices).reshape(n_antenna, n_time)
    return Mesh(dev_array, (ANTENNA_AXIS, TIME_AXIS))


def capture_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (n_antenna, n_blocks, block_len) capture arrays:
    antennas over the antenna axis, blocks over the time axis."""
    return NamedSharding(mesh, P(ANTENNA_AXIS, TIME_AXIS, None))


def antenna_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-antenna results (n_antenna, ...)."""
    return NamedSharding(mesh, P(ANTENNA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def single_device_mesh() -> Mesh:
    """Degenerate 1x1 mesh (single chip path)."""
    return make_mesh(1, 1, devices=jax.devices()[:1])


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-host bring-up: `jax.distributed.initialize` wrapper.

    The multi-node transport the reference lacks entirely (its inter-process
    fabric is loopback HTTP JSON, sdrout.c:7-8): one process per host, each
    seeing its local chips; after init, `jax.devices()` is the global device
    list and `multihost_mesh` lays ('antenna', 'time') over (hosts x chips)
    so antenna fusion (psum/all_gather) rides the fast links within a host
    and the network across hosts. No-ops (returns False) when already initialized or when
    running single-process with no coordinator configured — single-host
    paths call this unconditionally.
    """
    import os
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
        return True
    except (RuntimeError, ValueError):
        return False                  # already initialized


def multihost_mesh(n_antenna: int | None = None) -> Mesh:
    """Global (antenna, time) mesh over all processes' devices.

    Default layout: antenna axis = hosts (each antenna's SDR stream is
    captured/ingested by one host, so per-antenna work stays host-local and
    only the fused reductions cross hosts), time axis = devices within a
    host.
    """
    devices = jax.devices()
    if n_antenna is None:
        n_antenna = max(jax.process_count(), 1)
    return make_mesh(n_antenna, None, devices=devices)
