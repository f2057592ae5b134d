"""Device-mesh construction for DP x TP sharding.

The reference is strictly single-device (SURVEY.md §2.2: no
torch.distributed anywhere); this module supplies the distributed backbone:
a ``jax.sharding.Mesh`` over ('data', 'model') axes. Data parallelism rides
the 'data' axis (gradient all-reduce becomes an XLA psum under jit, NCCL on
GPUs); optional tensor parallelism shards ViT attention heads and MLP
hidden units over 'model'.

Multi-process: call ``initialize_distributed(coordinator_address=...,
num_processes=..., process_id=...)`` once per process before mesh
creation; per-process input pipelines then feed their local shard via
``jax.make_array_from_process_local_data`` (see ``local_batch_slice``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..configs import MeshConfig


def initialize_distributed(**kwargs) -> None:
    """``jax.distributed.initialize(**kwargs)`` for multi-process jobs.

    A no-op when this process is already initialised, or when the job is
    a single process (no ``coordinator_address`` and ``num_processes`` of
    1 or unset). Every other failure propagates.
    """
    if jax.distributed.is_initialized():
        return
    if (kwargs.get("coordinator_address") is None
            and kwargs.get("num_processes") in (None, 1)):
        return
    jax.distributed.initialize(**kwargs)


def create_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """Mesh of shape (data, model) over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    mp = max(1, cfg.model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (cfg.data_axis, cfg.model_axis))


def shard_sequences_for_process(
    sequences, process_index: int, process_count: int, global_batch_size: int,
) -> tuple[list, int]:
    """Pure multi-host input sharding: which sequences THIS process loads.

    Round-robin shard (process p takes sequences[p::n]) truncated to a
    common per-process length so every process runs the same number of
    steps — a straggler running extra steps would deadlock the collectives.
    Returns (local_sequences, local_batch_size). The reference has no
    distributed input path at all (SURVEY.md §2.2); this is the per-host
    pipeline half of the DCN design, kept pure so it is unit-testable
    without faking ``jax.process_count``.
    """
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range [0, {process_count})"
        )
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"batch_size {global_batch_size} not divisible by "
            f"process_count {process_count}"
        )
    per_proc = len(sequences) // process_count
    local = list(sequences[process_index::process_count])[:per_proc]
    return local, global_batch_size // process_count


def local_batch_slice(global_batch, mesh: Mesh, cfg: MeshConfig):
    """Build a globally-sharded batch from per-process local data.

    Single-process: plain device_put with the batch sharding. Multi-host:
    each process provides its local slice of the global batch.
    """
    from .sharding import batch_sharding

    sharding = batch_sharding(mesh, cfg)
    if jax.process_count() == 1:
        return jax.device_put(global_batch, sharding)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, x), global_batch
    )
