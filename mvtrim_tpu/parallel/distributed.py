"""Multi-process initialization.

The reference has no cross-machine story at all (SURVEY.md §5: no
NCCL/MPI/RPC); here the distributed substrate is JAX's: each process
joins a coordination service and ``jax.devices()`` then spans every
process's cards, so ``parallel.mesh.build_mesh()`` / ``sharded_scan_step``
shard frame batches across processes with collectives.

IMPORTANT: call ``initialize()`` before any other JAX usage —
``jax.distributed.initialize`` must run before backends initialize, so
this function decides from its arguments and environment variables alone
and never queries jax state beforehand.

Nothing discovers a cluster by itself: pass the coordinator and process
info explicitly or via the standard JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.  Several processes on one
host must each own exactly one card — a JAX process reserves most of a
card's memory when it starts, so two on one card fail.  Start each with
its own CUDA_VISIBLE_DEVICES (process p: ``CUDA_VISIBLE_DEVICES=p``).
"""

from __future__ import annotations

import os

from ..utils import logging as log

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the multi-process coordination service (idempotent).

    Returns True when running multi-process after the call, False for
    single-process operation (no coordinator given).  Must be called
    before any JAX computation/backend use.
    """
    global _initialized
    # an empty env var (unfilled compose/env template) means UNSET — it
    # must not trigger a coordinator-less multi-process initialize()
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS")
                           or None)
    if coordinator_address is None:
        return False

    import jax

    if _initialized:
        return jax.process_count() > 1

    kwargs = {"coordinator_address": coordinator_address}
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    _initialized = True
    log.info(f"distributed: process {jax.process_index()} of "
             f"{jax.process_count()}, {jax.device_count()} devices total")
    return jax.process_count() > 1
