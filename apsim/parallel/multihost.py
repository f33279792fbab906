"""Multi-host bring-up over DCN.

The reference joins nodes into an Akka cluster via seed nodes
(conf/akka.conf:10-15: ``seed-nodes`` + gossip; ClusterSharding then spreads
entry actors).  The JAX equivalent is ``jax.distributed``: every host
process dials the coordinator, after which ``jax.devices()`` spans the whole
multi-host cluster and the same :class:`~apsim.parallel.mesh.MeshEngine`
code runs unchanged — intra- and cross-host collectives are all
inserted by XLA from the sharding annotations.

Roles: the reference tags compute nodes with ``roles = [compute]``
(conf/akka.conf:14) and routes via a cluster-aware router; here placement is
static (a fixed slice) so the router disappears — hosts run the ingest
service (`serve/`) and share one global mesh.
"""

from __future__ import annotations

import os

import jax

from .mesh import make_mesh

__all__ = ["init_multihost", "global_mesh", "is_coordinator"]


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-host cluster (idempotent; single-process no-op-safe).

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``)
    — the seed-node analog of conf/akka.conf:11-12.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return  # single-host: nothing to join
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    global _initialized
    if _initialized:
        return  # make the documented idempotence real:
        # jax.distributed.initialize raises if called twice
    kwargs = {}
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(
        coordinator_address=coordinator_address, **kwargs
    )
    _initialized = True


_initialized = False


def global_mesh(shape=None):
    """1-D mesh over every device of every joined host."""
    return make_mesh(shape, devices=jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0
