"""Multi-process bootstrap: the reference's ``init_distributed_mode``.

Counterpart of uncertainty_vit_tpu/parallel/distributed.py:17-75 (the
reference's utils.py:218-312). Where the JAX package starts
``jax.distributed`` and lets XLA emit the collectives, the port starts a
``torch.distributed`` process group and names its collectives itself
(``parallel.mesh``, ``parallel.seq``).

The cluster is probed in the reference's order (utils.py:263-297): the
explicit arguments, then ``env://`` (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``, which torchrun sets), then
``SLURM_NTASKS`` / ``SLURM_PROCID``, then ``OMPI_COMM_WORLD_SIZE`` /
``OMPI_COMM_WORLD_RANK``. A single process starts nothing. The backend is
chosen once, never by a retry: ``nccl`` when every rank of a host has a
card of its own, ``gloo`` when ranks share a card or run on the CPU.
"""

from __future__ import annotations

import builtins
import dataclasses
import datetime
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Cluster:
    """What the probe found: the world, this process's rank, its rank and
    the number of ranks on its host, and the rendezvous."""

    world_size: int
    rank: int
    local_rank: int
    local_size: int
    init_method: Optional[str]


def _int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def probe_cluster(init_method: Optional[str] = None, world_size: Optional[int] = None,
                  rank: Optional[int] = None) -> Cluster:
    """The cluster of this process, from the arguments or the environment in
    the reference's order; a world of 1 where nothing is found. A launcher
    found without a rendezvous takes ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``)."""
    env = os.environ
    local_rank = local_size = None
    if world_size is None and "RANK" in env and "WORLD_SIZE" in env:
        world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = _int("LOCAL_RANK")
        local_size = _int("LOCAL_WORLD_SIZE")
    if world_size is None and "SLURM_NTASKS" in env:
        world_size, rank = int(env["SLURM_NTASKS"]), int(env.get("SLURM_PROCID", 0))
        local_rank = _int("SLURM_LOCALID")
        local_size = _int("SLURM_NTASKS_PER_NODE")
    if world_size is None and "OMPI_COMM_WORLD_SIZE" in env:
        world_size = int(env["OMPI_COMM_WORLD_SIZE"])
        rank = int(env.get("OMPI_COMM_WORLD_RANK", 0))
        local_rank = _int("OMPI_COMM_WORLD_LOCAL_RANK")
        local_size = _int("OMPI_COMM_WORLD_LOCAL_SIZE")
    world_size = world_size or 1
    rank = rank or 0
    if local_size is None:  # one host unless the launcher says otherwise
        local_size = world_size
    if local_rank is None:
        local_rank = rank % local_size
    if world_size > 1 and init_method is None:
        init_method = "env://"
    return Cluster(world_size, rank, local_rank, local_size, init_method)


def choose_backend(local_size: int, device: str = "cuda") -> str:
    """``nccl`` when every rank on a host has a card of its own, else
    ``gloo`` (ranks that share a card, or the CPU)."""
    if device != "cpu" and torch.cuda.is_available() and torch.cuda.device_count() >= local_size:
        return "nccl"
    return "gloo"


def init_distributed_mode(init_method: Optional[str] = None, world_size: Optional[int] = None,
                          rank: Optional[int] = None, device: str = "cuda",
                          suppress_output: bool = True, timeout: float = 1800.0) -> int:
    """Starts the default process group where a cluster is found and returns
    this process's rank; a single process is a no-op that returns 0. On
    ``nccl`` each rank takes the card of its local rank. With
    ``suppress_output`` ranks other than 0 print only with ``force=True``."""
    cluster = probe_cluster(init_method, world_size, rank)
    if cluster.world_size == 1:
        return 0
    if cluster.init_method == "env://" and not ("MASTER_ADDR" in os.environ
                                               and "MASTER_PORT" in os.environ):
        raise ValueError("a cluster of several processes needs a rendezvous: pass init_method "
                         "or set MASTER_ADDR and MASTER_PORT")
    backend = choose_backend(cluster.local_size, device)
    if backend == "nccl":
        torch.cuda.set_device(cluster.local_rank)
    print(f"| distributed init (rank {cluster.rank} of {cluster.world_size}): "
          f"{cluster.init_method}, backend {backend}", flush=True)
    dist.init_process_group(backend, init_method=cluster.init_method, rank=cluster.rank,
                            world_size=cluster.world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    if suppress_output:
        setup_for_distributed(cluster.rank == 0)
    return cluster.rank


def setup_for_distributed(is_master: bool) -> None:
    """Print gating with a ``force=True`` escape hatch (utils.py:218-230)."""
    base_print = getattr(builtins.print, "base_print", builtins.print)

    def gated_print(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            base_print(*args, **kwargs)

    gated_print.base_print = base_print
    builtins.print = gated_print


def is_main_process() -> bool:
    """Rank 0 of the default process group, or the one process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_on_master(fn: Callable, *args, **kwargs):
    """Run a save callable only on rank 0 (utils.py:257-259)."""
    if is_main_process():
        return fn(*args, **kwargs)
    return None
