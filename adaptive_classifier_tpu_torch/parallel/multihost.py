"""Process-group setup for the sharded stack.

Counterpart of ``adaptive_classifier_tpu/parallel/multihost.py`` on
``torch.distributed``: ``initialize_distributed`` starts the process
group from its arguments or from the variables ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); with neither it does nothing and returns False.  The
backend is NCCL with one rank per GPU (``torch.cuda.set_device`` to the
local rank) where CUDA is available, gloo on the CPU.  Nothing here
discovers a cluster: the rendezvous address comes from the caller.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Start the process group; True if one runs afterwards.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; without it ``MASTER_ADDR`` (and
    ``MASTER_PORT``, default 29500) are read, and with neither this is a
    single-process run: nothing is started and False comes back.  With an
    address, the world size and the rank must be known (arguments, else
    ``WORLD_SIZE`` / ``RANK``): a default would give the rendezvous a
    wrong world size and hang the other processes, so their absence
    raises ``ValueError``."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        logger.debug("single-process run; torch.distributed not initialized")
        return False
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    # explicit arguments win over the environment; `or` would take a rank
    # of 0 for a missing one
    if num_processes is None:
        env = os.environ.get("WORLD_SIZE")
        if env is None:
            raise ValueError(
                "coordinator address set but num_processes unknown: pass "
                "num_processes= or set WORLD_SIZE")
        num_processes = int(env)
    if process_id is None:
        env = os.environ.get("RANK")
        if env is None:
            raise ValueError(
                "coordinator address set but process_id unknown: pass "
                "process_id= or set RANK")
        process_id = int(env)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError("a process group with another world size or rank "
                               "is already running")
        return True
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    logger.info(f"torch.distributed initialized ({backend}): rank "
                f"{dist.get_rank()}/{dist.get_world_size()}")
    return True


def shutdown_distributed():
    """Tear the process group down, if one runs."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None):
    """The ("dp", "tp") mesh over every rank of the process group (raises
    without one).  Ranks are laid out with tp varying fastest, so a tp
    group is the consecutive ranks of one host under ``torchrun``."""
    from .mesh import make_mesh

    return make_mesh(dp=dp, tp=tp)
