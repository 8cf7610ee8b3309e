"""The process group of a data-parallel run.

Counterpart of the JAX package's ``parallel/dist.py`` (the reference's NCCL
bootstrap ``init_distributed_mode`` / ``setup_for_distributed``), for
``torch.distributed``: one process per data shard, started by ``torchrun``
or any launcher that sets ``WORLD_SIZE`` and ``RANK`` (and ``LOCAL_RANK``,
the card of the process on its node).  Without those variables a run is a
single process and nothing here touches ``torch.distributed``.
"""

from __future__ import annotations

import builtins
import os
from typing import Optional

import torch.distributed as dist

from ..utils.platform import resolve_device

_printer_installed = False


def is_dist_env() -> bool:
    """True when the environment describes a process group to join."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed_mode(dist_url: str = "env://", platform: Optional[str] = None) -> bool:
    """Join the process group the environment describes.

    ``nccl`` on CUDA, ``gloo`` for ``platform="cpu"``.  A group that already
    exists (made by the caller, with a backend of its choosing) is used as
    it is.  A failed rendezvous raises: an explicit request for a group
    never degrades to independent single-process runs, which would train N
    copies of the model and overwrite each other's logs.

    Returns True when this call created the group (its caller destroys it).
    """
    created = False
    if not dist.is_initialized():
        if not is_dist_env():
            return False
        if platform == "cpu":
            backend = "gloo"
        else:
            resolve_device(platform)  # binds this process to its card first
            backend = "nccl"
        dist.init_process_group(
            backend,
            init_method=dist_url,
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]),
        )
        created = True
    if get_world_size() > 1:
        setup_for_distributed(is_main_process())
    print(f"| distributed init: rank {get_rank()} of {get_world_size()}, "
          f"backend {dist.get_backend()}")
    return created


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Install a rank-0-only ``print``; ``print(..., force=True)`` prints on
    every rank (reference utils.py:160-168)."""
    global _printer_installed
    if _printer_installed:
        return
    _printer_installed = True
    builtin_print = builtins.print

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_


def barrier() -> None:
    """Block until every rank gets here; a no-op in a single process."""
    if get_world_size() > 1:
        dist.barrier()
