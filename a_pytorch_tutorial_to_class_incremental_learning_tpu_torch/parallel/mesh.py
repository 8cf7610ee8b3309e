"""The data axis of the mesh, and the collectives of a data-parallel step.

Counterpart of the JAX package's ``parallel/mesh.py`` for the ``(N, 1)``
mesh.  There XLA inserts the gradient all-reduce into the compiled step;
here the step calls it: one process per data shard holds replicated
parameters and the contiguous stripe ``[r·b, (r+1)·b)`` of each global
batch of ``b·N`` rows, and the parameter gradients are summed over the ranks
in one all-reduce of a flat buffer.  The ``model`` axis (head sharding,
JAX ``mesh.py:137-157``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .dist import get_rank, get_world_size


class DataAxis:
    """This process's place on the data axis: ``rank`` of ``size``
    processes, and ``group``, the process group of their collectives (None
    in a single process).

    Modules hold it (the BatchNorm layers), and a deep copy of a module
    (the teacher snapshot) holds the same axis: it is shared, never copied.
    """

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        if size > 1 and group is None:
            raise ValueError("a data axis of more than one process needs its group")
        self.size = size
        self.rank = rank
        self.group = group
        self._spans: Dict[int, object] = {}

    def __deepcopy__(self, memo) -> "DataAxis":
        return self

    def __repr__(self) -> str:
        return f"DataAxis(size={self.size}, rank={self.rank})"

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def span_group(self, ranks: int):
        """The group of ``ranks`` consecutive ranks that holds this one.

        Made on first use, for every block of the axis at once and in the
        same order on every rank, as ``dist.new_group`` requires."""
        if self.size % ranks:
            raise ValueError(f"{ranks} ranks per group do not divide {self.size} ranks")
        if ranks == self.size:
            return self.group
        if ranks not in self._spans:
            blocks = [dist.new_group(list(range(i, i + ranks)))
                      for i in range(0, self.size, ranks)]
            self._spans[ranks] = blocks[self.rank // ranks]
        return self._spans[ranks]


def data_axis(mesh_shape: Optional[Tuple[int, int]] = None) -> DataAxis:
    """The ``--mesh_data``/``--mesh_model`` flags against the process group.

    ``mesh_data`` 0 (or no mesh) means every process; any other value must
    equal the number of processes, one per data shard."""
    data, model = mesh_shape if mesh_shape is not None else (0, 1)
    if model != 1:
        raise NotImplementedError(
            f"--mesh_model {model} is not ported yet: model-axis head sharding "
            "arrives with a later slice of the PyTorch port"
        )
    world = get_world_size()
    if data not in (0, world):
        raise ValueError(
            f"--mesh_data {data} does not match the {world} process(es) of this "
            f"run: launch one process per data shard, e.g. torchrun "
            f"--nproc_per_node {data}"
        )
    return DataAxis(world, get_rank(), dist.group.WORLD if world > 1 else None)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum ``tensors`` over ``group`` in one all-reduce of a flat buffer;
    returns views of the buffer in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def broadcast_module(module: nn.Module, group, src: int = 0) -> None:
    """Overwrite every parameter and buffer with rank ``src``'s, once after
    the model is made: the counterpart of ``global_put``'s contract (JAX
    ``mesh.py:94-112``) that every process holds the same values."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src, group=group)
