"""The ``(data, model)`` mesh of a run, and the collectives of its step.

Counterpart of the JAX package's ``parallel/mesh.py``.  There one
``jax.sharding.Mesh`` of ``data × model`` devices carries the run and XLA
inserts the collectives; here one process sits at each place of the mesh
and the step calls them.  Rank ``r`` of the ``d·m`` processes sits at data
index ``r // m`` and model index ``r % m``, as JAX lays the devices out
(``np.asarray(devices).reshape(data, model)``, JAX ``mesh.py:46``).

* The **data axis** of a rank is the ``d`` ranks of its model index.  Data
  index ``i`` holds the contiguous stripe ``[i·b, (i+1)·b)`` of each global
  batch of ``b·d`` rows; the parameter gradients are summed over the data
  axis in one all-reduce of a flat buffer.
* The **model axis** of a rank is the ``m`` ranks of its data index: they
  see the same stripe, and each holds its rows ``[k·W/m, (k+1)·W/m)`` of
  the head (``fc.weight [W, 64]`` and ``fc.bias [W]``: rows are classes,
  where flax keeps columns), by JAX's ``param_sharding`` rule; everything
  else is replicated.  :func:`gather_rows` puts the head together for the
  forward, the counterpart of what XLA gathers before the loss's
  ``shard_map``.

At ``(N, 1)`` the data axis is the world group and there is no model group,
as before the model axis existed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .dist import get_rank, get_world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
# The parameters with a class dimension (the CilModel head), and its dim.
HEAD_PARAMS = ("fc.weight", "fc.bias")
_CLASS_DIM = 0


class DataAxis:
    """This process's place on the data axis: ``rank`` of ``size``
    processes, and ``group``, the process group of their collectives (None
    when the axis has one process).  ``columns`` is the number of data axes
    in the run (the model-axis size) and ``column`` this one's model index:
    data index ``i`` of column ``k`` is global rank ``i·columns + k``.

    Modules hold it (the BatchNorm layers), and a deep copy of a module
    (the teacher snapshot) holds the same axis: it is shared, never copied.
    """

    def __init__(self, size: int = 1, rank: int = 0, group=None, columns: int = 1,
                 column: int = 0):
        if size > 1 and group is None:
            raise ValueError("a data axis of more than one process needs its group")
        self.size = size
        self.rank = rank
        self.group = group
        self.columns = columns
        self.column = column
        self._spans: Dict[int, object] = {}

    def __deepcopy__(self, memo) -> "DataAxis":
        return self

    def __repr__(self) -> str:
        return f"DataAxis(size={self.size}, rank={self.rank})"

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def span_group(self, ranks: int):
        """The group of ``ranks`` consecutive data indices that holds this
        one.

        Made on first use, for every block of every data axis at once and in
        the same order on every rank, as ``dist.new_group`` requires."""
        if self.size % ranks:
            raise ValueError(f"{ranks} ranks per group do not divide {self.size} ranks")
        if ranks == self.size:
            return self.group
        if ranks not in self._spans:
            blocks = {}
            for col in range(self.columns):
                for i in range(0, self.size, ranks):
                    blocks[col, i] = dist.new_group(
                        [j * self.columns + col for j in range(i, i + ranks)])
            self._spans[ranks] = blocks[self.column, self.rank // ranks * ranks]
        return self._spans[ranks]


class ModelAxis:
    """This process's place on the model axis: ``rank`` (the model index)
    of ``size`` processes that see the same stripe, and ``group``, their
    process group (None when the axis has one process).  Shared by deep
    copies, like :class:`DataAxis`."""

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        if size > 1 and group is None:
            raise ValueError("a model axis of more than one process needs its group")
        self.size = size
        self.rank = rank
        self.group = group

    def __deepcopy__(self, memo) -> "ModelAxis":
        return self

    def __repr__(self) -> str:
        return f"ModelAxis(size={self.size}, rank={self.rank})"

    @property
    def sharded(self) -> bool:
        return self.size > 1


class Mesh:
    """The run's ``(data, model)`` mesh: this process's two axes, its global
    ``rank`` and the world ``size`` (files, agreements and barriers use
    these; the stripe, the augmentation and the loss use the data axis)."""

    def __init__(self, data: Optional[DataAxis] = None, model: Optional[ModelAxis] = None,
                 rank: int = 0, size: int = 1, data_group=None):
        self.data = data or DataAxis()
        self.model = model or ModelAxis()
        self.rank = rank
        self.size = size
        self._data_group = data_group  # the data axis's group, even of one rank
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    def device_mesh(self, device_type: str):
        """The mesh as a ``torch.distributed`` ``DeviceMesh`` over this run's
        own groups (made once, on first use, by every rank): what a
        ``DTensor`` of a head shard needs, for ``torch.distributed.checkpoint``.
        Only a run with a model axis has one."""
        if not self.model.sharded:
            raise ValueError("a mesh without a model axis shards nothing")
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            d, m = self.data.size, self.model.size
            self._device_mesh = DeviceMesh.from_group(
                [self._data_group, self.model.group], device_type,
                mesh=torch.arange(d * m).reshape(d, m),
                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        return self._device_mesh


def make_mesh(mesh_shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The ``--mesh_data``/``--mesh_model`` flags against the process group
    (JAX ``make_mesh``).

    No mesh, or ``mesh_data`` 0, puts every process on the data axis (``0``
    is ``world // mesh_model`` with a model axis); otherwise ``data ×
    model`` must equal the number of processes.  Every rank makes every
    group, in the same order: one data group a model index, one model group
    a data index."""
    data, model = mesh_shape if mesh_shape is not None else (0, 1)
    world, rank = get_world_size(), get_rank()
    if model < 1 or world % model:
        raise ValueError(
            f"--mesh_model {model} does not divide the {world} process(es) of this run")
    data = data or world // model
    if data * model != world:
        raise ValueError(
            f"--mesh_data {data} x --mesh_model {model} does not match the {world} "
            f"process(es) of this run: launch one process per mesh place, e.g. "
            f"torchrun --nproc_per_node {data * model}"
        )
    i, k = divmod(rank, model)
    if model == 1:
        group = dist.group.WORLD if world > 1 else None
        return Mesh(DataAxis(data, i, group), ModelAxis(), rank, world, group)
    data_groups = [dist.new_group([j * model + col for j in range(data)])
                   for col in range(model)]
    model_groups = [dist.new_group([row * model + col for col in range(model)])
                    for row in range(data)]
    data_axis = DataAxis(data, i, data_groups[k] if data > 1 else None, model, k)
    return Mesh(data_axis, ModelAxis(model, k, model_groups[i]), rank, world, data_groups[k])


def data_axis(mesh_shape: Optional[Tuple[int, int]] = None) -> DataAxis:
    """The data axis of :func:`make_mesh`."""
    return make_mesh(mesh_shape).data


# --------------------------------------------------------------------------- #
# The head's shards (JAX ``param_sharding`` / ``shard_params``)
# --------------------------------------------------------------------------- #


def param_sharding(model: ModelAxis, name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension of parameter ``name`` (a ``state_dict`` name) sharded
    over the model axis, or None for a replicated one.

    JAX ``param_sharding``'s rule: only the class dimension of the head,
    only on a model axis wider than 1, and only when the axis size divides
    it (``create_model(width_multiple=m)`` pads the head so that it does)."""
    if (model.size > 1 and name in HEAD_PARAMS
            and len(shape) > _CLASS_DIM and shape[_CLASS_DIM] % model.size == 0):
        return _CLASS_DIM
    return None


def shard_rows(model: ModelAxis, full: torch.Tensor) -> torch.Tensor:
    """This rank's rows ``[k·n/m, (k+1)·n/m)`` of a full tensor (a view)."""
    n = full.shape[_CLASS_DIM] // model.size
    return full.narrow(_CLASS_DIM, model.rank * n, n)


def shard_params(model: ModelAxis, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full-width ``state_dict`` -> this rank's: the sharded entries cut
    to its rows by :func:`param_sharding`, the others as they are (JAX
    ``shard_params``)."""
    return {name: shard_rows(model, t) if param_sharding(model, name, t.shape) is not None
            else t for name, t in state.items()}


class _GatherRows(torch.autograd.Function):
    """Forward: all-gather the shards of the model group along dim 0, in
    rank order, into the full tensor.

    Backward: this rank's rows of the incoming gradient, neither summed nor
    scaled.  Every rank of the group computes the same loss from the same
    full tensor (the same stripe through a replicated backbone), so the
    incoming gradient is the same on each, and a shard's gradient is its
    rows of it: exactly its slice of the unsharded gradient.  (The stock
    ``all_gather`` backward is a reduce-scatter, which would sum ``m``
    identical copies.)"""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, model: ModelAxis) -> torch.Tensor:
        ctx.model = model
        return gather_full(model, shard)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return shard_rows(ctx.model, grad).contiguous(), None


def gather_full(model: ModelAxis, shard: torch.Tensor) -> torch.Tensor:
    """The full tensor from the model group's shards (dim 0, rank order);
    no gradient flows through it."""
    parts = [torch.empty_like(shard) for _ in range(model.size)]
    dist.all_gather(parts, shard.detach().contiguous(), group=model.group)
    return torch.cat(parts, dim=_CLASS_DIM)


def gather_rows(model: Optional[ModelAxis], shard: torch.Tensor) -> torch.Tensor:
    """The full tensor from the model group's shards, differentiable as
    :class:`_GatherRows` says; the tensor itself without a sharded axis."""
    if model is None or not model.sharded:
        return shard
    return _GatherRows.apply(shard, model)


# --------------------------------------------------------------------------- #
# Collectives of the data-parallel step
# --------------------------------------------------------------------------- #


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
    ``mesh.py:94-112``) that every process holds the same values.  The
    caller hands it replicated modules only (the backbone), never a head
    shard."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src, group=group)
