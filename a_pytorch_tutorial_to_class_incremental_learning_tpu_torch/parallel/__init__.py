"""The process group and the ``(data, model)`` mesh of a run."""

from .dist import (  # noqa: F401
    barrier,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    setup_for_distributed,
)
from .mesh import (  # noqa: F401
    DataAxis,
    Mesh,
    ModelAxis,
    all_reduce_sum,
    broadcast_module,
    data_axis,
    gather_full,
    gather_rows,
    make_mesh,
    param_sharding,
    shard_params,
    shard_rows,
)
