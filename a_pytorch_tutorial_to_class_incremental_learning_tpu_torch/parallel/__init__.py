"""Data parallelism: the process group and the data axis of the mesh."""

from .dist import (  # noqa: F401
    barrier,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    setup_for_distributed,
)
from .mesh import DataAxis, all_reduce_sum, broadcast_module, data_axis  # noqa: F401
