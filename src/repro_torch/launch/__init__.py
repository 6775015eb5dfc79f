"""Command-line entry points of the port, and the pool mesh that lays the
sharded selection engines over ranks (``launch.mesh``)."""
from repro_torch.launch.mesh import (
    all_gather,
    make_pool_mesh,
    parse_pool_mesh_shape,
    pool_mesh_job_axes,
    rank_device,
)
