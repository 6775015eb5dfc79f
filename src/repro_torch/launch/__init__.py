"""Command-line entry points of the port: the trainer, the dry run and its
accounting (``dryrun``, ``op_analysis``, ``roofline``, ``perf``,
``reanalyze``; ``stand_ins``, the dry run's per-block DTensor versions of
a few model functions), and the meshes (``launch.mesh``)."""
from repro_torch.launch.mesh import (
    all_gather,
    make_cpu_mesh,
    make_pool_mesh,
    make_production_mesh,
    parse_pool_mesh_shape,
    pool_mesh_job_axes,
    rank_device,
)
