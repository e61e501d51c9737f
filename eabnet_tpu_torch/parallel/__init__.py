from eabnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_processes_mean,
    all_reduce_sum,
    host_local_slice,
    in_group,
    is_chief,
    local_index,
    make_mesh,
    process_count,
    process_index,
)
