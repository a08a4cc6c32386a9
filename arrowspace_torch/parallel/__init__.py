"""The corpus axis N sharded over devices and processes: meshes, the
sharded build and λ, the distributed top-k merges and the mesh serving
sessions (PyTorch counterpart of ``arrowspace_tpu.parallel``)."""

from .mesh import (  # noqa: F401
    Mesh, ShardedTensor, make_mesh, make_mesh_2d, items_sharding,
    replicated_sharding, shard_rows,
)
from .distributed import (  # noqa: F401
    sharded_compute_taumode_lambdas,
    distributed_lambda_aware_topk,
    distributed_lambda_aware_topk_2d,
    distributed_pruned_topk,
    distributed_index_step,
    sharded_incremental_clustering,
    distributed_build_step,
    DistributedSearchSession,
    DistributedEnergySearchSession,
)
from .multiprocess import (  # noqa: F401
    init_distributed, is_multiprocess, put_global, ensure_global,
    local_row_range, make_sharded_corpus, run_cpu_multiprocess_dryrun,
    run_multiprocess_dryrun,
)
