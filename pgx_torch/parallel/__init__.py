"""Data and model parallelism of the port (counterpart of ``pgx/parallel``):
one process per rank under a ``torch.distributed`` process group, the
collectives GSPMD places implicitly in ``pgx``, the data mesh, the
cross-process statistics, and (``tp``) the 2-D ``(data, model)`` grid with
the train state channel-sharded over its model axis (``channels`` mode) or
the images split over H across it (``spatial`` mode: the row collectives
``halo_exchange``, ``gather_rows`` and ``split_rows``).
"""

from pgx_torch.parallel import stats  # noqa: F401
from pgx_torch.parallel.collectives import (  # noqa: F401
    all_reduce_sum,
    average_,
    gather_model_axis,
    gather_rows,
    halo_exchange,
    reduce_to_shards,
    split_rows,
)
from pgx_torch.parallel.distributed import (  # noqa: F401
    broadcast_obj,
    broadcast_state,
    host_batch_slice,
    initialize_multihost,
    make_global_batch,
)
from pgx_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    data_parallel_apply,
    make_mesh,
    make_mesh_for_batch,
    replicate,
    replicated,
    shard_batch,
)
from pgx_torch.parallel.stats import (  # noqa: F401
    Collector,
    check_replica_consistency,
    init_moments,
    psum_moments,
    report,
)
from pgx_torch.parallel.tp import (  # noqa: F401
    Mesh2D,
    gather_state,
    make_mesh_2d,
    make_mesh_2d_for_batch,
    shard_state,
    SpatialSharding,
    spatial_active,
    spatial_batch_sharding,
    state_shardings,
    use_spatial_sharding,
)
