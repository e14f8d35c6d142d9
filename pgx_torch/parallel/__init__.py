"""Data parallelism of the port (counterpart of ``pgx/parallel``): one
process per rank under a ``torch.distributed`` process group, the
collectives GSPMD places implicitly in ``pgx``, the data mesh, and the
cross-process statistics.

Tensor and spatial model parallelism (``pgx/parallel/tp.py``) is not
ported yet: its names raise ``NotImplementedError``.
"""

from pgx_torch.parallel import stats  # noqa: F401
from pgx_torch.parallel.collectives import (  # noqa: F401
    all_reduce_sum,
    average_,
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


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"pgx_torch.parallel.{name}: tensor and spatial model "
            f"parallelism (pgx/parallel/tp.py) is not ported yet")
    fn.__name__ = name
    return fn


make_mesh_2d = _not_ported("make_mesh_2d")
make_mesh_2d_for_batch = _not_ported("make_mesh_2d_for_batch")
shard_state = _not_ported("shard_state")
spatial_batch_sharding = _not_ported("spatial_batch_sharding")
state_shardings = _not_ported("state_shardings")
