"""Data parallelism over ``torch.distributed`` (JAX counterpart ``tcct_tpu/parallel``)."""

from tcct_tpu_torch.parallel.distributed import (
    barrier,
    gather_rows,
    init_distributed,
    is_multiprocess_mesh,
    row_range,
)
from tcct_tpu_torch.parallel.mesh import (
    DataMesh,
    make_mesh,
    pick_dp_devices,
    replicate,
    shard_batch,
)
