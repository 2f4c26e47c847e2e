"""Several processes, one per card — ``probunet_tpu/parallel``: the
lockstep multi-host plan and its process group (data parallel), and the
spatial modes, which shard the tile's height over the ranks
(``spatial.py``, ``spatial_unet.py``, ``spatial_train.py``)."""

from probunet_torch.parallel.mesh import DataParallel, SpatialMesh, data_parallel  # noqa: F401
from probunet_torch.parallel.multihost import (  # noqa: F401
    MultihostPlan,
    make_plan,
    maybe_initialize_distributed,
    process_info,
)
