"""Multi-process data parallelism — ``probunet_tpu/parallel`` (the
lockstep multi-host plan and its process group). Spatial sharding
(``spatial*.py`` of the JAX package) is not ported yet: ROADMAP Queue 1
item 8."""

from probunet_torch.parallel.mesh import DataParallel, data_parallel  # noqa: F401
from probunet_torch.parallel.multihost import (  # noqa: F401
    MultihostPlan,
    make_plan,
    maybe_initialize_distributed,
    process_info,
)
