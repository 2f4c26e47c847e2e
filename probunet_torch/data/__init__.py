from probunet_torch.data.transforms import (  # noqa: F401
    compute_lr_stats,
    invstand_residual,
    make_pair,
    residual_to_hr,
)
from probunet_torch.data.dataset import ClimexDataset  # noqa: F401
