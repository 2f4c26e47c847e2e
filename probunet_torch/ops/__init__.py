from probunet_torch.ops.resample import (  # noqa: F401
    avg_pool,
    bilinear_upsample,
    nearest_upsample_2x,
)
from probunet_torch.ops.norm import group_norm, group_norm_silu, num_groups_for  # noqa: F401
from probunet_torch.ops.distributions import DiagGaussian, kl_diag_gaussian  # noqa: F401
