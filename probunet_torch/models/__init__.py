from probunet_torch.models.unet import UNet, UNetBlock, build_unet_plan  # noqa: F401
from probunet_torch.models.prob_unet import (  # noqa: F401
    AxisAlignedConvGaussian,
    Fcomb,
    ProbabilisticUNet,
)
from probunet_torch.models.edm import EDMPrecond  # noqa: F401
from probunet_torch.models.baselines import (  # noqa: F401
    ConvVAE,
    LinearCNN,
    bcsd,
    day_of_year_365,
)
