from probunet_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
)
from probunet_torch.train.steps import (  # noqa: F401
    beta_schedule,
    edm_heun_chain,
    edm_sample,
    make_crps_eval_fn,
    make_edm_crps_eval_fn,
    make_edm_eval_step,
    make_edm_sample_fn,
    make_edm_train_step,
    make_probunet_eval_step,
    make_probunet_train_multistep,
    make_probunet_train_step,
    make_sample_fn,
)
