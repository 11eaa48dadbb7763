from repro_torch.training.adapt import (
    AdaptState,
    alpha_lookup,
    default_adapt_setup,
    host_refresh,
    init_adapt,
    make_adapt,
    record_taus,
    sample_taus,
)
from repro_torch.training.steps import (
    TrainState,
    init_params,
    init_train_state,
    make_serve_step,
    make_step,
    param_template,
    param_view,
)

__all__ = [
    "AdaptState",
    "alpha_lookup",
    "default_adapt_setup",
    "host_refresh",
    "init_adapt",
    "make_adapt",
    "record_taus",
    "sample_taus",
    "TrainState",
    "init_params",
    "init_train_state",
    "make_serve_step",
    "make_step",
    "param_template",
    "param_view",
]
