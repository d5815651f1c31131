from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train_step import (
    cross_entropy,
    init_train_state,
    loss_fn,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cross_entropy",
    "init_train_state", "loss_fn", "make_train_step", "value_and_grad",
]
