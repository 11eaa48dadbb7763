from repro_torch.checkpoint.store import (
    key_paths,
    latest_step,
    load_pytree,
    load_train_state,
    save_pytree,
    save_train_state,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_train_state",
    "load_train_state",
    "latest_step",
    "key_paths",
]
