from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    list_steps,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "list_steps", "restore", "save"]
