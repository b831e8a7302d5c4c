from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore,
    save,
)
