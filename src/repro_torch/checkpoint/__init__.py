from repro_torch.checkpoint.manager import (
    CheckpointCorruption,
    CheckpointManager,
    all_steps,
    latest_step,
    latest_verified_step,
    restore,
    save,
    verify,
)

__all__ = ["CheckpointCorruption", "CheckpointManager", "all_steps",
           "latest_step", "latest_verified_step", "restore", "save",
           "verify"]
