from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
