"""The optimizer of the port (reference: `repro/optim/`)."""
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, apply_updates,
    global_norm, clip_by_global_norm, opt_specs,
)
from repro_torch.optim.schedules import cosine_warmup, linear_warmup

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "apply_updates",
    "global_norm", "clip_by_global_norm", "opt_specs", "cosine_warmup",
    "linear_warmup",
]
