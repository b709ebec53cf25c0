from repro_torch.data.pipeline import (
    DataConfig, SyntheticLM, MemmapTokens, ShardedLoader, make_loader,
)

__all__ = ["DataConfig", "SyntheticLM", "MemmapTokens", "ShardedLoader",
           "make_loader"]
