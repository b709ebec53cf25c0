"""Industrial DLRM from the paper's Table 2: 100 tables, concat vec 3200,
FC stack (2048, 512, 256), 50 GB embeddings.

Copy of `repro/configs/dlrm.py`: the use-case config (paper §6).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_tables: int = 100
    emb_dim: int = 32            # 3200 / 100 lookups
    rows_per_table: int = 4_000_000   # ~51 GB total at fp32 x 32-dim
    dense_features: int = 0
    fc_dims: tuple = (2048, 512, 256)
    out_dim: int = 1


CONFIG = DLRMConfig()


def reduced() -> DLRMConfig:
    return DLRMConfig(n_tables=8, emb_dim=16, rows_per_table=1000,
                      fc_dims=(64, 32), out_dim=1)
