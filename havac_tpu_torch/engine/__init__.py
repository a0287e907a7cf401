from havac_tpu_torch.engine.api import (
    DEFAULT_P_VALUE,
    Havac,
    HavacRunState,
    HavacUsageError,
    RunStats,
)

__all__ = [
    "DEFAULT_P_VALUE",
    "Havac",
    "HavacRunState",
    "HavacUsageError",
    "RunStats",
]
