from repro_torch.injection.engines import (
    FAILURE_TYPES,
    FailureInjector,
    NoInjector,
)

__all__ = ["FailureInjector", "NoInjector", "FAILURE_TYPES"]
