from repro_torch.train.supervisor import (
    TrainEvent,
    TrainReport,
    WrathTrainSupervisor,
)

__all__ = ["WrathTrainSupervisor", "TrainEvent", "TrainReport"]
