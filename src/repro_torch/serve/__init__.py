"""Production serving plane: queue -> admission -> batcher -> replicas.

``queue``, ``autoscaler`` and ``driver`` are copies of ``src/repro/serve/``
(the driver's default decode backend is the port's
:class:`TorchDecodeBackend`); ``batcher`` ports the decode backend.
"""
from repro_torch.serve.autoscaler import QUEUE_DEPTH_GAUGE, ReplicaAutoscaler
from repro_torch.serve.batcher import (DecodeBackend, ReplicaSlots,
                                       SimDecodeBackend, TorchDecodeBackend,
                                       advance_slots)
from repro_torch.serve.driver import Request, ServeReport, WrathServeDriver
from repro_torch.serve.queue import (RequestQueue, ServeRequest,
                                     SLOAdmissionPolicy)

__all__ = [
    "WrathServeDriver", "Request", "ServeReport",
    "ServeRequest", "RequestQueue", "SLOAdmissionPolicy",
    "ReplicaAutoscaler", "QUEUE_DEPTH_GAUGE",
    "DecodeBackend", "TorchDecodeBackend", "SimDecodeBackend",
    "ReplicaSlots", "advance_slots",
]
