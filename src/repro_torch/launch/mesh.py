"""Production mesh construction and the H100's roofline constants (the port
of ``repro.launch.mesh``).

The mesh builders are FUNCTIONS, not module-level constants, so importing
this module starts no process group and no CUDA context: they build a
``torch.distributed.device_mesh.DeviceMesh`` under the process group the
caller has started (``torch.distributed.init_process_group`` with its
address, world size and rank).  :func:`elastic_mesh_shape` is the pure
shape arithmetic of the elastic mesh, which the builder uses.

Hardware constants: one NVIDIA H100 SXM5, dense rates without sparsity,
from NVIDIA's H100 Tensor Core GPU datasheet (at the card's 700 W limit).
"""
from __future__ import annotations

import math

#: bf16 (and fp16) tensor-core peak, FLOP/s (H100 SXM5 datasheet, dense)
PEAK_FLOPS_BF16 = 989e12
#: fp32 peak outside the tensor cores, FLOP/s (H100 SXM5 datasheet)
PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth, bytes/s (H100 SXM5 datasheet: 80 GB at 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4 bandwidth of one GPU in one direction, bytes/s (H100 SXM5
#: datasheet: 900 GB/s both ways, all to all within a host)
NVLINK_BW_PER_DIRECTION = 450e9

#: chips of one pod and of two, and the ``model`` axis every mesh keeps
POD_CHIPS = 256
MODEL_AXIS = 16


def elastic_mesh_shape(n_lost_hosts: int = 0, *, chips_per_host: int = 4,
                       multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the largest divisor-friendly mesh left after
    losing ``n_lost_hosts`` hosts.

    WRATH's environment-layer recovery: denylisted hosts shrink the
    ``data`` axis to the largest power of two that still fits, keeping
    ``model`` intact so parameter sharding (and thus checkpoint layout
    compatibility) is preserved; two pods keep a ``pod`` axis while
    ``data`` is at least 32."""
    total = (2 * POD_CHIPS if multi_pod else POD_CHIPS) - n_lost_hosts * chips_per_host
    data = 1 << int(math.floor(math.log2(max(total // MODEL_AXIS, 1))))
    if multi_pod and data >= 32:
        return (2, data // 2, MODEL_AXIS), ("pod", "data", "model")
    return (data, MODEL_AXIS), ("data", "model")


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group (which the caller has started)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_elastic_mesh(n_lost_hosts: int = 0, *, chips_per_host: int = 4,
                      multi_pod: bool = False, device_type: str = "cuda"):
    """The mesh of :func:`elastic_mesh_shape` over the default process
    group, whose world size must be the mesh's chip count."""
    shape, axes = elastic_mesh_shape(n_lost_hosts, chips_per_host=chips_per_host,
                                     multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def mesh_chip_count(mesh) -> int:
    return int(mesh.size())
