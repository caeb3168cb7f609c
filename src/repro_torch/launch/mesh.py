"""Device meshes over the current process group, and the H100's rates.

The port's counterpart of the JAX package's ``launch/mesh.py``. A mesh is
a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group the caller has set up (``init_process_group``: NCCL on
cards, gloo on CPUs, or the fake backend of the dry run, which stands in
for 256 or 512 ranks in one process). Building a mesh never sets up a
group: a function, not module state, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks 0 .. prod(shape) - 1
    of the current process group, row-major (the last axis varies
    fastest, as ``jax.make_mesh`` lays devices out). Raises when no group
    is set up or it has too few ranks."""
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"a {tuple(shape)} mesh {tuple(axes)} needs {need} ranks; the "
            f"process group has {have} (init_process_group first)")
    return DeviceMesh(device_type or default_device_type(),
                      torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """A (1, 1) mesh with the production axes, over rank 0 of a group of
    one process."""
    return make_mesh((1, 1), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or a mesh given as that mapping,
    the reference's ``mesh.shape``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


def batch_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axis_of(mesh) -> str:
    return "model"


# --- NVIDIA H100 SXM5 (80 GB HBM3) rates: the roofline's denominators ---
# From NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column, dense rates
# (no sparsity), at the 700 W limit of the card that
# ``nvidia-smi --query-gpu=name,power.limit`` reports as
# "NVIDIA H100 80GB HBM3, 700.00 W". A card set below 700 W runs slower.
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor-core FLOP/s per card
PEAK_FLOPS_FP32 = 67e12  # float32 FLOP/s per card, outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s per card
NVLINK_BW = 450e9  # NVLink 4 bytes/s per card and direction (900 GB/s both)
