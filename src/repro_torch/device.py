"""Where the port's entry points run."""
from __future__ import annotations

from typing import List

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another (``cpu``, or ``meta`` for shapes without data, as the dry run
    traces a step). Raises when CUDA is asked for (or defaulted to) and
    absent — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def local_devices(device=None) -> List[torch.device]:
    """The devices an entry point may spread its work over (the port's
    ``jax.local_device_count()``): every visible card for CUDA, else
    ``[device]`` itself. The experiment facade reads the list here and
    nowhere else."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
