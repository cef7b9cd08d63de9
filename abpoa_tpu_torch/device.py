"""Device resolution: the torch device every entry point passes down.

`cuda` (the default everywhere) must be an sm_90 card, since the kernels are
built for sm_90a. `cpu` runs each kernel's plain PyTorch version. There is
no silent fallback from one to the other.
"""
from __future__ import annotations

import torch

REQUIRED_CAPABILITY = (9, 0)


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device for `name` ("cuda", "cuda:N" or "cpu"); raises
    RuntimeError when a CUDA device is asked for and none of capability
    9.0 is present."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"unknown device {name!r}: use cuda or cpu") from e
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            "pass --device cpu (Params.device = 'cpu') to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a (9.0)")
    return dev
