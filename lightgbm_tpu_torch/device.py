"""Which torch device the port runs on.

``Config.device_type`` keeps its name and aliases so parameter dicts carry
over from the JAX package: ``cpu`` asks for the host (the tests do), every
other value means the CUDA card. There is no silent fallback: asking for
the card on a host without one raises.
"""
from __future__ import annotations

import torch

from .utils.log import LightGBMError


def resolve_device(device_type: str) -> torch.device:
    if str(device_type).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise LightGBMError(
            "device_type=%s runs on the CUDA card, and torch finds none; "
            "pass device_type=cpu to run on the host" % device_type)
    return torch.device("cuda", torch.cuda.current_device())
