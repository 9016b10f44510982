"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``. Without a card they raise instead of
carrying on on the CPU: running there is something a caller asks for with
``device="cpu"`` (the CPU tests do), never a silent fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU explicitly")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
