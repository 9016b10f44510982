"""PyTorch + CUDA port of the ``repro`` GSOFT system, for NVIDIA Hopper.

Mirrors ``repro``'s module layout so every module has one JAX counterpart.
The package imports ``torch`` and numpy only. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; kernels follow the
device of the tensors they are given (see ``kernels/ops.py``).
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
