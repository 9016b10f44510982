"""Carry trees between the JAX package and the port.

A JAX param or adapter tree, handed over as numpy arrays (``np.asarray`` of
each leaf, e.g. via ``jax.tree.map``), becomes the port's nested dict of
tensors with the same keys, so ``/``-joined paths match leaf for leaf and
both packages compute the same thing. bf16 leaves arrive as numpy's
``ml_dtypes`` bfloat16, which torch cannot read directly; they pass through
float32 exactly. ``to_numpy`` carries a port tree back as numpy arrays, so
tests compare the two packages' trees leaf by leaf. ``quant_params_from_numpy``
carries a quantized JAX tree across with identical int8 codes and scales.
``config_from_jax`` carries a JAX ``ModelConfig`` over field for field
(``seq_parallel`` and ``remat`` included; the JAX-only fields drop).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.quant.core import QuantMeta, QuantTensor


def _leaf(a, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(tree: Any, device: torch.device, dtype) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def params_from_numpy(tree: Mapping, device: DeviceLike = "cuda",
                      dtype: Optional[torch.dtype] = None) -> dict:
    """Model params (nested dicts of arrays, as ``repro`` ``init_lm``
    returns them) -> the port's tree on ``device``; ``dtype`` casts every
    leaf (None keeps each leaf's own dtype)."""
    return _convert(tree, resolve_device(device), dtype)


def adapters_from_numpy(tree: Mapping, device: DeviceLike = "cuda",
                        dtype: Optional[torch.dtype] = None) -> dict:
    """Adapter trees — ``{path: {"L", "R"}}`` from ``init_peft`` or
    ``{name: {path: ...}}`` for a bank — -> the port's trees on
    ``device``, paths unchanged."""
    return _convert(tree, resolve_device(device), dtype)


def opt_state_from_numpy(state: Mapping, device: DeviceLike = "cuda") -> dict:
    """An optimizer state of ``repro.optim`` — {"mu": tree, "nu": tree,
    "step": int32 scalar} for AdamW, {"mu", "step"} for SGD — handed over
    as numpy arrays -> the port's state (``repro_torch.optim``), dtypes
    kept."""
    return _convert(state, resolve_device(device), None)


_QUANT_KEYS = ({"q", "scale"}, {"q", "scale", "dtype"})


def quant_params_from_numpy(tree: Mapping,
                            device: DeviceLike = "cuda") -> dict:
    """A quantized JAX param tree -> the port's, each ``QuantTensor`` leaf
    handed over as a ``{"q", "scale"}`` mapping of numpy arrays (optionally
    with ``"dtype"``, the logical weight dtype's name, default "bfloat16"),
    every other leaf as a numpy array. The codes and scales carry over
    unchanged, so both packages multiply by the same int8 weights."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, Mapping) and set(node) in _QUANT_KEYS:
            q = np.asarray(node["q"])
            if q.dtype != np.int8:
                raise TypeError(f"quantized codes must be int8, got {q.dtype}")
            meta = QuantMeta(dtype=str(node.get("dtype", "bfloat16")))
            return QuantTensor(_leaf(q, dev, None),
                               _leaf(node["scale"], dev, torch.float32), meta)
        if isinstance(node, Mapping):
            return {k: visit(v) for k, v in node.items()}
        return _leaf(node, dev, None)

    return visit(tree)


def to_numpy(tree: Any) -> Any:
    """A port tree (nested dicts of tensors) -> the same nesting of numpy
    arrays; bf16 leaves become float32 (exact), which numpy can hold."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def config_from_jax(jcfg: Any):
    """The port's ``ModelConfig`` with every field a JAX ``ModelConfig``
    shares with it carried one for one (tuples stay tuples)."""
    import dataclasses

    from repro_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
