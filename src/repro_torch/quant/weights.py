"""Weight-tree quantization for serving: int8 base weights, float adapters
(port of ``repro/quant/weights.py``).

``quantize_params(params, cfg)`` replaces every weight matching
``cfg.target_patterns`` (the projections the ``qlinear`` hook carries) with
a ``QuantTensor``; norms, biases and the embedding keep their dtype, and
adapter banks are never part of the params tree, so per-request rotations
stay in float. The tree is quantized one leaf at a time (and each stacked
leaf one layer at a time), so the float temporaries never exceed one layer
of one weight; ``release_source=True`` also drops each float leaf from the
source tree once its codes exist, so the float and int8 trees never both sit
in device memory whole.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Tuple

import torch

from .core import _FP8_MSG, is_quant_tensor, quantize_tensor

Tree = Any

DEFAULT_QUANT_TARGETS: Tuple[str, ...] = (
    r"(.*/)?(attn|cross|mlp|patch_proj)/(wq|wk|wv|wo|wi|wg)$",
    r"lm_head/w$",
    r"(.*/)?(conv\d+|down)/wc$",
)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How to quantize a serving weight tree (``repro.quant.QuantConfig``)."""
    mode: str = "int8"             # int8 | fp8 (not ported) | none
    per_channel: bool = True       # per-output-channel scales (axis -1)
    use_pallas: bool = False       # kept for one-for-one conversion; unread
    target_patterns: Tuple[str, ...] = DEFAULT_QUANT_TARGETS

    @property
    def axis(self) -> Optional[int]:
        return -1 if self.per_channel else None

    @property
    def enabled(self) -> bool:
        return self.mode != "none"


def _matches(cfg: QuantConfig, path: str) -> bool:
    return any(re.fullmatch(p, path) for p in cfg.target_patterns)


def quantize_params(params: Tree, cfg: QuantConfig, *,
                    release_source: bool = False, amax_reduce=None) -> Tree:
    """Replace every targeted >= 2-D float weight with a QuantTensor (a new
    tree; untouched leaves are shared). ``release_source=True`` deletes each
    quantized leaf from ``params`` as soon as its codes exist, which frees
    its memory unless something else holds it: ``params`` is left without
    those leaves and must not be served afterwards. ``amax_reduce(path)``
    (a split model's hook) returns, per weight, a function that combines
    the per-channel max |w| of the rank's slice into the whole weight's,
    or None when the slice's own is already whole."""
    if not cfg.enabled:
        return params
    if cfg.mode == "fp8":
        raise NotImplementedError(_FP8_MSG)
    if cfg.mode != "int8":
        raise ValueError(f"unknown quantization mode {cfg.mode!r} "
                         "(have: int8, fp8)")

    def visit(node: Mapping, prefix: str) -> dict:
        out = {}
        for k in list(node):
            path = f"{prefix}/{k}" if prefix else str(k)
            leaf = node[k]
            if isinstance(leaf, Mapping):
                out[k] = visit(leaf, path)
                continue
            if is_quant_tensor(leaf):
                raise ValueError(f"{path} is already quantized — "
                                 "quantize_params expects a float weight tree")
            if (leaf.dim() >= 2 and leaf.is_floating_point()
                    and _matches(cfg, path)):
                out[k] = quantize_tensor(
                    leaf, mode=cfg.mode, axis=cfg.axis,
                    use_pallas=cfg.use_pallas,
                    amax_reduce=(amax_reduce(path) if amax_reduce
                                 else None))
                if release_source:
                    del node[k]
            else:
                out[k] = leaf
        return out

    return visit(params, "")


def _map(tree: Tree, fn) -> Tree:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def dequantize_params(params: Tree) -> Tree:
    """Back to a plain float tree (testing / debugging)."""
    return _map(params, lambda l: l.dequantize() if is_quant_tensor(l) else l)


def is_quantized_tree(params: Tree) -> bool:
    return any(is_quant_tensor(l) for l in _leaves(params))


def tree_bytes(params: Tree) -> int:
    """Parameter memory in bytes (QuantTensor-aware): the device residency
    of the weights."""
    total = 0
    for leaf in _leaves(params):
        if is_quant_tensor(leaf):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
