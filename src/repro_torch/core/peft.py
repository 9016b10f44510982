"""PEFT engine (port of ``repro/core/peft.py``).

Frozen base params and adapter params are separate nested dicts whose
``/``-joined paths equal ``repro.core.peft.flatten_paths`` of the JAX trees.
``trainable_and_frozen`` splits them for the train step, and
``materialize_tree`` applies adapters weight-side — differentiably, in every
training step, and once for the offline serving merge;
``AdapterBank`` stacks named adapters for per-request, activation-side
serving, and ``AdapterContext`` / ``BankRotator`` carry a batch's slot ids
through the model.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import methods as methods_lib
from .adapters import AdapterSpec, init_adapter, materialize

Tree = Any

DEFAULT_TARGETS: Tuple[str, ...] = (
    r".*/(wq|wk|wv|wo|wi|wg)$",       # attention + MLP/MoE projections
    r".*/(wz|wx)$",                   # mamba in-projections (z / x branches)
    r".*/(in_proj|out_proj)$",
    r".*/wc$",                        # image-family conv channel mixers
)


@dataclasses.dataclass(frozen=True)
class PEFTConfig:
    """The GSOFT / Double GSOFT fields of ``repro.core.peft.PEFTConfig``
    (same names and defaults). ``use_pallas`` is kept for one-for-one conversion; kernel
    choice follows the device."""
    method: str = "gsoft"
    block_size: int = 32
    block_size_out: int = 0
    neumann_order: Optional[int] = None
    use_scale: bool = False
    use_pallas: bool = False
    target_patterns: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def is_peft(self) -> bool:
        return methods_lib.is_adapter_method(self.method)


# ---------------------------------------------------------------------------
# path utilities
# ---------------------------------------------------------------------------

def flatten_paths(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over nested dicts, keys in sorted order (as JAX's
    tree flattening orders dict keys)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten_paths(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def matches_patterns(patterns, path: str) -> bool:
    """fullmatch only: ``.*/wq`` must not also match ``.../wq_extra``."""
    return any(re.fullmatch(pat, path) for pat in patterns)


# ---------------------------------------------------------------------------
# spec inference + init
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def spec_for(cfg: PEFTConfig, shape: Tuple[int, ...]) -> AdapterSpec:
    """The AdapterSpec for a weight shape (batch dims lead)."""
    if len(shape) < 2:
        raise ValueError(f"cannot adapt weight of shape {shape}")
    return AdapterSpec(
        method=cfg.method, d_in=int(shape[-2]), d_out=int(shape[-1]),
        block_size=cfg.block_size, block_size_out=cfg.block_size_out,
        neumann_order=cfg.neumann_order,
        use_scale=cfg.use_scale, use_pallas=cfg.use_pallas,
        batch=tuple(int(s) for s in shape[:-2]))


def adapted_paths(cfg: PEFTConfig, params: Tree) -> Dict[str, AdapterSpec]:
    """Which weights get adapters, and with what spec."""
    if not cfg.is_peft:
        return {}
    return {path: spec_for(cfg, tuple(leaf.shape))
            for path, leaf in flatten_paths(params).items()
            if leaf.dim() >= 2 and matches_patterns(cfg.target_patterns, path)}


def init_peft(cfg: PEFTConfig, params: Tree,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapter tree: {weight_path: adapter_params}, identity-initialized."""
    dev = resolve_device(device)
    return {path: init_adapter(spec, None, dtype, dev)
            for path, spec in sorted(adapted_paths(cfg, params).items())}


def _map_paths(tree: Tree, fn, prefix: str = "") -> Tree:
    if isinstance(tree, Mapping):
        return {k: _map_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def materialize_tree(cfg: PEFTConfig, params: Tree,
                     adapters: Dict[str, Dict[str, torch.Tensor]],
                     merged: bool = False) -> Tree:
    """Effective parameter tree with adapters applied weight-side,
    differentiable w.r.t. the adapters (the train step calls it under
    autograd; keep it out of ``no_grad`` there). ``merged=True`` marks the
    offline single-merge call sites; same math."""
    del merged
    if not adapters:
        return params

    def visit(path, leaf):
        if path in adapters:
            return materialize(spec_for(cfg, tuple(leaf.shape)),
                               adapters[path], leaf)
        return leaf

    return _map_paths(params, visit)


def count_params(tree: Tree) -> int:
    return sum(int(v.numel()) for v in flatten_paths(tree).values()
               if isinstance(v, torch.Tensor))


def trainable_and_frozen(cfg: PEFTConfig, params: Tree, adapters: Tree):
    """(trainable, frozen) split for the optimizer / train step (the
    ``full``/``none`` pseudo-methods are interpreted by the registry
    module)."""
    return methods_lib.trainable_split(cfg.method, params, adapters)


# ---------------------------------------------------------------------------
# adapter bank: N named adapters + identity slot, per-request serving
# ---------------------------------------------------------------------------

BASE_ADAPTER = "__base__"


@dataclasses.dataclass
class AdapterBank:
    """Stacked per-request orthogonal rotations for multi-adapter serving.

    ``tree`` mirrors the params nesting: each adapted weight path maps to
    ``{method: factors}`` with factors stacked over A slots after the layer
    dim, e.g. ``{"L": (L, A, r, b, b), "R": ...}``. Slot 0 is the identity
    (serves the base model); slots 1..N are the named adapters in ``names``
    order."""
    cfg: PEFTConfig
    names: Tuple[str, ...]
    tree: Dict[str, Any]
    device: torch.device

    def slot(self, name: Optional[str]) -> int:
        """Bank slot for an adapter name (None / BASE_ADAPTER -> identity)."""
        if name is None:
            return 0
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown adapter '{name}'; bank has "
                           f"{list(self.names)}") from None

    def context(self, slot_ids) -> "AdapterContext":
        return AdapterContext(
            bank=self.tree,
            slots=torch.as_tensor(slot_ids, dtype=torch.int64,
                                  device=self.device))

    def validate(self, name: Optional[str]) -> None:
        self.slot(name)

    def acquire(self, name: Optional[str]) -> Optional[int]:
        """Admission-time slot claim: an eager bank is fully resident."""
        return self.slot(name)

    def release(self, name: Optional[str]) -> None:
        """Request-finished unpin (no-op for a fully-resident bank)."""


def _nest_insert(root: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split("/")
    node = root
    for seg in parts[:-1]:
        node = node.setdefault(seg, {})
    node[parts[-1]] = value


def bank_capability_check(cfg: PEFTConfig) -> None:
    ops = methods_lib.get(cfg.method)   # KeyError lists registered methods
    if ops.bank_build is None:
        raise ValueError(f"adapter bank cannot serve method {cfg.method!r}: "
                         f"it has no bank path — {ops.bank_unsupported}")
    if cfg.use_scale:
        raise ValueError("adapter bank does not support use_scale "
                         "(the per-output magnitude acts on the weight "
                         "output, not the rotated input)")


def bank_specs(cfg: PEFTConfig, params: Tree) -> Dict[str, AdapterSpec]:
    specs = adapted_paths(cfg, params)
    for path, spec in specs.items():
        if len(spec.batch) > 1:
            raise ValueError(
                f"adapter bank cannot serve {path}: weights with batch dims "
                f"{spec.batch} need routing-aware rotation")
    return specs


def _tree_device(params: Tree) -> torch.device:
    return next(iter(flatten_paths(params).values())).device


def build_adapter_bank(cfg: PEFTConfig, params: Tree,
                       adapters_by_name: Dict[str, Dict[str, Dict[str, torch.Tensor]]]
                       ) -> AdapterBank:
    """Build an AdapterBank from named adapter trees (as from ``init_peft``),
    on the device of ``params``. Per path, factors are Cayley-processed up
    front and stacked over [identity] + adapters under the method's key, so
    the tree matches the JAX bank's leaf for leaf. (The JAX package also
    takes a ``{name: PEFTConfig}`` mapping for mixed-method banks; with one
    method ported, one config covers every adapter.)"""
    bank_capability_check(cfg)
    device = _tree_device(params)
    ops = methods_lib.get(cfg.method)
    names = (BASE_ADAPTER,) + tuple(adapters_by_name)
    tree: Dict[str, Any] = {}
    for path, spec in sorted(bank_specs(cfg, params).items()):
        params_by_slot: List[Optional[Dict[str, torch.Tensor]]] = [None]
        for name in names[1:]:
            if path not in adapters_by_name[name]:
                raise KeyError(f"adapter '{name}' has no params for {path}")
            params_by_slot.append(adapters_by_name[name][path])
        _nest_insert(tree, path,
                     {cfg.method: ops.bank_build(spec, params_by_slot, device)})
    return AdapterBank(cfg=cfg, names=names, tree=tree, device=device)


# ---------------------------------------------------------------------------
# adapter context: the per-request adapter state of one batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdapterContext:
    """The bank subtree and the (B,) slot ids of the current batch, carried
    through prefill/decode as one object."""
    bank: Tree
    slots: torch.Tensor

    def group(self, *names) -> Optional[Dict]:
        """Bank subtree under ``names`` (e.g. ``"layers"``), or None."""
        node: Any = self.bank
        for n in names:
            node = node.get(n) if isinstance(node, dict) else None
            if node is None:
                return None
        return node or None

    def rotator(self, group: Optional[Dict]) -> Optional["BankRotator"]:
        """Rotation hook over one (layer-sliced) module subtree, or None."""
        if group is None or self.slots is None:
            return None
        return BankRotator(group, self.slots)


class BankRotator:
    """``rot(name, x)`` rotates row i of x with its own adapter (slot 0 =
    identity) before projection ``name``; each method stack of the entry
    applies in turn (sorted)."""

    __slots__ = ("_group", "slots")

    def __init__(self, group: Dict, slots: torch.Tensor):
        self._group = group
        self.slots = slots

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        entry = self._group.get(name)
        if entry is None:
            return x
        for m in sorted(entry):
            x = methods_lib.get(m).bank_rotator(entry[m], self.slots, x)
        return x


@dataclasses.dataclass(frozen=True)
class PrefillRequest:
    """Everything one prefill call needs beyond params/state: the input
    batch, the per-row ``last_idx`` and the optional AdapterContext."""
    batch: Dict[str, torch.Tensor]
    last_idx: Optional[torch.Tensor] = None
    ctx: Optional[AdapterContext] = None
