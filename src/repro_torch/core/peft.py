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
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

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
    """``repro.core.peft.PEFTConfig`` (same fields and defaults).
    ``use_pallas`` is kept for one-for-one conversion; kernel choice follows
    the device."""
    method: str = "gsoft"          # any core.methods entry, or full|none
    block_size: int = 32
    block_size_out: int = 0
    rank: int = 8
    alpha: float = 16.0
    boft_factors: int = 2
    reflections: int = 4           # householder factor count (even)
    givens_rounds: int = 4         # givens brick-wall round count
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
        rank=cfg.rank, alpha=cfg.alpha, boft_factors=cfg.boft_factors,
        reflections=cfg.reflections, givens_rounds=cfg.givens_rounds,
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
              device: DeviceLike = "cuda",
              seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapter tree: {weight_path: adapter_params}, W_eff(init) == W. The
    random draws (LoRA's A) come from one generator seeded with ``seed``,
    in sorted path order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {path: init_adapter(spec, gen, dtype, dev)
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


# methods whose weight-side form is Q @ W with Q on the input rows only: a
# rank holding a block of W's columns rotates it alone
INPUT_SIDE_METHODS = ("gsoft", "oft", "boft", "householder", "givens")


def materialize_split(cfg: PEFTConfig, params: Tree,
                      adapters: Dict[str, Dict[str, torch.Tensor]],
                      specs: Mapping[str, Tuple], whole, local,
                      regather: bool = True) -> Tree:
    """``materialize_tree`` for a rank holding its shards of ``params`` and
    its adapters, differentiable w.r.t. the adapters. ``specs[path]`` is a
    weight's spec (entries: an axis or None). The adapters of a weight
    split on a batch dim (an expert stack split by experts: expert
    parallelism) are the rank's rows of that dim, as the weight is; every
    other weight's are whole. A weight split on batch dims only, and under
    an input-side method also on its output columns, is rotated where it
    is: one launch per local stack, nothing gathered (the batch dims are
    the rotation's rows). Any other split weight is rotated one slice of
    its batch dims at a time:
    ``whole((path, i), w, spec)`` gathers slice i's frozen weight, it is
    rotated and ``local(w, spec)`` cuts it back to the rank's block. With
    ``regather`` each slice is checkpointed under autograd, so only one
    slice's whole weight lives at a time and the backward gathers it again;
    without, autograd keeps the gathered slices until the backward. The
    adapter spec is the whole weight's, as the adapters were drawn."""
    if not adapters:
        return params

    def visit(path, leaf):
        if path not in adapters:
            return leaf
        spec = tuple(specs.get(path, ()))
        split = {i for i, ax in enumerate(spec) if ax is not None}
        in_place = set(range(leaf.dim() - 2))     # the batch dims
        if cfg.method in INPUT_SIDE_METHODS:
            # an input-side method reads only d_in of its spec
            in_place.add(leaf.dim() - 1)
        if split <= in_place:
            return materialize(spec_for(cfg, tuple(leaf.shape)),
                               adapters[path], leaf)
        return _rotate_slices(cfg, path, adapters[path], leaf, spec, whole,
                              local, regather)

    return _map_paths(params, visit)


def _rotate_slices(cfg: PEFTConfig, path: str,
                   factors: Dict[str, torch.Tensor], leaf: torch.Tensor,
                   spec: Tuple, whole, local, regather: bool):
    """A split weight's rotation, slice by slice over its layer dims."""
    lead = tuple(leaf.shape[:-2])
    inner = tuple(spec[len(lead):])
    names = sorted(factors)

    def one(i, w, *fs):
        w = whole((path, i), w, inner)
        return local(materialize(spec_for(cfg, tuple(w.shape)),
                                 dict(zip(names, fs)), w), inner)

    grad = regather and torch.is_grad_enabled() and any(
        f.requires_grad for f in factors.values())
    n = math.prod(lead)
    ws = leaf.reshape((n,) + tuple(leaf.shape[-2:]))
    fs = [factors[k].reshape((n,) + tuple(factors[k].shape[len(lead):]))
          for k in names]
    out = [checkpoint(one, i, ws[i], *(f[i] for f in fs),
                      use_reentrant=False)
           if grad else one(i, ws[i], *(f[i] for f in fs)) for i in range(n)]
    return torch.stack(out).reshape(lead + tuple(out[0].shape))


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

PEFTConfigs = Union[PEFTConfig, Mapping[str, PEFTConfig]]


@dataclasses.dataclass
class AdapterBank:
    """Stacked per-request rotations for multi-adapter serving.

    ``tree`` mirrors the params nesting: each adapted weight path maps to
    ``{method: factors}``, each method's pre-processed per-slot stacks
    (Cayley-orthogonalized GS / OFT / BOFT blocks, normalized Householder
    vectors, Givens cos/sin) over A slots after the layer dim, e.g.
    ``{"gsoft": {"L": (L, A, r, b, b), "R": ...}}``. Slot 0 is the identity
    (serves the base model); slots 1..N are the named adapters in ``names``
    order. In a mixed-method bank every method stack spans all A slots and
    holds that method's identity wherever the slot's adapter uses another
    method, so the per-row composition of all stacks is the one rotation of
    the row's adapter."""
    cfg: PEFTConfig                  # primary/default config (bank knobs)
    names: Tuple[str, ...]
    tree: Dict[str, Any]
    device: torch.device
    # the config each named adapter was built with
    cfgs: Dict[str, PEFTConfig] = dataclasses.field(default_factory=dict)

    @property
    def num_slots(self) -> int:
        return len(self.names)

    @property
    def bank_methods(self) -> Tuple[str, ...]:
        """Methods actually present in this bank (sorted)."""
        return tuple(sorted({c.method for c in self.cfgs.values()}))

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


def normalize_bank_cfgs(adapters_by_name: Mapping[str, Any],
                        peft_cfg: PEFTConfigs
                        ) -> Tuple[PEFTConfig, Dict[str, PEFTConfig]]:
    """(primary, {name: cfg}) from either a single PEFTConfig (homogeneous
    bank) or a {name: PEFTConfig} mapping (mixed-method bank)."""
    if isinstance(peft_cfg, PEFTConfig):
        return peft_cfg, {name: peft_cfg for name in adapters_by_name}
    cfgs = dict(peft_cfg)
    missing = sorted(set(adapters_by_name) - set(cfgs))
    if missing:
        raise ValueError(f"no PEFTConfig for adapters {missing} — a mixed-"
                         "method bank needs one config per adapter name")
    if not cfgs:
        raise ValueError("empty PEFTConfig mapping — pass a single "
                         "PEFTConfig for an adapterless (identity-only) "
                         "bank")
    primary = next(iter(cfgs.values()))
    return primary, {name: cfgs[name] for name in adapters_by_name}


def bank_capability_check(name: Optional[str], cfg: PEFTConfig) -> None:
    """The method must be registered and provide ``bank_build``
    (``MethodOps.bank_unsupported`` explains why not)."""
    ops = methods_lib.get(cfg.method)   # KeyError lists registered methods
    if ops.bank_build is None:
        who = f"adapter '{name}'" if name else "the bank config"
        raise ValueError(f"adapter bank cannot serve {who}: method "
                         f"{cfg.method!r} has no bank path — "
                         f"{ops.bank_unsupported}")
    if cfg.use_scale:
        raise ValueError("adapter bank does not support use_scale "
                         "(the per-output magnitude acts on the weight "
                         "output, not the rotated input)")


def check_bank_member(name: str, cfg: PEFTConfig, primary: PEFTConfig,
                      cfg_of_method: Dict[str, PEFTConfig]) -> None:
    """One adapter's admissibility against a bank under ``primary``:
    bankable method, bank-wide knobs, one config per method. Mutates
    ``cfg_of_method`` (method -> canonical config)."""
    bank_capability_check(name, cfg)
    if cfg.target_patterns != primary.target_patterns:
        raise ValueError(
            f"adapter '{name}': target_patterns differ from the bank's "
            "— all adapters in one bank must adapt the same weights")
    if cfg.use_pallas != primary.use_pallas:
        raise ValueError(
            f"adapter '{name}': use_pallas differs from the bank's — "
            "the kernel path is a bank-wide choice")
    prev = cfg_of_method.setdefault(cfg.method, cfg)
    if prev != cfg:
        raise ValueError(
            f"adapter '{name}' shares method {cfg.method!r} with other "
            "adapters but differs in config — one bank holds one stack "
            "(hence one config) per method")


def bank_specs(cfg: PEFTConfig, params: Tree) -> Dict[str, AdapterSpec]:
    """Adapted-path specs a serving bank can hold: a weight with more than
    one batch dim (MoE experts (L, E, d_in, d_out), hybrid blocks) raises
    ValueError, as in JAX; a bank whose ``target_patterns`` leave those
    weights out (e.g. the attention projections only) serves."""
    specs = adapted_paths(cfg, params)
    for path, spec in specs.items():
        if len(spec.batch) > 1:
            raise ValueError(
                f"adapter bank cannot serve {path}: weights with batch dims "
                f"{spec.batch} (MoE experts / hybrid blocks) need "
                "routing-aware rotation")
    return specs


def _tree_device(params: Tree) -> torch.device:
    return next(iter(flatten_paths(params).values())).device


def build_adapter_bank(cfg: PEFTConfigs, params: Tree,
                       adapters_by_name: Dict[str, Dict[str, Dict[str, torch.Tensor]]]
                       ) -> AdapterBank:
    """Build an AdapterBank from named adapter trees (as from ``init_peft``),
    on the device of ``params``.

    ``cfg`` is a single PEFTConfig (every adapter uses it) or a
    {name: PEFTConfig} mapping for a mixed-method bank. Per path, each
    method's factors are pre-processed up front and stacked over
    [identity] + adapters (slots of another method hold this method's
    identity), so the tree matches the JAX bank's leaf for leaf. All
    configs must share ``target_patterns`` / ``use_pallas``, and adapters
    of one method must share its config (one stack per method)."""
    primary, cfg_by_name = normalize_bank_cfgs(adapters_by_name, cfg)
    bank_capability_check(None, primary)
    cfg_of_method: Dict[str, PEFTConfig] = {}
    names_of_method: Dict[str, set] = {}
    for name, c in cfg_by_name.items():
        check_bank_member(name, c, primary, cfg_of_method)
        names_of_method.setdefault(c.method, set()).add(name)

    device = _tree_device(params)
    names = (BASE_ADAPTER,) + tuple(adapters_by_name)
    tree: Dict[str, Any] = {}
    for path, spec in sorted(bank_specs(primary, params).items()):
        shape = tuple(spec.batch) + (spec.d_in, spec.d_out)
        entry: Dict[str, Any] = {}
        for m in sorted(cfg_of_method):
            members = names_of_method[m]
            params_by_slot: List[Optional[Dict[str, torch.Tensor]]] = [None]
            for name in names[1:]:
                if name not in members:
                    params_by_slot.append(None)     # other method: identity
                    continue
                if path not in adapters_by_name[name]:
                    raise KeyError(f"adapter '{name}' has no params for {path}")
                params_by_slot.append(adapters_by_name[name][path])
            entry[m] = methods_lib.get(m).bank_build(
                spec_for(cfg_of_method[m], shape), params_by_slot, device)
        _nest_insert(tree, path, entry)
    return AdapterBank(cfg=primary, names=names, tree=tree, device=device,
                       cfgs=cfg_by_name)


# ---------------------------------------------------------------------------
# adapter context: the per-request adapter state of one batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdapterContext:
    """The bank subtree and the slot ids of the current batch, carried
    through prefill/decode as one object. ``slots`` is one (B,) id tensor
    indexing every method stack (an eager bank, whose stacks all span its
    slots) or ``{method: (B,) compact ids}`` (a store-paged bank, whose
    stacks hold only their own method's members)."""
    bank: Tree
    slots: Union[torch.Tensor, Dict[str, torch.Tensor]]

    def group(self, *names) -> Optional[Dict]:
        """Bank subtree under ``names`` (e.g. ``"layers"``), or None."""
        node: Any = self.bank
        for n in names:
            node = node.get(n) if isinstance(node, dict) else None
            if node is None:
                return None
        return node or None

    def rotator(self, group: Optional[Dict],
                shard=None) -> Optional["BankRotator"]:
        """Rotation hook over one (layer-sliced) module subtree, or None.
        ``shard`` (a ``distrib.tp.TPShard``) lets a rank rotate with a
        bank stack it holds only part of (``MethodOps.bank_gather``)."""
        if group is None or self.slots is None:
            return None
        return BankRotator(group, self.slots, shard)


class BankRotator:
    """``rot(name, x)`` rotates row i of x with its own adapter (slot 0 =
    identity) before projection ``name``; each method stack of the entry
    applies in turn (sorted).

    ``quant_rotation`` splits the work for a quantized base matmul: the
    method that can fuse with the quantized kernel (GSOFT) hands back its
    bank and the slot ids, so rotation and int8 matmul run as one
    ``gs_q_matmul_bank`` call; the other stacks apply to x first.

    Under tensor parallelism (``shard``) x is always a whole row; a stack
    the rank holds only part of (GSOFT split over its blocks) is gathered
    for the batch's slots first (``MethodOps.bank_gather``)."""

    __slots__ = ("_group", "slots", "shard")

    def __init__(self, group: Dict, slots: torch.Tensor, shard=None):
        self._group = group
        self.slots = slots
        self.shard = shard

    def ids(self, method: str) -> torch.Tensor:
        """The slot ids that index ``method``'s stack."""
        if isinstance(self.slots, dict):
            return self.slots[method]
        return self.slots

    def adapts(self, name: str) -> bool:
        """Does the bank hold a rotation for projection ``name``?"""
        return self._group.get(name) is not None

    def _stack(self, method: str, entry, width: int):
        """(stack, ids) of ``method`` for a row of ``width`` features."""
        ops = methods_lib.get(method)
        ids = self.ids(method)
        if self.shard is None or ops.bank_gather is None:
            return entry, ids
        got, ids = ops.bank_gather(entry, ids, width, self.shard.all_gather)
        if got is not entry:
            self.shard.count_bank_gather(got)
        return got, ids

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        entry = self._group.get(name)
        if entry is None:
            return x
        for m in sorted(entry):
            e, ids = self._stack(m, entry[m], x.shape[-1])
            x = methods_lib.get(m).bank_rotator(e, ids, x)
        return x

    def quant_rotation(self, name: str, x: torch.Tensor, dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
        """-> (x with the unfusible method stacks applied, the hand-off of
        the (at most one) method whose ``quant_fuse`` fuses with the
        quantized matmul (GSOFT: its bank (L, R) and the slot ids), or
        None). Same fixed sorted method order as ``__call__``."""
        entry = self._group.get(name)
        if entry is None:
            return x, None
        fused = None
        for m in sorted(entry):
            ops = methods_lib.get(m)
            e, ids = self._stack(m, entry[m], x.shape[-1])
            if fused is None and ops.quant_fuse is not None:
                fused = ops.quant_fuse(e, ids, dtype)
            else:
                x = ops.bank_rotator(e, ids, x)
        return x, fused


@dataclasses.dataclass(frozen=True)
class PrefillRequest:
    """Everything one prefill call needs beyond params/state: the input
    batch, the per-row ``last_idx`` and the optional AdapterContext."""
    batch: Dict[str, torch.Tensor]
    last_idx: Optional[torch.Tensor] = None
    ctx: Optional[AdapterContext] = None
