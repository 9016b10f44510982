"""Partition rules for serving (port of the serving half of
``repro/sharding/specs.py``).

Mesh axes: ("data", "model"), or ("pod", "data", "model") multi-pod. DP =
pod x data, TP = model (Megatron: column-parallel wq / wk / wv / wi / wg,
row-parallel wo, vocab-parallel embedding and LM head).

A spec is a plain tuple with one entry per dim: a mesh-axis name or None
(replicated), the empty tuple meaning "all replicated" — the port's form of
JAX's ``PartitionSpec``, so ``tuple(jax_spec) == port_spec`` entry for
entry. Every rule is divisibility-guarded as in the JAX package: a dim that
does not divide its mesh axis falls back to replication.

``ShardingRules`` takes a mesh from ``launch.mesh`` (a
``torch.distributed`` ``DeviceMesh`` with named dims) or a plain
``{axis: size}`` mapping (no process group needed: what the rules read is
the axis sizes). ``place`` / ``place_leaf`` keep each rank's contiguous
local slice of a leaf, copied to the rank's device; ``gather_leaf`` is
the inverse (the whole leaf from every rank's slice, for a checkpoint).
``kv_heads_kept`` is the one place that says which kv heads a rank's KV
caches hold.

Training: ``act_spec`` names the activations' specs as JAX's table does
(``seq_parallel`` splits the residual stream's sequence over 'model');
the port splits them by hand in the model code, so ``make_sharder``'s
callback cuts a WHOLE activation to the rank's block (the multi-
controller form of a sharding constraint, for checks), ``opt_state_tree``
places the optimizer state as JAX's ``train`` does (``mu`` / ``nu`` as the
trainable tree: the adapters, or the params under full fine-tuning;
``step`` replicated), ``block_split`` says which weights sit in a split
block (their replicated adapters' gradients are partial sums over
'model'), ``grad_share`` says the same of every param under full
fine-tuning, and ``expert_split`` which expert stacks split by experts
(expert parallelism: their adapters split with them).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.quant.core import QuantTensor, is_quant_tensor

Tree = Any
Spec = Tuple[Optional[str], ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a plain mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_size(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= shape[a]
    return n


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _ax(axes):
    """Normalize an axis entry as ``PartitionSpec`` does: () -> None
    (replicated), a one-axis tuple -> its name."""
    if axes is None or (isinstance(axes, tuple) and len(axes) == 0):
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _map_paths(fn: Callable[[str, Any], Any], tree: Tree,
               prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over a nested dict, ``/``-joined paths (the JAX
    package's ``path_str``); a QuantTensor is one leaf."""
    if isinstance(tree, Mapping):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


class ShardingRules:
    """Derives parameter and serve-state specs for one arch on one mesh."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.tp = tp_size(mesh)
        self.dp = dp_axes(mesh)
        c = cfg
        is_moe = getattr(c, "is_moe", False)
        self.attn_heads_shardable = _div(c.num_heads, self.tp)
        self.kv_heads_shardable = _div(c.num_kv_heads, self.tp)
        self.ff_shardable = _div(c.d_ff, self.tp) if c.d_ff else False
        self.expert_ff_shardable = (_div(c.expert_d_ff, self.tp)
                                    if is_moe else False)
        self.experts_shardable = is_moe and _div(c.moe_experts, self.tp)
        self.vocab_shardable = _div(c.padded_vocab(), self.tp)
        self.mamba_shardable = (c.ssm_state > 0 and _div(c.ssm_heads, self.tp)
                                and _div(c.d_inner, self.tp))
        # the kv-head entry of every KV spec (decode and paged states)
        self.kv_axis = "model" if self.kv_heads_shardable else None

    def kv_heads_kept(self, rank: int) -> Tuple[int, ...]:
        """The global kv heads rank ``rank``'s KV caches and page pools
        hold, in order: its contiguous K / tp where the state specs split
        kv heads over 'model' (``kv_axis``). Where they replicate kv heads
        under a q-head split (K < tp), JAX keeps all K on every rank; the
        port keeps only those the rank's q heads read (global q head h
        reads h // (H / K)), once each when the grouping is uniform over
        the rank's heads, else one per q head, so that ``paged_decode``
        sees the rank's q heads over their own kv heads. Otherwise all K."""
        H, K = self.cfg.num_heads, self.cfg.num_kv_heads
        if self.kv_axis is not None:
            n = K // self.tp
            return tuple(range(rank * n, (rank + 1) * n))
        if not self.attn_heads_shardable or K == 0:
            return tuple(range(K))
        nq, g = H // self.tp, H // K
        of = [(rank * nq + j) // g for j in range(nq)]
        uniq = sorted(set(of))
        per = nq // len(uniq)
        uniform = (nq % len(uniq) == 0 and
                   of == [u for u in uniq for _ in range(per)])
        return tuple(uniq if uniform else of)

    # -- parameters ---------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        tp = "model"

        def guarded(axis_idx_from_end: int, ok: bool) -> Spec:
            if not ok:
                return ()
            spec = [None] * len(shape)
            spec[len(shape) - axis_idx_from_end] = tp
            return tuple(spec)

        if re.search(r"embed/table$", path):
            return (tp, None) if self.vocab_shardable else ()
        if re.search(r"lm_head/w$", path):
            return (None, tp) if self.vocab_shardable else ()
        if re.search(r"moe/router$", path):
            return ()
        if re.search(r"moe/(wi|wg|wo)$", path):
            if self.experts_shardable:
                return (None, tp, None, None)
            if self.expert_ff_shardable:
                return ((None, None, None, tp) if path.endswith(("wi", "wg"))
                        else (None, None, tp, None))
            return ()
        if re.search(r"attn/(wq)$", path) or re.search(r"cross/(wq)$", path):
            return guarded(1, self.attn_heads_shardable)
        if re.search(r"(attn|cross)/(wk|wv)$", path):
            return guarded(1, self.kv_heads_shardable)
        if re.search(r"(attn|cross)/(bq)$", path):
            return guarded(1, self.attn_heads_shardable)
        if re.search(r"(attn|cross)/(bk|bv)$", path):
            return guarded(1, self.kv_heads_shardable)
        if re.search(r"(attn|cross)/wo$", path):
            return guarded(2, self.attn_heads_shardable)
        if re.search(r"(mlp|shared_attn)/wi$", path) or \
                re.search(r"mlp/(wi|wg)$", path) or re.search(r"/wg$", path):
            return guarded(1, self.ff_shardable)
        if re.search(r"mlp/wo$", path):
            return guarded(2, self.ff_shardable)
        if re.search(r"patch_proj/wi$", path):
            return ()
        # mamba
        if re.search(r"/(wz|wx)$", path):
            return guarded(1, self.mamba_shardable)
        if re.search(r"/wdt$", path):
            return guarded(1, self.mamba_shardable and
                           _div(self.cfg.ssm_heads, self.tp))
        if re.search(r"/(wb|wc)$", path):
            return ()
        if re.search(r"/(A_log|D|dt_bias)$", path):
            return guarded(1, self.mamba_shardable)
        if re.search(r"/gate_norm$", path):
            return guarded(1, self.mamba_shardable)
        if re.search(r"out_proj/wo$", path):
            return guarded(2, self.mamba_shardable)
        if re.search(r"/(conv_w|conv_b)$", path):
            return ()
        return ()   # norms, scalars, anything unmatched: replicate

    def params_tree(self, params: Tree) -> Tree:
        return _map_paths(lambda p, l: self.param_spec(p, tuple(l.shape)),
                          params)

    # -- adapters (PEFT) ------------------------------------------------------
    def adapter_spec(self, weight_path: str, shape: Tuple[int, ...]) -> Spec:
        # per-expert adapters follow their expert's EP sharding
        if "/moe/" in weight_path and self.experts_shardable and \
                len(shape) >= 2 and shape[1] == self.cfg.moe_experts:
            return (None, "model", *([None] * (len(shape) - 2)))
        return ()   # adapters are tiny: replicate

    def adapters_tree(self, adapters: Tree) -> Tree:
        return {wpath: _map_paths(
                    lambda _p, l, w=wpath: self.adapter_spec(w, tuple(l.shape)),
                    tree)
                for wpath, tree in adapters.items()}


    # -- training: optimizer state, gradients, activations -------------------
    def opt_state_tree(self, opt_state: Tree, trainable_spec: Tree) -> Tree:
        """AdamW's state follows the trainable tree (``mu``, ``nu`` as
        ``trainable_spec``: the adapters' specs under PEFT, the params'
        under full fine-tuning; ``step`` replicated); any other
        optimizer's state replicates, as JAX's ``train`` places it."""
        if set(opt_state) == {"mu", "nu", "step"}:
            return {"mu": trainable_spec, "nu": trainable_spec, "step": ()}
        return _map_paths(lambda _p, _l: (), opt_state)

    def expert_split(self, path: str) -> bool:
        """Is the weight at ``path`` an expert stack (layers, E, d_in,
        d_out) split over 'model' by its experts (expert parallelism)? Its
        adapters then split with it (``adapter_spec``), and a rank rotates
        its own experts with its own adapters."""
        return (self.tp > 1 and self.experts_shardable
                and re.search(r"moe/(wi|wg|wo)$", path) is not None)

    def block_split(self, path: str) -> bool:
        """Does the weight at ``path`` sit in a block whose computation
        splits over 'model' (the MLP by d_ff, Mamba by heads, attention by
        q heads, an MoE layer by experts or by the experts' d_ff)? A
        replicated weight read there (Mamba's wb / wc and conv, unsplit kv
        heads, the MoE router) then gets on each rank only that rank's
        share of its gradient, as does a replicated adapter of any weight
        there: each rank uses only its part of the block's output."""
        if self.tp == 1:
            return False
        if "/moe/" in path:
            return self.experts_shardable or self.expert_ff_shardable
        if "/mlp/" in path:
            return self.ff_shardable
        if "/mamba/" in path:
            return self.mamba_shardable
        if "/attn/" in path:
            return self.attn_heads_shardable
        return False

    def grad_share(self, path: str, spec: Spec, seq_split: bool) -> bool:
        """Full fine-tuning: is a rank's gradient of the param at ``path``
        (placed under ``spec``) a share, to be summed over 'model', rather
        than whole? What the port's split forward computes on a rank:

        * a leaf split over 'model' holds its own block's whole gradient;
        * a replicated leaf in a split block (``block_split``) holds a
          share;
        * with the sequence split (``seq_split``: ``seq_parallel`` and a
          sequence that divides), the norms on the residual stream (before
          each block and the final one) see only the rank's tokens and
          hold shares. Everything else is whole: an unsplit block gathers
          the sequence and takes back the whole gradient of its output
          (``TPShard.leave``'s backward all-gathers it), the embedding
          lookup likewise, and the LM head (split or not) sees the
          gathered sequence; so tied embeddings are whole twice over;
        * every other replicated leaf is whole: each rank computes the
          same loss from the same replicated residual stream."""
        if self.tp == 1 or "model" in tuple(spec):
            return False
        if seq_split and re.search(r"(^|/)(attn_norm|mlp_norm|norm|"
                                   r"final_norm)$", path):
            return True
        return self.block_split(path)

    def act_spec(self, name: str) -> Optional[Spec]:
        """JAX's activation table: the spec of activation ``name``, None for
        a name it does not know."""
        dp, tp = _ax(self.dp), "model"
        sp = "model" if getattr(self.cfg, "seq_parallel", False) else None
        table = {
            "act_btd": (dp, sp, None),
            "act_d": (dp, sp, None),
            "act_ff": (dp, None, tp) if self.ff_shardable else (dp, None, None),
            "act_heads": ((dp, None, tp, None) if self.attn_heads_shardable
                          else (dp, None, None, None)),
            "act_kv_heads": ((dp, None, tp, None) if self.kv_heads_shardable
                             else (dp, None, None, None)),
            "act_inner": ((dp, None, tp) if self.mamba_shardable
                          else (dp, None, None)),
            "logits": ((dp, None, tp) if self.vocab_shardable
                       else (dp, None, None)),
            "moe_expert_in": ((tp, dp, None, None) if self.experts_shardable
                              else (None, dp, None, None)),
            "moe_expert_out": ((tp, dp, None, None) if self.experts_shardable
                               else (None, dp, None, None)),
        }
        return table.get(name)

    def make_sharder(self, batch_divisible: bool = True):
        """``shard(x, name)``: the rank's block of the WHOLE activation
        ``x`` under ``act_spec(name)``, with JAX's guards (an unknown name,
        or any split dim that does not divide its axes, leaves ``x`` whole;
        without ``batch_divisible`` the batch dim stays whole)."""
        mesh = self.mesh

        def shard(x, name):
            spec = self.act_spec(name)
            if spec is None:
                return x
            if not batch_divisible and spec and spec[0] == _ax(self.dp):
                spec = (None,) + tuple(spec[1:])
            for dim, ax in zip(x.shape, tuple(spec) + (None,) * x.dim()):
                if ax is None:
                    continue
                n = 1
                for a in ((ax,) if isinstance(ax, str) else ax):
                    n *= self.sizes[a]
                if dim % n:
                    return x
            return local_slice(mesh, x, spec)

        return shard

    # -- serve-time placement -------------------------------------------------
    def _fit(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """Divisibility guard at leaf granularity: any spec axis whose dim
        does not divide its mesh axes drops to None (replicated), so one
        rule covers a weight and its keepdims quantization scales."""
        out = []
        for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
            if ax is None:
                out.append(None)
                continue
            n = 1
            for a in ((ax,) if isinstance(ax, str) else ax):
                n *= self.sizes[a]
            out.append(ax if dim % n == 0 else None)
        return tuple(out)

    def serve_leaf_spec(self, path: str, leaf):
        """One leaf's serving spec (a QuantTensor of specs for a quantized
        weight: the int8 codes shard like the logical weight, the fp32
        scales reuse that spec wherever their keepdims shape divides)."""
        spec = self.param_spec(path, tuple(leaf.shape))
        if is_quant_tensor(leaf):
            return QuantTensor(q=self._fit(spec, tuple(leaf.q.shape)),
                               scale=self._fit(spec, tuple(leaf.scale.shape)),
                               meta=leaf.meta)
        return self._fit(spec, tuple(leaf.shape))

    def serve_params_tree(self, params: Tree) -> Tree:
        """Param specs for a serving runtime (``serve_leaf_spec`` per leaf:
        a per-channel scale keeps its out-channel split, size-1 reduced
        dims replicate)."""
        return _map_paths(self.serve_leaf_spec, params)

    def paged_state_spec(self, state: Tree) -> Tree:
        """Paged KV: the (L, P, page, K, hd) page pools split over the
        kv-head axis on 'model'; the page table and scalars replicate (host
        page allocation never sees the mesh). JAX's placement; where it
        replicates kv heads, the port's ranks hold ``kv_heads_kept``."""
        kv = self.kv_axis

        def one(path, l):
            if "pages/" in path or path.endswith(("/k", "/v")):
                spec = [None] * l.dim()
                if l.dim() >= 2:
                    spec[l.dim() - 2] = kv
                return self._fit(tuple(spec), tuple(l.shape))
            return ()

        return _map_paths(one, state)

    def bank_spec_tree(self, bank_tree: Tree) -> Tree:
        """Adapter-bank factor placement: replicated, except where a
        method's ``MethodOps.bank_shard_axes`` hook names a factor axis
        that may split over 'model' (GSOFT's block axis r)."""
        from repro_torch.core import methods as methods_lib
        registered = set(methods_lib.registered())

        def one(path, leaf):
            parts = path.split("/")
            method = next((s for s in parts if s in registered), None)
            if method is None:
                return ()
            hook = methods_lib.get(method).bank_shard_axes
            if hook is None:
                return ()
            ax = hook(parts[-1], tuple(leaf.shape))
            if ax is None:
                return ()
            spec = [None] * leaf.dim()
            spec[ax % leaf.dim()] = "model"
            return self._fit(tuple(spec), tuple(leaf.shape))

        return _map_paths(one, bank_tree)

    # -- batches / states -----------------------------------------------------
    def batch_spec(self, batch: Tree, batch_size: int) -> Tree:
        ok = _div(batch_size, dp_size(self.mesh))
        lead = _ax(self.dp if ok else ())

        def one(_p, l):
            return (lead, *([None] * (l.dim() - 1))) if l.dim() else ()
        return _map_paths(one, batch)

    def decode_state_spec(self, state: Tree, batch_size: int) -> Tree:
        """KV caches (L, B, S, K, hd) / Mamba states: batch on dp, kv heads
        / SSD heads on 'model' where they divide (kv heads as in
        ``paged_state_spec``)."""
        ok_b = _div(batch_size, dp_size(self.mesh))
        dp = _ax(self.dp if ok_b else ())
        kv = self.kv_axis
        ssm_h = "model" if self.mamba_shardable else None

        def one(path, l):
            nd = l.dim()
            if "kv/" in path or path.endswith(("/k", "/v")):
                if nd == 5:
                    return (None, dp, None, kv, None)
                if nd == 4:
                    return (dp, None, kv, None)
            if "mamba/ssm" in path:
                return (*((None,) * (nd - 4)), dp, ssm_h, None, None)
            if "mamba/conv" in path:
                return (*((None,) * (nd - 3)), dp, None, None)
            if "enc_out" in path:
                return (dp, None, None)
            return (dp, *([None] * (nd - 1))) if nd else ()

        return _map_paths(one, state)


# ---------------------------------------------------------------------------
# placement: each rank keeps its contiguous local slice
# ---------------------------------------------------------------------------

def _coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each mesh axis."""
    if isinstance(mesh, Mapping):
        return {a: 0 for a in mesh}
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def local_slice(mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; ``t`` itself when
    nothing splits). An axis split over several mesh axes takes them in
    order, the first the slowest, as a ``NamedSharding`` lays them out."""
    if not spec:
        return t
    sizes, coords = mesh_shape(mesh), _coords(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"divide over {axes} ({n})")
        w = t.shape[dim] // n
        t = t.narrow(dim, idx * w, w)
    return t


def place_leaf(mesh, leaf, spec, device=None):
    """One leaf cut to this rank's slice (a QuantTensor's codes and scales
    by their own specs) on ``device`` (default the leaf's). A real split
    or a move is a copy, so the whole leaf can be freed; an unsplit leaf
    that stays where it is comes back as it is."""
    if is_quant_tensor(leaf):
        return QuantTensor(place_leaf(mesh, leaf.q, spec.q, device),
                           place_leaf(mesh, leaf.scale, spec.scale, device),
                           leaf.meta)
    local = local_slice(mesh, leaf, spec)
    if device is not None:
        local = local.to(device)        # a move copies the slice alone
    if local is leaf or (local.untyped_storage().data_ptr()
                         != leaf.untyped_storage().data_ptr()):
        return local
    return local.contiguous().clone()


def place(mesh, tree: Tree, spec_tree: Tree, device=None) -> Tree:
    """Each leaf of ``tree`` cut to this rank's local slice per
    ``spec_tree`` (``place_leaf``), one leaf at a time."""
    if isinstance(tree, Mapping):
        return {k: place(mesh, v, spec_tree[k], device)
                for k, v in tree.items()}
    return place_leaf(mesh, tree, spec_tree, device)


def whole_shape(mesh, shape: Tuple[int, ...], spec: Spec) -> Tuple[int, ...]:
    """The whole leaf's shape of a local block of ``shape`` under
    ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, ax in enumerate(tuple(spec)[:len(shape)]):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            out[dim] *= sizes[a]
    return tuple(out)


def gather_leaf(mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` under ``spec`` (the
    inverse of ``local_slice``): an all-gather over each split axis, the
    inner axis of a dim first, bits moved as they are. Every rank of the
    mesh must call it (collective over the axes' groups); no autograd."""
    from repro_torch.distrib.tp import Comm

    sizes = mesh_shape(mesh)
    for dim, ax in enumerate(tuple(spec)[:t.dim()]):
        if ax is None:
            continue
        for a in reversed((ax,) if isinstance(ax, str) else tuple(ax)):
            if sizes[a] > 1:
                comm = Comm(mesh.get_group(a), sizes[a],
                            mesh.get_local_rank(a))
                t = comm.all_gather(t, dim)
    return t
