"""Tensor-parallel serve meshes and the collectives of the split model
(port of ``repro/distrib/tp.py``).

JAX serves tensor-parallel from one controller and lets GSPMD partition
its jitted closures. The port has no GSPMD and its kernels take plain
tensors at LOCAL shapes, so it is Megatron-style and multi-controller:

* one process per rank (``torchrun``), each holding plain local shards
  (``sharding.specs.place``), every rank running the same engine over the
  same requests;
* explicit collectives over the mesh's 'model' group (``TPShard``):
  column-parallel wq / wk / wv / wi / wg take none; row-parallel attention
  and MLP ``wo`` all-reduce their outputs; the embedding is vocab-parallel
  (ids outside the local rows are masked, then all-reduced); the LM head
  (or the tied table) is column-parallel and all-gathers its logits, so
  every rank picks the same greedy token.

Training (``train.steps.build_train_step(cfg, tcfg, mesh)``) runs the
same split code under autograd, so every collective is a
``torch.autograd.Function`` over ``torch.distributed`` (gloo or NCCL),
the Megatron pairs:

* ``enter``: identity forward, all-reduce backward, where a replicated
  activation enters a column-parallel block (each rank's gradient is only
  its columns' share); with ``seq_parallel`` an all-gather of the
  sequence forward and a reduce-scatter backward;
* ``leave`` after a row-parallel output: all-reduce forward, identity
  backward; with ``seq_parallel`` a reduce-scatter of the sequence
  forward, an all-gather backward;
* ``all_gather``: forward all-gather, backward the rank's slice (the
  logits, whose loss every rank computes whole);
* ``all_reduce_split``: all-reduce both ways (a sum whose result feeds the
  split computation again: the gated norm's variance);
* ``dp_sum``: the sum of gradients over the data axes (no autograd): the
  data-parallel mean when each rank's term already carries its weight.

Every rank computes the same loss, so a replicated tensor holds the whole
gradient on every rank and a split one its own part.

``serve_mesh(tp, dp)`` builds the dp x tp ("data", "model") mesh; the backend
follows the device (NCCL for ``cuda``, gloo for ``cpu``) unless the caller
names one. Gloo stages CUDA tensors through the host (``TPShard`` does it
explicitly), so two ranks may share one card for a check of the split
kernels, never for a speed.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.specs import (ShardingRules, dp_axes, dp_size,
                                       mesh_shape, tp_size)

SPLIT_FAMILIES = ("decoder", "ssm", "hybrid")   # the image family serves whole


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_world(backend: str, device: torch.device) -> None:
    """Join the process group: from ``torchrun``'s environment when it is
    there, else a world of one (an in-process store, no network). A group
    that is already up must use ``backend``: nothing switches silently."""
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the process group runs {have!r}, "
                             f"{backend!r} was asked for")
        return
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def close_world() -> None:
    """Leave the process group: a barrier (every rank is past its last
    collective), then the group's teardown, so no rank's exit closes a
    connection another rank still reads. A launcher calls it for a group
    it started."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def serve_mesh(tp: int, dp: int = 1, *, device: DeviceLike = "cuda",
               backend: Optional[str] = None):
    """The serving mesh for ``--tp N``: (dp, tp) over ("data", "model").
    tp=1 still yields a real (degenerate) mesh, in a world of one when the
    process was not started by ``torchrun``, so the placement path is the
    same whether or not the model is split."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp={tp} and dp={dp} must be >= 1")
    dev = resolve_device(device)
    init_world(backend or default_backend(dev), dev)
    n = tp * dp
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"serve mesh needs {n} ranks, the process group has "
                         f"{world} — start one process per rank with "
                         f"torchrun --nproc-per-node {n}")
    return make_mesh(dp, tp, device_type=dev.type)


def head_shard_map(fn: Callable, mesh, head_axes: Sequence[Optional[int]],
                   *, heads: Sequence[Optional[int]],
                   out_head_axis: int = 1, axis: str = "model") -> Callable:
    """Wrap a per-shard kernel for the rank's own heads.

    A rank holds only its shards, so the wrapper maps nothing: it checks
    that each head-split argument ``i`` (``head_axes[i]`` its head dim,
    None = replicated) carries ``heads[i] / tp`` heads on that dim, calls
    ``fn`` on the local tensors, and checks the output's head dim
    (``out_head_axis``) likewise against the first split argument. The
    kernel thus sees the local shapes its launch geometry is built for."""
    tp = mesh_shape(mesh).get(axis, 1)

    def local(i, a, ax, total):
        if total % tp:
            raise ValueError(f"argument {i}: {total} heads do not split over "
                             f"{tp} ranks")
        if a.shape[ax] != total // tp:
            raise ValueError(f"argument {i} carries {a.shape[ax]} heads on "
                             f"dim {ax}, the rank's share is {total // tp} "
                             f"of {total}")

    def wrapped(*args, **kwargs):
        first = None
        for i, (a, ax) in enumerate(zip(args, head_axes)):
            if ax is None:
                continue
            local(i, a, ax, heads[i])
            first = heads[i] if first is None else first
        out = fn(*args, **kwargs)
        if first is not None:
            local("out", out, out_head_axis, first)
        return out

    return wrapped

# ---------------------------------------------------------------------------
# raw collectives over one group (gloo stages CUDA tensors through the host)
# ---------------------------------------------------------------------------

class Comm:
    """A process group, its size, this rank's index in it and its backend:
    the raw collectives every split path shares (training's autograd
    functions, whole checkpoint leaves, the compressed gradient mean)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.backend = dist.get_backend(group)

    def host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce(self, y: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum over the group; half-precision partials add in fp32 and
        round once."""
        if self.size == 1:
            return y
        t = self.host(y.to(torch.float32) if y.dtype in
                      (torch.bfloat16, torch.float16) else y.contiguous())
        if t is y:
            t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t.to(device=y.device, dtype=y.dtype)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` joined along ``dim`` in rank order, bits as they
        are (half precision and int8 travel as bytes)."""
        if self.size == 1:
            return x
        raw = x.contiguous()
        if raw.dtype in (torch.bfloat16, torch.float16, torch.int8):
            raw = raw.view(torch.uint8)
        raw = self.host(raw)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(parts, raw, group=self.group)
        out = torch.cat(parts, dim).to(x.device)
        return out.view(x.dtype) if out.dtype != x.dtype else out

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's window of ``dim`` (a contiguous copy)."""
        w = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * w, w).contiguous()

    def reduce_scatter(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the group, this rank keeping its window of ``dim``:
        NCCL's reduce-scatter; gloo has none, so an all-reduce and the
        window there."""
        if self.size == 1:
            return y
        if self.backend != "nccl":
            return self.local(self.all_reduce(y), dim)
        src = y.movedim(dim, 0)
        src = (src.to(torch.float32) if y.dtype in
               (torch.bfloat16, torch.float16) else src).contiguous()
        out = torch.empty((src.shape[0] // self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.movedim(0, dim).to(y.dtype).contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward; backward identity, or all-reduce (``both``)."""

    @staticmethod
    def forward(ctx, y, comm, both):
        ctx.comm, ctx.both = comm, both
        return comm.all_reduce(y)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_reduce(g) if ctx.both else g), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward the rank's slice of the
    gradient (``scatter`` False: it is whole on every rank) or its
    reduce-scatter (the gathered tensor fed a split computation)."""

    @staticmethod
    def forward(ctx, x, comm, dim, scatter):
        ctx.comm, ctx.dim, ctx.scatter = comm, dim, scatter
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        g = c.reduce_scatter(g, ctx.dim) if ctx.scatter else c.local(g, ctx.dim)
        return g, None, None, None


class _GradShare(torch.autograd.Function):
    """Identity forward; backward the gradient times ``scale`` (a rank's
    share of a term every rank computes whole, whose gradients the ranks
    sum)."""

    @staticmethod
    def forward(ctx, y, scale):
        ctx.scale = scale
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward (``reduce``), or the rank's
    slice of a replicated tensor; backward the all-gather."""

    @staticmethod
    def forward(ctx, y, comm, dim, reduce):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter(y, dim) if reduce else comm.local(y, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None, None


_DP_GROUPS = {}


def dp_comm(mesh) -> Optional[Comm]:
    """The group of the data axes (pod x data) holding this rank's model
    coordinate, or None when they have one rank. A (data, model) mesh uses
    its 'data' group; a (pod, data, model) mesh builds one group per model
    coordinate (every rank takes part in every ``new_group``, once per
    mesh)."""
    shape = mesh_shape(mesh)
    n = dp_size(mesh)
    if n == 1:
        return None
    names = tuple(mesh.mesh_dim_names)
    if len(dp_axes(mesh)) == 1:
        ax = dp_axes(mesh)[0]
        return Comm(mesh.get_group(ax), n, mesh.get_local_rank(ax))
    key = id(mesh)
    if key not in _DP_GROUPS:
        ranks = mesh.mesh.reshape(-1, shape.get("model", 1))   # (dp, model)
        groups = [dist.new_group([int(r) for r in ranks[:, m]])
                  for m in range(ranks.shape[1])]
        _DP_GROUPS[key] = groups
    coords = {a: mesh.get_local_rank(a) for a in names}
    idx = 0
    for a in dp_axes(mesh):
        idx = idx * shape[a] + coords[a]
    return Comm(_DP_GROUPS[key][coords.get("model", 0)], n, idx)


def dp_sum(mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's sum over the data axes (pod x data) of ``mesh``, in
    fp32: the data-parallel gradient mean of terms each rank has weighted
    by its share of the batch (identity when the data axes hold one
    rank)."""
    comm = dp_comm(mesh) if mesh is not None else None
    if comm is None:
        return list(tensors)
    return [comm.all_reduce(t) for t in tensors]


class TPShard:
    """One rank's share of a model split over the mesh's 'model' axis: the
    local head and feature counts the model code shapes its tensors by,
    and the collectives it calls at the split points.

    * attention: q heads split when they divide (``heads_split``; then
      ``wo`` is row-parallel); kv heads split with them when they divide
      too. Otherwise K replicates while q splits, and the rank's KV cache
      holds only the kv heads its own q heads read
      (``ShardingRules.kv_heads_kept``; ``kv_select`` picks them out of
      the K heads ``wk`` / ``wv`` compute);
    * MLP: d_ff split when it divides (``ff_split``, ``wo`` row-parallel);
    * vocab: embedding rows and LM-head columns split when the padded
      vocab divides (``vocab_split``);
    * Mamba2: the SSD heads and d_inner split when both divide
      (``mamba_split``; ``models/ssm.py``);
    * MoE (expert parallelism): the expert stacks split by experts when E
      divides (``experts_split``: the rank holds experts ``experts[0]``
      up to ``experts[0] + experts[1]``), else by each expert's d_ff
      (``expert_ff_split``), else replicate; ``models/moe.py`` routes
      globally on every rank and runs the rank's part (``moe_split``).

    ``paged_attention`` is the paged-decode kernel behind
    ``head_shard_map``, wrapped once for the runtime.

    A plain ``{axis: size}`` mapping for ``mesh`` gives rank 0's shard with
    no process group: its local shapes and windows (a plan, as
    ``ShardingRules`` reads a mapping), never its collectives.
    """

    def __init__(self, cfg: ModelConfig, mesh):
        rules = ShardingRules(cfg, mesh)
        self.mesh = mesh
        self.size = rules.tp
        if isinstance(mesh, Mapping):
            self.rank, self.group, self.backend = 0, None, None
            self.comm, self.src = None, 0
        else:
            self.rank = mesh.get_local_rank("model")
            self.group = mesh.get_group("model")
            self.backend = dist.get_backend(self.group)
            self.comm = Comm(self.group, self.size, self.rank)
            self.src = dist.get_global_rank(self.group, 0)
        self.seq_parallel = bool(cfg.seq_parallel)
        self.sp = False                 # set on the copy ``with_seq`` makes
        self.experts_split = rules.experts_shardable
        self.expert_ff_split = (rules.expert_ff_shardable
                                and not self.experts_split)
        self.moe_split = self.experts_split or self.expert_ff_split
        E = cfg.moe_experts
        n = E // self.size if self.experts_split else E
        self.experts = (self.rank * n if self.experts_split else 0, n)
        self.heads_split = rules.attn_heads_shardable
        self.kv_split = rules.kv_heads_shardable
        self.ff_split = rules.ff_shardable
        self.vocab_split = rules.vocab_shardable
        self.mamba_split = rules.mamba_shardable
        H, K = cfg.num_heads, cfg.num_kv_heads
        self.q_heads = H // self.size if self.heads_split else H
        kept = rules.kv_heads_kept(self.rank)
        self.kv_heads = len(kept)
        self.kv_select = (list(kept) if self.heads_split and
                          not self.kv_split and K else None)
        self.bank_gather_bytes = 0      # see count_bank_gather
        kv = 2 if self.kv_split else None
        self.paged_attention = head_shard_map(
            kernel_ops.paged_attention, mesh,
            (1 if self.heads_split else None, kv, kv), heads=(H, K, K))

    # -- collectives ----------------------------------------------------------
    def with_seq(self, seq_len: int) -> "TPShard":
        """This shard for one training forward over ``seq_len`` tokens: a
        copy whose ``sp`` is set when ``cfg.seq_parallel`` holds and the
        sequence divides over the ranks (the residual stream then splits
        on it between blocks), else this shard itself."""
        if not self.seq_parallel or self.size == 1 or seq_len % self.size:
            return self
        out = copy.copy(self)
        out.sp = True
        return out

    def enter(self, x: torch.Tensor, split: bool = True) -> torch.Tensor:
        """The input of a block: ``split`` (column-parallel weights) takes
        the identity forward and sums the ranks' gradients; under ``sp``
        the sequence is all-gathered (its gradient reduce-scattered). An
        unsplit block under ``sp`` gathers the sequence and takes its own
        slice of the gradient."""
        if self.sp:
            return _Gather.apply(x, self.comm, 1, split)
        return _Enter.apply(x, self.comm) if split else x

    def leave(self, y: torch.Tensor, split: bool = True) -> torch.Tensor:
        """The output of a block: ``split`` (a row-parallel partial sum)
        all-reduces, or under ``sp`` reduce-scatters the sequence; an
        unsplit block's whole output under ``sp`` keeps the rank's slice
        of the sequence."""
        if self.sp:
            return _Scatter.apply(y, self.comm, 1, split)
        return _Reduce.apply(y, self.comm, False) if split else y

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum over the 'model' group (half-precision partials add in fp32
        and round once); backward the identity."""
        if self.size == 1:
            return y
        return _Reduce.apply(y, self.comm, False)

    def all_reduce_split(self, y: torch.Tensor) -> torch.Tensor:
        """Sum over the 'model' group whose result feeds the split
        computation: the backward sums the ranks' gradients too."""
        if self.size == 1:
            return y
        return _Reduce.apply(y, self.comm, True)

    def grad_share(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` as it is, its gradient scaled to this rank's 1 / size
        share: a term every rank computes whole (the MoE load-balance loss
        of the global routing) inside a block whose gradients the ranks
        sum."""
        if self.size == 1:
            return y
        return _GradShare.apply(y, 1.0 / self.size)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` joined along ``dim`` in rank order (bits moved
        as they are); backward the rank's slice of the gradient."""
        if self.size == 1:
            return x
        return _Gather.apply(x, self.comm, dim % x.dim(), False)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the 'model' group (a split weight's
        per-channel max |w|, for int8 scales equal to the whole's)."""
        return self.comm.all_reduce(t, op=dist.ReduceOp.MAX)

    def broadcast_ints(self, values: List[int]) -> List[int]:
        """Rank 0's integers on every rank (host decisions that must agree:
        admissions, backpressure)."""
        if self.size == 1:
            return list(values)
        dev = ("cpu" if self.backend == "gloo"
               else torch.device("cuda", torch.cuda.current_device()))
        t = torch.tensor(values, dtype=torch.int64, device=dev)
        dist.broadcast(t, self.src, group=self.group)
        return [int(v) for v in t.cpu()]

    def count_bank_gather(self, got) -> None:
        """Add the bytes this rank received to assemble ``got``, the whole
        factors of a batch's slots from a bank split over its blocks
        (``MethodOps.bank_gather``): all but its own share."""
        n = sum(t.numel() * t.element_size() for t in got.values())
        self.bank_gather_bytes += n - n // self.size

    # -- local windows --------------------------------------------------------
    def local_cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's window of the last dim of a whole row."""
        w = x.shape[-1] // self.size
        return x.narrow(-1, self.rank * w, w)

    def select_kv(self, k: torch.Tensor) -> torch.Tensor:
        """(..., K, hd) -> the kv heads this rank keeps (dim -2)."""
        if self.kv_select is None:
            return k
        idx = torch.as_tensor(self.kv_select, device=k.device)
        return k.index_select(k.dim() - 2, idx)


def model_shard(cfg: ModelConfig, mesh) -> Optional[TPShard]:
    """The runtime's ``TPShard``, or None when the mesh splits nothing
    (tp = 1: the model runs exactly as it does without a mesh). An MoE
    config splits its experts over 'model' where they divide, else each
    expert's d_ff, else runs its MoE layers replicated."""
    if mesh is None or tp_size(mesh) == 1:
        return None
    if cfg.family not in SPLIT_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving of the {cfg.family!r} family is not "
            f"ported (the {SPLIT_FAMILIES} families split)")
    return TPShard(cfg, mesh)
