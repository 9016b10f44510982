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

``serve_mesh(tp)`` builds the 1 x tp ("data", "model") mesh; the backend
follows the device (NCCL for ``cuda``, gloo for ``cpu``) unless the caller
names one. Gloo stages CUDA tensors through the host (``TPShard`` does it
explicitly), so two ranks may share one card for a check of the split
kernels, never for a speed.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.specs import ShardingRules, mesh_shape, tp_size

NEXT_SLICE = "the mesh-training slice"
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


def serve_mesh(tp: int, dp: int = 1, *, device: DeviceLike = "cuda",
               backend: Optional[str] = None):
    """The serving mesh for ``--tp N``: (dp, tp) over ("data", "model").
    tp=1 still yields a real (degenerate) mesh, in a world of one when the
    process was not started by ``torchrun``, so the placement path is the
    same whether or not the model is split."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp={tp} and dp={dp} must be >= 1")
    if dp > 1:
        raise NotImplementedError(
            "a 'data' mesh axis above 1 in serving is not ported yet "
            f"({NEXT_SLICE}); serve replicas with --replicas instead")
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
      (``mamba_split``; ``models/ssm.py``).

    ``paged_attention`` is the paged-decode kernel behind
    ``head_shard_map``, wrapped once for the runtime.
    """

    def __init__(self, cfg: ModelConfig, mesh):
        rules = ShardingRules(cfg, mesh)
        self.mesh = mesh
        self.size = rules.tp
        self.rank = mesh.get_local_rank("model")
        self.group = mesh.get_group("model")
        self.backend = dist.get_backend(self.group)
        self.src = dist.get_global_rank(self.group, 0)
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
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """gloo moves CUDA tensors through the host: do it here, once."""
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum over the 'model' group (half-precision partials add in fp32
        and round once)."""
        if self.size == 1:
            return y
        t = self._host(y.to(torch.float32) if y.dtype in
                       (torch.bfloat16, torch.float16) else y.contiguous())
        if t is y:
            t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t.to(device=y.device, dtype=y.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` joined along ``dim`` in rank order (bits moved
        as they are: half precision travels as bytes, which every backend
        takes)."""
        if self.size == 1:
            return x
        raw = x.contiguous()
        if raw.dtype in (torch.bfloat16, torch.float16):
            raw = raw.view(torch.uint8)
        raw = self._host(raw)
        parts = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(parts, raw, group=self.group)
        out = torch.cat(parts, dim).to(x.device)
        return out.view(x.dtype) if out.dtype != x.dtype else out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the 'model' group (a split weight's
        per-channel max |w|, for int8 scales equal to the whole's)."""
        if self.size == 1:
            return t
        h = self._host(t.contiguous()).clone()
        dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self.group)
        return h.to(t.device)

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
    (tp = 1: the model runs exactly as it does without a mesh)."""
    if mesh is None or tp_size(mesh) == 1:
        return None
    if cfg.family not in SPLIT_FAMILIES:
        raise NotImplementedError(
            f"tensor-parallel serving of the {cfg.family!r} family is not "
            f"ported (the {SPLIT_FAMILIES} families split)")
    return TPShard(cfg, mesh)
