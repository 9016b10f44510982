"""Pipeline parallelism: the GPipe schedule over a mesh axis (port of
``repro/sharding/pipeline.py``).

JAX runs the schedule in one ``shard_map``: every device holds one stage's
slice of the stacked parameters, activations move stage to stage with
``ppermute``, and a ``psum`` hands the last stage's outputs to every
device. The port is multi-controller: each rank along ``axis`` holds its
own stage's parameters, the ``ppermute`` becomes a point-to-point send to
the next stage and a receive from the previous one (``torch.distributed``
``isend`` / ``irecv``, tagged by microbatch; gloo stages CUDA tensors
through the host), each inside an autograd function whose backward sends
the gradient back, and the last stage's outputs are broadcast to every
rank (backward: the last stage keeps its own gradient, which every rank
holds whole). A stage computes only its active microbatches (JAX computes
the idle slots on zeros and masks them: the same outputs). Bubble
fraction = (S - 1) / (M + S - 1).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist


class _Link:
    """This rank's place on the pipeline axis: group, stage index, stage
    count and the neighbours' global ranks."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.idx = mesh.get_local_rank(axis)
        self.n = dist.get_world_size(self.group)
        self.gloo = dist.get_backend(self.group) == "gloo"
        rank = lambda i: dist.get_global_rank(self.group, i)  # noqa: E731
        self.prev = rank(self.idx - 1) if self.idx > 0 else None
        self.next = rank(self.idx + 1) if self.idx < self.n - 1 else None
        self.last = rank(self.n - 1)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        return t.cpu() if self.gloo and t.is_cuda else t

    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        """Send and wait until the peer has it: every stage takes its
        microbatches in one order (ascending forward, descending backward)
        and the last stage never waits on a later one, so no cycle forms."""
        dist.isend(self._wire(t), dst, group=self.group, tag=tag).wait()

    def recv(self, like: torch.Tensor, src: int, tag: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.gloo else like.device)
        dist.irecv(buf, src, group=self.group, tag=tag).wait()
        return buf.to(like.device)


class _Send(torch.autograd.Function):
    """Forward: send y to the next stage; returns a 0-d tie the caller adds
    (times 0) to its output so that the backward runs. Backward: receive
    dy from the next stage."""

    @staticmethod
    def forward(ctx, y, link, tag):
        ctx.link, ctx.tag, ctx.like = link, tag, y.detach()
        link.send(y, link.next, tag)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        link = ctx.link
        return link.recv(ctx.like, link.next, ctx.tag), None, None


class _Recv(torch.autograd.Function):
    """Forward: receive the previous stage's activations (``like`` gives
    shape and dtype; ``anchor``, a 0-d tensor that needs a gradient, makes
    the output need one, so the backward always runs). Backward: send
    their gradient back."""

    @staticmethod
    def forward(ctx, like, anchor, link, tag):
        ctx.link, ctx.tag = link, tag
        return link.recv(like, link.prev, tag)

    @staticmethod
    def backward(ctx, g):
        ctx.link.send(g, ctx.link.prev, ctx.tag)
        return None, None, None, None


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's tensor on every rank of the axis.
    Backward: the last stage keeps the gradient (whole on every rank, so
    counted once), the others none."""

    @staticmethod
    def forward(ctx, t, link):
        ctx.link = link
        buf = link._wire(t).clone()
        dist.broadcast(buf, link.last, group=link.group)
        return buf.to(t.device)

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        return (g if link.idx == link.n - 1 else torch.zeros_like(g)), None


def gpipe_forward(stage_fn: Callable, stage_params: Any, x_mb: torch.Tensor,
                  mesh, axis: str = "pipe") -> torch.Tensor:
    """Run M microbatches through the S stages of ``mesh``'s ``axis``.

    stage_fn:      (params, activations (mb, ...)) -> activations of the
                   same shape and dtype
    stage_params:  THIS rank's stage's parameters (any pytree; a rank holds
                   its stage, as ``stage_slice`` cuts it from a stacked tree)
    x_mb:          (M, mb, ...) microbatched input (stage 0 reads it)
    Returns (M, mb, ...) outputs, the same on every rank; differentiable
    w.r.t. every stage's parameters (each rank gets its own stage's
    gradients) and the input. Every rank of the axis must call it."""
    link = _Link(mesh, axis)
    nstage, nmb = link.n, x_mb.shape[0]
    idx = link.idx
    outs: List[torch.Tensor] = [x_mb[0] * 0 for _ in range(nmb)]
    anchor = torch.zeros((), device=x_mb.device,
                         requires_grad=torch.is_grad_enabled())
    ties = []
    for t in range(nmb + nstage - 1):
        mb = t - idx                          # this stage's microbatch
        if not 0 <= mb < nmb:
            continue
        feed = (x_mb[mb] if idx == 0
                else _Recv.apply(x_mb[0], anchor, link, mb))
        y = stage_fn(stage_params, feed)
        if link.next is not None:
            ties.append(_Send.apply(y, link, mb))
        else:
            outs[mb] = y
    out = _FromLast.apply(torch.stack(outs), link)
    for tie in ties:
        out = out + tie
    return out


def stage_slice(stacked: Any, mesh, axis: str = "pipe") -> Any:
    """This rank's stage of a tree whose leaves carry a leading stage dim
    (JAX's ``stage_params`` layout)."""
    i = mesh.get_local_rank(axis)
    if isinstance(stacked, dict):
        return {k: stage_slice(v, mesh, axis) for k, v in stacked.items()}
    return stacked[i]


def pipeline_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1) / (M + S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
