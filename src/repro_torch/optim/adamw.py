"""AdamW + SGD-momentum, functional (port of ``repro/optim/adamw.py``).

``init`` returns a state tree, ``update`` maps (grads, state, params) ->
(new_params, new_state, metrics), term for term as the JAX package: the
global-norm clip, fp32 moments, the bias correction, and weight decay masked
off 1-D params (norm scales, biases). Trees are nested dicts of tensors.
Under PEFT these states exist only for the adapter params. On a mesh each
rank updates its own shards; the train step hands in the global sum of
squares (``sum_sq``), so the clip and ``grad_norm`` are the whole tree's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | sgd
    learning_rate: float = 1e-3      # peak LR (schedules scale it)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    momentum: float = 0.9            # sgd


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    """Leaves in sorted-key order (the order of JAX's dict flattening)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree: Tree, sum_sq: Optional[Callable] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares. ``sum_sq(tree)``, when
    given, returns that sum instead: on a mesh, a leaf split over ranks
    counts every rank's part once (summed over the ranks) and a replicated
    leaf once, so every rank gets the whole tree's norm."""
    if sum_sq is not None:
        return torch.sqrt(sum_sq(tree) + 1e-30)
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(sum(leaves) + 1e-30)


def _clip_scale(grads: Tree, max_norm: float,
                sum_sq: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the factor that clips ``grads`` to ``max_norm``, their norm)."""
    gn = global_norm(grads, sum_sq)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def clip_by_global_norm(grads: Tree, max_norm: float,
                        sum_sq: Optional[Callable] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    scale, gn = _clip_scale(grads, max_norm, sum_sq)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def init(cfg: OptimizerConfig, params: Tree) -> Tree:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kind == "adamw":
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": step}
    if cfg.kind == "sgd":
        return {"mu": tree_map(zeros, params), "step": step}
    raise ValueError(cfg.kind)


def _unzip(tree: Tree, n: int) -> Tuple[Tree, ...]:
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def update(cfg: OptimizerConfig, grads: Tree, state: Tree, params: Tree,
           lr_scale=1.0, sum_sq: Optional[Callable] = None
           ) -> Tuple[Tree, Tree, dict]:
    """One step. ``sum_sq``: the gradients' global sum of squares on a
    mesh (``global_norm``), for the clip and the ``grad_norm`` metric.
    Each leaf is clipped, its moments and its param updated in turn (the
    clipped tree is never whole: full fine-tuning's peak memory)."""
    f32 = torch.float32
    scale, gn = _clip_scale(grads, cfg.grad_clip, sum_sq)
    step = state["step"] + 1
    lr = cfg.learning_rate * lr_scale
    decay = lambda p: 1.0 if p.dim() >= 2 else 0.0  # noqa: E731

    if cfg.kind == "adamw":
        s32 = step.to(f32)
        bc1 = 1 - torch.tensor(cfg.b1, dtype=f32, device=s32.device) ** s32
        bc2 = 1 - torch.tensor(cfg.b2, dtype=f32, device=s32.device) ** s32

        def leaf(p, g, m, v):
            g = g.to(f32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * decay(p) * p.to(f32)
            return (p.to(f32) - lr * delta).to(p.dtype), m, v

        new_params, mu, nu = _unzip(tree_map(leaf, params, grads,
                                             state["mu"], state["nu"]), 3)
        return new_params, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gn}

    if cfg.kind == "sgd":
        def leaf(p, g, m):
            m = cfg.momentum * m + g.to(f32) * scale
            delta = m + cfg.weight_decay * decay(p) * p.to(f32)
            return (p.to(f32) - lr * delta).to(p.dtype), m

        new_params, mu = _unzip(tree_map(leaf, params, grads, state["mu"]), 2)
        return new_params, {"mu": mu, "step": step}, {"grad_norm": gn}
    raise ValueError(cfg.kind)

