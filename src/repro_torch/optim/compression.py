"""int8 error-feedback gradient compression for the data-parallel mean
(port of ``repro/optim/compression.py``).

Each leaf is quantized to int8 with one fp32 scale after adding the error
buffer (the quantizer's accumulated error, kept in fp32 and added back
before the next quantization, which restores convergence for the biased
compressor); ``compressed_psum_mean`` then all-gathers the int8 codes and
the scales over the mesh axes and every rank takes the mean of the
dequantized parts: a quarter of the bytes of an fp32 all-reduce on the
wire. A library function, as in the JAX package: no train step calls it.
The codec is ``quant.core``'s (the serving weights' int8), so the codes
equal JAX's bit for bit.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.quant.core import dequantize_int8, quantize_int8

Tree = Any


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ef_compress(grads: Tree, err: Tree) -> Tuple[Tree, Tree, Tree]:
    """Error-feedback quantization -> (int8 code tree, fp32 scale tree,
    new error tree), leaf by leaf: corrected = g + e, (q, s) its per-tensor
    int8 codes, new e = corrected - q s."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    out = _map(one, grads, err)
    pick = lambda i: _map(lambda t: t[i], out) if isinstance(out, dict) \
        else out[i]  # noqa: E731
    return pick(0), pick(1), pick(2)


def init_error_buffer(grads_like: Tree) -> Tree:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_like)


def compressed_psum_mean(tree: Tree, err: Tree, mesh,
                         axes: Sequence[str] = ("data",)):
    """Mean of ``tree`` over the mesh ``axes`` with int8 compression ->
    (mean tree fp32, new error buffer). Each rank holds its own
    contribution in every leaf (a replicated gradient before its mean);
    every rank of the mesh must call it."""
    from repro_torch.distrib.tp import Comm
    q, s, new_e = ef_compress(tree, err)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    comms = [Comm(mesh.get_group(a), sizes[a], mesh.get_local_rank(a))
             for a in axes]

    def reduce_leaf(qq, ss):
        allq, alls = qq, ss
        for c in comms:                      # each gather prepends a dim
            allq, alls = c.all_gather(allq[None], 0), c.all_gather(alls[None], 0)
        lead = len(axes)
        deq = allq.to(torch.float32) * alls.reshape(alls.shape
                                                    + (1,) * qq.dim())
        return deq.mean(dim=tuple(range(lead)))

    return _map(reduce_leaf, q, s), new_e
