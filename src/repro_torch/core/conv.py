"""GS orthogonal convolutions (paper §6.3, App. F; port of
``repro/core/conv.py``).

Building blocks
---------------
* ``skew_kernel``       — L = M - ConvTranspose(M): makes the induced conv
                          matrix (eq. 2) skew-symmetric, so its exponential is
                          orthogonal (SOC, Singla & Feizi 2021).
* ``conv_exponential``  — truncated Taylor series of the convolution
                          exponential L *_e X (Definition 6.1), grouped.
* ``ch_shuffle``        — channel permutation; the *paired* variant
                          (App. F) keeps MaxMin pairs together.
* ``maxmin`` / ``maxmin_permuted`` — gradient-norm-preserving activations.
* ``gs_soc_layer``      — Y = GrExpConv2(ChShuffle2(GrExpConv1(ChShuffle1 X))),
                          the GS-SOC layer of eq. (3); the second conv is 1x1.

Layout as in the JAX package: NHWC activations, HWIO kernels
``(kh, kw, c/g, c)``. ``conv2d`` hands ``F.conv2d`` the activations as a
channels-last NCHW view and the kernel as OIHW (``permute(3, 2, 0, 1)``), so
an NHWC-contiguous input stays NHWC-contiguous through the call. The JAX
package runs these convolutions outside any Pallas kernel
(``lax.conv_general_dilated``), and so does the port (``F.conv2d``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .permutations import PermSpec, apply_perm


# ---------------------------------------------------------------------------
# skew-symmetric convolution kernels
# ---------------------------------------------------------------------------

def skew_kernel(m: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """L = M - ConvTranspose(M), per group.

    m: (H, W, c//g, c) HWIO grouped kernel with c_out == c_in == c.
    ConvTranspose(M)[h, w, i, o] = M[H-1-h, W-1-w, o, i]  (within each group).
    """
    H, W, cg, c = m.shape
    if c % groups or cg != c // groups:
        raise ValueError(f"bad grouped kernel shape {tuple(m.shape)} for "
                         f"groups={groups}")
    mg = m.reshape(H, W, cg, groups, cg)              # split O -> (g, o_local)
    mt = torch.flip(mg, dims=(0, 1)).transpose(2, 4)  # spatial flip, i <-> o
    return (mg - mt).reshape(H, W, cg, c)


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           groups: int = 1) -> torch.Tensor:
    """SAME-padded NHWC grouped convolution (stride 1, cross-correlation as
    ``lax.conv_general_dilated``); the result is in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding="same", groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_exponential(x: torch.Tensor, kernel: torch.Tensor, groups: int = 1,
                     terms: int = 6) -> torch.Tensor:
    """L *_e X = X + LX/1! + L^2 X/2! + ...  truncated at ``terms``.

    With a skew kernel the Jacobian is orthogonal up to truncation error.
    """
    acc = x
    term = x
    for t in range(1, terms + 1):
        term = conv2d(term, kernel, groups) / t
        acc = acc + term
    return acc


# ---------------------------------------------------------------------------
# activations (App. F)
# ---------------------------------------------------------------------------

def maxmin(x: torch.Tensor) -> torch.Tensor:
    """Original MaxMin: pairs channel i with channel i + c/2 (Def. F.1)."""
    c = x.shape[-1]
    a, b = x[..., : c // 2], x[..., c // 2:]
    return torch.cat([torch.maximum(a, b), torch.minimum(a, b)], dim=-1)


def maxmin_permuted(x: torch.Tensor) -> torch.Tensor:
    """MaxMinPermuted (Def. F.2): pairs *neighboring* channels (2i, 2i+1), so
    activations never leak information across ChShuffle groups."""
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.stack([torch.maximum(a, b), torch.minimum(a, b)], dim=-1)
    return out.reshape(x.shape)


ACTIVATIONS = {"maxmin": maxmin, "maxmin_permuted": maxmin_permuted,
               "none": lambda x: x}


# ---------------------------------------------------------------------------
# channel shuffle
# ---------------------------------------------------------------------------

def ch_shuffle_spec(channels: int, k: int, paired: bool = True) -> PermSpec:
    """ChShuffle before a k-grouped conv. ``paired`` (App. F) moves channel
    pairs jointly — optimal information transition AND keeps MaxMinPermuted
    pairs intact."""
    if paired and channels % (2 * k) == 0 and channels >= 2 * k:
        return PermSpec.paired(k)
    return PermSpec.gs(k)


def ch_shuffle(x: torch.Tensor, spec: PermSpec) -> torch.Tensor:
    return apply_perm(x, spec, axis=-1)


# ---------------------------------------------------------------------------
# GS-SOC layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GSSOCSpec:
    """One GS-SOC orthogonal convolution layer (paper Table 3 rows).

    groups = (a, b): first grouped exp-conv has ``a`` groups, kernel k1 x k1;
    second has ``b`` groups with kernel 1x1. b = 0 -> single conv (row "(4,-)").
    a == b == 1 with no shuffle reduces to plain SOC.
    """
    channels: int
    groups1: int = 4
    groups2: int = 0
    k1: int = 3
    k2: int = 1
    terms: int = 6
    paired: bool = True

    def param_shapes(self):
        c, g1 = self.channels, self.groups1
        shapes = {"m1": (self.k1, self.k1, c // g1, c)}
        if self.groups2:
            shapes["m2"] = (self.k2, self.k2, c // self.groups2, c)
        return shapes

    @property
    def num_params(self) -> int:
        return sum(int(np.prod(s)) for s in self.param_shapes().values())


def init_gs_soc(spec: GSSOCSpec, gen: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda"):
    """Normal kernels scaled by 1/sqrt(fan-in), drawn from ``gen`` (a
    generator on ``device``) in sorted name order (JAX draws them from
    folded keys: another stream)."""
    device = resolve_device(device)
    params = {}
    for name, shp in sorted(spec.param_shapes().items()):
        scale = 1.0 / math.sqrt(int(np.prod(shp[:3])))
        params[name] = (torch.randn(shp, generator=gen, device=device,
                                    dtype=torch.float32) * scale).to(dtype)
    return params


def gs_soc_layer(spec: GSSOCSpec, params, x: torch.Tensor) -> torch.Tensor:
    """Eq. (3): GrExpConv2(ChShuffle2(GrExpConv1(ChShuffle1(X)))).

    Orthogonal Jacobian (up to Taylor truncation): permutations are
    orthogonal, grouped conv exponentials of skew kernels are orthogonal,
    and compositions of orthogonal maps are orthogonal.
    """
    c = spec.channels
    if spec.groups1 > 1:
        x = ch_shuffle(x, ch_shuffle_spec(c, spec.groups1, spec.paired))
    k1 = skew_kernel(params["m1"], spec.groups1)
    x = conv_exponential(x, k1, spec.groups1, spec.terms)
    if spec.groups2:
        if spec.groups2 > 1:
            x = ch_shuffle(x, ch_shuffle_spec(c, spec.groups2, spec.paired))
        k2 = skew_kernel(params["m2"], spec.groups2)
        x = conv_exponential(x, k2, spec.groups2, spec.terms)
    return x


def soc_layer_spec(channels: int, terms: int = 6) -> GSSOCSpec:
    """Plain SOC baseline = one ungrouped exp conv, no shuffle."""
    return GSSOCSpec(channels=channels, groups1=1, groups2=0, terms=terms,
                     paired=False)


# ---------------------------------------------------------------------------
# utilities for Lipschitz nets
# ---------------------------------------------------------------------------

def space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Invertible (orthogonal) downsampling: (H, W, C) -> (H/2, W/2, 4C)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // factor, w // factor, factor * factor * c)


def power_iteration_sn(w: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Spectral norm estimate of a 2D matrix (for 1-Lipschitz dense heads)."""
    v = torch.ones((w.shape[1],), dtype=w.dtype, device=w.device) \
        / math.sqrt(w.shape[1])
    for _ in range(iters):
        u = w @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
        v = w.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
    return u @ w @ v


def certified_radius(logits: torch.Tensor) -> torch.Tensor:
    """SOC certificate: margin / sqrt(2) for 1-Lipschitz nets."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) / math.sqrt(2.0)
