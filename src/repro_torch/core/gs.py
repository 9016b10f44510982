"""Group-and-Shuffle (GS) matrices, the paper's structured class (port of
``repro/core/gs.py``).

A two-factor GS matrix is

    A = P_L (L P R) P_R                                         (paper eq. 1)

with L = diag(L_1..L_{k_L}), R = diag(R_1..R_{k_R}) block-diagonal and P_L,
P, P_R permutations. GSOFT uses the square layout Q = P^T L P R with
P = P_(r, d), r = d / b, dense iff r <= b (Theorem 2 with m = 2).
Higher-order GS (Definition 5.1) is A = P_{m+1} prod_{i=m..1} (B_i P_i).

Parameters are plain tensors (stacked blocks), layouts hashable dataclasses.
The applications (``gs_apply``, ``gs_apply_T``, ``gs_matmul``,
``gs_factors_apply``) run their block products through
``block_diag_matmul``, which is ``kernels.ops.bdmm``: on the card the bdmm
kernel, square or rectangular blocks alike. The materializations and the
structure tools (Proposition 1, Theorem 2) are plain torch / numpy for
tests and analysis, as the JAX package's are numpy: ``materialize_*`` and
``lowrank_blocks`` return tensors on their input's device (numpy inputs
become CPU tensors), ``block_ranks`` and ``support_pattern`` numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops

from .permutations import PermSpec, apply_perm, inverse_sigma

ArrayLike = Union[torch.Tensor, np.ndarray]


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockDiagSpec:
    """diag(B_1..B_k) with every block of shape (rows, cols)."""
    num_blocks: int
    rows: int
    cols: int

    @property
    def in_dim(self) -> int:
        return self.num_blocks * self.cols

    @property
    def out_dim(self) -> int:
        return self.num_blocks * self.rows

    @property
    def param_shape(self) -> Tuple[int, int, int]:
        return (self.num_blocks, self.rows, self.cols)

    @property
    def num_params(self) -> int:
        return self.num_blocks * self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class GSLayout:
    """Two-factor layout A = P_L (L P R) P_R (sizes per Definition 3.1)."""
    lspec: BlockDiagSpec
    rspec: BlockDiagSpec
    perm_left: PermSpec
    perm_mid: PermSpec
    perm_right: PermSpec

    def __post_init__(self):
        if self.lspec.in_dim != self.rspec.out_dim:
            raise ValueError(
                f"inner dims disagree: L takes {self.lspec.in_dim}, "
                f"R produces {self.rspec.out_dim}")

    @property
    def in_dim(self) -> int:
        return self.rspec.in_dim

    @property
    def out_dim(self) -> int:
        return self.lspec.out_dim

    @property
    def inner_dim(self) -> int:
        return self.rspec.out_dim

    @property
    def num_params(self) -> int:
        return self.lspec.num_params + self.rspec.num_params


def gsoft_layout(d: int, block_size: int) -> GSLayout:
    """The layout used by GSOFT: Q = P^T L P R with square b x b blocks,
    P = P_(r, d), r = d / b."""
    if d % block_size != 0:
        raise ValueError(f"block size {block_size} must divide d={d}")
    r = d // block_size
    spec = BlockDiagSpec(r, block_size, block_size)
    return GSLayout(lspec=spec, rspec=spec,
                    perm_left=PermSpec.gs_inv(r),     # P^T = P^{-1}
                    perm_mid=PermSpec.gs(r),
                    perm_right=PermSpec.identity())


def pick_block_size(d: int, target_b: int) -> int:
    """Largest divisor b of d with b <= target_b and d/b <= b when possible.

    Guarantees the m=2 GSOFT density condition (r <= b) whenever any divisor
    satisfies it; otherwise returns the largest divisor <= target_b.
    """
    divs = [b for b in range(1, d + 1) if d % b == 0]
    ok = [b for b in divs if b <= target_b and d // b <= b]
    if ok:
        return max(ok)
    le = [b for b in divs if b <= target_b]
    return max(le) if le else min(divs)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_blocks(spec: BlockDiagSpec,
                rng: Optional[np.random.Generator] = None,
                scale: float = 0.02, identity: bool = False,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """Stacked block tensor of shape (k, rows, cols), drawn from the numpy
    ``rng`` (default ``default_rng(0)``) exactly as the JAX package draws
    it."""
    dev = resolve_device(device)
    if identity:
        if spec.rows != spec.cols:
            raise ValueError("identity init needs square blocks")
        return torch.eye(spec.rows, dtype=dtype, device=dev).expand(
            spec.param_shape).clone()
    rng = rng or np.random.default_rng(0)
    w = rng.normal(0.0, scale, size=spec.param_shape)
    return torch.as_tensor(w, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# application (through the bdmm kernel on the card)
# ---------------------------------------------------------------------------

def block_diag_matmul(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = diag(B_1..B_k) x along the last axis of x.

    blocks: (k, rows, cols); x: (..., k*cols) -> (..., k*rows). The op the
    bdmm kernel implements: on the card it runs ``kernels.ops.bdmm`` (the
    ``bdmm`` kernel forward, ``bdmm_dblocks`` and, for an input that needs
    a gradient, ``bdmm`` backward), as the JAX package's ``bdmm_diff`` rule
    pairs the two Pallas kernels."""
    return kernel_ops.bdmm(blocks, x)


def gs_apply(layout: GSLayout, L: torch.Tensor, R: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A x with A = P_L (L P R) P_R, x: (..., in_dim)."""
    y = apply_perm(x, layout.perm_right)
    y = block_diag_matmul(R, y)
    y = apply_perm(y, layout.perm_mid)
    y = block_diag_matmul(L, y)
    return apply_perm(y, layout.perm_left)


def gs_apply_T(layout: GSLayout, L: torch.Tensor, R: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A^T x (the transpose application), x: (..., out_dim)."""
    y = apply_perm(x, layout.perm_left.inverse())
    y = block_diag_matmul(L.transpose(-1, -2), y)
    y = apply_perm(y, layout.perm_mid.inverse())
    y = block_diag_matmul(R.transpose(-1, -2), y)
    return apply_perm(y, layout.perm_right.inverse())


def gs_matmul(layout: GSLayout, L: torch.Tensor, R: torch.Tensor,
              W: torch.Tensor) -> torch.Tensor:
    """A @ W for W of shape (in_dim, n): A applied to every column of W
    (the columns are the block products' tokens)."""
    return gs_apply(layout, L, R, W.transpose(-1, -2)).transpose(-1, -2)


# ---------------------------------------------------------------------------
# materialization & structure (tests / analysis)
# ---------------------------------------------------------------------------

def _tensor(a: ArrayLike) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _index(sigma: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.int64, device=device)


def materialize_block_diag(blocks: ArrayLike) -> torch.Tensor:
    """Dense diag(B_1..B_k) of (k, rows, cols) blocks."""
    blocks = _tensor(blocks)
    k, r, c = blocks.shape
    out = torch.zeros((k, r, k, c), dtype=blocks.dtype, device=blocks.device)
    i = torch.arange(k, device=blocks.device)
    out[i, :, i, :] = blocks
    return out.reshape(k * r, k * c)


def _block_rows(blocks: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """diag(blocks) @ m in plain torch: m (k*cols, n) -> (k*rows, n)."""
    k, r, c = blocks.shape
    return torch.einsum("gij,gjn->gin", blocks,
                        m.reshape(k, c, m.shape[-1])).reshape(k * r, -1)


def gs_materialize(layout: GSLayout, L: ArrayLike,
                   R: ArrayLike) -> torch.Tensor:
    """Dense A = P_L L P R P_R (out_dim, in_dim), in L's dtype on L's
    device: the permutations as index gathers ((P M)[i] = M[sigma(i)],
    (M P)[:, j] = M[:, sigma^-1(j)]), the block factors as batched
    products."""
    L, R = _tensor(L), _tensor(R)
    dev = L.device
    R = R.to(device=dev, dtype=L.dtype)
    m = materialize_block_diag(R)[
        :, _index(inverse_sigma(layout.perm_right.sigma(layout.in_dim)), dev)]
    m = m[_index(layout.perm_mid.sigma(layout.inner_dim), dev)]
    m = _block_rows(L, m)
    return m[_index(layout.perm_left.sigma(layout.out_dim), dev)]


def block_ranks(layout: GSLayout) -> np.ndarray:
    """Rank bound r_{k1,k2} of block (k1, k2) of P_L^T A P_R^T, from P alone
    (Proposition 1). With the gather convention (Px)[j] = x[sigma(j)], the
    L column j pairs with the R row sigma(j)."""
    bL, bR = layout.lspec.cols, layout.rspec.rows
    kL, kR = layout.lspec.num_blocks, layout.rspec.num_blocks
    sigma = layout.perm_mid.sigma(layout.inner_dim)
    ranks = np.zeros((kL, kR), dtype=np.int64)
    j = np.arange(layout.inner_dim)
    np.add.at(ranks, (j // bL, sigma // bR), 1)
    return ranks


def lowrank_blocks(layout: GSLayout, L: ArrayLike,
                   R: ArrayLike) -> torch.Tensor:
    """The middle factor L P R as Proposition 1's sum of outer products,
    built block by block (tests hold it against ``gs_materialize``)."""
    L, R = _tensor(L), _tensor(R)
    R = R.to(device=L.device, dtype=torch.promote_types(L.dtype, R.dtype))
    L = L.to(R.dtype)
    kL, bL1, bL2 = L.shape
    kR, bR1, bR2 = R.shape
    sigma = layout.perm_mid.sigma(layout.inner_dim)
    out = torch.zeros((kL * bL1, kR * bR2), dtype=L.dtype, device=L.device)
    for j in range(layout.inner_dim):
        i = int(sigma[j])
        k1, k2 = j // bL2, i // bR1
        col = L[k1][:, j % bL2]                  # u_j
        row = R[k2][i % bR1, :]                  # v_{sigma(j)}^T
        out[k1 * bL1:(k1 + 1) * bL1, k2 * bR2:(k2 + 1) * bR2] += torch.outer(
            col, row)
    return out


# ---------------------------------------------------------------------------
# higher-order GS (Definition 5.1) + Theorem 2 density tools
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GSFactors:
    """A = P_{m+1} * prod_{i=m..1} (B_i P_i), factors in application order
    (P_1 first): specs[i] / perms[i] are (B_{i+1}, P_{i+1})."""
    specs: Tuple[BlockDiagSpec, ...]
    perms: Tuple[PermSpec, ...]        # len = m + 1 (last = P_{m+1})

    def __post_init__(self):
        if len(self.perms) != len(self.specs) + 1:
            raise ValueError("need m block specs and m+1 permutations")
        for a, b in zip(self.specs[:-1], self.specs[1:]):
            if a.out_dim != b.in_dim:
                raise ValueError("factor dims must chain")

    @property
    def in_dim(self) -> int:
        return self.specs[0].in_dim

    @property
    def out_dim(self) -> int:
        return self.specs[-1].out_dim

    @property
    def num_params(self) -> int:
        return sum(s.num_params for s in self.specs)


def gs_order_layout(d: int, block_size: int, m: int) -> GSFactors:
    """m-factor square GS layout with P_(r, d) shuffles between factors."""
    if d % block_size:
        raise ValueError("block must divide d")
    r = d // block_size
    spec = BlockDiagSpec(r, block_size, block_size)
    perms = ([PermSpec.identity()] + [PermSpec.gs(r)] * (m - 1)
             + [PermSpec.identity()])
    return GSFactors(specs=(spec,) * m, perms=tuple(perms))


def gs_factors_apply(factors: GSFactors, blocks: Sequence[torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    y = x
    for i in range(len(factors.specs)):
        y = apply_perm(y, factors.perms[i])
        y = block_diag_matmul(blocks[i], y)
    return apply_perm(y, factors.perms[-1])


def gs_factors_materialize(factors: GSFactors,
                           blocks: Sequence[ArrayLike]) -> torch.Tensor:
    """Dense A of a higher-order layout, in the first factor's dtype and
    device."""
    first = _tensor(blocks[0])
    dev = first.device
    out = torch.eye(factors.in_dim, dtype=first.dtype, device=dev)[
        _index(factors.perms[0].sigma(factors.in_dim), dev)]
    for i in range(len(factors.specs)):
        out = _block_rows(_tensor(blocks[i]).to(device=dev,
                                                dtype=first.dtype), out)
        out = out[_index(factors.perms[i + 1].sigma(out.shape[0]), dev)]
    return out


def min_factors_dense(block_size: int, num_blocks: int) -> int:
    """Theorem 2: m = 1 + ceil(log_b r) (vs 1 + ceil(log2 r) for
    butterfly)."""
    if num_blocks <= 1:
        return 1
    if block_size <= 1:
        raise ValueError("b = 1 can never densify")
    return 1 + math.ceil(math.log(num_blocks, block_size) - 1e-12)


def support_pattern(factors: GSFactors) -> np.ndarray:
    """Boolean reachability pattern of the class (True where entries can be
    nonzero)."""
    ones = [torch.ones(s.param_shape, dtype=torch.float64)
            for s in factors.specs]
    return (gs_factors_materialize(factors, ones) > 0).numpy()


def is_dense_class(factors: GSFactors) -> bool:
    return bool(np.all(support_pattern(factors)))
