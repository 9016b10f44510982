"""The forward GS rotation's launch plan on the CPU (``kernels/gs_fused.py``
``fwd_plan``, ``tile_windows`` over the backward's ``tc_table``), against
the JAX package.

Route 1 (``csrc/gs_fused.cu`` ``gs_fused_tc_kernel``) runs one CTA per tile
of output groups: a plain-torch emulation of its per-CTA work (the window
staging, U = X R^T per window group, the bf16 hi + lo intermediate, Z = V
L^T, the write-back of y = P^T z) must equal the plain version and JAX's
Pallas kernel, and every position of y must be written by exactly one
(CTA, slot). Inputs come from numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gs_fused as jgs  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402

B = gk.TC_BLOCK
SMS = 132
SMEM_LIMIT = 232448
# f32 sums in another order than the plain version's einsums, and v kept as
# bf16 hi + lo (2^-18 relative each) where the plain version keeps fp32
F32_REL = 1e-5


def _fwd_smem(maxw: int, simple: bool) -> int:
    """Bytes of shared memory of gs_fused_tc_kernel (its Layout)."""
    xp = maxw * B * 2 + 16
    stages = 3 if simple else 2
    slots = 4 * gk.TC_SLOTS
    return (stages * gk.TC_TOKENS * xp + 2 * slots * (B * 32 + 16)
            + slots * gk.TC_TOKENS * B * 2 + slots // 8 * 16 + 64
            + 4 * gk.TC_TAB * 4 + slots * 16)


def _tile_slots(r: int, k: int) -> list:
    """(q, g, s0 - w0) of tile k's slots, in the kernel's order (entry,
    then slot); an empty slot is left out."""
    table, _, parts, _, _ = gk._tc_geometry(r)
    w0 = gk.tile_windows(r)[k][0]
    out = []
    for e in table[k * parts:(k + 1) * parts]:
        for s in range(gk.TC_SLOTS):
            q, g, delta = (int(v) for v in e[8 + 4 * s:11 + 4 * s])
            if q >= 0:
                out.append((q, g, int(e[0]) - w0 + delta))
    return out


def _writes(r: int, k: int) -> list:
    """The kernel's write-back of tile k, b not dividing r or not: lane f
    of window group mm writes y feature f of its source group when the slot
    of q = f (q = f - 1 past the wrap) owns that position. Returns
    [(y index, slot, position)]."""
    w0, width = gk.tile_windows(r)[k]
    by_q = {q: (sl, delta) for sl, (q, _, delta) in enumerate(_tile_slots(r, k))}
    out = []
    for mm in range(width):
        mv = w0 + mm
        wrapped = mv >= r
        for f in range(B):
            sl, delta = by_q.get(f - 1 if wrapped else f, (None, 0))
            if sl is not None and 0 <= mm - delta < B:
                out.append(((mv - r if wrapped else mv) * B + f, sl, mm - delta))
    return out


ROUTE_CASES = [(1, 29568, 256, 32, "bf16", "tc"), (1, 8192, 924, 32, "bf16", "tc"),
               (1, 8192, 256, 32, "bf16", "tc"), (1, 1024, 256, 32, "bf16", "tc"),
               (1, 8192, 32, 32, "bf16", "tc"), (3, 5, 33, 32, "bf16", "tc"),
               (1, 1, 1056, 32, "bf16", "tc"), (1, 29568, 256, 32, "f32", "cc"),
               (1, 29568, 64, 128, "bf16", "cc"), (1, 300, 16, 32, "bf16", "cc"),
               (2, 7, 6, 4, "bf16", "cc"), (1, 40, 8, 128, "f32", "cc")]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "B%d-T%d-r%d-b%d-%s-%s" % c)
def test_fwd_plan_picks_the_route(case):
    bsz, t, r, b, dt, route = case
    plan = gk.fwd_plan(bsz, t, r, b, dt, SMS)
    assert plan.route == route
    if route == "cc":
        # route 2: the fp32 tile kernel, whole rows of at most MAX_TILE_ELEMS
        assert plan.tokens in (1, 2, 4, 8)
        return
    assert plan.tiles == -(-r // B)
    assert plan.tokens % gk.TC_TOKENS == 0
    assert (plan.splits - 1) * plan.tokens < t <= plan.splits * plan.tokens
    # one CTA an SM: the splits fill at most one wave when they can
    assert plan.tiles * bsz * plan.splits <= max(SMS, plan.tiles * bsz)
    if (bsz, t, r) == (1, 29568, 256):
        assert (plan.tiles, plan.splits, plan.window) == (8, 16, 32)


def test_fwd_plan_is_within_the_kernel_limits_for_every_r():
    """Route 1 takes any r >= 32 (d = 32 r, past the fp32 tile's 32768):
    every tile's window fits what the kernel stages, every plan entry's
    window fits a stage-(a) unit stride of 40, and when b | r each tile is a
    super-block whose slot s is q = s (the 16-byte write-back's layout)."""
    for r in range(32, 1101):
        wins = gk.tile_windows(r)
        _, tiles, parts, maxw, _ = gk._tc_geometry(r)
        assert len(wins) == tiles == -(-r // B) and parts == 4
        assert maxw < 40
        window = max(w for _, w in wins)
        assert window <= gk.FWD_MAX_WINDOW
        simple = r % B == 0
        assert _fwd_smem(window, simple) <= SMEM_LIMIT
        for k, (w0, width) in enumerate(wins):
            assert 0 <= w0 < r and 0 < width <= window
            slots = _tile_slots(r, k)
            assert len({q for q, _, _ in slots}) == len(slots)
            assert all(0 <= delta and delta + B <= width for _, _, delta in slots)
            if simple:
                assert (w0, width) == (k * B, B)
                assert slots == [(q, q * (r // B) + k, 0) for q in range(B)]
        plan = gk.fwd_plan(1, 8192, r, B, "bf16", SMS)
        assert plan.route == "tc" and plan.window == window


@pytest.mark.parametrize("r", [32, 33, 40, 63, 64, 100, 256, 924, 1040, 1056])
def test_fwd_plan_writes_every_position_of_y_once(r):
    """Each of the d positions of y has exactly one writer (tile, slot,
    position), and it is the one P^T assigns: y[m b + q] = z[q r + m] with
    z[g b + e] the slot's position e."""
    seen = {}
    for k in range(-(-r // B)):
        slots = _tile_slots(r, k)
        for idx, sl, pos in _writes(r, k):
            assert idx not in seen, (idx, seen.get(idx), (k, sl, pos))
            seen[idx] = (k, sl, pos)
            c = slots[sl][1] * B + pos
            assert idx == (c % r) * B + c // r
    assert sorted(seen) == list(range(r * B))


def _orth(rng, r):
    a = rng.normal(0, 0.3, size=(r, B, B))
    k = a - np.swapaxes(a, -1, -2)
    eye = np.eye(B)
    q = np.swapaxes(np.linalg.solve(eye + k, eye - k), -1, -2)
    return np.ascontiguousarray(q, dtype=np.float32)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _emulate(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Route 1's per-CTA work in plain torch, f32, one row."""
    t, d = x.shape
    r = d // B
    X = x.reshape(t, r, B)
    y = torch.full((t, d), float("nan"))
    for k, (w0, width) in enumerate(gk.tile_windows(r)):
        mv = torch.arange(w0, w0 + width)
        m, wrap = mv % r, (mv >= r).long()
        Xw = X[:, m]                                   # the staged window
        slots = _tile_slots(r, k)
        # (a) U^T = X_m R_m'^T for every (window group, slot): row q (+1
        # past the wrap) of R_m
        rows = torch.tensor([q for q, _, _ in slots])[None, :] + wrap[:, None]
        ok = rows < B
        Rw = R[m[:, None], rows.clamp(max=B - 1)] * ok[..., None]   # (W, S, b)
        U = torch.einsum("twj,wsj->tws", Xw, Rw)
        Z = []
        for sl, (q, g, delta) in enumerate(slots):
            v = U[:, delta:delta + B, sl]              # v = P u, (t, b)
            hi = _bf16(v)
            lo = _bf16(v - hi)
            # (c) Z^T = V L_g^T with v as hi + lo
            Z.append(hi @ L[g].T + lo @ L[g].T)
        for idx, sl, pos in _writes(r, k):             # y = P^T z
            assert torch.isnan(y[:, idx]).all()
            y[:, idx] = Z[sl][:, pos]
    assert not torch.isnan(y).any()
    return y


@pytest.mark.parametrize("t", [1, 15, 16, 40])
@pytest.mark.parametrize("r", [32, 33, 40, 63, 256, 924])
def test_fwd_emulation_matches_plain_and_jax(r, t):
    rng = np.random.default_rng(r * 10 + t)
    x = rng.normal(size=(t, r * B)).astype(np.float32)
    L, R = _orth(rng, r), _orth(rng, r)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(L), torch.from_numpy(R))
    plain = gk.gs_fused_plain(torch.from_numpy(x)[None], torch.from_numpy(L)[None],
                              torch.from_numpy(R)[None])[0]
    want = np.asarray(jgs.gs_fused_pallas(jnp.asarray(L), jnp.asarray(R),
                                          jnp.asarray(x), interpret=True))
    for ref in (plain.numpy(), want):
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got.numpy() - ref).max()) <= F32_REL * scale
