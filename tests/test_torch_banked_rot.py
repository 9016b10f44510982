"""The banked serving rotations on the CPU, against the JAX package.

* Route 1 of the transpose rotation (``csrc/gs_fused_T.cu`` ``gs_T_tc``)
  through its launch plan (``kernels/gs_fused.py`` ``t_plan``, ``t_entry``,
  ``t_table``): every y position owned by one entry, every cell of the
  intermediate written by one unit row, the plan within the kernel's
  limits for every r, and a plain-torch emulation of a CTA's work (window
  staging with its wraps, the transpose to XT, the L^T units with the
  intermediate as bf16 hi + lo, the R^T stage) against the plain version
  and JAX's ``gs_fused_T_pallas`` in interpret mode.
* The slot-id entry points (``ops.gs_bank_transform_T``,
  ``ops.gs_q_matmul_bank``) as ``core.adapters.gs_rotate_banked`` and
  ``gsoft_quant_fuse`` use them, against JAX's ``gs_rotate_banked`` and
  ``gsoft_quant_fuse`` + ``ops.gs_q_matmul_banked(use_pallas=True)``, with
  an identity slot 0 and repeated ids, f32 and bf16.
* ``gs_q_matmul``'s product plan (``kernels/q_matmul.py`` ``gsq_plan``).

Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.core import adapters as jad  # noqa: E402
from repro.kernels import gs_fused as jgs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import adapters as tad  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import q_matmul as qmk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

B = gk.TC_BLOCK
SMS = 132
# f32: sums in another order than the plain version's einsums, and the
# intermediate kept as bf16 hi + lo (2^-17 relative) where it keeps fp32
F32_REL = 1e-5
# bf16 rotation: the plain version (as JAX's oracle) rounds the
# intermediate to bf16 where JAX's kernel keeps fp32: one rounding (2^-9
# relative) carried through an orthogonal factor, |y| < 8 here (ulp 2^-5)
BF16_TOL = 2.0 ** -4
# the rotate + int8 matmul in f32: two fp32 sums in another order
GSQ_F32_TOL = 1e-3
# bf16: the rotated slab's bf16 rounding may differ by one ulp before the
# int8 product (the plain version rounds the intermediate, JAX's kernel
# does not), relative to max|y|
GSQ_BF16_REL = 2.0 ** -6


def _orth(rng, lead, r, b=B):
    a = rng.normal(0, 0.3, size=lead + (r, b, b))
    k = a - np.swapaxes(a, -1, -2)
    eye = np.eye(b)
    q = np.swapaxes(np.linalg.solve(eye + k, eye - k), -1, -2)
    return np.ascontiguousarray(q, dtype=np.float32)


# ---------------------------------------------------------------------------
# route 1's plan
# ---------------------------------------------------------------------------

# (B, T, r, route, ng, tokens per tile): decode rows (entries of 8 groups at
# d = 8192; 32 at the MLP width and past 32768, where 32-group entries
# already fill the SMs), prefill buckets, the dx slab, Double GSOFT's output
# sides (r = b; b not dividing r at T = 8192); f32, b != 32 and r < b take
# route 2
T_ROUTE_CASES = [(4, 1, 256, "tc", 8, 16), (1, 16, 256, "tc", 8, 16),
                 (1, 128, 256, "tc", 16, 16), (1, 29568, 256, "tc", 32, 16),
                 (4, 1, 924, "tc", 32, 8), (1, 16, 924, "tc", 16, 8),
                 (1, 8192, 924, "tc", 32, 8), (1, 8192, 32, "tc", 32, 16),
                 (4, 1, 1056, "tc", 32, 16), (1, 64, 1040, "tc", 32, 8)]


@pytest.mark.parametrize("case", T_ROUTE_CASES,
                         ids=lambda c: "B%d-T%d-r%d-%s" % c[:4])
def test_t_plan_picks_the_route_and_spreads_short_t(case):
    bsz, t, r, route, ng, tt = case
    plan = gk.t_plan(bsz, t, r, B, "bf16", SMS)
    assert (plan.route, plan.ng, plan.tt) == (route, ng, tt)
    assert plan.entries == -(-r // ng)
    assert plan.tokens % plan.tt == 0
    assert (plan.splits - 1) * plan.tokens < t <= plan.splits * plan.tokens
    # one CTA an SM: the splits fill at most one wave when they can
    assert plan.entries * bsz * plan.splits <= max(SMS, plan.entries * bsz)
    assert gk.t_smem(plan.tt, plan.window, plan.ng, 2) <= gk.SMEM_LIMIT
    assert (plan.lu, plan.ru) in gk.T_UNITS[plan.tt]
    assert gk.t_table(r, plan.ng)[2] <= gk.T_WARPS * plan.lu
    assert 2 * plan.ng <= gk.T_WARPS * plan.ru
    for dt, b, rr in (("f32", 32, r), ("bf16", 128, r), ("bf16", 32, 16)):
        assert gk.t_plan(bsz, t, rr, b, dt, SMS).route == "cc"


def _entries(r, ng):
    out = []
    for g0 in range(0, r, ng):
        n = min(ng, r - g0)
        units, wstart, width = gk.t_entry(r, g0, n)
        out.append((g0, n, units, wstart, width))
    return out


def test_t_plan_is_within_the_kernel_limits_for_every_r():
    """Route 1 takes any r >= 32 (d = 32 r, past the fp32 tile's 32768):
    at every entry size the units fit the warps' registers, the windows
    what the kernel stages, the shared memory the card, each unit reads 32
    positions inside its window, and the table holds what ``t_entry``
    says."""
    for r in range(32, 1101):
        for ng in (8, 16, 32):
            table, maxw, maxu = gk.t_table(r, ng)
            tt = 16 if r % B == 0 else 8
            assert maxw <= gk.T_MAX_WINDOW
            # a kernel instantiation holds every entry's units
            assert any(maxu <= gk.T_WARPS * lu and 2 * ng <= gk.T_WARPS * ru
                       for lu, ru in gk.T_UNITS[tt])
            assert gk.t_smem(tt, maxw, ng, 2) <= gk.SMEM_LIMIT
            for row, (g0, n, units, wstart, width) in zip(table,
                                                         _entries(r, ng)):
                assert len(units) <= gk.T_WARPS * gk.T_MAX_LU
                assert 2 * n <= gk.T_WARPS * gk.T_MAX_RU
                assert list(row[:5]) == [g0, n, wstart, width, len(units)]
                for (i, beta, mu, elo, ehi), code in zip(units, row[8:]):
                    assert code == i | beta << 5 | mu << 6 | elo << 8 | ehi << 16
                    oi = (i * r + g0) % B
                    base = g0 - oi + B * beta - wstart
                    assert 0 <= base and base + B <= width
                if r % B == 0:      # a closed super-block: one block a row
                    assert width == B and all(u[1] == 0 for u in units)


@pytest.mark.parametrize("r", [32, 33, 40, 63, 64, 100, 256, 924, 1040, 1056])
@pytest.mark.parametrize("ng", [8, 16, 32])
def test_t_plan_owns_every_output_and_intermediate_once(r, ng):
    """The entries cover the r output groups once (so every y position has
    one writer), and in each entry every cell (output group gl, row i) of
    the intermediate V has exactly one writer (unit, fragment row e'), the
    one P^T assigns: m_g[i] = z at s-position i r + g."""
    owned = []
    for g0, n, units, wstart, width in _entries(r, ng):
        owned += range(g0, g0 + n)
        seen = {}
        for u, (i, beta, mu, elo, ehi) in enumerate(units):
            oi = (i * r + g0) % B
            G = (i * r + g0) // B + beta
            for ep in range(16 * mu, 16 * mu + 16):
                gl = ep + B * beta - oi
                if elo <= ep < ehi and 0 <= gl < n:
                    assert (gl, i) not in seen
                    seen[(gl, i)] = u
                    assert G * B + ep == i * r + g0 + gl
        assert sorted(seen) == [(gl, i) for gl in range(n) for i in range(B)]
    assert owned == list(range(r))


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _emulate(x: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
             ng: int) -> torch.Tensor:
    """Route 1's per-CTA work in plain torch, f32, one row: each entry
    stages its window (natural groups wstart .. taken mod r), transposes it
    to XT[i][u] = S[u][i + wrap(u)], runs its units (L^T over positions
    base .. base + 31 of XT row i, z as hi + lo into V[gl][i]) and the R^T
    stage, and writes its own run of y."""
    t, d = x.shape
    r = d // B
    X = x.reshape(t, r, B)
    y = torch.full((t, d), float("nan"))
    for g0, n, units, wstart, width in _entries(r, ng):
        us = torch.arange(wstart, wstart + width)
        S = X[:, us % r]                                # (t, W, 32)
        wrap = torch.div(us, r, rounding_mode="floor")
        XT = torch.full((B, width, t), float("nan"))
        for u in range(width):
            for f in range(B):
                i = f - int(wrap[u])
                if 0 <= i < B:
                    XT[i, u] = S[:, u, f]
        Vhi = torch.full((n, B, t), float("nan"))
        Vlo = torch.full((n, B, t), float("nan"))
        for i, beta, mu, elo, ehi in units:
            oi = (i * r + g0) % B
            G = (i * r + g0) // B + beta
            base = g0 - oi + B * beta - wstart
            A = L[G].T.clone()                          # A[e'][e] = L_G[e][e']
            keep = torch.zeros(B, dtype=torch.bool)
            keep[max(elo, 16 * mu):min(ehi, 16 * mu + 16)] = True
            A[~keep] = 0
            D = A[16 * mu:16 * mu + 16] @ XT[i, base:base + B]   # (16, t)
            hi = _bf16(D)
            lo = _bf16(D - hi)
            for m in range(16):
                ep = 16 * mu + m
                gl = ep + B * beta - oi
                if keep[ep] and 0 <= gl < n:
                    assert torch.isnan(Vhi[gl, i]).all()
                    Vhi[gl, i], Vlo[gl, i] = hi[m], lo[m]
        assert not torch.isnan(Vhi).any()
        for gl in range(n):
            Rg = R[g0 + gl]                             # A[f][i] = R_g[i][f]
            out = Rg.T @ Vhi[gl] + Rg.T @ Vlo[gl]       # (32, t)
            y[:, (g0 + gl) * B:(g0 + gl + 1) * B] = out.T
    assert not torch.isnan(y).any()
    return y


@pytest.mark.parametrize("t", [1, 9, 16])
@pytest.mark.parametrize("r,ng", [(32, 32), (33, 32), (40, 16), (63, 8),
                                  (64, 8), (100, 32), (256, 16), (924, 32)])
def test_t_emulation_matches_plain_and_jax(r, ng, t):
    rng = np.random.default_rng(r * 10 + t + ng)
    x = rng.normal(size=(t, r * B)).astype(np.float32)
    L, R = _orth(rng, (), r), _orth(rng, (), r)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(L),
                   torch.from_numpy(R), ng)
    plain = ref.gs_fused_T_ref(torch.from_numpy(L), torch.from_numpy(R),
                               torch.from_numpy(x))
    want = np.asarray(jgs.gs_fused_T_pallas(jnp.asarray(L), jnp.asarray(R),
                                            jnp.asarray(x), interpret=True))
    for other in (plain.numpy(), want):
        scale = max(1.0, float(np.abs(other).max()))
        assert float(np.abs(got.numpy() - other).max()) <= F32_REL * scale


# ---------------------------------------------------------------------------
# the slot-id entry points against JAX
# ---------------------------------------------------------------------------

SLOTS = 4
IDS = [2, 0, 2, 3]         # slot 0 (the identity) and a repeated slot


def _bank(rng, r, b):
    """A gsoft_bank_build-like entry: fp32 (A, r, b, b) orthogonal blocks,
    slot 0 the identity."""
    L, R = _orth(rng, (SLOTS,), r, b), _orth(rng, (SLOTS,), r, b)
    L[0] = R[0] = np.eye(b, dtype=np.float32)
    return L, R


@pytest.mark.parametrize("r,b", [(4, 8), (8, 4), (6, 32), (33, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gs_rotate_banked_reads_the_bank_by_slot_id(r, b, dtype):
    """``core.adapters.gs_rotate_banked`` (the port: ``ops.gs_bank_transform_T``
    on the bank and the ids) against JAX's gather, cast and vmapped Pallas
    kernel; the identity slot gives x back bit for bit."""
    rng = np.random.default_rng(r * 7 + b)
    L, R = _bank(rng, r, b)
    x = rng.normal(size=(len(IDS), 3, r * b)).astype(np.float32)
    x[2] = x[0]                # rows 0 and 2: one slot, one input
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jx = jnp.asarray(x, jdt)
    want = jad.gs_rotate_banked({"L": jnp.asarray(L), "R": jnp.asarray(R)},
                                jnp.asarray(IDS, jnp.int32), jx,
                                use_pallas=True)
    tx = torch.from_numpy(x).to(tdt)
    ids = torch.tensor(IDS, dtype=torch.int64)
    entry = {"L": torch.from_numpy(L), "R": torch.from_numpy(R)}
    got = tad.gs_rotate_banked(entry, ids, tx)
    assert got.dtype == tdt and got.shape == tx.shape
    tol = F32_REL * 10 if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)
    assert torch.equal(got[1], tx[1])                  # slot 0: identity
    assert torch.equal(got[0], got[2])                 # one slot, one rotation
    again = tops.gs_bank_transform_T(entry["L"], entry["R"], ids, tx)
    assert torch.equal(again, got)


@pytest.mark.parametrize("r,b,n", [(4, 8, 40), (8, 4, 64), (6, 32, 48)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gsoft_quant_fuse_hands_the_bank_to_the_fused_kernel(r, b, n, dtype):
    """``gsoft_quant_fuse`` + ``ops.gs_q_matmul_bank`` (the port's int8
    hand-off: the bank and the slot ids) against JAX's ``gsoft_quant_fuse``
    (gathered blocks cast to x's dtype) + ``gs_q_matmul_banked`` with the
    Pallas kernel in interpret mode, on identical codes."""
    rng = np.random.default_rng(r * 11 + b + n)
    L, R = _bank(rng, r, b)
    x = rng.normal(size=(len(IDS), 2, r * b)).astype(np.float32) / np.sqrt(r * b)
    x[2] = x[0]
    w = rng.normal(size=(r * b, n)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=-1)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jx = jnp.asarray(x, jdt)
    jL, jR = jad.gsoft_quant_fuse({"L": jnp.asarray(L), "R": jnp.asarray(R)},
                                  jnp.asarray(IDS, jnp.int32), jdt)
    want = np.asarray(jops.gs_q_matmul_banked(jL, jR, jx, jq, js,
                                              use_pallas=True), np.float32)
    ids = torch.tensor(IDS, dtype=torch.int64)
    handoff = tad.gsoft_quant_fuse({"L": torch.from_numpy(L),
                                    "R": torch.from_numpy(R)}, ids, tdt)
    assert handoff[2] is ids and handoff[0].dtype == torch.float32
    got = tops.gs_q_matmul_bank(*handoff, torch.from_numpy(x).to(tdt),
                                torch.from_numpy(np.array(jq)),
                                torch.from_numpy(np.array(js)))
    assert got.dtype == tdt and got.shape == (len(IDS), 2, n)
    err = float(np.abs(got.float().numpy() - want).max())
    if dtype == "f32":
        assert err <= GSQ_F32_TOL
    else:
        assert err <= GSQ_BF16_REL * max(1.0, float(np.abs(want).max()))
    assert torch.equal(got[0], got[2])


def test_bank_entries_check_their_arguments():
    x = torch.zeros((2, 3, 64))
    L = torch.zeros((4, 8, 8, 8))
    ids = torch.tensor([0, 1])
    with pytest.raises(TypeError, match="int64"):
        gk.gs_fused_T_bank(x, L, L, ids.int())
    with pytest.raises(ValueError, match=r"\(B,\)"):
        gk.gs_fused_T_bank(x, L, L, torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match="d = r \\* b"):
        gk.gs_fused_T_bank(torch.zeros((2, 3, 60)), L, L, ids)
    with pytest.raises(TypeError, match="fp32 or x's dtype"):
        gk.gs_fused_T_bank(x, L.double(), L.double(), ids)
    q = torch.zeros((64, 8), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="inference only"):
        qmk.gs_q_matmul_bank(x, L.requires_grad_(), L, ids, q, 1.0)


def test_bank_entries_on_cpu_count_no_launch():
    rng = np.random.default_rng(3)
    L, R = (torch.from_numpy(a) for a in _bank(rng, 4, 8))
    x = torch.from_numpy(rng.normal(size=(4, 2, 32)).astype(np.float32))
    ids = torch.tensor(IDS, dtype=torch.int64)
    q = torch.from_numpy(rng.integers(-127, 128, size=(32, 16)).astype(np.int8))
    before = (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches,
              qmk.gs_q_matmul.launches, qmk.gs_q_matmul.slot_launches)
    assert torch.equal(gk.gs_fused_T_bank(x, L, R, ids),
                       gk.gs_fused_T_bank_plain(x, L, R, ids))
    assert torch.equal(qmk.gs_q_matmul_bank(x, L, R, ids, q, 0.5),
                       qmk.gs_q_matmul_bank_plain(x, L, R, ids, q, 0.5))
    assert (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches,
            qmk.gs_q_matmul.launches, qmk.gs_q_matmul.slot_launches) == before


# ---------------------------------------------------------------------------
# gs_q_matmul's product plan
# ---------------------------------------------------------------------------

# (M, K, N, tokens a tile, columns a CTA, K splits): decode rows of every
# qwen2-72b projection (wq, wk / wv, wi / wg, MLP wo), a prefill chunk, a
# contiguous prefill bucket, tiny shapes
GSQ_PLAN_CASES = [(4, 8192, 8192, 8, 128, 8), (4, 8192, 1024, 8, 32, 8),
                  (4, 8192, 29568, 8, 128, 8), (4, 29568, 8192, 8, 128, 8),
                  (16, 8192, 8192, 16, 64, 8), (128, 8192, 8192, 16, 64, 8),
                  (16, 8192, 1024, 16, 32, 8), (6, 24, 40, 8, 32, 1),
                  (5, 48, 24, 8, 32, 1), (4, 1536, 256, 8, 32, 2)]


@pytest.mark.parametrize("case", GSQ_PLAN_CASES,
                         ids=lambda c: "M%d-K%d-N%d" % c[:3])
def test_gsq_plan_gives_every_sm_codes_within_the_kernel_limits(case):
    m, k, n, ntok, nt, splits = case
    got = qmk.gsq_plan(m, k, n, SMS)
    assert got[:3] == (ntok, nt, splits)
    per = got[3]
    assert per % qmk.GSQ_KT == 0 and got[2] <= qmk.GSQ_MAX_SPLITS
    assert (got[2] - 1) * per < k <= got[2] * per
    assert got[2] == 1 or per >= qmk.GSQ_SPLIT_MIN_ROWS - qmk.GSQ_KT
    ctas = -(-n // nt) * -(-m // ntok) * got[2]
    assert ctas >= min(2 * SMS, -(-n // 32) * -(-m // ntok) * got[2])
