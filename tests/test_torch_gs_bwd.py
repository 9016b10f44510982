"""The GS backward's launch plan on the CPU (``kernels/gs_fused.py``
``tile_groups``, ``tc_table``, ``bwd_plan``), and the autograd rules that
pick the grads-only kernel for a frozen weight, against the JAX package.

The plan is what the tensor-core kernel (``csrc/gs_fused_bwd.cu``
``gs_grads_tc_kernel``) walks: a plain-torch emulation of its per-CTA sums
must equal the plain backward, and every position of dw = P dy and every
row of dR must have exactly one owner. Inputs come from numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gs_fused as jgs  # noqa: E402
from repro_torch.core import adapters as tad  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# f32 sums over up to a few hundred tokens in another order than the
# plain version's einsums
F32_REL = 1e-5
# (r, b): b | r (super-blocks), r = b, r >= b with b not dividing r (the
# MLP wo width r = 924 at b = 32, and small ones), odd r (a window of 2b - 1
# groups at most), gcd(r, b) of 1, 2, 4, 8 and 16
PLAN_SHAPES = [(8, 4), (16, 4), (12, 4), (7, 4), (9, 3), (10, 4), (5, 5),
               (256, 32), (32, 32), (924, 32), (33, 32), (63, 32), (34, 32),
               (36, 32), (40, 32), (48, 32), (100, 32)]


def _owners(r, b, slots):
    """For every CTA slot of the plan: (g, [(m, row) of position e])."""
    table, tiles, parts, _, _ = gk.tc_table(r, b, slots)
    assert table.shape == (tiles * parts, 8 + 4 * slots)
    out = []
    for entry in table:
        w0, width = int(entry[0]), int(entry[1])
        for s in range(slots):
            q, g, delta = (int(v) for v in entry[8 + 4 * s:11 + 4 * s])
            if q < 0:
                continue
            assert 0 <= delta and delta + b <= width
            mv = [w0 + delta + e for e in range(b)]
            out.append((g, [(v % r, q + (v >= r)) for v in mv]))
    return out


@pytest.mark.parametrize("r,b", PLAN_SHAPES, ids=lambda v: str(v))
def test_tc_plan_owns_every_position_and_dR_row_once(r, b):
    slots = min(b, 8)
    groups, rows = [], []
    for g, pos in _owners(r, b, slots):
        groups.append(g)
        for e, (m, row) in enumerate(pos):
            # position c = g b + e of dw = P dy is u[m][row] of the source
            assert g * b + e == row * r + m
            rows.append((m, row))
    assert sorted(groups) == list(range(r))
    assert sorted(rows) == [(m, q) for m in range(r) for q in range(b)]


def test_tc_plan_windows_fit_the_kernel_for_every_r():
    """Route 1 takes b = 32 and any r >= 32: each CTA's window of source
    groups and dy columns stays within what the kernel stages."""
    for r in list(range(32, 300)) + [924, 1000, 1023]:
        table, tiles, parts, maxw, maxdq = gk.tc_table(r)
        assert (tiles, parts) == (-(-r // 32), 4)
        assert maxw <= gk.TC_MAX_WINDOW and maxdq <= gk.TC_BLOCK
        for entry in table:
            w0, width, qlo, dq, simple = (int(v) for v in entry[:5])
            assert width == 0 or (0 <= w0 < r and qlo % 8 == 0 and dq % 8 == 0
                                  and qlo + dq <= gk.TC_BLOCK)
            if r % 32 == 0:
                assert simple and width == 32 and dq == 8


def _emulate(x, dy, L, R, r, b, slots):
    """The tensor-core kernel's per-slot sums in plain torch (one row)."""
    t = x.shape[0]
    X, DY = x.reshape(t, r, b), dy.reshape(t, r, b)
    dL = torch.full((r, b, b), float("nan"))
    dR = torch.full((r, b, b), float("nan"))
    for g, pos in _owners(r, b, slots):
        m = torch.tensor([p[0] for p in pos])
        row = torch.tensor([p[1] for p in pos])
        xs = X[:, m]                                      # (T, b, b)
        v = torch.einsum("tej,ej->te", xs, R[m, row])    # v = P R x
        dw = DY[:, m, row]                                # dw = P dy
        assert torch.isnan(dL[g]).all()
        dL[g] = dw.T @ v
        dv = dw @ L[g]                                    # dv = L^T dw
        assert torch.isnan(dR[m, row]).all()
        dR[m, row] = torch.einsum("te,tej->ej", dv, xs)   # du x^T
    return dL, dR


@pytest.mark.parametrize("r,b,t", [(8, 4, 40), (12, 4, 33), (7, 4, 20),
                                   (9, 3, 17), (10, 4, 50), (16, 4, 9),
                                   (5, 5, 30), (924, 32, 3), (33, 32, 5)])
def test_tc_plan_emulation_matches_the_plain_backward(r, b, t):
    rng = np.random.default_rng(r * 100 + b + t)
    x, dy = (torch.from_numpy(a) for a in
             rng.normal(size=(2, t, r * b)).astype(np.float32))
    L, R = (torch.from_numpy(a) for a in
            rng.normal(size=(2, r, b, b)).astype(np.float32))
    dL, dR = _emulate(x, dy, L, R, r, b, min(b, 8))
    wL, wR = ref.gs_fused_grads_ref(L, R, x, dy)
    for got, want in ((dL, wL), (dR, wR)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= F32_REL * scale


@pytest.mark.parametrize("r,b", [(8, 4), (16, 4), (12, 4), (64, 32)])
def test_q_is_block_diagonal_in_b_squared_blocks_when_b_divides_r(r, b):
    rng = np.random.default_rng(r + b)
    L, R = (torch.from_numpy(a)[None] for a in
            rng.normal(size=(2, r, b, b)).astype(np.float32))
    d = r * b
    Q = gk.gs_fused_plain(torch.eye(d)[None], L, R)[0]   # rows: Q e_t
    mask = torch.zeros(d, d, dtype=torch.bool)
    for s in range(d // (b * b)):
        mask[s * b * b:(s + 1) * b * b, s * b * b:(s + 1) * b * b] = True
    assert float(Q[~mask].abs().max()) == 0.0
    assert float(Q[mask].abs().max()) > 0.0


SMS = 132
# (B, T, r, b, dtype): the weight slabs of qwen2-72b at b = 32 (wi / wg,
# MLP wo, wq / attn wo, wk / wv, both sides), short T, several rows; route
# 2: f32, b = 64 / 128 / 256, r < b
PLAN_CASES = [(1, 29568, 256, 32, "bf16"), (1, 8192, 924, 32, "bf16"),
              (1, 8192, 256, 32, "bf16"), (1, 1024, 256, 32, "bf16"),
              (1, 8192, 32, 32, "bf16"), (1, 29568, 32, 32, "bf16"),
              (2, 5, 33, 32, "bf16"), (4, 700, 924, 32, "bf16"),
              (1, 29568, 256, 32, "f32"), (1, 29568, 64, 128, "bf16"),
              (1, 300, 2, 256, "bf16"), (1, 77, 128, 64, "bf16"),
              (1, 40, 8, 128, "f32"), (3, 5, 3, 16, "bf16")]


def _tc_smem(maxw, maxdq):
    """Bytes of shared memory of gs_grads_tc_kernel (its Layout)."""
    xp = maxw * 64 + 16
    dp = (maxw * maxdq * 2 + 31) // 32 * 32 + 16
    vqp, dump = 32 * 48 + 16, 8 * 48 + 16
    return 2 * 16 * (xp + dp) + 3 * 8 * vqp + 2 * maxw * dump + 64 + 4 * gk.TC_TAB


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "B%d-T%d-r%d-b%d-%s" % c)
def test_bwd_plan_is_within_the_kernel_limits(case):
    bsz, t, r, b, dt = case
    plan = gk.bwd_plan(bsz, t, r, b, dt, SMS)
    tc = dt == "bf16" and b == 32 and r >= 32
    assert plan.route == ("tc" if tc else "two_pass")
    assert 1 <= plan.splits <= 65535
    if tc:
        table, tiles, parts, maxw, maxdq = gk.tc_table(r)
        assert (plan.entries, plan.parts) == (tiles * parts, parts)
        assert (plan.window, plan.dq) == (maxw, maxdq)
        assert plan.tokens % gk.TC_TOKENS == 0
        assert (plan.splits - 1) * plan.tokens < t <= plan.splits * plan.tokens
        # one CTA an SM: the splits fill at most one wave when they can
        assert plan.entries * bsz * plan.splits <= max(SMS, plan.entries * bsz)
        assert _tc_smem(plan.window, plan.dq) <= 232448
    else:
        n4 = -(-b // 4)
        rows4 = -(-n4 // plan.ichunks)
        # every row of the b x b block in exactly one pass-2 CTA, each
        # within the kernel's 4 x 4 tiles and shared memory
        covered = [i for c in range(plan.ichunks)
                   for i in range(c * rows4, min(n4, (c + 1) * rows4))]
        assert covered == list(range(n4))
        assert rows4 * n4 <= gk.REDUCE_TILES
        assert 2 * 64 * (4 * rows4 + 4 * n4) * 4 <= 232448
        assert plan.tokens in (1, 2, 4, 8) and plan.tokens * r * b <= gk.MAX_TILE_ELEMS
    # the wi slab fills the card: 8 tiles x 4 parts x 4 splits
    if (bsz, t, r, dt) == (1, 29568, 256, "bf16"):
        assert (plan.entries, plan.splits) == (32, 4)


# ---------------------------------------------------------------------------
# the autograd rules: no dx kernel for a frozen weight
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Wrap the dispatch module's kernels so each call is recorded with its
    arguments and results."""
    calls = []
    for name in ("gs_fused", "gs_fused_T", "gs_fused_bwd", "gs_fused_grads"):
        fn = getattr(dispatch, name)

        def rec(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls.append((_name, args, out))
            return out
        monkeypatch.setattr(dispatch, name, rec)
    return calls


@pytest.mark.parametrize("method", ["gsoft", "double_gsoft"])
def test_adapter_backward_runs_no_dx_kernel_for_the_frozen_weight(
        monkeypatch, method):
    calls = _record(monkeypatch)
    kw = dict(method=method, d_in=32, d_out=24, block_size=8,
              block_size_out=4)
    tspec = tad.AdapterSpec(**kw)
    rng = np.random.default_rng(11)
    params = {k: v.numpy() + 0.05 * rng.normal(size=v.shape).astype(np.float32)
              for k, v in tad.init_adapter(tspec, device="cpu").items()}
    W = rng.normal(size=(32, 24)).astype(np.float32)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    loss = torch.mean((torch.from_numpy(x) @ tad.materialize(
        tspec, tp, torch.from_numpy(W))) ** 2)
    n_fwd = len(calls)
    torch.autograd.grad(loss, [tp[k] for k in sorted(tp)])
    bwd = [c[0] for c in calls[n_fwd:]]
    if method == "gsoft":
        assert sorted(bwd) == ["gs_fused_grads"]
    else:
        # output side: its input, the rotated W, needs dx (gs_fused of dy)
        assert sorted(bwd) == ["gs_fused", "gs_fused_grads", "gs_fused_grads"]
    assert "gs_fused_bwd" not in bwd
    # each grads call's (dL, dR) against the Pallas kernel on the same inputs
    for name, (xa, dya, La, Ra), (gL, gR) in (c for c in calls[n_fwd:]
                                               if c[0] == "gs_fused_grads"):
        jargs = [jnp.asarray(a[0].detach().numpy()) for a in (La, Ra, xa, dya)]
        qL, qR = jgs.gs_fused_grads_pallas(*jargs, token_tile=8, interpret=True)
        for got, want in ((gL[0], qL), (gR[0], qR)):
            want = np.asarray(want)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got.numpy() - want).max()) <= F32_REL * scale


def test_gs_diff_runs_the_dx_kernel_only_for_an_input_that_needs_it(
        monkeypatch):
    calls = _record(monkeypatch)
    rng = np.random.default_rng(5)
    L, R = (torch.from_numpy(a).requires_grad_() for a in
            rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    for op, dx_kernel in ((dispatch.gs_diff, "gs_fused_bwd"),
                          (dispatch.gs_T_diff, "gs_fused")):
        for needs in (False, True):
            xx = x.clone().requires_grad_(needs)
            y = op(L, R, xx)
            del calls[:]
            grads = torch.autograd.grad(y.sum(), [L, R] + ([xx] if needs else []))
            names = [c[0] for c in calls]
            assert (dx_kernel in names) == needs, (op, needs, names)
            if needs:
                # dx equals the fused kernel's on the other path
                want = ref.gs_fused_T_ref(L.detach(), R.detach(),
                                          torch.ones_like(x)) \
                    if op is dispatch.gs_diff else \
                    ref.gs_fused_ref(L.detach(), R.detach(), torch.ones_like(x))
                assert float((grads[2] - want).abs().max()) <= 1e-5
