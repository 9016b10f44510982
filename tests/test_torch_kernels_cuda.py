"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with an
NVIDIA GPU and only PyTorch: ``python -m pytest -q tests/test_torch_kernels_cuda.py``.
The ``cuda``-marked tests skip without a card; the wrapper's argument
checks run everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

from repro_torch.kernels import bdmm as bk  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402

# f32: fp32 sums in another order than the plain version's matmuls
F32_TOL = 1e-4
# bf16: the kernel keeps the intermediate in fp32 where the plain version
# rounds it to bf16 (2^-9 relative); both round y, |y| < 8 here (ulp 2^-5)
BF16_TOL = 2.0 ** -4


def _factors(rng, bsz, r, b):
    a = rng.normal(0, 0.3, size=(bsz, r, b, b))
    k = a - np.swapaxes(a, -1, -2)
    eye = np.eye(b)
    q = np.swapaxes(np.linalg.solve(eye + k, eye - k), -1, -2)
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# (B, T, r, b): decode rows (cluster-split), short prefill buckets at
# d = 8192 (cluster-split with 4 tokens per tile), prefill tiles, ragged T,
# r not a power of two, r < b, r > b, tiny d, and the qwen2-72b MLP width
CASES = [(4, 1, 256, 32), (1, 16, 256, 32), (1, 64, 256, 32),
         (1, 130, 256, 32), (2, 7, 6, 4), (3, 5, 3, 16), (1, 33, 24, 8),
         (2, 1, 231, 128), (1, 140, 924, 32), (1, 9, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B%d-T%d-r%d-b%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["gs_fused_T", "gs_fused"])
def test_kernel_matches_plain(cuda, case, dtype, name):
    bsz, t, r, b = case
    rng = np.random.default_rng(bsz * 1000 + t * 10 + r + b)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * b)).astype(np.float32))
    L, R = _factors(rng, bsz, r, b), _factors(rng, bsz, r, b)
    args = [a.to(cuda, dtype) for a in (x, L, R)]
    fn, plain = ((gk.gs_fused_T, gk.gs_fused_T_plain) if name == "gs_fused_T"
                 else (gk.gs_fused, gk.gs_fused_plain))
    before = fn.launches
    y = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_short_prefill_runs_the_split_multi_token_variant(cuda):
    # route 2 (f32; bf16 with b != 32): an fp32 tile over a cluster of 8
    # CTAs when the split grid fits one wave
    sms = gk._num_sms(cuda)
    for t, d, tt, cluster in ((16, 8192, 4, 8), (128, 8192, 4, 1),
                              (16, 29568, 1, 8)):
        plan = gk.t_plan(1, t, d // 32, 32, "f32", sms)
        assert (plan.route, plan.tt, plan.cluster) == ("cc", tt, cluster)
    # route 1 (bf16, b = 32): a short prefill spreads each 32-group tile
    # over entries of 8 or 16 output groups, so its factor read runs on at
    # least 32 SMs (4 times the whole tiles'); a long one runs whole tiles
    for t, d in ((16, 8192), (128, 8192), (16, 29568), (1, 8192)):
        plan = gk.t_plan(1 if t > 1 else 4, t, d // 32, 32, "bf16", sms)
        assert plan.route == "tc" and plan.ng < 32
        assert plan.entries * plan.splits * (1 if t > 1 else 4) >= 32
    assert gk.t_plan(1, 29568, 256, 32, "bf16", sms).ng == 32


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gs_fused_T", "gs_fused"])
def test_empty_input_launches_nothing(cuda, name):
    fn = getattr(gk, name)
    L = torch.zeros((1, 8, 8, 8), device=cuda)
    before = fn.launches
    assert fn(torch.zeros((1, 0, 64), device=cuda), L, L).shape == (1, 0, 64)
    assert fn.launches == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 64), device=cuda, dtype=torch.float16)
    L = torch.zeros((1, 8, 8, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        gk.gs_fused_T(x, L, L)
    x = torch.zeros((1, 64, 2), device=cuda).transpose(1, 2)
    L = torch.zeros((1, 8, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gs_fused_T(x, L, L)


def test_wrapper_checks_shapes_and_types_on_any_device():
    x = torch.zeros((2, 3, 64))
    L = torch.zeros((2, 8, 8, 8))
    with pytest.raises(ValueError, match="d = r \\* b"):
        gk.gs_fused_T(torch.zeros((2, 3, 60)), L, L)
    with pytest.raises(ValueError, match="expected x"):
        gk.gs_fused(torch.zeros((3, 64)), L, L)
    with pytest.raises(TypeError, match="one dtype"):
        gk.gs_fused_T(x, L.double(), L)
    with pytest.raises(ValueError, match="shape mismatch"):
        gk.gs_fused(torch.zeros((1, 3, 64)), L, L)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
    L, R = _factors(rng, 2, 4, 8), _factors(rng, 2, 4, 8)
    before = (gk.gs_fused_T.launches, gk.gs_fused.launches)
    assert torch.equal(gk.gs_fused_T(x, L, R), gk.gs_fused_T_plain(x, L, R))
    assert torch.equal(gk.gs_fused(x, L, R), gk.gs_fused_plain(x, L, R))
    assert (gk.gs_fused_T.launches, gk.gs_fused.launches) == before


# ---------------------------------------------------------------------------
# gs_fused route 1 (csrc/gs_fused.cu gs_fused_tc_kernel)
# ---------------------------------------------------------------------------

# (B, T, r) at b = 32, bf16: the slabs GSOFT and Double GSOFT train (wi / wg
# T = 29568 at r = 256; MLP wo T = 8192 at r = 924, b not dividing r; wq /
# attn wo 8192 x 8192; wk / wv T = 1024; the output sides T = 8192 at r =
# 32 = b and T = 1024 at r = 256), ragged T, T < 16, rows B > 1 with their
# own factors, r = b, windows that wrap (r = 33, 40, 63) and d > 32768 (r =
# 1056 with b | r, r = 1040 without)
FWD_TC_CASES = [(1, 29568, 256), (1, 8192, 924), (1, 8192, 256),
                (1, 1024, 256), (1, 8192, 32), (1, 1000, 256), (1, 77, 924),
                (1, 5, 256), (1, 1, 33), (2, 9, 924), (3, 40, 40),
                (2, 300, 924), (4, 33, 256), (1, 100, 32), (1, 777, 33),
                (1, 1000, 63), (1, 64, 1056), (1, 130, 1040)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_TC_CASES, ids=lambda c: "B%d-T%d-r%d" % c)
def test_forward_route1_matches_plain_and_reruns_bit_identical(cuda, case):
    bsz, t, r = case
    rng = np.random.default_rng(bsz * 13 + t * 5 + r)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * 32)).astype(np.float32))
    L, R = _factors(rng, bsz, r, 32), _factors(rng, bsz, r, 32)
    x, L, R = (a.to(cuda, torch.bfloat16) for a in (x, L, R))
    plan = gk.fwd_plan(bsz, t, r, 32, "bf16", gk._num_sms(cuda))
    assert plan.route == "tc"
    before = gk.gs_fused.launches
    y = gk.gs_fused(x, L, R)
    torch.cuda.synchronize()
    assert gk.gs_fused.launches == before + 1
    want = gk.gs_fused_plain(x, L, R)
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL
    assert torch.equal(gk.gs_fused(x, L, R), y)


@pytest.mark.cuda
def test_forward_route2_keeps_f32_other_blocks_and_short_rows(cuda):
    # loading the library checks its constants against route 1's plan
    gk._lib("gs_fused")
    sms = gk._num_sms(cuda)
    assert gk.fwd_plan(1, 29568, 256, 32, "bf16", sms).route == "tc"
    assert gk.fwd_plan(1, 29568, 256, 32, "f32", sms).route == "cc"
    assert gk.fwd_plan(1, 29568, 64, 128, "bf16", sms).route == "cc"
    assert gk.fwd_plan(1, 300, 16, 32, "bf16", sms).route == "cc"
    # route 2 (of both rotations) holds whole fp32 rows up to
    # MAX_TILE_ELEMS and takes a wider row through its wide passes (tokens
    # per tile 0); route 1 of the transpose rotation (bf16, b = 32) takes
    # any width
    assert gk.fwd_plan(1, 2, 1056, 32, "f32", sms) == ("cc", 0, 1, 0, 0)
    assert gk.t_plan(1, 2, 1056, 32, "f32", sms).tt == 0
    rng = np.random.default_rng(33792)
    x = torch.from_numpy(rng.normal(size=(1, 2, 33792)).astype(np.float32))
    L = _factors(rng, 1, 1056, 32).to(cuda)
    x = x.to(cuda)
    for fn, plain in ((gk.gs_fused, gk.gs_fused_plain),
                      (gk.gs_fused_T, gk.gs_fused_T_plain)):
        y = fn(x, L, L)
        torch.cuda.synchronize()
        assert (y - plain(x, L, L)).abs().max().item() <= F32_TOL
    y = gk.gs_fused_T(x.bfloat16(), L.bfloat16(), L.bfloat16())
    torch.cuda.synchronize()
    assert y.shape == x.shape and torch.isfinite(y.float()).all()


# route 2 past MAX_TILE_ELEMS: d = 33792 in f32 at b = 32 and in bf16 at
# b = 128, rows of their own factors, 9 tokens (two wide token tiles)
WIDE_CASES = [(torch.float32, 32), (torch.bfloat16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b", WIDE_CASES,
                         ids=lambda v: str(v).split(".")[-1])
def test_route2_takes_d_past_the_tile_limit(cuda, dtype, b):
    """gs_fused, gs_fused_T (per row and by slot id from a bank) and the GS
    backward at d = 33792 on route 2's wide passes, against their plain
    versions, one launch a call, bit-identical reruns."""
    d = 33792
    r = d // b
    rng = np.random.default_rng(b)
    sms = gk._num_sms(cuda)
    assert gk.fwd_plan(2, 9, r, b, "bf16" if b != 32 else "f32",
                       sms).tokens == 0
    x, dy, L, R = _bwd_inputs(rng, 2, 9, r, b, cuda, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for fn, plain in ((gk.gs_fused, gk.gs_fused_plain),
                      (gk.gs_fused_T, gk.gs_fused_T_plain)):
        before = fn.launches
        y = fn(x, L, R)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert (y.float() - plain(x, L, R).float()).abs().max().item() <= tol
        assert torch.equal(fn(x, L, R), y)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, 3, r, b))
    ids = torch.tensor([2, 0], dtype=torch.int64, device=cuda)
    y = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    want = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    assert (y.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(y[1], x[1])
    dx, dL, dR = gk.gs_fused_bwd(x, dy, L, R)
    gL, gR = gk.gs_fused_grads(x, dy, L, R)
    want = gk.gs_fused_bwd_plain(x, dy, L, R)
    assert (dx.float() - want[0].float()).abs().max().item() <= tol
    _assert_grads_close(dL, want[1], "dL")
    _assert_grads_close(dR, want[2], "dR")
    assert torch.equal(gL, dL) and torch.equal(gR, dR)


# ---------------------------------------------------------------------------
# backward kernels (csrc/gs_fused_bwd.cu)
# ---------------------------------------------------------------------------

# dL, dR: fp32 on both sides from the same inputs (bf16 inputs too), so they
# agree to summation order: 1e-4 of the largest magnitude
GRAD_REL = 1e-4

# (B, T, r, b): one and several token splits, ragged T, r < b, r > b, r not
# a power of two, tiny d, and the qwen2-72b MLP width d = 29568 (one token
# per fp32 tile). bf16 at b = 32 and r >= b takes route 1 (tensor cores):
# b | r, r = b, b not dividing r (r = 924, 33: a window of 39 groups; 63;
# 40), several token splits (T = 3000 at r = 256), rows B = 2 and 4, a
# ragged last token tile; route 2 (two passes, and every f32 case) also at
# b = 64, 128 and 256 (rows split over pass-2 CTAs) with r < b and r >= b
BWD_CASES = [(1, 64, 256, 32), (2, 130, 32, 32), (1, 7, 6, 4), (3, 5, 3, 16),
             (1, 33, 24, 8), (1, 40, 8, 128), (1, 300, 2, 32),
             (1, 9, 924, 32), (2, 3, 5, 5), (1, 3000, 256, 32),
             (2, 500, 924, 32), (1, 777, 33, 32), (1, 1000, 63, 32),
             (4, 45, 40, 32), (1, 50, 2, 64), (1, 70, 64, 64),
             (1, 30, 128, 128), (1, 20, 2, 256), (1, 41, 3, 256)]


def _bwd_inputs(rng, bsz, t, r, b, device, dtype):
    x, dy = (torch.from_numpy(a.astype(np.float32))
             for a in rng.normal(size=(2, bsz, t, r * b)))
    L, R = _factors(rng, bsz, r, b), _factors(rng, bsz, r, b)
    return [a.to(device, dtype) for a in (x, dy, L, R)]


def _assert_grads_close(got, want, what):
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all(), what
    assert err <= GRAD_REL * scale, f"{what}: {err} > {GRAD_REL} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "B%d-T%d-r%d-b%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_kernels_match_plain(cuda, case, dtype):
    bsz, t, r, b = case
    rng = np.random.default_rng(bsz * 7 + t * 3 + r + b)
    x, dy, L, R = _bwd_inputs(rng, bsz, t, r, b, cuda, dtype)
    before = (gk.gs_fused_bwd.launches, gk.gs_fused_grads.launches)
    dx, dL, dR = gk.gs_fused_bwd(x, dy, L, R)
    gL, gR = gk.gs_fused_grads(x, dy, L, R)
    torch.cuda.synchronize()
    assert (gk.gs_fused_bwd.launches, gk.gs_fused_grads.launches) == \
        (before[0] + 1, before[1] + 1)
    want = gk.gs_fused_bwd_plain(x, dy, L, R)
    assert dx.dtype == dtype and dL.dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert (dx.float() - want[0].float()).abs().max().item() <= tol
    _assert_grads_close(dL, want[1], "dL")
    _assert_grads_close(dR, want[2], "dR")
    # the grads-only variant sums the same terms in the same order
    assert torch.equal(gL, dL) and torch.equal(gR, dR)
    # deterministic: a second run is bit-identical
    again = gk.gs_fused_bwd(x, dy, L, R)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dL, dR)))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1056, 1040])
def test_backward_route1_takes_d_past_32768(cuda, r):
    """Route 1 of the backward (bf16, b = 32) and its dx, route 1 of the
    transpose rotation, take d = 33792 and 33280."""
    rng = np.random.default_rng(r)
    x, dy, L, R = _bwd_inputs(rng, 1, 40, r, 32, cuda, torch.bfloat16)
    dx, dL, dR = gk.gs_fused_bwd(x, dy, L, R)
    want = gk.gs_fused_bwd_plain(x, dy, L, R)
    assert (dx.float() - want[0].float()).abs().max().item() <= BF16_TOL
    _assert_grads_close(dL, want[1], "dL")
    _assert_grads_close(dR, want[2], "dR")


@pytest.mark.cuda
def test_backward_plan_matches_the_kernel(cuda):
    # loading the library checks its constants against the plan's
    gk._lib("gs_fused_bwd")
    sms = gk._num_sms(cuda)
    plan = gk.bwd_plan(1, 29568, 256, 32, "bf16", sms)
    assert plan.route == "tc" and plan.entries == 32
    assert plan.entries * plan.splits <= sms
    assert gk.bwd_plan(1, 29568, 256, 32, "f32", sms).route == "two_pass"
    assert gk.bwd_plan(1, 29568, 64, 128, "bf16", sms).route == "two_pass"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gs_fused_bwd", "gs_fused_grads"])
def test_backward_of_empty_input_is_zero_and_launches_nothing(cuda, name):
    fn = getattr(gk, name)
    x = torch.zeros((1, 0, 64), device=cuda)
    L = torch.ones((1, 8, 8, 8), device=cuda)
    before = fn.launches
    out = fn(x, x, L, L)
    assert fn.launches == before
    assert all(float(g.abs().max()) == 0.0 for g in out[-2:])


@pytest.mark.cuda
def test_backward_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 1024), device=cuda)
    L = torch.zeros((1, 2, 512, 512), device=cuda)
    with pytest.raises(ValueError, match="block size"):
        gk.gs_fused_bwd(x, x, L, L)
    L = torch.zeros((1, 8, 8, 8), device=cuda)
    x = torch.zeros((1, 64, 2), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gs_fused_grads(x, x.contiguous(), L, L)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gs_diff", "gs_T_diff"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_rules_match_autograd_of_the_plain_versions(cuda, op, dtype):
    """gs_diff / gs_T_diff gradients (the kernels both ways) against
    autograd through the plain forward versions on the card."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(17)
    t, r, b = 45, 24, 8
    x = torch.from_numpy(rng.normal(size=(t, r * b)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(t, r * b)).astype(np.float32))
    L, R = _factors(rng, 1, r, b)[0], _factors(rng, 1, r, b)[0]
    fn = getattr(dispatch, op)
    plain = ref.gs_fused_ref if op == "gs_diff" else ref.gs_fused_T_ref
    # forward, dx, factor gradients: the kernels each rule must launch
    used = ((gk.gs_fused, gk.gs_fused_bwd) if op == "gs_diff"
            else (gk.gs_fused_T, gk.gs_fused, gk.gs_fused_grads))
    before = [k.launches for k in used]
    grads = []
    for f in (fn, plain):
        args = [a.to(cuda, dtype).requires_grad_() for a in (L, R, x)]
        y = f(*args)
        grads.append(torch.autograd.grad((y.float() * cot.to(cuda)).sum(), args))
    assert [k.launches for k in used] == [n + 1 for n in before]
    for name, got, want in zip(("dL", "dR", "dx"), *grads):
        assert got.dtype == want.dtype == dtype
        if dtype == torch.float32:
            _assert_grads_close(got, want, f"{op} {name}")
        else:
            # the plain forward rounds its intermediate to bf16 and its
            # autograd rounds every stage's gradient; the kernels keep fp32:
            # one bf16 rounding (2^-8) of values up to the largest
            # magnitude, a few times over
            scale = max(1.0, want.float().abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2.0 ** -5 * scale, f"{op} {name} bf16: {err}"


# ---------------------------------------------------------------------------
# block-diagonal matmul kernels (csrc/bdmm.cu)
# ---------------------------------------------------------------------------

# (B, T, r, bo, bi): decode rows (per-row blocks, T = 1) at both qwen2-72b
# widths, short prefills, ragged T, a long slab with several token tiles per
# CTA, rectangular and odd blocks (the CUDA-core route), b = 128, tiny d;
# b = 256, (512, 64) (bo split over CTAs) and (64, 512) (32 k-steps); bi = 8
# and 40 (zero-padded along K) with a partial group tile; bi = 1024 (past
# the tensor cores' 512: bi looped in chunks on the CUDA cores); (8, 512),
# whose ring holds fewer groups per CTA)
BDMM_CASES = [(4, 1, 256, 32, 32), (4, 1, 924, 32, 32), (1, 16, 256, 32, 32),
              (1, 130, 256, 32, 32), (2, 7, 6, 4, 4), (3, 33, 2, 8, 4),
              (1, 64, 3, 5, 9), (1, 2500, 64, 32, 32), (2, 40, 4, 128, 128),
              (1, 9, 16, 4, 4), (1, 5, 1, 32, 32), (2, 1, 8, 16, 8),
              (1, 40, 1, 256, 256), (1, 33, 2, 512, 64), (1, 50, 2, 64, 512),
              (4, 1, 2, 256, 256), (1, 20, 5, 16, 8), (1, 37, 3, 24, 40),
              (1, 40, 1, 64, 1024), (1, 20, 4, 8, 512)]
# the product with blocks^T read in place: decode rows, odd blocks, prefill
# and slab tiles on the tensor cores, large blocks
TRANS_CASES = [(4, 1, 256, 32, 32), (4, 1, 924, 32, 32), (2, 7, 6, 4, 4),
               (3, 33, 2, 8, 4), (1, 64, 3, 5, 9), (2, 1, 8, 16, 8),
               (1, 130, 256, 32, 32), (1, 2500, 64, 32, 32),
               (1, 40, 1, 256, 256), (1, 33, 2, 512, 64), (4, 1, 2, 256, 256),
               (1, 37, 3, 24, 40), (1, 40, 1, 64, 1024)]
# (B, T, r, bo, bi) of the blocks gradient: one and several token splits,
# ragged T, rectangular and odd blocks, b = 128, a long slab; b = 256,
# (512, 64) and (64, 512) (split over CTAs along (bo, bi) tiles), and a
# partial group tile with bi = 40
DBLOCKS_CASES = [(1, 64, 256, 32, 32), (1, 3000, 256, 32, 32),
                 (2, 33, 2, 8, 4), (1, 250, 16, 4, 4), (1, 64, 3, 5, 9),
                 (1, 40, 2, 128, 128), (2, 7, 6, 4, 4), (1, 1, 4, 8, 8),
                 (1, 100, 3, 128, 64), (1, 40, 1, 256, 256),
                 (1, 70, 2, 512, 64), (1, 70, 2, 64, 512), (1, 45, 5, 24, 40)]
# the weight slabs chip_smoke.py gives the kernels (qwen2-72b, b = 32):
# (B, T, r, bo, bi) of wi / wg, MLP wo, wq / attn wo, wk / wv
SLABS = [(1, 29568, 256, 32, 32), (1, 8192, 924, 32, 32),
         (1, 8192, 256, 32, 32), (1, 1024, 256, 32, 32)]


def _bdmm_inputs(rng, bsz, t, r, bo, bi, device, dtype):
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * bi)).astype(np.float32))
    blocks = torch.from_numpy(
        rng.normal(0, bi ** -0.5, size=(bsz, r, bo, bi)).astype(np.float32))
    return x.to(device, dtype), blocks.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BDMM_CASES,
                         ids=lambda c: "B%d-T%d-r%d-bo%d-bi%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bdmm_kernel_matches_plain(cuda, case, dtype):
    bsz, t, r, bo, bi = case
    rng = np.random.default_rng(bsz * 7 + t + r * 3 + bo + bi)
    x, blocks = _bdmm_inputs(rng, bsz, t, r, bo, bi, cuda, dtype)
    before = bk.bdmm.launches
    y = bk.bdmm(x, blocks)
    torch.cuda.synchronize()
    assert bk.bdmm.launches == before + 1
    want = bk.bdmm_plain(x, blocks)
    assert y.shape == want.shape == (bsz, t, r * bo) and y.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", DBLOCKS_CASES,
                         ids=lambda c: "B%d-T%d-r%d-bo%d-bi%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bdmm_dblocks_kernel_matches_plain_and_is_deterministic(cuda, case,
                                                                dtype):
    bsz, t, r, bo, bi = case
    rng = np.random.default_rng(bsz * 5 + t + r * 7 + bo + bi)
    dy = torch.from_numpy(rng.normal(size=(bsz, t, r * bo)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * bi)).astype(np.float32))
    dy, x = dy.to(cuda, dtype), x.to(cuda, dtype)
    before = bk.bdmm_dblocks.launches
    got = bk.bdmm_dblocks(dy, x, bo, bi)
    torch.cuda.synchronize()
    assert bk.bdmm_dblocks.launches == before + 1
    want = bk.bdmm_dblocks_plain(dy, x, bo, bi)
    assert got.shape == (bsz, r, bo, bi) and got.dtype == torch.float32
    _assert_grads_close(got, want, "dblocks")
    assert torch.equal(bk.bdmm_dblocks(dy, x, bo, bi), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRANS_CASES,
                         ids=lambda c: "B%d-T%d-r%d-bo%d-bi%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bdmm_reads_transposed_blocks_in_place(cuda, case, dtype):
    bsz, t, r, bo, bi = case
    rng = np.random.default_rng(bsz * 11 + t + r * 5 + bo + bi)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * bi)).astype(np.float32))
    stored = torch.from_numpy(      # blocks^T is the product's (bo, bi) block
        rng.normal(0, bi ** -0.5, size=(bsz, r, bi, bo)).astype(np.float32))
    x, stored = x.to(cuda, dtype), stored.to(cuda, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    before = bk.bdmm.launches
    y = bk.bdmm(x, stored, transpose_blocks=True)
    torch.cuda.synchronize()
    assert bk.bdmm.launches == before + 1
    want = bk.bdmm_plain(x, stored, transpose_blocks=True)
    torch.testing.assert_close(
        want.float(), bk.bdmm_plain(x, stored.transpose(-1, -2).contiguous())
        .float(), rtol=0, atol=tol / 2)
    assert y.shape == (bsz, t, r * bo) and y.dtype == dtype
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_bdmm_decode_grid_splits_groups_over_the_sms(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for r in (256, 924):
        for trans in (False, True):
            plan = bk.bdmm_plan(torch.bfloat16, 4, 1, r, 32, 32, sms, trans)
            assert plan.route == "decode" and plan.grid[0] >= sms


def _within_limits(plan):
    gx, gy, gz = plan.grid
    assert plan.smem <= bk.SMEM_LIMIT == 227 * 1024
    assert 32 <= plan.threads <= bk.MAX_THREADS <= 1024
    assert plan.threads % 32 == 0
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535 and 1 <= gz <= 65535


def test_bdmm_geometry_is_within_the_kernel_limits():
    """Every route's launch for the test cases and the qwen2-72b slabs, as
    the C side recomputes and checks it: shared memory, threads, grid."""
    shapes = BDMM_CASES + TRANS_CASES + SLABS + [(4, 1, 256, 32, 32),
                                                 (4, 1, 924, 32, 32)]
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, t, r, bo, bi in shapes:
            for trans in (False, True):
                plan = bk.bdmm_plan(dtype, bsz, t, r, bo, bi, 132, trans)
                _within_limits(plan)
                # decode: one flat grid of block rows; else rows on grid z
                assert plan.grid[2] == (1 if plan.route == "decode" else bsz)
                if plan.route == "tc":
                    kt, nt, gt, wpg, tm, tpc = plan.args
                    assert dtype == torch.bfloat16 and t >= 16
                    assert kt * 16 >= bi and nt * kt <= 32 and tm % 16 == 0
                    assert plan.threads == gt * wpg * 32 and tpc % tm == 0
                    assert plan.grid[1] == -(-t // tpc)
                elif plan.route == "cc":
                    gt, nc, kc, tt, tpc = plan.args
                    assert gt * nc <= bk.MAX_THREADS and nc <= bo and kc <= bi
                    assert gt == 1 or (kc == bi and nc == bo)
                    assert tpc % tt == 0 and plan.grid[1] == -(-t // tpc)
                else:
                    assert plan.route == "decode" and t < 16
        for bsz, t, r, bo, bi in DBLOCKS_CASES + SLABS:
            plan = bk.dblocks_plan(dtype, bsz, t, r, bo, bi, 132)
            _within_limits(plan)
            splits, tps = plan.args[-2:]
            assert splits * tps >= t > (splits - 1) * tps
            assert tps % (plan.args[3] if plan.route == "tc" else 32) == 0
    # the slabs take the tensor cores in bf16, the CUDA cores in f32; decode
    # rows the decode kernel
    for bsz, t, r, bo, bi in SLABS:
        assert bk.bdmm_plan(torch.bfloat16, bsz, t, r, bo, bi, 132).route == "tc"
        assert bk.bdmm_plan(torch.float32, bsz, t, r, bo, bi, 132).route == "cc"
        assert bk.dblocks_plan(torch.bfloat16, bsz, t, r, bo, bi, 132).route == "tc"
    # at the widest slab, splits fill the card: twice its resident CTAs on
    # the tensor cores, about four CTAs per SM on the CUDA cores
    assert bk.dblocks_plan(torch.bfloat16, 1, 29568, 256, 32, 32,
                           132).args == (8, 1, 1, 32, 16, 1856)
    assert bk.dblocks_plan(torch.float32, 1, 29568, 256, 32, 32,
                           132).args == (4, 32, 32, 9, 3296)


@pytest.mark.cuda
def test_bdmm_refuses_what_it_does_not_take(cuda):
    """b = 256 runs and matches the plain version (there is no block-size
    limit); the wrapper refuses other dtypes and strided inputs, and an
    empty input launches nothing."""
    rng = np.random.default_rng(256)
    x, blocks = _bdmm_inputs(rng, 1, 24, 2, 256, 256, cuda, torch.float32)
    assert (bk.bdmm(x, blocks) - bk.bdmm_plain(x, blocks)).abs().max() <= F32_TOL
    _assert_grads_close(bk.bdmm_dblocks(x, x, 256, 256),
                        bk.bdmm_dblocks_plain(x, x, 256, 256), "dblocks")
    blocks = torch.zeros((1, 8, 8, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        bk.bdmm(torch.zeros((1, 2, 64), device=cuda, dtype=torch.float16),
                blocks)
    x = torch.zeros((1, 64, 2), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bk.bdmm(x, torch.zeros((1, 8, 8, 8), device=cuda))
    before = bk.bdmm.launches
    assert bk.bdmm(torch.zeros((1, 0, 64), device=cuda),
                   torch.zeros((1, 8, 8, 8), device=cuda)).shape == (1, 0, 64)
    assert bk.bdmm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bdmm_diff_runs_the_kernels_both_ways(cuda, dtype):
    """bdmm_diff gradients against autograd of the plain version on the
    card; dx launches bdmm only when the input needs a gradient."""
    rng = np.random.default_rng(29)
    x, blocks = _bdmm_inputs(rng, 2, 45, 24, 8, 8, cuda, dtype)
    cot = torch.from_numpy(rng.normal(size=(2, 45, 24 * 8)).astype(np.float32))
    cot = cot.to(cuda)
    grads = []
    for f in (dispatch.bdmm_diff, lambda b, v: bk.ref.bdmm_banked_ref(b, v)):
        args = [blocks.clone().requires_grad_(), x.clone().requires_grad_()]
        y = f(*args)
        grads.append(torch.autograd.grad((y.float() * cot).sum(), args))
    tol = GRAD_REL if dtype == torch.float32 else 2.0 ** -5
    for name, got, want in zip(("dblocks", "dx"), *grads):
        assert got.dtype == want.dtype == dtype
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale, name
    counts = (bk.bdmm.launches, bk.bdmm_dblocks.launches)
    wb = blocks.clone().requires_grad_()
    (dispatch.bdmm_diff(wb, x).float() * cot).sum().backward()
    # forward + dblocks; no dx launch for a frozen input
    assert (bk.bdmm.launches, bk.bdmm_dblocks.launches) == \
        (counts[0] + 1, counts[1] + 1)
    xx = x.clone().requires_grad_()
    (dispatch.bdmm_diff(wb.detach().requires_grad_(), xx).float()
     * cot).sum().backward()
    assert (bk.bdmm.launches, bk.bdmm_dblocks.launches) == \
        (counts[0] + 3, counts[1] + 2)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    """On the card the wrappers launch the kernels: with the plain versions
    made to raise, the bdmm path still runs, forward and backward."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    for name in ("bdmm_banked_ref", "bdmm_dblocks_ref", "bdmm_ref"):
        monkeypatch.setattr(bk.ref, name, boom)
    rng = np.random.default_rng(3)
    x, blocks = _bdmm_inputs(rng, 1, 20, 8, 16, 16, cuda, torch.float32)
    xx = x.requires_grad_()
    wb = blocks.requires_grad_()
    dispatch.bdmm_diff(wb, xx).sum().backward()
    torch.cuda.synchronize()
    assert wb.grad is not None and xx.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bdmm_diff_reads_transposed_blocks_both_ways(cuda, dtype):
    """bdmm_diff with transpose_blocks against autograd of the plain version
    on the card: one forward, one dblocks and one dx launch, as without."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=(3, 40, 6 * 16)).astype(np.float32))
    stored = torch.from_numpy(rng.normal(0, 0.25, size=(3, 6, 16, 24))
                              .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(3, 40, 6 * 24)).astype(np.float32))
    x, stored, cot = x.to(cuda, dtype), stored.to(cuda, dtype), cot.to(cuda)
    grads = []
    for f in (lambda b, v: dispatch.bdmm_diff(b, v, transpose_blocks=True),
              lambda b, v: bk.ref.bdmm_banked_ref(b, v, transpose_blocks=True)):
        args = [stored.clone().requires_grad_(), x.clone().requires_grad_()]
        grads.append(torch.autograd.grad((f(*args).float() * cot).sum(), args))
    tol = GRAD_REL if dtype == torch.float32 else 2.0 ** -5
    for name, got, want in zip(("dblocks", "dx"), *grads):
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale, name
    counts = (bk.bdmm.launches, bk.bdmm_dblocks.launches)
    args = [stored.clone().requires_grad_(), x.clone().requires_grad_()]
    (dispatch.bdmm_diff(*args, transpose_blocks=True).float()
     * cot).sum().backward()
    assert (bk.bdmm.launches, bk.bdmm_dblocks.launches) == \
        (counts[0] + 2, counts[1] + 1)


def test_bdmm_takes_any_block_size():
    """No block-size limit in the wrapper's checks: b = 256 and (64, 512)
    pass them (the plain version on the CPU, a route of the kernels on the
    card), blocks read transposed too."""
    rng = np.random.default_rng(7)
    for bo, bi in ((256, 256), (64, 512), (512, 64)):
        x, blocks = _bdmm_inputs(rng, 2, 5, 2, bo, bi, "cpu", torch.float32)
        assert torch.equal(bk.bdmm(x, blocks), bk.bdmm_plain(x, blocks))
        tb = blocks.transpose(-1, -2).contiguous()
        # the same sums, read through a strided view (another order)
        torch.testing.assert_close(bk.bdmm(x, tb, transpose_blocks=True),
                                   bk.bdmm_plain(x, blocks), rtol=1e-6,
                                   atol=1e-6)
        dy = torch.from_numpy(rng.normal(size=(2, 5, 2 * bo)).astype(np.float32))
        assert torch.equal(bk.bdmm_dblocks(dy, x, bo, bi),
                           bk.bdmm_dblocks_plain(dy, x, bo, bi))
        for dtype in (torch.float32, torch.bfloat16):
            for t in (1, 5, 300):
                for trans in (False, True):
                    _within_limits(bk.bdmm_plan(dtype, 2, t, 2, bo, bi, 132,
                                                trans))
                _within_limits(bk.dblocks_plan(dtype, 2, t, 2, bo, bi, 132))
    with pytest.raises(ValueError, match="shape mismatch"):
        bk.bdmm(x, blocks, transpose_blocks=True)


def test_bdmm_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    x, blocks = _bdmm_inputs(rng, 2, 3, 4, 8, 8, "cpu", torch.float32)
    before = (bk.bdmm.launches, bk.bdmm_dblocks.launches)
    assert torch.equal(bk.bdmm(x, blocks), bk.bdmm_plain(x, blocks))
    dy = torch.ones((2, 3, 32))
    assert torch.equal(bk.bdmm_dblocks(dy, x, 8, 8),
                       bk.bdmm_dblocks_plain(dy, x, 8, 8))
    assert (bk.bdmm.launches, bk.bdmm_dblocks.launches) == before
    with pytest.raises(ValueError, match="shape mismatch"):
        bk.bdmm(torch.zeros((2, 3, 30)), blocks)
    with pytest.raises(TypeError, match="one dtype"):
        bk.bdmm(x, blocks.double())
    with pytest.raises(ValueError, match="expected dy"):
        bk.bdmm_dblocks(dy[:, :2], x, 8, 8)


# ---------------------------------------------------------------------------
# the GS-class library on the card: its block products are bdmm launches
# ---------------------------------------------------------------------------

from repro_torch.core import gs as tgs  # noqa: E402
from repro_torch.core.permutations import PermSpec  # noqa: E402


def _gs_layouts():
    """GSOFT's square layout, one with rectangular blocks on both factors
    (L: 8 blocks of 24 x 48, R: 12 of 32 x 16) and one with 64-row blocks
    against 16-column ones (the shapes the tensor-core route takes)."""
    return {
        "gsoft": tgs.gsoft_layout(256, 32),
        "rect": tgs.GSLayout(tgs.BlockDiagSpec(8, 24, 48),
                             tgs.BlockDiagSpec(12, 32, 16),
                             PermSpec.identity(), PermSpec.gs(8),
                             PermSpec.gs_inv(12)),
        "wide": tgs.GSLayout(tgs.BlockDiagSpec(4, 64, 32),
                             tgs.BlockDiagSpec(8, 16, 16),
                             PermSpec.gs_inv(4), PermSpec.gs(4),
                             PermSpec.identity()),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gsoft", "rect", "wide"])
@pytest.mark.parametrize("t", [1, 16, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gs_apply_and_matmul_run_bdmm_against_their_plain_versions(
        cuda, monkeypatch, name, t, dtype):
    """gs_apply, gs_apply_T and gs_matmul on CUDA tensors launch the bdmm
    kernel twice each (one per factor) and never its plain version; the
    same calls on CPU tensors (the plain versions) agree to the bdmm
    tolerances."""
    lay = _gs_layouts()[name]
    rng = np.random.default_rng(t + len(name))
    L = torch.from_numpy(rng.normal(0, 0.2, size=lay.lspec.param_shape)
                         .astype(np.float32))
    R = torch.from_numpy(rng.normal(0, 0.2, size=lay.rspec.param_shape)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, t, lay.in_dim))
                         .astype(np.float32))
    xo = torch.from_numpy(rng.normal(size=(2, t, lay.out_dim))
                          .astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(lay.in_dim, 24)).astype(np.float32))
    calls = {
        "gs_apply": lambda L, R, x, xo, W: tgs.gs_apply(lay, L, R, x),
        "gs_apply_T": lambda L, R, x, xo, W: tgs.gs_apply_T(lay, L, R, xo),
        "gs_matmul": lambda L, R, x, xo, W: tgs.gs_matmul(lay, L, R, W),
    }
    plain = []
    real_plain = bk.bdmm_plain
    monkeypatch.setattr(bk, "bdmm_plain",
                        lambda *a, **k: plain.append(1) or real_plain(*a, **k))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for what, fn in calls.items():
        dev_args = [a.to(cuda, dtype) for a in (L, R, x, xo, W)]
        before = bk.bdmm.launches
        y = fn(*dev_args)
        torch.cuda.synchronize()
        assert bk.bdmm.launches == before + 2, what
        assert not plain, what
        want = fn(*[a.to(dtype) for a in (L, R, x, xo, W)])
        plain.clear()
        assert torch.isfinite(y.float()).all()
        err = (y.float().cpu() - want.float()).abs().max().item()
        assert err <= tol * max(1.0, want.float().abs().max().item()), (
            what, err)


@pytest.mark.cuda
def test_gs_factors_apply_runs_one_bdmm_per_factor(cuda):
    f = tgs.gs_order_layout(512, 8, 3)
    rng = np.random.default_rng(3)
    blocks = [torch.from_numpy(rng.normal(0, 0.3, size=s.param_shape)
                               .astype(np.float32)) for s in f.specs]
    x = torch.from_numpy(rng.normal(size=(3, 512)).astype(np.float32))
    before = bk.bdmm.launches
    y = tgs.gs_factors_apply(f, [b.to(cuda) for b in blocks], x.to(cuda))
    torch.cuda.synchronize()
    assert bk.bdmm.launches == before + 3
    want = tgs.gs_factors_apply(f, blocks, x)
    assert (y.cpu() - want).abs().max().item() <= F32_TOL * max(
        1.0, want.abs().max().item())


# ---------------------------------------------------------------------------
# quantized matmuls and paged decode attention
# ---------------------------------------------------------------------------

from repro_torch import quant  # noqa: E402
from repro_torch.kernels import paged_attention as pak  # noqa: E402
from repro_torch.kernels import q_matmul as qmk  # noqa: E402

# q_matmul f32: fp32 sums in another order (allclose atol = rtol, as the JAX
# test); bf16: both round y once from near-equal fp32 sums, one bf16 ulp
QMM_F32_TOL = 1e-4
QMM_BF16_REL = 2.0 ** -7
# gs_q_matmul bf16: the kernel keeps the rotation's intermediate in fp32,
# the plain version rounds it to bf16, and the rotated slab's bf16 rounding
# can then differ by one ulp before the int8 product
GSQ_BF16_REL = 2.0 ** -6
GSQ_F32_REL = 1e-4
# paged decode: f32 as tests/test_kv.py; bf16 against the plain version's
# single fp32 softmax, which rounds neither q * scale nor p
PAGED_F32_TOL = 2e-5
PAGED_BF16_REL = 2.0 ** -6

# (M, K, N): decode rows T = 1 and 3 (K split over CTAs at N = 1024), one
# prefill chunk T = 16 at the MLP width, ragged N (byte loads), token tiles
QMM_CASES = [(1, 8192, 1024), (3, 8192, 8192), (16, 29568, 1024),
             (4, 64, 40), (16, 8192, 1000), (2, 100, 130), (33, 48, 96),
             (250, 24, 40), (8, 256, 512)]
# (B, T, r, b, N): decode at d = 8192 and d = 29568, a prefill chunk with
# ragged N, tiny and odd shapes (N not a multiple of 4)
GSQ_CASES = [(4, 1, 256, 32, 1024), (1, 16, 256, 32, 1000),
             (4, 1, 924, 32, 8192), (2, 3, 6, 4, 40), (3, 5, 3, 16, 24),
             (1, 9, 2, 32, 130)]
# (B, H, K, D, page, pages in the pool, table width W): qwen2-72b's heads
# at the serve phase's tables, 4096 keys a row at page 16 (the rows split
# over a cluster), GQA groups past 8 and odd, D of 256 and one that is no
# multiple of 16 (bf16) or of 8 (both dtypes: element loads)
PAGED_CASES = [(4, 64, 8, 128, 8, 40, 18), (4, 64, 8, 128, 16, 24, 9),
               (3, 4, 2, 16, 8, 11, 5), (2, 6, 3, 32, 16, 7, 3),
               (4, 64, 8, 128, 16, 300, 256), (2, 24, 2, 64, 8, 50, 40),
               (2, 16, 4, 256, 16, 30, 20), (3, 6, 2, 40, 8, 20, 12),
               (2, 4, 2, 20, 32, 9, 6)]


def _codes(rng, k, n):
    w = rng.normal(size=(k, n)).astype(np.float32)
    return quant.quantize_int8(torch.from_numpy(w), axis=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QMM_CASES, ids=lambda c: "M%d-K%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q_matmul_kernel_matches_plain(cuda, case, dtype):
    m, k, n = case
    rng = np.random.default_rng(m * 31 + n)
    q, s = _codes(rng, k, n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         / np.sqrt(k))
    x, q, s = x.to(cuda, dtype), q.to(cuda), s.to(cuda)
    before = qmk.q_matmul.launches
    y = qmk.q_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qmk.q_matmul.launches == before + 1
    want = qmk.q_matmul_plain(x, q, s)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=QMM_F32_TOL,
                                   rtol=QMM_F32_TOL)
    else:
        err = (y.float() - want.float()).abs().max().item()
        assert err <= QMM_BF16_REL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", GSQ_CASES,
                         ids=lambda c: "B%d-T%d-r%d-b%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gs_q_matmul_kernel_matches_plain(cuda, case, dtype):
    bsz, t, r, b, n = case
    rng = np.random.default_rng(bsz * 100 + t * 10 + r + n)
    q, s = _codes(rng, r * b, n)
    L, R = _factors(rng, bsz, r, b), _factors(rng, bsz, r, b)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * b)).astype(np.float32)
                         / np.sqrt(r * b))
    x, L, R = (a.to(cuda, dtype) for a in (x, L, R))
    q, s = q.to(cuda), s.to(cuda)
    before = qmk.gs_q_matmul.launches
    y = qmk.gs_q_matmul(x, L, R, q, s)
    torch.cuda.synchronize()
    assert qmk.gs_q_matmul.launches == before + 1
    want = qmk.gs_q_matmul_plain(x, L, R, q, s)
    assert y.shape == (bsz, t, n) and torch.isfinite(y.float()).all()
    rel = GSQ_F32_REL if dtype == torch.float32 else GSQ_BF16_REL
    err = (y.float() - want.float()).abs().max().item()
    assert err <= rel * max(1.0, want.float().abs().max().item())


# ---------------------------------------------------------------------------
# the banked serving rotations: gs_fused_T's route 1 (csrc/gs_fused_T.cu
# gs_T_tc) and the bank read by slot id; gs_q_matmul's chained product
# ---------------------------------------------------------------------------

# (B, T, r) at b = 32, bf16, per-row factors: decode rows and every prefill
# bucket at d = 8192 and d = 29568 (b not dividing r), the dx slab of the GS
# backward (T = 29568), Double GSOFT's output sides (T = 8192 at r = 32, 256
# and 924), ragged T, rows with their own factors, windows that wrap (r =
# 33, 40, 63), d past 32768 (r = 1056, 1040)
T_TC_CASES = [(4, 1, 256), (1, 16, 256), (1, 32, 256), (1, 64, 256),
              (1, 128, 256), (4, 1, 924), (1, 16, 924), (1, 64, 924),
              (1, 128, 924), (1, 29568, 256), (1, 8192, 32), (1, 8192, 256),
              (1, 8192, 924), (1, 1000, 256), (1, 77, 924), (3, 5, 33),
              (2, 300, 40), (1, 1000, 63), (4, 1, 1056), (1, 40, 1056),
              (2, 9, 1040)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", T_TC_CASES, ids=lambda c: "B%d-T%d-r%d" % c)
def test_transpose_route1_matches_plain_and_reruns_bit_identical(cuda, case):
    bsz, t, r = case
    rng = np.random.default_rng(bsz * 1000 + t + r)
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * 32)).astype(np.float32))
    L, R = _factors(rng, bsz, r, 32), _factors(rng, bsz, r, 32)
    x, L, R = (a.to(cuda, torch.bfloat16) for a in (x, L, R))
    assert gk.t_plan(bsz, t, r, 32, "bf16", gk._num_sms(cuda)).route == "tc"
    before = gk.gs_fused_T.launches
    y = gk.gs_fused_T(x, L, R)
    torch.cuda.synchronize()
    assert gk.gs_fused_T.launches == before + 1
    want = gk.gs_fused_T_plain(x, L, R)
    assert torch.isfinite(y.float()).all()
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL
    assert torch.equal(gk.gs_fused_T(x, L, R), y)


def _bank(rng, slots, r, b):
    """fp32 (A, r, b, b) orthogonal blocks with the identity in slot 0."""
    L, R = _factors(rng, slots, r, b), _factors(rng, slots, r, b)
    L[0] = R[0] = torch.eye(b)
    return L, R


# (T, r, b, x dtype, bank dtype): decode rows and a prefill bucket of the
# qwen2-72b widths on route 1 from an fp32 bank (bf16 x) and from a bf16
# bank; route 2 from an fp32 bank with f32 x and with bf16 x at b = 128
BANK_CASES = [(1, 256, 32, torch.bfloat16, torch.float32),
              (16, 256, 32, torch.bfloat16, torch.float32),
              (1, 924, 32, torch.bfloat16, torch.float32),
              (16, 924, 32, torch.bfloat16, torch.bfloat16),
              (1, 1056, 32, torch.bfloat16, torch.float32),
              (1, 256, 32, torch.float32, torch.float32),
              (3, 924, 32, torch.float32, torch.float32),
              (1, 64, 128, torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BANK_CASES, ids=lambda c: "T%d-r%d-b%d-%s-%s" % (
    c[:3] + tuple(str(a).split(".")[1] for a in c[3:])))
def test_transpose_bank_reads_slot_ids_on_the_device(cuda, case):
    """gs_fused_T_bank against the gather, cast and plain version: repeated
    slot ids, the identity slot 0 (x back bit for bit), fp32 bank entries
    rounded to bf16 in registers, one launch counted on both counters, and
    the same y from a non-default stream."""
    t, r, b, xdt, bdt = case
    rng = np.random.default_rng(t + r + b)
    Lb, Rb = (a.to(cuda, bdt) for a in _bank(rng, 4, r, b))
    x = torch.from_numpy(rng.normal(size=(4, t, r * b)).astype(np.float32))
    x[2] = x[0]
    x = x.to(cuda, xdt)
    ids = torch.tensor([2, 0, 2, 3], dtype=torch.int64, device=cuda)
    before = (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches)
    y = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    torch.cuda.synchronize()
    assert (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches) == \
        (before[0] + 1, before[1] + 1)
    want = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    tol = F32_TOL if xdt == torch.float32 else BF16_TOL
    assert (y.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(y[1], x[1]) and torch.equal(y[0], y[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    side.synchronize()
    assert torch.equal(again, y)


# (B, T, r, b, N): decode rows of wq (d = N = 8192), of wk / wv (N = 1024:
# K split over a cluster), the MLP wo input (d = 29568, b not dividing r),
# a prefill chunk with ragged N, two 16-token tiles, d past 32768, tiny
# shapes with N not a multiple of 16 (byte-wise code loads) and b != 32
GSQ_BANK_CASES = [(4, 1, 256, 32, 8192), (4, 1, 256, 32, 1024),
                  (4, 1, 924, 32, 8192), (1, 16, 256, 32, 1000),
                  (1, 32, 256, 32, 512), (4, 1, 1056, 32, 256),
                  (2, 3, 6, 4, 40), (3, 5, 3, 16, 24), (1, 9, 2, 32, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,dtype",
    # f32 rotates on route 2 (past d = 32768 through its wide passes)
    [(c, dt) for c in GSQ_BANK_CASES for dt in (torch.float32, torch.bfloat16)],
    ids=lambda v: ("B%d-T%d-r%d-b%d-N%d" % v if isinstance(v, tuple)
                   else str(v).split(".")[1]))
def test_gs_q_matmul_bank_is_one_call_and_matches_plain(cuda, case, dtype):
    """The rotation and the product behind it count one launch of
    gs_q_matmul (and none of gs_fused_T), match the gather + plain version,
    and rerun bit-identically (the K split adds in rank order)."""
    bsz, t, r, b, n = case
    rng = np.random.default_rng(bsz * 100 + t * 10 + r + n)
    q, s = _codes(rng, r * b, n)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, 4, r, b))
    x = torch.from_numpy(rng.normal(size=(bsz, t, r * b)).astype(np.float32)
                         / np.sqrt(r * b)).to(cuda, dtype)
    ids = torch.tensor([3, 0, 1, 3][:bsz], dtype=torch.int64, device=cuda)
    q, s = q.to(cuda), s.to(cuda)
    before = (qmk.gs_q_matmul.launches, qmk.gs_q_matmul.slot_launches,
              gk.gs_fused_T.launches)
    y = qmk.gs_q_matmul_bank(x, Lb, Rb, ids, q, s)
    torch.cuda.synchronize()
    assert (qmk.gs_q_matmul.launches, qmk.gs_q_matmul.slot_launches,
            gk.gs_fused_T.launches) == (before[0] + 1, before[1] + 1,
                                        before[2])
    want = qmk.gs_q_matmul_bank_plain(x, Lb, Rb, ids, q, s)
    assert y.shape == (bsz, t, n) and torch.isfinite(y.float()).all()
    rel = GSQ_F32_REL if dtype == torch.float32 else GSQ_BF16_REL
    err = (y.float() - want.float()).abs().max().item()
    assert err <= rel * max(1.0, want.float().abs().max().item())
    assert torch.equal(qmk.gs_q_matmul_bank(x, Lb, Rb, ids, q, s), y)


def test_gsq_plan_splits_k_when_the_columns_do_not_fill_the_card():
    # wk / wv at decode: 8 column tiles of 128 would leave most SMs idle
    ntok, nt, splits, per = qmk.gsq_plan(4, 8192, 1024, 132)
    assert (ntok, nt, splits, per) == (8, 32, 8, 1024)
    assert qmk.gsq_plan(4, 8192, 29568, 132)[1:3] == (128, 8)
    assert qmk.gsq_plan(16, 8192, 8192, 132)[:2] == (16, 64)


def _paged_inputs(rng, case, device, dtype):
    bsz, h, kh, d, page, npages, w = case
    q = torch.from_numpy(rng.normal(size=(bsz, h, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(npages, page, kh, d))
                               .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.integers(1, npages, size=(bsz, w))
                             .astype(np.int32))
    # one row at one token, one mid-page, one full table, and a parked row
    # whose kv_len runs past W * page (no page past column W - 1 is read)
    lens = [1, page + 3, w * page, w * page + 1][:bsz]
    kv_len = torch.tensor(lens + [2] * (bsz - len(lens)), dtype=torch.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            table.to(device), kv_len.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: "B%d-H%d-K%d-D%d-page%d-P%d-W%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_kernel_matches_plain(cuda, case, dtype):
    rng = np.random.default_rng(sum(case))
    args = _paged_inputs(rng, case, cuda, dtype)
    before = pak.paged_decode.launches
    out = pak.paged_decode(*args)
    torch.cuda.synchronize()
    assert pak.paged_decode.launches == before + 1
    want = pak.paged_decode_plain(*args)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= PAGED_F32_TOL * max(1.0, want.abs().max().item())
    else:
        assert err <= PAGED_BF16_REL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [3, 32], ids=["one-split", "split"])
def test_paged_decode_reads_no_page_past_the_table(cuda, w):
    """A parked row's table holds only the garbage page: poisoning every
    other page must not change its output. With the row split over a
    cluster (W = 32: 4 CTAs a row), a row of 70 keys reads only the pages
    of its first 9 columns: poisoning the pages of the others leaves it as
    it was."""
    rng = np.random.default_rng(11)
    q, kp, vp, table, kv_len = _paged_inputs(
        rng, (2, 4, 2, 16, 8, 2 * w + 1, w), cuda, torch.float32)
    table[0] = torch.arange(1, w + 1)
    kv_len[0] = min(70, w * 8)
    table[1] = 0
    kv_len[1] = w * 8 + 1
    plan = pak.paged_plan(2, 2, w, 8, w * 8, pak._num_sms(cuda), groups=2,
                          d=16)
    assert (plan["splits"] > 1) == (w == 32)
    first = pak.paged_decode(q, kp, vp, table, kv_len)
    live = -(-int(kv_len[0]) // 8)
    kp[table[0, live:].long()] = float("nan")
    vp[table[0, live:].long()] = float("nan")
    kp[w + 1:] = float("nan")
    vp[w + 1:] = float("nan")
    mid = pak.paged_decode(q, kp, vp, table, kv_len)
    assert torch.equal(first, mid)
    kp[1:] = float("nan")
    vp[1:] = float("nan")
    again = pak.paged_decode(q, kp, vp, table, kv_len)
    assert torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_splits_rows_over_a_cluster(cuda, dtype):
    """qwen2-72b's heads at 4096 keys a row, page 16: 4 CTAs a row; beside
    them a row shorter than one split (its other splits empty), a row of
    one token and a parked row (all columns the garbage page). Equal to the
    plain version, one launch, and equal to itself with kv_len as int32 or
    int64 and the table as a strided view."""
    bsz, h, kh, d, page, w = 4, 64, 8, 128, 16, 256
    rng = np.random.default_rng(21)
    q, kp, vp, table, kv_len = _paged_inputs(
        rng, (bsz, h, kh, d, page, 2 * w + 1, w), cuda, dtype)
    table[:] = torch.arange(1, bsz * w + 1).reshape(bsz, w) % (2 * w) + 1
    table[3] = 0
    kv_len[:] = torch.tensor([4096, 70, 1, w * page + 1])
    plan = pak.paged_plan(bsz, kh, w, page, w * page, pak._num_sms(cuda))
    assert plan["splits"] > 1 and plan["ctas"] <= pak._num_sms(cuda)
    # 70 keys: the first two splits take pages 0-3 and 4, the others none
    spans = pak.paged_split(70, w, page, plan["splits"])
    assert [e - b for b, e in spans] == [64, 6] + [0] * (plan["splits"] - 2)
    before = pak.paged_decode.launches
    out = pak.paged_decode(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    assert pak.paged_decode.launches == before + 1
    want = pak.paged_decode_plain(q, kp, vp, table, kv_len)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= PAGED_F32_TOL * max(1.0, want.abs().max().item())
    else:
        assert err <= PAGED_BF16_REL * want.float().abs().max().item()
    wide = torch.zeros((bsz, w + 1), dtype=torch.int32, device=cuda)
    wide[:, :w] = table
    assert torch.equal(pak.paged_decode(q, kp, vp, wide[:, :-1],
                                        kv_len.long()), out)


@pytest.mark.cuda
def test_quantized_and_paged_kernels_refuse_gradients(cuda):
    x = torch.zeros((2, 8), device=cuda, requires_grad=True)
    q = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="inference only"):
        qmk.q_matmul(x, q, torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        qmk.q_matmul(torch.zeros((8, 2), device=cuda).t(), q, 1.0)
    with pytest.raises(RuntimeError, match="inference only"):
        pak.paged_decode(torch.zeros((1, 2, 4), device=cuda,
                                     requires_grad=True),
                         torch.zeros((2, 8, 1, 4), device=cuda),
                         torch.zeros((2, 8, 1, 4), device=cuda),
                         torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                         torch.ones(1, dtype=torch.int32, device=cuda))


def test_quantized_and_paged_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(2)
    q, s = _codes(rng, 32, 24)
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32))
    L, R = _factors(rng, 1, 4, 8), _factors(rng, 1, 4, 8)
    before = (qmk.q_matmul.launches, qmk.gs_q_matmul.launches,
              pak.paged_decode.launches)
    assert torch.equal(qmk.q_matmul(x, q, s), qmk.q_matmul_plain(x, q, s))
    assert torch.equal(qmk.gs_q_matmul(x[None], L, R, q, s),
                       qmk.gs_q_matmul_plain(x[None], L, R, q, s))
    args = _paged_inputs(rng, (2, 4, 2, 16, 8, 6, 3), "cpu", torch.float32)
    assert torch.equal(pak.paged_decode(*args), pak.paged_decode_plain(*args))
    # the slot-id entries: a CPU tensor gathers and runs the plain versions
    slot_before = (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches,
                   qmk.gs_q_matmul.slot_launches)
    Lb, Rb = _bank(rng, 3, 4, 8)
    ids = torch.tensor([2, 2], dtype=torch.int64)
    xb = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
    assert torch.equal(qmk.gs_q_matmul_bank(xb, Lb, Rb, ids, q, s),
                       qmk.gs_q_matmul_bank_plain(xb, Lb, Rb, ids, q, s))
    assert torch.equal(gk.gs_fused_T_bank(xb, Lb, Rb, ids),
                       gk.gs_fused_T_bank_plain(xb, Lb, Rb, ids))
    assert (qmk.q_matmul.launches, qmk.gs_q_matmul.launches,
            pak.paged_decode.launches) == before
    assert (gk.gs_fused_T.launches, gk.gs_fused_T.slot_launches,
            qmk.gs_q_matmul.slot_launches) == slot_before


# ---------------------------------------------------------------------------
# the SSD chunked scan and flash attention
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as ssdk  # noqa: E402

# ssd, relative to max|ref| as tests/test_kernels.py's tolerances: f32 sums
# in another order and another chunk (the kernel's 64 against the plain
# version's largest divisor <= 256); bf16 y rounded once by both
SSD_F32_REL = 1e-4
SSD_BF16_REL = 5e-2
# flash, allclose atol = rtol as tests/test_flash_attention.py: f32 sums in
# another order; bf16 p rounded to bf16 before p . v (the TPU kernel's step)
FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2

# (Nb, T, H, P, N): zamba2 (80 heads, P = N = 64) and mamba2-130m (24
# heads, N = 128) at prefill buckets, the carried state over 32 chunks, a T
# that is no multiple of the chunk (JAX's halving path: chunk 8), batch 4
# with P split over CTAs, and the shapes of tests/test_kernels.py
SSD_CASES = [(1, 16, 80, 64, 64), (1, 128, 80, 64, 64), (1, 64, 24, 64, 128),
             (1, 2048, 8, 64, 64), (1, 1000, 4, 64, 128), (4, 300, 6, 16, 32),
             (4, 128, 80, 64, 64), (1, 32, 2, 8, 8), (1, 48, 2, 8, 8),
             (1, 16, 3, 4, 4), (2, 5, 3, 20, 12)]
# (B, H, KH, Sq, Sk, D, causal): qwen2-72b heads (64 / 8, D 128) and
# zamba2's (32 / 32, D 80), long causal, ragged causal Sq, Sq != Sk, the
# shapes of tests/test_flash_attention.py; gemma-7b's D = 256 and D = 320
# (the output features split over CTAs: 2 and 3 chunks), causal, not and
# ragged causal; D = 160 and 72 (padded to 16), 20 and 21 (element loads)
FLASH_CASES = [(1, 64, 8, 128, 128, 128, True), (1, 64, 8, 512, 512, 128, False),
               (1, 32, 32, 512, 512, 80, True), (1, 32, 32, 128, 128, 80, False),
               (1, 8, 8, 2048, 2048, 64, True), (1, 4, 4, 1000, 1000, 64, True),
               (2, 4, 2, 64, 128, 16, False), (2, 2, 2, 64, 64, 16, True),
               (3, 3, 3, 100, 100, 16, True), (2, 2, 2, 32, 32, 64, True),
               (1, 1, 1, 256, 256, 16, True), (1, 2, 1, 70, 130, 32, True),
               (1, 16, 16, 512, 512, 256, True), (1, 4, 2, 256, 256, 256, False),
               (2, 2, 1, 300, 300, 256, True), (1, 4, 4, 256, 256, 320, True),
               (1, 2, 1, 256, 256, 320, False), (1, 2, 2, 200, 200, 320, True),
               (1, 2, 2, 130, 130, 160, True), (1, 2, 1, 100, 100, 72, True),
               (1, 2, 2, 70, 70, 20, True), (1, 2, 1, 65, 65, 21, False)]


def _ssd_inputs(rng, case, device, dtype):
    nb, t, h, p, n = case
    x = rng.normal(size=(nb, t, h, p))
    loga = -np.abs(rng.normal(size=(nb, t, h))) * 0.3
    B = rng.normal(size=(nb, t, h, n)) * 0.5
    C = rng.normal(size=(nb, t, h, n)) * 0.5
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype)
            for a in (x, loga, B, C)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "Nb%d-T%d-H%d-P%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    args = _ssd_inputs(np.random.default_rng(sum(case)), case, cuda, dtype)
    before = ssdk.ssd.launches
    y = ssdk.ssd(*args)
    torch.cuda.synchronize()
    assert ssdk.ssd.launches == before + 1
    want = ssdk.ssd_plain(*args)
    assert y.dtype == dtype and y.shape == want.shape
    assert torch.isfinite(y.float()).all()
    err = (y.float() - want.float()).abs().max().item()
    rel = SSD_F32_REL if dtype == torch.float32 else SSD_BF16_REL
    assert err <= rel * want.float().abs().max().item()


@pytest.mark.cuda
def test_ssd_kernel_carries_the_state_exactly(cuda):
    """The first chunks of a long row do not depend on what follows, and
    the 3-D entry point is one row of the batched one."""
    x, la, B, C = _ssd_inputs(np.random.default_rng(5), (2, 512, 8, 64, 64),
                              cuda, torch.float32)
    full = ssdk.ssd(x, la, B, C)
    head = ssdk.ssd(x[:, :128].contiguous(), la[:, :128].contiguous(),
                    B[:, :128].contiguous(), C[:, :128].contiguous())
    assert torch.equal(full[:, :128], head)
    assert torch.equal(ops.ssd(x[1], la[1], B[1], C[1]), full[1])


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    """Mixed dtypes and a missing batch dim are refused; so is a backward
    past the backward kernel's widest head (P > 64), which raises rather
    than fall back to autograd of the plain scan."""
    x, la, B, C = _ssd_inputs(np.random.default_rng(1), (1, 8, 2, 4, 4),
                              cuda, torch.float32)
    wide = _ssd_inputs(np.random.default_rng(1), (1, 8, 2, 65, 4), cuda,
                       torch.float32)
    with pytest.raises(ValueError, match="head width"):
        ssdk.ssd_bwd(*wide, torch.ones_like(wide[0]))
    with pytest.raises(TypeError, match="one dtype"):
        ssdk.ssd(x.detach(), la.double(), B, C)
    with pytest.raises(ValueError, match="expected x"):
        ssdk.ssd(x.detach()[0], la, B, C)


# ssd_bwd, each gradient relative to its own max|ref| (autograd through the
# plain scan in fp32 on the same values): f32 sums in other orders; bf16
# gradients rounded once to bf16 (2^-8)
SSD_BWD_F32_REL = 1e-4
SSD_BWD_BF16_REL = 2e-2
# (Nb, T, H, P, N): zamba2's training shape, mamba2-130m's heads, a ragged
# T = 1000, N = MAX_N, one chunk, T shorter than a chunk with odd widths
SSD_BWD_CASES = [(2, 256, 80, 64, 64), (1, 512, 24, 64, 128),
                 (1, 1000, 4, 64, 64), (1, 256, 4, 64, 256),
                 (1, 64, 1, 8, 16), (2, 5, 3, 20, 12), (3, 200, 2, 12, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES,
                         ids=lambda c: "Nb%d-T%d-H%d-P%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_bwd_kernel_matches_plain_autograd(cuda, case, dtype):
    rng = np.random.default_rng(sum(case) + 7)
    args = _ssd_inputs(rng, case, cuda, dtype)
    dy = torch.from_numpy(rng.normal(size=case[:4]).astype(np.float32)).to(
        cuda, dtype)
    before = ssdk.ssd_bwd.launches
    got = ssdk.ssd_bwd(*args, dy)
    torch.cuda.synchronize()
    assert ssdk.ssd_bwd.launches == before + 1
    want = ssdk.ssd_bwd_plain(*(a.float() for a in args), dy.float())
    rel = SSD_BWD_F32_REL if dtype == torch.float32 else SSD_BWD_BF16_REL
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        assert (g.float() - w).abs().max().item() <= \
            rel * w.abs().max().item()


@pytest.mark.cuda
def test_ssd_needing_a_gradient_runs_the_backward_kernel(cuda):
    """A CUDA input that needs a gradient goes through the autograd rule:
    one forward launch (which keeps the chunk states) and one ``ssd_bwd``
    launch, whose gradients are the wrapper's own, bit for bit."""
    args = _ssd_inputs(np.random.default_rng(3), (2, 300, 4, 64, 64), cuda,
                       torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in args]
    f0, b0 = ssdk.ssd.launches, ssdk.ssd_bwd.launches
    y = ops.ssd(*leaves)
    assert ssdk.ssd.launches == f0 + 1 and y.requires_grad
    assert torch.equal(y.detach(), ssdk.ssd(*args))
    dy = torch.randn_like(y)
    y.backward(dy)
    assert ssdk.ssd_bwd.launches == b0 + 1
    want = ssdk.ssd_bwd(*args, dy)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
def test_ssd_bwd_launch_and_build_failures_raise(cuda, monkeypatch, tmp_path):
    """A launch the kernel refuses (a P tile of 0 for the forward's states)
    raises with the CUDA error; a source nvcc cannot build raises too."""
    args = _ssd_inputs(np.random.default_rng(4), (1, 64, 2, 8, 8), cuda,
                       torch.float32)
    states, _ = ssdk.ssd_fwd(*args, states=True)[1]
    with pytest.raises(RuntimeError, match="ssd_bwd launch failed"):
        ssdk.ssd_bwd(*args, torch.ones_like(args[0]), saved=(states, 0))
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("--no-such-flag",))
    monkeypatch.setattr(ssdk, "_BWD_LIB", [])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ssdk.ssd_bwd(*args, torch.ones_like(args[0]))


def test_ssd_geometry_splits_p_only_while_sms_idle():
    """Every chunk of a head is a unit of its own, so P is no longer split
    over CTAs for idle SMs (a narrower tile recomputes C B^T and ran slower
    at every shape measured on the H100): P is cut only into the fewest
    tiles of at most MAX_P_TILE columns."""
    assert ssdk.ssd_geometry(64, 64) == 64          # zamba2
    assert ssdk.ssd_geometry(64, 128) == 64         # mamba2-130m
    assert ssdk.ssd_geometry(4, 4) == 4
    assert ssdk.ssd_geometry(20, 12) == 20
    assert ssdk.ssd_geometry(128, 64) == 64         # two tiles
    assert ssdk.ssd_geometry(80, 64) == 40


@pytest.mark.parametrize("case", [(64, 64, 64), (64, 128, 64), (200, 64, 50),
                                  (64, 256, 64), (128, 256, 64), (16, 256, 16)],
                         ids=lambda c: "P%d-N%d" % c[:2])
def test_ssd_geometry_counts_the_chunks_and_fits_shared_memory(case):
    """A tile is at most MAX_P_TILE columns and a unit of state width N fits
    shared memory; the chunks, each a unit, fill the card."""
    p, n, want = case
    pt = ssdk.ssd_geometry(p, n)
    assert pt == want
    assert pt <= ssdk.MAX_P_TILE and ssdk.ssd_smem(n, pt) <= ssdk.SMEM_LIMIT


# (Nb, T, H, P, N): one step, a chunk short of, exactly and one past 64
# steps, 1000 and 2048 steps (16 and 32 chunks of a chain), batch 4 with
# N = 128, P past the 64-column tile (two tiles) and a P split over CTAs,
# N = 256 (the widest state); units of 16 warps (few units) and of 8 (more
# than two an SM: batch 4 of mamba2-130m's heads at T = 512)
SSD_PAR_CASES = [(1, 1, 8, 64, 64), (1, 63, 8, 64, 64), (1, 64, 8, 64, 64),
                 (1, 65, 8, 64, 64), (1, 1000, 4, 64, 64),
                 (1, 2048, 8, 64, 64), (4, 130, 6, 64, 128),
                 (2, 200, 3, 128, 64), (1, 96, 2, 64, 32), (1, 70, 2, 16, 256),
                 (4, 512, 24, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_PAR_CASES,
                         ids=lambda c: "Nb%d-T%d-H%d-P%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_chunks_in_parallel_match_plain_and_rerun_bit_identical(
        cuda, case, dtype):
    """Every chunk of a chain runs at once and hands the state on: the
    result matches the plain version at the unchanged tolerances, one call
    counts one launch, and a rerun (and one on another stream) is bit for
    bit the same."""
    args = _ssd_inputs(np.random.default_rng(sum(case) + 1), case, cuda, dtype)
    before = ssdk.ssd.launches
    y = ssdk.ssd(*args)
    torch.cuda.synchronize()
    assert ssdk.ssd.launches == before + 1
    want = ssdk.ssd_plain(*args)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    err = (y.float() - want.float()).abs().max().item()
    rel = SSD_F32_REL if dtype == torch.float32 else SSD_BF16_REL
    assert err <= rel * want.float().abs().max().item()
    assert torch.equal(ssdk.ssd(*args), y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = ssdk.ssd(*args)
    side.synchronize()
    assert torch.equal(again, y)


@pytest.mark.cuda
def test_ssd_refuses_a_state_past_the_widest(cuda):
    x, la, B, C = _ssd_inputs(np.random.default_rng(2), (1, 8, 2, 4, 264),
                              cuda, torch.float32)
    with pytest.raises(ValueError, match="state width"):
        ssdk.ssd(x, la, B, C)


# q_matmul's stream at its edges (M, K, N): one decode row at the MLP
# width, four rows at wk / wv (K split over a cluster), a 16-token tile and
# a 17th token (two tiles), N no multiple of the 128-column tile, K no
# multiple of the 64-row stage, K % 8 != 0 (x copied by the producer warp),
# N % 16 != 0 (codes copied by the producer warp)
QMM_EDGE_CASES = [(1, 8192, 29568), (4, 8192, 1024), (16, 8192, 1000),
                  (17, 1000, 1100), (4, 1000, 130), (17, 100, 130),
                  (1, 64, 16), (9, 520, 8200)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", QMM_EDGE_CASES,
                         ids=lambda c: "M%d-K%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["aligned", "offset", "scalar"])
def test_q_matmul_stream_matches_plain_at_its_edges(cuda, case, dtype,
                                                    layout):
    """The TMA ring at ragged edges, codes at a base that is not 16-byte
    aligned ("offset": copied by the producer warp), a scalar scale; one
    launch a call and bit-identical reruns (the K split adds in rank
    order)."""
    m, k, n = case
    rng = np.random.default_rng(m * 7 + k + n)
    q, s = _codes(rng, k, n)
    if layout == "scalar":
        s = 0.02
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         / np.sqrt(k)).to(cuda, dtype)
    q = q.to(cuda)
    if layout == "offset":
        buf = torch.empty(k * n + 1, dtype=torch.int8, device=cuda)
        buf[1:].copy_(q.reshape(-1))
        q = buf[1:].view(k, n)
        assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    if isinstance(s, torch.Tensor):
        s = s.to(cuda)
    before = qmk.q_matmul.launches
    y = qmk.q_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qmk.q_matmul.launches == before + 1
    want = qmk.q_matmul_plain(x, q, s)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=QMM_F32_TOL,
                                   rtol=QMM_F32_TOL)
    else:
        err = (y.float() - want.float()).abs().max().item()
        assert err <= QMM_BF16_REL * want.float().abs().max().item()
    assert torch.equal(qmk.q_matmul(x, q, s), y)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(w, st) for w in (1, 2, 4)
                                  for st in (2, 4, 6, 8)],
                         ids=lambda t: "boxes%d-stages%d" % t)
@pytest.mark.parametrize("case", [(1, 4160, 1100), (17, 1000, 600),
                                  (4, 520, 130)],
                         ids=lambda c: "M%d-K%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q_matmul_every_tile_and_ring_matches_plain(cuda, tile, case, dtype):
    """Every tile width (1, 2, 4 boxes of 128 columns) and ring depth the
    kernel takes, persistent and with K split over a cluster of 3 and of
    up to 16 (past the portable 8), at ragged M, K and N, against the plain
    version; a depth that does not fit an SM is refused by the plan."""
    m, k, n = case
    ntw, stages = tile
    rng = np.random.default_rng(m + k + n + ntw)
    q, s = _codes(rng, k, n)
    q, s = q.to(cuda), qmk.scale_vector(s.to(cuda), n, cuda)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         / np.sqrt(k)).to(cuda, dtype)
    want = qmk.q_matmul_plain(x, q, s)
    lib = qmk._lib()
    for splits in (None, 3, 16):
        try:
            plan = qmk.qmm_geometry(m, k, n, x.element_size(), ntw=ntw,
                                    stages=stages, splits=splits)
        except ValueError:
            assert qmk._occupancy(x.element_size(), 8 if m <= 8 else 16,
                                  ntw, stages)[0] == 0
            return
        y = torch.empty_like(want)
        qmk._err(lib, "q_matmul", qmk._launch_qmm(
            lib, x, q, s, y, m, k, n,
            torch.cuda.current_stream().cuda_stream, plan))
        torch.cuda.synchronize()
        if dtype == torch.float32:
            torch.testing.assert_close(y, want, atol=QMM_F32_TOL,
                                       rtol=QMM_F32_TOL)
        else:
            err = (y.float() - want.float()).abs().max().item()
            assert err <= QMM_BF16_REL * want.float().abs().max().item()


@pytest.mark.parametrize("case", [(4, 8192, 152064), (1, 8192, 152064),
                                  (4, 8192, 1024), (4, 8192, 8192),
                                  (16, 29568, 8192), (4, 8192, 29568),
                                  (17, 100, 130), (250, 24, 40)],
                         ids=lambda c: "M%d-K%d-N%d" % c)
def test_qmm_geometry_is_within_the_kernel_limits(case, monkeypatch):
    """Persistent CTAs (as many as the occupancy calculator puts on an SM)
    walk the items when they fill the card, each with the whole of K (the
    LM head: 3 rounds of 396 in bf16); otherwise K splits over a cluster of
    whole 64-row stages, one item a CTA, as deep as the card holds every
    cluster at once and no deeper; decode rows that leave CTAs idle take
    the decode tile. A forced split is taken as given."""
    m, k, n = case
    gpcs = [16] * 6 + [18] * 2             # 132 SMs: a model of the card

    def occupancy(es, ntok, ntw, stages, splits=1):
        per_sm = {(1, 6): 3, (2, 4): 2}.get((ntw, stages), 1)
        if es == 4:
            per_sm = max(1, per_sm - 1)
        return per_sm, 16, sum(per_sm * g // splits for g in gpcs)

    monkeypatch.setattr(qmk, "_num_sms", lambda: 132)
    monkeypatch.setattr(qmk, "_occupancy", occupancy)
    for es in (2, 4):
        p = qmk.qmm_geometry(m, k, n, es)
        per_sm = occupancy(es, p.ntok, p.ntw, p.stages)[0]
        slots = per_sm * 132
        items = -(-n // (qmk.QMM_BOX_N * p.ntw)) * -(-m // p.ntok)
        wide = -(-n // (qmk.QMM_BOX_N * qmk.QMM_TILE[0])) * -(-m // p.ntok)
        assert p.ntok == (8 if m <= 8 else 16)
        decode = p.ntok == 8 and wide < occupancy(es, 8, *qmk.QMM_TILE)[0] * 132
        assert (p.ntw, p.stages) == (qmk.QMM_DECODE_TILE if decode
                                     else qmk.QMM_TILE)
        assert 1 <= p.splits <= qmk.QMM_MAX_SPLITS and p.per % qmk.QMM_KT == 0
        assert (p.splits - 1) * p.per < k <= p.splits * p.per
        if p.splits > 1:
            active = occupancy(es, p.ntok, p.ntw, p.stages, p.splits)[2]
            assert p.grid == items * p.splits <= slots and items <= active
            deeper = occupancy(es, p.ntok, p.ntw, p.stages, p.splits + 1)[2]
            assert (p.splits == qmk.QMM_MAX_SPLITS or items > deeper
                    or k < (p.splits + 1) * qmk.QMM_SPLIT_MIN_ROWS)
        else:
            assert p.grid == min(items, slots)
        if n == 152064:
            assert (p.ntw, p.splits, p.grid) == (1, 1, slots)
        if n == 1024:
            assert p.splits == 16 and p.grid == items * 16
        forced = qmk.qmm_geometry(m, k, n, es, ntw=4, stages=4, splits=2)
        if k >= 2 * qmk.QMM_KT:
            assert (forced.ntw, forced.stages, forced.splits) == (4, 4, 2)
            assert forced.grid == -(-n // 512) * -(-m // p.ntok) * 2


def _qkv(rng, case, device, dtype):
    b, h, kh, sq, sk, d, _ = case
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(device, dtype)
    return mk(b, h, sq, d), mk(b, kh, sk, d), mk(b, kh, sk, d)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "B%d-H%d-K%d-Sq%d-Sk%d-D%d-c%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    causal = case[-1]
    q, k, v = _qkv(np.random.default_rng(sum(case)), case, cuda, dtype)
    before = fak.flash_attention.launches
    out = fak.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fak.flash_attention.launches == before + 1
    want = fak.flash_attention_plain(q, k, v, causal=causal)
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_reads_bshd_in_place_with_gqa(cuda, causal):
    """ops.flash_mha on (B, S, H, D) activations, 64 / 8 heads, equals the
    kernel on head-major copies and the plain version."""
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda)
    q, k, v = mk(2, 256, 64, 128), mk(2, 256, 8, 128), mk(2, 256, 8, 128)
    out = ops.flash_mha(q, k, v, causal=causal)
    assert out.shape == q.shape and out.is_contiguous()
    heads = fak.flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(), causal=causal)
    assert torch.equal(out, heads.transpose(1, 2))
    want = fak.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal)
    torch.testing.assert_close(out, want.transpose(1, 2), atol=FLASH_F32_TOL,
                               rtol=FLASH_F32_TOL)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(np.random.default_rng(4), (1, 2, 2, 64, 200, 16, False),
                   cuda, torch.float32)
    with pytest.raises(ValueError, match="Sk % blk_k"):
        fak.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="Sk % blk_k"):
        ops.flash_mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=False, blk=64)
    with pytest.raises(NotImplementedError, match="inference only"):
        fak.flash_attention(q.requires_grad_(), k, v)
    # D = 160 was refused (D <= 128) before the output features could be
    # split over CTAs: now it runs and matches the plain version
    wide = _qkv(np.random.default_rng(5), (1, 2, 2, 8, 8, 160, True), cuda,
                torch.float32)
    torch.testing.assert_close(fak.flash_attention(*wide),
                               fak.flash_attention_plain(*wide),
                               atol=FLASH_F32_TOL, rtol=FLASH_F32_TOL)


def test_ssd_and_flash_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor runs the plain version: the wrapper returns what the
    plain version returned for the very same tensors, and moves no launch
    counter. The plain versions' calls are recorded, not run a second time
    to compare: two CPU runs of one plain version need not be bit-identical
    on every host (the CPU's matrix products)."""
    rng = np.random.default_rng(6)
    args = _ssd_inputs(rng, (2, 40, 3, 8, 4), "cpu", torch.float32)
    q, k, v = _qkv(rng, (2, 4, 2, 40, 40, 16, True), "cpu", torch.float32)
    calls = []

    def recorded(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, a, out))
            return out
        return run

    monkeypatch.setattr(ssdk, "ssd_plain", recorded("ssd", ssdk.ssd_plain))
    monkeypatch.setattr(fak, "flash_attention_plain",
                        recorded("flash", fak.flash_attention_plain))
    before = (ssdk.ssd.launches, fak.flash_attention.launches)
    y = ssdk.ssd(*args)
    assert [c[0] for c in calls] == ["ssd"] and calls[0][2] is y
    assert all(a is b for a, b in zip(calls[0][1], args))
    o = fak.flash_attention(q, k, v)
    assert [c[0] for c in calls] == ["ssd", "flash"] and calls[1][2] is o
    assert all(a is b for a, b in zip(calls[1][1], (q, k, v)))
    assert y.shape == args[0].shape and torch.isfinite(y).all()
    assert o.shape == q.shape and torch.isfinite(o).all()
    with pytest.raises(ValueError, match="Sk % blk_k"):
        fak.flash_attention(q, k[:, :, :30], v[:, :, :30], causal=False,
                            blk_k=16)
    assert (ssdk.ssd.launches, fak.flash_attention.launches) == before


# ---------------------------------------------------------------------------
# the image lane's shapes (lipconvnet-15 served per tenant, phase 15 of
# chip_smoke.py): 8 image rows, b = 8 (route 2 of the GS kernels), the wc
# channel mix at (d, tokens a row) = (32, 1024) ... (1024, 1), int8 products
# with K = N = d from 32 up, shorter than one ring stage (64 rows) and one
# box (128 columns) at the narrow end
# ---------------------------------------------------------------------------

IMAGE_ROWS = 8
IMAGE_SLOTS = 7                     # 6 tenants + the identity slot 0
IMAGE_PAIRS = [(32, 1024), (64, 256), (128, 64), (256, 16), (512, 4),
               (1024, 1)]


def _image_ids(device):
    """Eight rows over the 7-slot bank: repeats, the identity, every slot."""
    return torch.tensor([1, 2, 3, 0, 4, 5, 6, 1], dtype=torch.int64,
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", IMAGE_PAIRS, ids=lambda v: str(v))
def test_image_lane_transpose_bank_at_b8(cuda, d, t):
    rng = np.random.default_rng(d + t)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, IMAGE_SLOTS, d // 8, 8))
    x = torch.from_numpy(rng.normal(size=(IMAGE_ROWS, t, d))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    ids = _image_ids(cuda)
    before = gk.gs_fused_T.slot_launches
    y = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    torch.cuda.synchronize()
    assert gk.gs_fused_T.slot_launches == before + 1
    want = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL
    assert torch.equal(y[3], x[3])


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", IMAGE_PAIRS, ids=lambda v: str(v))
def test_image_lane_gs_q_matmul_bank_at_b8(cuda, d, t):
    rng = np.random.default_rng(2 * d + t)
    q, s = _codes(rng, d, d)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, IMAGE_SLOTS, d // 8, 8))
    x = torch.from_numpy(rng.normal(size=(IMAGE_ROWS, t, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    ids = _image_ids(cuda)
    q, s = q.to(cuda), s.to(cuda)
    y = qmk.gs_q_matmul_bank(x, Lb, Rb, ids, q, s)
    torch.cuda.synchronize()
    want = qmk.gs_q_matmul_bank_plain(x, Lb, Rb, ids, q, s)
    assert y.shape == (IMAGE_ROWS, t, d) and torch.isfinite(y.float()).all()
    err = (y.float() - want.float()).abs().max().item()
    assert err <= GSQ_BF16_REL * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", IMAGE_PAIRS + [(2048, 1)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_image_lane_q_matmul_narrow_k_and_n(cuda, d, t, dtype):
    """M = 8 rows x tokens (up to 8192), K = N = d: K shorter than a ring
    stage and N than a box at d = 32 must read zeros past K and N, never
    the next row's codes."""
    m = IMAGE_ROWS * t
    rng = np.random.default_rng(3 * d + t)
    q, s = _codes(rng, d, d)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)
                         / np.sqrt(d)).to(cuda, dtype)
    q, s = q.to(cuda), s.to(cuda)
    y = qmk.q_matmul(x, q, s)
    torch.cuda.synchronize()
    want = qmk.q_matmul_plain(x, q, s)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, atol=QMM_F32_TOL,
                                   rtol=QMM_F32_TOL)
    else:
        err = (y.float() - want.float()).abs().max().item()
        assert err <= QMM_BF16_REL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", IMAGE_PAIRS, ids=lambda v: str(v))
@pytest.mark.parametrize("trans", [False, True], ids=["stored", "transposed"])
def test_image_lane_bdmm_at_b8(cuda, d, t, trans):
    """BOFT tenants' rows: per-row (r, 8, 8) blocks, bf16, read as stored
    and transposed in place."""
    rng = np.random.default_rng(4 * d + t)
    blocks = _factors(rng, IMAGE_ROWS, d // 8, 8).to(cuda, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(IMAGE_ROWS, t, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    before = bk.bdmm.launches
    y = bk.bdmm(x, blocks, transpose_blocks=trans)
    torch.cuda.synchronize()
    assert bk.bdmm.launches == before + 1
    want = bk.bdmm_plain(x, blocks, transpose_blocks=trans)
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512, 1024, 2048])
def test_image_lane_gs_fused_merge_at_b8_f32(cuda, d):
    """The merge of a GSOFT tenant into wc (identity base): T = d tokens of
    width d, f32, b = 8 (route 2)."""
    rng = np.random.default_rng(5 * d)
    x = torch.eye(d, device=cuda)[None]
    L, R = (_factors(rng, 1, d // 8, 8).to(cuda) for _ in range(2))
    y = gk.gs_fused(x, L, R)
    torch.cuda.synchronize()
    want = gk.gs_fused_plain(x, L, R)
    assert (y - want).abs().max().item() <= F32_TOL
    eye = torch.eye(d, device=cuda)
    assert (y[0] @ y[0].T - eye).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_merged_then_quantized_weight_runs_q_matmul(cuda):
    """A merged GSOFT weight comes out of the weight-side rotation as a
    transposed view; its int8 codes must still be row-major, which
    ``q_matmul`` streams (it refused them before: "q_matmul needs
    contiguous x and q", on the image lane's "merge, then quantize")."""
    rng = np.random.default_rng(9)
    L, R = (_factors(rng, 1, 8, 8).to(cuda) for _ in range(2))
    w = gk.gs_fused(torch.eye(64, device=cuda)[None], L, R)[0].T
    assert not w.is_contiguous()
    qt = quant.quantize_tensor(w)
    assert qt.q.is_contiguous()
    x = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    y = qmk.q_matmul(x, qt.q, qt.scale)
    want = qmk.q_matmul_plain(x, qt.q, qt.scale)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= QMM_BF16_REL * want.float().abs().max().item()


# ---------------------------------------------------------------------------
# tensor-parallel serving's local shapes (qwen2-72b at tp = 2: 64 / 8 heads
# become 32 / 4 a rank, d_ff 29568 becomes 14784; phase 16 of chip_smoke.py)
# ---------------------------------------------------------------------------

# (M, K, N): column-parallel at the local N (wq 4096, wk / wv 512, wi / wg
# 14784, the LM head's 76032 vocab columns), row-parallel at the local K
# (attention wo 4096, MLP wo 14784); decode rows and a prefill chunk
TP_QMM_CASES = [(1, 8192, 4096), (4, 8192, 512), (4, 8192, 14784),
                (1, 8192, 76032), (4, 4096, 8192), (4, 14784, 8192),
                (16, 14784, 8192)]


def _device_codes(k, n, device, seed):
    """Random int8 codes and per-column scales made on the card (a 76032-
    column head is 600 MB of codes: too slow to draw on the host)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.rand((1, n), generator=gen, device=device) * 0.02 + 1e-3
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("case", TP_QMM_CASES, ids=lambda c: "M%d-K%d-N%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tp_q_matmul_at_local_n_and_k(cuda, case, dtype):
    m, k, n = case
    q, s = _device_codes(k, n, cuda, m + k + n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    x = (torch.randn((m, k), generator=gen, device=cuda) / k ** 0.5).to(dtype)
    before = qmk.q_matmul.launches
    y = qmk.q_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qmk.q_matmul.launches == before + 1
    want = qmk.q_matmul_plain(x, q, s)
    assert y.shape == (m, n) and torch.isfinite(y.float()).all()
    err = (y.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= QMM_F32_TOL * max(1.0, want.abs().max().item())
    else:
        assert err <= QMM_BF16_REL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d,rank,tp", [(8192, 0, 2), (8192, 1, 2),
                                       (29568, 1, 2), (8192, 3, 4)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("t", [1, 16], ids=["decode", "prefill"])
def test_tp_row_parallel_rotation_path(cuda, d, rank, tp, t):
    """A row-parallel int8 ``wo`` under a GSOFT bank: the whole gathered
    row rotated by slot id (``gs_fused_T_bank``, one launch), the rank's K
    window cut out, then ``q_matmul`` at the local K (one launch) — held
    against the plain versions of the same three steps (``ops.q_matmul``
    takes the window's strided rows, as the model's ``row_linear`` does)."""
    rng = np.random.default_rng(d + rank + t)
    bsz, w = 4, d // tp
    Lb, Rb = (a.to(cuda) for a in _bank(rng, 5, d // 8, 8))
    x = torch.from_numpy(rng.normal(size=(bsz, t, d)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    ids = torch.tensor([1, 0, 4, 1], dtype=torch.int64, device=cuda)
    q, s = _device_codes(w, 8192, cuda, d + rank)
    slot0, mm0 = gk.gs_fused_T.slot_launches, qmk.q_matmul.launches
    rot = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    y = ops.q_matmul(rot.narrow(-1, rank * w, w), q, s)
    torch.cuda.synchronize()
    assert gk.gs_fused_T.slot_launches == slot0 + 1
    assert qmk.q_matmul.launches == mm0 + 1
    want_rot = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    assert (rot.float() - want_rot.float()).abs().max().item() <= BF16_TOL
    want = qmk.q_matmul_plain(
        want_rot.narrow(-1, rank * w, w).reshape(-1, w), q, s).reshape(y.shape)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= GSQ_BF16_REL * max(1.0, want.float().abs().max().item())


# the cluster lane's GSOFT / BOFT tenants: b = 8 on qwen2-72b's whole rows
# (d_model 8192, r = 1024; d_ff 29568, r = 3696); (d, B, T) for the decode
# rows and the prefill buckets of prompts of 4-12 tokens
CLUSTER_B8_CASES = [(8192, 4, 1), (8192, 1, 8), (8192, 1, 16),
                    (29568, 4, 1), (29568, 1, 8), (29568, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,bsz,t", CLUSTER_B8_CASES,
                         ids=lambda v: str(v))
def test_cluster_lane_transpose_bank_at_b8(cuda, d, bsz, t):
    rng = np.random.default_rng(d + bsz + t)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, 5, d // 8, 8))
    x = torch.from_numpy(rng.normal(size=(bsz, t, d)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    ids = torch.tensor([1, 0, 4, 2][:bsz], dtype=torch.int64, device=cuda)
    before = gk.gs_fused_T.slot_launches
    y = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    torch.cuda.synchronize()
    assert gk.gs_fused_T.slot_launches == before + 1
    want = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,bsz,t", CLUSTER_B8_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("trans", [False, True], ids=["stored", "transposed"])
def test_cluster_lane_bdmm_at_b8(cuda, d, bsz, t, trans):
    rng = np.random.default_rng(2 * d + bsz + t)
    blocks = _factors(rng, bsz, d // 8, 8).to(cuda, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(bsz, t, d)).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    before = bk.bdmm.launches
    y = bk.bdmm(x, blocks, transpose_blocks=trans)
    torch.cuda.synchronize()
    assert bk.bdmm.launches == before + 1
    want = bk.bdmm_plain(x, blocks, transpose_blocks=trans)
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL


# (B, H, K, D, page, P, W): tp = 2's 32 / 4 heads; the kv heads a rank
# keeps when they replicate under a q-head split (16 q heads reading their
# one kv head; a non-uniform grouping keeps one kv copy per q head)
TP_PAGED_CASES = [(4, 32, 4, 128, 16, 64, 24), (8, 32, 4, 128, 16, 300, 256),
                  (4, 16, 1, 128, 16, 64, 24), (4, 3, 3, 128, 8, 40, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TP_PAGED_CASES,
                         ids=lambda c: "B%d-H%d-K%d-D%d-page%d-P%d-W%d" % c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tp_paged_decode_at_local_heads(cuda, case, dtype):
    rng = np.random.default_rng(sum(case) + 7)
    args = _paged_inputs(rng, case, cuda, dtype)
    before = pak.paged_decode.launches
    out = pak.paged_decode(*args)
    torch.cuda.synchronize()
    assert pak.paged_decode.launches == before + 1
    want = pak.paged_decode_plain(*args)
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= PAGED_F32_TOL * max(1.0, want.abs().max().item())
    else:
        assert err <= PAGED_BF16_REL * want.float().abs().max().item()


# ---------------------------------------------------------------------------
# expert stacks: one launch over every expert of a layer (the MoE configs'
# (E, d_in, d_out) stacks as the kernels' rows)
# ---------------------------------------------------------------------------

# (E, T, d) = (experts, d_out, d_in), b = 32: qwen3-moe-30b-a3b's wi / wg
# (route 1) and wo (r = 24 < b: route 2), phi-3.5-MoE's wi and wo (r = 200)
MOE_STACKS = [(128, 768, 2048), (128, 2048, 768), (16, 6400, 4096),
              (16, 4096, 6400)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_STACKS, ids=lambda c: "E%d-T%d-d%d" % c)
def test_expert_stack_rotation_and_grads_in_one_launch(cuda, case):
    """``gs_fused`` and ``gs_fused_grads`` over a whole expert stack in bf16:
    one launch each, against the plain version on three sampled experts
    and against the per-expert launches."""
    E, T, d = case
    b = 32
    rng = np.random.default_rng(E + T + d)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(E * T + d)
    L, R = (_factors(rng, E, d // b, b).to(cuda, torch.bfloat16)
            for _ in range(2))
    x, dy = (torch.randn((E, T, d), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    idx = torch.tensor([0, E // 2, E - 1], device=cuda)
    before = (gk.gs_fused.launches, gk.gs_fused_grads.launches)
    y = gk.gs_fused(x, L, R)
    dL, dR = gk.gs_fused_grads(x, dy, L, R)
    assert (gk.gs_fused.launches, gk.gs_fused_grads.launches) == (
        before[0] + 1, before[1] + 1)
    pick = lambda *ts: [t.index_select(0, idx) for t in ts]  # noqa: E731
    want = gk.gs_fused_plain(*pick(x, L, R))
    assert (y.index_select(0, idx).float() - want.float()).abs().max() <= BF16_TOL
    wL, wR = gk.gs_fused_grads_plain(*pick(x, dy, L, R))
    for got, w in ((dL.index_select(0, idx), wL), (dR.index_select(0, idx), wR)):
        assert (got - w).abs().max() <= 1e-4 * max(1.0, w.abs().max().item())
    for i in (1, E - 2):
        one = [t[i:i + 1] for t in (x, dy, L, R)]
        assert (gk.gs_fused(one[0], *one[2:])[0].float()
                - y[i].float()).abs().max() <= BF16_TOL
        gL, gR = gk.gs_fused_grads(*one)
        assert (gL[0] - dL[i]).abs().max() <= 1e-4 * max(1.0, dL[i].abs().max().item())
        assert (gR[0] - dR[i]).abs().max() <= 1e-4 * max(1.0, dR[i].abs().max().item())


# ---------------------------------------------------------------------------
# the encoder-decoder, vlm and classifier shapes (seamless-m4t-medium,
# pixtral-12b, the RoBERTa-base-width classifier)
# ---------------------------------------------------------------------------

# (B, T, d, b, dtype) of a training step's weight stacks (rows: layers, two
# of them here; T = d_out, d = d_in): seamless d 1024 (r = b = 32) and its
# MLP wo (d 4096, r = 128); pixtral wq (d 5120, r = 160), attention wo (d
# 4096), MLP wi (T 14336) and wo (d 14336, r = 448), patch_proj (one row,
# d 1024); the classifier's GSOFT b = 8 in f32 (route 2): d 768 / 3072
SLICE17_STACKS = [(2, 1024, 1024, 32, torch.bfloat16),
                  (2, 4096, 1024, 32, torch.bfloat16),
                  (2, 1024, 4096, 32, torch.bfloat16),
                  (2, 4096, 5120, 32, torch.bfloat16),
                  (2, 5120, 4096, 32, torch.bfloat16),
                  (2, 14336, 5120, 32, torch.bfloat16),
                  (2, 5120, 14336, 32, torch.bfloat16),
                  (1, 5120, 1024, 32, torch.bfloat16),
                  (2, 768, 768, 8, torch.float32),
                  (2, 3072, 768, 8, torch.float32),
                  (2, 768, 3072, 8, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLICE17_STACKS,
                         ids=lambda c: "B%d-T%d-d%d-b%d-%s" % (
                             c[:4] + (str(c[4])[6:],)))
def test_slice17_stack_rotation_and_grads(cuda, case):
    """``gs_fused`` and ``gs_fused_grads`` at the new families' training
    shapes: one launch each over the rows, against the plain versions."""
    B, T, d, b, dtype = case
    rng = np.random.default_rng(B + T + d + b)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T * d + b)
    L, R = (_factors(rng, B, d // b, b).to(cuda, dtype) for _ in range(2))
    x, dy = (torch.randn((B, T, d), generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    before = (gk.gs_fused.launches, gk.gs_fused_grads.launches)
    y = gk.gs_fused(x, L, R)
    dL, dR = gk.gs_fused_grads(x, dy, L, R)
    torch.cuda.synchronize()
    assert (gk.gs_fused.launches, gk.gs_fused_grads.launches) == (
        before[0] + 1, before[1] + 1)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want = gk.gs_fused_plain(x, L, R)
    assert (y.float() - want.float()).abs().max().item() <= tol
    wL, wR = gk.gs_fused_grads_plain(x, dy, L, R)
    _assert_grads_close(dL, wL, "dL")
    _assert_grads_close(dR, wR, "dR")


# (B, T, r, bo, bi): the classifier's OFT b = 16 and BOFT b = 8 levels at
# d 768 (wq..wo, MLP wi) and 3072 (MLP wo), f32, two layers as rows
SLICE17_BDMM = [(2, 768, 48, 16, 16), (2, 3072, 48, 16, 16),
                (2, 768, 192, 16, 16), (2, 768, 96, 8, 8),
                (2, 3072, 96, 8, 8), (2, 768, 384, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLICE17_BDMM,
                         ids=lambda c: "B%d-T%d-r%d-bo%d-bi%d" % c)
def test_slice17_classifier_bdmm_and_dblocks(cuda, case):
    bsz, t, r, bo, bi = case
    rng = np.random.default_rng(bsz + t + r + bo)
    x, blocks = _bdmm_inputs(rng, bsz, t, r, bo, bi, cuda, torch.float32)
    y = bk.bdmm(x, blocks)
    want = bk.bdmm_plain(x, blocks)
    assert (y - want).abs().max().item() <= F32_TOL
    dy = torch.from_numpy(rng.normal(size=(bsz, t, r * bo)).astype(
        np.float32)).to(cuda)
    _assert_grads_close(bk.bdmm_dblocks(dy, x, bo, bi),
                        bk.bdmm_dblocks_plain(dy, x, bo, bi), "dblocks")


# (T, d): pixtral's banked rotations a serving step reads by slot id:
# decode rows at d 5120 (wq / wk / wv / wi / wg), 4096 (attention wo),
# 14336 (MLP wo), and one request's 256 patches at d 1024 (patch_proj)
SLICE17_BANK = [(1, 5120), (1, 4096), (1, 14336), (256, 1024), (16, 5120)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", SLICE17_BANK, ids=lambda v: str(v))
def test_slice17_pixtral_bank_rotation_and_int8(cuda, t, d):
    """``gs_fused_T_bank`` (fp32 bank, bf16 x, slot 0 the identity) and
    the fused int8 ``gs_q_matmul_bank`` at pixtral's widths."""
    rng = np.random.default_rng(t + d)
    Lb, Rb = (a.to(cuda) for a in _bank(rng, 4, d // 32, 32))
    bsz = 4 if t == 1 else 1
    x = torch.from_numpy(rng.normal(size=(bsz, t, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    ids = torch.tensor([1, 2, 0, 3][:bsz], device=cuda)
    y = gk.gs_fused_T_bank(x, Lb, Rb, ids)
    want = gk.gs_fused_T_bank_plain(x, Lb, Rb, ids)
    assert (y.float() - want.float()).abs().max().item() <= BF16_TOL
    n = 1024
    q, s = (a.to(cuda) for a in _codes(rng, d, n))
    y = qmk.gs_q_matmul_bank(x, Lb, Rb, ids, q, s)
    want = qmk.gs_q_matmul_bank_plain(x, Lb, Rb, ids, q, s)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= GSQ_BF16_REL * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 5120, 131072), (4, 1024, 256208),
                                  (256, 1024, 5120)],
                         ids=lambda c: "M%d-K%d-N%d" % c)
def test_slice17_q_matmul_heads_and_patch_proj(cuda, case):
    """int8 ``q_matmul`` at pixtral's LM head (M = 4 decode rows),
    seamless's (vocab 256208) and pixtral's patch_proj over 256 patches."""
    m, k, n = case
    rng = np.random.default_rng(m + k + n)
    q, s = (a.to(cuda) for a in _codes(rng, k, n))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    y = qmk.q_matmul(x, q, s)
    want = qmk.q_matmul_plain(x, q, s)
    err = (y.float() - want.float()).abs().max().item()
    assert err <= GSQ_BF16_REL * max(1.0, want.float().abs().max().item())
