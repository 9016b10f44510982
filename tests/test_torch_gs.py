"""The port's GS core and kernel plain versions against the JAX package:
``repro.kernels.ref`` oracles, ``repro.kernels.ops`` with ``use_pallas=True``
(the Pallas kernels in interpret mode off-TPU), Cayley/skew, block-size
choice and the GSOFT bank build. Inputs come from numpy and go to both."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adapters as jad  # noqa: E402
from repro.core import gs as jgs  # noqa: E402
from repro.core import orthogonal as jorth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import adapters as tad  # noqa: E402
from repro_torch.core import gs as tgs  # noqa: E402
from repro_torch.core import methods as tmethods  # noqa: E402
from repro_torch.core import orthogonal as torth  # noqa: E402
from repro_torch.kernels import gs_fused as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (r, b): r < b, r = b, r > b, r not a power of two (and r > b)
GEOMS = [(2, 8), (4, 4), (8, 2), (6, 4), (3, 5)]
F32_TOL = 1e-5
# bf16: both sides round to bf16 at the same places (the torch plain version
# mirrors the JAX oracle), so only summation order differs — one bf16 ulp
# (2^-8 relative) of values of magnitude ~|x| = O(1).
BF16_TOL = 2.0 ** -6


def _orth(rng, *shape):
    """Orthogonal blocks via Cayley of random skew matrices, in numpy."""
    a = rng.normal(0, 0.3, size=shape).astype(np.float32)
    return np.asarray(jorth.cayley(jorth.skew(jnp.asarray(a))))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("r,b", GEOMS)
@pytest.mark.parametrize("t", [1, 7, 16])
def test_gs_fused_and_T_match_jax_f32(r, b, t):
    rng = np.random.default_rng(r * 100 + b * 10 + t)
    L, R = _orth(rng, r, b, b), _orth(rng, r, b, b)
    x = rng.normal(size=(t, r * b)).astype(np.float32)
    jL, jR, jx = jnp.asarray(L), jnp.asarray(R), jnp.asarray(x)
    for tfn, jfn, opfn in ((tref.gs_fused_ref, jref.gs_fused_ref,
                            jops.gs_transform),
                           (tref.gs_fused_T_ref, jref.gs_fused_T_ref,
                            jops.gs_transform_T)):
        got = tfn(_t(L), _t(R), _t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jL, jR, jx)),
                                   atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(
            got, np.asarray(opfn(jL, jR, jx, use_pallas=True)),
            atol=F32_TOL, rtol=0)
    # the wrappers' CPU path (B = 1) and ops agree with the plain versions
    y = tk.gs_fused(_t(x)[None], _t(L)[None], _t(R)[None])[0].numpy()
    np.testing.assert_allclose(y, np.asarray(jref.gs_fused_ref(jL, jR, jx)),
                               atol=F32_TOL, rtol=0)
    y = tops.gs_transform_T(_t(L), _t(R), _t(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jref.gs_fused_T_ref(jL, jR, jx)),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("r,b", GEOMS)
def test_gs_fused_matches_dense_q(r, b):
    """The shuffle as index math: Q = P^T L P R materialized from
    ``gs_sigma`` equals the fused rotation, and x Q equals the transpose."""
    rng = np.random.default_rng(r + 31 * b)
    L, R = _orth(rng, r, b, b), _orth(rng, r, b, b)
    x = rng.normal(size=(5, r * b)).astype(np.float32)
    Q = tgs.gs_materialize(tgs.gsoft_layout(r * b, b), L.astype(np.float64),
                           R.astype(np.float64)).numpy()
    np.testing.assert_allclose(tref.gs_fused_ref(_t(L), _t(R), _t(x)).numpy(),
                               x @ Q.T, atol=F32_TOL)
    np.testing.assert_allclose(tref.gs_fused_T_ref(_t(L), _t(R), _t(x)).numpy(),
                               x @ Q, atol=F32_TOL)


@pytest.mark.parametrize("r,b", GEOMS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_banked_T_matches_jax(r, b, dtype):
    """gs_fused_T with per-row factors == the JAX banked oracle and the
    vmapped Pallas path; ragged T = 3."""
    rng = np.random.default_rng(7 * r + b)
    bsz, t = 3, 3
    L, R = _orth(rng, bsz, r, b, b), _orth(rng, bsz, r, b, b)
    x = rng.normal(size=(bsz, t, r * b)).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    jL, jR, jx = (jnp.asarray(a, jdt) for a in (L, R, x))
    got = tk.gs_fused_T(_t(x, tdt), _t(L, tdt), _t(R, tdt)).float().numpy()
    want = np.asarray(jref.gs_banked_T_ref(jL, jR, jx), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    want_k = np.asarray(jops.gs_banked_transform_T(jL, jR, jx, use_pallas=True),
                        np.float32)
    np.testing.assert_allclose(got, want_k, atol=tol, rtol=0)
    # forward per-row rotation inverts the transpose one (Q Q^T = I)
    if dtype == "f32":
        back = tk.gs_fused(tk.gs_fused_T(_t(x), _t(L), _t(R)), _t(L), _t(R))
        np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("neumann", [None, 3])
def test_cayley_skew_match_jax(neumann):
    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.2, size=(5, 6, 6)).astype(np.float32)
    want = jorth.cayley(jorth.skew(jnp.asarray(a)), neumann_order=neumann)
    got = torth.cayley(torth.skew(_t(a)), neumann_order=neumann)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(torth.skew(_t(a)).numpy(),
                               np.asarray(jorth.skew(jnp.asarray(a))))


@pytest.mark.parametrize("d,target", [(64, 8), (64, 32), (29568, 32),
                                      (29568, 128), (8192, 32), (96, 5)])
def test_pick_block_size_matches_jax(d, target):
    assert tgs.pick_block_size(d, target) == jgs.pick_block_size(d, target)


@pytest.mark.parametrize("neumann", [None, 2])
def test_gsoft_adapter_matches_jax(neumann):
    """Identity init, the offline merge Q W over stacked layers, the
    activation side x Q and the parameter count; r = 6 blocks of b = 8."""
    rng = np.random.default_rng(5)
    kw = dict(method="gsoft", d_in=48, d_out=10, block_size=8,
              neumann_order=neumann, batch=(2,))
    spec_j, spec_t = jad.AdapterSpec(**kw), tad.AdapterSpec(**kw)
    init_j = jad.init_adapter(spec_j, jax.random.PRNGKey(0))
    init_t = tad.init_adapter(spec_t, device="cpu")
    for k in ("L", "R"):
        assert tuple(init_t[k].shape) == init_j[k].shape == (2, 6, 8, 8)
        assert not init_t[k].any()
    p = {k: rng.normal(0, 0.3, size=(2, 6, 8, 8)).astype(np.float32)
         for k in ("L", "R")}
    W = rng.normal(size=(2, 48, 10)).astype(np.float32)
    merged = tad.materialize(spec_t, {k: _t(v) for k, v in p.items()},
                             _t(W)).numpy()
    want = jad.materialize(spec_j, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(W))
    np.testing.assert_allclose(merged, np.asarray(want), atol=F32_TOL)

    one = {k: v[0] for k, v in p.items()}
    x = rng.normal(size=(3, 48)).astype(np.float32)
    xq = tmethods.get("gsoft").apply_activation_side(
        dataclasses.replace(spec_t, batch=()),
        {k: _t(v) for k, v in one.items()}, _t(x)).numpy()
    want_xq = jad.apply_activation_side(
        dataclasses.replace(spec_j, batch=()),
        {k: jnp.asarray(v) for k, v in one.items()}, jnp.asarray(x))
    np.testing.assert_allclose(xq, np.asarray(want_xq), atol=F32_TOL)
    np.testing.assert_allclose(xq @ W[0], x @ merged[0], atol=1e-4)
    assert tad.gsoft_param_count(spec_t) == jad.gsoft_param_count(spec_j) \
        == 2 * 6 * 8 * 8


def test_gsoft_bank_build_matches_jax():
    rng = np.random.default_rng(11)
    spec_j = jad.AdapterSpec(method="gsoft", d_in=64, d_out=16, block_size=8,
                             batch=(2,))
    spec_t = tad.AdapterSpec(method="gsoft", d_in=64, d_out=16, block_size=8,
                             batch=(2,))
    p = {k: rng.normal(0, 0.3, size=(2, 8, 8, 8)).astype(np.float32)
         for k in ("L", "R")}
    slots = [None, p, None]
    want = jad.gsoft_bank_build(spec_j, [None if s is None else
                                         {k: jnp.asarray(v) for k, v in s.items()}
                                         for s in slots])
    got = tad.gsoft_bank_build(spec_t, [None if s is None else
                                        {k: _t(v) for k, v in s.items()}
                                        for s in slots], torch.device("cpu"))
    for k in ("L", "R"):
        assert tuple(got[k].shape) == want[k].shape == (2, 3, 8, 8, 8)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
