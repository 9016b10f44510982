"""The port's GS-class library against the JAX package on the CPU: the
permutations (every ``PermSpec`` kind, the paired shuffle), the orthogonal
machinery, the general two-factor class (``GSLayout``, Proposition 1's
block ranks and low-rank blocks), higher-order GS and Theorem 2's density
tools, Algorithm 1 (``project_to_gs``) and the one layout class that
``gsoft_layout`` now returns. Mirrors tests/test_gs.py, test_projection.py,
test_orthogonal.py, test_permutations.py and the GS cases of
test_properties.py; every case compares the port's result with JAX's on
the same numpy inputs.

Tolerances: structure (sigmas, ranks, patterns, dense-class answers) is
compared exactly; float64 materializations and projections (numpy float64
in JAX, torch float64 here) to 1e-10 absolute on O(1) entries; f32
applications (JAX einsum against the port's bdmm plain version, the same
sums in another order) to 1e-5 of max(1, max|ref|)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import gs as jgs  # noqa: E402
from repro.core import orthogonal as jorth  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import gs as tgs  # noqa: E402
from repro_torch.core import orthogonal as torth  # noqa: E402
from repro_torch.core import permutations as tperm  # noqa: E402
from repro_torch.core import projection as tproj  # noqa: E402

F64_ATOL = 1e-10
F32_REL = 1e-5


def _close(got, want, rel=F32_REL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (what, err, rel * scale)


def _jspec(spec):
    return jperm.PermSpec(spec.kind, k=spec.k, table=spec.table)


def _jlayout(lay):
    """The JAX layout with the same block specs and permutations."""
    b = lambda s: jgs.BlockDiagSpec(s.num_blocks, s.rows, s.cols)  # noqa: E731
    return jgs.GSLayout(lspec=b(lay.lspec), rspec=b(lay.rspec),
                        perm_left=_jspec(lay.perm_left),
                        perm_mid=_jspec(lay.perm_mid),
                        perm_right=_jspec(lay.perm_right))


def _jfactors(f):
    return jgs.GSFactors(
        specs=tuple(jgs.BlockDiagSpec(s.num_blocks, s.rows, s.cols)
                    for s in f.specs),
        perms=tuple(_jspec(p) for p in f.perms))


def _random_layout(rng):
    """Random small GS layout with compatible chained dims (as
    tests/test_gs.py draws it)."""
    kL = int(rng.integers(1, 5))
    kR = int(rng.integers(1, 5))
    s = int(np.lcm(kL, kR)) * int(rng.integers(1, 4))
    bL2, bR1 = s // kL, s // kR
    bL1, bR2 = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    lspec = tgs.BlockDiagSpec(kL, bL1, bL2)
    rspec = tgs.BlockDiagSpec(kR, bR1, bR2)
    sigma = rng.permutation(s)
    return tgs.GSLayout(
        lspec=lspec, rspec=rspec,
        perm_left=tperm.PermSpec.from_sigma(rng.permutation(lspec.out_dim)),
        perm_mid=tperm.PermSpec.from_sigma(sigma),
        perm_right=tperm.PermSpec.from_sigma(rng.permutation(rspec.in_dim)))


def _factors(rng, lay):
    return (rng.normal(size=lay.lspec.param_shape),
            rng.normal(size=lay.rspec.param_shape))


# ---------------------------------------------------------------------------
# permutations (tests/test_permutations.py)
# ---------------------------------------------------------------------------

def divisor_pairs():
    return st.integers(1, 8).flatmap(
        lambda k: st.integers(1, 8).map(lambda m: (k, k * m)))


@settings(max_examples=30, deadline=None)
@given(divisor_pairs())
def test_sigmas_and_inverse_match_jax(kn):
    k, n = kn
    s = tperm.gs_sigma(k, n)
    np.testing.assert_array_equal(s, jperm.gs_sigma(k, n))
    assert tperm.is_permutation(s) and jperm.is_permutation(s)
    inv = tperm.inverse_sigma(s)
    np.testing.assert_array_equal(inv, jperm.inverse_sigma(s))
    np.testing.assert_array_equal(inv, tperm.gs_sigma(n // k, n))
    if n % (2 * k) == 0:
        np.testing.assert_array_equal(tperm.paired_sigma(k, n),
                                      jperm.paired_sigma(k, n))


@pytest.mark.parametrize("kind", ["identity", "gs", "gs_inv", "paired",
                                  "paired_inv", "index"])
def test_every_perm_kind_matches_jax(kind):
    """sigma, inverse, matrix and apply / apply_T of every PermSpec kind,
    along a middle axis too (the gs kinds take the reshape path, the others
    the gather)."""
    k, n = 4, 32
    rng = np.random.default_rng(5)
    if kind == "index":
        spec = tperm.PermSpec.from_sigma(rng.permutation(n))
    else:
        spec = tperm.PermSpec(kind, k=k if kind != "identity" else 0)
    jspec = _jspec(spec)
    np.testing.assert_array_equal(spec.sigma(n), jspec.sigma(n))
    np.testing.assert_array_equal(spec.inverse().sigma(n),
                                  jspec.inverse().sigma(n))
    np.testing.assert_array_equal(spec.matrix(n), jspec.matrix(n))
    x = rng.normal(size=(3, n, 2)).astype(np.float32)
    for fn_t, fn_j in ((tperm.apply_perm, jperm.apply_perm),
                       (tperm.apply_perm_T, jperm.apply_perm_T)):
        got = fn_t(torch.from_numpy(x), spec, axis=1).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            fn_j(jnp.asarray(x), jspec, axis=1)))


def test_gs_reshape_path_backprops_the_inverse():
    x = torch.randn(2, 12, dtype=torch.float64, requires_grad=True)
    spec = tperm.PermSpec.gs(3)
    g = torch.randn(2, 12, dtype=torch.float64)
    (tperm.apply_perm(x, spec) * g).sum().backward()
    np.testing.assert_array_equal(
        x.grad.numpy(), tperm.apply_perm(g, spec.inverse()).numpy())


def test_definition_example_figure3_and_perm_matrix():
    s = tperm.gs_sigma(3, 12)
    np.testing.assert_array_equal(np.arange(12)[s],
                                  np.arange(12).reshape(3, 4).T.reshape(-1))
    P = tperm.perm_matrix(tperm.gs_sigma(4, 12))
    np.testing.assert_array_equal(P, jperm.perm_matrix(jperm.gs_sigma(4, 12)))
    x = np.random.default_rng(1).normal(size=12)
    np.testing.assert_allclose(P.T @ (P @ x), x)


def test_paired_sigma_keeps_pairs_and_mixes_groups():
    k, n = 4, 32
    s = tperm.paired_sigma(k, n)
    for i in range(0, n, 2):
        assert s[i + 1] == s[i] + 1 and s[i] % 2 == 0
    group = n // k
    src = [s[i] // group for i in range(0, group, 2)]
    assert len(set(src)) == min(k, group // 2)


def test_compose_sigma_matches_jax_and_the_matrix_product():
    s1, s2 = tperm.gs_sigma(3, 12), tperm.gs_sigma(4, 12)
    sc = tperm.compose_sigma(s1, s2)
    np.testing.assert_array_equal(sc, jperm.compose_sigma(s1, s2))
    np.testing.assert_array_equal(tperm.perm_matrix(sc),
                                  tperm.perm_matrix(s1) @ tperm.perm_matrix(s2))


def test_invalid_sizes_raise():
    with pytest.raises(ValueError):
        tperm.gs_sigma(5, 12)
    with pytest.raises(ValueError):
        tperm.paired_sigma(5, 12)
    with pytest.raises(ValueError):
        tperm.apply_perm(torch.zeros(12), tperm.PermSpec.gs(5))


# ---------------------------------------------------------------------------
# orthogonal (tests/test_orthogonal.py)
# ---------------------------------------------------------------------------

def test_cayley_inverse_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(2, 6, 6)) * 0.3).astype(np.float32)
    q = torth.cayley(torth.skew(torch.from_numpy(a)))
    jq = jorth.cayley(jorth.skew(jnp.asarray(a)))
    _close(q.numpy(), np.asarray(jq))
    k1 = torth.cayley_inverse(q)
    _close(k1.numpy(), np.asarray(jorth.cayley_inverse(jq)), 1e-4)
    _close(k1.numpy(), torth.skew(torch.from_numpy(a)).numpy(), 1e-4)
    _close(torth.cayley(k1).numpy(), q.numpy(), 1e-5)


def test_orthogonal_blocks_and_error_match_jax():
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(8, 16, 16)) * 0.5).astype(np.float32)
    q = torth.orthogonal_blocks(torch.from_numpy(a))
    jq = jorth.orthogonal_blocks(jnp.asarray(a))
    _close(q.numpy(), np.asarray(jq))
    err = float(torth.orthogonality_error(q))
    assert err < 1e-5
    assert abs(err - float(jorth.orthogonality_error(jq))) < 1e-5


def test_project_orthogonal_matches_jax_polar_factor():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(3, 7, 7)).astype(np.float32)
    q = torth.project_orthogonal(torch.from_numpy(a))
    _close(q.numpy(), np.asarray(jorth.project_orthogonal(jnp.asarray(a))),
           1e-4)
    assert float(torth.orthogonality_error(q)) < 1e-4


def test_random_orthogonal_blocks_equal_jax_from_one_numpy_seed():
    q = torth.random_orthogonal_blocks(np.random.default_rng(7), 4, 5,
                                       device="cpu")
    jq = jorth.random_orthogonal_blocks(np.random.default_rng(7), 4, 5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    gen = torch.Generator().manual_seed(0)
    qt = torth.random_orthogonal_blocks(gen, 4, 5)
    assert float(torth.orthogonality_error(qt)) < 1e-5


def test_orthogonal_gs_matrix_is_orthogonal_and_matches_jax():
    rng = np.random.default_rng(4)
    lay = tgs.gsoft_layout(32, 8)
    a, b = (rng.normal(size=lay.lspec.param_shape).astype(np.float32)
            for _ in range(2))
    L = torth.orthogonal_blocks(torch.from_numpy(a))
    R = torth.orthogonal_blocks(torch.from_numpy(b))
    A = tgs.gs_materialize(lay, L, R).numpy()
    jA = jgs.gs_materialize(_jlayout(lay),
                            jorth.orthogonal_blocks(jnp.asarray(a)),
                            jorth.orthogonal_blocks(jnp.asarray(b)))
    _close(A, jA)
    np.testing.assert_allclose(A.T @ A, np.eye(32), atol=1e-5)


def test_theorem1_block_orthogonal_representation():
    rng = np.random.default_rng(5)
    lay = tgs.gsoft_layout(24, 6)
    L = jorth.random_orthogonal_blocks(rng, *lay.lspec.param_shape[:2])
    R = jorth.random_orthogonal_blocks(rng, *lay.rspec.param_shape[:2])
    A = np.asarray(jgs.gs_materialize(_jlayout(lay), L, R), np.float64)
    L2, R2 = tproj.project_to_gs(A, lay)
    A2 = tgs.gs_materialize(lay, L2, R2).numpy()
    np.testing.assert_allclose(A2, A, atol=1e-8)
    jL2, jR2 = jproj.project_to_gs(A, _jlayout(lay))
    np.testing.assert_allclose(
        A2, jgs.gs_materialize(_jlayout(lay), jL2, jR2), atol=F64_ATOL)
    for blk in L2.numpy():
        g = blk.T @ blk
        d = np.sqrt(np.diag(g))
        np.testing.assert_allclose(g / np.outer(d, d), np.eye(blk.shape[1]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the two-factor class (tests/test_gs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_apply_matches_jax_and_materialize(seed):
    rng = np.random.default_rng(seed)
    lay = _random_layout(rng)
    jlay = _jlayout(lay)
    L, R = (a.astype(np.float32) for a in _factors(rng, lay))
    x = rng.normal(size=(3, lay.in_dim)).astype(np.float32)
    y = tgs.gs_apply(lay, torch.from_numpy(L), torch.from_numpy(R),
                     torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jgs.gs_apply(jlay, jnp.asarray(L), jnp.asarray(R),
                                      jnp.asarray(x))))
    A = tgs.gs_materialize(lay, L.astype(np.float64), R.astype(np.float64))
    np.testing.assert_allclose(A.numpy(), jgs.gs_materialize(
        jlay, L.astype(np.float64), R.astype(np.float64)), atol=F64_ATOL)
    _close(y, x @ A.numpy().T)


@pytest.mark.parametrize("seed", range(4))
def test_apply_T_matches_jax_and_materialize(seed):
    rng = np.random.default_rng(seed + 10)
    lay = _random_layout(rng)
    L, R = (a.astype(np.float32) for a in _factors(rng, lay))
    x = rng.normal(size=(2, lay.out_dim)).astype(np.float32)
    y = tgs.gs_apply_T(lay, torch.from_numpy(L), torch.from_numpy(R),
                       torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jgs.gs_apply_T(_jlayout(lay), jnp.asarray(L),
                                        jnp.asarray(R), jnp.asarray(x))))
    A = tgs.gs_materialize(lay, L.astype(np.float64), R.astype(np.float64))
    _close(y, x @ A.numpy())


@pytest.mark.parametrize("d,b,n", [(12, 4, 7), (32, 8, 5), (24, 6, 3)])
def test_gs_matmul_weight_side_matches_jax(d, b, n):
    rng = np.random.default_rng(3)
    lay = tgs.gsoft_layout(d, b)
    L, R = (a.astype(np.float32) for a in _factors(rng, lay))
    W = rng.normal(size=(d, n)).astype(np.float32)
    got = tgs.gs_matmul(lay, torch.from_numpy(L), torch.from_numpy(R),
                        torch.from_numpy(W)).numpy()
    _close(got, np.asarray(jgs.gs_matmul(_jlayout(lay), jnp.asarray(L),
                                         jnp.asarray(R), jnp.asarray(W))))
    A = tgs.gs_materialize(lay, L.astype(np.float64), R.astype(np.float64))
    _close(got, A.numpy() @ W)


def test_rectangular_blocks_apply_matches_jax():
    """L of (2, 3, 6) blocks and R of (3, 4, 2): rows != cols on both
    factors, the shapes the bdmm kernel takes on the card."""
    rng = np.random.default_rng(11)
    lay = tgs.GSLayout(lspec=tgs.BlockDiagSpec(2, 3, 6),
                       rspec=tgs.BlockDiagSpec(3, 4, 2),
                       perm_left=tperm.PermSpec.identity(),
                       perm_mid=tperm.PermSpec.gs(3),
                       perm_right=tperm.PermSpec.identity())
    L, R = (a.astype(np.float32) for a in _factors(rng, lay))
    x = rng.normal(size=(5, lay.in_dim)).astype(np.float32)
    args_t = (torch.from_numpy(L), torch.from_numpy(R))
    args_j = (jnp.asarray(L), jnp.asarray(R))
    _close(tgs.gs_apply(lay, *args_t, torch.from_numpy(x)).numpy(),
           np.asarray(jgs.gs_apply(_jlayout(lay), *args_j, jnp.asarray(x))))
    xo = rng.normal(size=(5, lay.out_dim)).astype(np.float32)
    _close(tgs.gs_apply_T(lay, *args_t, torch.from_numpy(xo)).numpy(),
           np.asarray(jgs.gs_apply_T(_jlayout(lay), *args_j,
                                     jnp.asarray(xo))))


@pytest.mark.parametrize("seed", range(5))
def test_proposition1_block_lowrank_matches_jax(seed):
    rng = np.random.default_rng(seed + 20)
    lay = _random_layout(rng)
    lay = tgs.GSLayout(lay.lspec, lay.rspec, tperm.PermSpec.identity(),
                       lay.perm_mid, tperm.PermSpec.identity())
    L, R = _factors(rng, lay)
    via_prop = tgs.lowrank_blocks(lay, L, R).numpy()
    np.testing.assert_allclose(via_prop, tgs.gs_materialize(lay, L, R).numpy(),
                               atol=F64_ATOL)
    np.testing.assert_allclose(via_prop, jgs.lowrank_blocks(_jlayout(lay), L, R),
                               atol=F64_ATOL)
    np.testing.assert_array_equal(tgs.block_ranks(lay),
                                  jgs.block_ranks(_jlayout(lay)))


def test_block_ranks_figure2_example():
    lay = tgs.GSLayout(lspec=tgs.BlockDiagSpec(4, 3, 3),
                       rspec=tgs.BlockDiagSpec(2, 6, 6),
                       perm_left=tperm.PermSpec.identity(),
                       perm_mid=tperm.PermSpec.gs(4),
                       perm_right=tperm.PermSpec.identity())
    ranks = tgs.block_ranks(lay)
    assert ranks.shape == (4, 2) and ranks.sum() == 12
    np.testing.assert_array_equal(ranks, jgs.block_ranks(_jlayout(lay)))


def test_materialize_block_diag_matches_jax():
    blocks = np.random.default_rng(0).normal(size=(3, 2, 4))
    np.testing.assert_array_equal(tgs.materialize_block_diag(blocks).numpy(),
                                  jgs.materialize_block_diag(blocks))


def test_monarch_constraint_not_required():
    lay = tgs.gsoft_layout(16, 8)
    assert lay.lspec.num_blocks == 2 and lay.lspec.rows == 8
    rng = np.random.default_rng(0)
    L, R = (torch.from_numpy(a.astype(np.float32)) for a in _factors(rng, lay))
    assert tgs.gs_apply(lay, L, R, torch.randn(16)).shape == (16,)


def test_init_blocks_match_jax():
    spec = tgs.BlockDiagSpec(3, 4, 5)
    jspec = jgs.BlockDiagSpec(3, 4, 5)
    got = tgs.init_blocks(spec, np.random.default_rng(3), device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgs.init_blocks(jspec,
                                                np.random.default_rng(3))))
    sq = tgs.BlockDiagSpec(2, 4, 4)
    np.testing.assert_array_equal(
        tgs.init_blocks(sq, identity=True, device="cpu").numpy(),
        np.asarray(jgs.init_blocks(jgs.BlockDiagSpec(2, 4, 4),
                                   identity=True)))
    with pytest.raises(ValueError, match="square"):
        tgs.init_blocks(spec, identity=True, device="cpu")


# ---------------------------------------------------------------------------
# Theorem 2 — density, higher-order GS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,r", [(2, 4), (4, 4), (2, 8), (4, 16), (3, 9)])
def test_theorem2_density_matches_jax(b, r):
    d = b * r
    m = tgs.min_factors_dense(b, r)
    assert m == jgs.min_factors_dense(b, r)
    assert m == 1 + math.ceil(math.log(r, b) - 1e-12)
    dense = tgs.gs_order_layout(d, b, m)
    assert tgs.is_dense_class(dense)
    np.testing.assert_array_equal(tgs.support_pattern(dense),
                                  jgs.support_pattern(_jfactors(dense)))
    if m > 1:
        thin = tgs.gs_order_layout(d, b, m - 1)
        assert not tgs.is_dense_class(thin)
        assert not jgs.is_dense_class(_jfactors(thin))
        np.testing.assert_array_equal(tgs.support_pattern(thin),
                                      jgs.support_pattern(_jfactors(thin)))


def test_theorem2_beats_butterfly_count():
    assert tgs.min_factors_dense(32, 32) == 2 == jgs.min_factors_dense(32, 32)
    assert 1 + math.ceil(math.log2(32)) == 6
    assert tgs.min_factors_dense(8, 1) == 1
    with pytest.raises(ValueError, match="densify"):
        tgs.min_factors_dense(1, 4)


def test_gsoft_layout_dense_when_r_le_b():
    lay = tgs.gsoft_layout(64, 8)
    factors = tgs.GSFactors(
        specs=(lay.rspec, lay.lspec),
        perms=(lay.perm_right, lay.perm_mid, lay.perm_left))
    assert tgs.is_dense_class(factors)
    assert jgs.is_dense_class(_jfactors(factors))


def test_pick_block_size_matches_jax():
    for d in (64, 96, 1024, 4096, 12288, 29568):
        for target in (8, 32, 64):
            assert tgs.pick_block_size(d, target) == \
                jgs.pick_block_size(d, target)


@pytest.mark.parametrize("d,b,m", [(27, 3, 3), (64, 4, 3), (32, 8, 2)])
def test_higher_order_apply_matches_jax_and_materialize(d, b, m):
    rng = np.random.default_rng(7)
    f = tgs.gs_order_layout(d, b, m)
    blocks = [rng.normal(size=s.param_shape).astype(np.float32)
              for s in f.specs]
    x = rng.normal(size=(2, d)).astype(np.float32)
    y = tgs.gs_factors_apply(f, [torch.from_numpy(a) for a in blocks],
                             torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jgs.gs_factors_apply(
        _jfactors(f), [jnp.asarray(a) for a in blocks], jnp.asarray(x))))
    b64 = [a.astype(np.float64) for a in blocks]
    A = tgs.gs_factors_materialize(f, b64).numpy()
    np.testing.assert_allclose(A, jgs.gs_factors_materialize(_jfactors(f),
                                                             b64),
                               atol=F64_ATOL)
    _close(y, x @ A.T)


def test_param_counts_match_jax():
    lay = tgs.gsoft_layout(1024, 32)
    assert lay.num_params == 2 * 1024 * 32
    assert lay.num_params == jgs.gsoft_layout(1024, 32).num_params
    f = tgs.gs_order_layout(1024, 32, 3)
    assert f.num_params == jgs.gs_order_layout(1024, 32, 3).num_params
    with pytest.raises(ValueError, match="inner dims"):
        tgs.GSLayout(tgs.BlockDiagSpec(2, 3, 3), tgs.BlockDiagSpec(2, 4, 4),
                     tperm.PermSpec.identity(), tperm.PermSpec.identity(),
                     tperm.PermSpec.identity())


# ---------------------------------------------------------------------------
# one layout class (the repair): gsoft_layout returns a GSLayout
# ---------------------------------------------------------------------------

# every (d, b) the port's GS tests and smoke configs use
LAYOUT_DB = ([(r * b, b) for r, b in [(2, 8), (4, 4), (8, 2), (6, 4), (3, 5)]]
             + [(64, 8), (128, 8), (256, 8), (128, 32), (24, 6), (12, 4),
                (16, 8), (32, 8), (1024, 32)])


@pytest.mark.parametrize("d,b", LAYOUT_DB)
def test_gsoft_layout_is_a_gslayout_with_the_old_maps_and_q(d, b):
    """The former GSOFTLayout's gather maps were sigma_mid = gs_sigma(r, d)
    and sigma_left = its inverse, and its Q = eye[sigma_left] @ diag(L) @
    eye[sigma_mid] @ diag(R): the GSLayout gives the same maps and the same
    Q, and JAX's layout gives the same again."""
    lay = tgs.gsoft_layout(d, b)
    assert isinstance(lay, tgs.GSLayout) and not hasattr(tgs, "GSOFTLayout")
    r = d // b
    sigma_mid = tperm.gs_sigma(r, d)
    sigma_left = tperm.inverse_sigma(sigma_mid)
    np.testing.assert_array_equal(lay.perm_mid.sigma(d), sigma_mid)
    np.testing.assert_array_equal(lay.perm_left.sigma(d), sigma_left)
    np.testing.assert_array_equal(lay.perm_right.sigma(d), np.arange(d))
    jlay = jgs.gsoft_layout(d, b)
    assert lay.lspec.param_shape == jlay.lspec.param_shape == (r, b, b)
    rng = np.random.default_rng(d + b)
    L, R = rng.normal(size=(r, b, b)), rng.normal(size=(r, b, b))
    eye = np.eye(d)
    old_q = (eye[sigma_left] @ tgs.materialize_block_diag(L).numpy()
             @ eye[sigma_mid] @ tgs.materialize_block_diag(R).numpy())
    q = tgs.gs_materialize(lay, L, R).numpy()
    np.testing.assert_allclose(q, old_q, atol=F64_ATOL)
    np.testing.assert_allclose(q, jgs.gs_materialize(jlay, L, R),
                               atol=F64_ATOL)


def test_core_exports_the_jax_public_names():
    import types
    from repro import core as jcore
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), types.ModuleType)]
    assert len(names) > 50
    assert [n for n in names if not hasattr(tcore, n)] == []


# ---------------------------------------------------------------------------
# Algorithm 1 (tests/test_projection.py)
# ---------------------------------------------------------------------------

def _assert_projection_matches_jax(A, lay):
    """The port's projection reconstructs what JAX's does and recovers the
    same error; every L column and R row agrees up to the sign an SVD may
    pick (u and v flip together)."""
    L, R = tproj.project_to_gs(A, lay)
    assert L.dtype == torch.float64
    jL, jR = jproj.project_to_gs(A, _jlayout(lay))
    A1 = tgs.gs_materialize(lay, L, R).numpy()
    np.testing.assert_allclose(
        A1, jgs.gs_materialize(_jlayout(lay), jL, jR), atol=1e-9)
    err = tproj.gs_reconstruction_error(A, lay, L, R)
    jerr = jproj.gs_reconstruction_error(A, _jlayout(lay), jL, jR)
    assert abs(err - jerr) <= 1e-9 * max(1.0, jerr)
    np.testing.assert_allclose(np.abs(L.numpy()), np.abs(jL), atol=1e-8)
    np.testing.assert_allclose(np.abs(R.numpy()), np.abs(jR), atol=1e-8)
    return L, R, err


def test_exact_recovery_for_class_members():
    rng = np.random.default_rng(0)
    lay = tgs.gsoft_layout(24, 6)
    A = tgs.gs_materialize(lay, *_factors(rng, lay)).numpy()
    _, _, err = _assert_projection_matches_jax(A, lay)
    assert err < 1e-8


def test_idempotence():
    rng = np.random.default_rng(1)
    lay = tgs.gsoft_layout(24, 6)
    A = rng.normal(size=(lay.out_dim, lay.in_dim))
    L1, R1, _ = _assert_projection_matches_jax(A, lay)
    A1 = tgs.gs_materialize(lay, L1, R1)
    L2, R2 = tproj.project_to_gs(A1, lay)
    np.testing.assert_allclose(tgs.gs_materialize(lay, L2, R2).numpy(),
                               A1.numpy(), atol=1e-8)


def test_projection_beats_random_candidates():
    rng = np.random.default_rng(2)
    lay = tgs.gsoft_layout(16, 4)
    A = rng.normal(size=(16, 16))
    _, _, err_opt = _assert_projection_matches_jax(A, lay)
    for _ in range(10):
        Lr, Rr = _factors(rng, lay)
        assert err_opt <= tproj.gs_reconstruction_error(A, lay, Lr, Rr) + 1e-9


def test_projection_with_outer_permutations():
    rng = np.random.default_rng(3)
    d, b = 24, 6
    spec = tgs.BlockDiagSpec(d // b, b, b)
    lay = tgs.GSLayout(
        lspec=spec, rspec=spec,
        perm_left=tperm.PermSpec.from_sigma(rng.permutation(d)),
        perm_mid=tperm.PermSpec.gs(d // b),
        perm_right=tperm.PermSpec.from_sigma(rng.permutation(d)))
    A = tgs.gs_materialize(lay, *_factors(rng, lay)).numpy()
    _, _, err = _assert_projection_matches_jax(A, lay)
    assert err < 1e-8


def test_projection_rectangular_blocks():
    rng = np.random.default_rng(4)
    lay = tgs.GSLayout(lspec=tgs.BlockDiagSpec(2, 3, 6),
                       rspec=tgs.BlockDiagSpec(3, 4, 2),
                       perm_left=tperm.PermSpec.identity(),
                       perm_mid=tperm.PermSpec.gs(3),
                       perm_right=tperm.PermSpec.identity())
    A = rng.normal(size=(lay.out_dim, lay.in_dim))
    L, R, _ = _assert_projection_matches_jax(A, lay)
    assert tuple(L.shape) == lay.lspec.param_shape
    assert tuple(R.shape) == lay.rspec.param_shape
    A1 = tgs.gs_materialize(lay, L, R)
    L2, R2 = tproj.project_to_gs(A1, lay)
    assert tproj.gs_reconstruction_error(A1, lay, L2, R2) < 1e-8


@pytest.mark.parametrize("seed", range(4))
def test_projection_of_random_layouts_matches_jax(seed):
    """Random middle permutations give buckets of mixed ranks (batched SVD
    groups of several sizes), surplus budget included."""
    rng = np.random.default_rng(seed + 40)
    lay = _random_layout(rng)
    A = rng.normal(size=(lay.out_dim, lay.in_dim))
    _assert_projection_matches_jax(A, lay)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tproj.project_to_gs(np.zeros((3, 3)), tgs.gsoft_layout(24, 6))


def test_f32_input_on_the_cpu_is_projected_in_f64():
    lay = tgs.gsoft_layout(16, 4)
    A = torch.randn(16, 16, dtype=torch.float32)
    L, _ = tproj.project_to_gs(A, lay)
    assert L.dtype == torch.float64
    assert tproj.compute_dtype(torch.device("cpu")) == torch.float64


# ---------------------------------------------------------------------------
# properties (tests/test_properties.py, the GS cases)
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(st.integers(1, 6), st.integers(1, 6), st.integers(0, 10 ** 6))
def test_orthogonal_gs_always_orthogonal(b, r, seed):
    d = b * r
    rng = np.random.default_rng(seed)
    lay = tgs.gsoft_layout(d, b)
    a, c = (rng.normal(size=lay.lspec.param_shape).astype(np.float32)
            for _ in range(2))
    L = torth.cayley(torth.skew(torch.from_numpy(a)))
    R = torth.cayley(torth.skew(torch.from_numpy(c)))
    A = tgs.gs_materialize(lay, L, R).numpy()
    assert np.abs(A.T @ A - np.eye(d)).max() < 1e-4
    jA = jgs.gs_materialize(_jlayout(lay), jorth.cayley(jorth.skew(
        jnp.asarray(a))), jorth.cayley(jorth.skew(jnp.asarray(c))))
    _close(A, jA, 1e-5)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(0, 10 ** 5))
def test_projection_never_increases_error_vs_zero(kl, kr, seed):
    rng = np.random.default_rng(seed)
    s = int(np.lcm(kl, kr)) * 2
    lay = tgs.GSLayout(lspec=tgs.BlockDiagSpec(kl, 3, s // kl),
                       rspec=tgs.BlockDiagSpec(kr, s // kr, 2),
                       perm_left=tperm.PermSpec.identity(),
                       perm_mid=tperm.PermSpec.from_sigma(rng.permutation(s)),
                       perm_right=tperm.PermSpec.identity())
    A = rng.normal(size=(lay.out_dim, lay.in_dim))
    L, R = tproj.project_to_gs(A, lay)
    err = tproj.gs_reconstruction_error(A, lay, L, R)
    assert err <= np.linalg.norm(A) + 1e-9
    jL, jR = jproj.project_to_gs(A, _jlayout(lay))
    assert abs(err - jproj.gs_reconstruction_error(A, _jlayout(lay), jL, jR)
               ) <= 1e-9 * max(1.0, err)
