"""The port's adapter-method registry against the JAX package on the CPU:
OFT, BOFT, Householder, Givens and LoRA (beside GSOFT and Double GSOFT),
the bdmm entry points and their gradients against the Pallas kernels in
interpret mode, the permutations and plain banked rotations, the
mixed-method ``AdapterBank`` served by ``ServeEngine`` at the qwen2-72b
smoke config in f32 (exact greedy tokens), its configuration errors, one
train step per method against JAX's ``build_train_step``, and the launcher.
Inputs come from numpy seeds and go to both packages; weights and adapters
are carried across by ``repro_torch.convert``."""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import adapters as jad  # noqa: E402
from repro.core import methods as jmethods  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import LMDataSource as JLMDataSource  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import adapters as tad  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core import permutations as tperm  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
NEW_METHODS = ["oft", "boft", "householder", "givens", "lora"]
ACT_METHODS = [m for m in methods.registered()
               if methods.get(m).apply_activation_side is not None]
# f32 on both sides: the same algorithm with sums in another order; max
# |diff| within 1e-5 of the largest magnitude (1e-6 absolute at init)
F32_REL = 1e-5
IDENTITY_ATOL = 1e-6
# x @ (Q W) against (x Q) @ W in f32: two products in another order
MERGE_ATOL = 1e-4
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


def _specs(method, **kw):
    kw = dict(dict(d_in=16, d_out=24, block_size=4, reflections=4), **kw,
              method=method)
    return jad.AdapterSpec(**kw), tad.AdapterSpec(**kw)


def _noisy_params(jspec, seed=3, scale=0.3):
    p = jad.init_adapter(jspec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v) + scale * rng.normal(size=v.shape).astype(np.float32)
            for k, v in p.items()}


# ---------------------------------------------------------------------------
# registry surface
# ---------------------------------------------------------------------------

def test_registry_has_the_jax_entries():
    assert methods.registered() == jmethods.registered() == [
        "boft", "double_gsoft", "givens", "gsoft", "householder", "lora", "oft"]
    for m in methods.registered():
        t, j = methods.get(m), jmethods.get(m)
        assert (t.structure, t.orthogonal, t.banked_kernel,
                t.bank_unsupported) == (j.structure, j.orthogonal,
                                        j.banked_kernel, j.bank_unsupported)
        assert (t.bank_build is None) == (j.bank_build is None)
        assert ((t.apply_activation_side is None)
                == (j.apply_activation_side is None))


def test_unknown_method_raises_keyerror_listing_registered():
    with pytest.raises(KeyError, match="monarch") as ei:
        methods.get("monarch")
    for m in ("gsoft", "boft", "householder", "lora", "oft", "givens"):
        assert m in str(ei.value)
    with pytest.raises(KeyError, match="monarch"):
        tad.init_adapter(_specs("monarch")[1], device=CPU)
    with pytest.raises(KeyError, match="retnofit"):
        methods.trainable_split("retnofit", {}, {})


def test_householder_rejects_odd_reflections():
    with pytest.raises(ValueError, match="EVEN"):
        tad.init_adapter(_specs("householder", reflections=3)[1], device=CPU)
    with pytest.raises(ValueError, match="positive round count"):
        tad.init_adapter(_specs("givens", givens_rounds=0)[1], device=CPU)


def test_no_method_string_dispatch_outside_registry():
    """As tests/test_methods.py guards the JAX package: raw ``method ==``
    dispatch outside core/methods.py forks the registry."""
    pat = re.compile(r"\bmethod\s*==")
    offenders = []
    for path in SRC.rglob("*.py"):
        if path.name == "methods.py" and path.parent.name == "core":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pat.search(line):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


# ---------------------------------------------------------------------------
# per-method numerics against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", methods.registered())
def test_identity_init_and_params_match_jax(method):
    """W_eff == W at init; the init tree has JAX's keys and shapes (LoRA's
    random A is drawn by each package's own generator, so only its shape
    and B = 0 compare); the analytic count equals JAX's and the tree's."""
    jspec, tspec = _specs(method)
    jp = jad.init_adapter(jspec, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = tad.init_adapter(tspec, gen, device=CPU)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        if method != "lora" or k == "B":
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    W = np.random.default_rng(1).normal(size=(16, 24)).astype(np.float32)
    np.testing.assert_allclose(tad.materialize(tspec, tp, _t(W)).numpy(), W,
                               atol=IDENTITY_ATOL)
    for batch, use_scale in (((), False), ((3,), True)):
        jb, tb = _specs(method, batch=batch, use_scale=use_scale)
        counted = sum(int(v.numel()) for v in
                      tad.init_adapter(tb, gen, device=CPU).values())
        assert tad.num_adapter_params(tb) == jad.num_adapter_params(jb) == counted


@pytest.mark.parametrize("method", methods.registered())
@pytest.mark.parametrize("batch", [(), (2,)])
def test_materialize_matches_jax(method, batch):
    jspec, tspec = _specs(method, batch=batch)
    params = _noisy_params(jspec)
    W = np.random.default_rng(5).normal(size=batch + (16, 24)).astype(np.float32)
    want = jad.materialize(jspec, {k: _j(v) for k, v in params.items()}, _j(W))
    got = tad.materialize(tspec, {k: _t(v) for k, v in params.items()}, _t(W))
    _close(_np(got), _np(want), F32_REL, f"{method} W_eff")


@pytest.mark.parametrize("method", ACT_METHODS)
def test_activation_side_matches_jax_and_the_merge(method):
    """x Q against JAX's, and x @ (Q W) == (x Q) @ W (the contract banked
    serving relies on), with the merge through ``tad.merge``."""
    jspec, tspec = _specs(method)
    params = _noisy_params(jspec)
    rng = np.random.default_rng(9)
    W = rng.normal(size=(16, 24)).astype(np.float32)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    tp = {k: _t(v) for k, v in params.items()}
    want = jad.apply_activation_side(jspec, {k: _j(v) for k, v in params.items()},
                                     _j(x))
    got = tad.apply_activation_side(tspec, tp, _t(x))
    _close(_np(got), _np(want), F32_REL, f"{method} x Q")
    np.testing.assert_allclose((got @ _t(W)).numpy(),
                               (_t(x) @ tad.merge(tspec, tp, _t(W))).numpy(),
                               atol=MERGE_ATOL)


def test_lora_has_no_activation_side_form():
    with pytest.raises(ValueError, match="activation-side not defined"):
        tad.apply_activation_side(_specs("lora")[1], {}, torch.zeros(2, 16))


@pytest.mark.parametrize("method", NEW_METHODS)
def test_adapter_loss_gradients_match_jax(method):
    """The port's gradients through ``materialize`` (bdmm kernels' autograd
    rule for OFT / BOFT, autograd of plain torch for the others) against
    jax.grad of the JAX materialization."""
    jspec, tspec = _specs(method, d_in=32, block_size=8)
    params = _noisy_params(jspec, seed=7, scale=0.05)
    rng = np.random.default_rng(7)
    W = rng.normal(size=(32, 24)).astype(np.float32)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    tgt = rng.normal(size=(16, 24)).astype(np.float32)

    def jloss(p):
        return jnp.mean((_j(x) @ jad.materialize(jspec, p, _j(W)) - _j(tgt)) ** 2)

    jl, jg = jax.value_and_grad(jloss)({k: _j(v) for k, v in params.items()})
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    tl = torch.mean((_t(x) @ tad.materialize(tspec, tp, _t(W)) - _t(tgt)) ** 2)
    tg = torch.autograd.grad(tl, [tp[k] for k in sorted(tp)])
    _close(float(tl.detach()), float(jl), F32_REL, "loss")
    for k, g in zip(sorted(tp), tg):
        _close(_np(g), _np(jg[k]), F32_REL, f"{method} d{k}")


# ---------------------------------------------------------------------------
# bdmm entry points (kernels 5-6) against the Pallas kernels
# ---------------------------------------------------------------------------

# (r, bo, bi, T) as tests/test_kernel_grads.py BDMM_GRAD_SHAPES: square,
# rectangular with ragged T, odd sizes, many small blocks
BDMM_SHAPES = [(4, 8, 8, 16), (2, 8, 4, 33), (3, 5, 9, 64), (16, 4, 4, 250)]


@pytest.mark.parametrize("r,bo,bi,t", BDMM_SHAPES)
def test_ops_bdmm_and_gradients_match_jax_pallas(r, bo, bi, t):
    rng = np.random.default_rng(r + 10 * bo + 100 * bi + t)
    blocks = rng.normal(size=(r, bo, bi)).astype(np.float32)
    x = rng.normal(size=(3, t, r * bi)).astype(np.float32)
    cot = rng.normal(size=(3, t, r * bo)).astype(np.float32)

    def jloss(w, xx):
        return jnp.sum(jops.bdmm(w, xx, use_pallas=True) * _j(cot))

    jy = jops.bdmm(_j(blocks), _j(x), use_pallas=True)
    jg = jax.grad(jloss, argnums=(0, 1))(_j(blocks), _j(x))
    tw, tx = _t(blocks).requires_grad_(), _t(x).requires_grad_()
    ty = tops.bdmm(tw, tx)
    assert ty.grad_fn is not None
    _close(_np(ty), _np(jy), F32_REL, "y")
    tg = torch.autograd.grad((ty * _t(cot)).sum(), (tw, tx))
    for name, got, want in zip(("dblocks", "dx"), tg, jg):
        _close(_np(got), _np(want), F32_REL, name)


# (B, r, bo, bi, T): as tests/test_kernels.py test_ops_bdmm_banked_paths_agree,
# plus a rectangular case
BANKED_SHAPES = [(3, 4, 8, 8, 5), (2, 8, 16, 16, 33), (2, 3, 8, 4, 7)]


@pytest.mark.parametrize("bsz,r,bo,bi,t", BANKED_SHAPES)
def test_ops_bdmm_banked_and_gradients_match_jax_pallas(bsz, r, bo, bi, t):
    rng = np.random.default_rng(bsz + r + bo + bi + t)
    blocks = rng.normal(size=(bsz, r, bo, bi)).astype(np.float32)
    x = rng.normal(size=(bsz, t, r * bi)).astype(np.float32)
    cot = rng.normal(size=(bsz, t, r * bo)).astype(np.float32)

    def jloss(w, xx):
        return jnp.sum(jops.bdmm_banked(w, xx, use_pallas=True) * _j(cot))

    jy = jops.bdmm_banked(_j(blocks), _j(x), use_pallas=True)
    jg = jax.grad(jloss, argnums=(0, 1))(_j(blocks), _j(x))
    tw, tx = _t(blocks).requires_grad_(), _t(x).requires_grad_()
    ty = tops.bdmm_banked(tw, tx)
    _close(_np(ty), _np(jy), F32_REL, "y")
    tg = torch.autograd.grad((ty * _t(cot)).sum(), (tw, tx))
    for name, got, want in zip(("dblocks", "dx"), tg, jg):
        _close(_np(got), _np(want), F32_REL, name)


# (B, r, p, q, T): stored blocks (p, q) read transposed, so the product's
# (bo, bi) = (q, p): square, rectangular with ragged T, odd sizes
TRANS_SHAPES = [(2, 4, 8, 8, 16), (1, 3, 4, 8, 33), (2, 2, 9, 5, 7)]


@pytest.mark.parametrize("bsz,r,p,q,t", TRANS_SHAPES)
def test_bdmm_transposed_blocks_match_jax_pallas_of_the_transpose(bsz, r, p, q,
                                                                  t):
    """``bk.bdmm(x, Q, transpose_blocks=True)`` is JAX's ``bdmm_pallas(Q^T,
    x)`` (interpret mode), row by row; ``bdmm_diff``'s gradients are those
    of JAX's ``bdmm_diff`` rule through the transpose."""
    from repro.kernels import dispatch as jdispatch
    from repro.kernels.bdmm import bdmm_pallas
    from repro_torch.kernels import bdmm as tbk
    from repro_torch.kernels import dispatch as tdispatch
    rng = np.random.default_rng(bsz + r + p + q + t)
    Q = rng.normal(size=(bsz, r, p, q)).astype(np.float32)
    x = rng.normal(size=(bsz, t, r * p)).astype(np.float32)
    cot = rng.normal(size=(bsz, t, r * q)).astype(np.float32)
    tun = jdispatch.Tuning()
    jy, jgq, jgx = [], [], []
    for z in range(bsz):
        jy.append(bdmm_pallas(jnp.swapaxes(_j(Q[z]), -1, -2), _j(x[z]),
                              interpret=True))

        def jloss(w, xx):
            y = jdispatch.bdmm_diff(tun, True, jnp.swapaxes(w, -1, -2), xx)
            return jnp.sum(y * _j(cot[z]))

        gq, gx = jax.grad(jloss, argnums=(0, 1))(_j(Q[z]), _j(x[z]))
        jgq.append(gq)
        jgx.append(gx)
    ty = tbk.bdmm(_t(x), _t(Q), transpose_blocks=True)
    tq, tx = _t(Q).requires_grad_(), _t(x).requires_grad_()
    y = tdispatch.bdmm_diff(tq, tx, transpose_blocks=True)
    gq, gx = torch.autograd.grad((y * _t(cot)).sum(), (tq, tx))
    for what, got, want in (("y", ty, jy), ("dQ", gq, jgq), ("dx", gx, jgx)):
        np.testing.assert_allclose(_np(got), np.stack([_np(a) for a in want]),
                                   rtol=0, atol=1e-5, err_msg=what)
    # the banked entry point takes the flag through to the same rule
    tq2 = _t(Q).requires_grad_()
    yb = tops.bdmm_banked(tq2, _t(x), transpose_blocks=True)
    _close(_np(yb), _np(ty), 1e-6, "bdmm_banked")


def test_dblocks_plain_version_is_the_autodiff_of_bdmm_ref():
    rng = np.random.default_rng(2)
    blocks = rng.normal(size=(3, 5, 9)).astype(np.float32)
    x, = rng.normal(size=(1, 2, 11, 27)).astype(np.float32)
    dy = rng.normal(size=(2, 11, 15)).astype(np.float32)
    _, vjp = jax.vjp(lambda w, xx: jref.bdmm_ref(w, xx), _j(blocks), _j(x[0]))
    want, _ = vjp(_j(dy[0]))
    got = tref.bdmm_dblocks_ref(_t(dy), _t(x), 5, 9)
    assert tuple(got.shape) == (2, 3, 5, 9) and got.dtype == torch.float32
    _close(_np(got[0]), _np(want), F32_REL, "dblocks")


def test_plain_banked_rotations_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 17)).astype(np.float32)
    V = rng.normal(size=(3, 4, 17)).astype(np.float32)
    V /= np.linalg.norm(V, axis=-1, keepdims=True)
    _close(_np(tops.householder_banked(_t(V), _t(x))),
           _np(jref.householder_banked_ref(_j(V), _j(x))), F32_REL, "hh")
    theta = rng.normal(size=(3, 3, 8)).astype(np.float32)
    C, S = np.cos(theta), np.sin(theta)
    _close(_np(tops.givens_banked(_t(C), _t(S), _t(x))),
           _np(jref.givens_banked_ref(_j(C), _j(S), _j(x))), F32_REL, "givens")


@pytest.mark.parametrize("sigma", [
    np.random.default_rng(0).permutation(16),
    jperm.gs_sigma(4, 16),
    tad.butterfly_sigma(16, 4, 2),
], ids=["random", "gs", "butterfly"])
def test_permutations_match_jax_and_backprop_the_inverse_gather(sigma):
    n = 16
    jspec = jperm.PermSpec.from_sigma(sigma)
    tspec = tperm.PermSpec.from_sigma(sigma)
    np.testing.assert_array_equal(tspec.sigma(n), jspec.sigma(n))
    np.testing.assert_array_equal(tspec.inverse().sigma(n),
                                  jspec.inverse().sigma(n))
    x = np.random.default_rng(1).normal(size=(3, n, 2)).astype(np.float32)
    for axis in (-2, 1):
        np.testing.assert_array_equal(
            tperm.apply_perm(_t(x), tspec, axis=axis).numpy(),
            np.asarray(jperm.apply_perm(_j(x), jspec, axis=axis)))
        np.testing.assert_array_equal(
            tperm.apply_perm_T(_t(x), tspec, axis=axis).numpy(),
            np.asarray(jperm.apply_perm_T(_j(x), jspec, axis=axis)))
    tx = _t(x).requires_grad_()
    dy = torch.from_numpy(np.random.default_rng(2).normal(
        size=x.shape).astype(np.float32))
    (g,) = torch.autograd.grad((tperm.apply_perm(tx, tspec, axis=1) * dy).sum(),
                               tx)
    assert torch.equal(g, tperm.apply_perm_T(dy, tspec, axis=1))
    ident = tperm.PermSpec.identity()
    assert tperm.apply_perm(tx, ident) is tx and ident.inverse() == ident


def test_butterfly_levels_match_jax():
    for d, b in ((16, 4), (64, 8), (8192, 32), (29568, 32), (24, 4)):
        assert tad.max_butterfly_levels(d, b) == jad.max_butterfly_levels(d, b)
        for lvl in range(1, tad.max_butterfly_levels(d, b) + 1):
            np.testing.assert_array_equal(tad.butterfly_sigma(d, b, lvl),
                                          jad.butterfly_sigma(d, b, lvl))
    with pytest.raises(ValueError, match="even block size"):
        tad.butterfly_sigma(12, 3, 2)


# ---------------------------------------------------------------------------
# the mixed-method bank at the qwen2-72b smoke config, f32
# ---------------------------------------------------------------------------

JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")
MIXED = {
    "alice": dict(method="gsoft", block_size=8),
    "bob": dict(method="boft", block_size=8),
    "carol": dict(method="householder", reflections=4),
    "dave": dict(method="oft", block_size=8),
    "erin": dict(method="givens", givens_rounds=4),
}
JMIXED = {n: jpeft.PEFTConfig(**kw) for n, kw in MIXED.items()}
TMIXED = {n: tpeft.PEFTConfig(**kw) for n, kw in MIXED.items()}
PROMPT = [3, 4, 5, 6]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tuned(cfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(cfg, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    jadp = {n: _tuned(c, jrt.params, i * 7 + 3)
            for i, (n, c) in enumerate(JMIXED.items())}
    tparams = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    tadp = convert.adapters_from_numpy(_np_tree(jadp), device=CPU)
    return jrt, jadp, ModelRuntime(CFG, tparams, device=CPU), tadp


def _serve(engine, names):
    rids = {n: engine.add_request(PROMPT, max_new_tokens=5, adapter=n)
            for n in names}
    out = engine.run()
    return {n: out[r] for n, r in rids.items()}


@pytest.fixture(scope="module")
def mixed_tokens(world):
    jrt, jadp, rt, tadp = world
    names = list(MIXED) + [None]
    jtok = _serve(JaxEngine(jrt.attach(jadp, JMIXED), max_batch=4,
                            max_len=48, eos_id=-1), names)
    banked = rt.attach(tadp, TMIXED)
    ttok = _serve(ServeEngine(banked, max_batch=4, max_len=48, eos_id=-1),
                  names)
    return jtok, ttok, banked


def test_mixed_bank_tree_matches_jax(world, mixed_tokens):
    jrt, jadp, _, _ = world
    bank = mixed_tokens[2].bank
    assert bank.bank_methods == ("boft", "givens", "gsoft", "householder",
                                 "oft")
    assert bank.num_slots == 6 and bank.cfgs["bob"] == TMIXED["bob"]
    jbank = jpeft.build_adapter_bank(JMIXED, jrt.params, jadp)
    tflat = tpeft.flatten_paths(bank.tree)
    jflat = jpeft.flatten_paths(jbank.tree)
    assert sorted(tflat) == sorted(jflat)
    for path, leaf in jflat.items():
        _close(tflat[path].numpy(), np.asarray(leaf), F32_REL, path)


def test_mixed_bank_engine_tokens_equal_jax(mixed_tokens):
    jtok, ttok, _ = mixed_tokens
    assert ttok == jtok
    assert len({tuple(v) for v in ttok.values()}) == len(ttok)


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_bank_tenant_equals_its_solo_merged_run(world, mixed_tokens,
                                                      name):
    _, _, rt, tadp = world
    merged = ModelRuntime(CFG, rt.params, device=CPU, adapters=tadp[name],
                          peft_cfg=TMIXED[name])
    eng = ServeEngine(merged, max_batch=1, max_len=48, eos_id=-1)
    assert _serve(eng, [None])[None] == mixed_tokens[1][name]


def test_mixed_bank_base_slot_equals_bankless_model(world, mixed_tokens):
    _, _, rt, _ = world
    eng = ServeEngine(rt, max_batch=1, max_len=48, eos_id=-1)
    assert _serve(eng, [None])[None] == mixed_tokens[1][None]


def test_bank_rejects_weight_side_only_methods(world):
    """The error texts match tests/test_methods.py's regexes."""
    _, _, rt, tadp = world
    with pytest.raises(ValueError, match=r"'lora'.*weight-side"):
        rt.attach({"t": tadp["alice"]}, {"t": tpeft.PEFTConfig(method="lora")})
    with pytest.raises(ValueError, match="double_gsoft.*output-side"):
        rt.attach({}, tpeft.PEFTConfig(method="double_gsoft"))
    with pytest.raises(KeyError, match="monarch"):
        tpeft.build_adapter_bank(tpeft.PEFTConfig(method="monarch"), rt.params,
                                 {})
    bank = tpeft.build_adapter_bank(
        tpeft.PEFTConfig(method="boft", block_size=8), rt.params, {})
    assert bank.num_slots == 1 and bank.bank_methods == ()


def test_bank_config_consistency_errors(world):
    _, _, rt, tadp = world
    gs_cfg = TMIXED["alice"]
    other = dataclasses.replace(gs_cfg, target_patterns=(r".*/wq$",))
    with pytest.raises(ValueError, match="target_patterns"):
        tpeft.build_adapter_bank({"a": gs_cfg, "b": other}, rt.params,
                                 {"a": tadp["alice"], "b": tadp["alice"]})
    with pytest.raises(ValueError, match="one config per adapter"):
        tpeft.build_adapter_bank({"a": gs_cfg}, rt.params, {"a": {}, "b": {}})
    gs16 = dataclasses.replace(gs_cfg, block_size=16)
    with pytest.raises(ValueError, match="one stack"):
        tpeft.build_adapter_bank({"a": gs_cfg, "b": gs16}, rt.params,
                                 {"a": tadp["alice"], "b": tadp["alice"]})
    with pytest.raises(ValueError, match="use_pallas"):
        tpeft.build_adapter_bank(
            {"a": gs_cfg, "b": dataclasses.replace(TMIXED["dave"],
                                                   use_pallas=True)},
            rt.params, {"a": tadp["alice"], "b": tadp["dave"]})
    # a store-paged bank needs one device slot per method (five here)
    with pytest.raises(ValueError, match="one adapter per method"):
        rt.attach(tadp, TMIXED, hbm_budget=2)


# ---------------------------------------------------------------------------
# one train step per method against JAX's build_train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_params(world):
    return _np_tree(world[0].params)


@pytest.mark.parametrize("method", NEW_METHODS)
def test_train_step_matches_jax(base_params, method):
    """One step with SGD, whose update is linear in the gradient, so the
    adapters compare at the gradients' f32 tolerance (AdamW's first step,
    g / (|g| + eps), magnifies the rounding of gradients near eps; AdamW
    against JAX is held by tests/test_torch_train.py)."""
    kw = dict(method=method, block_size=8)
    jp_cfg, tp_cfg = jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)
    okw = dict(kind="sgd", learning_rate=1e-1)
    jt = jsteps.TrainStepConfig(peft=jp_cfg, opt=joptim.OptimizerConfig(**okw))
    tt = tsteps.TrainStepConfig(peft=tp_cfg, opt=optim.OptimizerConfig(**okw))
    ad = jpeft.init_peft(jp_cfg, jax.tree.map(jnp.asarray, base_params),
                         jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    adapters = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        ad)
    batch = JLMDataSource(JDataConfig(seq_len=12, global_batch=4, seed=2,
                                      vocab_size=CFG.vocab_size)).batch_at(0)
    jtr = jax.tree.map(jnp.asarray, adapters)
    jfz = jax.tree.map(jnp.asarray, base_params)
    jopt = joptim.init(jt.opt, jtr)
    jtr, jopt, jm = jax.jit(jsteps.build_train_step(JCFG, jt))(
        jfz, jtr, jopt, jax.tree.map(jnp.asarray, batch))
    ttr = convert.adapters_from_numpy(adapters, device=CPU)
    topt = convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, joptim.init(jt.opt, jax.tree.map(
            jnp.asarray, adapters))), device=CPU)
    ttr, topt, tm = tsteps.build_train_step(CFG, tt)(
        convert.params_from_numpy(base_params, device=CPU), ttr, topt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "accuracy"):
        _close(float(tm[key]), float(jm[key]), F32_REL, key)
    want = tpeft.flatten_paths(_np_tree(jtr))
    got = tpeft.flatten_paths(convert.to_numpy(ttr))
    assert sorted(got) == sorted(want)
    for path in want:
        _close(got[path], want[path], F32_REL, f"{method} {path}")


@pytest.mark.parametrize("peft", NEW_METHODS)
def test_launcher_trains_every_method_on_the_cpu(capsys, peft):
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--peft", peft, "--block-size", "8"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and out.count("step ") >= 2


def test_peft_config_fields_equal_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(jpeft.PEFTConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tpeft.PEFTConfig)}
    assert tfields == jfields
    jspec = {f.name: f.default for f in dataclasses.fields(jad.AdapterSpec)}
    tspec = {f.name: f.default for f in dataclasses.fields(tad.AdapterSpec)}
    assert tspec == jspec
