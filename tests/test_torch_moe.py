"""The MoE layer and the stacked rotations against the JAX package on the
CPU, in f32: ``models/moe.py`` ``moe_layer`` (output, load-balance loss,
and the kept / dropped choices with their expert slots, read from JAX's
own dispatch) with and without dropped tokens, with forced router ties,
over several segments and for each MLP type; the gradients of GSOFT
adapters on the expert stacks against ``jax.grad``; and
``adapters.materialize`` over a (layers x experts) stack against the
per-slice loop, method by method, with the number of kernel calls one
stack takes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import adapters as jad  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import adapters as tad  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
# f32: the expert products and the combine sum the same terms in another
# order: max |diff| within 1e-5 of the largest magnitude
F32_REL = 1e-5
# gradients through the Cayley solve, the rotations and the layer: 1e-4
# of each leaf's largest magnitude
GRAD_REL = 1e-4

# (name, overrides, S, segment, tie the router's columns)
CASES = [
    ("plain", {}, 32, 2048, False),
    ("drops", {"capacity_factor": 0.5}, 32, 2048, False),
    ("ties", {}, 32, 2048, True),
    ("segments", {"capacity_factor": 0.75}, 48, 16, False),
    ("geglu", {"mlp_type": "geglu"}, 24, 2048, False),
    ("gelu", {"mlp_type": "gelu", "moe_top_k": 3}, 24, 8, False),
]


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


def _layer(cfg, rng, tie):
    d, E, fe = cfg.d_model, cfg.moe_experts, cfg.expert_d_ff
    p = {"router": rng.normal(size=(d, E)) / 4,
         "wi": rng.normal(size=(E, d, fe)) / np.sqrt(d),
         "wo": rng.normal(size=(E, fe, d)) / np.sqrt(fe)}
    if cfg.mlp_type != "gelu":
        p["wg"] = rng.normal(size=(E, d, fe)) / np.sqrt(d)
    if tie:     # experts 0, 3 and 5 get equal logits for every token
        p["router"][:, 3] = p["router"][:, 0]
        p["router"][:, 5] = p["router"][:, 0]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _jax_choices(p, x, cfg, segment):
    """JAX's moe_layer, eagerly, with the (E, B, cap, d) expert input of
    each segment caught at its ``shard`` hook: every filled slot holds a
    copy of one token, which names it. Returns (y, aux, {(b, s, e, c)})."""
    seen = []

    def shard(a, name):
        if name == "moe_expert_in":
            seen.append(np.asarray(a))
        return a

    with jax.disable_jit():
        y, aux = jmoe.moe_layer({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), cfg, shard, segment=segment)
    seg = x.shape[1] // len(seen)
    choices = set()
    for i, xin in enumerate(seen):
        for e, b, c in zip(*np.nonzero(np.abs(xin).sum(-1))):
            rows = np.nonzero((x[b, i * seg:(i + 1) * seg]
                               == xin[e, b, c]).all(-1))[0]
            assert len(rows) == 1
            choices.add((int(b), i * seg + int(rows[0]), int(e), int(c)))
    return np.asarray(y), float(aux), choices


@pytest.mark.parametrize("name,over,s,segment,tie", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_layer_matches_jax(name, over, s, segment, tie):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **over)
    cfg = convert.config_from_jax(jcfg)
    rng = np.random.default_rng(len(name) * 7 + s)
    p = _layer(cfg, rng, tie)
    x = rng.normal(size=(3, s, cfg.d_model)).astype(np.float32)
    jy, jaux, jchoices = _jax_choices(p, x, jcfg, segment)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = tmoe.moe_layer(tp, torch.from_numpy(x), cfg, segment=segment)
    _close(ty.numpy(), jy, F32_REL, f"{name} y")
    _close(float(taux), jaux, F32_REL, f"{name} aux")
    r = tmoe.routing(tp, torch.from_numpy(x), cfg, segment=segment)
    b, si, k = np.nonzero(r.keep.numpy())
    port = {(int(bb), int(ss), int(r.idx[bb, ss, kk]), int(r.slot[bb, ss, kk]))
            for bb, ss, kk in zip(b, si, k)}
    assert port == jchoices
    dropped = int((~r.keep).sum())
    if name in ("drops", "segments"):
        assert dropped > 0
        # a token with every choice dropped passes through: its output is 0
        lost = (~r.keep).all(-1).numpy()
        if lost.any():
            assert np.all(ty.numpy()[lost] == 0)
    if tie:
        probs = r.probs.numpy()
        assert np.all(probs[..., 0] == probs[..., 3])
        # a tie goes to the lower expert index, as lax.top_k
        chosen = r.idx.numpy()
        both = (chosen == 0).any(-1) & (chosen == 3).any(-1)
        assert ((chosen == 3).any(-1) <= (chosen == 0).any(-1)).all()
        assert both.any()


def test_top_k_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25] * 4 + [0.0]])
    vals, idx = tmoe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


def test_segment_and_capacity_follow_jax():
    cfg = convert.config_from_jax(jax_smoke_config(ARCH))
    for s, segment, want in ((32, 2048, 32), (48, 16, 16), (30, 16, 15),
                             (7, 4, 1), (1, 2048, 1)):
        assert tmoe.segment_len(s, segment) == want
    for seg in (1, 15, 16, 32, 2048):
        assert tmoe._capacity(cfg, seg) == jmoe._capacity(
            jax_smoke_config(ARCH), seg)


def test_init_moe_tree_matches_jax():
    jcfg = jax_smoke_config(ARCH)
    cfg = convert.config_from_jax(jcfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, 2, jnp.float32)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, 2,
                       torch.float32, "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == (torch.float32 if k == "router"
                               else cfg.weight_dtype)
        # N(0, 1 / d_in): the draws differ, their scale does not
        want = float(np.asarray(jp[k]).std())
        assert abs(float(tp[k].std()) - want) < 0.15 * want


def test_expert_adapter_gradients_match_jax():
    """GSOFT on the expert stacks (L, E, d_in, d_out), materialized and run
    through the MoE layer: the loss and every adapter leaf's gradient
    against jax.grad."""
    jcfg = jax_smoke_config(ARCH)
    cfg = convert.config_from_jax(jcfg)
    rng = np.random.default_rng(5)
    L = 2
    layers = [_layer(cfg, rng, False) for _ in range(L)]
    moe = {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
    params = {"layers": {"moe": moe}}
    kw = dict(method="gsoft", block_size=8)
    jpc, tpc = jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)
    ad = jpeft.init_peft(jpc, jax.tree.map(jnp.asarray, params),
                         jax.random.PRNGKey(1))
    ad = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), ad)
    assert sorted(ad) == ["layers/moe/wg", "layers/moe/wi", "layers/moe/wo"]
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(a):
        p = jpeft.materialize_tree(jpc, jax.tree.map(jnp.asarray, params), a)
        h, tot = jnp.asarray(x), 0.0
        for i in range(L):
            y, aux = jmoe.moe_layer(jax.tree.map(lambda v: v[i],
                                                 p["layers"]["moe"]),
                                    h, jcfg)
            h = h + y
            tot = tot + aux
        return jnp.sum(h * w) + tot

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, ad))
    tad_ = {path: {k: torch.from_numpy(v).requires_grad_()
                   for k, v in leaf.items()} for path, leaf in ad.items()}
    tparams = convert.params_from_numpy(params, device="cpu")
    p = tpeft.materialize_tree(tpc, tparams, tad_)
    h, tot = torch.from_numpy(x), 0.0
    for i in range(L):
        y, aux = tmoe.moe_layer({k: v[i] for k, v in p["layers"]["moe"].items()},
                                h, cfg)
        h = h + y
        tot = tot + aux
    tl = torch.sum(h * torch.from_numpy(w)) + tot
    leaves = [(path, k) for path in sorted(ad) for k in sorted(ad[path])]
    tg = torch.autograd.grad(tl, [tad_[pa][k] for pa, k in leaves])
    _close(float(tl.detach()), float(jl), F32_REL, "loss")
    for (pa, k), g in zip(leaves, tg):
        _close(g.numpy(), np.asarray(jg[pa][k]), GRAD_REL, f"d {pa}/{k}")


# ---------------------------------------------------------------------------
# adapters.materialize over a stack: one launch per rotation, not per slice
# ---------------------------------------------------------------------------

# kernel wrappers each method's materialize reaches, and how many calls a
# stack takes (BOFT: one per butterfly level); Householder and Givens have
# no kernel and keep the per-slice loop
KERNEL_CALLS = {"gsoft": {"gs_fused": 1},
                "double_gsoft": {"gs_fused": 1, "gs_fused_T": 1},
                "oft": {"bdmm": 1}, "boft": {"bdmm": 2}, "lora": {},
                "householder": {}, "givens": {}}


def _count_calls(monkeypatch):
    calls = {}
    for name in ("gs_fused", "gs_fused_T", "bdmm"):
        fn = getattr(dispatch, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(dispatch, name, counted)
    return calls


def _stack_spec(method, shape):
    return tpeft.spec_for(tpeft.PEFTConfig(method=method, block_size=8,
                                           boft_factors=2), shape)


@pytest.mark.parametrize("method", sorted(KERNEL_CALLS))
def test_stacked_materialize_equals_the_slice_loop(method, monkeypatch):
    """A (layers x experts) stack: bit for bit the per-slice loop's weights,
    its gradients within 1e-6, and for a method with row kernels one call
    of each kernel for the whole stack (the loop: one a slice)."""
    W = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, 64, 48)).astype(np.float32))
    spec = _stack_spec(method, tuple(W.shape))
    assert methods.get(method).stacked == (method not in ("householder",
                                                           "givens"))
    p0 = tad.init_adapter(spec, torch.Generator().manual_seed(1), device="cpu")
    gen = torch.Generator().manual_seed(3)
    p = {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).requires_grad_()
         for k, v in p0.items()}
    calls = _count_calls(monkeypatch)
    got = tad.materialize(spec, p, W)
    assert calls == KERNEL_CALLS[method]
    ggot = torch.autograd.grad((got * got.sin()).sum(), list(p.values()))
    inner = dataclasses.replace(spec, batch=())
    want = torch.stack([torch.stack([
        tad.materialize(inner, {k: v[i, j] for k, v in p.items()}, W[i, j])
        for j in range(3)]) for i in range(2)])
    gwant = torch.autograd.grad((want * want.sin()).sum(), list(p.values()))
    assert torch.equal(got, want)
    for k, a, b in zip(p, ggot, gwant):
        _close(a.numpy(), b.numpy(), 1e-6, f"{method} d{k}")


def test_stacked_gsoft_equals_jax_vmap_and_chunks_by_layer(monkeypatch):
    """The stacked GSOFT rotation against JAX's vmapped ``materialize``,
    and a stack past ``STACK_CHUNK_BYTES`` cut into whole layers: one
    launch a chunk, the same weights bit for bit."""
    rng = np.random.default_rng(4)
    W = rng.normal(size=(3, 2, 32, 40)).astype(np.float32)
    spec = _stack_spec("gsoft", W.shape)
    jspec = jad.AdapterSpec(method="gsoft", d_in=32, d_out=40, block_size=8,
                            batch=(3, 2))
    p = {k: (np.asarray(v) + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
         for k, v in jad.init_adapter(jspec, jax.random.PRNGKey(0)).items()}
    want = np.asarray(jad.materialize(
        jspec, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(W)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    whole = tad.materialize(spec, tp, torch.from_numpy(W))
    _close(whole.numpy(), want, F32_REL, "stack vs vmap")
    calls = _count_calls(monkeypatch)
    monkeypatch.setattr(tad, "STACK_CHUNK_BYTES", 2 * 32 * 40 * 4 * 2)
    chunked = tad.materialize(spec, tp, torch.from_numpy(W))
    assert calls == {"gs_fused": 2}          # layers (0, 1) and (2,)
    assert torch.equal(chunked, whole)
    monkeypatch.setattr(tad, "STACK_CHUNK_BYTES", 1)
    calls.clear()
    assert torch.equal(tad.materialize(spec, tp, torch.from_numpy(W)), whole)
    assert calls == {"gs_fused": 3}          # never below one layer


class _Rank:
    """What ``moe_layer(..., tp=)`` reads of a ``distrib.tp.TPShard``, for
    one simulated rank of ``size`` with no process group: the collectives
    are the identity, so the layer returns this rank's partial combine."""

    def __init__(self, rank, size, E, by_experts):
        self.moe_split = True
        n = E // size if by_experts else E
        self.experts = (rank * n if by_experts else 0, n)

    def enter(self, x, split=True):
        return x

    def leave(self, y, split=True):
        return y

    def grad_share(self, y):
        return y


def _rank_layer(p, rank, size, by_experts):
    """Rank ``rank``'s shards of one layer: its experts, or every
    expert's ``rank``-th window of d_ff (wi / wg columns, wo rows)."""
    if by_experts:
        n = p["wi"].shape[0] // size
        return {k: (v if k == "router" else v[rank * n:(rank + 1) * n])
                for k, v in p.items()}
    f = p["wi"].shape[-1] // size
    cols = slice(rank * f, (rank + 1) * f)
    return {k: (v if k == "router" else v[:, cols] if k == "wo"
                else v[..., cols]) for k, v in p.items()}


@pytest.mark.parametrize("by_experts, E, size", [(True, 8, 2), (True, 8, 4),
                                                 (False, 6, 4)],
                         ids=["experts_tp2", "experts_tp4", "d_ff_tp4"])
def test_partial_combines_sum_to_the_layer(by_experts, E, size):
    """Split by experts or by each expert's d_ff: every simulated rank
    routes the whole input and returns its partial combine (fp32); their
    sum equals ``moe_layer``'s output within 1e-6 (the summation order
    alone), with drops and two segments, and every rank's load-balance
    loss is the layer's exactly."""
    cfg = convert.config_from_jax(dataclasses.replace(
        jax_smoke_config(ARCH), moe_experts=E, capacity_factor=0.75))
    rng = np.random.default_rng(11 + E + size)
    p = {k: torch.from_numpy(v) for k, v in _layer(cfg, rng, False).items()}
    x = torch.from_numpy(rng.normal(size=(3, 32, cfg.d_model))
                         .astype(np.float32))
    want, aux = tmoe.moe_layer(p, x, cfg, segment=16)
    parts = [tmoe.moe_layer(_rank_layer(p, r, size, by_experts), x, cfg,
                            segment=16, tp=_Rank(r, size, E, by_experts))
             for r in range(size)]
    got = sum(y.to(torch.float64) for y, _ in parts)
    _close(got.numpy(), want.numpy(), 1e-6, "sum of the partial combines")
    assert all(torch.equal(a, aux) for _, a in parts)
    assert int((~tmoe.routing(p, x, cfg, segment=16).keep).sum()) > 0
    if by_experts:      # a rank's combine holds only its experts' tokens
        assert all(float(y.abs().sum()) > 0 for y, _ in parts)


def test_split_expert_stack_rotates_in_place(monkeypatch):
    """``materialize_split`` on a rank's expert stack split by experts
    (spec (None, 'model', None, None)) and its own rows of the adapters:
    one ``gs_diff_rows`` call for the local stack, no slice gathered (0
    bytes), and bit for bit the rank's experts of the whole stack's
    rotation."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    W = torch.from_numpy(rng.normal(size=(2, 8, 32, 24)).astype(np.float32))
    pcfg = tpeft.PEFTConfig(method="gsoft", block_size=8)
    spec = tpeft.spec_for(pcfg, tuple(W.shape))
    ad = {k: v + 0.1 * torch.from_numpy(rng.normal(size=v.shape)
                                        .astype(np.float32))
          for k, v in tad.init_adapter(spec, torch.Generator(),
                                       device="cpu").items()}
    whole = tad.materialize(spec, ad, W)
    calls, gathered = [], []
    rows = ops.gs_diff_rows
    monkeypatch.setattr(ops, "gs_diff_rows", lambda L, R, x: (
        calls.append(tuple(x.shape)), rows(L, R, x))[1])
    for rank in range(2):
        mine = slice(4 * rank, 4 * rank + 4)
        calls.clear()
        got = tpeft.materialize_split(
            pcfg, {"moe": {"wi": W[:, mine]}},
            {"moe/wi": {k: v[:, mine] for k, v in ad.items()}},
            {"moe/wi": (None, "model", None, None)},
            lambda key, w, s: gathered.append(w.numel()) or w,
            lambda w, s: w)
        assert len(calls) == 1 and calls[0][0] == 2 * 4
        assert torch.equal(got["moe"]["wi"], whole[:, mine])
    assert sum(gathered) == 0
