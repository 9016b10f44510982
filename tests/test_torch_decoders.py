"""The dense decoders beyond qwen2-72b and the MoE configs, against the
JAX package on the CPU at their smoke configs in f32: gemma-7b (GeGLU,
tied and scaled embeddings), granite-34b (GELU MLP, one kv head),
mistral-large-123b, qwen3-moe-30b-a3b and phi-3.5-MoE
(``models/moe.py``). JAX ``init_lm``
params and perturbed ``init_peft`` adapters are carried across by
``repro_torch.convert``. Held per config: forward logits and the loss with
``moe_aux``, GSOFT train steps and the adapters' gradients, greedy tokens
through ``ServeEngine``, ``PagedServeEngine`` and ``StaticServeEngine``
(merged), ``attn_impl="prefix_loop"``; for the MoE configs the bank's
refusal of the expert stacks, an attention-only bank against the merged
model, and int8 serving against JAX's banked int8 on identical codes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro import quant as jquant  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import LMDataSource as JLMDataSource  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, optim, quant  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
DENSE = ("gemma-7b", "granite-34b", "mistral-large-123b")
MOE = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
ARCHS = DENSE + MOE
# the attention projections only: a bank over them serves an MoE config
ATTN = (r".*/attn/(wq|wk|wv|wo)$",)
PROMPTS = {"alice": [3, 4, 5, 6], "bob": [9, 10, 11], None: [7, 8, 9, 10, 11]}
# f32: logits and losses within 1e-5 of the largest magnitude (sums in
# another order); adapter gradients within 1e-4 of each leaf's largest
F32_REL = 1e-5
GRAD_REL = 1e-4
LOGIT_REL = 1e-4             # logits after int8 matmuls (same codes)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pcfgs(arch, bank=False):
    """(JAX, port) GSOFT configs; a bank on an MoE config adapts the
    attention projections only."""
    kw = dict(method="gsoft", block_size=8)
    if bank and arch in MOE:
        kw["target_patterns"] = ATTN
    return jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)


def _tuned(pcfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(pcfg, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


_WORLDS = {}


def world(arch):
    """JAX's runtime and the port's on the same params, and two tuned
    bank adapters (attention-only on an MoE config) in both."""
    if arch not in _WORLDS:
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        assert convert.config_from_jax(jcfg) == cfg
        jrt = JaxRuntime(jcfg, key=jax.random.PRNGKey(0))
        params = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
        jpc, _ = _pcfgs(arch, bank=True)
        jad = {"alice": _tuned(jpc, jrt.params, 7),
               "bob": _tuned(jpc, jrt.params, 11)}
        _WORLDS[arch] = dict(
            jcfg=jcfg, cfg=cfg, jrt=jrt, params=params,
            rt=ModelRuntime(cfg, params, device=CPU), jad=jad,
            tad=convert.adapters_from_numpy(_np_tree(jad), device=CPU))
    return _WORLDS[arch]


def _serve(engine, adapters=(None,), max_new=4):
    # a static engine serves one merged model: its requests name no adapter
    kw = lambda a: {} if isinstance(
        engine, (jengine.StaticServeEngine, tengine.StaticServeEngine)) \
        else {"adapter": a}
    rids = {a: engine.add_request(PROMPTS[a], max_new_tokens=max_new,
                                  **kw(a)) for a in adapters}
    out = engine.run()
    return {a: out[rid] for a, rid in rids.items()}


def _batch(cfg, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, s + 1))
    mask = np.ones((2, s), np.float32)
    mask[1, -3:] = 0.0
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "mask": mask}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    w = world(arch)
    batch = _batch(w["cfg"])
    jlog, jaux = jtransformer.forward(w["jcfg"], w["jrt"].params, _jb(batch))
    jloss, jm = jtransformer.lm_loss(w["jcfg"], w["jrt"].params, _jb(batch))
    tlog, taux = transformer.forward(w["cfg"], w["params"], _tb(batch))
    tloss, tm = transformer.lm_loss(w["cfg"], w["params"], _tb(batch))
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "logits")
    _close(float(taux), float(jaux), F32_REL, "moe_aux")
    _close(float(tloss), float(jloss), F32_REL, "loss")
    _close(float(tm["moe_aux"]), float(jm["moe_aux"]), F32_REL, "metric aux")
    assert (float(taux) > 0.5) == (arch in MOE)   # E * sum f P is ~1


@pytest.mark.parametrize("arch", ARCHS)
def test_gsoft_training_matches_jax(arch):
    """Two GSOFT train steps (default targets: on an MoE config also the
    expert stacks, batch dims (L, E)): losses, grad norms and updated
    adapters against JAX's jitted step; then every adapter leaf's gradient
    of the loss against jax.grad."""
    w = world(arch)
    jcfg, cfg = w["jcfg"], w["cfg"]
    jpc, tpc = _pcfgs(arch)
    okw = dict(learning_rate=1e-2)
    jt = jsteps.TrainStepConfig(peft=jpc, opt=joptim.OptimizerConfig(**okw))
    tt = tsteps.TrainStepConfig(peft=tpc, opt=optim.OptimizerConfig(**okw))
    jad = jax.tree.map(np.asarray, _tuned(jpc, w["jrt"].params, 3, 0.05))
    if arch in MOE:
        assert any("/moe/" in p for p in jad)
    data = JLMDataSource(JDataConfig(seq_len=12, global_batch=4, seed=2,
                                     vocab_size=cfg.vocab_size))
    jstep = jax.jit(jsteps.build_train_step(jcfg, jt))
    tstep = tsteps.build_train_step(cfg, tt)
    jtr = jax.tree.map(jnp.asarray, jad)
    jopt = joptim.init(jt.opt, jtr)
    ttr = convert.adapters_from_numpy(jad, device=CPU)
    topt = convert.opt_state_from_numpy(_np_tree(jopt), device=CPU)
    for step in range(2):
        batch = data.batch_at(step)
        jtr, jopt, jm = jstep(w["jrt"].params, jtr, jopt, _jb(batch))
        ttr, topt, tm = tstep(w["params"], ttr, topt, _tb(batch))
        for key in ("loss", "grad_norm", "moe_aux"):
            _close(float(tm[key]), float(jm[key]), F32_REL, f"{step} {key}")
    # AdamW moves an entry by about lr * g / (|g| + eps): where |g| is near
    # eps, gradients equal to 1e-4 of the leaf's largest give updates that
    # differ by a few 1e-5; within 1e-2 of the learning rate
    want = tpeft.flatten_paths(_np_tree(jtr))
    got = tpeft.flatten_paths(convert.to_numpy(ttr))
    assert sorted(got) == sorted(want)
    for path in want:
        _close(got[path], want[path], 1e-2 * okw["learning_rate"],
               f"adapters {path}")

    batch = _batch(cfg, s=12, seed=4)

    def jloss(ad):
        p = jpeft.materialize_tree(jpc, w["jrt"].params, ad)
        return jtransformer.lm_loss(jcfg, p, _jb(batch))[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jad))
    tad = {p: {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in leaf.items()} for p, leaf in jad.items()}
    tl, _ = transformer.lm_loss(
        cfg, tpeft.materialize_tree(tpc, w["params"], tad), _tb(batch))
    leaves = [(p, k) for p in sorted(tad) for k in sorted(tad[p])]
    tg = torch.autograd.grad(tl, [tad[p][k] for p, k in leaves])
    _close(float(tl.detach()), float(jl), F32_REL, "grad loss")
    for (p, k), g in zip(leaves, tg):
        _close(g.numpy(), np.asarray(jg[p][k]), GRAD_REL, f"d {p}/{k}")


ENGINES = ("continuous", "paged", "static")


def _engines(kind, jrt, rt):
    kw = dict(max_batch=3, max_len=48, eos_id=-1)
    if kind == "continuous":
        return jengine.ServeEngine(jrt, **kw), tengine.ServeEngine(rt, **kw)
    if kind == "paged":
        kw.update(page_size=8, prefill_chunk=8)
        return (jengine.PagedServeEngine(jrt, **kw),
                tengine.PagedServeEngine(rt, **kw))
    return (jengine.StaticServeEngine(jrt, **kw),
            tengine.StaticServeEngine(rt, **kw))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(arch, engine):
    """Two tenants and the base through a bank (continuous, paged; on an
    MoE config over the attention projections), or one adapter merged
    with the default targets (static: an MoE config's expert stacks go
    through the stacked rotation), token for token against JAX."""
    w = world(arch)
    jpc, tpc = _pcfgs(arch, bank=True)
    if engine == "static":
        jpc, tpc = _pcfgs(arch)
        jad = _tuned(jpc, w["jrt"].params, 5)
        tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
        jrt = JaxRuntime(w["jcfg"], w["jrt"].params, adapters=jad,
                         peft_cfg=jpc)
        rt = ModelRuntime(w["cfg"], w["params"], device=CPU, adapters=tad,
                          peft_cfg=tpc)
        who = (None,)
    else:
        jrt, rt = w["jrt"].attach(w["jad"], jpc), w["rt"].attach(w["tad"], tpc)
        who = ("alice", "bob", None)
    jeng, teng = _engines(engine, jrt, rt)
    want = _serve(jeng, who)
    got = _serve(teng, who)
    assert got == want
    if engine == "continuous":
        assert got["alice"] != got[None] or got["bob"] != got[None]


@pytest.mark.parametrize("arch", MOE)
def test_moe_bank_refuses_experts_and_serves_attention(arch):
    """Default targets reach the (L, E, d_in, d_out) expert stacks: both
    packages' banks refuse them (JAX's test_bank_build_rejects_moe_batch_
    dims). An attention-only bank serves, and its tokens equal the model
    with the same adapter merged, in f32."""
    w = world(arch)
    jdef, tdef = _pcfgs(arch)
    with pytest.raises(ValueError, match="batch dims|routing-aware"):
        w["jrt"].attach({}, jdef)
    with pytest.raises(ValueError, match="MoE experts / hybrid blocks"):
        w["rt"].attach({}, tdef)
    with pytest.raises(ValueError, match="batch dims|routing-aware"):
        tpeft.bank_specs(tdef, w["params"])
    _, tpc = _pcfgs(arch, bank=True)
    assert all("/attn/" in p for p in tpeft.bank_specs(tpc, w["params"]))
    banked = _serve(tengine.ServeEngine(w["rt"].attach(w["tad"], tpc),
                                        max_batch=2, max_len=48, eos_id=-1),
                    ("alice", None), max_new=6)
    merged = ModelRuntime(w["cfg"], w["params"], device=CPU,
                          adapters=w["tad"]["alice"], peft_cfg=tpc)
    eng = tengine.ServeEngine(merged, max_batch=1, max_len=48, eos_id=-1)
    rid = eng.add_request(PROMPTS["alice"], max_new_tokens=6)
    assert banked["alice"] == eng.run()[rid]


def _jq_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: ({"q": np.asarray(l.q), "scale": np.asarray(l.scale),
                    "dtype": l.meta.dtype} if jquant.is_quant_tensor(l)
                   else np.asarray(l)),
        tree, is_leaf=jquant.is_quant_tensor)


@pytest.mark.parametrize("arch", MOE)
def test_int8_moe_matches_jax_banked_int8(arch):
    """int8 of an MoE config quantizes the attention projections and the
    LM head only (the experts and the router stay float), as JAX's; on
    JAX's codes the port's banked int8 decode logits and tokens equal
    JAX's."""
    w = world(arch)
    jpc, tpc = _pcfgs(arch, bank=True)
    jqrt = w["jrt"].attach(w["jad"], jpc).quantized("int8")
    jq = {p for p, l in jpeft.flatten_paths(_jq_numpy(jqrt.params)).items()
          if p.endswith("/q")}
    own = quant.quantize_params(
        convert.params_from_numpy(_np_tree(w["jrt"].params), device=CPU),
        quant.QuantConfig())
    tq = {p + "/q" for p, l in tpeft.flatten_paths(own).items()
          if isinstance(l, quant.QuantTensor)}
    assert tq == jq and jq
    assert all("/attn/" in p or p.startswith("lm_head/") for p in tq)
    trt = ModelRuntime(w["cfg"], convert.quant_params_from_numpy(
        _jq_numpy(jqrt.params), device=CPU), device=CPU).attach(w["tad"], tpc)
    toks = np.asarray([[5], [9], [7]])
    slots = [1, 2, 0]
    _, jlog, _ = jsteps.build_decode_step(w["jcfg"])(
        jqrt.params, jqrt.bank.context(slots), jnp.asarray(toks),
        jqrt.init_decode_state(3, 16), jnp.zeros((3,), jnp.int32))
    _, tlog, _ = tsteps.build_decode_step(w["cfg"])(
        trt.params, trt.bank.context(slots), torch.as_tensor(toks),
        trt.decode_state(3, 16), torch.zeros(3, dtype=torch.int64))
    _close(tlog.numpy(), np.asarray(jlog), LOGIT_REL, "int8 decode logits")
    kw = dict(max_batch=3, max_len=48, eos_id=-1)
    who = ("alice", "bob", None)
    assert _serve(tengine.ServeEngine(trt, **kw), who) == \
        _serve(jengine.ServeEngine(jqrt, **kw), who)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_loop_matches_jax(arch):
    """``attn_impl="prefix_loop"``: causal attention one query chunk at a
    time against JAX's, and against the dense schedule; S = 16 splits into
    chunks of 8, S = 13 falls back to ``online_attention``."""
    w = world(arch)
    over = dict(attn_impl="prefix_loop", attn_chunk=8)
    jcfg = dataclasses.replace(w["jcfg"], **over)
    cfg = w["cfg"].with_overrides(**over)
    for s in (16, 13):
        batch = _batch(cfg, s=s, seed=s)
        jlog, _ = jtransformer.forward(jcfg, w["jrt"].params, _jb(batch))
        tlog, _ = transformer.forward(cfg, w["params"], _tb(batch))
        dense, _ = transformer.forward(w["cfg"], w["params"], _tb(batch))
        _close(tlog.numpy(), np.asarray(jlog), F32_REL, f"S={s} vs JAX")
        _close(tlog.numpy(), dense.numpy(), F32_REL, f"S={s} vs dense")
