"""The vlm family (pixtral-12b: the decoder with a patch frontend stub and
``patch_proj``) against the JAX package on the CPU at its smoke config in
f32. JAX ``init_lm`` params, perturbed ``init_peft`` adapters and numpy
batches are carried across by ``repro_torch.convert``. Held: the config,
the param tree and counts, ``forward`` with random patches (the text
positions' logits only) and the loss, ``prefill`` with random patches and
the patch offset in ``last_idx``, then decode; GSOFT gradients with the
``patch_proj/wi`` adapter; banked greedy tokens (the bank rotates
``patch_proj`` per request) against JAX's banked tokens and against the
merged model; int8 banked serving against JAX's banked int8 on identical
codes (``patch_proj/wi`` among them); the paged engine refused; the
launchers; ``lm_batch``'s patches and frames against JAX's shapes, and
``LMDataSource``'s (the training loop's) tokens against JAX's pipeline.

Tolerances: logits and losses within 1e-5 of the largest magnitude (sums
in another order); adapter gradients within 1e-4 of each leaf's largest;
logits after int8 matmuls on the same codes within 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.peft import PrefillRequest as JPrefill  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import LMDataSource as JLMDataSource  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, quant  # noqa: E402
from repro_torch.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.peft import PrefillRequest  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import DataConfig, LMDataSource, lm_batch  # noqa: E402
from repro_torch.data.synthetic import frontend_shape, text_len  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
ARCH = "pixtral-12b"
F32_REL = 1e-5
GRAD_REL = 1e-4
LOGIT_REL = 1e-4
PROMPTS = {"alice": [3, 4, 5, 6], "bob": [9, 10, 11], None: [7, 8, 9, 10, 11]}
WHO = ("alice", "bob", None)
GSOFT = dict(method="gsoft", block_size=8)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tuned(pcfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(pcfg, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


_W = {}


def world():
    """JAX's runtime and the port's on the same params, and two tuned
    GSOFT bank adapters (``patch_proj/wi`` among their paths) in both."""
    if not _W:
        jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
        jrt = JaxRuntime(jcfg, key=jax.random.PRNGKey(0))
        params = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
        jpc = jpeft.PEFTConfig(**GSOFT)
        jad = {"alice": _tuned(jpc, jrt.params, 7),
               "bob": _tuned(jpc, jrt.params, 11)}
        _W.update(jcfg=jcfg, cfg=cfg, jrt=jrt, params=params, jad=jad,
                  rt=ModelRuntime(cfg, params, device=CPU),
                  tad=convert.adapters_from_numpy(_np_tree(jad), device=CPU))
    return _W


def _batch(cfg, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, s + 1))
    mask = np.ones((2, s), np.float32)
    mask[1, -3:] = 0.0
    patches = rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "mask": mask,
            "patches": patches.astype(np.float32)}


def test_config_tree_and_counts_match_jax():
    w = world()
    cfg = w["cfg"]
    assert convert.config_from_jax(w["jcfg"]) == cfg
    assert convert.config_from_jax(jax_get_config(ARCH)) == get_config(ARCH)
    assert (cfg.frontend, cfg.frontend_dim, cfg.frontend_tokens) == \
        ("patch", 32, 8)
    own = transformer.init_lm(cfg, seed=3, device=CPU)
    want = {p: tuple(v.shape) for p, v in
            tpeft.flatten_paths(_np_tree(w["jrt"].params)).items()}
    assert {p: tuple(v.shape) for p, v in
            tpeft.flatten_paths(own).items()} == want
    assert want["patch_proj/wi"] == (cfg.frontend_dim, cfg.d_model)
    for c, jc in ((cfg, w["jcfg"]), (get_config(ARCH), jax_get_config(ARCH))):
        assert api.param_count(c) == japi.param_count(jc)
        assert api.active_param_count(c) == japi.active_param_count(jc)
    ops = api.family_ops(cfg)
    assert ops.has_patches and ops.init_paged_state is None


def test_forward_keeps_text_logits_and_loss_matches_jax():
    w = world()
    batch = _batch(w["cfg"])
    jlog, _ = jtransformer.forward(w["jcfg"], w["jrt"].params, _jb(batch))
    jloss, _ = jtransformer.lm_loss(w["jcfg"], w["jrt"].params, _jb(batch))
    tlog, _ = transformer.forward(w["cfg"], w["params"], _tb(batch))
    tloss, _ = transformer.lm_loss(w["cfg"], w["params"], _tb(batch))
    assert tlog.shape[:2] == (2, 12)
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "logits")
    _close(float(tloss), float(jloss), F32_REL, "loss")
    # the patches reach the text logits; without them the text runs alone
    text = {k: v for k, v in batch.items() if k != "patches"}
    jtext, _ = jtransformer.forward(w["jcfg"], w["jrt"].params, _jb(text))
    ttext, _ = transformer.forward(w["cfg"], w["params"], _tb(text))
    _close(ttext.numpy(), np.asarray(jtext), F32_REL, "text only")
    assert not np.allclose(ttext.numpy(), tlog.numpy())


def test_prefill_with_patches_and_decode_match_jax():
    """Random patches, a ragged batch-2 prompt (last_idx = P + len - 1 per
    row), then three decode steps at P + len + t: logits and the KV cache
    against JAX's."""
    w = world()
    jcfg, cfg = w["jcfg"], w["cfg"]
    batch = _batch(cfg, s=6, seed=5)
    feed = {"tokens": batch["tokens"], "patches": batch["patches"]}
    P = cfg.frontend_tokens
    last = np.asarray([P + 5, P + 3], np.int32)
    max_len = P + 16
    jstate = japi.init_decode_state(jcfg, 2, max_len)
    tstate = api.init_decode_state(cfg, 2, max_len, device=CPU)
    jlog, jstate = jtransformer.prefill(jcfg, w["jrt"].params, JPrefill(
        batch=_jb(feed), last_idx=jnp.asarray(last)), jstate)
    tlog, tstate = transformer.prefill(cfg, w["params"], PrefillRequest(
        batch=_tb(feed), last_idx=torch.as_tensor(last)), tstate)
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "prefill logits")
    for k in ("k", "v"):
        _close(tstate["kv"][k].numpy(), np.asarray(jstate["kv"][k]), F32_REL,
               f"kv {k}")
    assert tstate["kv"]["k"][:, :, :P].abs().sum() > 0
    pos = last + 1
    tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
    for step in range(3):
        jlog, jstate = jtransformer.decode_step(
            jcfg, w["jrt"].params, jnp.asarray(tok), jstate, jnp.asarray(pos))
        tlog, tstate = transformer.decode_step(
            cfg, w["params"], torch.as_tensor(tok), tstate,
            torch.as_tensor(pos))
        _close(tlog.numpy(), np.asarray(jlog), F32_REL, f"decode {step}")
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_gsoft_gradients_include_patch_proj():
    """GSOFT over the default targets adapts patch_proj/wi (2-D, outside
    the layer stack) besides the 7 layer stacks: every adapter leaf's
    gradient of the loss with random patches against jax.grad."""
    w = world()
    jcfg, cfg = w["jcfg"], w["cfg"]
    jpc, tpc = jpeft.PEFTConfig(**GSOFT), tpeft.PEFTConfig(**GSOFT)
    jad = _np_tree(_tuned(jpc, w["jrt"].params, 3, 0.05))
    assert len(jad) == 8 and "patch_proj/wi" in jad
    batch = _batch(cfg, s=10, seed=4)

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
    _close(float(tl.detach()), float(jl), F32_REL, "loss")
    for (p, k), g in zip(leaves, tg):
        _close(g.numpy(), np.asarray(jg[p][k]), GRAD_REL, f"d {p}/{k}")
    assert float(tg[[p for p, _ in leaves].index("patch_proj/wi")].abs().max()
                 ) > 0


def _serve(eng, who=WHO, max_new=4, static=False):
    rids = {a: eng.add_request(PROMPTS[a], max_new_tokens=max_new,
                               **({} if static else {"adapter": a}))
            for a in who}
    out = eng.run()
    return {a: out[r] for a, r in rids.items()}


def test_banked_tokens_equal_jax_and_the_merged_model():
    """Two tenants and the base through a GSOFT bank whose tree holds
    patch_proj/wi (the engines' zero patches still pass through the rotated
    projection): tokens equal JAX's banked engine's; each tenant's tokens
    equal the model with its adapter merged (port and JAX), and the
    prefill logits with random patches equal the merged model's."""
    w = world()
    jpc, tpc = jpeft.PEFTConfig(**GSOFT), tpeft.PEFTConfig(**GSOFT)
    jrt, rt = w["jrt"].attach(w["jad"], jpc), w["rt"].attach(w["tad"], tpc)
    assert "patch_proj" in rt.bank.tree and "wi" in rt.bank.tree[
        "patch_proj"]
    kw = dict(max_batch=3, max_len=40, eos_id=-1)
    got = _serve(tengine.ServeEngine(rt, **kw))
    assert got == _serve(jengine.ServeEngine(jrt, **kw))
    assert got["alice"] != got[None] or got["bob"] != got[None]
    for name in ("alice", "bob"):
        merged = ModelRuntime(w["cfg"], w["params"], device=CPU,
                              adapters=w["tad"][name], peft_cfg=tpc)
        solo = _serve(tengine.StaticServeEngine(merged, **kw), (name,),
                      static=True)
        assert solo[name] == got[name]
    batch = _batch(w["cfg"], s=6, seed=9)
    feed = _tb({"tokens": batch["tokens"][:1],
                "patches": batch["patches"][:1]})
    last = torch.tensor([w["cfg"].frontend_tokens + 5])
    state = lambda r: r.decode_state(1, 32)
    banked, _ = tsteps.build_prefill_step(w["cfg"])(
        rt.params, PrefillRequest(feed, last, rt.context([1])), state(rt))
    merged = ModelRuntime(w["cfg"], w["params"], device=CPU,
                          adapters=w["tad"]["alice"], peft_cfg=tpc)
    want, _ = tsteps.build_prefill_step(w["cfg"])(
        merged.params, PrefillRequest(feed, last), state(merged))
    _close(banked.numpy(), want.numpy(), F32_REL, "banked vs merged")


def _jq_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: ({"q": np.asarray(l.q), "scale": np.asarray(l.scale),
                    "dtype": l.meta.dtype} if jquant.is_quant_tensor(l)
                   else np.asarray(l)),
        tree, is_leaf=jquant.is_quant_tensor)


def test_int8_banked_serving_matches_jax_banked_int8():
    """int8 quantizes patch_proj/wi too (as JAX's targets do). On JAX's
    codes the port's banked int8 prefill (random patches, the rotation
    fused into the int8 matmul) and decode logits equal JAX's, and the
    engines' tokens are the same."""
    w = world()
    jpc, tpc = jpeft.PEFTConfig(**GSOFT), tpeft.PEFTConfig(**GSOFT)
    jqrt = w["jrt"].attach(w["jad"], jpc).quantized("int8")
    jq = {p for p, _ in jpeft.flatten_paths(_jq_numpy(jqrt.params)).items()
          if p.endswith("/q")}
    own = quant.quantize_params(w["params"], quant.QuantConfig())
    tq = {p + "/q" for p, l in tpeft.flatten_paths(own).items()
          if isinstance(l, quant.QuantTensor)}
    assert tq == jq and "patch_proj/wi/q" in tq
    trt = ModelRuntime(w["cfg"], convert.quant_params_from_numpy(
        _jq_numpy(jqrt.params), device=CPU), device=CPU).attach(
            w["tad"], tpc)
    batch = _batch(w["cfg"], s=5, seed=2)
    P = w["cfg"].frontend_tokens
    feed = {"tokens": np.concatenate([batch["tokens"], batch["tokens"][:1]]),
            "patches": np.concatenate([batch["patches"],
                                       batch["patches"][:1]])}
    last = np.asarray([P + 4, P + 2, P + 3], np.int32)
    slots = [1, 2, 0]
    jlog, jst = jsteps.build_prefill_step(w["jcfg"])(
        jqrt.params, JPrefill(_jb(feed), jnp.asarray(last),
                              jqrt.bank.context(slots)),
        jqrt.init_decode_state(3, 24))
    tlog, tst = tsteps.build_prefill_step(w["cfg"])(
        trt.params, PrefillRequest(_tb(feed), torch.as_tensor(last),
                                   trt.bank.context(slots)),
        trt.decode_state(3, 24))
    _close(tlog.numpy(), np.asarray(jlog), LOGIT_REL, "int8 prefill logits")
    toks = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None]
    _, jlog, _ = jsteps.build_decode_step(w["jcfg"])(
        jqrt.params, jqrt.bank.context(slots), jnp.asarray(toks), jst,
        jnp.asarray(last + 1))
    _, tlog, _ = tsteps.build_decode_step(w["cfg"])(
        trt.params, trt.bank.context(slots), torch.as_tensor(toks), tst,
        torch.as_tensor(last + 1))
    _close(tlog.numpy(), np.asarray(jlog), LOGIT_REL, "int8 decode logits")
    kw = dict(max_batch=3, max_len=40, eos_id=-1)
    assert _serve(tengine.ServeEngine(trt, **kw)) == \
        _serve(jengine.ServeEngine(jqrt, **kw))


def test_paged_engine_refused_and_capacity_counts_patches():
    w = world()
    for cls in (jengine.PagedServeEngine, tengine.PagedServeEngine):
        rt = w["jrt"] if cls is jengine.PagedServeEngine else w["rt"]
        with pytest.raises(ValueError, match="no paged KV serve path"):
            cls(rt, max_batch=2, max_len=40)
    P = w["cfg"].frontend_tokens
    eng = tengine.ServeEngine(w["rt"], max_batch=1, max_len=P + 8)
    eng.add_request([1, 2, 3, 4], max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.add_request([1, 2, 3, 4, 5], max_new_tokens=4)


def test_launchers_train_serve_and_refuse_a_mesh(capsys):
    """``launch/train.py --arch pixtral-12b`` trains (patches in every
    batch: --seq 24 is 8 patches + 16 text tokens); ``launch/serve.py``
    serves a 3-tenant bank (its max_len counts the patches); ``--engine
    paged``, ``--tp 2`` and ``--mesh`` are refused."""
    assert tlaunch_train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                               "--batch", "2", "--seq", "24", "--block-size",
                               "8", "--warmup", "1", "--no-resume",
                               "--device", CPU]) == 0
    assert "final loss" in capsys.readouterr().out
    assert tlaunch.main(["--arch", ARCH, "--smoke", "--demo-adapters", "3",
                         "--requests", "4", "--prompt-len", "12",
                         "--device", CPU]) == 0
    assert "[continuous] served 4 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no paged KV serve path"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--engine", "paged",
                      "--device", CPU])
    for flags in (["--tp", "2"], ["--mesh", "1,2"]):
        with pytest.raises(NotImplementedError, match="encdec / vlm mesh"):
            tlaunch.main(["--arch", ARCH, "--smoke", "--device", CPU]
                         + flags)


@pytest.mark.parametrize("arch", (ARCH, "seamless-m4t-medium"))
def test_lm_batch_frontends_have_jax_shapes(arch):
    """``lm_batch``: the vlm's patches (B, P, frontend_dim) and
    max(seq - P, 8) text tokens; the encoder-decoder's frames (B,
    max(seq // 4, 8), d_model); keys, shapes and dtypes as JAX's (the
    draws are the port's own)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    for seq in (12, 40):
        b = lm_batch(cfg, 3, seq, seed=1, device=CPU)
        jb = jsynth.lm_batch(jcfg, 3, seq, seed=1)
        assert sorted(b) == sorted(jb)
        for k in jb:
            assert tuple(b[k].shape) == tuple(jb[k].shape), (k, seq)
        extra = "patches" if arch == ARCH else "frames"
        assert b[extra].dtype == torch.float32
        assert 0.5 < float(b[extra].std()) < 1.5
        assert torch.equal(b[extra], lm_batch(cfg, 3, seq, seed=1,
                                              device=CPU)[extra])


@pytest.mark.parametrize("arch", (ARCH, "seamless-m4t-medium"))
def test_data_source_frontends(arch):
    """The training loop's batches (``LMDataSource`` with ``frontend_shape``):
    the tokens are JAX's pipeline's for the same (seed, step); the patches
    or frames have ``lm_batch``'s shape, are standard normal, repeat for a
    (seed, step), change with the step, and a host slice draws the same
    rows as the whole batch."""
    cfg = get_smoke_config(arch)
    seq = text_len(cfg, 40)
    kw = dict(seq_len=seq, global_batch=4, seed=5, vocab_size=64)
    key, shape = frontend_shape(cfg, seq)
    src = LMDataSource(DataConfig(**kw), frontend=(key, shape))
    want = lm_batch(cfg, 4, 40, seed=5, device=CPU)
    for step in (0, 3):
        b, jb = src.batch_at(step), JLMDataSource(JDataConfig(**kw)).batch_at(
            step)
        assert sorted(b) == sorted(want)
        for k in jb:
            np.testing.assert_array_equal(b[k], np.asarray(jb[k]))
        assert b[key].shape == tuple(want[key].shape)
        assert b[key].dtype == np.float32
        assert 0.5 < float(b[key].std()) < 1.5
        np.testing.assert_array_equal(b[key], src.batch_at(step)[key])
        np.testing.assert_array_equal(b[key][1:3],
                                      src.batch_at(step, 1, 3)[key])
    assert not np.array_equal(src.batch_at(0)[key], src.batch_at(1)[key])
    assert frontend_shape(get_smoke_config("qwen2-72b"), seq) is None
