"""The encoder-decoder family (``models/encdec.py``, seamless-m4t-medium)
against the JAX package on the CPU at its smoke config in f32. JAX
``init_encdec`` params, perturbed ``init_peft`` adapters and numpy batches
are carried across by ``repro_torch.convert``. Held: the config and the
param tree, ``encode`` and ``forward`` / ``lm_loss`` with random frames,
``prefill`` + ``decode_step`` with random frames (the engines feed zero
frames, whose encoder output is zero, so cross-attention then adds
nothing), the decode state's ``enc_out`` and ``kv``, the slot scatter's
batch axes, three GSOFT train steps and the adapters' gradients, greedy
tokens of ``ServeEngine`` and ``StaticServeEngine`` on merged adapters,
the bank refused as in JAX, the paged engine refused, and the launchers.

Tolerances: logits and losses within 1e-5 of the largest magnitude (sums
in another order); adapter gradients within 1e-4 of each leaf's largest;
updated adapters within 1e-2 of the learning rate (AdamW moves an entry by
about lr * g / (|g| + eps))."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.peft import PrefillRequest as JPrefill  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.peft import PrefillRequest  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch_train  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
ARCH = "seamless-m4t-medium"
F32_REL = 1e-5
GRAD_REL = 1e-4
PROMPTS = ([3, 4, 5, 6], [9, 10, 11], [7, 8, 9, 10, 11])


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


def _batch(cfg, s=12, f=9, seed=0):
    """Random tokens and frames (F = 9: not a multiple of the chunk or of
    anything else), a ragged mask on row 1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, s + 1))
    mask = np.ones((2, s), np.float32)
    mask[1, -3:] = 0.0
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "mask": mask,
            "frames": rng.normal(size=(2, f, cfg.d_model)).astype(np.float32)}


_W = {}


def world():
    if not _W:
        jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
        jrt = JaxRuntime(jcfg, key=jax.random.PRNGKey(0))
        params = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
        _W.update(jcfg=jcfg, cfg=cfg, jrt=jrt, params=params)
    return _W


def test_config_tree_and_counts_match_jax():
    w = world()
    assert convert.config_from_jax(w["jcfg"]) == w["cfg"]
    assert w["cfg"].enc_layers == 2 and w["cfg"].frontend == "frames"
    assert convert.config_from_jax(jax_get_config(ARCH)) == get_config(ARCH)
    own = encdec.init_encdec(w["cfg"], seed=3, device=CPU)
    want = {p: tuple(v.shape) for p, v in
            tpeft.flatten_paths(_np_tree(w["jrt"].params)).items()}
    got = {p: tuple(v.shape) for p, v in tpeft.flatten_paths(own).items()}
    assert got == want
    for cfg, jcfg in ((w["cfg"], w["jcfg"]),
                      (get_config(ARCH), jax_get_config(ARCH))):
        assert api.param_count(cfg) == japi.param_count(jcfg)
        assert api.active_param_count(cfg) == \
            japi.active_param_count(jcfg) == api.param_count(cfg)
    assert api.family_ops(w["cfg"]).has_encoder
    assert api.family_ops(w["cfg"]).init_paged_state is None


def test_encode_forward_and_loss_match_jax():
    w = world()
    batch = _batch(w["cfg"])
    jenc = jencdec.encode(w["jcfg"], w["jrt"].params, jnp.asarray(
        batch["frames"]))
    tenc = encdec.encode(w["cfg"], w["params"], _tb(batch)["frames"])
    _close(tenc.numpy(), np.asarray(jenc), F32_REL, "enc_out")
    jlog, _ = jencdec.forward(w["jcfg"], w["jrt"].params, _jb(batch))
    jloss, jm = jencdec.lm_loss(w["jcfg"], w["jrt"].params, _jb(batch))
    tlog, taux = encdec.forward(w["cfg"], w["params"], _tb(batch))
    tloss, tm = encdec.lm_loss(w["cfg"], w["params"], _tb(batch))
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "logits")
    _close(float(tloss), float(jloss), F32_REL, "loss")
    _close(float(tm["accuracy"]), float(jm["accuracy"]), 1e-6, "accuracy")
    assert float(taux) == 0.0
    # the frames matter: other frames, other logits
    other = dict(batch, frames=batch["frames"][::-1].copy())
    assert not np.allclose(encdec.forward(w["cfg"], w["params"],
                                          _tb(other))[0].numpy(),
                           tlog.numpy())


def test_prefill_and_decode_with_random_frames_match_jax():
    """A ragged batch-2 prefill (last_idx per row) with random frames, then
    three decode steps at per-row positions: logits, the state's enc_out
    and its KV cache against JAX's."""
    w = world()
    jcfg, cfg = w["jcfg"], w["cfg"]
    batch = _batch(cfg, s=6, f=9, seed=5)
    feed = {"tokens": batch["tokens"], "frames": batch["frames"]}
    last = np.asarray([5, 3], np.int32)
    max_len = 16
    jstate = japi.init_decode_state(jcfg, 2, max_len, 9)
    tstate = api.init_decode_state(cfg, 2, max_len, 9, device=CPU)
    assert set(tstate) == {"kv", "enc_out"}
    assert tuple(tstate["enc_out"].shape) == (2, 9, cfg.d_model)
    assert tuple(tstate["kv"]["k"].shape) == tuple(jstate["kv"]["k"].shape)
    jlog, jstate = jencdec.prefill(jcfg, w["jrt"].params, JPrefill(
        batch=_jb(feed), last_idx=jnp.asarray(last)), jstate)
    tlog, tstate = encdec.prefill(cfg, w["params"], PrefillRequest(
        batch=_tb(feed), last_idx=torch.as_tensor(last)), tstate)
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "prefill logits")
    _close(tstate["enc_out"].numpy(), np.asarray(jstate["enc_out"]), F32_REL,
           "state enc_out")
    assert float(np.abs(np.asarray(jstate["enc_out"])).max()) > 0.1
    for k in ("k", "v"):
        _close(tstate["kv"][k].numpy(), np.asarray(jstate["kv"][k]), F32_REL,
               f"kv {k}")
    pos = last + 1
    tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
    for step in range(3):
        jlog, jstate = jencdec.decode_step(jcfg, w["jrt"].params,
                                           jnp.asarray(tok), jstate,
                                           jnp.asarray(pos))
        tlog, tstate = encdec.decode_step(cfg, w["params"],
                                          torch.as_tensor(tok), tstate,
                                          torch.as_tensor(pos))
        _close(tlog.numpy(), np.asarray(jlog), F32_REL, f"decode {step}")
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tstate["kv"][k].numpy(), np.asarray(jstate["kv"][k]), F32_REL,
               f"kv {k} after decode")


def test_slot_prefill_scatters_enc_out_on_axis_0():
    """enc_out's batch axis is 0, kv's is 1 (JAX's
    ``_decode_state_batch_axes``); a slot prefill writes its row of both
    and leaves the other slots' rows alone."""
    w = world()
    cfg = w["cfg"]
    assert tsteps._decode_state_batch_axes(cfg, 16, 8) == {
        "kv": {"k": 1, "v": 1}, "enc_out": 0}
    assert jax.tree.map(int, jsteps._decode_state_batch_axes(
        w["jcfg"], 16, 8)) == {"kv": {"k": 1, "v": 1}, "enc_out": 0}
    step = tsteps.build_slot_prefill_step(cfg, max_len=16, enc_len=8,
                                          device=CPU)
    state = api.init_decode_state(cfg, 3, 16, 8, device=CPU)
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.normal(size=(1, 8, cfg.d_model)).astype(
        np.float32))
    req = PrefillRequest(batch={"tokens": torch.tensor([[5, 6, 7, 0]]),
                                "frames": frames},
                         last_idx=torch.tensor(2))
    _, state = step(w["params"], req, state, 1)
    want = encdec.encode(cfg, w["params"], frames)[0]
    assert torch.equal(state["enc_out"][1], want)
    assert not state["enc_out"][0].any() and not state["enc_out"][2].any()
    assert state["kv"]["k"][:, 1, :4].abs().sum() > 0
    assert not state["kv"]["k"][:, 0].any() and not state["kv"]["k"][:, 2].any()


def test_gsoft_training_matches_jax():
    """Three GSOFT train steps (the 16 adapted stacks: encoder attn / mlp,
    decoder attn / cross / mlp) against JAX's jitted step, then every
    adapter leaf's gradient against jax.grad."""
    w = world()
    jcfg, cfg = w["jcfg"], w["cfg"]
    kw = dict(method="gsoft", block_size=8)
    jpc, tpc = jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)
    okw = dict(learning_rate=1e-2)
    jt = jsteps.TrainStepConfig(peft=jpc, opt=joptim.OptimizerConfig(**okw))
    tt = tsteps.TrainStepConfig(peft=tpc, opt=optim.OptimizerConfig(**okw))
    jad = _np_tree(_tuned(jpc, w["jrt"].params, 3, 0.05))
    assert len(jad) == 16
    assert {p.split("/")[0] for p in jad} == {"encoder", "decoder"}
    jstep = jax.jit(jsteps.build_train_step(jcfg, jt))
    tstep = tsteps.build_train_step(cfg, tt)
    jtr = jax.tree.map(jnp.asarray, jad)
    jopt = joptim.init(jt.opt, jtr)
    ttr = convert.adapters_from_numpy(jad, device=CPU)
    topt = convert.opt_state_from_numpy(_np_tree(jopt), device=CPU)
    for step in range(3):
        batch = _batch(cfg, s=10, f=8, seed=10 + step)
        jtr, jopt, jm = jstep(w["jrt"].params, jtr, jopt, _jb(batch))
        ttr, topt, tm = tstep(w["params"], ttr, topt, _tb(batch))
        for key in ("loss", "grad_norm", "accuracy"):
            _close(float(tm[key]), float(jm[key]), F32_REL, f"{step} {key}")
    want = tpeft.flatten_paths(_np_tree(jtr))
    got = tpeft.flatten_paths(convert.to_numpy(ttr))
    assert sorted(got) == sorted(want)
    for path in want:
        _close(got[path], want[path], 1e-2 * okw["learning_rate"],
               f"adapters {path}")

    batch = _batch(cfg, s=12, f=10, seed=4)

    def jloss(ad):
        p = jpeft.materialize_tree(jpc, w["jrt"].params, ad)
        return jencdec.lm_loss(jcfg, p, _jb(batch))[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jad))
    tad = {p: {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in leaf.items()} for p, leaf in jad.items()}
    tl, _ = encdec.lm_loss(
        cfg, tpeft.materialize_tree(tpc, w["params"], tad), _tb(batch))
    leaves = [(p, k) for p in sorted(tad) for k in sorted(tad[p])]
    tg = torch.autograd.grad(tl, [tad[p][k] for p, k in leaves])
    _close(float(tl.detach()), float(jl), F32_REL, "grad loss")
    for (p, k), g in zip(leaves, tg):
        _close(g.numpy(), np.asarray(jg[p][k]), GRAD_REL, f"d {p}/{k}")


@pytest.mark.parametrize("engine", ("continuous", "static"))
def test_merged_serving_tokens_equal_jax(engine):
    """One GSOFT adapter merged into the weights (the 16 stacks), greedy
    tokens of three requests through JAX's engine and the port's, token
    for token (the engines feed zero frames, as JAX's do)."""
    w = world()
    kw = dict(method="gsoft", block_size=8)
    jpc, tpc = jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)
    jad = _tuned(jpc, w["jrt"].params, 5)
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    jrt = JaxRuntime(w["jcfg"], w["jrt"].params, adapters=jad, peft_cfg=jpc)
    rt = ModelRuntime(w["cfg"], w["params"], device=CPU, adapters=tad,
                      peft_cfg=tpc)
    merged = tpeft.materialize_tree(tpc, w["params"], tad)
    for path in tad:
        a = tpeft.flatten_paths(merged)[path]
        assert not torch.equal(a, tpeft.flatten_paths(w["params"])[path])
    kind = (jengine.ServeEngine, tengine.ServeEngine) if engine == \
        "continuous" else (jengine.StaticServeEngine,
                           tengine.StaticServeEngine)
    ekw = dict(max_batch=2, max_len=32, eos_id=-1)
    outs = []
    for cls, r in zip(kind, (jrt, rt)):
        eng = cls(r, **ekw)
        rids = [eng.add_request(p, max_new_tokens=5) for p in PROMPTS]
        res = eng.run()
        outs.append([res[i] for i in rids])
    assert outs[1] == outs[0]
    assert all(len(o) == 5 for o in outs[1])


def test_bank_and_paged_engine_refused_as_in_jax():
    """JAX refuses a bank for encdec at its first prefill; the port's
    prefill and decode raise the same ValueError, and the paged engine
    refuses the family (no paged surface)."""
    w = world()
    kw = dict(method="gsoft", block_size=8)
    jpc, tpc = jpeft.PEFTConfig(**kw), tpeft.PEFTConfig(**kw)
    jad = {"a": _tuned(jpc, w["jrt"].params, 7)}
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    jeng = jengine.ServeEngine(w["jrt"].attach(jad, jpc), max_batch=1,
                               max_len=32)
    jeng.add_request([3, 4, 5], max_new_tokens=2, adapter="a")
    with pytest.raises(ValueError, match="not supported for encdec"):
        jeng.run()
    rt = ModelRuntime(w["cfg"], w["params"], device=CPU).attach(tad, tpc)
    eng = tengine.ServeEngine(rt, max_batch=1, max_len=32)
    eng.add_request([3, 4, 5], max_new_tokens=2, adapter="a")
    with pytest.raises(ValueError, match="not supported for encdec"):
        eng.run()
    with pytest.raises(ValueError, match="not supported for encdec"):
        encdec.decode_step(w["cfg"], w["params"], torch.zeros((1, 1),
                                                              dtype=torch.long),
                           api.init_decode_state(w["cfg"], 1, 8, 8,
                                                 device=CPU),
                           0, ctx=rt.context([1]))
    with pytest.raises(ValueError, match="no paged KV serve path"):
        tengine.PagedServeEngine(ModelRuntime(w["cfg"], w["params"],
                                              device=CPU))


def test_launchers_train_serve_and_refuse_a_mesh(capsys):
    """``launch/train.py --arch seamless-m4t-medium`` trains (frames in
    every batch), ``launch/serve.py`` serves it merged (continuous and
    static), and ``--tp 2`` / ``--mesh`` raise NotImplementedError naming
    the ROADMAP item."""
    assert tlaunch_train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                               "--batch", "2", "--seq", "16", "--block-size",
                               "8", "--warmup", "1", "--no-resume",
                               "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and out.count("step ") >= 2
    for engine in ("continuous", "static"):
        assert tlaunch.main(["--arch", ARCH, "--smoke", "--peft-demo",
                             "--engine", engine, "--requests", "3",
                             "--device", CPU]) == 0
        assert f"[{engine}] served 3 requests" in capsys.readouterr().out
    for flags in (["--tp", "2"], ["--mesh", "1,2"], ["--mesh", "2,1"]):
        with pytest.raises(NotImplementedError, match="encdec / vlm mesh"):
            tlaunch.main(["--arch", ARCH, "--smoke", "--device", CPU]
                         + flags)
    with pytest.raises(NotImplementedError, match="encdec / vlm mesh"):
        tsteps.build_train_step(get_smoke_config(ARCH),
                                tsteps.TrainStepConfig(), mesh=object())
