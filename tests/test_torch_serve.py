"""The port's serving slice against the JAX package on the CPU, at the
qwen2-72b smoke config in f32: JAX ``init_lm`` params and perturbed
``init_peft`` adapters are carried across by ``repro_torch.convert``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import adapters as tad_lib  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")
JPCFG = jpeft.PEFTConfig(method="gsoft", block_size=8)
PCFG = tpeft.PEFTConfig(method="gsoft", block_size=8)
PROMPTS = {"alice": [3, 4, 5, 6], "bob": [9, 10, 11], None: [7, 8, 9, 10, 11]}
LOGIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tuned(params, seed, scale=0.3):
    """Perturbed identity adapters (noise from numpy, shared by both)."""
    ad = jpeft.init_peft(JPCFG, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    jad = {"alice": _tuned(jrt.params, 7), "bob": _tuned(jrt.params, 11)}
    tparams = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    return jrt, jad, ModelRuntime(CFG, tparams, device=CPU), tad


def _serve(engine, adapters=(None,)):
    rids = {a: engine.add_request(PROMPTS[a], max_new_tokens=5, adapter=a)
            for a in adapters}
    out = engine.run()
    return {a: out[rid] for a, rid in rids.items()}


@pytest.fixture(scope="module")
def jax_bank_tokens(world):
    jrt, jad, _, _ = world
    eng = JaxEngine(jrt.attach(jad, JPCFG), max_batch=3, max_len=48, eos_id=-1)
    return _serve(eng, ("alice", "bob", None))


@pytest.fixture(scope="module")
def port_bank_tokens(world):
    _, _, rt, tad = world
    eng = ServeEngine(rt.attach(tad, PCFG), max_batch=3, max_len=48,
                      eos_id=-1)
    return _serve(eng, ("alice", "bob", None))


def test_param_paths_match_jax(world):
    jrt, jad, rt, tad = world
    assert sorted(tpeft.flatten_paths(rt.params)) == \
        sorted(jpeft.flatten_paths(jrt.params))
    assert sorted(tpeft.adapted_paths(PCFG, rt.params)) == \
        sorted(jpeft.adapted_paths(JPCFG, jrt.params))
    assert sorted(tad["alice"]) == sorted(jad["alice"])
    bank = tpeft.build_adapter_bank(PCFG, rt.params, tad)
    jbank = jpeft.build_adapter_bank(JPCFG, jrt.params, jad)
    tflat, jflat = (tpeft.flatten_paths(bank.tree),
                    jpeft.flatten_paths(jbank.tree))
    assert sorted(tflat) == sorted(jflat)
    for path, leaf in jflat.items():
        assert tuple(tflat[path].shape) == leaf.shape
        np.testing.assert_allclose(tflat[path].numpy(), np.asarray(leaf),
                                   atol=1e-5)


@pytest.mark.parametrize("banked", [False, True])
def test_prefill_and_decode_logits_match_jax(world, banked):
    jrt, jad, rt, tad = world
    toks = np.asarray([[5, 9, 3, 7, 0, 0, 0, 0], [4, 8, 2, 6, 1, 0, 0, 0]])
    last = np.asarray([3, 4])
    slots = [1, 2]
    jctx = jpeft.build_adapter_bank(JPCFG, jrt.params, jad).context(slots) \
        if banked else None
    tctx = tpeft.build_adapter_bank(PCFG, rt.params, tad).context(slots) \
        if banked else None

    jstate = jrt.init_decode_state(2, 16)
    jlog, jstate = jsteps.build_prefill_step(JCFG)(
        jrt.params, jpeft.PrefillRequest(batch={"tokens": jnp.asarray(toks)},
                                         last_idx=jnp.asarray(last),
                                         ctx=jctx), jstate)
    tstate = rt.decode_state(2, 16)
    tlog, tstate = tsteps.build_prefill_step(CFG)(
        rt.params, tpeft.PrefillRequest(batch={"tokens": torch.as_tensor(toks)},
                                        last_idx=torch.as_tensor(last),
                                        ctx=tctx), tstate)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL)

    nxt = np.asarray([[11], [12]])
    pos = last + 1
    _, jdl, _ = jsteps.build_decode_step(JCFG)(
        jrt.params, jctx, jnp.asarray(nxt), jstate, jnp.asarray(pos))
    _, tdl, _ = tsteps.build_decode_step(CFG)(
        rt.params, tctx, torch.as_tensor(nxt), tstate, torch.as_tensor(pos))
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), atol=LOGIT_TOL)


def test_forward_logits_match_jax(world):
    jrt, _, rt, _ = world
    toks = np.asarray([[5, 9, 3, 7, 2, 1], [4, 8, 2, 6, 1, 0]])
    jlog, _ = jtransformer.forward(JCFG, jrt.params,
                                   {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlog, _ = transformer.forward(CFG, rt.params,
                                      {"tokens": torch.as_tensor(toks)})
    assert tuple(tlog.shape) == jlog.shape == (2, 6, CFG.padded_vocab())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL)


def test_mixed_bank_engine_tokens_equal_jax(jax_bank_tokens, port_bank_tokens):
    assert port_bank_tokens == jax_bank_tokens
    assert port_bank_tokens["alice"] != port_bank_tokens["bob"]


@pytest.mark.parametrize("name", ["alice", "bob"])
def test_banked_tokens_equal_merged_runtime(world, port_bank_tokens, name):
    """Per-request adapter from the bank (transpose rotation) == the same
    adapter merged offline into the weights (forward rotation)."""
    _, _, rt, tad = world
    merged = ModelRuntime(CFG, rt.params, device=CPU, adapters=tad[name],
                          peft_cfg=PCFG)
    eng = ServeEngine(merged, max_batch=1, max_len=48, eos_id=-1)
    rid = eng.add_request(PROMPTS[name], max_new_tokens=5)
    assert eng.run()[rid] == port_bank_tokens[name]


def test_identity_slot_equals_bankless_model(world, port_bank_tokens):
    _, _, rt, _ = world
    eng = ServeEngine(rt, max_batch=2, max_len=48, eos_id=-1)
    assert _serve(eng)[None] == port_bank_tokens[None]


def test_eos_frees_slot_and_admits_queued_request(world):
    """EOS ends a request early; the queued request takes its slot at that
    decode step, not after the finished request's token budget."""
    _, _, rt, _ = world

    def engine(eos):
        return ServeEngine(rt, max_batch=1, max_len=64, eos_id=eos)
    probe_eng = engine(-1)
    rid = probe_eng.add_request([3, 4, 5], max_new_tokens=8)
    probe = probe_eng.run()[rid]
    eos = next(t for t in probe[1:] if t != probe[0])
    k = probe.index(eos) + 1
    eng = engine(eos)
    r1 = eng.add_request([3, 4, 5], max_new_tokens=8)
    r2 = eng.add_request([9, 10, 11, 12], max_new_tokens=4)
    results = eng.run()
    assert results[r1] == probe[:k]
    assert 1 <= len(results[r2]) <= 4
    assert dict(eng.stats["admission_log"])[r2] == k - 1


def test_unknown_method_or_adapter_raises(world):
    _, _, rt, tad = world
    with pytest.raises(KeyError,
                       match="registered methods: \\['boft', 'double_gsoft', "
                             "'givens', 'gsoft', 'householder', 'lora', 'oft'\\]"):
        methods.get("monarch")
    with pytest.raises(KeyError, match="monarch"):
        rt.attach(tad, tpeft.PEFTConfig(method="monarch"))
    banked = rt.attach(tad, PCFG)
    eng = ServeEngine(banked, max_batch=1, max_len=48)
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.add_request([1, 2], adapter="carol")
    with pytest.raises(KeyError, match="no adapter bank"):
        ServeEngine(rt, max_batch=1, max_len=48).add_request(
            [1, 2], adapter="alice")


def test_entry_points_without_device_refuse_the_cpu(world, monkeypatch):
    """With no card, an entry point given no device raises instead of
    silently running on the CPU."""
    _, _, rt, tad = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRuntime(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRuntime(CFG, rt.params)
    spec = tad_lib.AdapterSpec(method="gsoft", d_in=64, d_out=8,
                               block_size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tad_lib.init_adapter(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tad_lib.gsoft_init(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_lm(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpeft.init_peft(PCFG, rt.params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy({"w": np.zeros(2)})


def test_port_init_is_seeded_and_on_the_requested_device():
    a = transformer.init_lm(CFG, seed=3, device=CPU)
    b = transformer.init_lm(CFG, seed=3, device=CPU)
    flat_a, flat_b = tpeft.flatten_paths(a), tpeft.flatten_paths(b)
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
    assert all(v.device.type == "cpu" for v in flat_a.values())
