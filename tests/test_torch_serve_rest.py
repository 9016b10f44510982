"""The rest of the port's serving slice against the JAX package on the CPU,
at the qwen2-72b smoke config in f32 (JAX's params carried across by
``repro_torch.convert``): ``StaticServeEngine`` on one merged GSOFT adapter
gives JAX's static engine's greedy tokens on ragged prompts (exactly) and
refuses a banked runtime; the multi-replica surface (``steal_queued``,
``submit``, ``load``, ``queue_depth``) behaves as JAX's; the runtime's new
surfaces (``banked``, ``stateless``, ``prefill_fn``); ``lm_batch``'s
structure; the launcher's ``--engine static --peft-demo`` lane."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.peft import PrefillRequest  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")
JPCFG = jpeft.PEFTConfig(method="gsoft", block_size=8)
PCFG = tpeft.PEFTConfig(method="gsoft", block_size=8)
# ragged prompts and budgets (rows of one static batch differ in both)
PROMPTS = [([3, 4, 5, 6], 5), ([9, 10, 11], 7), ([7, 8, 9, 10, 11, 12, 13], 4),
           ([21, 22, 23, 24, 25], 6), ([30, 31], 3)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tuned(params, seed, scale=0.3):
    ad = jpeft.init_peft(JPCFG, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    jad = _tuned(jrt.params, 7)
    params = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    jmerged = JaxRuntime(JCFG, jrt.params, adapters=jad, peft_cfg=JPCFG)
    merged = ModelRuntime(CFG, params, device=CPU, adapters=tad,
                          peft_cfg=PCFG)
    return dict(jrt=jrt, jad=jad, jmerged=jmerged, rt=ModelRuntime(
        CFG, params, device=CPU), tad=tad, merged=merged)


def _run(eng, reqs=PROMPTS):
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_static_tokens(world):
    return _run(jengine.StaticServeEngine(world["jmerged"], max_batch=3,
                                          max_len=48, eos_id=-1))


def test_static_engine_tokens_equal_jax_on_merged_gsoft(world,
                                                        jax_static_tokens):
    eng = tengine.StaticServeEngine(world["merged"], max_batch=3, max_len=48,
                                    eos_id=-1)
    got = _run(eng)
    assert got == jax_static_tokens
    assert [len(t) for t in got] == [n for _, n in PROMPTS]
    # two batches (3 + 2 rows), lockstep to each batch's longest budget
    assert eng.stats["prefills"] == 2
    assert eng.stats["decode_steps"] == (7 - 1) + (6 - 1)
    assert eng.stats["requests"] == 5 and eng.queue_depth == 0
    assert all(r.t_submit <= r.t_first <= r.t_done for r in eng.finished)


def test_static_equals_continuous_on_the_merged_runtime(world,
                                                        jax_static_tokens):
    cont = _run(tengine.ServeEngine(world["merged"], max_batch=2, max_len=48,
                                    eos_id=-1))
    assert cont == jax_static_tokens


def test_static_engine_refusals(world):
    banked = world["rt"].attach({"a": world["tad"]}, PCFG)
    assert banked.banked and not world["merged"].banked
    with pytest.raises(ValueError, match="merges ONE adapter"):
        tengine.StaticServeEngine(banked)
    eng = tengine.StaticServeEngine(world["merged"], max_len=16)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.add_request(list(range(10)), max_new_tokens=8)
    assert not world["rt"].stateless
    assert tengine._stream_prefix(CFG) == 0
    tengine._check_token_family(CFG)


def test_prefill_fn_gathers_each_rows_last_logits(world):
    """The batched prefill's logits at each row's own last_idx equal a
    batch-1 prefill of that row alone."""
    rt = world["merged"]
    toks = torch.tensor([[3, 4, 5, 6, 0, 0], [9, 10, 11, 12, 13, 14]])
    last = torch.tensor([3, 5])
    logits, _ = rt.prefill_fn()(rt.params, PrefillRequest(
        batch={"tokens": toks}, last_idx=last), rt.decode_state(2, 16))
    for i in range(2):
        solo, _ = rt.prefill_fn()(rt.params, PrefillRequest(
            batch={"tokens": toks[i:i + 1, :int(last[i]) + 1]}),
            rt.decode_state(1, 16))
        torch.testing.assert_close(logits[i, -1], solo[0, -1], atol=1e-5,
                                   rtol=0)


def _surface(mod, rt):
    """The same calls on either package's ServeEngine: queue three, steal
    the youngest, resubmit it, serve."""
    eng = mod.ServeEngine(rt, max_batch=2, max_len=48, eos_id=-1)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in PROMPTS[:3]]
    seen = [eng.queue_depth, eng.load, eng.num_active, eng.idle]
    stolen = eng.steal_queued()
    seen += [stolen.rid, stolen.prompt, eng.queue_depth]
    seen.append(eng.submit(stolen))
    seen += [eng.queue_depth, eng.load]
    eng.step()
    seen += [eng.queue_depth, eng.num_active, eng.load]
    out = eng.run()
    seen += [sorted(out), [out[r] for r in rids[:2]] + [out[3]]]
    seen += [len(eng.drain_finished()), eng.finished, eng.adapter_stats()]
    empty = mod.ServeEngine(rt, max_batch=2, max_len=48, eos_id=-1)
    seen.append(empty.steal_queued())
    return seen


def test_engine_surface_behaves_as_in_jax(world):
    assert _surface(tengine, world["rt"]) == _surface(jengine, world["jrt"])


def test_latency_percentiles_match_jax():
    reqs = []
    for mod in (tengine, jengine):
        rs = []
        for i, (t0, t1) in enumerate([(0.0, 0.5), (0.1, 0.3), (0.2, 1.4),
                                      (0.3, 0.35)]):
            r = mod.Request(i, [1], t_submit=t0, t_done=t1)
            rs.append(r)
        reqs.append(rs)
    assert [r.latency_s for r in reqs[0]] == [r.latency_s for r in reqs[1]]
    assert tengine.latency_percentiles(reqs[0], (50, 95, 99)) == \
        jengine.latency_percentiles(reqs[1], (50, 95, 99))
    assert tengine.latency_percentiles([]) == {50: 0.0, 95: 0.0}


def test_lm_batch_has_jax_structure():
    """The port's stream is its own (another generator) with JAX's
    structure: labels are the next tokens, and every token is either the
    bigram (prev * 31 + 7) % V of the one before it or a noise reset
    divisible by 7."""
    b = lm_batch(CFG, 3, 40, seed=2, device=CPU)
    jb = jsynth.lm_batch(JCFG, 3, 40, seed=2)
    for k in ("tokens", "labels", "mask"):
        assert tuple(b[k].shape) == tuple(jb[k].shape)
    full = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    prev, nxt = full[:, :-1], full[:, 1:]
    bigram = nxt == (prev * 31 + 7) % CFG.vocab_size
    assert bool(torch.all(bigram | (nxt % 7 == 0)))
    assert float(bigram.float().mean()) > 0.5
    assert torch.equal(b["tokens"], lm_batch(CFG, 3, 40, seed=2,
                                             device=CPU)["tokens"])
    assert float(b["mask"].sum()) == 3 * 40


def test_launcher_static_lane(capsys):
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--engine",
                         "static", "--peft-demo", "--requests", "5",
                         "--mixed-lengths", "--trace", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "[static] served 5 requests" in out and "2 prefills" in out
    assert "ttft_ms" in out
    with pytest.raises(SystemExit, match="static serving merges ONE"):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--engine", "static",
                      "--demo-adapters", "2", "--device", CPU])
    with pytest.raises(SystemExit, match="pick one"):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--peft-demo",
                      "--demo-adapters", "2", "--device", CPU])


def test_launcher_saves_and_reloads_a_mixed_demo_bank(capsys, tmp_path):
    d = str(tmp_path / "bank")
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--requests", "4",
                         "--demo-adapters", "3", "--demo-methods",
                         "gsoft,boft,householder", "--save-adapters", d,
                         "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "round-tripped ['a0', 'a1', 'a2']" in out
    assert "methods ['boft', 'gsoft', 'householder']" in out
    with pytest.raises(SystemExit, match="needs a bank"):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--save-adapters", d,
                      "--device", CPU])
