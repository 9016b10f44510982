"""The port's image lane (``models/image.py``, ``serve/image.py``,
``data/synthetic.py``'s ``image_batch``) against the JAX package on the
CPU, at the ``lipconvnet-15`` smoke config: the port's params and
perturbed adapters are carried to JAX as numpy (``convert.to_numpy``; JAX's
own init is slower to trace than the whole port run), int8 codes from JAX
to the port by ``convert.quant_params_from_numpy``, and the same numpy
images go through both.

Tolerances: f32 logits agree within ``F32_TOL`` (absolute; the convolutions
sum in another order), classes exactly; int8 banked logits within
``F32_TOL`` too (identical codes and scales, so only the summation order
differs); bf16 within ``BF16_REL`` of max|logit| (six Taylor terms of bf16
convolutions round differently in the two packages); gradients of the loss
The loss gradients are held against ``jax.grad`` in
tests/test_torch_image_grad.py. The JAX side is jitted, each jitted
closure is traced once (one batch shape) and JAX's bank is built once,
which keeps the file inside its time budget.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.models import image as jimage  # noqa: E402
from repro.serve.image import ImageServeEngine as JaxImageEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.peft import flatten_paths  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import image_batch  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import image as timage  # noqa: E402
from repro_torch.serve.engine import (PagedServeEngine, ServeEngine,  # noqa: E402
                                      StaticServeEngine)
from repro_torch.serve.image import ImageServeEngine  # noqa: E402
from repro_torch.store import AdapterStore  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("lipconvnet-15")
CFG = get_smoke_config("lipconvnet-15")
F32_TOL = 1e-4
BF16_REL = 0.05
BATCH = 4                        # every engine's max_batch: one JAX trace
TENANTS = {"alice": dict(method="gsoft", block_size=4),
           "bob": dict(method="boft", block_size=4),
           "carol": dict(method="householder", reflections=4)}
NAMES = [None] + list(TENANTS)


def _jc(kw):
    return jpeft.PEFTConfig(**kw)


def _tc(kw):
    return tpeft.PEFTConfig(**kw)


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, CFG.image_size, CFG.image_size,
              CFG.in_channels)).astype(np.float32)


def _tuned(cfg, params, seed, scale=0.3):
    """The port's identity-initialized adapters plus numpy noise."""
    ad = tpeft.init_peft(cfg, params, device=CPU, seed=seed)
    rng = np.random.default_rng(seed)
    return {path: {k: v + torch.from_numpy(
                scale * rng.normal(size=tuple(v.shape)).astype(np.float32))
                   for k, v in entry.items()}
            for path, entry in ad.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, convert.to_numpy(tree))


def _jq_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: ({"q": np.asarray(l.q), "scale": np.asarray(l.scale),
                    "dtype": l.meta.dtype} if jquant.is_quant_tensor(l)
                   else np.asarray(l)),
        tree, is_leaf=jquant.is_quant_tensor)


@pytest.fixture(scope="module")
def world():
    tparams = timage.init_image(CFG, 0, CPU)
    jrt = JaxRuntime(JCFG, _to_jax(tparams))
    tcfgs = {n: _tc(kw) for n, kw in TENANTS.items()}
    tad = {n: _tuned(tcfgs[n], tparams, i + 1)
           for i, n in enumerate(TENANTS)}
    jcfgs = {n: _jc(kw) for n, kw in TENANTS.items()}
    rt = ModelRuntime(CFG, tparams, device=CPU)
    return dict(jrt=jrt, jbanked=jrt.attach(_to_jax(tad), jcfgs), rt=rt,
                tad=tad, tcfgs=tcfgs, banked=rt.attach(tad, tcfgs))


def _reqs(n=8, seed=3):
    imgs = _images(n, seed)
    return [(imgs[i], NAMES[i % len(NAMES)]) for i in range(n)]


def _serve(engine, reqs):
    rids = [engine.add_request(img, adapter=name) for img, name in reqs]
    res = engine.run()
    return (np.stack([engine.result_logits[r] for r in rids]),
            [res[r] for r in rids])


@pytest.fixture(scope="module")
def jax_banked(world):
    """JAX's banked engine over the three tenants and the base slot."""
    return _serve(JaxImageEngine(world["jbanked"], max_batch=BATCH), _reqs())


@pytest.fixture(scope="module")
def jax_base(world):
    x = _images(BATCH, 5)
    return x, np.asarray(world["jrt"].infer(jnp.asarray(x)))


def test_apply_image_matches_jax(world, jax_base):
    x, want = jax_base
    got = timage.apply_image(CFG, world["rt"].params, torch.from_numpy(x))
    assert got.shape == (BATCH, CFG.num_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    # the port's init: JAX's tree (paths, shapes), every wc the identity
    jshapes = {k: tuple(v.shape) for k, v in flatten_paths(
        jimage.abstract_params(JCFG)).items()}
    assert {k: tuple(v.shape) for k, v in flatten_paths(
        world["rt"].params).items()} == jshapes
    assert torch.equal(world["rt"].params["block1"]["down"]["wc"],
                       torch.eye(32))


def test_apply_image_bf16_within_logit_tolerance(world, jax_base):
    """bf16 activations (the full config's dtype) against JAX's f32 logits
    of the same params and images."""
    x, want = jax_base
    got = timage.apply_image(CFG.with_overrides(dtype="bf16"),
                             world["rt"].params, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    gap = np.abs(got.float().numpy() - want).max()
    assert gap <= BF16_REL * np.abs(want).max(), gap


def test_banked_engine_matches_jax_engine(world, jax_banked):
    """gsoft, boft and householder tenants and the base slot: logits and
    classes equal JAX's ImageServeEngine on the same images."""
    jlogits, jcls = jax_banked
    logits, cls = _serve(ImageServeEngine(world["banked"], max_batch=BATCH),
                         _reqs())
    np.testing.assert_allclose(logits, jlogits, atol=F32_TOL, rtol=0)
    assert cls == jcls
    # distinct tenants give distinct logits (the adapters act)
    assert np.abs(logits[1] - logits[0]).max() > 1e-3 or \
        np.abs(logits[5] - logits[4]).max() > 1e-3


def test_banked_matches_solo_merged_and_identity_slot_is_exact(world):
    reqs = _reqs(8, 9)
    got, _ = _serve(ImageServeEngine(world["banked"], max_batch=BATCH), reqs)
    for name in NAMES:
        idx = [i for i, (_, n) in enumerate(reqs) if n == name]
        imgs = torch.from_numpy(np.stack([reqs[i][0] for i in idx]))
        rt = (world["rt"] if name is None else ModelRuntime(
            CFG, world["rt"].params, device=CPU, adapters=world["tad"][name],
            peft_cfg=world["tcfgs"][name]))
        want = rt.infer(imgs).numpy()
        if name is None:       # the base slot is the base model bit for bit
            np.testing.assert_array_equal(got[idx], want)
        else:
            np.testing.assert_allclose(got[idx], want, atol=F32_TOL, rtol=0,
                                       err_msg=name)


def test_int8_banked_logits_match_jax_on_identical_codes(world):
    w = world
    jq = w["jbanked"].quantized("int8")
    jlogits, jcls = _serve(JaxImageEngine(jq, max_batch=BATCH), _reqs(8, 11))
    qparams = convert.quant_params_from_numpy(_jq_numpy(jq.params),
                                              device=CPU)
    trt = ModelRuntime(CFG, qparams, device=CPU).attach(w["tad"], w["tcfgs"])
    assert trt.is_quantized or any(
        hasattr(v, "q") for v in flatten_paths(qparams).values())
    logits, cls = _serve(ImageServeEngine(trt, max_batch=BATCH), _reqs(8, 11))
    np.testing.assert_allclose(logits, jlogits, atol=F32_TOL, rtol=0)
    assert cls == jcls
    # the port's own quantization gives the same codes
    own = w["banked"].quantized("int8")
    for path, leaf in flatten_paths(own.params).items():
        if hasattr(leaf, "q"):
            assert torch.equal(leaf.q, flatten_paths(qparams)[path].q), path


def test_merge_then_quantize_gives_row_major_codes(world):
    """A tenant merged into wc (a transposed view out of the weight-side
    rotation), then quantized: the codes are row-major (the card's int8
    kernels stream them so) and equal those of the contiguous weight."""
    w = world
    merged = ModelRuntime(CFG, w["rt"].params, device=CPU,
                          adapters=w["tad"]["alice"],
                          peft_cfg=w["tcfgs"]["alice"])
    wc = merged.params["block0"]["conv0"]["wc"]
    q = merged.quantized("int8").params["block0"]["conv0"]["wc"]
    assert q.q.is_contiguous()
    from repro_torch.quant import quantize_tensor
    ref = quantize_tensor(wc.contiguous())
    assert torch.equal(q.q, ref.q) and torch.equal(q.scale, ref.scale)


def test_store_paged_bank_matches_eager(world):
    """Four tenants (dave: a second GSOFT tenant with alice's factors) in
    three device slots: gsoft pages, and every request equals the eager
    bank's (dave's equals alice's)."""
    w = world
    store = AdapterStore.from_adapters(dict(w["tad"], dave=w["tad"]["alice"]),
                                       dict(w["tcfgs"],
                                            dave=w["tcfgs"]["alice"]))
    srt = w["rt"].attach(store, hbm_budget=3)
    imgs = _images(10, 13)
    names = [None, "alice", "bob", "carol", "dave"]
    reqs = [(imgs[i], names[i % 5]) for i in range(10)]
    eng = ImageServeEngine(srt, max_batch=BATCH)
    got, _ = _serve(eng, reqs)
    want, _ = _serve(ImageServeEngine(w["banked"], max_batch=BATCH),
                     [(im, "alice" if n == "dave" else n) for im, n in reqs])
    np.testing.assert_array_equal(got, want)
    st = eng.adapter_stats()
    assert st["evictions"] > 0, st


def test_engine_surface_and_tracer(world):
    from repro_torch.obs import MetricsRegistry, SLOMonitor, TraceRecorder
    tracer = TraceRecorder(slo=SLOMonitor(), registry=MetricsRegistry())
    eng = ImageServeEngine(world["banked"], max_batch=2, tracer=tracer)
    reqs = _reqs(5, 15)
    for img, name in reqs:
        eng.add_request(img, adapter=name)
    assert eng.queue_depth == eng.load == 5 and eng.idle is False
    moved = eng.steal_queued()
    assert moved.rid == 4 and eng.queue_depth == 4
    assert eng.submit(moved) == 5
    eng.run()
    assert len(tracer.finished) == 5 and all(t.complete
                                             for t in tracer.finished)
    assert eng.stats["requests"] == 5 and eng.stats["decode_steps"] == 3
    assert eng.adapter_stats() is None
    assert len(eng.drain_finished()) == 5 and not eng.result_logits


@pytest.mark.parametrize("engine_cls", [ServeEngine, StaticServeEngine])
def test_token_engines_refuse_the_image_family(world, engine_cls):
    with pytest.raises(ValueError, match="stateless"):
        engine_cls(world["rt"], max_batch=2, max_len=16, eos_id=-1)


def test_image_engine_refusals(world):
    with pytest.raises(ValueError, match="paged KV"):
        PagedServeEngine(world["rt"], max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="stateless"):
        world["rt"].decode_state(1, 8)
    qwen = ModelRuntime(get_smoke_config("qwen2-72b"), device=CPU)
    with pytest.raises(ValueError, match="prefill/decode"):
        ImageServeEngine(qwen)
    with pytest.raises(ValueError, match="no stateless infer"):
        qwen.infer_fn()
    eng = ImageServeEngine(world["rt"], max_batch=2)
    with pytest.raises(ValueError, match="shape"):
        eng.add_request(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(KeyError):
        eng.add_request(_images(1)[0], adapter="alice")


def test_image_batch_is_seeded_and_learnable():
    a = image_batch(CFG, 6, seed=1, device=CPU)
    b = image_batch(CFG, 6, seed=1, device=CPU)
    c = image_batch(CFG, 6, seed=2, device=CPU)
    assert a["images"].shape == (6, 32, 32, 3) and a["labels"].shape == (6,)
    assert torch.equal(a["images"], b["images"])
    assert not torch.equal(a["images"], c["images"])
    assert int(a["labels"].max()) < CFG.num_classes
    # one class manifold whatever the seed: same label -> same template
    d = image_batch(CFG, 64, seed=3, device=CPU)
    lab = d["labels"]
    i, j = next((i, j) for i in range(64) for j in range(i + 1, 64)
                if lab[i] == lab[j])
    assert float((d["images"][i] - d["images"][j]).std()) < 1.0


def test_launcher_serves_the_image_family(capsys, tmp_path):
    assert tlaunch.main(["--arch", "lipconvnet-15", "--smoke", "--family",
                         "image", "--requests", "6", "--demo-adapters", "3",
                         "--demo-methods", "gsoft,boft,householder",
                         "--trace", "--trace-out",
                         str(tmp_path / "t.json"), "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "[continuous] served 6 requests, 6 tokens" in out
    assert "methods ['boft', 'gsoft', 'householder']" in out
    assert "ttft_ms" in out and "trace: 6 requests" in out
    with pytest.raises(SystemExit, match="stateless"):
        tlaunch.main(["--arch", "lipconvnet-15", "--smoke", "--engine",
                      "paged", "--device", CPU])
    with pytest.raises(SystemExit, match="registers family"):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--family", "image",
                      "--device", CPU])
