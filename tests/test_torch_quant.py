"""The port's int8 serving slice against the JAX package on the CPU:
``quant`` codes and scales, the plain versions of the ``q_matmul`` and
banked ``gs_q_matmul`` kernels against the Pallas kernels in interpret mode,
``quantize_params`` / ``tree_bytes``, the ``quantized()`` guards, and the
quantized banked runtime (GSOFT bank and the mixed-method bank) against
JAX's banked int8 runtime on identical codes, at the qwen2-72b smoke config
in f32. Inputs come from numpy seeds; weights, adapters and int8 codes are
carried across by ``repro_torch.convert``."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.q_matmul import q_matmul_pallas  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, quant  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import methods  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import q_matmul as tqm  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")
JPCFG = jpeft.PEFTConfig(method="gsoft", block_size=8)
PCFG = tpeft.PEFTConfig(method="gsoft", block_size=8)
# tests/test_quant.py's QMM_SHAPES (T, K, N): ragged T, decode, ragged N
QMM_SHAPES = [(16, 32, 64), (128, 64, 128), (33, 48, 96), (1, 64, 64),
              (250, 24, 40)]
# the JAX test's tolerances for the quantized matmul (atol = rtol)
QMM_TOL = {"f32": 1e-4, "bf16": 5e-2}
# the banked rotate + int8 matmul in f32: two fp32 sums in another order
GSQ_TOL = 1e-3
# decode logits of the quantized banked runtime on identical codes, f32
LOGIT_REL = 1e-4
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


def _jq_numpy(tree):
    """A quantized JAX tree with each QuantTensor as a {"q", "scale",
    "dtype"} mapping of numpy arrays (what ``quant_params_from_numpy``
    takes)."""
    return jax.tree_util.tree_map(
        lambda l: ({"q": np.asarray(l.q), "scale": np.asarray(l.scale),
                    "dtype": l.meta.dtype} if jquant.is_quant_tensor(l)
                   else np.asarray(l)),
        tree, is_leaf=jquant.is_quant_tensor)


def _tuned(cfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(cfg, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# quant core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,batch_dims,shape", [
    (None, 0, (48, 40)), (-1, 0, (48, 40)), (-1, 1, (3, 24, 40)),
    (None, 1, (3, 24, 40)), (0, 0, (32, 8))])
def test_quantize_int8_codes_equal_jax(axis, batch_dims, shape):
    rng = np.random.default_rng(len(shape) * 10 + batch_dims)
    w = (rng.normal(size=shape) * rng.uniform(0.1, 10, size=shape[-1])
         ).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=axis,
                                  batch_dims=batch_dims)
    tq, ts = quant.quantize_int8(torch.from_numpy(w), axis=axis,
                                 batch_dims=batch_dims)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.shape == js.shape
    # scales within one float32 ulp
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_allclose(quant.dequantize_int8(tq, ts).numpy(),
                               np.asarray(jquant.dequantize_int8(jq, js)),
                               rtol=1e-6)


def test_quant_tensor_mirrors_the_logical_weight():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 24)).astype(np.float32)).to(torch.bfloat16)
    qt = quant.quantize_tensor(w)
    assert quant.is_quant_tensor(qt) and qt.shape == w.shape
    assert qt.ndim == qt.dim() == 3 and qt.dtype == torch.bfloat16
    assert qt.scale.shape == (2, 1, 24)
    assert qt.nbytes == 2 * 16 * 24 + 2 * 24 * 4
    layer = qt[1]
    assert layer.q.shape == (16, 24) and layer.scale.shape == (1, 24)
    assert [t.q.shape for t in qt.unbind()] == [(16, 24), (16, 24)]
    err = (qt.dequantize(torch.float32) - w.float()).abs()
    assert (err <= qt.scale / 2 + 1e-6).all()
    with pytest.raises(NotImplementedError, match="fp8"):
        quant.quantize_tensor(w, mode="fp8")
    with pytest.raises(ValueError, match="unknown quantization mode"):
        quant.quantize_tensor(w, mode="int4")


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,n", QMM_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_q_matmul_matches_jax_pallas(t, k, n, dtype):
    rng = np.random.default_rng(t * 7 + n)
    x = rng.normal(size=(t, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=-1)
    want = q_matmul_pallas(jnp.asarray(x).astype(jdt), jq, js, interpret=True)
    got = tops.q_matmul(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)))
    assert got.dtype == tdt and got.shape == (t, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=QMM_TOL[dtype], rtol=QMM_TOL[dtype])


def test_q_matmul_leading_dims_and_scalar_scale():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=None)
    want = jops.q_matmul(jnp.asarray(x), jq, js, use_pallas=True)
    got = tops.q_matmul(torch.from_numpy(x), torch.from_numpy(np.array(jq)),
                        torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _factors(rng, lead, r, b):
    a = rng.normal(0, 0.3, size=lead + (r, b, b))
    k = a - np.swapaxes(a, -1, -2)
    eye = np.eye(b)
    return np.swapaxes(np.linalg.solve(eye + k, eye - k), -1, -2).astype(
        np.float32)


@pytest.mark.parametrize("bsz,t,r,b,n", [(2, 3, 4, 8, 40), (3, 1, 8, 4, 64),
                                         (1, 5, 2, 16, 24)])
def test_gs_q_matmul_banked_matches_jax_pallas(bsz, t, r, b, n):
    rng = np.random.default_rng(bsz * 100 + t * 10 + r)
    L, R = _factors(rng, (bsz,), r, b), _factors(rng, (bsz,), r, b)
    x = rng.normal(size=(bsz, t, r * b)).astype(np.float32)
    w = rng.normal(size=(r * b, n)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=-1)
    want = jops.gs_q_matmul_banked(jnp.asarray(L), jnp.asarray(R),
                                   jnp.asarray(x), jq, js, use_pallas=True)
    got = tops.gs_q_matmul_banked(
        torch.from_numpy(L), torch.from_numpy(R), torch.from_numpy(x),
        torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    assert got.shape == (bsz, t, n)
    _close(got.numpy(), np.asarray(want), GSQ_TOL, "gs_q_matmul_banked")


def test_gs_q_matmul_single_adapter_matches_jax_pallas():
    rng = np.random.default_rng(5)
    L, R = _factors(rng, (), 4, 8), _factors(rng, (), 4, 8)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=-1)
    want = jops.gs_q_matmul(jnp.asarray(L), jnp.asarray(R), jnp.asarray(x),
                            jq, js, use_pallas=True)
    got = tops.gs_q_matmul(torch.from_numpy(L), torch.from_numpy(R),
                           torch.from_numpy(x),
                           torch.from_numpy(np.array(jq)),
                           torch.from_numpy(np.array(js)))
    _close(got.numpy(), np.asarray(want), GSQ_TOL, "gs_q_matmul")


def test_quantized_kernels_refuse_gradients_and_bad_codes():
    x = torch.zeros((2, 8), requires_grad=True)
    q = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="inference only"):
        tqm.q_matmul(x, q, torch.ones(4))
    with pytest.raises(TypeError, match="int8"):
        tqm.q_matmul(x.detach(), q.float(), torch.ones(4))
    with pytest.raises(ValueError, match="K"):
        tqm.q_matmul(x.detach(), torch.zeros((6, 4), dtype=torch.int8), 1.0)


# ---------------------------------------------------------------------------
# weight trees, runtimes and serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    return jrt, ModelRuntime(CFG, tparams, device=CPU)


def test_quantize_params_codes_and_bytes_equal_jax(world):
    jrt, rt = world
    jqp = jquant.quantize_params(jrt.params, jquant.QuantConfig())
    tqp = quant.quantize_params(rt.params, quant.QuantConfig())
    jflat = jpeft.flatten_paths(_jq_numpy(jqp))
    tflat = tpeft.flatten_paths(tqp)
    jq_paths = sorted({p.rsplit("/", 1)[0] for p in jflat
                       if p.endswith("/q")})
    tq_paths = sorted(p for p, l in tflat.items() if quant.is_quant_tensor(l))
    assert tq_paths == jq_paths and "lm_head/w" in tq_paths
    assert "layers/attn/bq" not in tq_paths and "embed/table" not in tq_paths
    for path in tq_paths:
        np.testing.assert_array_equal(tflat[path].q.numpy(),
                                      jflat[path + "/q"])
        np.testing.assert_array_max_ulp(tflat[path].scale.numpy(),
                                        jflat[path + "/scale"], maxulp=1)
    assert quant.tree_bytes(tqp) == jquant.tree_bytes(jqp)
    assert quant.tree_bytes(rt.params) == jquant.tree_bytes(jrt.params)
    assert quant.is_quantized_tree(tqp)
    assert not quant.is_quantized_tree(rt.params)
    back = quant.dequantize_params(tqp)
    assert not quant.is_quantized_tree(back)


def test_release_source_frees_the_float_leaves(world):
    _, rt = world
    src = convert.params_from_numpy(convert.to_numpy(rt.params), device=CPU)
    qp = quant.quantize_params(src, quant.QuantConfig(), release_source=True)
    assert "w" not in src["lm_head"] and "wq" not in src["layers"]["attn"]
    assert "bq" in src["layers"]["attn"]          # untouched leaves stay
    assert quant.is_quant_tensor(qp["lm_head"]["w"])


def test_quantized_runtime_guards(world):
    _, rt = world
    qrt = rt.quantized("int8")
    assert qrt.is_quantized and qrt.quant_cfg.mode == "int8"
    assert not rt.is_quantized
    with pytest.raises(ValueError, match="already quantized"):
        qrt.quantized("int8")
    adapters = convert.adapters_from_numpy(
        _np_tree(_tuned(JPCFG, world[0].params, 3)), device=CPU)
    with pytest.raises(ValueError, match="already-quantized"):
        ModelRuntime(CFG, qrt.params, device=CPU, adapters=adapters,
                     peft_cfg=PCFG)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        rt.quantized("int4")
    with pytest.raises(ValueError, match="conflicts"):
        rt.quantized("fp8", qcfg=quant.QuantConfig(mode="int8"))
    with pytest.raises(NotImplementedError, match="fp8"):
        rt.quantized("fp8")
    # quantize-then-bank keeps the quantized state (and re-quantizing raises)
    banked = qrt.attach({"a": adapters}, PCFG)
    assert banked.is_quantized
    with pytest.raises(ValueError, match="already quantized"):
        banked.quantized("int8")


def test_bank_quant_compatibility_is_read_from_the_registry(world,
                                                            monkeypatch):
    import dataclasses
    _, rt = world
    adapters = convert.adapters_from_numpy(
        _np_tree(_tuned(JPCFG, world[0].params, 3)), device=CPU)
    assert [m for m in methods.registered()
            if methods.get(m).quant_compatible] == [
        "boft", "givens", "gsoft", "householder", "oft"]
    assert [m for m in methods.registered()
            if methods.get(m).quant_fuse is not None] == ["gsoft"]
    monkeypatch.setitem(methods._METHODS, "gsoft", dataclasses.replace(
        methods.get("gsoft"), quant_compatible=False))
    with pytest.raises(ValueError, match="not quantization-compatible"):
        rt.quantized("int8").attach({"a": adapters}, PCFG)
    with pytest.raises(ValueError, match="not quantization-compatible"):
        rt.attach({"a": adapters}, PCFG).quantized("int8")


@pytest.fixture(scope="module")
def gsoft_q(world):
    """JAX's banked int8 runtime and the port's, on identical codes."""
    jrt, rt = world
    jad = {"a": _tuned(JPCFG, jrt.params, 3), "b": _tuned(JPCFG, jrt.params, 7)}
    jqrt = jrt.attach(jad, JPCFG).quantized("int8")
    tparams = convert.quant_params_from_numpy(_jq_numpy(jqrt.params),
                                              device=CPU)
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    trt = ModelRuntime(CFG, tparams, device=CPU).attach(tad, PCFG)
    return jqrt, trt, jad, tad


def test_quantized_banked_decode_logits_match_jax(gsoft_q):
    jqrt, trt, _, _ = gsoft_q
    assert quant.is_quantized_tree(trt.params)
    toks = np.asarray([[5], [9], [7]])
    slots = [1, 2, 0]
    _, jlog, _ = jsteps.build_decode_step(JCFG)(
        jqrt.params, jqrt.bank.context(slots), jnp.asarray(toks),
        jqrt.init_decode_state(3, 16), jnp.zeros((3,), jnp.int32))
    tnt, tlog, _ = tsteps.build_decode_step(CFG)(
        trt.params, trt.bank.context(slots), torch.as_tensor(toks),
        trt.decode_state(3, 16), torch.zeros(3, dtype=torch.int64))
    _close(tlog.numpy(), np.asarray(jlog), LOGIT_REL, "decode logits")
    assert tnt[:, 0].tolist() == np.asarray(jlog)[:, -1].argmax(-1).tolist()


def test_quantized_banked_engine_tokens_equal_jax(gsoft_q):
    jqrt, trt, _, _ = gsoft_q

    def serve(eng):
        rids = {n: eng.add_request(PROMPT, max_new_tokens=5, adapter=n)
                for n in ("a", "b", None)}
        out = eng.run()
        return {n: out[r] for n, r in rids.items()}

    jtok = serve(JaxEngine(jqrt, max_batch=3, max_len=48, eos_id=-1))
    ttok = serve(ServeEngine(trt, max_batch=3, max_len=48, eos_id=-1))
    assert ttok == jtok
    assert len({tuple(v) for v in ttok.values()}) == 3
    # the base slot equals the bankless int8 model
    bare = ModelRuntime(CFG, trt.params, device=CPU)
    eng = ServeEngine(bare, max_batch=1, max_len=48, eos_id=-1)
    rid = eng.add_request(PROMPT, max_new_tokens=5)
    assert eng.run()[rid] == ttok[None]


def test_quant_rotation_hands_gsoft_factors_to_the_fused_kernel(gsoft_q):
    _, trt, _, _ = gsoft_q
    ctx = trt.bank.context([1, 2])
    layer0 = {k: {m: {n: v[0] for n, v in f.items()} for m, f in e.items()}
              for k, e in ctx.group("layers", "attn").items()}
    rot = ctx.rotator(layer0)
    x = torch.randn(2, 3, CFG.d_model,
                    generator=torch.Generator().manual_seed(0))
    xq, factors = rot.quant_rotation("wq", x, torch.float32)
    # the hand-off is the layer's bank entry (every slot, fp32) and the
    # batch's slot ids, read by the fused kernel itself
    assert xq is x and factors is not None and len(factors) == 3
    L, R, ids = factors
    assert L is layer0["wq"]["gsoft"]["L"] and R is layer0["wq"]["gsoft"]["R"]
    assert L.dtype == torch.float32 and ids.tolist() == [1, 2]
    # with identity codes (127 I, scale 1/127) the fused kernel's product is
    # the rotation itself: the same x Q_i the plain hook applies
    eye = quant.quantize_tensor(torch.eye(CFG.d_model))
    got = tops.gs_q_matmul_bank(L, R, ids, x, eye.q, eye.scale)
    _close(got.numpy(), rot("wq", x).numpy(), 1e-5, "fused rotation")


@pytest.fixture(scope="module")
def mixed_q(world):
    jrt, rt = world
    jad = {n: _tuned(c, jrt.params, i * 7 + 3)
           for i, (n, c) in enumerate(JMIXED.items())}
    jqrt = jrt.attach(jad, JMIXED).quantized("int8")
    tparams = convert.quant_params_from_numpy(_jq_numpy(jqrt.params),
                                              device=CPU)
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    trt = ModelRuntime(CFG, tparams, device=CPU).attach(tad, TMIXED)
    return jqrt, trt


def test_mixed_bank_over_int8_matches_jax_banked_int8(mixed_q):
    """The mixed-method bank over int8 weights against JAX's BANKED int8
    runtime on identical codes (not against "merge, then quantize", whose
    codes differ by construction): equal greedy tokens and decode logits
    within tolerance; the bank's factors stay float."""
    jqrt, trt = mixed_q
    names = list(MIXED) + [None]

    def serve(eng):
        rids = {n: eng.add_request(PROMPT, max_new_tokens=5, adapter=n)
                for n in names}
        out = eng.run()
        return {n: out[r] for n, r in rids.items()}

    jtok = serve(JaxEngine(jqrt, max_batch=6, max_len=48, eos_id=-1))
    ttok = serve(ServeEngine(trt, max_batch=6, max_len=48, eos_id=-1))
    assert ttok == jtok
    slots = list(range(6))
    toks = np.full((6, 1), 5)
    _, jlog, _ = jsteps.build_decode_step(JCFG)(
        jqrt.params, jqrt.bank.context(slots), jnp.asarray(toks),
        jqrt.init_decode_state(6, 16), jnp.zeros((6,), jnp.int32))
    _, tlog, _ = tsteps.build_decode_step(CFG)(
        trt.params, trt.bank.context(slots), torch.as_tensor(toks),
        trt.decode_state(6, 16), torch.zeros(6, dtype=torch.int64))
    _close(tlog.numpy(), np.asarray(jlog), LOGIT_REL, "mixed int8 logits")
    for leaf in tpeft.flatten_paths(trt.bank.tree).values():
        assert leaf.is_floating_point()
