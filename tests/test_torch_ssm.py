"""The port's Mamba2 slice against the JAX package on the CPU: the SSD and
flash-attention plain versions and entry points against the Pallas kernels
in interpret mode and JAX's oracles, the Mamba2 block pieces, the ``ssm``
(mamba2-130m) and ``hybrid`` (zamba2-2.7b) models' trees, forward, prefill
and decode, ``ServeEngine`` greedy tokens, the state-space duality, the
refusals (adapter banks, the paged engine), the slot scatter and the serve
launcher, at the smoke configs in f32 with JAX's params carried across."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ssd import ssd_pallas  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.peft import PrefillRequest  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
ARCHS = ("mamba2-130m", "zamba2-2.7b")
# tests/test_kernels.py's SSD shapes: (T, H, P, N, chunk)
SSD_SHAPES = [(32, 2, 8, 8, 8), (64, 1, 16, 16, 16), (128, 4, 8, 16, 32),
              (16, 3, 4, 4, 16), (48, 2, 8, 8, 16)]
# tests/test_flash_attention.py's shapes: (H, Sq, Sk, D, blk)
FLASH_SHAPES = [(2, 64, 64, 16, 32), (1, 128, 128, 32, 64),
                (3, 100, 100, 16, 32), (2, 32, 32, 64, 32),
                (1, 256, 256, 16, 128)]
# f32 scan oracles: the same sequence of fp32 operations in both packages,
# sums in another order; the kernel path (chunk halving) against the plain
# version and bf16 as tests/test_kernels.py (f32 1e-4, bf16 5e-2)
SSD_REF_TOL = 1e-5
SSD_TOL = {np.float32: 1e-4, "bf16": 5e-2}
# flash as tests/test_flash_attention.py (f32 2e-5, bf16 2e-2)
FLASH_TOL = {np.float32: 2e-5, "bf16": 2e-2}
# Mamba block pieces and whole models in f32: relative to the largest
# magnitude of the JAX output (einsum / matmul sums in another order)
PIECE_REL = 1e-5
LOGIT_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    a = np.asarray(a, np.float32)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _close(got, want, rel):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _ssd_inputs(rng, t, h, p, n, lead=()):
    x = rng.normal(size=lead + (t, h, p))
    loga = -np.abs(rng.normal(size=lead + (t, h))) * 0.3
    B = rng.normal(size=lead + (t, h, n)) * 0.5
    C = rng.normal(size=lead + (t, h, n)) * 0.5
    return [a.astype(np.float32) for a in (x, loga, B, C)]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,h,p,n,chunk", SSD_SHAPES)
def test_ssd_oracles_match_jax(t, h, p, n, chunk):
    args = _ssd_inputs(np.random.default_rng(t + h), t, h, p, n)
    s0 = np.random.default_rng(1).normal(size=(h, n, p)).astype(np.float32)
    jy, jS = jref.ssd_ref(*map(jnp.asarray, args), jnp.asarray(s0),
                          return_state=True)
    ty, tS = tref.ssd_ref(*map(_t, args), initial_state=_t(s0),
                          return_state=True)
    _close(ty, jy, SSD_REF_TOL)
    _close(tS, jS, SSD_REF_TOL)
    _close(tref.ssd_chunked_ref(*map(_t, args), chunk=chunk),
           jref.ssd_chunked_ref(*map(jnp.asarray, args), chunk=chunk),
           SSD_REF_TOL)


@pytest.mark.parametrize("t,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("batched", [False, True], ids=["3d", "4d"])
def test_ops_ssd_matches_jax_kernel_and_plain_path(t, h, p, n, chunk, dtype,
                                                   batched):
    lead = (2,) if batched else ()
    args = _ssd_inputs(np.random.default_rng(t * 3 + n), t, h, p, n, lead)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jargs = [jnp.asarray(a, jdt) for a in args]
    targs = [_t(a, tdt) for a in args]
    got = tops.ssd(*targs, chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == args[0].shape
    if batched:
        kern = jax.vmap(lambda *a: ssd_pallas(*a, chunk=chunk,
                                              interpret=True))(*jargs)
    else:
        kern = ssd_pallas(*jargs, chunk=chunk, interpret=True)
    plain = jops.ssd(*jargs, chunk=chunk, use_pallas=False)
    _close(got, np.asarray(kern, np.float32), SSD_TOL[dtype])
    _close(got, np.asarray(plain, np.float32), SSD_TOL[dtype])


def test_ops_ssd_takes_the_plain_chunk_for_a_ragged_t():
    """T = 40 at chunk 16: the plain path's chunk is 10 (largest divisor),
    the JAX kernel path's 8 (halving); all agree up to rounding."""
    args = _ssd_inputs(np.random.default_rng(9), 40, 2, 8, 8, (3,))
    got = tops.ssd(*map(_t, args), chunk=16)
    _close(got, jops.ssd(*map(jnp.asarray, args), chunk=16, use_pallas=True),
           SSD_TOL[np.float32])
    want = tref.ssd_chunked_ref(*map(_t, args), chunk=10)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(rng, h, sq, sk, d, lead=()):
    return [rng.normal(size=lead + s).astype(np.float32)
            for s in ((h, sq, d), (h, sk, d), (h, sk, d))]


@pytest.mark.parametrize("h,sq,sk,d,blk", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_flash_matches_jax_kernel(h, sq, sk, d, blk, dtype):
    q, k, v = _qkv(np.random.default_rng(h * sq + d), h, sq, sk, d)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True,
                  blk_q=blk, blk_k=blk, interpret=True)
    got = tfa.flash_attention(*(_t(a, tdt) for a in (q, k, v)), causal=True,
                              blk_q=blk, blk_k=blk)
    assert got.dtype == tdt
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    _close(tref.flash_ref(*map(_t, (q, k, v))),
           jref.flash_ref(*map(jnp.asarray, (q, k, v))), 1e-6)


def test_flash_noncausal_matches_jax_and_ragged_raises():
    q, k, v = _qkv(np.random.default_rng(2), 2, 64, 128, 16)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=False, blk_q=32,
                  blk_k=64, interpret=True)
    got = tfa.flash_attention(*map(_t, (q, k, v)), causal=False, blk_q=32,
                              blk_k=64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    q, k, v = _qkv(np.random.default_rng(3), 2, 64, 100, 16)
    with pytest.raises(ValueError, match="Sk % blk_k"):
        jflash(*map(jnp.asarray, (q, k, v)), causal=False, blk_q=32,
               blk_k=64, interpret=True)
    with pytest.raises(ValueError, match="Sk % blk_k"):
        tfa.flash_attention(*map(_t, (q, k, v)), causal=False, blk_q=32,
                            blk_k=64)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_gqa_matches_jax(causal):
    rng = np.random.default_rng(4)
    b, s, h, kh, d = 2, 64, 8, 2, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    got = tops.flash_mha(*map(_t, (q, k, v)), causal=causal, blk=32)
    for use_pallas in (False, True):
        want = jops.flash_mha(*map(jnp.asarray, (q, k, v)), causal=causal,
                              use_pallas=use_pallas, blk=32)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="Sk % blk_k"):
        tops.flash_mha(*map(_t, (q, k[:, :40], v[:, :40])), causal=False,
                       blk=32)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg, (), jnp.float32)
    return jcfg, cfg, jp, convert.params_from_numpy(_np_tree(jp), device=CPU)


def test_conv_and_gated_norm_match_jax(block):
    jcfg, cfg, jp, tp = block
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, tssm._conv_dim(cfg))).astype(np.float32)
    _close(tssm._causal_conv(_t(x), tp["conv_w"], tp["conv_b"] + 0.1),
           jssm._causal_conv(jnp.asarray(x), jp["conv_w"],
                             jp["conv_b"] + 0.1), PIECE_REL)
    y = rng.normal(size=(2, 11, cfg.d_inner)).astype(np.float32)
    z = rng.normal(size=(2, 11, cfg.d_inner)).astype(np.float32)
    sc = rng.normal(size=(cfg.d_inner,)).astype(np.float32) * 0.1
    _close(tssm._gated_rms_norm(_t(y), _t(z), _t(sc), cfg.norm_eps),
           jssm._gated_rms_norm(jnp.asarray(y), jnp.asarray(z),
                                jnp.asarray(sc), jcfg.norm_eps), PIECE_REL)


def test_mamba_block_and_decode_step_match_jax(block):
    jcfg, cfg, jp, tp = block
    rng = np.random.default_rng(6)
    u = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    _close(tssm.mamba_block(tp, _t(u), cfg),
           jssm.mamba_block(jp, jnp.asarray(u), jcfg), PIECE_REL)
    jst = jssm.init_mamba_state(jcfg, 2)
    tst = tssm.init_mamba_state(cfg, 2, device=CPU)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tst.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jst.items()}
    for t in range(3):
        ut = u[:, t:t + 1]
        jy, jst = jssm.mamba_decode_step(jp, jnp.asarray(ut), jst, jcfg)
        ty, tst = tssm.mamba_decode_step(tp, _t(ut), tst, cfg)
        _close(ty, jy, PIECE_REL)
        _close(tst["conv"], jst["conv"], PIECE_REL)
        _close(tst["ssm"], jst["ssm"], PIECE_REL)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jrt = JaxRuntime(jcfg, key=jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    return jcfg, cfg, jrt, ModelRuntime(cfg, tparams, device=CPU)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _shapes(tree):
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_init_lm_tree_matches_jax(arch, param_dtype):
    """Keys, shapes and dtypes (the fp32 leaves A_log, D, dt_bias stay fp32
    in a bf16 tree); convert carries the JAX tree over unchanged."""
    jcfg = jax_smoke_config(arch).with_overrides(param_dtype=param_dtype)
    cfg = get_smoke_config(arch).with_overrides(param_dtype=param_dtype)
    jtree = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                           jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), str(a.dtype))
            for p, a in _flat(jtree).items()}
    got = _shapes(ttf.init_lm(cfg, seed=0, device=CPU))
    assert got == want
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jtree)
    carried = _shapes(convert.params_from_numpy(zeros, device=CPU))
    assert carried == want
    if cfg.attn_every:
        per = cfg.attn_every
        assert got["/blocks/mamba/wz"][0][:2] == (cfg.num_layers // per, per)
    lead = "/blocks" if cfg.attn_every else "/layers"
    for name in ("A_log", "D", "dt_bias"):
        assert got[f"{lead}/mamba/{name}"][1] == "float32"


def test_forward_prefill_and_decode_match_jax(model):
    jcfg, cfg, jrt, rt = model
    fam, jfam = tapi.family_ops(cfg), japi.family_ops(jcfg)
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 12))
    jl, _ = japi.forward(jcfg, jrt.params, {"tokens": jnp.asarray(toks)})
    tl, _ = tapi.forward(cfg, rt.params, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl, LOGIT_REL)

    from repro.core.peft import PrefillRequest as JReq
    last = np.array([11, 6])
    jstate = jfam.init_decode_state(jcfg, 2, 20)
    jlog, jstate2 = jfam.prefill(jcfg, jrt.params,
                                 JReq(batch={"tokens": jnp.asarray(toks)},
                                      last_idx=jnp.asarray(last)), jstate)
    tstate = fam.init_decode_state(cfg, 2, 20, CPU)
    tlog, tstate2 = fam.prefill(cfg, rt.params,
                                PrefillRequest(batch={"tokens": torch.as_tensor(
                                    toks)}, last_idx=torch.as_tensor(last)),
                                tstate)
    _close(tlog, jlog, LOGIT_REL)
    # the reference's prefill hands the decode state back unchanged
    assert tstate2 is tstate
    assert all(not leaf.any() for leaf in _flat(tstate2).values())
    assert all(not np.asarray(leaf).any() for leaf in _flat(jstate2).values())

    for step in range(4):
        tok = toks[:, step:step + 1]
        pos = np.array([step, step + 3])
        jlog, jstate2 = jfam.decode_step(jcfg, jrt.params, jnp.asarray(tok),
                                         jstate2, jnp.asarray(pos, jnp.int32))
        tlog, tstate2 = fam.decode_step(cfg, rt.params, torch.as_tensor(tok),
                                        tstate2, torch.as_tensor(pos))
        _close(tlog, jlog, LOGIT_REL)
    jflat, tflat = _flat(jstate2), _flat(tstate2)
    assert set(jflat) == set(tflat)
    for k in jflat:
        _close(tflat[k], jflat[k], LOGIT_REL)


def test_serve_engine_tokens_equal_jax(model):
    """Greedy tokens over ragged prompts on 3 slots, exactly."""
    jcfg, cfg, jrt, rt = model
    rng = np.random.default_rng(8)
    work = [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for n, m in ((5, 4), (19, 6), (3, 8), (26, 3), (11, 5))]
    out = []
    for eng in (JaxEngine(jrt, max_batch=3, max_len=48, eos_id=-1),
                ServeEngine(rt, max_batch=3, max_len=48, eos_id=-1)):
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
        res = eng.run()
        out.append([res[r] for r in rids])
    assert out[0] == out[1]
    assert [len(t) for t in out[1]] == [m for _, m in work]


def test_state_space_duality_inside_the_port(model):
    """Token-by-token decode from the empty state reproduces the parallel
    forward (the SSD scan against the recurrence)."""
    _, cfg, _, rt = model
    fam = tapi.family_ops(cfg)
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        1, cfg.vocab_size, (2, 40)))
    full, _ = tapi.forward(cfg, rt.params, {"tokens": toks})
    state = fam.init_decode_state(cfg, 2, 41, CPU)
    steps = []
    for t in range(toks.shape[1]):
        lg, state = fam.decode_step(cfg, rt.params, toks[:, t:t + 1], state,
                                    torch.as_tensor(t))
        steps.append(lg[:, 0])
    _close(torch.stack(steps, 1), full.numpy(), LOGIT_REL)


def test_first_served_token_is_forward_argmax(model):
    _, cfg, _, rt = model
    prompt = np.random.default_rng(11).integers(1, cfg.vocab_size, 13)
    eng = ServeEngine(rt, max_batch=2, max_len=32, eos_id=-1)
    rid = eng.add_request(prompt.tolist(), max_new_tokens=2)
    first = eng.run()[rid][0]
    full, _ = tapi.forward(cfg, rt.params,
                           {"tokens": torch.as_tensor(prompt[None])})
    assert first == int(torch.argmax(full[0, -1]))


def test_banks_and_the_paged_engine_are_refused(model):
    """As in the JAX package: a bank over mamba2 builds and its first use
    raises; over zamba2 the stacked (nsuper, per) weights refuse the bank
    when it is built."""
    jcfg, cfg, jrt, rt = model
    pcfg = tpeft.PEFTConfig(method="gsoft", block_size=8)
    adapters = tlaunch.make_demo_adapters(["a"], rt.params, pcfg, rt.device)
    if cfg.attn_every:
        with pytest.raises(ValueError, match="adapter bank cannot serve "
                           "blocks/mamba"):
            rt.attach(adapters, pcfg)
    else:
        eng = ServeEngine(rt.attach(adapters, pcfg), max_batch=2, max_len=32,
                          eos_id=-1)
        eng.add_request([1, 2, 3], max_new_tokens=2, adapter="a")
        with pytest.raises(ValueError, match="adapter bank serving not "
                           f"supported for family {cfg.family}"):
            eng.run()
    with pytest.raises(ValueError, match="no paged KV serve path"):
        PagedServeEngine(rt, max_batch=2, max_len=32)


def test_slot_prefill_resets_only_its_own_row(model):
    """The admission scatter writes row ``slot`` along each leaf's own
    batch axis (hybrid Mamba leaves carry it on axis 2) and nothing else."""
    _, cfg, _, rt = model
    step = tsteps.build_slot_prefill_step(cfg, max_len=24, device=CPU)
    state = rt.decode_state(3, 24)
    for leaf in _flat(state).values():
        leaf.fill_(7.0)
    req = PrefillRequest(batch={"tokens": torch.as_tensor([[3, 4, 5, 0]])},
                         last_idx=torch.as_tensor(2))
    step(rt.params, req, state, 1)
    axes = tsteps._decode_state_batch_axes(cfg, 24)
    for key, leaf in _flat(state).items():
        ax = _flat(axes)[key]
        assert not leaf.select(ax, 1).any(), key
        assert (leaf.select(ax, 0) == 7).all() and (
            leaf.select(ax, 2) == 7).all(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_and_refuses_like_jax(arch, capsys):
    assert tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "3",
                         "--family", get_smoke_config(arch).family]) == 0
    assert "[continuous] served 3 requests, 9 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="registers family"):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--family", "decoder"])
    with pytest.raises(ValueError, match="no paged KV serve path"):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "paged"])
    with pytest.raises(ValueError, match="adapter bank"):
        tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--demo-adapters", "2", "--requests", "2"])
