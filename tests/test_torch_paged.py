"""The port's paged-KV serving slice against the JAX package on the CPU:
``KVPagePool`` on a scripted admit / register / finish sequence, the plain
version of the paged decode kernel against ``paged_flash_decode`` in
interpret mode, and ``PagedServeEngine`` (chunked prefill, EOS refill under
a tight pool, shared prefixes, a GSOFT bank, int8 weights) against JAX's
``PagedServeEngine`` and the port's own contiguous ``ServeEngine``, at the
qwen2-72b smoke config in f32, plus the serve launcher."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.kernels.flash_attention import paged_flash_decode  # noqa: E402
from repro.serve import kv as jkv  # noqa: E402
from repro.serve.engine import PagedServeEngine as JaxPaged  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve import kv as tkv  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
JCFG = jax_smoke_config("qwen2-72b")
CFG = get_smoke_config("qwen2-72b")
JPCFG = jpeft.PEFTConfig(method="gsoft", block_size=8)
PCFG = tpeft.PEFTConfig(method="gsoft", block_size=8)
# paged decode in f32: tests/test_kv.py holds the Pallas kernel to its
# oracle at this tolerance
PAGED_TOL = 2e-5
LOGIT_REL = 1e-4
# tests/test_kv.py's ragged traffic: several prompts need several chunks
RAGGED = ((5, 4), (19, 6), (3, 8), (26, 3), (11, 5), (7, 7))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tuned(params, seed, scale=0.3):
    ad = jpeft.init_peft(JPCFG, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


def _paged(rt, cls=PagedServeEngine, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 48)
    kw.setdefault("eos_id", -1)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return cls(rt, **kw)


def _serve(eng, work):
    rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
            for p, m, a in work]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def world():
    jrt = JaxRuntime(JCFG, key=jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_np_tree(jrt.params), device=CPU)
    return jrt, ModelRuntime(CFG, tparams, device=CPU)


def _solo(rt, prompt, max_new, eos_id=-1):
    eng = ServeEngine(rt, max_batch=1, max_len=48, eos_id=eos_id)
    rid = eng.add_request(list(prompt), max_new_tokens=max_new)
    return eng.run()[rid]


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------

def _pool_script(mod):
    """One admit / register / finish sequence (prefix sharing across two
    tenants, a partial page, a stall, cache eviction); returns everything
    observable after each step."""
    pool = mod.KVPagePool(num_pages=9, page_size=8)
    log = []

    def snap(sp, what):
        log.append((what, None if sp is None else
                    (list(sp.pages), sp.n_cached, sp.n_prompt_full,
                     pool.table_row(sp, 9).tolist()),
                    pool._refs.tolist(), pool.available, pool.stats()))

    sys_prompt = list(range(100, 116))
    a = pool.admit("t", sys_prompt + [1, 2, 3], max_new=4)
    snap(a, "a")
    pool.register(a)
    b = pool.admit("t", sys_prompt + [7, 8, 9], max_new=4)
    snap(b, "b shares two pages")
    c = pool.admit("u", sys_prompt + [7], max_new=4)
    snap(c, "c: another adapter, no sharing")
    d = pool.admit(None, list(range(30)), max_new=10)
    snap(d, "d stalls")
    pool.finish(a)
    snap(None, "a finished")
    pool.finish(b)
    pool.finish(c)
    snap(None, "b, c finished")
    e = pool.admit(None, list(range(200, 240)), max_new=16)
    snap(e, "e evicts the cached prefix")
    return log


def test_pool_script_matches_jax():
    assert _pool_script(tkv) == _pool_script(jkv)


def test_pool_basics_and_budget_match_jax():
    pool = tkv.KVPagePool(num_pages=9, page_size=8)
    assert pool.available == 8 and tkv.GARBAGE_PAGE == jkv.GARBAGE_PAGE == 0
    sp = pool.admit(None, list(range(10)), max_new=6)
    assert len(sp.pages) == 2 and tkv.GARBAGE_PAGE not in sp.pages
    row = pool.table_row(sp, 5)
    assert row.dtype == np.int32 and list(row[2:]) == [0, 0, 0]
    pool.finish(sp)
    assert pool.available == 8
    with pytest.raises(ValueError):
        tkv.KVPagePool(num_pages=1, page_size=8)
    for ps in (8, 16):
        assert tkv.kv_page_bytes(CFG, ps) == jkv.kv_page_bytes(JCFG, ps)
        assert (tkv.pages_for_budget(CFG, ps, 49152)
                == jkv.pages_for_budget(JCFG, ps, 49152))
    merged = tkv.merge_pool_stats([pool.stats(), pool.stats()])
    assert merged["num_pages"] == 18 and merged["page_size"] == 8
    with pytest.raises(ValueError, match="page sizes"):
        tkv.merge_pool_stats([pool.stats(),
                              tkv.KVPagePool(3, 16).stats()])


# ---------------------------------------------------------------------------
# the paged decode kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [8, 16])
def test_paged_attention_matches_jax_pallas(page):
    b, h, kh, d, npages, w = 4, 4, 2, 16, 11, 5
    rng = np.random.default_rng(page)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(npages, page, kh, d)).astype(np.float32)
    vp = rng.normal(size=(npages, page, kh, d)).astype(np.float32)
    table = rng.integers(0, npages, size=(b, w)).astype(np.int32)
    # the last row is parked: kv_len past the table's W * page
    kv_len = np.asarray([1, page + 1, 3 * page, w * page + 1], np.int32)
    want = paged_flash_decode(*(jnp.asarray(a) for a in
                                (q, kp, vp, table, kv_len)), interpret=True)
    got = tops.paged_attention(*(torch.from_numpy(a) for a in
                                 (q, kp, vp, table, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PAGED_TOL, rtol=PAGED_TOL)


def test_paged_attention_checks_its_inputs():
    q = torch.zeros((2, 4, 16))
    kp = torch.zeros((3, 8, 2, 16))
    with pytest.raises(ValueError, match="table"):
        tpa.paged_decode(q, kp, kp, torch.zeros((3, 2), dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple"):
        tpa.paged_decode(torch.zeros((2, 3, 16)), kp, kp,
                         torch.zeros((2, 2), dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="inference only"):
        tpa.paged_decode(q.requires_grad_(True), kp, kp,
                         torch.zeros((2, 2), dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# paged engine == JAX paged engine == contiguous engine
# ---------------------------------------------------------------------------

def _ragged():
    rng = np.random.default_rng(3)
    return [(rng.integers(1, 200, size=n).tolist(), m, None)
            for n, m in RAGGED]


def test_paged_decode_and_chunk_logits_match_jax(world):
    jrt, rt = world
    jstate = jrt.paged_state(2, 9, 8, 4)
    tstate = rt.paged_state(2, 9, 8, 4)
    table = np.zeros((2, 5), np.int32)
    table[0, :2], table[1, :3] = [3, 5], [1, 2, 7]
    jstate["table"] = jnp.asarray(table)
    tstate["table"] = torch.as_tensor(table)
    toks = np.arange(1, 13)[None]
    jreq = jpeft.PrefillRequest(batch={"tokens": jnp.asarray(toks)},
                                last_idx=jnp.asarray(10, jnp.int32))
    treq = tpeft.PrefillRequest(batch={"tokens": torch.as_tensor(toks)},
                                last_idx=torch.as_tensor(10))
    jfirst, jstate = jsteps.build_chunk_prefill_step(JCFG)(
        jrt.params, jreq, jstate, jnp.asarray(1, jnp.int32),
        jnp.asarray(4, jnp.int32))
    tfirst, tstate = tsteps.build_chunk_prefill_step(CFG)(
        rt.params, treq, tstate, 1, 4)
    assert int(tfirst) == int(jfirst)
    pos = np.asarray([32, 17])                    # row 0 parked
    _, jlog, jstate = jsteps.build_paged_decode_step(JCFG)(
        jrt.params, None, jnp.asarray([[4], [9]]), jstate,
        jnp.asarray(pos, jnp.int32))
    _, tlog, tstate = tsteps.build_paged_decode_step(CFG)(
        rt.params, None, torch.as_tensor([[4], [9]]), tstate,
        torch.as_tensor(pos))
    got, want = tlog.numpy()[1], np.asarray(jlog)[1]
    assert np.abs(got - want).max() <= LOGIT_REL * max(1, np.abs(want).max())
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate["pages"][key].numpy()[:, 1:],
                                   np.asarray(jstate["pages"][key])[:, 1:],
                                   atol=1e-5)


def test_paged_matches_jax_and_contiguous_on_ragged_traffic(world):
    jrt, rt = world
    work = _ragged()
    ref = _serve(ServeEngine(rt, max_batch=3, max_len=48, eos_id=-1), work)
    got = _serve(_paged(rt), work)
    assert got == ref
    assert _serve(_paged(jrt, JaxPaged), work) == got


def test_multi_chunk_prompt_matches_solo(world):
    _, rt = world
    prompt = list(range(1, 20))                   # 19 tokens, chunk 8 -> 3
    eng = _paged(rt, max_batch=1)
    rid = eng.add_request(prompt, max_new_tokens=6)
    assert eng.run()[rid] == _solo(rt, prompt, 6)
    assert eng.stats["prefills"] == 1


def test_eos_refill_reuses_freed_pages(world):
    jrt, rt = world
    probe = _solo(rt, [5, 6, 7], 8)
    eos = next(t for t in probe if t != probe[0])
    prompts = [[5, 6, 7], [9, 10, 11, 12], [3, 4], [8, 2, 6, 1], [13, 14]]
    solo = [_solo(rt, p, 8, eos_id=eos) for p in prompts]
    work = [(p, 8, None) for p in prompts]
    eng = _paged(rt, max_batch=2, num_pages=7, eos_id=eos)
    assert _serve(eng, work) == solo
    assert any(len(out) < 8 for out in solo)        # EOS actually fired
    st = eng.kv_stats()
    assert st["alloc"] > 6 and eng.pool.available == 6
    jeng = _paged(jrt, JaxPaged, max_batch=2, num_pages=7, eos_id=eos)
    assert _serve(jeng, work) == solo
    assert jeng.kv_stats()["alloc"] == st["alloc"]


def test_shared_prefix_hits_and_matches_jax(world):
    jrt, rt = world
    sys_prompt = list(range(40, 56))                # 2 full pages at ps=8
    p1, p2 = sys_prompt + [1, 2, 3], sys_prompt + [7, 8]
    outs = {}
    for name, r, cls in (("port", rt, PagedServeEngine),
                         ("jax", jrt, JaxPaged)):
        eng = _paged(r, cls, max_batch=1)
        o1 = _serve(eng, [(p1, 5, None)])
        o2 = _serve(eng, [(p2, 5, None)])
        outs[name] = (o1, o2, eng.kv_stats()["prefix_hits"])
    assert outs["port"] == outs["jax"]
    assert outs["port"][2] >= 2
    assert outs["port"][0] == [_solo(rt, p1, 5)]
    assert outs["port"][1] == [_solo(rt, p2, 5)]


@pytest.mark.parametrize("quantized", [False, True])
def test_banked_paged_engine_matches_jax(world, quantized):
    """A GSOFT bank over f32 or int8 weights, with 16-token pages: paged
    tokens equal JAX's paged engine and the port's contiguous engine."""
    jrt, rt = world
    jad = {"a": _tuned(jrt.params, 3), "b": _tuned(jrt.params, 7)}
    tad = convert.adapters_from_numpy(_np_tree(jad), device=CPU)
    jb, tb = jrt.attach(jad, JPCFG), rt.attach(tad, PCFG)
    if quantized:
        jb, tb = jb.quantized("int8"), tb.quantized("int8")
    names = ["a", "b", None]
    work = [(p, m, names[i % 3]) for i, (p, m, _) in enumerate(_ragged())]
    got = _serve(_paged(tb, page_size=16, prefill_chunk=16), work)
    assert got == _serve(ServeEngine(tb, max_batch=3, max_len=48, eos_id=-1),
                         work)
    assert got == _serve(_paged(jb, JaxPaged, page_size=16, prefill_chunk=16),
                         work)


def test_paged_engine_refuses_bad_geometry(world):
    _, rt = world
    with pytest.raises(ValueError, match=">= 1"):
        _paged(rt, page_size=0)
    eng = _paged(rt, hbm_kv_budget=3 * tkv.kv_page_bytes(CFG, 8))
    assert eng.num_pages == 3


def test_launcher_serves_paged_int8_bank_on_the_cpu(capsys):
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--engine",
                         "paged", "--quantize", "int8", "--demo-adapters",
                         "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quantized base weights (int8)" in out
    assert "[paged] served 8 requests" in out and "tok/s" in out
    assert "kv: pool=" in out and "cluster: 1 replica(s)" in out


@pytest.mark.parametrize("flags", [["--mesh", "2,1"],
                                   ["--quantize", "fp8"],
                                   ["--arch", "pixtral-12b", "--tp", "2"],
                                   ["--arch", "lipconvnet-15", "--tp", "2"],
                                   ["--mesh", "2,2"],
                                   ["--arch", "seamless-m4t-medium", "--tp",
                                    "2"]])
def test_launcher_refuses_unported_lanes(flags):
    """Unported lanes raise NotImplementedError (the vlm and encdec
    families serve since they were ported, but not on a mesh); a 'data'
    axis above 1 is served now, so in one process its mesh is refused for
    the world's size (ValueError naming both)."""
    exc, match = ((ValueError, "needs [0-9]+ ranks") if "--mesh" in flags
                  else (NotImplementedError, None))
    with pytest.raises(exc, match=match):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu"]
                     + flags)
