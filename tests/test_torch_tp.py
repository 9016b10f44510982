"""Tensor-parallel serving of the port (``distrib/tp.py``, ``sharding/
specs.py``, ``ModelRuntime(mesh=)``, the split model code) on the CPU at
tp = 2: gloo ranks in their own processes (``tests/torch_tp_runner.py``),
each holding its shards, against JAX's SINGLE-DEVICE engines on the same
params, codes and adapters — as tests/serve_distributed_runner.py holds
JAX's own TP. tests/test_torch_tp4.py runs tp = 4.

One spawn of two ranks serves a mixed-method eager bank, the same tenants
store-paged, int8 banked with JAX's codes (contiguous and paged), int8
quantized on the mesh, int8 restored from checkpoints leaf by leaf, an
offline merge placed weight by weight, and streaming arrivals; then
qwen3-moe with its experts split over the ranks (an attention bank through
the contiguous and paged engines, one decode step's logits, a merge of
every projection, the launcher's ``--tp 2``). Greedy tokens are compared
exactly (f32 on both sides). Each rank's params, bank stacks and KV are
checked to be its local slice, so a silently replicated weight fails. The
launcher's refusals run in this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

from repro_torch.launch import serve as tlaunch  # noqa: E402

import torch_tp_refs as R  # noqa: E402
import torch_tp_runner as runner  # noqa: E402

CFG = R.CFG


@pytest.fixture(scope="module")
def refs():
    """JAX's single-device tokens and the payloads for the ranks. The
    store-paged bank serves the eager bank's tenants and first requests,
    and the paged engine the contiguous int8 one's: paging moves where
    factors and KV live, not what is computed, so each is held to the
    same JAX run."""
    jrt = R.jax_runtime()
    params = R.np_tree(jrt.params)
    mixed, gb = R.adapters(params, R.MIXED), R.adapters(params, R.GB)
    jqrt = jrt.quantized("int8")
    bank = R.jax_tokens(jrt.attach(mixed, R.jcfgs(R.MIXED)), R.MIXED, 8, 1)
    int8 = R.jax_tokens(jqrt.attach(gb, R.jcfgs(R.GB)), R.GB, 6, 3)
    want = {"bank": bank, "store": bank[:6], "int8": int8, "paged": int8,
            "ckpt": int8}
    qparams = R.jq_numpy(jqrt.params)
    payload = {
        "bank": dict(params=params, methods=R.MIXED, adapters=mixed, n=8,
                     seed=1, stream=True),
        "store": dict(params=params, methods=R.MIXED, adapters=mixed, n=6,
                      seed=1, budget=5),
        "int8": dict(qparams=qparams, methods=R.GB, adapters=gb, n=6,
                     seed=3),
        "paged": dict(qparams=qparams, methods=R.GB, adapters=gb, n=6,
                      seed=3, paged=True),
        "quantize": dict(params=params, methods={}, n=0, seed=5,
                         quantize=True),
        "ckpt": dict(qparams=qparams, params=params, methods=R.GB,
                     adapters=gb, n=6, seed=3, ckpt=True),
        "merge": dict(params=params, n=4, seed=2, merge=True),
    }
    moe_want, moe_payload = _moe_refs()
    want.update(moe_want)
    payload.update(moe_payload)
    return want, payload


MOE = "qwen3-moe-30b-a3b"
ATTN = (r".*/attn/(wq|wk|wv|wo)$",)   # a bank refuses the expert stacks
MOE_BANK = {"e0": "gsoft", "e1": "gsoft", "e2": "gsoft"}


def _moe_refs():
    """qwen3-moe (smoke: 8 experts, 4 a rank at tp = 2): JAX's one-device
    tokens from a 3-tenant GSOFT bank on the attention projections, and
    JAX's ``build_decode_step`` logits of one step of 8 rows."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_smoke_config as jax_smoke_config
    from repro.core import peft as jpeft
    from repro.core.runtime import ModelRuntime as JaxRuntime
    from repro.models import api as japi
    from repro.train.steps import build_decode_step as jax_decode_step
    from repro_torch import convert
    from repro_torch.core import peft as tpeft
    jcfg = jax_smoke_config(MOE)
    jrt = JaxRuntime(jcfg, key=jax.random.PRNGKey(0))
    params = R.np_tree(jrt.params)
    tcfgs = {n: tpeft.PEFTConfig(method=m, block_size=8, target_patterns=ATTN)
             for n, m in MOE_BANK.items()}
    ads = tlaunch.make_demo_adapters(
        list(MOE_BANK), convert.params_from_numpy(params, "cpu"), tcfgs,
        torch.device("cpu"), scale=0.3)
    ads = {n: {p: {k: v.numpy() for k, v in e.items()} for p, e in t.items()}
           for n, t in ads.items()}
    jcfgs = {n: jpeft.PEFTConfig(method=m, block_size=8, target_patterns=ATTN)
             for n, m in MOE_BANK.items()}
    toks = R.jax_tokens(jrt.attach(ads, jcfgs), MOE_BANK, 6, 4)
    _, logits, _ = jax_decode_step(jcfg)(
        jrt.params, None, jnp.arange(1, 9, dtype=jnp.int32)[:, None],
        japi.init_decode_state(jcfg, 8, 16), jnp.asarray(0, jnp.int32))
    case = dict(arch=MOE, params=params, methods=MOE_BANK, adapters=ads,
                targets=ATTN, n=6, seed=4)
    return ({"moe": toks, "moe_paged": toks,
             "moe_probe": np.asarray(logits, np.float32)},
            {"moe": dict(case, probe=True),
             "moe_paged": dict(case, paged=True),
             "moe_merge": dict(arch=MOE, params=params, n=4, seed=2,
                               merge=True),
             "moe_launch": dict(argv=["--arch", MOE, "--smoke", "--tp", "2",
                                      "--engine", "paged", "--device",
                                      "cpu"])})


@pytest.fixture(scope="module")
def tp2(refs):
    return runner.spawn(2, refs[1])


@pytest.mark.parametrize("case", ["bank", "store", "int8", "paged", "ckpt"])
def test_tp2_tokens_equal_jax_single_device(refs, tp2, case):
    """Both ranks serve the same greedy tokens as JAX's one-device engine:
    mixed-method eager bank (gsoft / boft / oft / householder / givens),
    the same tenants store-paged under a 5-slot budget, int8 banked on
    JAX's codes, contiguous and paged, and those codes restored from a
    checkpoint by ``load_quantized(mesh=)``."""
    want = refs[0][case]
    assert [r[case]["tokens"] for r in tp2] == [want, want]


def test_params_bank_and_kv_are_local(tp2):
    """Every split weight, the GSOFT bank's block axis and the KV heads hold
    the rank's share: wq / wk / MLP wi columns, attention / MLP wo rows,
    embedding rows and LM-head columns over 2; the caches and page pools
    K / 2 heads; the GSOFT stacks r / 2 blocks (eager and store-paged)."""
    H, K, hd = CFG.num_heads, CFG.num_kv_heads, CFG.d_head
    d, f, vp = CFG.d_model, CFG.d_ff, CFG.padded_vocab()
    for case in ("bank", "int8", "paged"):
        loc = tp2[1][case]["local"]
        assert loc["wq"][-2:] == (d, H * hd // 2)
        assert loc["wk"][-2:] == (d, K * hd // 2)
        assert loc["wo"][-2:] == (H * hd // 2, d)
        assert loc["mlp_wi"][-2:] == (d, f // 2)
        assert loc["mlp_wo"][-2:] == (f // 2, d)
        assert loc["embed"] == (vp // 2, d)
        assert loc["lm_head"] == (d, vp // 2)
        assert loc["kv"][-2] == K // 2
    for case in ("bank", "store"):
        bank = tp2[0][case]["bank"]
        assert bank["attn_wq"][-3] * 8 * 2 == d
        assert bank["mlp_wo"][-3] * 8 * 2 == f


def test_streaming_arrivals_give_equal_tokens_on_both_ranks(tp2):
    """Each rank's arrival clock runs at its own rate; rank 0 decides each
    tick's admissions and broadcasts them, so both ranks admit the same
    requests and stream the same tokens, every request served."""
    a, b = tp2[0]["bank"]["stream"], tp2[1]["bank"]["stream"]
    assert a == b and len(a) == 8 and all(len(t) == 6 for t in a)


def test_int8_quantized_on_the_mesh_equals_the_whole(tp2):
    """``quantized()`` on placed f32 shards: the row-split weights' scales
    take the max |w| over both ranks, so each rank's codes and scales are
    exactly its slice of the whole tree's."""
    assert all(r["quantize"]["codes_equal"] for r in tp2)


@pytest.mark.parametrize("flags, exc, match", [
    (["--tp", "2", "--mesh", "1,2"], SystemExit, "one or the other"),
    (["--mesh", "2,1"], ValueError, "needs 2 ranks"),
    (["--tp", "2"], ValueError, "needs 2 ranks"),
])
def test_launcher_refuses_bad_meshes(flags, exc, match):
    """``--tp`` with ``--mesh`` is refused, and a mesh larger than the
    world (a 'data' axis included) names both sizes."""
    with pytest.raises(exc, match=match):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu"]
                     + flags)


def test_launcher_serves_tp1_as_the_degenerate_mesh(capsys):
    """``--tp 1`` in one process: a world of one, the same report."""
    assert tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--tp", "1",
                         "--engine", "paged", "--quantize", "int8",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cluster: 1 replica(s), 8 requests" in out and "kv: pool=" in out


def test_load_quantized_on_the_mesh_keeps_each_leafs_slice(tp2):
    """``load_quantized(mesh=)`` reads each leaf and keeps its slice: from
    a quantized checkpoint the codes and scales are exactly the rank's
    slice of the whole tree's, and from a float checkpoint, quantized on
    the mesh, exactly the slice of the whole's quantization."""
    H, hd = CFG.num_heads, CFG.d_head
    for r in tp2:
        assert r["ckpt"]["codes_equal"] and r["ckpt"]["float_codes_equal"]
        assert r["ckpt"]["wq"][-1] == H * hd // 2


def test_offline_merge_on_the_mesh_equals_the_whole_merge(tp2):
    """A GSOFT adapter merged under the mesh, each weight merged and cut
    before the next (drawn from the seed, and from a passed tree), serves
    the unsplit merge's greedy tokens exactly, on split weights."""
    for r in tp2:
        for how in ("seed", "tree"):
            whole, split = r["merge"][how]
            assert split == whole and len(whole) == 4
        assert r["merge"]["wq"][-1] == CFG.num_heads * CFG.d_head // 2


def test_split_gsoft_bank_counts_the_gathered_blocks(tp2):
    """A GSOFT bank split over its blocks gathers the batch's slots at each
    rotation, and each rank counts the bytes it received: some in every
    banked case with GSOFT tenants."""
    for r in tp2:
        for case in ("bank", "store", "int8", "paged"):
            assert r[case]["bank_gather_bytes"] > 0, case


@pytest.mark.parametrize("case", ["moe", "moe_paged"])
def test_moe_split_by_experts_serves_jax_tokens(refs, tp2, case):
    """qwen3-moe at tp = 2, its 8 experts 4 a rank (routing on every rank,
    the partial combines summed), serving a 3-tenant GSOFT bank on the
    attention projections through the contiguous and the paged engine:
    both ranks give JAX's one-device greedy tokens exactly (f32), and
    each holds its half of the experts."""
    want = refs[0]["moe"]
    assert [r[case]["tokens"] for r in tp2] == [want, want]
    from repro_torch.config import get_smoke_config
    cfg = get_smoke_config(MOE)
    for r in tp2:
        assert r[case]["local"]["moe_wi"][1:] == (
            cfg.moe_experts // 2, cfg.d_model, cfg.expert_d_ff)


def test_moe_decode_at_tp2_matches_jax(refs, tp2):
    """One decode step of 8 rows at tp = 2: logits within ``decode_cell``'s
    5e-2 of JAX's single-device ``build_decode_step`` and its greedy
    tokens exactly."""
    want = refs[0]["moe_probe"]
    for r in tp2:
        got = r["moe"]["probe"]
        np.testing.assert_allclose(got["logits"], want, rtol=5e-2, atol=5e-2)
        assert np.array_equal(got["tokens"], want[:, -1].argmax(-1))


def test_moe_offline_merge_on_the_mesh_equals_the_whole_merge(tp2):
    """A GSOFT adapter on every projection, the expert stacks included,
    merged under tp = 2: each rank rotates its own experts with their
    adapters and serves the unsplit merge's greedy tokens exactly."""
    for r in tp2:
        for how in ("seed", "tree"):
            whole, split = r["moe_merge"][how]
            assert split == whole and len(whole) == 4


def test_launcher_serves_moe_split_over_two_ranks(tp2):
    """``launch/serve.py --arch qwen3-moe-30b-a3b --smoke --tp 2 --engine
    paged`` in both ranks (the mesh joins their process group): every
    request served, rank 0 alone prints the report."""
    a, b = tp2[0]["moe_launch"], tp2[1]["moe_launch"]
    assert a["rc"] == b["rc"] == 0
    assert "cluster: 1 replica(s), 8 requests" in a["out"] and not b["out"]
