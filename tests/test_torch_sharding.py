"""The port's serving partition rules (``sharding/specs.py``) against the
JAX package's ``ShardingRules`` on the CPU: for every ported config
(qwen2-72b, mamba2-130m, zamba2-2.7b, lipconvnet-15), smoke and full
shapes, at tp = 1, 2, 4 and 8 on a (1, tp) ("data", "model") mesh, every
leaf's spec equals JAX's ``PartitionSpec`` entry for entry — params,
``serve_params_tree`` over int8 trees, ``paged_state_spec``,
``decode_state_spec`` and ``bank_spec_tree`` over a mixed-method bank.

JAX's rules take a ``jax.sharding.AbstractMesh``, the port's a plain
``{axis: size}`` mapping: no process group and no device. Full-width trees
are shapes only (JAX's ``eval_shape``, the port's meta tensors); the smoke
trees are the ones each package builds, so their paths are checked too.
Also ``place``: each rank's local slices reassemble the whole leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.peft import path_str  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.quant import QuantConfig as JaxQuantConfig  # noqa: E402
from repro.quant import quantize_params as jax_quantize  # noqa: E402
from repro.sharding.specs import ShardingRules as JaxRules  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch import convert, quant  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.quant.core import QuantTensor  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ARCHS = ("qwen2-72b", "mamba2-130m", "zamba2-2.7b", "lipconvnet-15",
         "gemma-7b", "granite-34b", "mistral-large-123b",
         "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
TPS = (1, 2, 4, 8)


def _rules(cfg, jcfg, tp):
    return (specs.ShardingRules(cfg, {"data": 1, "model": tp}),
            JaxRules(jcfg, AbstractMesh((1, tp), ("data", "model"))))


def _jax_flat(spec_tree):
    """{path: spec tuple} of a JAX spec tree (a QuantTensor's specs as
    ``.../q`` and ``.../scale``)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    out = {}
    for p, s in leaves:
        key = path_str(p)
        out[key.replace("/.q", "/q").replace("/.scale", "/scale")] = tuple(s)
    return out


def _port_flat(spec_tree, prefix=""):
    out = {}
    for k, v in spec_tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_flat(v, path))
        elif isinstance(v, QuantTensor):
            out[f"{path}/q"], out[f"{path}/scale"] = tuple(v.q), tuple(v.scale)
        else:
            out[path] = tuple(v)
    return out


def _meta(tree):
    """JAX shapes -> the port's meta tensors (same nesting, same dtype)."""
    def leaf(a):
        dt = (torch.bfloat16 if str(a.dtype) == "bfloat16"
              else getattr(torch, str(a.dtype)))
        return torch.empty(a.shape, dtype=dt, device="meta")
    return jax.tree.map(leaf, tree)


def _configs(arch):
    return ((tconfig.get_smoke_config(arch), jconfig.get_smoke_config(arch)),
            (tconfig.get_config(arch), jconfig.get_config(arch)))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, tp):
    """Every param leaf, smoke and full: the port's ``params_tree`` and
    ``serve_params_tree`` equal JAX's ``params_tree`` /
    ``serve_params_tree``; on the smoke config over the tree each package
    builds (the same paths), on the full one over JAX's shapes."""
    for i, (cfg, jcfg) in enumerate(_configs(arch)):
        rules, jrules = _rules(cfg, jcfg, tp)
        jabs = japi.abstract_params(jcfg)
        if i == 0:
            tree = tapi.init_params(cfg, 0, "cpu")
        else:
            tree = _meta(jabs)
        want = _jax_flat(jrules.params_tree(jabs))
        assert _port_flat(rules.params_tree(tree)) == want
        assert _port_flat(rules.serve_params_tree(tree)) == \
            _jax_flat(jrules.serve_params_tree(jabs))
        assert rules.attn_heads_shardable == jrules.attn_heads_shardable
        assert rules.kv_heads_shardable == jrules.kv_heads_shardable
        assert rules.vocab_shardable == jrules.vocab_shardable
        assert rules.mamba_shardable == jrules.mamba_shardable


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ("qwen2-72b", "lipconvnet-15"))
def test_int8_serve_specs_equal_jax(arch, tp):
    """``serve_params_tree`` over int8 trees (codes shard like the weight,
    scales where their keepdims shape divides), smoke and full."""
    for cfg, jcfg in _configs(arch):
        rules, jrules = _rules(cfg, jcfg, tp)
        jq = jax.eval_shape(lambda p: jax_quantize(p, JaxQuantConfig(
            mode="int8")), japi.abstract_params(jcfg))
        tq = quant.quantize_params(_meta(japi.abstract_params(jcfg)),
                                   quant.QuantConfig(mode="int8"))
        assert _port_flat(rules.serve_params_tree(tq)) == \
            _jax_flat(jrules.serve_params_tree(jq))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ("qwen2-72b", "mamba2-130m", "zamba2-2.7b"))
def test_state_specs_equal_jax(arch, tp):
    """``decode_state_spec`` (KV caches, Mamba states) for every family and
    ``paged_state_spec`` for the decoder, smoke and full, batch 4."""
    for cfg, jcfg in _configs(arch):
        rules, jrules = _rules(cfg, jcfg, tp)
        jst = jax.eval_shape(lambda: jtransformer.init_decode_state(
            jcfg, 4, 64))
        tst = ttransformer.init_decode_state(cfg, 4, 64, "meta")
        assert _port_flat(rules.decode_state_spec(tst, 4)) == \
            _jax_flat(jrules.decode_state_spec(jst, 4))
        if arch != "qwen2-72b":
            continue
        jps = jax.eval_shape(lambda: jtransformer.init_paged_state(
            jcfg, 4, 17, 8, 8))
        tps = ttransformer.init_paged_state(cfg, 4, 17, 8, 8, "meta")
        assert _port_flat(rules.paged_state_spec(tps)) == \
            _jax_flat(jrules.paged_state_spec(jps))
        jb = {"tokens": jax.ShapeDtypeStruct((4, 16), np.int32)}
        tb = {"tokens": torch.empty((4, 16), dtype=torch.int32,
                                    device="meta")}
        assert _port_flat(rules.batch_spec(tb, 4)) == \
            _jax_flat(jrules.batch_spec(jb, 4))


@pytest.fixture(scope="module")
def banks():
    """A mixed-method bank (gsoft / boft / oft / householder / givens) built
    by each package over the same smoke params and adapters."""
    jcfg = jconfig.get_smoke_config("qwen2-72b")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    methods = ("gsoft", "boft", "oft", "householder", "givens")
    jc = {f"a{i}": jpeft.PEFTConfig(method=m, block_size=8)
          for i, m in enumerate(methods)}
    tc = {f"a{i}": tpeft.PEFTConfig(method=m, block_size=8)
          for i, m in enumerate(methods)}
    jad = {n: jpeft.init_peft(c, jparams, jax.random.PRNGKey(i))
           for i, (n, c) in enumerate(jc.items())}
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    tad = convert.adapters_from_numpy(jax.tree.map(np.asarray, jad),
                                      device="cpu")
    return (jpeft.build_adapter_bank(jc, jparams, jad),
            tpeft.build_adapter_bank(tc, tparams, tad))


@pytest.mark.parametrize("tp", TPS)
def test_bank_specs_equal_jax(banks, tp):
    """``bank_spec_tree``: replicated stacks, GSOFT's split over its block
    axis r wherever it divides (``MethodOps.bank_shard_axes``)."""
    jbank, tbank = banks
    cfg, jcfg = (tconfig.get_smoke_config("qwen2-72b"),
                 jconfig.get_smoke_config("qwen2-72b"))
    rules, jrules = _rules(cfg, jcfg, tp)
    want = _jax_flat(jrules.bank_spec_tree(jbank.tree))
    got = _port_flat(rules.bank_spec_tree(tbank.tree))
    assert got == want
    split = [p for p, s in got.items() if "model" in s]
    assert split and all("/gsoft/" in p for p in split)


class _Rank(dict):
    """A mesh seen from one rank: axis sizes plus this rank's coords."""

    def __init__(self, sizes, coords):
        super().__init__(sizes)
        self.coords = coords


def test_local_slices_reassemble_the_leaf(monkeypatch):
    """``place`` keeps rank r's contiguous block of each split dim; the
    ranks' blocks, joined in rank order, are the whole leaf (codes and
    scales of a QuantTensor alike), and a replicated leaf stays whole."""
    cfg = tconfig.get_smoke_config("qwen2-72b")
    params = quant.quantize_params(tapi.init_params(cfg, 0, "cpu"),
                                   quant.QuantConfig(mode="int8"))
    tp = 2
    rules = specs.ShardingRules(cfg, {"data": 1, "model": tp})
    spec_tree = rules.serve_params_tree(params)
    parts = []
    for r in range(tp):
        monkeypatch.setattr(specs, "_coords",
                            lambda mesh, r=r: {"data": 0, "model": r})
        parts.append(specs.place({"data": 1, "model": tp}, params, spec_tree))
    mine = [tpeft.flatten_paths(p) for p in parts]
    for path, whole in tpeft.flatten_paths(params).items():
        spec = tpeft.flatten_paths(spec_tree)[path]
        pairs = ([(whole.q, spec.q, [m[path].q for m in mine]),
                  (whole.scale, spec.scale, [m[path].scale for m in mine])]
                 if isinstance(whole, QuantTensor)
                 else [(whole, spec, [m[path] for m in mine])])
        for w, sp, pieces in pairs:
            if "model" in sp:
                dim = sp.index("model")
                assert pieces[0].shape[dim] * tp == w.shape[dim]
                assert torch.equal(torch.cat(pieces, dim), w)
            else:
                assert all(torch.equal(p, w) for p in pieces)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_kv_heads_kept_follow_the_state_specs(smoke, tp):
    """``kv_heads_kept``, the kv heads a rank's caches hold, for qwen2-72b:
    the rank's contiguous K / tp where the state specs split kv heads over
    'model'; where they replicate them under a q-head split, exactly the
    heads the rank's q heads read; else all K. Every q head of the rank
    finds its kv head among them."""
    get = tconfig.get_smoke_config if smoke else tconfig.get_config
    cfg = get("qwen2-72b")
    H, K = cfg.num_heads, cfg.num_kv_heads
    rules = specs.ShardingRules(cfg, {"data": 1, "model": tp})
    kv_entry = rules.paged_state_spec(
        {"pages": {"k": torch.empty((1, 2, 8, K, cfg.d_head),
                                    device="meta")}})["pages"]["k"][-2]
    assert kv_entry == rules.kv_axis
    for r in range(tp):
        kept = rules.kv_heads_kept(r)
        if kv_entry == "model":
            assert kept == tuple(range(r * K // tp, (r + 1) * K // tp))
        elif H % tp == 0:
            q = range(r * H // tp, (r + 1) * H // tp)
            assert set(kept) == {h // (H // K) for h in q}
        else:
            assert kept == tuple(range(K))


def test_place_copies_a_split_leaf_and_moves_only_the_slice():
    """A split leaf's slice is a copy (the whole leaf can be freed), an
    unsplit one comes back as it is, and with ``device`` the slice alone
    is moved."""
    mesh = {"data": 1, "model": 2}
    w = torch.arange(24.0).reshape(4, 6)
    half = specs.place_leaf(mesh, w, (None, "model"))
    assert half.shape == (4, 3) and torch.equal(half, w[:, :3])
    assert half.untyped_storage().data_ptr() != \
        w.untyped_storage().data_ptr()
    assert specs.place_leaf(mesh, w, ()) is w
    meta = specs.place_leaf(mesh, w, ("model", None), device="meta")
    assert meta.device.type == "meta" and meta.shape == (2, 6)
