"""The port's checkpoint manager against the JAX package's on the CPU, on
real trees of the qwen2-72b smoke config: checkpoints exchanged in both
directions leaf for leaf (params in f32 and bf16, the training state
``{"trainable", "opt"}``, a mixed-method adapter bank, a quantized tree),
the files byte for byte, the crash-safety / GC / LATEST / async cases of
tests/test_substrate.py, ``train()`` resumed from a checkpoint against an
uninterrupted run and against JAX's resumed run, and ``attach`` of a
JAX-written adapter directory serving JAX's tokens.

Exchanged leaves are compared bit for bit. A bf16 leaf the port writes
holds the bits and the index dtype JAX writes (the files are equal byte
for byte); JAX's own ``restore`` cannot load a bf16 leaf (``np.load``
gives ``|V2`` and ``jnp.asarray`` refuses it), which
``test_jax_cannot_restore_its_own_bf16_leaf`` records. The resumed
training run equals the uninterrupted one exactly on the CPU; against JAX
the losses agree to 1e-5 relative and the adapters to 1e-4 of
max(1, max|ref|) (f32, the same algorithm with sums in another order)."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro import quant as jquant  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.core.runtime import ModelRuntime as JaxRuntime  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.quant import QuantConfig, is_quant_tensor  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.store import AdapterStore  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

CPU = "cpu"
DTYPES = {"f32": "f32", "bf16": "bf16"}
MIXED = {
    "alice": dict(method="gsoft", block_size=8),
    "bob": dict(method="boft", block_size=8),
    "carol": dict(method="householder", reflections=4),
    "dave": dict(method="oft", block_size=8),
    "erin": dict(method="givens", givens_rounds=4),
}
PROMPT = [3, 4, 5, 6]
LOSS_REL = 1e-5
ADAPTER_REL = 1e-4


def _jcfg(dt="f32"):
    return jax_smoke_config("qwen2-72b").with_overrides(dtype=dt,
                                                        param_dtype=dt)


def _tcfg(dt="f32"):
    return get_smoke_config("qwen2-72b").with_overrides(dtype=dt,
                                                        param_dtype=dt)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    """A leaf's raw bits as a numpy array (torch tensor or numpy/JAX)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "void16") or a.dtype.kind == "V":
        return a.view(np.int16)
    return a


def _assert_bit_equal(port_flat, jax_flat):
    assert sorted(port_flat) == sorted(jax_flat)
    for k, v in jax_flat.items():
        got, want = _bits(port_flat[k]), _bits(v)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _files(d):
    """{relative path: bytes} of every file of a checkpoint directory."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _tuned(cfg, params, seed, scale=0.3):
    ad = jpeft.init_peft(cfg, params, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(scale * rng.normal(size=a.shape), a.dtype),
        ad)


@pytest.fixture(scope="module")
def jparams():
    return {dt: JaxRuntime(_jcfg(dt), key=jax.random.PRNGKey(0)).params
            for dt in DTYPES}


# ---------------------------------------------------------------------------
# params, both directions, f32 and bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_jax_written_params_restore_in_the_port_bit_equal(tmp_path, jparams,
                                                          dt):
    JaxManager(str(tmp_path)).save(3, jparams[dt], extra={"note": dt})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3 and mgr.extra() == {"note": dt}
    got = mgr.restore(device=CPU)
    _assert_bit_equal(tpeft.flatten_paths(got),
                      jpeft.flatten_paths(jparams[dt]))
    if dt == "bf16":
        assert got["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # restoring into a given structure gives the same leaves
    like = convert.params_from_numpy(_np_tree(jparams[dt]), device=CPU)
    _assert_bit_equal(tpeft.flatten_paths(mgr.restore(like, device=CPU)),
                      jpeft.flatten_paths(jparams[dt]))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_port_written_params_equal_jax_files_byte_for_byte(tmp_path, jparams,
                                                           dt):
    tparams = convert.params_from_numpy(_np_tree(jparams[dt]), device=CPU)
    CheckpointManager(str(tmp_path / "port")).save(3, tparams,
                                                   extra={"note": dt})
    JaxManager(str(tmp_path / "jax")).save(3, jparams[dt], extra={"note": dt})
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref)
    for name, blob in ref.items():
        assert port[name] == blob, name
    index = json.loads(port["step_0000000003/index.json"])
    want = "bfloat16" if dt == "bf16" else "float32"
    assert index["leaves"]["layers__attn__wq"]["dtype"] == want
    if dt == "f32":
        out = JaxManager(str(tmp_path / "port")).restore(
            _np_tree(jparams[dt]))
        _assert_bit_equal(jpeft.flatten_paths(out),
                          jpeft.flatten_paths(jparams[dt]))


def test_jax_cannot_restore_its_own_bf16_leaf(tmp_path):
    """The reference's caveat: a bf16 leaf is written as raw 16-bit words
    whose header numpy reads as |V2, which jnp.asarray refuses."""
    tree = {"w": jnp.asarray([1.0, -2.5], jnp.bfloat16)}
    mgr = JaxManager(str(tmp_path))
    mgr.save(1, tree)
    raw = np.load(tmp_path / "step_0000000001" / "w.npy")
    assert raw.dtype.kind == "V" and raw.view(np.uint16)[0] == 0x3F80
    with pytest.raises(TypeError, match="V2"):
        mgr.restore(tree)
    got = CheckpointManager(str(tmp_path)).restore(device=CPU)["w"]
    assert got.dtype == torch.bfloat16 and got.tolist() == [1.0, -2.5]


# ---------------------------------------------------------------------------
# the training state, an adapter bank, a quantized tree
# ---------------------------------------------------------------------------

def _jax_train_state(params):
    pcfg = jpeft.PEFTConfig(method="gsoft", block_size=8)
    trainable = _tuned(pcfg, params, 5)
    opt = joptim.init(joptim.OptimizerConfig(), trainable)
    rng = np.random.default_rng(9)
    opt = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape), a.dtype) if a.ndim else a + 7, opt)
    return {"trainable": trainable, "opt": opt}


def test_training_state_exchanges_both_ways(tmp_path, jparams):
    state = _jax_train_state(jparams["f32"])
    JaxManager(str(tmp_path / "j")).save(2, state, extra={"data_step": 2})
    mgr = CheckpointManager(str(tmp_path / "j"))
    got = mgr.restore(device=CPU)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    _assert_bit_equal(tpeft.flatten_paths(got), jpeft.flatten_paths(state))
    assert mgr.extra()["data_step"] == 2
    # the port writes the same files, and JAX reads them back bit-equal
    CheckpointManager(str(tmp_path / "t")).save(2, got,
                                                extra={"data_step": 2})
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    back = JaxManager(str(tmp_path / "t")).restore(_np_tree(state))
    _assert_bit_equal(jpeft.flatten_paths(back), jpeft.flatten_paths(state))


@pytest.fixture(scope="module")
def mixed_bank(jparams):
    cfgs = {n: jpeft.PEFTConfig(**kw) for n, kw in MIXED.items()}
    adapters = {n: _tuned(c, jparams["f32"], i * 7 + 3)
                for i, (n, c) in enumerate(cfgs.items())}
    return adapters, cfgs


def _cfg_dicts(cfgs):
    return {n: dataclasses.asdict(c) for n, c in cfgs.items()}


def test_jax_adapter_bank_restores_in_the_port(tmp_path, mixed_bank):
    adapters, cfgs = mixed_bank
    JaxManager(str(tmp_path)).save_adapters(0, adapters, cfgs)
    mgr = CheckpointManager(str(tmp_path))
    got, got_cfgs = mgr.restore_adapters(device=CPU)
    assert list(got) == list(MIXED)
    assert _cfg_dicts(got_cfgs) == _cfg_dicts(cfgs)
    _assert_bit_equal(tpeft.flatten_paths(got), jpeft.flatten_paths(adapters))
    names, idx_cfgs, paths = mgr.adapter_index()
    assert names == tuple(MIXED) and _cfg_dicts(idx_cfgs) == _cfg_dicts(cfgs)
    assert paths == tuple(sorted(adapters["alice"]))
    one = mgr.load_adapter("bob", device=CPU)
    _assert_bit_equal(tpeft.flatten_paths(one),
                      jpeft.flatten_paths(adapters["bob"]))
    with pytest.raises(KeyError, match="zed"):
        mgr.load_adapter("zed")


def test_port_adapter_bank_restores_in_jax(tmp_path, mixed_bank):
    adapters, cfgs = mixed_bank
    tadp = convert.adapters_from_numpy(_np_tree(adapters), device=CPU)
    tcfgs = {n: tpeft.PEFTConfig(**kw) for n, kw in MIXED.items()}
    CheckpointManager(str(tmp_path / "t")).save_adapters(0, tadp, tcfgs)
    JaxManager(str(tmp_path / "j")).save_adapters(0, adapters, cfgs)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    back, back_cfgs = JaxManager(str(tmp_path / "t")).restore_adapters()
    assert back_cfgs == cfgs
    _assert_bit_equal(jpeft.flatten_paths(back),
                      jpeft.flatten_paths(adapters))


def test_quantized_tree_exchanges_both_ways(tmp_path, jparams):
    qcfg = jquant.QuantConfig()
    jq = jquant.quantize_params(jparams["f32"], qcfg)
    JaxManager(str(tmp_path / "j")).save_quantized(0, jq, qcfg)
    mgr = CheckpointManager(str(tmp_path / "j"))
    got, used = mgr.restore_quantized(torch.float32, device=CPU)
    assert dataclasses.asdict(used) == dataclasses.asdict(qcfg)
    wq = got["layers"]["attn"]["wq"]
    assert is_quant_tensor(wq) and wq.meta.dtype == "float32"
    flat = {}
    for path, leaf in tpeft.flatten_paths(got).items():
        if is_quant_tensor(leaf):
            flat[path + "/q"], flat[path + "/scale"] = leaf.q, leaf.scale
        else:
            flat[path] = leaf
    _assert_bit_equal(flat, jpeft.flatten_paths(jq))
    # the port writes the same files, and JAX restores them bit-equal
    CheckpointManager(str(tmp_path / "t")).save_quantized(
        0, got, QuantConfig())
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    back, _ = JaxManager(str(tmp_path / "t")).restore_quantized(
        japi.abstract_params(_jcfg()))
    _assert_bit_equal(jpeft.flatten_paths(back), jpeft.flatten_paths(jq))
    # a conflicting request is refused, as in JAX
    with pytest.raises(ValueError, match="conflicts"):
        mgr.restore_quantized(qcfg=QuantConfig(per_channel=False),
                              device=CPU)


def test_load_quantized_serves_jax_tokens(tmp_path, jparams):
    """A JAX-written int8 checkpoint through ``ModelRuntime.load_quantized``
    serves JAX's int8 greedy tokens (its codes and scales, bit-equal)."""
    qcfg = jquant.QuantConfig()
    jrt = JaxRuntime(_jcfg(), jparams["f32"]).quantized(qcfg=qcfg)
    JaxManager(str(tmp_path)).save_quantized(0, jrt.params, qcfg)
    jeng = JaxEngine(JaxRuntime.load_quantized(str(tmp_path), _jcfg()),
                     max_batch=1, max_len=24, eos_id=-1)
    rid = jeng.add_request(PROMPT, max_new_tokens=5)
    want = jeng.run()[rid]
    rt = ModelRuntime.load_quantized(str(tmp_path), _tcfg(), device=CPU)
    assert rt.is_quantized and rt.quant_cfg.mode == "int8"
    eng = ServeEngine(rt, max_batch=1, max_len=24, eos_id=-1)
    rid = eng.add_request(PROMPT, max_new_tokens=5)
    assert eng.run()[rid] == want
    # a plain float checkpoint is quantized on load
    JaxManager(str(tmp_path / "f")).save(0, jparams["f32"])
    rt2 = ModelRuntime.load_quantized(str(tmp_path / "f"), _tcfg(),
                                      device=CPU)
    np.testing.assert_array_equal(
        rt2.params["layers"]["attn"]["wq"].q.numpy(),
        rt.params["layers"]["attn"]["wq"].q.numpy())


# ---------------------------------------------------------------------------
# tests/test_substrate.py's cases
# ---------------------------------------------------------------------------

def _tree():
    return {"model": {"w": torch.arange(6.0).reshape(2, 3),
                      "b": torch.ones(3)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(12, tree, extra={"data_step": 12})
    assert mgr.latest_step() == 12
    out = mgr.restore(tree, device=CPU)
    for k, v in tpeft.flatten_paths(tree).items():
        assert torch.equal(tpeft.flatten_paths(out)[k], v)
    assert mgr.extra()["data_step"] == 12


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_0000000003", "step_0000000004"]
    assert mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device=CPU)


def test_checkpoint_async_writes_the_state_it_was_given(tmp_path):
    """An async save copies to host memory first: an in-place update right
    after save() returns does not reach the files."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, blocking=False)
    tree["model"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    got = mgr.restore(device=CPU)
    assert torch.equal(got["model"]["w"], torch.arange(6.0).reshape(2, 3))


def test_checkpoint_crash_safety(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / ".tmp_step_0000000099")
    mgr.save(2, _tree())
    assert mgr.latest_step() == 2
    # a stale .tmp_ of the step being written is replaced
    os.makedirs(tmp_path / ".tmp_step_0000000003" / "junk")
    mgr.save(3, _tree())
    assert not (tmp_path / ".tmp_step_0000000003").exists()
    # LATEST naming a missing directory means no checkpoint
    (tmp_path / "LATEST").write_text("step_0000000042")
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# train() resumed from a checkpoint
# ---------------------------------------------------------------------------

STEPS = 4


def _tcfg_train():
    return tsteps.TrainStepConfig(
        peft=tpeft.PEFTConfig(method="gsoft", block_size=8),
        opt=optim.OptimizerConfig(learning_rate=3e-3))


def _jcfg_train():
    return jsteps.TrainStepConfig(
        peft=jpeft.PEFTConfig(method="gsoft", block_size=8),
        opt=joptim.OptimizerConfig(learning_rate=3e-3))


@pytest.fixture(scope="module")
def resumed(jparams, tmp_path_factory):
    """Port and JAX: STEPS steps uninterrupted, and 2 steps then a resume
    to STEPS, over the same (JAX-drawn) base params."""
    tparams = convert.params_from_numpy(_np_tree(jparams["f32"]), device=CPU)

    class SameParams(ModelRuntime):
        def __init__(self, cfg, params=None, **kw):
            super().__init__(cfg, params if params is not None else
                             {k: v for k, v in tparams.items()}, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tloop, "ModelRuntime", SameParams)
    dcfg = DataConfig(seq_len=16, global_batch=2, seed=0, vocab_size=128)
    jdcfg = JDataConfig(seq_len=16, global_batch=2, seed=0, vocab_size=128)
    quiet = lambda s: None  # noqa: E731
    out = {}
    try:
        full = tloop.train(_tcfg(), _tcfg_train(), dcfg,
                           tloop.LoopConfig(steps=STEPS, log_every=1),
                           log_fn=quiet, device=CPU)
        d = str(tmp_path_factory.mktemp("port_ckpt"))
        first = tloop.train(_tcfg(), _tcfg_train(), dcfg,
                            tloop.LoopConfig(steps=2, log_every=1,
                                             ckpt_dir=d, async_ckpt=True),
                            log_fn=quiet, device=CPU)
        saved = CheckpointManager(d).restore(device=CPU)
        logs = []
        second = tloop.train(_tcfg(), _tcfg_train(), dcfg,
                             tloop.LoopConfig(steps=STEPS, log_every=1,
                                              ckpt_dir=d),
                             log_fn=logs.append, device=CPU)
        out["port"] = dict(full=full, first=first, second=second,
                           saved=saved, logs=logs, dir=d)
    finally:
        mp.undo()
    jd = str(tmp_path_factory.mktemp("jax_ckpt"))
    jfirst = jloop.train(_jcfg(), _jcfg_train(), jdcfg,
                         jloop.LoopConfig(steps=2, log_every=1, ckpt_dir=jd),
                         log_fn=quiet)
    jsecond = jloop.train(_jcfg(), _jcfg_train(), jdcfg,
                          jloop.LoopConfig(steps=STEPS, log_every=1,
                                           ckpt_dir=jd), log_fn=quiet)
    out["jax"] = dict(first=jfirst, second=jsecond, dir=jd)
    return out


def test_train_resume_restores_the_saved_state_bit_for_bit(resumed):
    p = resumed["port"]
    assert "resumed from step 2" in p["logs"]
    _assert_bit_equal(tpeft.flatten_paths(p["saved"]["trainable"]),
                      tpeft.flatten_paths(p["first"]["trainable"]))
    _assert_bit_equal(tpeft.flatten_paths(p["saved"]["opt"]),
                      tpeft.flatten_paths(p["first"]["opt_state"]))
    mgr = CheckpointManager(p["dir"])
    assert mgr.latest_step() == STEPS
    assert mgr.extra() == {"data_step": STEPS}


def test_train_resume_equals_the_uninterrupted_run_exactly(resumed):
    p = resumed["port"]
    full_losses = [h["loss"] for h in p["full"]["history"]]
    assert [h["step"] for h in p["second"]["history"]] == [2, 3]
    assert [h["loss"] for h in p["second"]["history"]] == full_losses[2:]
    _assert_bit_equal(tpeft.flatten_paths(p["second"]["trainable"]),
                      tpeft.flatten_paths(p["full"]["trainable"]))
    _assert_bit_equal(tpeft.flatten_paths(p["second"]["opt_state"]),
                      tpeft.flatten_paths(p["full"]["opt_state"]))


def test_train_resume_matches_jax_resumed_run(resumed):
    p, j = resumed["port"], resumed["jax"]
    for th, jh in zip(p["first"]["history"] + p["second"]["history"],
                      j["first"]["history"] + j["second"]["history"]):
        assert th["step"] == jh["step"]
        assert abs(th["loss"] - jh["loss"]) <= LOSS_REL * abs(jh["loss"])
    jflat = jpeft.flatten_paths(j["second"]["trainable"])
    tflat = tpeft.flatten_paths(p["second"]["trainable"])
    for k, v in jflat.items():
        want = np.asarray(v, np.float64)
        err = np.abs(tflat[k].numpy() - want).max()
        assert err <= ADAPTER_REL * max(1.0, np.abs(want).max()), k
    # and each package reads the other's checkpoint of the run
    jstate = JaxManager(p["dir"]).restore(_np_tree(
        {"trainable": j["second"]["trainable"],
         "opt": j["second"]["opt_state"]}))
    _assert_bit_equal(jpeft.flatten_paths(jstate["trainable"]),
                      tpeft.flatten_paths(p["second"]["trainable"]))
    tstate = CheckpointManager(j["dir"]).restore(device=CPU)
    _assert_bit_equal(tpeft.flatten_paths(tstate["trainable"]),
                      jpeft.flatten_paths(j["second"]["trainable"]))


def test_launcher_ckpt_dir_resumes(tmp_path, capsys):
    from repro_torch.launch import train as tlaunch
    args = ["--arch", "qwen2-72b", "--smoke", "--device", CPU, "--batch", "2",
            "--seq", "16", "--block-size", "8", "--ckpt-dir", str(tmp_path)]
    assert tlaunch.main(args + ["--steps", "2"]) == 0
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    capsys.readouterr()
    assert tlaunch.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("step ") >= 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


# ---------------------------------------------------------------------------
# attach(<JAX-written dir>)
# ---------------------------------------------------------------------------

def _serve(engine, names):
    rids = {n: engine.add_request(PROMPT, max_new_tokens=5, adapter=n)
            for n in names}
    out = engine.run()
    return {n: out[r] for n, r in rids.items()}


def test_attach_of_a_jax_written_dir_serves_jax_tokens(tmp_path, jparams,
                                                       mixed_bank):
    adapters, cfgs = mixed_bank
    JaxManager(str(tmp_path)).save_adapters(0, adapters, cfgs)
    names = list(MIXED) + [None]
    jrt = JaxRuntime(_jcfg(), jparams["f32"])
    want = _serve(JaxEngine(jrt.attach(adapters, cfgs), max_batch=4,
                            max_len=48, eos_id=-1), names)
    rt = ModelRuntime(_tcfg(), convert.params_from_numpy(
        _np_tree(jparams["f32"]), device=CPU), device=CPU)
    paged = rt.attach(str(tmp_path))
    assert isinstance(paged.bank.store, AdapterStore)
    assert _serve(ServeEngine(paged, max_batch=4, max_len=48, eos_id=-1),
                  names) == want
    # the launcher's entry form, loaded eagerly
    eager = rt.attach([f"bob={tmp_path}", f"alice={tmp_path}"])
    assert eager.bank.names[1:] == ("bob", "alice")
    assert _serve(ServeEngine(eager, max_batch=2, max_len=48, eos_id=-1),
                  ["bob", "alice"]) == {n: want[n] for n in ("bob", "alice")}
    with pytest.raises(ValueError, match="carries its own"):
        rt.attach(str(tmp_path), tpeft.PEFTConfig())
