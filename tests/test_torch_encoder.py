"""The encoder classifier (``models/encoder.py``: the paper's GLUE setting,
Table 1) against the JAX package on the CPU at the proxy size of
``benchmarks/table1_glue.py`` (2 layers, d 64, 4 heads, d_ff 128, vocab
64, 4 classes), f32. JAX ``init_encoder_classifier`` params are carried
across by ``repro_torch.convert``. Held: the config, the tree, the logits,
loss and accuracy; and, for LoRA r 8, OFT b 16, BOFT m 2 b 8 and GSOFT b
8 (table1's four adapter methods, built as it builds them: the adapters
and the head train, the backbone is frozen, ``materialize_tree`` applies
the adapters), the loss and every trainable leaf's gradient against
jax.grad, then three AdamW steps against JAX's.

Tolerances: logits and losses within 1e-5 of the largest magnitude (sums
in another order); gradients within 1e-4 of each leaf's largest; updated
leaves within 1e-2 of the learning rate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.models import encoder as jencoder  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.core import peft as tpeft  # noqa: E402
from repro_torch.models import encoder  # noqa: E402

CPU = "cpu"
F32_REL = 1e-5
GRAD_REL = 1e-4
KW = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=64)
NUM_CLASSES = 4
SEQ = 12
METHODS = {
    "LoRA_r8": dict(method="lora", rank=8, alpha=16),
    "OFT_b16": dict(method="oft", block_size=16),
    "BOFT_m2_b8": dict(method="boft", block_size=8, boft_factors=2),
    "GSOFT_b8": dict(method="gsoft", block_size=8),
}


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max|diff| {err} > {rel} * {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _task(cfg, n, seed):
    """table1_glue's task: the label is the last token's class."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": (toks[:, -1] % NUM_CLASSES).astype(
        np.int32)}


_W = {}


def world():
    if not _W:
        jcfg, cfg = jencoder.encoder_config(**KW), encoder.encoder_config(**KW)
        jp = jencoder.init_encoder_classifier(jcfg, NUM_CLASSES,
                                              jax.random.PRNGKey(0))
        params = convert.params_from_numpy(_np_tree(jp), device=CPU)
        _W.update(jcfg=jcfg, cfg=cfg, jp=jp, params=params)
    return _W


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_config_tree_logits_and_loss_match_jax():
    w = world()
    assert convert.config_from_jax(w["jcfg"]) == w["cfg"]
    assert encoder.encoder_config() == convert.config_from_jax(
        jencoder.encoder_config())
    own = encoder.init_encoder_classifier(w["cfg"], NUM_CLASSES, seed=1,
                                          device=CPU)
    assert {p: tuple(v.shape) for p, v in tpeft.flatten_paths(own).items()} \
        == {p: tuple(v.shape) for p, v in
            tpeft.flatten_paths(_np_tree(w["jp"])).items()}
    batch = _task(w["cfg"], 16, 0)
    jlog = jencoder.encoder_forward(w["jcfg"], w["jp"],
                                    jnp.asarray(batch["tokens"]))
    tlog = encoder.encoder_forward(w["cfg"], w["params"],
                                   torch.from_numpy(batch["tokens"]))
    assert tuple(tlog.shape) == (16, NUM_CLASSES)
    _close(tlog.numpy(), np.asarray(jlog), F32_REL, "logits")
    jl, jm = jencoder.classifier_loss(w["jcfg"], w["jp"], _jb(batch))
    tl, tm = encoder.classifier_loss(w["cfg"], w["params"], _tb(batch))
    _close(float(tl), float(jl), F32_REL, "loss")
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    # bidirectional: a change at the last position moves position 0's
    # logits (a causal stack would not)
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, -1] = (other["tokens"][:, -1] + 1) % 64
    assert not np.allclose(encoder.encoder_forward(
        w["cfg"], w["params"], torch.from_numpy(other["tokens"])).numpy(),
        tlog.numpy())


def _setups(name, w):
    """table1_glue's trainable tree: {"adapters", "head"}, the adapters
    perturbed off their identity (LoRA's B off zero) so every gradient
    path is live."""
    jpc = jpeft.PEFTConfig(**METHODS[name])
    tpc = tpeft.PEFTConfig(**METHODS[name])
    ad = jpeft.init_peft(jpc, w["jp"], jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    ad = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * rng.normal(size=a.shape), a.dtype), ad)
    jtr = {"adapters": ad, "head": w["jp"]["head"]}
    ttr = convert.adapters_from_numpy(_np_tree(jtr), device=CPU)

    def jmat(t):
        return {**jpeft.materialize_tree(jpc, w["jp"], t["adapters"]),
                "head": t["head"]}

    def tmat(t):
        return {**tpeft.materialize_tree(tpc, w["params"], t["adapters"]),
                "head": t["head"]}

    return jtr, ttr, jmat, tmat


def _keys(tr):
    """The trainable leaves' keys: ("adapters", weight path, factor) and
    ("head", name) (the adapter paths hold "/", so no flat path)."""
    return ([("adapters", p, k) for p in sorted(tr["adapters"])
             for k in sorted(tr["adapters"][p])]
            + [("head", k) for k in sorted(tr["head"])])


def _get(tr, key):
    for k in key:
        tr = tr[k]
    return tr


def _tree(keys, vals):
    out = {"adapters": {}, "head": {}}
    for key, v in zip(keys, vals):
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = v
    return out


def _torch_grads(cfg, tmat, ttr, batch):
    """(loss, keys, gradients of every trainable leaf)."""
    keys = _keys(ttr)
    req = [_get(ttr, k).detach().clone().requires_grad_() for k in keys]
    tl, _ = encoder.classifier_loss(cfg, tmat(_tree(keys, req)), _tb(batch))
    return tl.detach(), keys, torch.autograd.grad(tl, req)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_adapter_gradients_and_steps_match_jax(name):
    w = world()
    jcfg, cfg = w["jcfg"], w["cfg"]
    jtr, ttr, jmat, tmat = _setups(name, w)
    assert len(jtr["adapters"]) == 6      # wq wk wv wo, mlp wi wo
    batch = _task(cfg, 16, 1)
    jl, jg = jax.value_and_grad(
        lambda t: jencoder.classifier_loss(jcfg, jmat(t), _jb(batch))[0])(jtr)
    tl, keys, grads = _torch_grads(cfg, tmat, ttr, batch)
    _close(float(tl), float(jl), F32_REL, "loss")
    assert keys == _keys(jg)
    for key, g in zip(keys, grads):
        _close(g.numpy(), np.asarray(_get(jg, key)), GRAD_REL, f"d {key}")
        assert float(g.abs().max()) > 0, key
    # three AdamW steps, as table1_glue's step
    lr = 5e-3
    jo = joptim.OptimizerConfig(learning_rate=lr)
    to = optim.OptimizerConfig(learning_rate=lr)
    jopt = joptim.init(jo, jtr)
    topt = convert.opt_state_from_numpy(_np_tree(jopt), device=CPU)

    @jax.jit
    def jstep(tr, opt, b):
        (loss, _), g = jax.value_and_grad(lambda t: jencoder.classifier_loss(
            jcfg, jmat(t), b), has_aux=True)(tr)
        tr, opt, _ = joptim.update(jo, g, opt, tr)
        return tr, opt, loss

    for s in range(3):
        b = _task(cfg, 32, 10 + s)
        jtr, jopt, jl = jstep(jtr, jopt, _jb(b))
        tl, keys, g = _torch_grads(cfg, tmat, ttr, b)
        with torch.no_grad():
            ttr, topt, _ = optim.update(to, _tree(keys, g), topt, ttr)
        _close(float(tl), float(jl), F32_REL, f"step {s} loss")
    for key in _keys(jtr):
        _close(_get(ttr, key).numpy(), np.asarray(_get(jtr, key)), 1e-2 * lr,
               f"updated {key}")
