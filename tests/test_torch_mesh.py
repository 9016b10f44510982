"""Training on a (data x model) mesh on the CPU: four gloo ranks spawned
once (``tests/torch_mesh_runner.py``, JAX-free) against JAX's
single-device references computed here.

* ``train_cell`` as ``tests/distributed_runner.py`` runs it: qwen2-72b,
  zamba2-2.7b and mamba2-130m at their smoke configs, GSOFT b = 8, AdamW
  lr 1e-3, batch 8 x 16 in 2 microbatches, 3 steps, on the (2, 2) mesh
  with ``seq_parallel`` off and on: every rank's losses within rtol = atol
  = 2e-3 of JAX's single-device step (JAX's own tolerance), AdamW's first
  moments (the gradients' running sums) leaf for leaf within 2e-3 of
  their largest (each rank's block of a leaf), the grad norms within 1e-4
  relative, and the adapters moved; the same with a ragged mask
  (qwen2-72b with ``seq_parallel`` under remat "full", mamba2-130m
  without), where the masked mean is the global microbatch's;
* full fine-tuning of qwen2-72b, gemma-7b (tied embeddings) and
  mamba2-130m on (2, 2), ``seq_parallel`` off and on; qwen3-moe (E 8, top
  2) with its experts split over 'model', under GSOFT (the expert stacks'
  adapters split with them, rotated in place: nothing gathered) and full
  fine-tuning, with a ragged mask (the load-balance term a mean over
  rows), and with 6 experts on (1, 4) (each expert's d_ff split); the
  default clip binding, so a rank's own norm would fail; a full
  fine-tuning checkpoint saved on (2, 2) restored onto (1, 4) and read by
  JAX;
* a checkpoint of the placed params saved on (2, 2) (gathered whole, one
  writer) is read by JAX's ``CheckpointManager.restore`` equal to the
  params, and restored by the port onto (4, 1) and (1, 4) bit for bit the
  rank's slice; a save that does not block is read back after ``wait()``;
* ``compressed_psum_mean`` over 'data' within JAX's 1e-2 of the exact
  mean, and ``ef_compress`` equal to JAX's bit for bit on the int8 codes;
* ``gpipe_forward`` over 4 stages against the stages run in sequence,
  outputs and every stage's gradients (as ``tests/pipeline_runner.py``);
* one decode step with the batch rows split over 'data' (2, 2): the
  gathered logits against JAX's single-device decode (``decode_cell``'s
  tolerance, 5e-2), qwen3-moe's too, and their greedy tokens exactly;
* the launcher on (2, 2) in the ranks (``--peft full``, qwen3-moe), and
  its ``--mesh`` refusals in process.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from repro.config import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.data.synthetic import lm_batch  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.sharding.specs import ShardingRules as JaxRules  # noqa: E402
from repro.train.steps import TrainStepConfig as JaxTSC  # noqa: E402
from repro.train.steps import build_decode_step as jax_decode_step  # noqa: E402
from repro.train.steps import build_train_step as jax_train_step  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.sharding.specs import ShardingRules  # noqa: E402

import torch_mesh_runner as runner  # noqa: E402

ARCHS = ("qwen2-72b", "zamba2-2.7b", "mamba2-130m")
# valid tokens of each of the 8 rows: microbatch 0 (rows 0-3) leaves data
# rank 1 (rows 2-3) none, and each rank's share differs in both microbatches
RAGGED = (16, 3, 0, 0, 12, 7, 5, 16)
# (arch, seq_parallel, remat): remat "full" also gathers each row-split
# weight slice again in the backward
RAGGED_CELLS = (("qwen2-72b", True, "full"), ("mamba2-130m", False, "none"))
NSTAGE, NMB, MB, D = 4, 6, 2, 16
# full fine-tuning on (2, 2): a dense decoder, tied embeddings, Mamba2
FT_ARCHS = ("qwen2-72b", "gemma-7b", "mamba2-130m")
MOE = "qwen3-moe-30b-a3b"   # smoke: E 8, top 2: split by experts on (2, 2)
DFF = dict(moe_experts=6)   # 6 experts on (1, 4): split by each one's d_ff
CLIP = 1.0                  # the default grad_clip: under every cell's norm
LAUNCHES = {"full": ["--arch", "qwen2-72b", "--peft", "full"],
            "moe": ["--arch", MOE]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_STEPS = {}


def _jax_train(arch, params, batch, method="gsoft", over=None):
    """JAX's single-device ``train_cell`` reference: losses, AdamW's first
    moments by path and the grad norms (GSOFT b = 8, or full
    fine-tuning)."""
    cfg = dataclasses.replace(jax_smoke_config(arch), **(over or {}))
    pcfg = jpeft.PEFTConfig(method=method, block_size=runner.BLOCK)
    ocfg = joptim.OptimizerConfig(learning_rate=1e-3, grad_clip=CLIP)
    if pcfg.is_peft:
        frozen = params
        trainable = jpeft.init_peft(pcfg, params, jax.random.PRNGKey(0))
    else:
        frozen, trainable = {}, params
    opt = joptim.init(ocfg, trainable)
    key = (arch, method, tuple(sorted((over or {}).items())))
    if key not in _STEPS:       # one compile for the cells that share it
        _STEPS[key] = jax.jit(jax_train_step(cfg, JaxTSC(
            peft=pcfg, opt=ocfg, num_microbatches=2)))
    step = _STEPS[key]
    losses, norms = [], []
    for _ in range(3):
        trainable, opt, m = step(frozen, trainable, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mu = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_flatten_with_path(opt["mu"])[0]}
    return losses, mu, norms, trainable


def _check_cell(got, want, norms=True):
    """Losses within rtol = atol = 2e-3 of JAX's, the trainable tree
    moved, AdamW's first moments leaf by leaf (the rank's block against
    the same block of JAX's leaf) within 2e-3 of the leaf's largest, and
    the grad norms within 1e-4 relative."""
    losses, mu, gn = want[:3]
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-3, atol=2e-3)
    assert got["moved"] > 0
    assert got["mu"].keys() == mu.keys()
    for k, v in mu.items():
        block = v[tuple(slice(a, a + n) for a, n in got["windows"][k])]
        np.testing.assert_allclose(got["mu"][k], block,
                                   atol=2e-3 * np.abs(v).max() + 1e-12,
                                   err_msg=k)
    if norms:
        np.testing.assert_allclose(got["grad_norms"], gn, rtol=1e-4)


def _jax_decode(arch, params):
    cfg = jax_smoke_config(arch)
    state = japi.init_decode_state(cfg, 8, 32, enc_len=8)
    _, logits, _ = jax_decode_step(cfg, mesh=None)(
        params, None, jnp.ones((8, 1), jnp.int32), state,
        jnp.asarray(0, jnp.int32))
    return np.asarray(logits, np.float32)


def _ragged(batch):
    """``batch`` with its mask padded row by row to RAGGED's lengths."""
    seq = batch["mask"].shape[1]
    mask = (np.arange(seq)[None, :] < np.asarray(RAGGED)[:, None])
    return dict(batch, mask=jnp.asarray(mask, batch["mask"].dtype))


def _gpipe_params():
    rng = np.random.default_rng(0)
    return ({"w": (rng.standard_normal((NSTAGE, D, D)) / np.sqrt(D))
             .astype(np.float32),
             "b": (rng.standard_normal((NSTAGE, D)) * 0.1).astype(np.float32)},
            rng.standard_normal((NMB, MB, D)).astype(np.float32))


@pytest.fixture(scope="module")
def mesh4():
    """(JAX references, the four ranks' results, the checkpoint dir,
    params, payload, the full fine-tuning checkpoint dir). The ranks start
    first and run while the parent computes JAX's references."""
    payload, jobs, params, batches = {}, {}, {}, {}
    for arch in dict.fromkeys(ARCHS + FT_ARCHS + (MOE,)):
        cfg = jax_smoke_config(arch)
        params[arch] = japi.init_params(cfg, jax.random.PRNGKey(0))
        batches[arch] = lm_batch(cfg, batch=8, seq=16)
    jcfg6 = dataclasses.replace(jax_smoke_config(MOE), **DFF)
    params["dff"] = japi.init_params(jcfg6, jax.random.PRNGKey(0))
    tmp = tempfile.TemporaryDirectory()
    ft_dir = tempfile.TemporaryDirectory()

    def cell(name, arch, sp=False, mesh="2x2", ref=None, batch=None,
             p="", **kw):
        payload[name] = dict(case="train", arch=arch, seq_parallel=sp,
                             mesh=mesh, params=_np(params[p or arch]),
                             batch=runner.np_batch(batches[arch]
                                                   if batch is None
                                                   else batch), **kw)
        if ref is not None:
            jobs[ref] = (arch, params[p or arch],
                         batches[arch] if batch is None else batch,
                         kw.get("method", "gsoft"), kw.get("over"))

    for arch in ARCHS:
        for sp in (False, True):
            cell(f"train/{arch}/{sp}", arch, sp, ref=arch)
        payload[f"decode/{arch}"] = dict(case="decode", arch=arch,
                                         mesh="2x2", params=_np(params[arch]),
                                         batch=8, max_len=32)
    for arch, sp, remat in RAGGED_CELLS:
        cell(f"train/ragged/{arch}", arch, sp, remat=remat,
             ref=f"ragged/{arch}", batch=_ragged(batches[arch]))
    for arch in FT_ARCHS:
        for sp in (False, True):
            extra = (dict(ckpt=["1x4"], dir=ft_dir.name)
                     if arch == "qwen2-72b" and not sp else {})
            cell(f"full/{arch}/{sp}", arch, sp, ref=f"full/{arch}",
                 method="full", **extra)
    for method in ("gsoft", "full"):
        for sp in (False, True):
            cell(f"moe/{method}/{sp}", MOE, sp, ref=f"moe/{method}",
                 method=method)
    cell("moe/ragged", MOE, ref="moe/ragged", method="full",
         batch=_ragged(batches[MOE]))
    cell("moe/dff", MOE, mesh="1x4", ref="moe/dff", p="dff", over=DFF)
    payload[f"decode/{MOE}"] = dict(case="decode", arch=MOE, mesh="2x2",
                                    params=_np(params[MOE]), batch=8,
                                    max_len=32)
    for name, argv in LAUNCHES.items():
        payload[f"launch/{name}"] = dict(case="launch", argv=argv + [
            "--smoke", "--mesh", "2,2", "--microbatches", "2", "--steps",
            "3", "--batch", "8", "--seq", "16", "--block-size", "8",
            "--device", "cpu"])
    payload["ckpt"] = dict(case="ckpt", arch="qwen2-72b", save_on="2x2",
                           restore_on=["4x1", "1x4"], dir=tmp.name,
                           params=_np(params["qwen2-72b"]))
    rng = np.random.default_rng(1)
    payload["psum"] = dict(case="psum", mesh="2x2", leaves={
        "w": rng.standard_normal((4, 16, 16)).astype(np.float32),
        "b": rng.standard_normal((4, 7)).astype(np.float32)})
    gp, x = _gpipe_params()
    payload["gpipe"] = dict(case="gpipe", params=gp, x=x)
    ranks = runner.Spawned(4, payload)
    ref = {"train": {k: _jax_train(*v) for k, v in jobs.items()},
           "decode": {a: _jax_decode(a, params[a]) for a in ARCHS + (MOE,)}}
    ranks = ranks.collect()
    yield ref, ranks, tmp.name, params, payload, ft_dir.name
    tmp.cleanup()
    ft_dir.cleanup()


@pytest.mark.parametrize("sp", (False, True), ids=("dp_tp", "seq_parallel"))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_jax_single_device(mesh4, arch, sp):
    """(2, 2): every rank's losses within JAX's rtol = atol = 2e-3 of the
    single-device run; the adapters moved."""
    ref, ranks = mesh4[0], mesh4[1]
    for r in ranks:
        _check_cell(r[f"train/{arch}/{sp}"], ref["train"][arch])
    if arch == "qwen2-72b":       # each rank holds half the q heads' columns
        cfg = get_smoke_config(arch)
        assert ranks[0][f"train/{arch}/{sp}"]["wq"][-1] == \
            cfg.num_heads * cfg.d_head // 2


@pytest.mark.parametrize("arch, sp, remat", RAGGED_CELLS)
def test_mesh_training_with_padding_matches_jax_single_device(mesh4, arch,
                                                               sp, remat):
    """A ragged mask (a data rank with no valid token in one microbatch):
    JAX's loss is the masked mean over each GLOBAL microbatch, so every
    rank's losses and AdamW first moments on (2, 2) match JAX's
    single-device step as in the unpadded cells (qwen2 under remat "full",
    its row-split slices gathered again in the backward)."""
    ref, ranks = mesh4[0], mesh4[1]
    for r in ranks:
        _check_cell(r[f"train/ragged/{arch}"], ref["train"][f"ragged/{arch}"])


def test_checkpoint_saved_on_a_mesh_is_read_by_jax(mesh4):
    """The (2, 2) save gathers every leaf whole: JAX's restore returns the
    params exactly."""
    d, params = mesh4[2], mesh4[3]
    got = JaxCheckpoints(d).restore(params["qwen2-72b"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params["qwen2-72b"])):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


def test_save_on_a_mesh_without_blocking(mesh4):
    """``save(blocking=False)`` on (2, 2): after ``wait()`` every rank
    reads the new step back, its own slice bit for bit."""
    assert all(r["ckpt"]["async"] is True for r in mesh4[1])


@pytest.mark.parametrize("mesh", ("4x1", "1x4"))
def test_elastic_restore_onto_another_mesh(mesh4, mesh):
    """Saved on (2, 2), restored onto (4, 1) (whole) and (1, 4) (a quarter
    of wq's columns a rank): bit for bit each rank's slice."""
    ranks = mesh4[1]
    cfg = get_smoke_config("qwen2-72b")
    for r in ranks:
        assert r["ckpt"][mesh] is True
        (shape,) = r["ckpt"][mesh + "_shapes"].values()
        assert shape[-1] == cfg.num_heads * cfg.d_head // (
            4 if mesh == "1x4" else 1)


def test_compressed_psum_mean_over_data(mesh4):
    """Each rank's mean over its 'data' pair is the pair's exact mean
    within JAX's 1e-2 (int8 codes, one scale a leaf)."""
    ranks, payload = mesh4[1], mesh4[4]
    leaves = payload["psum"]["leaves"]
    for rank, r in enumerate(ranks):
        m = rank % 2                   # (data, model) = divmod(rank, 2)
        for k, v in leaves.items():
            exact = (v[m] + v[2 + m]) / 2
            np.testing.assert_allclose(r["psum"]["mean"][k], exact,
                                       atol=1e-2 * np.abs(v).max())
            assert np.isfinite(r["psum"]["err"][k]).all()


def test_ef_compress_equals_jax_bit_for_bit():
    """Codes and scales equal JAX's exactly, error buffers to fp32
    rounding, two rounds (the second adds the first's error)."""
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((33, 17)).astype(np.float32),
         "b": {"c": (rng.standard_normal(64) * 1e-3).astype(np.float32)}}
    jerr = jcomp.init_error_buffer(jax.tree.map(jnp.asarray, g))
    terr = tcomp.init_error_buffer(jax.tree.map(torch.as_tensor, g))
    for _ in range(2):
        jq, js, jerr = jcomp.ef_compress(jax.tree.map(jnp.asarray, g), jerr)
        tq, ts, terr = tcomp.ef_compress(jax.tree.map(torch.as_tensor, g),
                                         terr)
        for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(tq)):
            assert np.array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(ts)):
            assert np.array_equal(np.asarray(a, np.float32),
                                  np.asarray(b.numpy(), np.float32))
        for a, b in zip(jax.tree.leaves(jerr), jax.tree.leaves(terr)):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


def test_gpipe_matches_the_stages_in_sequence(mesh4):
    """Outputs on every rank and each rank's stage gradients of sum(out^2)
    equal the sequential stages' (autograd, f32)."""
    ranks = mesh4[1]
    gp, x = _gpipe_params()
    w = torch.tensor(gp["w"], requires_grad=True)
    b = torch.tensor(gp["b"], requires_grad=True)
    h = torch.tensor(x)
    for s in range(NSTAGE):
        h = torch.tanh(h @ w[s] + b[s])
    (h ** 2).sum().backward()
    for r in ranks:
        got = r["gpipe"]
        s = got["stage"]
        np.testing.assert_allclose(got["out"], h.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(got["grads"]["w"], w.grad[s].numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(got["grads"]["b"], b.grad[s].numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS + (MOE,))
def test_decode_with_a_data_axis_matches_jax(mesh4, arch):
    """(2, 2): four rows a rank, their logits gathered over 'data' equal
    JAX's single-device decode within 5e-2 and their greedy tokens JAX's
    exactly (the MoE decoder with its experts split over 'model')."""
    ref, ranks = mesh4[0], mesh4[1]
    for r in ranks:
        got = r[f"decode/{arch}"]
        assert got["rows"] == 4
        assert np.isfinite(got["logits"]).all()
        np.testing.assert_allclose(got["logits"], ref["decode"][arch],
                                   rtol=5e-2, atol=5e-2)
        assert np.array_equal(got["tokens"][:, 0],
                              ref["decode"][arch][:, -1].argmax(-1))


@pytest.mark.parametrize("sp", (False, True), ids=("dp_tp", "seq_parallel"))
@pytest.mark.parametrize("arch", FT_ARCHS)
def test_full_finetuning_on_a_mesh_matches_jax(mesh4, arch, sp):
    """Full fine-tuning on (2, 2): every rank's losses, grad norms and
    first moments (its shards of the params' moments against the same
    blocks of JAX's) match JAX's single-device step: the replicated leaves
    read in a split block, and under ``seq_parallel`` the residual
    stream's norms, sum their shares over 'model'; tied embeddings
    (gemma-7b) are whole. Each rank holds half the split leaves."""
    ref, ranks = mesh4[0], mesh4[1]
    for r in ranks:
        got = r[f"full/{arch}/{sp}"]
        _check_cell(got, ref["train"][f"full/{arch}"])
        assert got["gather_bytes"] == {}        # no rotation, no gather
        split = [k for k, w in got["windows"].items()
                 if any(n != m for (_, n), m in
                        zip(w, ref["train"][f"full/{arch}"][1][k].shape))]
        assert split


@pytest.mark.parametrize("sp", (False, True), ids=("dp_tp", "seq_parallel"))
@pytest.mark.parametrize("method", ("gsoft", "full"))
def test_moe_split_by_experts_matches_jax(mesh4, method, sp):
    """qwen3-moe (smoke: E 8, top 2) on (2, 2), its experts split over
    'model' (each rank holds 4: routing global, the partial combines
    summed), under GSOFT b = 8 (the expert stacks' adapters split with
    them) and under full fine-tuning: losses, moments and grad norms
    against JAX's single-device step. Under GSOFT a rank gathers no expert
    stack and rotates each local stack in one ``gs_diff_rows`` call."""
    ref, ranks = mesh4[0], mesh4[1]
    E = get_smoke_config(MOE).moe_experts
    for rank, r in enumerate(ranks):
        got = r[f"moe/{method}/{sp}"]
        _check_cell(got, ref["train"][f"moe/{method}"])
        m = rank % 2
        assert got["experts"] == (m * E // 2, E // 2)
        assert got["moe_wi"][1] == E // 2
        # attention's row-split wo is gathered slice by slice; no expert
        # stack is
        assert not [k for k in got["gather_bytes"] if "/moe/" in k]
        if method == "gsoft":
            # 6 stacks rotate in place (wq, wk, wv; the experts' wi, wg,
            # wo) a forward: one call each, 2 microbatches, 3 steps (the
            # row-split attention wo rotates one gathered slice at a time)
            assert len(got["gs_calls"]) == 6 * 2 * 3
            moe_rows = [c for c in got["gs_calls"] if c[0] == 2 * E // 2]
            assert len(moe_rows) == 3 * 2 * 3


def test_moe_with_a_ragged_mask_weights_the_aux_loss_by_rows(mesh4):
    """A ragged mask on (2, 2) under full fine-tuning: the cross entropy
    is the global microbatch's masked mean (a rank weighted by its valid
    tokens), the load-balance loss a mean over its rows (a rank weighted
    by its rows); losses, moments and grad norms equal JAX's."""
    ref, ranks = mesh4[0], mesh4[1]
    for r in ranks:
        _check_cell(r["moe/ragged"], ref["train"]["moe/ragged"])


def test_binding_clip_uses_the_global_norm(mesh4):
    """grad_clip (1.0) under the grad norm of every cell, so the clip
    binds: with the expert adapters split by experts (qwen3-moe GSOFT) and
    with the params split (full fine-tuning), every rank clips by the
    whole tree's norm (the split leaves' squares summed over 'model'), so
    its grad norms and moments equal JAX's; a rank's own norm would scale
    its moments apart from the other ranks' and JAX's."""
    ref, ranks = mesh4[0], mesh4[1]
    for cell in ("moe/gsoft", "full/qwen2-72b", "full/gemma-7b"):
        assert min(ref["train"][cell][2]) > 2 * CLIP
        for r in ranks:
            _check_cell(r[cell + "/False"], ref["train"][cell])


def test_moe_split_by_d_ff_matches_jax(mesh4):
    """6 experts on (1, 4): E does not divide, each expert's d_ff does, so
    every rank runs every expert's slots on its quarter of the columns and
    the partial combines are summed; GSOFT losses, moments and grad norms
    equal JAX's. wi / wg rotate in place, the row-split wo is gathered one
    (layer, expert) slice at a time."""
    ref, ranks = mesh4[0], mesh4[1]
    cfg = get_smoke_config(MOE)
    for r in ranks:
        got = r["moe/dff"]
        _check_cell(got, ref["train"]["moe/dff"])
        assert got["experts"] == (0, 6)
        assert got["moe_wi"][1:] == (6, cfg.d_model, cfg.expert_d_ff // 4)
        assert {k for k in got["gather_bytes"] if "/moe/" in k} == \
            {"layers/moe/wo"}


def test_full_finetuning_checkpoint_restores_onto_another_mesh(mesh4):
    """The full fine-tuning state saved on (2, 2) (params and both
    moments gathered whole, one writer) restores onto (1, 4) bit for bit
    each rank's slice, and JAX's ``CheckpointManager.restore`` reads the
    params whole."""
    ranks, params, d = mesh4[1], mesh4[3], mesh4[5]
    cfg = get_smoke_config("qwen2-72b")
    for r in ranks:
        ck = r["full/qwen2-72b/False"]["ckpt"]
        assert ck["1x4"] is True
        assert ck["1x4_wq"][-1] == cfg.num_heads * cfg.d_head // 4
    whole = ranks[0]["full/qwen2-72b/False"]["ckpt"]["whole"]
    got = JaxCheckpoints(d).restore({"trainable": params["qwen2-72b"]})
    flat = jpeft.flatten_paths(got["trainable"])
    assert flat.keys() == whole.keys()
    for k, v in whole.items():
        assert np.array_equal(np.asarray(flat[k], np.float32),
                              v.astype(np.float32)), k


@pytest.mark.parametrize("name", ("act_btd", "act_ff", "act_heads",
                                  "act_inner", "logits", "nope"))
@pytest.mark.parametrize("sp", (False, True))
def test_act_spec_equals_jax(name, sp):
    """``act_spec`` is JAX's table entry for entry, seq_parallel on and
    off, on (2, 2) and (2, 2, 2) meshes."""
    from jax.sharding import AbstractMesh
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model"))):
        for arch in ARCHS:
            jcfg = dataclasses.replace(jax_smoke_config(arch),
                                       seq_parallel=sp)
            tcfg = dataclasses.replace(get_smoke_config(arch),
                                       seq_parallel=sp)
            want = JaxRules(jcfg, AbstractMesh(shape, axes)).act_spec(name)
            got = ShardingRules(tcfg, dict(zip(axes, shape))).act_spec(name)
            assert (None if want is None else tuple(want)) == got


@pytest.mark.parametrize("flags, match", [
    (["--mesh", "2,1"], "needs 2 ranks"),
    (["--mesh", "1,1,4"], "needs 4 ranks"),
    (["--mesh", "2"], "D,M or P,D,M"),
])
def test_launcher_refuses_a_mesh_the_world_does_not_fit(flags, match):
    """In one process (a world of one) a mesh of more ranks is refused,
    naming both sizes; a malformed shape is refused."""
    with pytest.raises(ValueError, match=match):
        tlaunch.main(["--arch", "qwen2-72b", "--smoke", "--steps", "1",
                      "--device", "cpu"] + flags)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_trains_on_a_mesh(mesh4, name):
    """``launch/train.py --mesh 2,2`` in four ranks: full fine-tuning of
    qwen2-72b and GSOFT on qwen3-moe (its experts split): each runs its 3
    steps, global rank 0 alone logs, the loss finite."""
    outs = [r[f"launch/{name}"] for r in mesh4[1]]
    assert all(o["rc"] == 0 for o in outs)
    assert "final loss" in outs[0]["out"]
    assert not any(o["out"] for o in outs[1:])
    line = outs[0]["out"].strip().splitlines()[-1]
    assert np.isfinite(float(line.split()[2]))
