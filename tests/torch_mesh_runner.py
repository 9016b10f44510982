"""Rank worker of tests/test_torch_mesh.py: training on a (data x model)
mesh (PEFT and full fine-tuning, the MoE family split by experts or by
their d_ff), elastic checkpoints, the compressed gradient mean, GPipe and
decode with a data axis, one gloo process per rank on the CPU, JAX-free (the
parent computes JAX's single-device references and hands over numpy
params and batches).

``spawn(world, payload)`` (``torch_tp_runner.spawn``'s mechanics) starts
``world`` ranks; each joins one process group, runs every case of
``payload`` and returns {case: result}; the parent gets one dict per rank
in rank order. ``Spawned`` starts them and lets the parent work until it
``collect()``s.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BLOCK = 8


def _tree(params_np):
    from repro_torch import convert
    return convert.params_from_numpy(params_np, "cpu")


def _windows(mesh, spec, shape):
    """[(start, length)] of each dim of a rank's block of ``shape`` under
    ``spec``, in the whole leaf (what the parent slices JAX's leaf by)."""
    from repro_torch.sharding.specs import mesh_shape
    sizes = mesh_shape(mesh)
    out = []
    for dim, n in enumerate(shape):
        ax = tuple(spec)[dim] if dim < len(tuple(spec)) else None
        idx = 0
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else tuple(ax)):
            idx = idx * sizes[a] + mesh.get_local_rank(a)
        out.append((idx * n, n))
    return out


def _train(spec, meshes):
    """3 AdamW steps (2 microbatches) of GSOFT (b = 8) or full fine-tuning
    on the named mesh -> losses, grad norms, how far the trainable tree
    moved, AdamW's first moments (the rank's blocks, with their windows in
    the whole leaves), the bytes gathered to rotate each weight and the GS
    rotations run; ``ckpt``: the trained state saved on this mesh and
    restored onto the named others."""
    from repro_torch import optim
    from repro_torch.config import get_smoke_config
    from repro_torch.core import peft as tpeft
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.kernels import ops
    from repro_torch.sharding import specs
    from repro_torch.train.steps import TrainStepConfig, build_train_step
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              seq_parallel=spec["seq_parallel"],
                              remat=spec.get("remat", "none"),
                              **spec.get("over", {}))
    mesh = meshes[spec["mesh"]]
    rt = ModelRuntime(cfg, _tree(spec["params"]), device="cpu", mesh=mesh)
    rules = specs.ShardingRules(cfg, mesh)
    pcfg = tpeft.PEFTConfig(method=spec.get("method", "gsoft"),
                            block_size=BLOCK)
    ocfg = optim.OptimizerConfig(learning_rate=1e-3)
    if pcfg.is_peft:
        whole = tpeft.init_peft(pcfg, rt.param_shapes, device="cpu")
        t_spec = rules.adapters_tree(whole)
        trainable, frozen = specs.place(mesh, whole, t_spec), rt.params
    else:
        t_spec = rules.serve_params_tree(rt.param_shapes)
        trainable, frozen = rt.params, {}
    start = {k: v.clone() for k, v in tpeft.flatten_paths(trainable).items()}
    opt = optim.init(ocfg, trainable)
    step = build_train_step(cfg, TrainStepConfig(peft=pcfg, opt=ocfg,
                                                 num_microbatches=2), mesh)
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    calls = []
    rows = ops.gs_diff_rows
    ops.gs_diff_rows = lambda L, R, x: (calls.append(tuple(x.shape)),
                                        rows(L, R, x))[1]
    try:
        losses, norms = [], []
        for _ in range(3):
            trainable, opt, m = step(frozen, trainable, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        ops.gs_diff_rows = rows
    moved = sum(float((v - start[k]).abs().sum())
                for k, v in tpeft.flatten_paths(trainable).items())
    flat_spec = tpeft.flatten_paths(t_spec)
    mu = {k: v.numpy() for k, v in tpeft.flatten_paths(opt["mu"]).items()}
    out = {"losses": losses, "grad_norms": norms, "moved": moved, "mu": mu,
           "windows": {k: _windows(mesh, flat_spec[k], v.shape)
                       for k, v in mu.items()},
           "gather_bytes": dict(step.split.gather_bytes),
           "gs_calls": calls,
           "wq": tuple(rt.params["layers"]["attn"]["wq"].shape)
           if "attn" in rt.params.get("layers", {}) else None}
    if "moe" in rt.params.get("layers", {}):
        out["experts"] = step.split.shard.experts
        out["moe_wi"] = tuple(rt.params["layers"]["moe"]["wi"].shape)
    if spec.get("ckpt"):
        out["ckpt"] = _ft_ckpt(spec, cfg, meshes, rt.param_shapes,
                               {"trainable": trainable, "opt": opt},
                               rules.opt_state_tree(opt, t_spec), t_spec)
    return out


def _ft_ckpt(spec, cfg, meshes, shapes, state, opt_spec, t_spec):
    """A full fine-tuning state saved on its mesh (gathered whole, one
    writer), restored onto each of ``spec["ckpt"]``'s meshes: is every
    rank's restore bit for bit its slice of the whole state? Returns the
    whole trainable tree too (numpy, for JAX's restore)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sharding import specs
    mesh = meshes[spec["mesh"]]
    tree_spec = {"trainable": t_spec, "opt": opt_spec}
    mgr = CheckpointManager(spec["dir"])
    mgr.save(3, state, mesh=mesh, spec_tree=tree_spec)
    whole = _gather_tree(mesh, state, tree_spec)
    out = {"whole": {k: v.numpy() for k, v in _flat(whole["trainable"])}}
    for name in spec["ckpt"]:
        m = meshes[name]
        rules = specs.ShardingRules(cfg, m)
        ts = rules.serve_params_tree(shapes)
        sp = {"trainable": ts, "opt": rules.opt_state_tree(whole["opt"], ts)}
        got = dict(_flat(mgr.restore(whole, device="cpu", mesh=m,
                                     spec_tree=sp)))
        want = dict(_flat(specs.place(m, whole, sp)))
        out[name] = (got.keys() == want.keys() and
                     all(torch.equal(got[k], want[k]) for k in got))
        out[name + "_wq"] = tuple(got["trainable/layers/attn/wq"].shape)
    return out


def _gather_tree(mesh, tree, spec_tree):
    from repro_torch.sharding import specs
    if isinstance(tree, dict):
        return {k: _gather_tree(mesh, v, spec_tree[k]) for k, v in
                tree.items()}
    return specs.gather_leaf(mesh, tree, spec_tree)


def _ckpt(spec, meshes):
    """Save the placed params on one mesh; restore them onto the others;
    is each restore exactly the rank's slice of the whole tree?"""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import get_smoke_config
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.sharding import specs
    cfg = get_smoke_config(spec["arch"])
    whole = _tree(spec["params"])
    mesh = meshes[spec["save_on"]]
    rt = ModelRuntime(cfg, whole, device="cpu", mesh=mesh)
    mgr = CheckpointManager(spec["dir"])
    mgr.save(3, rt.params, mesh=mesh,
             spec_tree=specs.ShardingRules(cfg, mesh).serve_params_tree(whole))
    out = {}
    for name in spec["restore_on"]:
        m = meshes[name]
        sp = specs.ShardingRules(cfg, m).serve_params_tree(whole)
        got = mgr.restore(whole, device="cpu", mesh=m, spec_tree=sp)
        want = specs.place(m, whole, sp)
        a = {k: v for k, v in _flat(got)}
        b = {k: v for k, v in _flat(want)}
        out[name] = (a.keys() == b.keys() and
                     all(torch.equal(a[k], b[k]) for k in a))
        out[name + "_shapes"] = {k: tuple(v.shape) for k, v in a.items()
                                 if k.endswith("attn/wq")}
    # a save that does not block: only the writer keeps host copies, and
    # every rank meets it again in wait() before reading
    sp = specs.ShardingRules(cfg, mesh).serve_params_tree(whole)
    mgr.save(4, rt.params, blocking=False, mesh=mesh, spec_tree=sp)
    mgr.wait()
    got = _flat(mgr.restore(whole, step=4, device="cpu", mesh=mesh,
                            spec_tree=sp))
    want = dict(_flat(specs.place(mesh, whole, sp)))
    out["async"] = (mgr.latest_step() == 4 and
                    all(torch.equal(v, want[k]) for k, v in got))
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _psum(spec, meshes):
    """``compressed_psum_mean`` over 'data' of rank-dependent leaves."""
    from repro_torch.optim import compressed_psum_mean, init_error_buffer
    mesh = meshes[spec["mesh"]]
    rank = dist.get_rank()
    g = {k: torch.as_tensor(v[rank]) for k, v in spec["leaves"].items()}
    red, err = compressed_psum_mean(g, init_error_buffer(g), mesh, ("data",))
    return {"mean": {k: v.numpy() for k, v in red.items()},
            "err": {k: v.numpy() for k, v in err.items()}}


def _gpipe(spec, meshes):
    """GPipe over the 'pipe' axis: outputs and this rank's stage gradients
    of sum(out^2)."""
    from repro_torch.sharding.pipeline import gpipe_forward, stage_slice
    mesh = meshes["pipe"]
    stacked = {k: torch.as_tensor(v) for k, v in spec["params"].items()}
    mine = {k: v.clone().requires_grad_(True)
            for k, v in stage_slice(stacked, mesh).items()}
    x = torch.as_tensor(spec["x"])

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    out = gpipe_forward(stage_fn, mine, x, mesh, axis="pipe")
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": {k: v.grad.numpy() for k, v in mine.items()},
            "stage": mesh.get_local_rank("pipe")}


def _decode(spec, meshes):
    """One decode step of the whole batch's rows split over 'data' (and
    the model over 'model'); the logits gathered back."""
    from repro_torch.config import get_smoke_config
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.models import api
    from repro_torch.train.steps import (build_decode_step, gather_rows,
                                         local_rows)
    cfg = get_smoke_config(spec["arch"])
    mesh = meshes[spec["mesh"]]
    rt = ModelRuntime(cfg, _tree(spec["params"]), device="cpu", mesh=mesh)
    tokens = local_rows(mesh, torch.ones((spec["batch"], 1), dtype=torch.int64))
    kw = {} if rt.shard is None else {"tp": rt.shard}
    state = api.family_ops(cfg).init_decode_state(
        cfg, tokens.shape[0], spec["max_len"], "cpu", **kw)
    step = build_decode_step(cfg, **kw)
    next_tok, logits, _ = step(rt.params, None, tokens, state,
                               torch.tensor(0, dtype=torch.int64))
    return {"logits": gather_rows(mesh, logits.float()).numpy(),
            "tokens": gather_rows(mesh, next_tok).numpy(),
            "rows": tokens.shape[0]}


def _launch(spec, meshes):
    """The training launcher in this rank with ``--mesh`` (the process
    group is up: the launcher's mesh joins it); what it printed."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(spec["argv"])
    return {"rc": rc, "out": buf.getvalue()}


CASES = {"train": _train, "launch": _launch, "ckpt": _ckpt, "psum": _psum, "gpipe": _gpipe,
         "decode": _decode}


def _meshes(world):
    """Every mesh the cases name, built once on every rank in one order."""
    from repro_torch.launch.mesh import make_axes_mesh, make_mesh
    out = {}
    for d in (1, 2, 4):
        if world % d == 0:
            out[f"{d}x{world // d}"] = make_mesh(d, world // d,
                                                 device_type="cpu")
    out["pipe"] = make_axes_mesh((world,), ("pipe",), device_type="cpu")
    return out


def _rank(rank, world, port, payload, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo")
        meshes = _meshes(world)
        res = {name: CASES[spec["case"]](spec, meshes)
               for name, spec in payload.items()}
        queue.put((rank, res))
    except Exception:                                # noqa: BLE001
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Spawned:
    """``world`` gloo ranks running ``payload``, started at once so the
    parent can compute its references meanwhile; ``collect()`` waits for
    them and returns [rank 0's result, ...]."""

    def __init__(self, world, payload, timeout=420):
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.timeout = timeout
        self.procs = [ctx.Process(target=_rank, args=(r, world, port, payload,
                                                      self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def collect(self):
        try:
            got = dict(self.queue.get(timeout=self.timeout)
                       for _ in self.procs)
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        errors = [v["error"] for v in got.values() if "error" in v]
        assert not errors, errors[0]
        return [got[r] for r in range(len(self.procs))]


def spawn(world, payload, timeout=420):
    """Run ``payload`` on ``world`` gloo ranks; [rank 0's result, ...]."""
    return Spawned(world, payload, timeout).collect()


def np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}
