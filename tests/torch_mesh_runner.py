"""Rank worker of tests/test_torch_mesh.py: training on a (data x model)
mesh, elastic checkpoints, the compressed gradient mean, GPipe and decode
with a data axis, one gloo process per rank on the CPU, JAX-free (the
parent computes JAX's single-device references and hands over numpy
params and batches).

``spawn(world, payload)`` (``torch_tp_runner.spawn``'s mechanics) starts
``world`` ranks; each joins one process group, runs every case of
``payload`` and returns {case: result}; the parent gets one dict per rank
in rank order.
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


def _train(spec, meshes):
    """3 GSOFT steps (2 microbatches) on the named mesh -> losses and how
    far the adapters moved."""
    from repro_torch import optim
    from repro_torch.config import get_smoke_config
    from repro_torch.core import peft as tpeft
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.train.steps import TrainStepConfig, build_train_step
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              seq_parallel=spec["seq_parallel"],
                              remat=spec.get("remat", "none"))
    mesh = meshes[spec["mesh"]]
    rt = ModelRuntime(cfg, _tree(spec["params"]), device="cpu", mesh=mesh)
    pcfg = tpeft.PEFTConfig(method="gsoft", block_size=BLOCK)
    ocfg = optim.OptimizerConfig(learning_rate=1e-3)
    adapters = tpeft.init_peft(pcfg, rt.param_shapes, device="cpu")
    start = {k: v.clone() for k, v in tpeft.flatten_paths(adapters).items()}
    opt = optim.init(ocfg, adapters)
    step = build_train_step(cfg, TrainStepConfig(peft=pcfg, opt=ocfg,
                                                 num_microbatches=2), mesh)
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    losses = []
    for _ in range(3):
        adapters, opt, m = step(rt.params, adapters, opt, batch)
        losses.append(float(m["loss"]))
    moved = sum(float((v - start[k]).abs().sum())
                for k, v in tpeft.flatten_paths(adapters).items())
    mu = {k: v.numpy() for k, v in tpeft.flatten_paths(opt["mu"]).items()}
    return {"losses": losses, "moved": moved, "mu": mu,
            "wq": tuple(rt.params["layers"]["attn"]["wq"].shape)
            if "attn" in rt.params.get("layers", {}) else None}


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
    _, logits, _ = step(rt.params, None, tokens, state,
                        torch.tensor(0, dtype=torch.int64))
    return {"logits": gather_rows(mesh, logits.float()).numpy(),
            "rows": tokens.shape[0]}


CASES = {"train": _train, "ckpt": _ckpt, "psum": _psum, "gpipe": _gpipe,
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


def spawn(world, payload, timeout=300):
    """Run ``payload`` on ``world`` gloo ranks; [rank 0's result, ...]."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, port, payload, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [v["error"] for v in got.values() if "error" in v]
    assert not errors, errors[0]
    return [got[r] for r in range(world)]


def np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}
