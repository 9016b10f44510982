"""Rank worker of tests/test_torch_tp.py: one process per rank over gloo on
the CPU, JAX-free (the parent computes JAX's reference tokens and hands
over numpy params, int8 codes and adapters).

``spawn(world, payload)`` starts ``world`` ranks; each builds
``serve_mesh(world, device="cpu")``, runs every case of ``payload`` on its
shards and returns {case: result} to the parent, which gets one dict per
rank in rank order.
"""
from __future__ import annotations

import os
import socket
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MAX_LEN = 40


def _requests(names, n, seed, max_new=6):
    """``n`` requests of 8 prompt tokens (one prefill shape: JAX's
    reference compiles once), round-robin over ``names`` and the base."""
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, 200, size=8).tolist(),
             "max_new_tokens": max_new,
             "adapter": (names + [None])[i % (len(names) + 1)]}
            for i in range(n)]


def _serve(eng, reqs):
    rids = [eng.add_request(**r) for r in reqs]
    out = eng.run()
    return [out[r] for r in rids]


def _mamba_shapes(rt, state):
    """Shapes of the rank's first Mamba weights and SSD state."""
    p = rt.params
    m = (p["layers"] if "layers" in p else p["blocks"])["mamba"]
    out = {"wz": tuple(m["wz"].shape), "wo": tuple(m["out_proj"]["wo"].shape),
           "ssm": tuple(state["mamba"]["ssm"].shape),
           "conv": tuple(state["mamba"]["conv"].shape)}
    if "shared_attn" in p:
        out["shared_wq"] = tuple(p["shared_attn"]["attn"]["wq"].shape)
    return out


def _local_shapes(rt, state_key, state):
    p = rt.params
    q = lambda t: tuple((t.q if hasattr(t, "q") else t).shape)  # noqa: E731
    out = {k: q(p["layers"]["attn"][k]) for k in ("wq", "wk", "wo")}
    ffn = "moe" if "moe" in p["layers"] else "mlp"
    out.update({f"{ffn}_{k}": q(p["layers"][ffn][k]) for k in ("wi", "wo")})
    out["embed"] = q(p["embed"]["table"])
    out["lm_head"] = q(p["lm_head"]["w"])
    out["kv"] = tuple(state[state_key]["k"].shape)
    return out


def _bank_shapes(rt):
    """Shapes of the bank's first GSOFT factor stack for wq and MLP wo."""
    tree = rt.bank.tree["layers"]
    return {"attn_wq": tuple(tree["attn"]["wq"]["gsoft"]["L"].shape),
            "mlp_wo": tuple(tree["mlp"]["wo"]["gsoft"]["L"].shape)}


def _codes_equal(rt, whole, cfg, mesh):
    """Are the rank's int8 codes and scales exactly its slice of the
    ``whole`` quantized tree's?"""
    from repro_torch.core import peft as tpeft
    from repro_torch.sharding import specs
    local = specs.place(mesh, whole,
                        specs.ShardingRules(cfg, mesh).serve_params_tree(whole))
    mine = tpeft.flatten_paths(rt.params)
    ref = tpeft.flatten_paths(local)
    return all(torch.equal(mine[k].q, ref[k].q) and
               torch.equal(mine[k].scale, ref[k].scale)
               for k in ref if hasattr(ref[k], "q"))


def _ckpt_case(spec, cfg, mesh):
    """``load_quantized(mesh=)`` from a quantized and from a float
    checkpoint of the whole tree: codes equal to the slice of the whole's,
    and the quantized one served through the int8 bank."""
    from repro_torch import convert, quant
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.runtime import ModelRuntime
    whole_q = convert.quant_params_from_numpy(spec["qparams"], "cpu")
    params = convert.params_from_numpy(spec["params"], "cpu")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        qdir, fdir = os.path.join(d, "q"), os.path.join(d, "f")
        CheckpointManager(qdir).save_quantized(
            0, whole_q, quant.QuantConfig(mode="int8"))
        CheckpointManager(fdir).save(0, params)
        rt = ModelRuntime.load_quantized(qdir, cfg, device="cpu", mesh=mesh)
        frt = ModelRuntime.load_quantized(fdir, cfg, device="cpu", mesh=mesh)
    out["codes_equal"] = _codes_equal(rt, whole_q, cfg, mesh)
    out["float_codes_equal"] = _codes_equal(
        frt, quant.quantize_params(params, quant.QuantConfig(mode="int8")),
        cfg, mesh)
    out["wq"] = tuple(rt.params["layers"]["attn"]["wq"].q.shape)
    return rt, out


def _merge_case(spec, cfg, mesh):
    """An offline GSOFT merge under the mesh, each weight merged and cut
    before the next (drawn from the seed, as ``--peft-demo --tp`` does,
    and from a passed tree), against the unsplit merge's tokens."""
    from repro_torch import convert
    from repro_torch.core import peft as tpeft
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.launch.serve import make_demo_adapters
    from repro_torch.serve.engine import ServeEngine
    pc = tpeft.PEFTConfig(method="gsoft", block_size=8)
    params = convert.params_from_numpy(spec["params"], "cpu")
    ads = make_demo_adapters(["m"], params, pc, "cpu")["m"]
    reqs = _requests([], spec["n"], spec["seed"])
    out = {}
    for how, tree in (("seed", None), ("tree", params)):
        toks = []
        for m in (None, mesh):
            rt = ModelRuntime(cfg, tree, seed=0, device="cpu", mesh=m,
                              adapters=ads, peft_cfg=pc)
            toks.append(_serve(ServeEngine(rt, max_batch=3, max_len=MAX_LEN,
                                           eos_id=-1), reqs))
        out[how] = toks
    out["wq"] = tuple(rt.params["layers"]["attn"]["wq"].shape)
    return out


def _probe(rt, cfg):
    """One decode step of 8 rows from position 0 (tokens 1..8): logits
    and greedy tokens, as JAX's ``build_decode_step`` gives them."""
    from repro_torch.models import api
    from repro_torch.train.steps import build_decode_step
    tokens = torch.arange(1, 9, dtype=torch.int64)[:, None]
    state = api.family_ops(cfg).init_decode_state(cfg, 8, 16, "cpu",
                                                  tp=rt.shard)
    tok, logits, _ = build_decode_step(cfg, tp=rt.shard)(
        rt.params, None, tokens, state, torch.tensor(0))
    return {"logits": logits.float().numpy(), "tokens": tok[:, 0].numpy()}


def _launch(spec):
    """The serve launcher in this rank (the process group is up: the
    launcher's mesh joins it); rank 0's report."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(spec["argv"])
    return {"rc": rc, "out": buf.getvalue()}


def _case(name, spec, mesh, rank):
    from repro_torch import convert, quant
    from repro_torch.config import get_smoke_config
    from repro_torch.core import peft as tpeft
    from repro_torch.core.runtime import ModelRuntime
    from repro_torch.launch.serve import drive_streaming
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    cfg = get_smoke_config(spec.get("arch", "qwen2-72b"))
    if spec.get("argv"):
        return _launch(spec)
    if spec.get("merge"):
        return _merge_case(spec, cfg, mesh)
    out = {}
    if spec.get("ckpt"):
        rt, out = _ckpt_case(spec, cfg, mesh)
    elif spec.get("qparams") is not None:
        params = convert.quant_params_from_numpy(spec["qparams"], "cpu")
    else:
        params = convert.params_from_numpy(spec["params"], "cpu")
    if not spec.get("ckpt"):
        rt = ModelRuntime(cfg, params, device="cpu", mesh=mesh)
    if spec.get("quantize"):            # quantize the placed f32 shards
        whole = quant.quantize_params(
            convert.params_from_numpy(spec["params"], "cpu"),
            quant.QuantConfig(mode="int8"))
        rt = rt.quantized("int8")
        out["codes_equal"] = _codes_equal(rt, whole, cfg, mesh)
    targets = spec.get("targets")
    cfgs = {n: tpeft.PEFTConfig(method=m, block_size=8,
                                **({"target_patterns": targets}
                                   if targets else {}))
            for n, m in spec["methods"].items()}
    if spec.get("probe"):       # one decode step of 8 rows, no bank
        out["probe"] = _probe(rt, cfg)
    if cfgs:
        ads = convert.adapters_from_numpy(spec["adapters"], "cpu")
        rt = rt.attach(ads, cfgs, hbm_budget=spec.get("budget"))
        if "gsoft" in spec["methods"].values() and not targets:
            out["bank"] = _bank_shapes(rt)
    names = list(cfgs)
    reqs = _requests(names, spec["n"], spec["seed"])
    if not reqs:
        return out
    if cfg.family != "decoder":
        eng = ServeEngine(rt, max_batch=3, max_len=MAX_LEN, eos_id=-1)
        out["local"] = _mamba_shapes(rt, eng._state)
    elif spec.get("paged"):
        eng = PagedServeEngine(rt, max_batch=3, max_len=MAX_LEN, eos_id=-1,
                               page_size=8, prefill_chunk=8)
        out["local"] = _local_shapes(rt, "pages", eng._state)
    else:
        eng = ServeEngine(rt, max_batch=3, max_len=MAX_LEN, eos_id=-1)
        out["local"] = _local_shapes(rt, "kv", eng._state)
    out["tokens"] = _serve(eng, reqs)
    out["bank_gather_bytes"] = rt.shard.bank_gather_bytes
    if spec.get("stream"):
        # each rank's own clock runs at its own rate: only rank 0's
        # admissions, broadcast each tick, keep the ranks in step
        eng = ServeEngine(rt, max_batch=3, max_len=MAX_LEN, eos_id=-1)
        arrivals = np.cumsum(np.full(len(reqs), 0.002 * (1 + 3 * rank)))
        res = drive_streaming(eng, reqs, arrivals,
                              sync=rt.shard.broadcast_ints)
        out["stream"] = [res[r] for r in sorted(res)]
    return out


def _rank(rank, world, port, payload, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        from repro_torch.distrib.tp import serve_mesh
        mesh = serve_mesh(world, device="cpu")
        res = {name: _case(name, spec, mesh, rank)
               for name, spec in payload.items()}
        queue.put((rank, res))
    except Exception:                                # noqa: BLE001
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world, payload, timeout=240):
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
