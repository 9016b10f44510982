"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--out results/chip_smoke.json]

Phases (any failure exits non-zero; no phase catches and carries on):

1. device — refuse to run without CUDA; print the card's name and power limit
2. build  — compile every CUDA kernel of the port from ``src/repro_torch``
3. kernels — each kernel against its plain PyTorch version on the card at the
   serving path's shapes (qwen2-72b widths: decode rows, every prefill
   bucket the serve phase's prompts can take, the merge slabs), with times
   for the kernel, the plain version and a library yardstick (one dense
   matmul); the transpose kernel's launch variants (split over a cluster or
   not, one or several tokens per tile) must each be checked
3b. backward kernels — ``gs_fused_bwd`` and ``gs_fused_grads`` against their
   plain versions at every (T, d) the training path gives them (the weight
   slabs of the seven projections), bf16 and f32, with times, bounds and a
   partial library yardstick
4. serve  — full-width qwen2-72b, depth cut to 8 layers, bf16, random weights
   from a seed: 3 GSOFT adapters banked, 8 requests through ``ServeEngine``;
   the ``gs_fused_T`` kernel must have run
5. banked vs merged — full width at 2 layers in f32 (TF32 off): one adapter
   merged through ``gs_fused``, one prompt served both ways, equal greedy
   tokens and decode logits within tolerance
7. train  — full-width qwen2-72b, depth cut to 4 layers, bf16, remat
   "full": GSOFT (b = 32) on all seven projections, AdamW, steps of
   ``build_train_step`` on one fixed batch (the loss must fall), then 3
   steps of ``train()``; the forward and backward GS kernels must have run
   once per adapted weight slice and step
8. gradients — full width, 2 layers, f32, TF32 off: for GSOFT and Double
   GSOFT, the adapter gradients of one train step against a central
   difference of the loss along a seeded random direction (all four GS
   kernels run in these backward passes)
9. report — one JSON line of kernels, then the ``{"ok": true, ...}`` line

Imports nothing of JAX: the port is ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import peft as peft_lib  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import DataConfig, LMDataSource  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402
from repro_torch.serve.engine import ServeEngine, prompt_bucket  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import steps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor-core rate
              torch.float32: 67e12}     # fp32 outside the tensor cores
SERVE_LAYERS = 8
SERVE_MAX_LEN = 256
PROMPT_LENS = (16, 128)             # serve phase: prompt lengths drawn in this range
CHECK_LAYERS = 2
F32_TOL = 1e-4
# bf16: the kernel keeps the intermediate in fp32, the plain version rounds it
# to bf16 (2^-9 relative) and both round y once; |y| < 8 for unit-variance x
# and orthogonal Q, where one bf16 ulp is at most 2^-5.
BF16_TOL = 2.0 ** -4
LOGIT_TOL = 1e-3                    # f32 banked vs merged, relative to max|logit|
# backward dL, dR against the plain version, relative to max|ref|, in both
# dtypes: kernel and plain version compute every intermediate and sum in fp32
# from the same inputs (bf16 inputs are exact in fp32), so only the
# summation order differs; dx is held to F32_TOL / BF16_TOL as y is
GRAD_REL = 1e-4
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 256
TRAIN_STEPS = 6
TRAIN_LR = 1e-3
GRAD_LAYERS = 2
GRAD_BATCH, GRAD_SEQ = 2, 64
# central difference of an f32 loss, Richardson-extrapolated from steps h and
# h/2: h is set so that the loss moves by about FD_TARGET (1e4 f32 ulps of a
# loss near 12, so the rounding of the four losses adds a few 1e-4
# relative), with no adapter element moved by more than FD_MAX_STEP; the
# extrapolation removes the h^2 term (1-2 % at these steps in a reduced-width
# rehearsal), so 1e-2 leaves a margin over what remains
FD_TARGET = 1e-2
FD_MAX_STEP = 1e-2
FD_REL = 1e-2

KERNELS = {
    "gs_fused_T": dict(fn=gk.gs_fused_T, plain=gk.gs_fused_T_plain,
                       replaces="src/repro/kernels/gs_fused.py:163",
                       source="src/repro_torch/kernels/csrc/gs_fused_T.cu"),
    "gs_fused": dict(fn=gk.gs_fused, plain=gk.gs_fused_plain,
                     replaces="src/repro/kernels/gs_fused.py:157",
                     source="src/repro_torch/kernels/csrc/gs_fused.cu"),
    "gs_fused_bwd": dict(fn=gk.gs_fused_bwd, plain=gk.gs_fused_bwd_plain,
                         replaces="src/repro/kernels/gs_fused.py:206",
                         source="src/repro_torch/kernels/csrc/gs_fused_bwd.cu"),
    "gs_fused_grads": dict(fn=gk.gs_fused_grads, plain=gk.gs_fused_grads_plain,
                           replaces="src/repro/kernels/gs_fused.py:221",
                           source="src/repro_torch/kernels/csrc/gs_fused_bwd.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing + bounds
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets) -> float:
    """Mean ms per call over CUDA events, cycling ``arg_sets`` (several sets
    when one fits in L2, so the factors come from device memory as they do
    on the serving path, where every layer has its own)."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    est = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(200, max(3, 0.1 / est)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(B: int, T: int, d: int, b: int, dtype) -> tuple:
    """Least time for y = rotation(x): x read and y written once, the
    per-row factors read once; 4*B*T*d*b operations (two block stages of
    2*d*b each per token) at the dtype's peak rate."""
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * T * d + 2 * B * d * b) * es
    flops = 4 * B * T * d * b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _orth_factors(gen, B, r, b, dtype, device):
    a = torch.randn((B, 2, r, b, b), generator=gen, device=device) * 0.3
    k = a - a.transpose(-1, -2)
    eye = torch.eye(b, device=device)
    q = torch.linalg.solve(eye + k, eye - k).transpose(-1, -2)
    return q[:, 0].to(dtype).contiguous(), q[:, 1].to(dtype).contiguous()


def _dense(kernel: str, L, R, device):
    """Per-row dense M with x @ M == kernel(x): the rotation of the rows of
    the identity (built with the kernel, outside any timing)."""
    d = L.shape[1] * L.shape[2]
    eye = torch.eye(d, dtype=L.dtype, device=device)[None]
    fn = KERNELS[kernel]["fn"]
    return torch.cat([fn(eye, L[i:i + 1], R[i:i + 1])
                      for i in range(L.shape[0])])


def check_case(kernel, B, T, d, b, dtype, gen, device) -> dict:
    r = d // b
    spec = KERNELS[kernel]
    L, R = _orth_factors(gen, B, r, b, dtype, device)
    x = torch.randn((B, T, d), generator=gen, device=device).to(dtype)
    y = spec["fn"](x, L, R)
    torch.cuda.synchronize()
    y_plain = spec["plain"](x, L, R)
    err = (y.float() - y_plain.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{kernel} B={B} T={T} d={d} b={b} {dtype}: "
                             f"max|err| {err} > {tol}")
    set_bytes = (2 * B * T * d + 2 * B * d * b) * x.element_size()
    n_sets = int(min(16, max(1, math.ceil(120e6 / set_bytes))))
    sets = [(x, L, R)] + [(x,) + _orth_factors(gen, B, r, b, dtype, device)
                          for _ in range(n_sets - 1)]
    ms = time_ms(spec["fn"], sets)
    plain_ms = time_ms(spec["plain"], sets)
    M = _dense(kernel, L, R, device)
    lib_ms = time_ms(torch.bmm, [(x, M)])
    lib_err = (torch.bmm(x, M).float() - y.float()).abs().max().item()
    del M
    bound_ms, bound_by = bound(B, T, d, b, dtype)
    tt, cluster = gk.launch_geometry(kernel, B, T, d)
    return dict(kernel=kernel, B=B, T=T, d=d, b=b, tt=tt, cluster=cluster,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_err=lib_err, bound_ms=bound_ms, bound_by=bound_by)


def prefill_buckets():
    """Every prefill length the serve phase can run: the engine's bucket of
    each prompt length in ``PROMPT_LENS`` (the f32 check's prompt of 24
    tokens falls among them)."""
    lo, hi = PROMPT_LENS
    return sorted({prompt_bucket(n, SERVE_MAX_LEN) for n in range(lo, hi + 1)})


def kernel_cases(cfg):
    """The serving path's shapes: decode rows (B=4, T=1) and each prefill
    bucket (B=1) through the transpose rotation; the merge slabs (T = d_out
    of wq / wi at d = d_model, of the MLP wo at d = d_ff) through the
    forward rotation. The short buckets run the transpose kernel split over
    a cluster with several tokens per tile (d = d_model) or one (d = d_ff),
    the longer ones unsplit."""
    D, F = cfg.d_model, cfg.d_ff
    out = []
    for d, slabs in ((D, (cfg.num_heads * cfg.d_head, F)), (F, (D,))):
        for b in (32, 128):
            out.append(("gs_fused_T", 4, 1, d, b))
            out += [("gs_fused_T", 1, t, d, b) for t in prefill_buckets()]
            out += [("gs_fused", 1, t, d, b) for t in slabs]
    return out


def check_variants(cases) -> None:
    """Fail unless every launch variant of the transpose kernel was held
    against its plain version in each dtype: split over a cluster with one
    and with several tokens per tile, and unsplit."""
    for dtype in ("bfloat16", "float32"):
        seen = {(c["cluster"] > 1, c["tt"] > 1) for c in cases
                if c["kernel"] == "gs_fused_T" and c["dtype"] == dtype}
        missing = {(True, False), (True, True), (False, True)} - seen
        if missing:
            raise AssertionError(f"gs_fused_T {dtype}: no checked case ran "
                                 f"the (split, several tokens) variants "
                                 f"{sorted(missing)}")


def bwd_bound(T: int, d: int, b: int, dtype, with_dx: bool) -> tuple:
    """Least time for the backward of one row: x and dy read, dx written
    (with_dx), the factors read and dL, dR written (fp32) once; 10*T*d*b
    operations with dx (u, dv, dx stages and the two factor sums, 2*d*b
    each per token), 8*T*d*b without, at the input dtype's peak rate."""
    es = torch.finfo(dtype).bits // 8
    nbytes = ((3 if with_dx else 2) * T * d + 2 * d * b) * es + 2 * d * b * 4
    flops = (10 if with_dx else 8) * T * d * b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_cases(cfg):
    """(kernel, T, d) the training path gives the backward kernels, b = 32:
    the weight-side GSOFT rotation treats the columns of W (d_in, d_out) as
    tokens (T = d_out, d = d_in, gs_fused_bwd); Double GSOFT's output side
    treats its rows as tokens (T = d_in, d = d_out, gs_fused_grads). Slabs:
    wq / attn wo, wk / wv, wi / wg, MLP wo."""
    D, F = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.d_head
    w = [(D, cfg.num_heads * cfg.d_head), (D, kv), (D, F), (F, D)]
    return ([("gs_fused_bwd", d_out, d_in) for d_in, d_out in w] +
            [("gs_fused_grads", d_in, d_out) for d_in, d_out in w])


def check_bwd_case(kernel, T, d, b, dtype, gen, device) -> dict:
    r = d // b
    spec = KERNELS[kernel]
    with_dx = kernel == "gs_fused_bwd"
    L, R = _orth_factors(gen, 1, r, b, dtype, device)
    x = torch.randn((1, T, d), generator=gen, device=device).to(dtype)
    dy = torch.randn((1, T, d), generator=gen, device=device).to(dtype)
    out = spec["fn"](x, dy, L, R)
    torch.cuda.synchronize()
    want = spec["plain"](x, dy, L, R)
    grad_abs = [(g - w).abs().max().item() for g, w in zip(out[-2:], want[-2:])]
    grad_err = max(e / max(1.0, w.abs().max().item())
                   for e, w in zip(grad_abs, want[-2:]))
    dx_err = ((out[0].float() - want[0].float()).abs().max().item()
              if with_dx else 0.0)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not (math.isfinite(grad_err) and grad_err <= GRAD_REL
            and math.isfinite(dx_err) and dx_err <= tol):
        raise AssertionError(f"{kernel} T={T} d={d} b={b} {dtype}: dL/dR "
                             f"rel err {grad_err} (tol {GRAD_REL}), dx err "
                             f"{dx_err} (tol {tol})")
    del out, want
    args = [(x, dy, L, R)]
    ms = time_ms(spec["fn"], args)
    plain_ms = time_ms(spec["plain"], args)
    if with_dx:
        # partial yardstick: dx alone, as one dense bmm (x @ M == x Q)
        M = _dense("gs_fused_T", L, R, device)
        lib_ms = time_ms(torch.bmm, [(dy, M)])
        lib_what = "bmm(dy, dense Q): dx only"
        del M
    else:
        # partial yardstick: the two b x b factor sums over prepared, already
        # shuffled fp32 operands, as two batched GEMMs
        a = torch.randn((r, b, T), generator=gen, device=device)
        c = torch.randn((r, T, b), generator=gen, device=device)
        lib_ms = time_ms(lambda p, q: (torch.bmm(p, q), torch.bmm(p, q)),
                         [(a, c)])
        lib_what = "2 x bmm over r blocks (b, T) @ (T, b), fp32: the sums only"
        del a, c
    bound_ms, bound_by = bwd_bound(T, d, b, dtype, with_dx)
    tt, splits = gk.launch_geometry("gs_fused_bwd", 1, T, d, b)
    return dict(kernel=kernel, B=1, T=T, d=d, b=b, tt=tt, splits=splits,
                dtype=str(dtype).replace("torch.", ""),
                max_abs_err=max([dx_err] + grad_abs), dx_abs_err=dx_err,
                grad_rel_err=grad_err, tol=tol,
                grad_tol=GRAD_REL, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_what=lib_what, bound_ms=bound_ms,
                bound_by=bound_by)


# ---------------------------------------------------------------------------
# main-path phases
# ---------------------------------------------------------------------------

def perturbed_adapters(pcfg, params, seed: int, scale: float, device):
    ad = peft_lib.init_peft(pcfg, params, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {path: {k: v + scale * torch.randn(v.shape, generator=gen,
                                              device=device)
                   for k, v in entry.items()}
            for path, entry in ad.items()}


def _profile(run) -> dict:
    """Run ``run()`` under torch.profiler; device time by kernel name, and
    the share of the wall time with a kernel running on the card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append(dict(name=e.key[:120], device_ms=us / 1e3,
                                count=e.count))
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels) / 1e3
    # the port's kernels live in namespace gs::; sum them by kernel function
    by_kernel = {}
    for k in kernels:
        if "gs::" in k["name"]:
            fam = k["name"].split("gs::", 1)[1].split("<", 1)[0].split("(", 1)[0]
            by_kernel[fam] = by_kernel.get(fam, 0.0) + k["device_ms"]
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall if wall > 0 else None,
                gs_kernels_device_s=sum(by_kernel.values()) / 1e3,
                gs_device_ms_by_kernel=by_kernel, top=kernels[:16])


def serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """8 requests (prompts of 16-128 tokens, 16 new tokens each) round-robin
    over 3 banked adapters and the base model, on 4 slots. The first run is
    the counted main-path run; ``repeats`` runs in all give the median
    rate; one more runs under the profiler."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    rt = base.attach({n: perturbed_adapters(pcfg, base.params, seed + 1 + i,
                                            0.05, device)
                      for i, n in enumerate(names)}, pcfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=8)
    order = names + [None]
    work = [(rng.integers(1, cfg.vocab_size, size=int(n)).tolist(), order[i % 4])
            for i, n in enumerate(lens)]

    def drive():
        eng = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
        for prompt, adapter in work:
            eng.add_request(prompt, max_new_tokens=16, adapter=adapter)
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        return eng, results, time.perf_counter() - t0

    warm = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
    warm.add_request([1, 2, 3], max_new_tokens=2, adapter=names[0])
    warm.run()
    gk.gs_fused_T.launches = 0
    gk.gs_fused.launches = 0
    eng, results, wall = drive()
    launches = {"gs_fused_T": gk.gs_fused_T.launches,
                "gs_fused": gk.gs_fused.launches}
    if len(results) != 8 or any(len(v) != 16 for v in results.values()):
        raise AssertionError(f"served {len(results)} of 8 requests: "
                             f"{ {k: len(v) for k, v in results.items()} }")
    if not all(0 <= t < cfg.padded_vocab() for v in results.values()
               for t in v):
        raise AssertionError("served a token outside the vocabulary")
    if launches["gs_fused_T"] == 0:
        raise AssertionError("banked serving never launched gs_fused_T")
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w = drive()
        if again != results:
            raise AssertionError("a repeated run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    return dict(layers=cfg.num_layers, requests=len(results),
                prompt_lens=[int(n) for n in lens], tokens=toks,
                wall_s=walls, wall_median_s=wall_med,
                tok_s=toks / wall_med,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"], setup_s=setup_s,
                launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                profile=_profile(drive))


def merged_phase(cfg, seed: int, device) -> dict:
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    adapter = perturbed_adapters(pcfg, base.params, seed + 7, 0.05, device)
    banked = base.attach({"a": adapter}, pcfg)
    gk.gs_fused.launches = 0
    t0 = time.perf_counter()
    merged = ModelRuntime(cfg, base.params, device=device, adapters=adapter,
                          peft_cfg=pcfg)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_launches = gk.gs_fused.launches
    if merge_launches == 0:
        raise AssertionError("the offline merge never launched gs_fused")

    prompt = np.random.default_rng(seed).integers(1, cfg.vocab_size, 24)
    tokens = {}
    for name, rt, adapter_name in (("banked", banked, "a"),
                                   ("merged", merged, None)):
        eng = ServeEngine(rt, max_batch=1, max_len=64, eos_id=-1)
        rid = eng.add_request(prompt.tolist(), max_new_tokens=8,
                              adapter=adapter_name)
        tokens[name] = eng.run()[rid]
    if tokens["banked"] != tokens["merged"]:
        raise AssertionError(f"banked {tokens['banked']} != merged "
                             f"{tokens['merged']}")

    # one prefill + one decode step, logits compared
    logits = {}
    feed = torch.as_tensor(prompt[None], device=device)
    for name, rt, slot in (("banked", banked, [1]), ("merged", merged, [0])):
        state = rt.decode_state(1, 64)
        req = peft_lib.PrefillRequest(batch={"tokens": feed},
                                      last_idx=torch.as_tensor(len(prompt) - 1),
                                      ctx=rt.context(slot))
        _, state = steps.build_prefill_step(cfg)(rt.params, req, state)
        _, lg, _ = steps.build_decode_step(cfg)(
            rt.params, rt.context(slot),
            torch.as_tensor([[int(tokens[name][0])]], device=device), state,
            torch.as_tensor([len(prompt)], device=device))
        logits[name] = lg.float()
    scale = max(1.0, logits["merged"].abs().max().item())
    err = (logits["banked"] - logits["merged"]).abs().max().item()
    if not (torch.isfinite(logits["banked"]).all() and err <= LOGIT_TOL * scale):
        raise AssertionError(f"decode logits differ by {err} "
                             f"(tolerance {LOGIT_TOL * scale})")
    return dict(layers=cfg.num_layers, tokens=tokens["banked"],
                logit_max_abs_err=err, logit_tol=LOGIT_TOL * scale,
                merge_s=merge_s, merge_launches=merge_launches,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _reset_launches() -> None:
    for name in KERNELS:
        KERNELS[name]["fn"].launches = 0


def _launches() -> dict:
    return {name: KERNELS[name]["fn"].launches for name in KERNELS}


def _slices(pcfg, params) -> int:
    """Adapted weight slices: one rotation (one kernel launch) each."""
    return sum(math.prod(spec.batch)
               for spec in peft_lib.adapted_paths(pcfg, params).values())


def train_phase(cfg, seed: int, device, steps_n: int = TRAIN_STEPS) -> dict:
    """GSOFT fine-tuning of the depth-cut model: ``steps_n`` steps of
    ``build_train_step`` on one fixed batch (the counted main-path run; the
    loss must fall), one more under the profiler, then 3 steps of
    ``train()`` on ``batch_at(step)``."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=TRAIN_LR))
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed,
                      vocab_size=min(cfg.vocab_size, 256))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = peft_lib.init_peft(pcfg, params, device=device)
    trainable, frozen = peft_lib.trainable_and_frozen(pcfg, params, adapters)
    opt_state = optim.init(tcfg.opt, trainable)
    step = steps.build_train_step(cfg, tcfg)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in LMDataSource(dcfg).batch_at(0).items()}
    n_slices = _slices(pcfg, frozen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    _reset_launches()
    losses, gnorms, times = [], [], []
    for _ in range(steps_n):
        t = time.perf_counter()
        trainable, opt_state, m = step(frozen, trainable, opt_state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = _launches()
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not min(gnorms) > 0:
        raise AssertionError(f"zero gradient norm: {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the fixed-batch loss did not fall: {losses}")
    want = {"gs_fused": steps_n * n_slices, "gs_fused_bwd": steps_n * n_slices,
            "gs_fused_T": 0, "gs_fused_grads": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != the design's {want} "
                             f"({n_slices} adapted slices x {steps_n} steps)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(lambda: step(frozen, trainable, opt_state, batch))
    step_s = float(np.median(times))
    del params, adapters, trainable, frozen, opt_state, step
    torch.cuda.empty_cache()

    _reset_launches()
    hist = []
    out = train_loop.train(cfg, tcfg, dcfg,
                           train_loop.LoopConfig(steps=3, log_every=1),
                           log_fn=lambda msg: log(f"  train(): {msg}"),
                           device=device)
    hist = out["history"]
    loop_launches = _launches()
    del out
    torch.cuda.empty_cache()
    if len(hist) != 3 or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train() history {hist}")
    if loop_launches["gs_fused_bwd"] != 3 * n_slices:
        raise AssertionError(f"train() launches {loop_launches}")
    return dict(layers=cfg.num_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=TRAIN_LR, remat=cfg.remat, adapted_slices=n_slices,
                losses=losses, grad_norms=gnorms, step_s=times,
                step_median_s=step_s,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                launches=launches,
                launches_per_step={k: v / steps_n for k, v in launches.items()},
                peak_mem_gb=peak_gb, setup_s=setup_s, profile=prof,
                train_loop=dict(history=hist, launches=loop_launches))


def grad_phase(cfg, seed: int, device, method: str) -> dict:
    """One train step's adapter gradients (autograd through the GS kernels)
    against a central difference of the loss along a seeded random
    direction, in f32 at a perturbed (non-identity) adapter point."""
    pcfg = peft_lib.PEFTConfig(method=method, block_size=32)
    tcfg = steps.TrainStepConfig(peft=pcfg)
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = perturbed_adapters(pcfg, params, seed + 11, 0.02, device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in LMDataSource(
        DataConfig(seq_len=GRAD_SEQ, global_batch=GRAD_BATCH, seed=seed,
                   vocab_size=min(cfg.vocab_size, 256))).batch_at(0).items()}
    n_slices = _slices(pcfg, params)
    _reset_launches()
    loss, _, grads = steps.build_grad_fn(cfg, pcfg)(adapters, params, batch)
    torch.cuda.synchronize()
    launches = _launches()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 23)
    direction = {p: {k: torch.randn(v.shape, generator=gen, device=device)
                     for k, v in e.items()} for p, e in adapters.items()}
    deriv = sum(float((grads[p][k].double() * direction[p][k].double()).sum())
                for p in adapters for k in adapters[p])
    umax = max(float(u.abs().max()) for e in direction.values()
               for u in e.values())
    h = min(FD_TARGET / max(abs(deriv), 1e-30), FD_MAX_STEP / umax)
    del grads
    evaluate = steps.build_eval_step(cfg, tcfg)

    def central(step: float) -> tuple:
        lp, lm = (float(evaluate(params, {p: {k: v + sgn * step * direction[p][k]
                                              for k, v in e.items()}
                                          for p, e in adapters.items()},
                                 batch)["loss"])
                  for sgn in (1.0, -1.0))
        return (lp - lm) / (2 * step), lp, lm

    # Richardson: (4 D(h/2) - D(h)) / 3 cancels the h^2 term of the central
    # difference, leaving O(h^4) and the rounding of the four losses
    fd_h, lp, lm = central(h)
    fd_h2, _, _ = central(h / 2)
    fd = (4 * fd_h2 - fd_h) / 3
    err = abs(fd - deriv)
    del params, adapters, direction
    torch.cuda.empty_cache()
    want_fwd = ("gs_fused",) if method == "gsoft" else ("gs_fused", "gs_fused_T")
    want_bwd = (("gs_fused_bwd",) if method == "gsoft"
                else ("gs_fused_bwd", "gs_fused_grads"))
    for name in want_fwd + want_bwd:
        if launches[name] == 0:
            raise AssertionError(f"{method}: {name} never launched in the "
                                 f"gradient step ({launches})")
    if not (math.isfinite(fd) and err <= FD_REL * abs(deriv)):
        raise AssertionError(f"{method}: directional derivative {deriv} vs "
                             f"central difference {fd} (h {h}): |diff| {err} "
                             f"> {FD_REL} * |deriv|")
    return dict(method=method, layers=cfg.num_layers, loss=float(loss),
                adapted_slices=n_slices, directional_derivative=deriv,
                central_difference=fd, central_h=fd_h, central_h2=fd_h2,
                h=h, loss_plus=lp, loss_minus=lm,
                rel_err=err / abs(deriv), tol=FD_REL, launches=launches,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/chip_smoke.json")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("numerics: TF32 off for matmul and cuDNN (f32 is full f32)")

    # 2. build
    build_s = build.build_all()
    log(f"build: {build_s:.1f} s for {sorted(build.BUILD_LOG) or 'cached'}")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # 3. kernels against their plain versions (after ~1 s of matmuls, so the
    # first timed case does not pay for the clocks ramping up)
    warm = torch.randn((8192, 8192), device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    full = get_config("qwen2-72b")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, B, T, d, b in kernel_cases(full):
            c = check_case(kernel, B, T, d, b, dtype, gen, device)
            cases.append(c)
            log(f"kernel {kernel:10s} B={B} T={T:5d} d={d:5d} b={b:3d} "
                f"tt={c['tt']} cluster={c['cluster']} {c['dtype']:8s} err {c['max_abs_err']:.2e} (tol "
                f"{c['tol']:.0e}) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"lib {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
    check_variants(cases)
    torch.cuda.empty_cache()

    # 3b. backward kernels against their plain versions
    bwd_cases_run = []
    for dtype in (torch.bfloat16, torch.float32):
        for kernel, T, d in bwd_cases(full):
            c = check_bwd_case(kernel, T, d, 32, dtype, gen, device)
            bwd_cases_run.append(c)
            log(f"kernel {kernel:14s} T={T:5d} d={d:5d} b=32 tt={c['tt']} "
                f"splits={c['splits']} {c['dtype']:8s} dx err "
                f"{c['dx_abs_err']:.2e} (tol {c['tol']:.0e}) dL/dR rel err "
                f"{c['grad_rel_err']:.2e} (tol {GRAD_REL:.0e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()

    # 4. serve, bf16, full width, depth cut
    cfg8 = full.with_overrides(num_layers=SERVE_LAYERS)
    log(f"serve: qwen2-72b full width, depth cut 80 -> {SERVE_LAYERS} layers, "
        f"bf16, seed {args.seed}")
    torch.cuda.reset_peak_memory_stats()
    serve = serve_phase(cfg8, args.seed, device)
    prof = serve["profile"]
    log(f"serve: {serve['requests']} requests, {serve['tokens']} tokens; wall "
        f"{['%.3f' % w for w in serve['wall_s']]} s, median "
        f"{serve['tok_s']:.1f} tok/s; {serve['decode_steps']} decode steps; "
        f"launches {serve['launches']}")
    log(f"serve profile: wall {prof['wall_s']:.3f} s, device busy "
        f"{prof['device_busy_s']:.3f} s (idle share {prof['idle_share']}), "
        f"GS kernels {prof['gs_kernels_device_s']:.4f} s")
    torch.cuda.empty_cache()

    # 5. banked vs merged, f32
    cfg2 = full.with_overrides(num_layers=CHECK_LAYERS, dtype="f32",
                               param_dtype="f32")
    log(f"check: qwen2-72b full width, {CHECK_LAYERS} layers, f32, TF32 off")
    merged = merged_phase(cfg2, args.seed, device)
    log(f"check: banked == merged tokens {merged['tokens']}; decode logits "
        f"max|diff| {merged['logit_max_abs_err']:.3e} (tol "
        f"{merged['logit_tol']:.1e}); merge launches "
        f"{merged['merge_launches']}")

    # 7. train, bf16, full width, depth cut
    cfg4 = full.with_overrides(num_layers=TRAIN_LAYERS, remat="full")
    log(f"train: qwen2-72b full width, depth cut 80 -> {TRAIN_LAYERS} "
        f"layers, bf16, remat full, GSOFT b=32, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, AdamW lr {TRAIN_LR}")
    train = train_phase(cfg4, args.seed, device)
    tprof = train["profile"]
    log(f"train: losses {['%.5f' % v for v in train['losses']]}; grad norms "
        f"{['%.3e' % v for v in train['grad_norms']]}; step "
        f"{['%.3f' % v for v in train['step_s']]} s, median "
        f"{train['step_median_s']:.3f} s, {train['tokens_per_s']:.1f} tok/s; "
        f"peak {train['peak_mem_gb']:.1f} GB; launches per step "
        f"{train['launches_per_step']}")
    log(f"train profile: wall {tprof['wall_s']:.3f} s, device busy "
        f"{tprof['device_busy_s']:.3f} s (idle share {tprof['idle_share']}), "
        f"GS kernels {tprof['gs_kernels_device_s']:.4f} s "
        f"{ {k: round(v, 2) for k, v in tprof['gs_device_ms_by_kernel'].items()} } ms")
    torch.cuda.empty_cache()

    # 8. gradients against a central difference, f32
    cfg_g = full.with_overrides(num_layers=GRAD_LAYERS, dtype="f32",
                                param_dtype="f32", remat="full")
    log(f"grads: qwen2-72b full width, {GRAD_LAYERS} layers, f32, TF32 off")
    grads = []
    for method in ("gsoft", "double_gsoft"):
        g = grad_phase(cfg_g, args.seed, device, method)
        grads.append(g)
        log(f"grads {method}: directional derivative "
            f"{g['directional_derivative']:.6e}, central difference "
            f"{g['central_difference']:.6e} (h {g['h']:.2e}), rel err "
            f"{g['rel_err']:.2e} (tol {FD_REL:.0e}); launches {g['launches']}")
        torch.cuda.empty_cache()

    # 9. report
    by_path = {"serve": serve["launches"],
               "merge": {"gs_fused": merged["merge_launches"]},
               "train": train["launches"],
               "grads_double_gsoft": grads[1]["launches"]}
    main_case = {"gs_fused_T": ("gs_fused_T", 4, 1, full.d_model, 32,
                                "bfloat16"),
                 "gs_fused": ("gs_fused", 1, full.d_ff, full.d_model, 32,
                              "float32"),
                 "gs_fused_bwd": ("gs_fused_bwd", 1, full.d_ff, full.d_model,
                                  32, "bfloat16"),
                 "gs_fused_grads": ("gs_fused_grads", 1, full.d_model,
                                    full.d_ff, 32, "bfloat16")}
    # launches on the training path: GSOFT training (phase 7) for the
    # forward rotation and the fused backward; Double GSOFT's gradient step
    # (phase 8) for the transpose rotation and the grads-only backward
    launches = {"gs_fused_T": grads[1]["launches"]["gs_fused_T"],
                "gs_fused": train["launches"]["gs_fused"],
                "gs_fused_bwd": train["launches"]["gs_fused_bwd"],
                "gs_fused_grads": grads[1]["launches"]["gs_fused_grads"]}
    all_cases = cases + bwd_cases_run
    kernels = []
    for name, key in main_case.items():
        c = next(c for c in all_cases
                 if (c["kernel"], c["B"], c["T"], c["d"], c["b"],
                     c["dtype"]) == key)
        mine = [x for x in all_cases if x["kernel"] == name]
        extra = {f"max_abs_err_{dt}": max(x["max_abs_err"] for x in mine
                                          if x["dtype"] == dt)
                 for dt in ("bfloat16", "float32")}
        if name in ("gs_fused_bwd", "gs_fused_grads"):
            extra.update({f"max_grad_rel_err_{dt}": max(
                x["grad_rel_err"] for x in mine if x["dtype"] == dt)
                for dt in ("bfloat16", "float32")})
            extra["library_what"] = c["library_what"]
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            launches_by_path={p: v[name] for p, v in by_path.items()
                              if name in v},
            max_abs_err=c["max_abs_err"], **extra,
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape=dict(B=c["B"], T=c["T"], d=c["d"], b=c["b"],
                       dtype=c["dtype"])))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, build_s=build_s, cases=cases,
                                   bwd_cases=bwd_cases_run, serve=serve,
                                   merged=merged, train=train, grads=grads,
                                   kernels=kernels), indent=1))
    log(f"details: {out}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
