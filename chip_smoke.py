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
4. serve  — full-width qwen2-72b, depth cut to 8 layers, bf16, random weights
   from a seed: 3 GSOFT adapters banked, 8 requests through ``ServeEngine``;
   the ``gs_fused_T`` kernel must have run
5. banked vs merged — full width at 2 layers in f32 (TF32 off): one adapter
   merged through ``gs_fused``, one prompt served both ways, equal greedy
   tokens and decode logits within tolerance
6. report — one JSON line of kernels, then the ``{"ok": true, ...}`` line

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

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import peft as peft_lib  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402
from repro_torch.serve.engine import ServeEngine, prompt_bucket  # noqa: E402
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

KERNELS = {
    "gs_fused_T": dict(fn=gk.gs_fused_T, plain=gk.gs_fused_T_plain,
                       replaces="src/repro/kernels/gs_fused.py:163",
                       source="src/repro_torch/kernels/csrc/gs_fused_T.cu"),
    "gs_fused": dict(fn=gk.gs_fused, plain=gk.gs_fused_plain,
                     replaces="src/repro/kernels/gs_fused.py:157",
                     source="src/repro_torch/kernels/csrc/gs_fused.cu"),
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
    gs = sum(k["device_ms"] for k in kernels if "gs_fused" in k["name"]) / 1e3
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall if wall > 0 else None,
                gs_fused_device_s=gs, top=kernels[:12])


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
        f"gs_fused kernels {prof['gs_fused_device_s']:.4f} s")
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

    # 6. report
    main_case = {"gs_fused_T": ("gs_fused_T", 4, 1, full.d_model, 32,
                                "bfloat16"),
                 "gs_fused": ("gs_fused", 1, full.d_ff, full.d_model, 32,
                              "float32")}
    launches = {"gs_fused_T": serve["launches"]["gs_fused_T"],
                "gs_fused": merged["merge_launches"]}
    kernels = []
    for name, key in main_case.items():
        c = next(c for c in cases
                 if (c["kernel"], c["B"], c["T"], c["d"], c["b"],
                     c["dtype"]) == key)
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=c["max_abs_err"],
            **{f"max_abs_err_{dt}": max(x["max_abs_err"] for x in cases
                                        if x["kernel"] == name
                                        and x["dtype"] == dt)
               for dt in ("bfloat16", "float32")},
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape=dict(B=c["B"], T=c["T"], d=c["d"], b=c["b"],
                       dtype=c["dtype"])))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, build_s=build_s, cases=cases,
                                   serve=serve, merged=merged,
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
