"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--out results/chip_smoke.json]

Phases (any failure exits non-zero; no phase catches and carries on):

1. device — refuse to run without CUDA; print the card's name and power limit
2. build  — compile every CUDA kernel of the port from ``src/repro_torch``
   (one nvcc per source, all started together)
3. kernels — each kernel against its plain PyTorch version on the card at the
   serving path's shapes (qwen2-72b widths: decode rows, every prefill
   bucket the serve phase's prompts can take, the weight slabs the merge
   and training rotate, Double GSOFT's output sides), with times for the
   kernel, the plain version and a library yardstick (one dense matmul;
   where b divides r also the product over the b^2 x b^2 diagonal blocks),
   and each call's route; the transpose rotation runs through its slot-id
   entry (``gs_fused_T_bank``) from a 4-slot fp32 bank, also at Double
   GSOFT's output-side slabs, the dx slab of the GS backward and d = 33792;
   the fp32 tile route's launch variants (split over a cluster or not, one
   or several tokens per tile) must each be checked; at d = 33792 also
   route 2's wide passes (f32 at b = 32, bf16 at b = 128)
3b. backward kernels — ``gs_fused_grads`` against its plain version at every
   (T, d) the training paths give it (the weight slabs of the seven
   projections, both sides), ``gs_fused_bwd`` (with dx) at the weight-side
   slabs, bf16 and f32, with the route each took, times, bounds and a
   partial library yardstick; then both at the wi slab with b = 128 and
   256 (route 2), bf16; at d = 33792 on route 2's wide passes (f32 b = 32,
   bf16 b = 128); then ``gs_fused_bwd``'s path, once: ``gs_diff``
   through autograd with an input that needs a gradient
3c. bdmm kernels — ``bdmm`` at the weight slabs (OFT / BOFT training and
   merge), the banked decode rows and every prefill bucket (OFT / BOFT
   serving; also with the blocks read transposed in place, as the banked
   rotations read them), ``bdmm_dblocks`` at the weight slabs (their
   backward), bf16 and f32, b = 32, and b = 256 at the wi slab and the
   decode rows, with the route each took, times, bounds, plain versions and
   one einsum each as the library yardstick; dblocks must be bit-identical
   across two runs
3d. int8 and paged kernels — ``q_matmul`` at the LM head and every
   projection shape (one and four decode rows, one prefill chunk),
   ``gs_q_matmul`` at each adapted projection through its slot-id entry
   (four decode rows of their own slots of a 4-slot fp32 bank, one prefill
   chunk; also d = 33792), ``paged_decode`` at qwen2-72b's heads
   through page-8 and page-16 tables (one ragged case with a parked row)
   and at 4096 keys a row through a page-16 table of 256 columns (each row
   split over a cluster), bf16 and f32, against their plain versions, with
   times, bounds, library yardsticks and the splits a row took
3e. SSD scan — ``ssd`` at zamba2's heads (80, P = N = 64) and mamba2-130m's
   (24, N = 128) at every prefill bucket, T = 2048 (the carried state),
   T = 1000 (no multiple of any power-of-two chunk), batch 1 and 4, bf16
   and f32, against its plain version, with times and bounds (no library
   call computes the scan)
3f. flash attention — through ``ops.flash_mha`` at qwen2-72b's heads (64 /
   8, D 128) and zamba2's (32 / 32, D 80), S of 128, 512 and 2048, causal
   and not, a ragged causal S of 1000, gemma-7b's heads (16 / 16, D 256, S
   of 512 and 2048, causal) and D = 320 (8 / 8, S = 1024, causal), bf16
   (route ``tc``, the tensor cores) and f32 (route ``cc``), against its
   plain version with times, bounds and SDPA as the yardstick, and the
   route and feature splits each call took; a non-causal ragged Sk must
   raise; then the entry point driven once per model's heads (flash
   attention's path: it lies on no model path)
3g. GS-class library — ``gs_apply``, ``gs_apply_T`` and ``gs_matmul`` at d =
   8192 for ``gsoft_layout(8192, 32)`` and a layout with rectangular blocks,
   and ``gs_factors_apply`` for ``gs_order_layout(8192, 32, 3)``, f32 and
   bf16, against their plain versions (bdmm's plain version underneath),
   with times, a dense matmul of the materialized A as the library call and
   bounds; each must launch ``bdmm`` once per factor and never the plain
   version; then ``project_to_gs`` (Algorithm 1) at d = 8192, b = 32 in f32
   on the card recovers a materialized GS matrix (error within 1e-3 of
   ||A||_F), timed, and on a random dense orthogonal A at d = 1024 its error
   equals the CPU float64 projection's within 1e-4 relative
3h. image lane kernels — at every (channels d, pixels a row) of
   lipconvnet-15's ``wc`` channel mixes (d = 32-1024, 1024-1 pixels), 8
   rows, b = 8, bf16: ``gs_fused_T`` through its slot-id entry,
   ``gs_q_matmul`` through its slot-id entry (N = d), ``q_matmul`` (M = 8 x
   pixels, K = N = d) and ``bdmm`` (blocks as stored and transposed); then
   ``gs_fused`` in f32 at b = 8 on the d x d merge slab of each width;
   against their plain versions, with times, bounds, library yardsticks
   and the route or plan of each call
4. serve  — full-width qwen2-72b, depth cut to 8 layers, bf16, random weights
   from a seed: 3 GSOFT adapters banked, 8 requests through ``ServeEngine``;
   the ``gs_fused_T`` kernel must have run, every launch through the bank
   read by slot id; the profile counts the gather and copy kernels
4b. paged int8 serve — the serve launcher's ``--engine paged --quantize
   int8`` path at the same width and depth: the banked runtime quantized to
   int8 (each bf16 weight freed once quantized), 8 requests (two of one
   tenant share a 64-token prefix) through ``PagedServeEngine`` (page 8,
   chunk 16) on 4 slots; ``q_matmul``, ``gs_q_matmul`` (every call through
   the bank read by slot id) and ``paged_decode`` must have run, the prefix
   must have been reused; median rate of 3 runs,
   params bytes, peak memory, KV pages against the contiguous cache, a
   profile
5. banked vs merged — full width at 2 layers in f32 (TF32 off): one adapter
   merged through ``gs_fused``, one prompt served both ways, equal greedy
   tokens and decode logits within tolerance
5b. paged int8 check — full width at 2 layers in f32: paged tokens equal
   contiguous tokens, unquantized and int8; the base slot equals the
   bankless int8 model; banked int8 decode logits within 10 % of
   max|logit| of "merge, then quantize"
7. train  — full-width qwen2-72b, depth cut to 4 layers, bf16, remat
   "full": GSOFT (b = 32) on all seven projections, AdamW, steps of
   ``build_train_step`` on one fixed batch (the loss must fall), then 3
   steps of ``train()``; ``gs_fused`` and ``gs_fused_grads`` must have run
   once per adapted weight slice and step, and ``gs_fused_bwd`` never (the
   rotated weight is frozen: no dx); the profiled step reports
   ``gs_fused``'s share of the busy time and the device time of the copies
   that lay W^T and dy out as contiguous tokens for the GS kernels
8. gradients — full width, 2 layers, f32, TF32 off: for GSOFT and Double
   GSOFT, the adapter gradients of one train step against a central
   difference of the loss along a seeded random direction (``gs_fused``,
   ``gs_fused_T`` and ``gs_fused_grads`` run in these backward passes)
9. OFT / BOFT train — as phase 7 with OFT and BOFT (b = 32, BOFT at its two
   butterfly levels): fixed-batch steps whose bdmm / bdmm_dblocks launches
   per step must equal the design's count, then 3 steps through the
   launcher (``launch/train.py --peft``); one step each of householder,
   givens and lora at 2 layers (finite loss, no GS or bdmm launch)
10. OFT / BOFT gradients — as phase 8, f32 at 2 layers
11. mixed serve — full width, 2 layers (cut from 8 for phase 18's
   time), bf16: one bank holding gsoft, oft,
   boft, householder and givens tenants (``attach`` with a
   ``{name: PEFTConfig}`` mapping), 12 requests on 4 slots (the GSOFT
   rotations through the bank read by slot id), median rate of 3 runs and a
   profile; then f32 at 2 layers: every tenant's tokens equal
   its solo offline-merged run, decode logits within tolerance, and the
   base slot equals the bankless model
12. checkpoints — full width, 4 layers, bf16, GSOFT b = 32: ``train()``
   with ``ckpt_dir`` for 2 steps (async saves), the saved {"trainable",
   "opt"} restored bit for bit, ``train()`` again resuming to step 4 against
   an uninterrupted 4-step run (losses of steps 2-3 within 1e-3 relative,
   the largest adapter difference recorded); then ``launch/train.py
   --ckpt-dir`` twice (2 steps, then 3, resumed)
12b. adapter and int8 checkpoints — full width, 2 layers, f32, TF32 off: 3
   GSOFT tenants through ``save_adapters`` and ``attach(<dir>)`` serve the
   tokens of ``attach({name: adapters}, cfg)``; ``save_quantized`` and
   ``ModelRuntime.load_quantized`` give bit-equal codes and scales and the
   paged int8 engine serves the saved runtime's tokens (``q_matmul``,
   ``gs_q_matmul``)
12c. store-paged serve — full width, 2 layers (cut from 8 for phase
   18's time), bf16: 24 tenants (gsoft,
   boft, householder round-robin, b = 32; about 160 MB of fp32 factors per
   GSOFT or BOFT tenant) saved with ``save_adapters`` and opened lazily by
   ``attach(<dir>, hbm_budget=6)``: a cold sweep of one request per tenant
   (seeded order), then 12 revisits of 4 tenants, prompts of 16-128 tokens,
   8 new tokens, 4 slots of ``ServeEngine``; every GSOFT rotation through
   the slot-id entry with compact ids, ``bdmm`` for the BOFT tenants,
   evictions and page-ins, finite first-token logits for every tenant;
   median rate of 3 runs, page-in p50 / p95, hit rate, resident against
   padded bank bytes, peak memory, a profile of the first 12 requests;
   then f32 at 2 layers: 6
   tenants under budget 3 equal their solo merged runs (one evicted and
   paged in again) and the store-paged bank equals the eager padded bank,
   unquantized and over int8; finally ``launch/serve.py --store-dir
   --hbm-adapter-budget 6`` serves 8 requests
13. hybrid serve — zamba2-2.7b at full width and full depth (54 layers),
   bf16, random weights from the seed, the serve launcher's continuous lane:
   8 requests (prompts of 16-128 tokens, 16 new tokens) on 4 slots of
   ``ServeEngine``; ``ssd`` must launch once per Mamba layer per prefill and
   no other kernel of the port may; median rate of 3 runs, params bytes,
   peak memory, a profile; then the launcher itself (``--arch
   zamba2-2.7b``) serves 8 requests
13b. SSM checks, f32, TF32 off — mamba2-130m at its full config, T = 512:
   the card's forward against the CPU's (plain versions, same params) and
   against token-by-token decode (the state-space duality); zamba2-2.7b at
   full width and 12 layers, T = 320: the duality; both: the first served
   token equals the forward's argmax; gaps within 1e-3 of max|logit|
14. static, streaming and traced serving — qwen2-72b at full width, 8
   layers, bf16: (a) ``StaticServeEngine`` on a runtime with one GSOFT
   adapter merged (b = 32; the merge must launch ``gs_fused``), 8
   mixed-length requests, 4 a batch, median rate of 3 runs beside
   ``ServeEngine`` on the same runtime and requests, a profile with the
   dispatches named (``profiler_annotations``); (b) ``ServeEngine`` over a
   3-tenant GSOFT bank: tracing off and on in turns, 3 runs each (tokens
   equal, the rate ratio reported), then ``drive_streaming`` with Poisson
   arrivals at 0.7x the up-front request rate under a ``TraceRecorder`` +
   ``SLOMonitor``: TTFT / TPOT p50 / p95 / p99, stalls by reason, every
   trace complete, Chrome and JSONL exports parsed back; (c) the paged int8
   lane traced under a 24-page KV pool: at least one ``kv`` stall,
   ``q_matmul``, ``gs_q_matmul`` (by slot id) and ``paged_decode`` must
   launch; (d) the launcher with ``--engine static --peft-demo`` and with
   ``--arrival-rate 4 --trace --trace-out --log-json``; (e) f32 at 2
   layers: the static engine's tokens on the merged runtime equal
   ``ServeEngine``'s on it and on a banked runtime serving that tenant
15. image serving — lipconvnet-15 full (widths 32-512, ``down`` convs to
   2048 channels, 100 classes), bf16, random params from the seed: (a)
   ``ImageServeEngine`` (8 a batch) over a bank of 6 tenants (gsoft, boft,
   householder round-robin, b = 8) and the base slot, 64 images, median
   images/s of 3 runs, peak memory, a profile of the first 12 requests;
   ``gs_fused_T`` only by slot id, ``bdmm`` must launch; (b) the same over
   int8 weights (``gs_q_matmul`` by slot id, no ``gs_fused_T``), and the
   bankless int8 model (``q_matmul``); (c) the launcher ``--family image
   --demo-adapters 3 --trace``; (d) f32, TF32 off: every tenant's banked
   logits within 1e-3 of max|logit| of its solo merged runtime's, the base
   slot equal to the bankless model bit for bit, the banked net 1-Lipschitz
   on seeded pairs (1e-3), banked int8 within 1e-3 of max|logit| of each
   tenant's exact model and within 10 % of "merge, then quantize" (GSOFT
   and BOFT tenants; a Householder tenant's dense merged Q is recorded)
16. scale-out — qwen2-72b full width: (a) the ``EngineCluster`` at 1 and 2
   replicas sharing the card (4 layers bf16, cut from 8; 8 tenants GSOFT / BOFT at
   b = 8 in a store, 4 device slots a replica, 32 mixed-length requests
   up front, a warm-up run, median tok/s of 3, page-ins, affinity hit
   rate): tokens equal, each replica reads its GSOFT bank by slot id in
   ``gs_fused_T`` and launches ``bdmm``, the speedup reported, not gated;
   (b) the launcher's ``--replicas 2 --store-dir --hbm-adapter-budget`` and
   ``--tp 1 --engine paged --quantize int8`` lanes and their cluster
   reports; (c) a runtime on the degenerate tp = 1 mesh (a world of one)
   serving a 3-tenant GSOFT bank, then paged int8: tokens equal the
   unmeshed runtime's bit for bit; (d) tp = 2 as two processes on the card
   over gloo (CUDA tensors staged through the host: a check of the split
   kernels at their local shapes, never a speed): the contiguous bank lane
   (3 GSOFT tenants + BOFT, b = 32), int8 banked and paged int8 at 2
   layers f32 (TF32 off) give tp = 1's tokens on both ranks, every one of
   ``gs_fused_T``, ``bdmm``, ``q_matmul``, ``gs_q_matmul`` and
   ``paged_decode`` launches on the split path; zamba2-2.7b full in f32
   (40 of 80 SSD heads a rank, ``ssd`` on them) gives tp = 1's tokens; at
   4 layers bf16 the logits lie within 2^-4 of max|logit| of tp = 1's and
   the differing tokens are counted; then ``q_matmul`` (local N and K),
   ``gs_q_matmul`` (local N), ``paged_decode`` (32 / 4 heads) and ``ssd``
   (40 heads) against their plain versions, timed
17. training — (a) ``ssd_bwd`` (the scan's backward, the port's own
   kernel) against autograd through the plain scan at zamba2's training
   shape (2 x 256, 80 heads, P = N = 64; f32 and bf16), mamba2-130m's (24
   heads, N = 128), a ragged T = 1000 and N = 256, each of dx / dloga /
   dB / dC within its tolerance, timed, with bounds; (b) mamba2-130m and
   zamba2-2.7b trained at full width and depth (bf16, GSOFT b = 32, 3
   steps on one batch: the loss must fall, each step launching ``ssd``
   twice and ``ssd_bwd`` once a Mamba layer), tok/s and peak memory, and
   their f32 gradients at 2 layers against central differences along
   three random directions each; (c) qwen2-72b at full width (1 layer,
   f32, remat "none", GSOFT b = 32, batch 8 x 64, 2 microbatches, 3
   steps) trained on (data, model) = (2, 1), (1, 2) with and without
   ``seq_parallel``, and (2, 2), as gloo processes sharing the card, each
   mesh's losses within rtol = atol = 2e-3 of one process, every rank's
   AdamW first moments leaf by leaf within 2e-3 of the leaf's max, and
   the adapters moved; BOFT one step at (1, 2); zamba2 (2 layers and the
   shared block, f32, remat "full": each row-split weight slice gathered
   again in the backward) at (1, 2), ``ssd`` / ``ssd_bwd`` on 40 heads a
   rank; (d) a checkpoint saved on (1, 2) restored onto (2, 1) bit for
   bit, ``compressed_psum_mean`` over data = 2 within 1e-2, GPipe over 2
   stages (one full-width bf16 decoder layer each, 4 microbatches)
   against the stages in sequence, decode of 8 rows at (2, 1) against
   one call
18. the MoE family and the other dense decoders — (a) ``moe_layer`` at
   qwen3-moe-30b-a3b's full width (d 2048, 128 experts, top 8, f_e 768),
   one layer, 2 x 256 tokens: the card against the CPU in f32 (1e-4 of
   max |y|, identical kept / dropped choices, experts and slots), its bf16
   time and dropped share; (b) ``gs_fused`` and ``gs_fused_grads`` over a
   whole expert stack in ONE launch (bf16, b = 32): qwen3's wi (d 2048, T
   768, 128 experts) and wo (d 768: r = 24 < b, route 2), phi-3.5-MoE's wi
   (d 4096, T 6400, 16 experts) and wo (d 6400, r = 200), against the
   plain version on sampled experts and the per-expert loop, both timed,
   with bounds and the library yardsticks; (c) qwen3-moe full width, 4
   layers (GSOFT on every expert of 48 layers, about 1.9 G adapter
   parameters with AdamW, does not fit beside 61 GB of weights), bf16,
   GSOFT b = 32, 2 x 256, 3 steps on one batch: the loss falls, each step
   launches one rotation an adapted stack (one step again with the old
   per-slice loop, its launches and time), tok/s, peak, idle share; the
   launcher (``launch/train.py``, 3 steps, its log with ``moe_aux``); f32
   gradients at 2 layers along three random directions; (d) qwen3-moe
   full width, 8 layers, bf16: a paged engine over a GSOFT bank of the
   attention projections (3 tenants + base, 8 requests on 4 slots), a
   static engine on (c)'s adapter merged (the expert stacks through
   ``gs_fused``, one launch a stack chunk), tok/s and idle share; f32 at 2
   layers: the attention bank's tokens equal the merged model's; (e)
   gemma-7b at full width and depth (28 layers): a paged GSOFT bank (D =
   256 through ``paged_decode``), 3 GSOFT training steps, and
   ``attn_impl="prefix_loop"`` against the dense schedule at 2 layers f32;
   granite-34b (GELU MLP, one kv head) and mistral-large-123b (d 12288) at
   full width, 2 layers: f32 bank == merged tokens, one bf16 GSOFT step
19. the encoder-decoder, the vlm and the encoder classifier — (a)
   seamless-m4t-medium full (12 + 12 layers, d 1024, vocab 256206 padded to
   256208), bf16, GSOFT b = 32 on one batch of 2 x 256 tokens with 64
   random frames a row, 3 steps: the loss falls, each step launches 16
   ``gs_fused`` + 16 ``gs_fused_grads`` (one a stack: encoder attention /
   MLP, decoder attention / cross-attention / MLP), profiled once; the
   launcher (``launch/train.py --arch seamless-m4t-medium``, 3 steps);
   the trained adapter merged (16 ``gs_fused``) and served through
   ``ServeEngine`` and ``StaticServeEngine`` (8 requests on 4 slots, zero
   frames as JAX's engines feed; no port kernel on the merged path), then
   ``launch/serve.py --peft-demo``; f32 at 2 + 2 layers: logits, loss and
   adapter gradients with random frames on the card against the CPU; (b)
   pixtral-12b at full width (d 5120, 32 / 8 heads, d_ff 14336, vocab
   131072, 256 patches of 1024): 8 of 40 layers bf16 served from a bank of
   3 GSOFT tenants + the base (8 requests on 4 slots): every adapted
   projection of every prefill (patch_proj too) and decode step rotates
   through ``gs_fused_T`` by slot id, then the same over int8 weights
   (``gs_q_matmul`` by slot id, ``q_matmul`` at the LM head); 4 layers
   trained (2 x 512: 256 patches + 256 text, GSOFT b = 32, 3 steps, 8
   stacks), profiled once; f32 at 2 layers: banked tokens and prefill
   logits with random patches equal the merged model's, and card vs CPU;
   (c) the encoder classifier at RoBERTa-base's widths (12 layers, d 768,
   12 heads, d_ff 3072, vocab 50265; a RoBERTa-shaped proxy), f32, 2
   classes, 8 x 128: LoRA r 8, OFT b 16, BOFT m 2 b 8 and GSOFT b 8
   (``benchmarks/table1_glue.py``'s methods), the first step's gradients
   card vs CPU, 3 steps each (the loss falls, launches as designed); (d)
   the kernels at the new shapes against their plain versions, timed, with
   bounds and library yardsticks
20. full fine-tuning on a mesh and expert parallelism, as gloo ranks
   sharing the card, each run held to one process — (a) gemma-7b at full
   width (d 3072, 16 heads of 256, d_ff 24576, vocab 256000, tied
   embeddings), 1 layer, f32, every param trained (8 x 64, 2
   microbatches, 3 AdamW steps) on (2, 1), (1, 2) with and without
   seq_parallel, and (2, 2): every rank's losses, grad norms and first
   moments (its block of each leaf) against one process, no port kernel
   launched; (b) qwen3-moe at full width, 2 layers, f32, GSOFT b = 32 on
   every projection, its experts split over 'model' (64 a rank) at (1,
   2) with and without seq_parallel and (2, 2), then with a ragged mask at
   (2, 2), each on the one process's routing piece: every rank's own
   first-step routings (experts and kept sets) equal one process's (later
   steps' flips counted, with their margins) before its losses, grad
   norms and first moments are held to it; one ``gs_fused`` + one ``gs_fused_grads`` launch per local expert
   stack per microbatch and no expert byte gathered; served at tp = 2 (a
   paged engine over a 3-tenant GSOFT bank of the attention projections,
   8 requests on 4 slots): at 2 layers f32 the tokens equal tp = 1, at 4
   layers bf16 the differing tokens are counted; (c) a rank's expert stacks
   through ``gs_fused`` / ``gs_fused_grads`` (64 experts of a layer in
   bf16, the 2 x 64 rows 20b trains in f32) and ``paged_decode`` at a
   rank's heads against their plain versions, timed, with bounds; (d)
   ``launch/train.py --mesh 1,2 --peft full`` (gemma-7b, 1 layer) and
   ``launch/serve.py --arch qwen3-moe-30b-a3b --tp 2`` (4 layers, paged)
   under torchrun, two ranks each over gloo, both at once. Its one-process
   runs go before phase 17, and its mesh runs in 17c's gloo ranks
21. report — where the time went (build, set-up, timed runs, profiled
   runs, and phases 3g, 3h, 12, 12b, 12c, 14, 15, 16, 17, 18, 19 and 20
   whole), the card's name and power limit, one JSON line of kernels, then the
   ``{"ok": true, ...}`` line

Imports nothing of JAX: the port is ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter as Counter_
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch import store as store_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import adapters as ad_lib  # noqa: E402
from repro_torch.core import conv as conv_lib  # noqa: E402
from repro_torch.core import methods as methods_lib  # noqa: E402
from repro_torch.core import gs as gs_lib  # noqa: E402
from repro_torch.core import projection as gs_proj  # noqa: E402
from repro_torch.core import peft as peft_lib  # noqa: E402
from repro_torch.core.permutations import PermSpec  # noqa: E402
from repro_torch.core.runtime import ModelRuntime  # noqa: E402
from repro_torch.data import DataConfig, LMDataSource  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distrib import EngineCluster  # noqa: E402
from repro_torch.distrib.tp import serve_mesh  # noqa: E402
from repro_torch.kernels import bdmm as bk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.kernels import gs_fused as gk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pak  # noqa: E402
from repro_torch.kernels import q_matmul as qmk  # noqa: E402
from repro_torch.kernels import ssd as ssdk  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encoder as encoder_model  # noqa: E402
from repro_torch.models import image as image_model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.obs import REGISTRY, SLOMonitor, TraceRecorder  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.quant import is_quant_tensor, quantize_int8, tree_bytes  # noqa: E402
from repro_torch.serve.engine import (PagedServeEngine, ServeEngine,  # noqa: E402
                                      StaticServeEngine, prompt_bucket)
from repro_torch.serve.image import ImageServeEngine  # noqa: E402
from repro_torch.serve.kv import kv_page_bytes  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import steps  # noqa: E402

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor-core rate
              torch.float32: 67e12}     # fp32 outside the tensor cores
SERVE_LAYERS = 8
MIXED_SERVE_LAYERS = 2              # the mixed-method serve's depth (was 8)
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
BDMM_BLOCK = 32
BDMM_LARGE_BLOCK = 256              # phase 3c: a block size past the old limit
QUICK_LAYERS = 2                    # householder / givens / lora one-step check
MIXED_SERVE_REQUESTS = 12           # two per tenant and two on the base slot
MIXED_SCALE = 0.3                   # noise on the mixed bank's adapters
PAGE_SIZE = 8                       # the serve launcher's defaults
PREFILL_CHUNK = 16
SHARED_PREFIX = 64                  # tokens two requests of one tenant share
# quantized matmul: f32 sums in another order (allclose atol = rtol); bf16:
# kernel and plain version round y once from near-equal fp32 sums (one ulp)
QMM_F32_TOL = 1e-4
QMM_BF16_REL = 2.0 ** -7
# gs_q_matmul bf16: the kernel keeps the rotation's intermediate in fp32
# where the plain version rounds it, so the rotated slab may differ by one
# bf16 ulp before the int8 product; f32 relative to max(1, max|ref|)
GSQ_BF16_REL = 2.0 ** -6
GSQ_F32_REL = 1e-4
# paged decode: f32 as tests/test_kv.py; bf16 against one fp32 softmax that
# rounds neither q * scale nor p
PAGED_F32_TOL = 2e-5
PAGED_BF16_REL = 2.0 ** -6
# banked int8 against "merge, then quantize" (f32, 2 layers): the two int8
# trees quantize W and Q^T W, whose codes differ by construction (about 1 %
# of a weight's scale each); 0.15 absolute at smoke scale in
# tests/test_quant.py is about 5 % of max|logit| there; stated relative to
# max|logit| here
QUANT_LOGIT_REL = 0.1
# ssd against its plain version, relative to max|ref| (tests/test_kernels.py:
# f32 1e-4, bf16 5e-2): fp32 state math in both, sums in another order and
# over another chunk (the kernel's 64 steps, the plain version's largest
# divisor of T up to 256); bf16 y rounded once by both
SSD_F32_REL = 1e-4
SSD_BF16_REL = 5e-2
# flash attention, allclose atol = rtol as tests/test_flash_attention.py:
# f32 sums in another order; bf16 also p rounded to bf16 before p . v
FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2
HYBRID_REQUESTS = 8
SSM_CHECK_T = 512                   # mamba2-130m: two 256-step chunks
HYBRID_CHECK_LAYERS = 12            # zamba2: two super-blocks of 6
HYBRID_CHECK_T = 320
SSM_LOGIT_REL = 1e-3                # f32 checks, relative to max|logit|
SLOTS = 4                           # phases 3 and 3d: slots of the fp32 bank
WIDE_D = 33 * 1024                  # phases 3, 3b, 3d: a width past 32768

KERNELS = {
    "gs_fused_T": dict(fn=gk.gs_fused_T, plain=gk.gs_fused_T_plain,
                       bank=gk.gs_fused_T_bank,
                       bank_plain=gk.gs_fused_T_bank_plain,
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
    "bdmm": dict(fn=bk.bdmm, plain=bk.bdmm_plain,
                 replaces="src/repro/kernels/bdmm.py:46",
                 source="src/repro_torch/kernels/csrc/bdmm.cu"),
    "bdmm_dblocks": dict(fn=bk.bdmm_dblocks, plain=bk.bdmm_dblocks_plain,
                         replaces="src/repro/kernels/bdmm.py:98",
                         source="src/repro_torch/kernels/csrc/bdmm.cu"),
    "q_matmul": dict(fn=qmk.q_matmul, plain=qmk.q_matmul_plain,
                     replaces="src/repro/kernels/q_matmul.py:69",
                     source="src/repro_torch/kernels/csrc/q_matmul.cu"),
    "gs_q_matmul": dict(fn=qmk.gs_q_matmul, plain=qmk.gs_q_matmul_plain,
                        replaces="src/repro/kernels/q_matmul.py:120",
                        source="src/repro_torch/kernels/csrc/q_matmul.cu"),
    "paged_decode": dict(fn=pak.paged_decode, plain=pak.paged_decode_plain,
                         replaces="src/repro/kernels/flash_attention.py:180",
                         source="src/repro_torch/kernels/csrc/paged_attn.cu"),
    "ssd": dict(fn=ssdk.ssd, plain=ssdk.ssd_plain,
                replaces="src/repro/kernels/ssd.py:67",
                source="src/repro_torch/kernels/csrc/ssd.cu"),
    "ssd_bwd": dict(fn=ssdk.ssd_bwd, plain=ssdk.ssd_bwd_plain,
                    replaces="src/repro/kernels/ssd.py:67",
                    replaces_note="none: the gradient of ssd_pallas, which "
                                  "has no backward kernel (the JAX package "
                                  "differentiates src/repro/kernels/ref.py:"
                                  "216 ssd_chunked_ref)",
                    source="src/repro_torch/kernels/csrc/ssd_bwd.cu"),
    "flash_attention": dict(fn=fak.flash_attention,
                            plain=fak.flash_attention_plain,
                            replaces="src/repro/kernels/flash_attention.py:77",
                            source="src/repro_torch/kernels/csrc/flash_attn.cu"),
}
# kernel launches per rotation launch of an adapted weight stack (one a
# chunk of whole layers for the methods whose kernels take rows, one a
# slice for the others) and train step, by method, as the design predicts (m: BOFT's butterfly levels): materialization runs outside
# remat, so once forward; the weight slab is frozen, so no dx launch for the
# first level's input (GSOFT: the grads-only backward, no gs_fused_bwd)
DESIGN_LAUNCHES = {
    "gsoft": lambda m: {"gs_fused": 1, "gs_fused_grads": 1},
    "oft": lambda m: {"bdmm": 1, "bdmm_dblocks": 1},
    "boft": lambda m: {"bdmm": 2 * m - 1, "bdmm_dblocks": m},
    "householder": lambda m: {},
    "givens": lambda m: {},
    "lora": lambda m: {},
}
# the backward kernel of each trained method (counted in the train() steps)
BWD_KERNEL = {"gsoft": "gs_fused_grads", "oft": "bdmm_dblocks",
              "boft": "bdmm_dblocks"}
# the kernels one train step's gradient runs, by method (phases 8 and 10);
# Double GSOFT's output side takes gs_fused for the dx of its input, the
# rotated weight
GRAD_KERNELS = {
    "gsoft": ("gs_fused", "gs_fused_grads"),
    "double_gsoft": ("gs_fused", "gs_fused_T", "gs_fused_grads"),
    "oft": ("bdmm", "bdmm_dblocks"),
    "boft": ("bdmm", "bdmm_dblocks"),
}


_START = time.perf_counter()
# seconds spent by kind: "timed" (kernel timing loops and the served runs
# a rate is taken from), "profiled" (runs under torch.profiler and the
# processing of their traces); the rest of the script, past the build, is
# set-up (models, weights, data, plain versions, checks)
_SPENT = {"timed": 0.0, "profiled": 0.0}
# seconds of each phase this script added last (all kinds of time)
_PHASE_S = {}


def log(msg: str) -> None:
    """One progress line, prefixed with the seconds since the script
    started (so a run's output shows where its time went)."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing + bounds
# ---------------------------------------------------------------------------

def time_ms(fn, arg_sets) -> float:
    """Mean ms per call over CUDA events, cycling ``arg_sets`` (several sets
    when one fits in L2, so the factors come from device memory as they do
    on the serving path, where every layer has its own)."""
    t_in = time.perf_counter()
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
    _SPENT["timed"] += time.perf_counter() - t_in
    return start.elapsed_time(end) / iters


def bound(B: int, T: int, d: int, b: int, dtype,
          factor_bytes: int = None) -> tuple:
    """Least time for y = rotation(x): x read and y written once, the
    factors read once (per-row factors in x's dtype, or ``factor_bytes``:
    the fp32 bank slots the rows read); 4*B*T*d*b operations (two block
    stages of 2*d*b each per token) at the dtype's peak rate."""
    es = torch.finfo(dtype).bits // 8
    if factor_bytes is None:
        factor_bytes = 2 * B * d * b * es
    nbytes = 2 * B * T * d * es + factor_bytes
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


def _slot_ids(B: int, device) -> torch.Tensor:
    """Row i of a bank call reads slot (i + 1) % SLOTS: distinct slots for
    up to four rows, the identity slot 0 last."""
    return torch.tensor([(i + 1) % SLOTS for i in range(B)],
                        dtype=torch.int64, device=device)


def _bank(gen, r: int, b: int, device) -> tuple:
    """A SLOTS-slot fp32 bank (L, R) of orthogonal blocks with the identity
    in slot 0, as ``gsoft_bank_build`` stacks one."""
    L, R = _orth_factors(gen, SLOTS, r, b, torch.float32, device)
    L[0] = R[0] = torch.eye(b, device=device)
    return L, R


def _bank_bytes(ids: torch.Tensor, L: torch.Tensor) -> int:
    """fp32 bytes of the bank slots the rows read (L and R, each slot
    once)."""
    return 2 * len(set(ids.tolist())) * L[0].numel() * L.element_size()


def _dense(kernel: str, L, R, device):
    """Per-row dense M with x @ M == kernel(x): the rotation of the rows of
    the identity (built with the kernel, outside any timing)."""
    d = L.shape[1] * L.shape[2]
    eye = torch.eye(d, dtype=L.dtype, device=device)[None]
    fn = KERNELS[kernel]["fn"]
    return torch.cat([fn(eye, L[i:i + 1], R[i:i + 1])
                      for i in range(L.shape[0])])


def check_case(kernel, B, T, d, b, dtype, gen, device) -> dict:
    """``kernel`` at x (B, T, d), block b, against its plain version, with
    times (kernel, plain, dense ``bmm``, the b^2 x b^2 block product where b
    divides r) and the bound. ``gs_fused_T`` runs through its slot-id entry
    from a SLOTS-slot fp32 bank (the serving path's call), ``gs_fused``
    with per-row factors in x's dtype."""
    r = d // b
    spec = KERNELS[kernel]
    x = torch.randn((B, T, d), generator=gen, device=device).to(dtype)
    banked = kernel == "gs_fused_T"
    if banked:
        ids = _slot_ids(B, device)
        fn, plain = spec["bank"], spec["bank_plain"]
        args = (x,) + _bank(gen, r, b, device) + (ids,)
        fresh = lambda: (x,) + _bank(gen, r, b, device) + (ids,)  # noqa: E731
        L = args[1].index_select(0, ids).to(dtype)
        R = args[2].index_select(0, ids).to(dtype)
        factor_bytes = _bank_bytes(ids, args[1])
    else:
        fn, plain = spec["fn"], spec["plain"]
        L, R = _orth_factors(gen, B, r, b, dtype, device)
        args = (x, L, R)
        fresh = lambda: (x,) + _orth_factors(gen, B, r, b, dtype, device)  # noqa: E731
        factor_bytes = None
    y = fn(*args)
    torch.cuda.synchronize()
    y_plain = plain(*args)
    err = (y.float() - y_plain.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{kernel} B={B} T={T} d={d} b={b} {dtype}: "
                             f"max|err| {err} > {tol}")
    del y_plain
    set_bytes = 2 * B * T * d * x.element_size() + (
        factor_bytes or 2 * B * d * b * x.element_size())
    n_sets = int(min(16, max(1, math.ceil(120e6 / set_bytes))))
    sets = [args] + [fresh() for _ in range(n_sets - 1)]
    ms = time_ms(fn, sets)
    plain_ms = time_ms(plain, sets)
    del sets
    M = _dense(kernel, L, R, device)
    lib_ms = time_ms(torch.bmm, [(x, M)])
    lib_err = (torch.bmm(x, M).float() - y.float()).abs().max().item()
    blocks_ms = blocks_err = None
    if r % b == 0:
        # Q is block-diagonal in d / b^2 blocks of b^2 x b^2 when b | r: one
        # einsum over those blocks computes the same function
        n = b * b
        Mb = torch.stack([M[:, s * n:(s + 1) * n, s * n:(s + 1) * n]
                          for s in range(d // n)], dim=1)

        def blocks(xx, mb):
            return torch.einsum("btsi,bsij->btsj",
                                xx.view(B, T, d // n, n), mb)
        blocks_ms = time_ms(blocks, [(x, Mb)])
        blocks_err = (blocks(x, Mb).reshape(B, T, d).float()
                      - y.float()).abs().max().item()
        del Mb
    del M
    bound_ms, bound_by = bound(B, T, d, b, dtype, factor_bytes)
    if kernel == "gs_fused":
        plan = gk.fwd_plan(B, T, r, b, gk._DTYPES[dtype], gk._num_sms(device))
        route, tt, cluster = plan.route, plan.tokens, 1
    else:
        plan = gk.t_plan(B, T, r, b, gk._DTYPES[dtype], gk._num_sms(device))
        route, tt, cluster = plan.route, plan.tt, plan.cluster
    return dict(kernel=kernel, B=B, T=T, d=d, b=b, route=route, tt=tt,
                cluster=cluster, plan=plan._asdict(), banked=banked,
                dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_err=lib_err,
                library_blocks_ms=blocks_ms, library_blocks_err=blocks_err,
                bound_ms=bound_ms, bound_by=bound_by)


def prefill_buckets():
    """Every prefill length the serve phase can run: the engine's bucket of
    each prompt length in ``PROMPT_LENS`` (the f32 check's prompt of 24
    tokens falls among them)."""
    lo, hi = PROMPT_LENS
    return sorted({prompt_bucket(n, SERVE_MAX_LEN) for n in range(lo, hi + 1)})


def kernel_cases(cfg):
    """The serving path's shapes: decode rows (B=4, T=1) and each prefill
    bucket (B=1) through the transpose rotation; the weight slabs (T = d_out
    of wq / wi at d = d_model, of the MLP wo at d = d_ff) through the
    forward rotation, and at b = 32 those of wk / wv (T = 1024 at d =
    d_model) and Double GSOFT's output side of wq (T = d_model at d = 1024,
    the wk / wv width). The short buckets run the transpose kernel split
    over a cluster with several tokens per tile (d = d_model) or one (d =
    d_ff), the longer ones unsplit."""
    D, F = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.d_head
    out = []
    for d, slabs in ((D, (cfg.num_heads * cfg.d_head, F)), (F, (D,))):
        for b in (32, 128):
            out.append(("gs_fused_T", 4, 1, d, b))
            out += [("gs_fused_T", 1, t, d, b) for t in prefill_buckets()]
            out += [("gs_fused", 1, t, d, b) for t in slabs]
    out += [("gs_fused", 1, kv, D, 32), ("gs_fused", 1, D, kv, 32)]
    # bf16 only (route 1): Double GSOFT's output sides (T = d_in, d = d_out
    # of wq / attn wo, wk / wv, wi / wg and the MLP wo, the last also the
    # shape of the GS backward's dx slab); then a width past 32768 (WIDE_D):
    # route 1 in bf16 at b = 32, route 2's wide passes in f32 at b = 32 and
    # in bf16 at b = 128 (decode rows, one prefill bucket, a short slab)
    return out + [("gs_fused_T", 1, t, d, 32)
                  for t, d in ((D, D), (D, kv), (D, F), (F, D))] + [
        (k, bsz, t, WIDE_D, b) for b in (32, 128)
        for k, bsz, t in (("gs_fused_T", 4, 1), ("gs_fused_T", 1, 128),
                          ("gs_fused", 1, 128))]


def f32_case(kernel: str, T: int, d: int) -> bool:
    """Phase 3 also runs the case in f32 (route 2): the rows and prefill
    buckets of the transpose rotation and every ``gs_fused`` slab."""
    return kernel == "gs_fused" or T <= max(prefill_buckets())


def check_variants(cases) -> None:
    """Fail unless every launch variant of the transpose rotation's fp32
    tile route was held against its plain version in each dtype (bf16:
    through b = 128): split over a cluster with one and with several tokens
    per tile, and unsplit."""
    for dtype in ("bfloat16", "float32"):
        seen = {(c["cluster"] > 1, c["tt"] > 1) for c in cases
                if c["kernel"] == "gs_fused_T" and c["dtype"] == dtype
                and c["route"] == "cc"}
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
    """(kernel, T, d, b) of phase 3b. The weight-side GSOFT rotation treats
    the columns of W (d_in, d_out) as tokens (T = d_out, d = d_in); Double
    GSOFT's output side treats its rows as tokens (T = d_in, d = d_out).
    Both train through ``gs_fused_grads`` (slabs: wq / attn wo, wk / wv,
    wi / wg, MLP wo); ``gs_fused_bwd`` (with dx) is held at the weight-side
    slabs. Then the wi slab at b = 128 and 256 (route 2, bf16 only); last
    (kernel, T, d) at d = WIDE_D, route 2's wide passes (b = 32 in f32, 128
    in bf16)."""
    D, F = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.d_head
    w = [(D, cfg.num_heads * cfg.d_head), (D, kv), (D, F), (F, D)]
    grads = []
    for T, d in [(d_out, d_in) for d_in, d_out in w] + \
            [(d_in, d_out) for d_in, d_out in w]:
        if ("gs_fused_grads", T, d, 32) not in grads:
            grads.append(("gs_fused_grads", T, d, 32))
    return (grads + [("gs_fused_bwd", d_out, d_in, 32) for d_in, d_out in w],
            [(k, F, D, b) for b in (128, 256)
             for k in ("gs_fused_grads", "gs_fused_bwd")],
            [(k, 128, WIDE_D) for k in ("gs_fused_grads", "gs_fused_bwd")])


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
    plan = gk.bwd_plan(1, T, d // b, b, gk._DTYPES[dtype], gk._num_sms(device))
    return dict(kernel=kernel, B=1, T=T, d=d, b=b, route=plan.route,
                splits=plan.splits, tokens=plan.tokens, window=plan.window,
                dtype=str(dtype).replace("torch.", ""),
                max_abs_err=max([dx_err] + grad_abs), dx_abs_err=dx_err,
                grad_rel_err=grad_err, tol=tol,
                grad_tol=GRAD_REL, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_what=lib_what, bound_ms=bound_ms,
                bound_by=bound_by)


def bwd_entry_phase(cfg, gen, device) -> dict:
    """``gs_fused_bwd``'s path, which no training path takes: the autograd
    rule of ``ops.gs_transform`` (``gs_diff``) when its input needs a
    gradient, driven once at the wi slab in bf16, with the launches counted
    from zero around that run; dx against the plain transpose rotation."""
    T, d, b = cfg.d_ff, cfg.d_model, 32
    L, R = (f[0].requires_grad_() for f in
            _orth_factors(gen, 1, d // b, b, torch.bfloat16, device))
    x = torch.randn((T, d), generator=gen, device=device).to(
        torch.bfloat16).requires_grad_()
    cot = torch.randn((T, d), generator=gen, device=device).to(torch.bfloat16)
    _reset_launches()
    y = ops.gs_transform(L, R, x)
    dL, dR, dx = torch.autograd.grad(y, (L, R, x), cot)
    torch.cuda.synchronize()
    launches = _launches()
    want = {k: 0 for k in launches}
    want.update(gs_fused=1, gs_fused_bwd=1)
    if launches != want:
        raise AssertionError(f"gs_diff with an input that needs a gradient "
                             f"launched {launches}, not {want}")
    ref_dx = gk.gs_fused_T_plain(cot[None], L.detach()[None],
                                 R.detach()[None])[0]
    err = (dx.float() - ref_dx.float()).abs().max().item()
    if not (math.isfinite(err) and err <= BF16_TOL and
            all(torch.isfinite(g).all() for g in (dL, dR))):
        raise AssertionError(f"gs_diff dx err {err} (tol {BF16_TOL})")
    return dict(T=T, d=d, b=b, dtype="bfloat16", launches=launches,
                dx_abs_err=err)


def bdmm_bound(B: int, T: int, d: int, b: int, dtype) -> tuple:
    """Least time for y = bdmm(x, blocks), square b x b blocks: x read and y
    written once, the per-row blocks read once; 2*B*T*d*b operations."""
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * T * d + B * d * b) * es
    flops = 2 * B * T * d * b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dblocks_bound(T: int, d: int, b: int, dtype) -> tuple:
    """Least time for dblocks = bdmm_dblocks(dy, x): dy and x read once,
    the fp32 (r, b, b) sums written once; 2*T*d*b operations."""
    es = torch.finfo(dtype).bits // 8
    nbytes = 2 * T * d * es + d * b * 4
    flops = 2 * T * d * b
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _slabs(cfg):
    """(T, d) of the weight-side rotation of each projection's weight
    W (d_in, d_out): its columns are the tokens (T = d_out, d = d_in).
    wi / wg, MLP wo, wq / attn wo, wk / wv."""
    D, F = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.d_head
    return [(F, D), (D, F), (cfg.num_heads * cfg.d_head, D), (kv, D)]


def bdmm_cases(cfg):
    """(B, T, d) the OFT / BOFT paths give ``bdmm``: the weight slabs
    (training, merge; also the dx of BOFT's second level), the banked decode
    rows and each prefill bucket at both widths a rotation sees (d_model
    before the attention and MLP input projections, d_ff before the MLP
    output projection)."""
    out = [(1, t, d) for t, d in _slabs(cfg)]
    for d in (cfg.d_model, cfg.d_ff):
        out.append((4, 1, d))
        out += [(1, t, d) for t in prefill_buckets()]
    return out


def bdmm_large_cases(cfg):
    """(B, T, d) of phase 3c's b = 256 cases: the wi slab and the decode
    rows, at d_model (256 does not divide qwen2-72b's d_ff)."""
    return [(1, cfg.d_ff, cfg.d_model), (4, 1, cfg.d_model)]


def bdmm_trans_cases(cfg):
    """(B, T, d) the banked OFT / BOFT rotations give ``bdmm`` with the
    blocks read transposed: the decode rows and each prefill bucket at both
    widths."""
    return [c for c in bdmm_cases(cfg) if c[0] != 1 or c[1] in
            prefill_buckets()]


def _plan_fields(plan) -> dict:
    return dict(route=plan.route, geometry=list(plan.args),
                grid=list(plan.grid), threads=plan.threads, smem=plan.smem)


def check_bdmm_case(B, T, d, b, dtype, gen, device, trans=False) -> dict:
    r = d // b
    blocks = _orth_factors(gen, B, r, b, dtype, device)[0]
    x = torch.randn((B, T, d), generator=gen, device=device).to(dtype)
    y = bk.bdmm(x, blocks, transpose_blocks=trans)
    torch.cuda.synchronize()
    y_plain = bk.bdmm_plain(x, blocks, transpose_blocks=trans)
    err = (y.float() - y_plain.float()).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"bdmm B={B} T={T} d={d} b={b} {dtype} "
                             f"trans={trans}: max|err| {err} > {tol}")
    set_bytes = (2 * B * T * d + B * d * b) * x.element_size()
    n_sets = int(min(16, max(1, math.ceil(120e6 / set_bytes))))
    sets = [(x, blocks)] + [(x, _orth_factors(gen, B, r, b, dtype, device)[0])
                            for _ in range(n_sets - 1)]

    def kernel(xx, w):
        return bk.bdmm(xx, w, transpose_blocks=trans)

    def plain(xx, w):
        return bk.bdmm_plain(xx, w, transpose_blocks=trans)

    def library(xx, w):                  # one cuBLAS batched product
        return torch.einsum("zgji,ztgj->ztgi" if trans else "zgij,ztgj->ztgi",
                            w, xx.view(B, T, r, b))

    ms = time_ms(kernel, sets)
    plain_ms = time_ms(plain, sets)
    lib_ms = time_ms(library, sets)
    lib_err = (library(x, blocks).reshape(B, T, d).float()
               - y.float()).abs().max().item()
    bound_ms, bound_by = bdmm_bound(B, T, d, b, dtype)
    plan = bk.bdmm_plan(dtype, B, T, r, b, b, gk._num_sms(device), trans)
    return dict(kernel="bdmm", B=B, T=T, d=d, b=b, trans=trans,
                **_plan_fields(plan), dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_err=lib_err,
                library_what=('einsum("zgji,ztgj->ztgi")' if trans else
                              'einsum("zgij,ztgj->ztgi")'),
                bound_ms=bound_ms, bound_by=bound_by)


def check_dblocks_case(T, d, b, dtype, gen, device) -> dict:
    r = d // b
    dy = torch.randn((1, T, d), generator=gen, device=device).to(dtype)
    x = torch.randn((1, T, d), generator=gen, device=device).to(dtype)
    got = bk.bdmm_dblocks(dy, x, b, b)
    torch.cuda.synchronize()
    want = bk.bdmm_dblocks_plain(dy, x, b, b)
    err = (got - want).abs().max().item()
    rel = err / max(1.0, want.abs().max().item())
    if not (math.isfinite(rel) and rel <= GRAD_REL):
        raise AssertionError(f"bdmm_dblocks T={T} d={d} b={b} {dtype}: rel "
                             f"err {rel} > {GRAD_REL}")
    if not torch.equal(bk.bdmm_dblocks(dy, x, b, b), got):
        raise AssertionError(f"bdmm_dblocks T={T} d={d} b={b} {dtype}: two "
                             "runs differ")
    del want
    args = [(dy, x, b, b)]
    ms = time_ms(bk.bdmm_dblocks, args)
    plain_ms = time_ms(bk.bdmm_dblocks_plain, args)
    # the library yardstick sums fp32 copies prepared outside the timing
    dy32, x32 = dy.float().view(T, r, b), x.float().view(T, r, b)
    lib_ms = time_ms(lambda p, q: torch.einsum("tgi,tgj->gij", p, q),
                     [(dy32, x32)])
    lib_err = (torch.einsum("tgi,tgj->gij", dy32, x32)
               - got[0]).abs().max().item()
    del dy32, x32
    bound_ms, bound_by = dblocks_bound(T, d, b, dtype)
    plan = bk.dblocks_plan(dtype, 1, T, r, b, b, gk._num_sms(device))
    return dict(kernel="bdmm_dblocks", B=1, T=T, d=d, b=b,
                **_plan_fields(plan),
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                grad_rel_err=rel, tol=GRAD_REL, bit_identical=True, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                library_what='einsum("tgi,tgj->gij") over fp32 copies',
                bound_ms=bound_ms, bound_by=bound_by)


def bdmm_phase(cfg, gen, device) -> list:
    """Phase 3c: both bdmm kernels against their plain versions, bf16 and
    f32, at every shape the OFT / BOFT paths give them (b = 32), with the
    blocks read transposed at the banked rotations' shapes, and at
    b = 256."""
    run = []
    for dtype in (torch.bfloat16, torch.float32):
        cases = ([(B, T, d, BDMM_BLOCK, False) for B, T, d in bdmm_cases(cfg)]
                 + [(B, T, d, BDMM_BLOCK, True)
                    for B, T, d in bdmm_trans_cases(cfg)]
                 + [(B, T, d, BDMM_LARGE_BLOCK, False)
                    for B, T, d in bdmm_large_cases(cfg)])
        for B, T, d, b, trans in cases:
            c = check_bdmm_case(B, T, d, b, dtype, gen, device, trans)
            run.append(c)
            log(f"kernel bdmm           B={B} T={T:5d} d={d:5d} b={b:3d} "
                f"{'T ' if trans else '  '}{c['route']:6s} "
                f"{c['geometry']} {c['dtype']:8s} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
        for T, d, b in ([(T, d, BDMM_BLOCK) for T, d in _slabs(cfg)]
                        + [(cfg.d_ff, cfg.d_model, BDMM_LARGE_BLOCK)]):
            c = check_dblocks_case(T, d, b, dtype, gen, device)
            run.append(c)
            log(f"kernel bdmm_dblocks   T={T:5d} d={d:5d} b={b:3d} "
                f"{c['route']:6s} {c['geometry']} {c['dtype']:8s} rel err "
                f"{c['grad_rel_err']:.2e} (tol {GRAD_REL:.0e}) "
                f"bit-identical ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"lib {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
    return run


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


def _profile(run, copy_shapes=None, ranges=()) -> dict:
    """Run ``run()`` under torch.profiler; device time by kernel name, and
    the share of the wall time with a kernel running on the card. With
    ``copy_shapes`` (a set of (T, d)), also the device time of the copies
    (``aten::clone``) of tensors of those shapes, (T, d) or (n, T, d) (a
    stack of n rows); with
    ``ranges`` (names of ``record_function`` ranges, as a tracer with
    ``profiler_annotations`` opens them around the engines' dispatches),
    the count, the host ms, the device ms (the kernels' own time, summed
    over the operators nested in the range) and the device span ms (the
    range on the card's timeline, first kernel to last, gaps included) of
    each, kept out of the kernels' sums. Only then are the host's operators
    traced too; otherwise the device's activity alone, which keeps the
    serving runs' host-side traces (hundreds of thousands of operators),
    their recording cost and their processing out of the run."""
    from torch.profiler import ProfilerActivity, profile
    t_in = time.perf_counter()
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if copy_shapes is not None or ranges else [])
    with profile(activities=acts,
                 record_shapes=copy_shapes is not None) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    kernels = []
    for e in averages:
        if ("CUDA" not in str(getattr(e, "device_type", ""))
                or e.key in ranges):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append(dict(name=e.key[:120], device_ms=us / 1e3,
                                count=e.count))
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels) / 1e3
    # the gathers (index_select) and the copies / dtype casts (PyTorch's
    # direct_copy kernels) the run launched, by count and device ms
    moved = {}
    for e in averages:
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        for what, tag in (("index_select", "indexSelect"),
                          ("copy", "direct_copy_kernel")):
            if tag in e.key:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                n, ms = moved.get(what, (0, 0.0))
                moved[what] = (n + e.count, ms + us / 1e3)
    # the port's kernels live in namespaces gs:: (GS and bdmm), qmm::
    # (quantized matmuls), pa:: (paged attention), ssd:: (the SSD scan) and
    # fa:: (flash attention); sum them by function
    by_kernel = {}
    for k in kernels:
        for ns in ("gs::", "qmm::", "pa::", "ssd::", "fa::"):
            if ns in k["name"]:
                fam = (k["name"].split(ns, 1)[1].split("<", 1)[0]
                       .split("(", 1)[0])
                by_kernel[fam] = by_kernel.get(fam, 0.0) + k["device_ms"]
    out = dict(wall_s=wall, device_busy_s=busy,
               idle_share=1.0 - busy / wall if wall > 0 else None,
               port_kernels_device_s=sum(by_kernel.values()) / 1e3,
               port_device_ms_by_kernel=by_kernel, top=kernels[:16],
               index_select_kernels=moved.get("index_select", (0, 0.0))[0],
               index_select_device_ms=moved.get("index_select", (0, 0.0))[1],
               copy_kernels=moved.get("copy", (0, 0.0))[0],
               copy_device_ms=moved.get("copy", (0, 0.0))[1])
    if copy_shapes is not None:
        ms, n = 0.0, 0
        for e in prof.key_averages(group_by_input_shape=True):
            shape = tuple(e.input_shapes[0]) if e.input_shapes else ()
            if e.key == "aten::clone" and (shape in copy_shapes or (
                    len(shape) == 3 and shape[1:] in copy_shapes)):
                us = getattr(e, "device_time_total", None)
                ms += (us if us is not None else e.cuda_time_total) / 1e3
                n += e.count
        out.update(copies_device_ms=ms, copies=n)
    if ranges:
        out["ranges"] = {}
        for e in averages:
            if e.key not in ranges:
                continue
            r = out["ranges"].setdefault(e.key, dict(
                count=0, host_ms=0.0, device_ms=0.0, device_span_ms=0.0))
            if "CUDA" in str(getattr(e, "device_type", "")):
                # the range's annotation on the card's timeline: from its
                # first kernel to its last, the gaps between them included
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                r["device_span_ms"] += us / 1e3
            else:
                # the host range: its kernels' device time, summed over
                # every operator nested in it
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = getattr(e, "cuda_time_total", 0.0)
                r["count"] = e.count
                r["host_ms"] += e.cpu_time_total / 1e3
                r["device_ms"] += us / 1e3
    out["profiler_s"] = time.perf_counter() - t_in
    _SPENT["profiled"] += out["profiler_s"]
    return out


def _moved(prof) -> str:
    """The profile's gather and copy / cast kernels, for the log."""
    return (f"index_select kernels {prof['index_select_kernels']} "
            f"({prof['index_select_device_ms']:.2f} ms), copy / cast kernels "
            f"{prof['copy_kernels']} ({prof['copy_device_ms']:.2f} ms)")


# the forward GS rotation's kernels by profiler name: route 1 and route 2
def gs_fwd_share(prof) -> tuple:
    """(``gs_fused``'s device ms by kernel, their share of the busy time)."""
    by = {k: v for k, v in prof["port_device_ms_by_kernel"].items()
          if k.endswith("gs_fused_tc_kernel") or k == "gs_fused_kernel"}
    return by, sum(by.values()) / (prof["device_busy_s"] * 1e3)


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
    _reset_launches()
    eng, results, wall = drive()
    launches = {"gs_fused_T": gk.gs_fused_T.launches,
                "gs_fused": gk.gs_fused.launches}
    slot = _slot_launches()
    if len(results) != 8 or any(len(v) != 16 for v in results.values()):
        raise AssertionError(f"served {len(results)} of 8 requests: "
                             f"{ {k: len(v) for k, v in results.items()} }")
    if not all(0 <= t < cfg.padded_vocab() for v in results.values()
               for t in v):
        raise AssertionError("served a token outside the vocabulary")
    check_slot_path("serve", launches, slot, ("gs_fused_T",))
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w = drive()
        if again != results:
            raise AssertionError("a repeated run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    _SPENT["timed"] += sum(walls)
    return dict(layers=cfg.num_layers, requests=len(results),
                prompt_lens=[int(n) for n in lens], tokens=toks,
                wall_s=walls, wall_median_s=wall_med,
                tok_s=toks / wall_med,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"], setup_s=setup_s,
                launches=launches, slot_launches=slot,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                profile=_profile(drive))


def _logits_gap(cfg, banked, slot: int, merged, prompt, first: int,
                device, rel: float = LOGIT_TOL) -> tuple:
    """One prefill and one decode step (fed ``first``) of ``prompt`` on the
    bank's ``slot`` and on the merged runtime; fails unless the decode
    logits agree within ``rel`` of their largest magnitude. Returns
    (max |diff|, tolerance, the bank's prefill logits)."""
    logits = []
    feed = torch.as_tensor(prompt[None], device=device)
    for rt, s in ((banked, [slot]), (merged, [0])):
        state = rt.decode_state(1, 64)
        req = peft_lib.PrefillRequest(batch={"tokens": feed},
                                      last_idx=torch.as_tensor(len(prompt) - 1),
                                      ctx=rt.context(s))
        pre, state = steps.build_prefill_step(cfg)(rt.params, req, state)
        _, lg, _ = steps.build_decode_step(cfg)(
            rt.params, rt.context(s),
            torch.as_tensor([[int(first)]], device=device), state,
            torch.as_tensor([len(prompt)], device=device))
        logits.append((pre.float(), lg.float()))
    tol = rel * max(1.0, logits[1][1].abs().max().item())
    err = (logits[0][1] - logits[1][1]).abs().max().item()
    if not (torch.isfinite(logits[0][1]).all() and err <= tol):
        raise AssertionError(f"decode logits differ by {err} (tolerance {tol})")
    return err, tol, logits[0][0]


def merged_phase(cfg, seed: int, device, pcfg=None) -> dict:
    """f32: a one-adapter GSOFT bank (``pcfg``, default targets unless
    given) against the model with that adapter merged: equal greedy
    tokens, decode logits within LOGIT_TOL."""
    pcfg = pcfg or peft_lib.PEFTConfig(method="gsoft", block_size=32)
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
    err, tol, _ = _logits_gap(cfg, banked, 1, merged, prompt,
                              tokens["banked"][0], device)
    return dict(layers=cfg.num_layers, tokens=tokens["banked"],
                logit_max_abs_err=err, logit_tol=tol,
                merge_s=merge_s, merge_launches=merge_launches,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _reset_launches() -> None:
    for name in KERNELS:
        KERNELS[name]["fn"].launches = 0
    gk.gs_fused_T.slot_launches = qmk.gs_q_matmul.slot_launches = 0
    bk.bdmm.launches_by_route = {}


def _launches() -> dict:
    return {name: KERNELS[name]["fn"].launches for name in KERNELS}


def _slot_launches() -> dict:
    """The GSOFT rotation launches that read the bank by slot id."""
    return {"gs_fused_T": gk.gs_fused_T.slot_launches,
            "gs_q_matmul": qmk.gs_q_matmul.slot_launches}


def check_slot_path(phase: str, launches: dict, slot: dict,
                    names: tuple) -> None:
    """Fail unless each of ``names`` launched and every launch of it read
    the bank by slot id (no gathered factors)."""
    for name in names:
        if launches[name] == 0 or slot[name] != launches[name]:
            raise AssertionError(f"{phase}: {slot[name]} of {launches[name]} "
                                 f"{name} launches read the bank by slot id")


def _slices(pcfg, params) -> int:
    """Adapted weight slices (each its own adapter)."""
    return sum(math.prod(spec.batch)
               for spec in peft_lib.adapted_paths(pcfg, params).values())


def _rotations(pcfg, params) -> dict:
    """{path: kernel launches of one rotation pass}: one a stack (a chunk of
    whole layers, ``adapters.STACK_CHUNK_BYTES``) for the methods whose
    kernels take rows, one a slice for the others."""
    flat = peft_lib.flatten_paths(params)
    return {path: ad_lib.rotation_launches(spec, flat[path])
            for path, spec in peft_lib.adapted_paths(pcfg, params).items()}


def design_launches(pcfg, params) -> dict:
    """Kernel launches per train step the design predicts for ``pcfg`` on
    ``params``: DESIGN_LAUNCHES per rotation launch of each adapted
    weight stack (``_rotations``)."""
    want = {name: 0 for name in KERNELS}
    rot = _rotations(pcfg, params)
    for path, spec in peft_lib.adapted_paths(pcfg, params).items():
        b = spec.resolved_block(spec.d_in, spec.block_size)
        m = min(spec.boft_factors, ad_lib.max_butterfly_levels(spec.d_in, b))
        for name, per in DESIGN_LAUNCHES[pcfg.method](m).items():
            want[name] += per * rot[path]
    return want


def _launcher_run(cfg, method: str, seed: int, steps_n: int) -> dict:
    """``launch/train.py --peft method`` (which runs ``train()``) for
    ``steps_n`` steps at ``cfg``'s depth and remat, on the card; its output
    is echoed into this log."""
    argv = ["--arch", "qwen2-72b", "--peft", method, "--block-size",
            str(BDMM_BLOCK), "--steps", str(steps_n), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--warmup", "1", "--seed", str(seed), "--no-resume", "--set",
            f"num_layers={cfg.num_layers}", f"remat={cfg.remat}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  launcher: {line}")
    final = [float(line.split()[2]) for line in out.splitlines()
             if line.startswith("final loss")]
    if rc != 0 or len(final) != 1 or not math.isfinite(final[0]):
        raise AssertionError(f"launcher --peft {method} returned {rc}: {out}")
    return dict(argv=argv, final_loss=final[0],
                steps_logged=sum(line.startswith("step ")
                                 for line in out.splitlines()))


def train_phase(cfg, seed: int, device, steps_n: int = TRAIN_STEPS,
                method: str = "gsoft") -> dict:
    """Fine-tuning of the depth-cut model with ``method`` (b = 32):
    ``steps_n`` steps of ``build_train_step`` on one fixed batch (the
    counted main-path run; the loss must fall, the launches must equal the
    design's), one more under the profiler, then 3 steps of ``train()``
    (GSOFT directly, the others through the launcher)."""
    pcfg = peft_lib.PEFTConfig(method=method, block_size=BDMM_BLOCK)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=TRAIN_LR))
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed,
                      vocab_size=min(cfg.vocab_size, 256))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = peft_lib.init_peft(pcfg, params, device=device, seed=seed)
    trainable, frozen = peft_lib.trainable_and_frozen(pcfg, params, adapters)
    opt_state = optim.init(tcfg.opt, trainable)
    step = steps.build_train_step(cfg, tcfg)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in LMDataSource(dcfg).batch_at(0).items()}
    n_slices = _slices(pcfg, frozen)
    per_step = design_launches(pcfg, frozen)
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
    want = {k: steps_n * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{method}: launches {launches} != the design's "
                             f"{want} ({n_slices} adapted slices x {steps_n} "
                             f"steps)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # GSOFT: the GS kernels take W^T and dy as contiguous (d_out, d_in) tokens
    slabs = ({(s.d_out, s.d_in) for s in
              peft_lib.adapted_paths(pcfg, frozen).values()}
             if method == "gsoft" else None)
    prof = _profile(lambda: step(frozen, trainable, opt_state, batch), slabs)
    if method == "gsoft":
        by, share = gs_fwd_share(prof)
        prof["gs_fwd_device_ms_by_kernel"], prof["gs_fwd_share_of_busy"] = by, share
        # bf16 at b = 32: every gs_fused launch takes route 1 on the card
        if device.type == "cuda" and ("gs_fused_kernel" in by or not any(
                k.endswith("gs_fused_tc_kernel") for k in by)):
            raise AssertionError(f"the GSOFT step's gs_fused launches did "
                                 f"not all take route 1: {by}")
    step_s = float(np.median(times))
    del params, adapters, trainable, frozen, opt_state, step
    torch.cuda.empty_cache()

    bwd = BWD_KERNEL[method]
    _reset_launches()
    if method == "gsoft":
        out = train_loop.train(cfg, tcfg, dcfg,
                               train_loop.LoopConfig(steps=3, log_every=1),
                               log_fn=lambda msg: log(f"  train(): {msg}"),
                               device=device)
        loop = dict(history=out["history"])
        del out
        if len(loop["history"]) != 3 or not all(
                math.isfinite(h["loss"]) for h in loop["history"]):
            raise AssertionError(f"train() history {loop['history']}")
    else:
        loop = _launcher_run(cfg, method, seed, 3)
    loop["launches"] = _launches()
    torch.cuda.empty_cache()
    if loop["launches"][bwd] != 3 * per_step[bwd]:
        raise AssertionError(f"train() launches {loop['launches']}")
    return dict(method=method, layers=cfg.num_layers, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, lr=TRAIN_LR, remat=cfg.remat,
                adapted_slices=n_slices, losses=losses, grad_norms=gnorms,
                step_s=times, step_median_s=step_s,
                tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                launches=launches,
                launches_per_step={k: v / steps_n for k, v in launches.items()},
                design_per_step=per_step, peak_mem_gb=peak_gb,
                setup_s=setup_s, profile=prof, train_loop=loop)


def quick_step_phase(cfg, seed: int, device, method: str) -> dict:
    """One train step of a method that runs no kernel of the port
    (householder, givens, lora): a finite loss, and no GS or bdmm launch."""
    pcfg = peft_lib.PEFTConfig(method=method, block_size=BDMM_BLOCK)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = peft_lib.init_peft(pcfg, params, device=device, seed=seed)
    trainable, frozen = peft_lib.trainable_and_frozen(pcfg, params, adapters)
    opt_state = optim.init(tcfg.opt, trainable)
    batch = {k: torch.as_tensor(v, device=device) for k, v in LMDataSource(
        DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed,
                   vocab_size=min(cfg.vocab_size, 256))).batch_at(0).items()}
    _reset_launches()
    t0 = time.perf_counter()
    _, _, m = steps.build_train_step(cfg, tcfg)(frozen, trainable, opt_state,
                                                batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _launches()
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    del params, adapters, trainable, frozen, opt_state
    torch.cuda.empty_cache()
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"{method}: loss {loss}, grad norm {gnorm}")
    if any(launches.values()):
        raise AssertionError(f"{method} launched the port's kernels: "
                             f"{launches}")
    return dict(method=method, layers=cfg.num_layers, loss=loss,
                grad_norm=gnorm, step_s=step_s, launches=launches,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


@contextlib.contextmanager
def routing_piece(record: list, own: list = None):
    """``models.moe.route`` held to one routing piece: an empty ``record``
    fills with each call's routing, in call order; a filled one replays
    its experts, slots and kept set (the gates are recomputed from the
    router's probabilities), and ``own``, when given, receives the routing
    each call would have taken. Top-k and capacity are piecewise constant,
    so the loss jumps where a choice flips; autograd differentiates the
    piece the point lies on, which this holds the central differences (18c)
    and the mesh runs (20b) to."""
    orig = moe_lib.route
    replay = iter(list(record)) if record else None

    def route(router, xseg, cfg, cap):
        r = orig(router, xseg, cfg, cap)
        if replay is None:
            record.append(r)
            return r
        if own is not None:
            own.append(r)
        base = next(replay)
        gate = torch.gather(r.probs, -1, base.idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return moe_lib.Routing(base.idx, gate, base.slot, base.keep, r.probs)

    moe_lib.route = route
    try:
        yield
    finally:
        moe_lib.route = orig


def grad_phase(cfg, seed: int, device, method: str,
               seq: int = GRAD_SEQ, directions: int = 1,
               per_norm: bool = False) -> dict:
    """One train step's adapter gradients (autograd through the port's kernels)
    against central differences of the loss along ``directions`` seeded
    random directions, each checked, in f32 at a perturbed (non-identity)
    adapter point; the batch is GRAD_BATCH rows of ``seq`` tokens. The
    tolerance is FD_REL of |directional derivative|, or with ``per_norm``
    of the larger of that and |g|_2, the RMS of the directional derivative
    over random directions (entries of unit variance): a draw nearly
    orthogonal to g has a derivative below the differences' rounding,
    while an error e in g still shows as e . u, of RMS |e|_2. The
    top-level numbers are the worst direction's. An MoE config's
    differences are taken on the routing piece of the unperturbed point
    (``routing_piece``)."""
    pcfg = peft_lib.PEFTConfig(method=method, block_size=32)
    tcfg = steps.TrainStepConfig(peft=pcfg)
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = perturbed_adapters(pcfg, params, seed + 11, 0.02, device)
    batch = {k: torch.as_tensor(v, device=device) for k, v in LMDataSource(
        DataConfig(seq_len=seq, global_batch=GRAD_BATCH, seed=seed,
                   vocab_size=min(cfg.vocab_size, 256))).batch_at(0).items()}
    n_slices = _slices(pcfg, params)
    _reset_launches()
    loss, _, grads = steps.build_grad_fn(cfg, pcfg)(adapters, params, batch)
    torch.cuda.synchronize()
    launches = _launches()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 23)
    evaluate = steps.build_eval_step(cfg, tcfg)
    piece = []
    if cfg.is_moe:
        with routing_piece(piece):
            evaluate(params, adapters, batch)

    def loss_at(direction, step: float) -> float:
        with (routing_piece(piece) if cfg.is_moe
              else contextlib.nullcontext()):
            return float(evaluate(
                params, {p: {k: v + step * direction[p][k]
                             for k, v in e.items()}
                         for p, e in adapters.items()}, batch)["loss"])

    def central(direction, step: float) -> tuple:
        lp, lm = loss_at(direction, step), loss_at(direction, -step)
        return (lp - lm) / (2 * step), lp, lm

    gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                          for e in grads.values() for g in e.values()))
    checks = []
    for _ in range(directions):
        direction = {p: {k: torch.randn(v.shape, generator=gen,
                                        device=device)
                         for k, v in e.items()} for p, e in adapters.items()}
        deriv = sum(float((grads[p][k].double() * direction[p][k].double())
                          .sum()) for p in adapters for k in adapters[p])
        umax = max(float(u.abs().max()) for e in direction.values()
                   for u in e.values())
        h = min(FD_TARGET / max(abs(deriv), 1e-30), FD_MAX_STEP / umax)
        # Richardson: (4 D(h/2) - D(h)) / 3 cancels the h^2 term of the
        # central difference, leaving O(h^4) and the rounding of the four
        # losses
        fd_h, lp, lm = central(direction, h)
        fd_h2, _, _ = central(direction, h / 2)
        fd = (4 * fd_h2 - fd_h) / 3
        scale = max(abs(deriv), gnorm) if per_norm else abs(deriv)
        checks.append(dict(directional_derivative=deriv,
                           central_difference=fd, central_h=fd_h,
                           central_h2=fd_h2, h=h, loss_plus=lp,
                           loss_minus=lm, tol_scale=scale,
                           rel_err=abs(fd - deriv) / max(scale, 1e-300),
                           rel_to_derivative=abs(fd - deriv)
                           / max(abs(deriv), 1e-300)))
        del direction
    del grads, params, adapters
    torch.cuda.empty_cache()
    for name in GRAD_KERNELS[method]:
        if launches[name] == 0:
            raise AssertionError(f"{method}: {name} never launched in the "
                                 f"gradient step ({launches})")
    for c in checks:
        if not (math.isfinite(c["central_difference"])
                and c["rel_err"] <= FD_REL):
            raise AssertionError(
                f"{method} ({cfg.name}, |g| {gnorm:.4e}): "
                f"directional derivative vs central difference (h, rel) off "
                f"by more than {FD_REL}: " + "; ".join(
                    f"{d['directional_derivative']:.6e} vs "
                    f"{d['central_difference']:.6e} ({d['h']:.2e}, "
                    f"{d['rel_err']:.1e})" for d in checks))
    worst = max(checks, key=lambda c: c["rel_err"])
    return dict(method=method, layers=cfg.num_layers, loss=float(loss),
                adapted_slices=n_slices, directions=checks,
                grad_norm=gnorm, per_norm=per_norm,
                **worst, tol=FD_REL, launches=launches,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def mixed_cfgs() -> dict:
    """The mixed bank's tenants: one per bankable method, b = 32."""
    return {f"t_{m}": peft_lib.PEFTConfig(method=m, block_size=BDMM_BLOCK)
            for m in ("gsoft", "oft", "boft", "householder", "givens")}


def _mixed_adapters(cfgs, params, seed: int, device) -> dict:
    """Identity adapters plus N(0, MIXED_SCALE^2) noise, as
    tests/test_methods.py perturbs them."""
    return {n: perturbed_adapters(c, params, seed + 1 + i, MIXED_SCALE, device)
            for i, (n, c) in enumerate(cfgs.items())}


def _one(rt, prompt, adapter, max_new: int = 8):
    eng = ServeEngine(rt, max_batch=1, max_len=64, eos_id=-1)
    rid = eng.add_request(list(prompt), max_new_tokens=max_new, adapter=adapter)
    return eng.run()[rid]


def mixed_serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """One bank of gsoft, oft, boft, householder and givens tenants built by
    ``attach(adapters, {name: PEFTConfig})``; 12 requests (two per tenant,
    two on the base slot; prompts of 16-128 tokens, 16 new tokens each) on
    4 slots. The first run is the counted main-path run; ``repeats`` runs
    give the median rate; one more runs under the profiler."""
    cfgs = mixed_cfgs()
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    rt = base.attach(_mixed_adapters(cfgs, base.params, seed, device), cfgs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    methods_in_bank = rt.bank.bank_methods
    if methods_in_bank != tuple(sorted(c.method for c in cfgs.values())):
        raise AssertionError(f"bank methods {methods_in_bank}")
    rng = np.random.default_rng(seed + 100)
    order = list(cfgs) + [None]
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                        size=MIXED_SERVE_REQUESTS)
    work = [(rng.integers(1, cfg.vocab_size, size=int(n)).tolist(),
             order[i % len(order)]) for i, n in enumerate(lens)]

    def drive():
        eng = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
        for prompt, adapter in work:
            eng.add_request(prompt, max_new_tokens=16, adapter=adapter)
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        return eng, results, time.perf_counter() - t0

    warm = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
    for name in cfgs:
        warm.add_request([1, 2, 3], max_new_tokens=2, adapter=name)
    warm.run()
    _reset_launches()
    eng, results, wall = drive()
    launches = _launches()
    slot = _slot_launches()
    bdmm_routes = dict(bk.bdmm.launches_by_route)
    if len(results) != MIXED_SERVE_REQUESTS or any(
            len(v) != 16 for v in results.values()):
        raise AssertionError(f"served {len(results)} of "
                             f"{MIXED_SERVE_REQUESTS} requests")
    if not all(0 <= t < cfg.padded_vocab() for v in results.values()
               for t in v):
        raise AssertionError("served a token outside the vocabulary")
    for name in ("gs_fused_T", "bdmm"):
        if launches[name] == 0:
            raise AssertionError(f"mixed serving never launched {name}: "
                                 f"{launches}")
    if (launches["bdmm_dblocks"] or launches["gs_fused_bwd"]
            or launches["gs_fused_grads"]):
        raise AssertionError(f"serving launched a backward kernel: {launches}")
    check_slot_path("mixed serve", launches, slot, ("gs_fused_T",))
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w = drive()
        if again != results:
            raise AssertionError("a repeated run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    _SPENT["timed"] += sum(walls)
    return dict(layers=cfg.num_layers, tenants=list(cfgs),
                bank_methods=list(methods_in_bank), requests=len(results),
                prompt_lens=[int(n) for n in lens], tokens=toks,
                wall_s=walls, wall_median_s=wall_med, tok_s=toks / wall_med,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"], setup_s=setup_s,
                launches=launches, slot_launches=slot,
                bdmm_launches_by_route=bdmm_routes,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                profile=_profile(drive))


def mixed_check_phase(cfg, seed: int, device) -> dict:
    """f32: each tenant of the mixed bank (served together, 4 slots) gives
    the tokens of its solo offline-merged run, with decode logits within
    tolerance, and prefill logits other than the base slot's; the base
    slot gives the bankless model's tokens."""
    cfgs = mixed_cfgs()
    base = ModelRuntime(cfg, seed=seed, device=device)
    adapters = _mixed_adapters(cfgs, base.params, seed + 50, device)
    banked = base.attach(adapters, cfgs)
    prompt = np.random.default_rng(seed + 5).integers(1, cfg.vocab_size, 24)
    eng = ServeEngine(banked, max_batch=4, max_len=64, eos_id=-1)
    rids = {n: eng.add_request(prompt.tolist(), max_new_tokens=8, adapter=n)
            for n in list(cfgs) + [None]}
    res = eng.run()
    tokens = {n: res[r] for n, r in rids.items()}
    solo = {None: _one(base, prompt, None)}
    if tokens[None] != solo[None]:
        raise AssertionError(f"base slot {tokens[None]} != bankless model "
                             f"{solo[None]}")
    gaps = {}
    for name, pcfg in cfgs.items():
        merged = ModelRuntime(cfg, base.params, device=device,
                              adapters=adapters[name], peft_cfg=pcfg)
        solo[name] = _one(merged, prompt, None)
        if tokens[name] != solo[name]:
            raise AssertionError(f"{name}: banked {tokens[name]} != solo "
                                 f"merged {solo[name]}")
        gaps[name] = _logits_gap(cfg, banked, banked.bank.slot(name), merged,
                                 prompt, tokens[name][0], device)
        del merged
        torch.cuda.empty_cache()
    # each tenant's rotation really runs: its prefill logits differ from the
    # base slot's (a tenant may still pick the base's tokens: Householder's
    # 4 reflections move only a 4-dimensional slice of d = 8192)
    base_pre = _logits_gap(cfg, banked, 0, base, prompt, tokens[None][0],
                           device)[2]
    moved = {n: (g[2] - base_pre).abs().max().item() for n, g in gaps.items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"a tenant's prefill logits equal the base "
                             f"slot's: {moved}")
    return dict(layers=cfg.num_layers, tokens={str(k): v for k, v in
                                               tokens.items()},
                distinct_tenant_tokens=len({tuple(v) for v in tokens.values()}),
                logit_max_abs_err={k: v[0] for k, v in gaps.items()},
                logit_tol={k: v[1] for k, v in gaps.items()},
                prefill_logit_gap_to_base=moved,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


# ---------------------------------------------------------------------------
# phase 3d: quantized matmuls and paged decode attention
# ---------------------------------------------------------------------------

def _bytes_bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _codes(gen, k: int, n: int, device):
    """int8 codes and per-channel scales of a seeded normal (k, n) weight."""
    return quantize_int8(torch.randn((k, n), generator=gen, device=device),
                         axis=-1)


def _weight_sets(first, make, nbytes: int) -> list:
    """``first`` plus fresh argument sets until together they exceed the
    50 MB L2 (at most 8), so the timed weights come from device memory."""
    n_sets = int(min(8, max(1, math.ceil(120e6 / nbytes))))
    return [first] + [make() for _ in range(n_sets - 1)]


def _err_ok(err: float, tol: float) -> bool:
    return math.isfinite(err) and err <= tol


def qmm_cases(cfg):
    """(M, K, N): the LM head (K = d_model, N = vocab) and every projection
    shape at decode (B = 4 rows, and one row) and at one prefill chunk."""
    D, F, KV = cfg.d_model, cfg.d_ff, cfg.num_kv_heads * cfg.d_head
    shapes = [(D, cfg.padded_vocab()), (D, D), (D, KV), (D, F), (F, D)]
    return [(m, k, n) for m in (1, 4, PREFILL_CHUNK) for k, n in shapes]


def check_qmm_case(M, K, N, dtype, gen, device) -> dict:
    q, s = _codes(gen, K, N, device)
    x = (torch.randn((M, K), generator=gen, device=device)
         / math.sqrt(K)).to(dtype)
    y = qmk.q_matmul(x, q, s)
    torch.cuda.synchronize()
    want = qmk.q_matmul_plain(x, q, s)
    err = (y.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        tol = QMM_F32_TOL * (1.0 + want.abs().max().item())
    else:
        tol = QMM_BF16_REL * want.float().abs().max().item()
    if not _err_ok(err, tol):
        raise AssertionError(f"q_matmul M={M} K={K} N={N} {dtype}: max|err| "
                             f"{err} > {tol}")
    del want
    sets = _weight_sets((x, q, s), lambda: (x,) + _codes(gen, K, N, device),
                        K * N)
    ms = time_ms(qmk.q_matmul, sets)
    plain_ms = time_ms(qmk.q_matmul_plain, sets[:1])
    lib = lambda xx, qq, ss: (xx @ qq.to(xx.dtype)) * ss   # noqa: E731
    lib_ms = time_ms(lib, sets[:1])
    es = x.element_size()
    bound_ms, bound_by = _bytes_bound(M * K * es + K * N + 4 * N + M * N * es,
                                      2 * M * K * N, dtype)
    plan = qmk.qmm_geometry(M, K, N, es)
    return dict(kernel="q_matmul", M=M, K=K, N=N, tokens=plan.ntok,
                boxes=plan.ntw, stages=plan.stages, ctas=plan.grid,
                k_splits=plan.splits, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_what="(x @ q.to(x.dtype)) * scale",
                bound_ms=bound_ms, bound_by=bound_by)


def gsq_cases(cfg):
    """(B, T, d, N): each adapted projection's input width and output width
    at decode (B = 4 rows of one token) and at one prefill chunk; and the
    wq-like shape at a width past 32768 at decode."""
    D, F, KV = cfg.d_model, cfg.d_ff, cfg.num_kv_heads * cfg.d_head
    shapes = [(D, D), (D, KV), (D, F), (F, D)]
    return [(bsz, t, d, n) for bsz, t in ((4, 1), (1, PREFILL_CHUNK))
            for d, n in shapes] + [(4, 1, 33 * 1024, D)]


def check_gsq_case(B, T, d, N, b, dtype, gen, device) -> dict:
    """``gs_q_matmul`` through its slot-id entry (``gs_q_matmul_bank``,
    rows on their own slots of a SLOTS-slot fp32 bank) against the gather
    and its plain version; times of the call, the plain version, the
    library yardstick (the bank rotation, then one cuBLAS product of x and
    the widened codes) and ``q_matmul`` alone on x (the product without
    the rotation); the bound counts x, the bank slots read, the codes and
    scales once, and y."""
    r = d // b
    ids = _slot_ids(B, device)
    q, s = _codes(gen, d, N, device)
    x = (torch.randn((B, T, d), generator=gen, device=device)
         / math.sqrt(d)).to(dtype)
    args = (x,) + _bank(gen, r, b, device) + (ids, q, s)
    y = qmk.gs_q_matmul_bank(*args)
    torch.cuda.synchronize()
    want = qmk.gs_q_matmul_bank_plain(*args)
    err = (y.float() - want.float()).abs().max().item()
    rel = GSQ_F32_REL if dtype == torch.float32 else GSQ_BF16_REL
    tol = rel * max(1.0, want.float().abs().max().item())
    if not _err_ok(err, tol):
        raise AssertionError(f"gs_q_matmul B={B} T={T} d={d} N={N} {dtype}: "
                             f"max|err| {err} > {tol}")
    del want
    again = qmk.gs_q_matmul_bank(*args)
    if not torch.equal(again, y):
        raise AssertionError(f"gs_q_matmul B={B} T={T} d={d} N={N} {dtype}: "
                             f"a rerun differs")
    del again
    sets = _weight_sets(
        args, lambda: (x,) + _bank(gen, r, b, device) + (ids,)
        + _codes(gen, d, N, device), d * N)
    ms = time_ms(qmk.gs_q_matmul_bank, sets)
    plain_ms = time_ms(qmk.gs_q_matmul_bank_plain, sets[:1])

    def lib(xx, LL, RR, ii, qq, ss):     # the rotation kernel, then cuBLAS
        return (gk.gs_fused_T_bank(xx, LL, RR, ii) @ qq.to(xx.dtype)) * ss

    lib_ms = time_ms(lib, sets[:1])
    # the same product without the rotation: what the rotation adds
    flat = [(a[0].reshape(B * T, d), a[4], a[5]) for a in sets]
    qmm_ms = time_ms(qmk.q_matmul, flat)
    rot_ms = time_ms(gk.gs_fused_T_bank, [a[:4] for a in sets])
    es = x.element_size()
    nbytes = (B * T * d * es + _bank_bytes(ids, args[1]) + d * N + 4 * N
              + B * T * N * es)
    bound_ms, bound_by = _bytes_bound(nbytes, 4 * B * T * d * b
                                      + 2 * B * T * d * N, dtype)
    plan = (dict(zip(("tokens_per_tile", "cols_per_cta", "k_splits",
                      "k_rows_per_split"),
                     qmk.gsq_plan(B * T, d, N, qmk._num_sms())))
            if dtype == torch.bfloat16 else None)
    return dict(kernel="gs_q_matmul", B=B, T=T, d=d, N=N, b=b, plan=plan,
                rotation_route=gk.t_plan(B, T, r, b, gk._DTYPES[dtype],
                                         gk._num_sms(device)).route,
                slots=ids.tolist(), dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                library_what="gs_fused_T_bank, then (x @ q.to(x.dtype)) * "
                             "scale",
                q_matmul_ms=qmm_ms, rotation_ms=rot_ms,
                bound_ms=bound_ms, bound_by=bound_by)


PAGED_LENS = {"ctx144": [144, 144, 144, 144],
              "ragged_parked": [17, 80, 200, None],     # None: a parked row
              "ctx4096": [4096, 4096, 4096, 4096]}
# a case's table holds this many keys a row (the serve phase's tables,
# W = SERVE_MAX_LEN / page, unless named here)
PAGED_TABLE_KEYS = {"ctx4096": 4096}
# (page, lens): the serve phase's page size and page 16 at its table width,
# and long rows through a page-16 table
PAGED_CASES = [(page, lens) for page in (8, 16)
               for lens in ("ctx144", "ragged_parked")] + [(16, "ctx4096")]


def check_paged_case(cfg, page: int, lens_name: str, dtype, gen,
                     device) -> dict:
    """B = 4 rows of qwen2-72b's attention (64 query heads over 8 KV heads,
    d_head 128) through a stall-free pool of the serve phase's geometry
    (W = max_len / page table columns; ``PAGED_TABLE_KEYS`` for longer
    rows); a parked row has an all-garbage table and kv_len = W * page + 1,
    as the engine parks it."""
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    W = PAGED_TABLE_KEYS.get(lens_name, SERVE_MAX_LEN) // page
    lens = PAGED_LENS[lens_name]
    B = len(lens)
    npages = B * W + 1
    kp = torch.randn((npages, page, KH, D), generator=gen,
                     device=device).to(dtype)
    vp = torch.randn((npages, page, KH, D), generator=gen,
                     device=device).to(dtype)
    q = torch.randn((B, H, D), generator=gen, device=device).to(dtype)
    table = torch.zeros((B, W), dtype=torch.int32, device=device)
    kv_len = torch.zeros(B, dtype=torch.int32, device=device)
    for i, n in enumerate(lens):
        if n is None:                       # parked: garbage page only
            kv_len[i] = W * page + 1
            continue
        table[i, :W] = torch.arange(1 + i * W, 1 + (i + 1) * W)
        kv_len[i] = n
    out = pak.paged_decode(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    want = pak.paged_decode_plain(q, kp, vp, table, kv_len)
    err = (out.float() - want.float()).abs().max().item()
    tol = (PAGED_F32_TOL * max(1.0, want.abs().max().item())
           if dtype == torch.float32
           else PAGED_BF16_REL * want.float().abs().max().item())
    if not _err_ok(err, tol):
        raise AssertionError(f"paged_decode page={page} {lens_name} {dtype}: "
                             f"max|err| {err} > {tol}")
    args = [(q, kp, vp, table, kv_len)]
    ms = time_ms(pak.paged_decode, args)
    plain_ms = time_ms(pak.paged_decode_plain, args)
    G = H // KH

    def lib(qq, kk, vv, tbl, lens_):       # table gather, then SDPA
        k = kk[tbl.long()].reshape(B, -1, KH, D).transpose(1, 2)
        v = vv[tbl.long()].reshape(B, -1, KH, D).transpose(1, 2)
        mask = (torch.arange(k.shape[2], device=device)[None, :]
                < lens_[:, None])[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(
            qq.reshape(B, KH, G, D), k, v, attn_mask=mask)

    lib_ms = time_ms(lib, args)
    lib_err = (lib(*args[0]).reshape(B, H, D).float()
               - want.float()).abs().max().item()
    keys = sum(min(int(n), W * page) for n in kv_len.tolist())
    es = q.element_size()
    nbytes = 2 * B * H * D * es + 2 * keys * KH * D * es + 4 * B * (W + 1)
    bound_ms, bound_by = _bytes_bound(nbytes, 4 * H * D * keys, dtype)
    # kv_len lies on the card: the wrapper plans from the table's width
    plan = pak.paged_plan(B, KH, W, page, W * page, gk._num_sms(device),
                          groups=G, d=D)
    return dict(kernel="paged_decode", B=B, H=H, KH=KH, D=D, page=page, W=W,
                splits=plan["splits"], ctas=plan["ctas"],
                lens=lens_name, kv_len=kv_len.tolist(),
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_err=lib_err,
                library_what="table gather + scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phases 4b and 5b: paged KV serving over int8 weights
# ---------------------------------------------------------------------------

def _paged_engine(rt, max_batch: int, max_len: int) -> PagedServeEngine:
    return PagedServeEngine(rt, max_batch=max_batch, max_len=max_len,
                            eos_id=-1, page_size=PAGE_SIZE,
                            prefill_chunk=PREFILL_CHUNK)


def paged_quant_serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """The serve launcher's paged int8 path at full width: 3 GSOFT tenants
    (b = 32) and the base, the runtime quantized to int8 (each bf16 weight
    freed once its codes exist), 8 requests (prompts of 16-128 tokens;
    requests 0 and 4 of one tenant share a 64-token prefix) on 4 slots of
    ``PagedServeEngine`` (page 8, chunk 16), 16 new tokens each. The first
    run is the counted main-path run; ``repeats`` runs give the median
    rate; one more runs under the profiler."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    banked = base.attach({n: perturbed_adapters(pcfg, base.params,
                                                seed + 1 + i, 0.05, device)
                          for i, n in enumerate(names)}, pcfg)
    bf16_bytes = tree_bytes(banked.params)
    del base
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tq = time.perf_counter()
    rt = banked.quantized("int8", release_source=True)
    del banked
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - tq
    quantize_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    setup_s = time.perf_counter() - t0
    int8_bytes = tree_bytes(rt.params)
    rng = np.random.default_rng(seed + 200)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=8)
    prefix = rng.integers(1, cfg.vocab_size, size=SHARED_PREFIX).tolist()
    order = names + [None]
    work = []
    for i, n in enumerate(lens):
        if i in (0, 4):                     # one tenant, one shared prefix
            n = max(int(n), SHARED_PREFIX + 8) - SHARED_PREFIX
            prompt = prefix + rng.integers(1, cfg.vocab_size, size=n).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
        work.append((prompt, order[i % 4]))

    def drive():
        eng = _paged_engine(rt, 4, SERVE_MAX_LEN)
        for prompt, adapter in work:
            eng.add_request(prompt, max_new_tokens=16, adapter=adapter)
        t0 = time.perf_counter()
        peak_pages = 0
        while eng.step():
            peak_pages = max(peak_pages, eng.pool.in_use)
        results = eng.run()
        torch.cuda.synchronize()
        return eng, results, time.perf_counter() - t0, peak_pages

    warm = _paged_engine(rt, 4, SERVE_MAX_LEN)
    for name in names:
        warm.add_request([1, 2, 3], max_new_tokens=2, adapter=name)
    warm.run()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    eng, results, wall, peak_pages = drive()
    launches = _launches()
    slot = _slot_launches()
    if len(results) != 8 or any(len(v) != 16 for v in results.values()):
        raise AssertionError(f"served {len(results)} of 8 requests: "
                             f"{ {k: len(v) for k, v in results.items()} }")
    if not all(0 <= t < cfg.padded_vocab() for v in results.values()
               for t in v):
        raise AssertionError("served a token outside the vocabulary")
    for name in ("q_matmul", "gs_q_matmul", "paged_decode"):
        if launches[name] == 0:
            raise AssertionError(f"paged int8 serving never launched {name}: "
                                 f"{launches}")
    if (launches["gs_fused_T"] or launches["gs_fused_bwd"]
            or launches["gs_fused_grads"] or launches["bdmm"]):
        raise AssertionError(f"the fused int8 path launched another "
                             f"rotation kernel: {launches}")
    check_slot_path("paged int8 serve", launches, slot, ("gs_q_matmul",))
    kv = eng.kv_stats()
    if kv["prefix_hits"] < 1:
        raise AssertionError(f"the shared 64-token prefix was never reused: "
                             f"{kv}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w, _ = drive()
        if again != results:
            raise AssertionError("a repeated paged run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    _SPENT["timed"] += sum(walls)
    page_bytes = kv_page_bytes(cfg, PAGE_SIZE)
    contiguous_kv = (2 * cfg.num_layers * 4 * SERVE_MAX_LEN
                     * cfg.num_kv_heads * cfg.d_head
                     * torch.empty((), dtype=cfg.act_dtype).element_size())
    return dict(layers=cfg.num_layers, requests=len(results),
                prompt_lens=[len(p) for p, _ in work], tokens=toks,
                wall_s=walls, wall_median_s=wall_med, tok_s=toks / wall_med,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"], setup_s=setup_s,
                quantize_s=quantize_s, launches=launches,
                slot_launches=slot,
                params_bytes_bf16=bf16_bytes, params_bytes_int8=int8_bytes,
                quantize_peak_gb=quantize_peak_gb, serve_peak_gb=peak_gb,
                kv_stats=kv, kv_pages_peak=peak_pages,
                kv_bytes_peak=peak_pages * page_bytes,
                kv_pool_bytes=eng.num_pages * page_bytes,
                contiguous_kv_bytes=contiguous_kv,
                profile=_profile(drive))


def paged_quant_check_phase(cfg, seed: int, device) -> dict:
    """f32 at full width: on a GSOFT bank (one tenant and the base), paged
    tokens equal contiguous tokens, unquantized and over int8; the base slot
    over int8 equals the bankless int8 model; the banked int8 decode logits
    lie within QUANT_LOGIT_REL of "merge, then quantize"; each of the three
    kernels of the int8 paged path launched."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    adapter = perturbed_adapters(pcfg, base.params, seed + 9, 0.05, device)
    banked = base.attach({"a": adapter}, pcfg)
    qbanked = banked.quantized("int8")
    rng = np.random.default_rng(seed + 6)
    p1 = rng.integers(1, cfg.vocab_size, 40).tolist()    # three chunks
    p2 = rng.integers(1, cfg.vocab_size, 24).tolist()

    def serve(rt, paged: bool, work):
        eng = (_paged_engine(rt, 2, 64) if paged else
               ServeEngine(rt, max_batch=2, max_len=64, eos_id=-1))
        rids = [eng.add_request(p, max_new_tokens=8, adapter=a)
                for p, a in work]
        res = eng.run()
        return [res[r] for r in rids]

    work = [(p1, "a"), (p2, None)]
    _reset_launches()
    tokens = {}
    for name, rt in (("f32", banked), ("int8", qbanked)):
        tokens[name] = {"paged": serve(rt, True, work),
                        "contiguous": serve(rt, False, work)}
        if tokens[name]["paged"] != tokens[name]["contiguous"]:
            raise AssertionError(f"{name}: paged {tokens[name]['paged']} != "
                                 f"contiguous {tokens[name]['contiguous']}")
    launches = _launches()
    for name in ("q_matmul", "gs_q_matmul", "paged_decode"):
        if launches[name] == 0:
            raise AssertionError(f"the f32 check never launched {name}")
    bare = ModelRuntime(cfg, qbanked.params, device=device)
    base_tokens = serve(bare, True, [(p2, None)])[0]
    if base_tokens != tokens["int8"]["paged"][1]:
        raise AssertionError(f"base slot {tokens['int8']['paged'][1]} != "
                             f"bankless int8 model {base_tokens}")
    merged = ModelRuntime(cfg, base.params, device=device, adapters=adapter,
                          peft_cfg=pcfg).quantized("int8")
    err, tol, _ = _logits_gap(cfg, qbanked, 1, merged, np.asarray(p1),
                              tokens["int8"]["paged"][0][0], device,
                              rel=QUANT_LOGIT_REL)
    scale = tol / QUANT_LOGIT_REL
    return dict(layers=cfg.num_layers, tokens=tokens, launches=launches,
                quant_vs_merged_max_abs=err, quant_vs_merged_rel=err / scale,
                quant_vs_merged_tol=tol,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


# ---------------------------------------------------------------------------
# phases 3e and 3f: the SSD scan and flash attention
# ---------------------------------------------------------------------------

def ssd_cases():
    """(Nb, T, H, P, N): zamba2's heads (80, P = N = 64) and mamba2-130m's
    (24, N = 128) at every prefill bucket the serve phase can take, plus
    the 13b check's T = 512 for mamba2; zamba2's at T = 2048 (8 chunks of
    256 for the plain version, 32 of the kernel's 64: the carried state),
    batch 1 and 4; T = 1000 (JAX's kernel path halves its chunk to 8); batch
    4 at the longest bucket."""
    z = (80, 64, 64)
    m = (24, 64, 128)
    out = [(1, t) + z for t in prefill_buckets()]
    out += [(1, t) + m for t in prefill_buckets() + [SSM_CHECK_T]]
    out += [(1, 2048) + z, (4, 2048) + z, (1, 1000) + z,
            (4, max(prefill_buckets())) + z]
    return out


def ssd_bound(nb, t, h, p, n, dtype) -> tuple:
    """Bytes (x, loga, B, C read once, y written once) over the memory rate,
    or the function's own operations over the fp32 rate (all state math is
    fp32): the recurrence S_t = a_t S_{t-1} + B_t x_t^T, y_t = C_t^T S_t,
    2 Nb T H (N + P + 2 N P), which is the chunked count at a chunk of one
    step; a longer chunk is the kernel's choice, not the function's work."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * nb * t * h * p + nb * t * h + 2 * nb * t * h * n) * es
    flops = 2 * nb * t * h * (n + p + 2 * n * p)
    return _bytes_bound(nbytes, flops, torch.float32)


def check_ssd_case(nb, t, h, p, n, dtype, gen, device) -> dict:
    def mk(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    x = mk(nb, t, h, p)
    loga = (-(torch.randn((nb, t, h), generator=gen, device=device).abs())
            * 0.3).to(dtype)
    B, C = mk(nb, t, h, n, scale=0.5), mk(nb, t, h, n, scale=0.5)
    args = (x, loga, B, C)
    y = ssdk.ssd(*args)
    torch.cuda.synchronize()
    want = ssdk.ssd_plain(*args)
    err = (y.float() - want.float()).abs().max().item()
    rel = SSD_F32_REL if dtype == torch.float32 else SSD_BF16_REL
    tol = rel * want.float().abs().max().item()
    if not _err_ok(err, tol):
        raise AssertionError(f"ssd Nb={nb} T={t} H={h} P={p} N={n} {dtype}: "
                             f"max|err| {err} > {tol}")
    ms = time_ms(ssdk.ssd, [args])
    plain_ms = time_ms(ssdk.ssd_plain, [args])
    bound_ms, bound_by = ssd_bound(nb, t, h, p, n, dtype)
    return dict(kernel="ssd", Nb=nb, T=t, H=h, P=p, N=n,
                p_tile=ssdk.ssd_geometry(p, n),
                chunk=ssdk.CHUNK, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=None,
                library_what="none: no single PyTorch call computes the scan",
                bound_ms=bound_ms, bound_by=bound_by)


# gemma-7b's attention heads (src/repro/configs/gemma_7b.py: 16 heads, 16
# KV heads, head_dim 256), written out: this script imports nothing of the
# JAX package
GEMMA_HEADS = (16, 16, 256)


def flash_cases(qwen, zamba):
    """(name, B, H, KH, Sq, Sk, D, causal): qwen2-72b's heads (64 / 8, D
    128, through ops.flash_mha's GQA) and zamba2's (32 / 32, D 80) at S of
    128, 512 and 2048, causal and not, and a ragged causal Sq of 1000;
    gemma-7b's (16 / 16, D 256: two feature chunks) at S of 512 and 2048,
    causal; D = 320 (three chunks, the last half padding), S = 1024."""
    out = []
    for name, cfg in (("qwen2-72b", qwen), ("zamba2-2.7b", zamba)):
        hd = (cfg.num_heads, cfg.num_kv_heads, cfg.d_head)
        for s_len in (128, 512, 2048):
            for causal in (True, False):
                out.append((name, 1, *hd[:2], s_len, s_len, hd[2], causal))
        out.append((name, 1, *hd[:2], 1000, 1000, hd[2], True))
    for s_len in (512, 2048):
        out.append(("gemma-7b", 1, *GEMMA_HEADS[:2], s_len, s_len,
                    GEMMA_HEADS[2], True))
    out.append(("D=320", 1, 8, 8, 1024, 1024, 320, True))
    return out


def flash_bound(b, h, kh, sq, sk, d, causal, dtype) -> tuple:
    """q, k, v read once and the output written once, or 4 B H Sq Sk D
    operations (halved when causal) at the dtype's rate."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kh * d) * es
    flops = 4 * b * h * sq * sk * d // (2 if causal else 1)
    return _bytes_bound(nbytes, flops, dtype)


def check_flash_case(name, b, h, kh, sq, sk, d, causal, dtype, gen,
                     device) -> dict:
    """Through ``ops.flash_mha`` on (B, S, H, D) activations: the kernel
    reads that layout in place and KV head h // (H / KH)."""
    def mk(s_len, heads):
        return torch.randn((b, s_len, heads, d), generator=gen,
                           device=device).to(dtype)

    q, k, v = mk(sq, h), mk(sk, kh), mk(sk, kh)
    args = (q, k, v)
    run = lambda qq, kk, vv: ops.flash_mha(qq, kk, vv, causal=causal)

    def plain(qq, kk, vv):
        return fak.flash_attention_plain(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            causal=causal).transpose(1, 2)

    def lib(qq, kk, vv):
        return torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            is_causal=causal, enable_gqa=h != kh).transpose(1, 2)

    out = run(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    err = (out.float() - want.float()).abs().max().item()
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    if not (torch.isfinite(out).all() and torch.allclose(
            out.float(), want.float(), atol=tol, rtol=tol)):
        raise AssertionError(f"flash_attention {name} S={sq} causal={causal} "
                             f"{dtype}: max|err| {err} (atol = rtol = {tol})")
    ms = time_ms(run, [args])
    plain_ms = time_ms(plain, [args])
    lib_ms = time_ms(lib, [args])
    lib_err = (lib(*args).float() - want.float()).abs().max().item()
    bound_ms, bound_by = flash_bound(b, h, kh, sq, sk, d, causal, dtype)
    plan = fak.flash_plan(d, dtype)
    return dict(kernel="flash_attention", heads=name, B=b, H=h, KH=kh, Sq=sq,
                Sk=sk, D=d, causal=causal, route=plan["route"],
                splits=plan["splits"],
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_err=lib_err,
                library_what="scaled_dot_product_attention",
                bound_ms=bound_ms, bound_by=bound_by)


def flash_refusal(device) -> str:
    """A non-causal Sk that is no multiple of the block raises ValueError,
    as the JAX kernel does; returns the message."""
    q = torch.zeros((1, 200, 2, 64), device=device)
    try:
        ops.flash_mha(q, q, q, causal=False)
    except ValueError as e:
        return str(e)
    raise AssertionError("non-causal flash with Sk = 200, blk 128 did not "
                         "raise")


def flash_entry_phase(qwen, zamba, gen, device) -> dict:
    """The public entry point ``ops.flash_mha`` driven once at each model's
    heads (bf16, S = 512, causal): flash attention's path, with its launch
    count read from just this run."""
    work = []
    for cfg in (qwen, zamba):
        mk = lambda heads: torch.randn(
            (1, 512, heads, cfg.d_head), generator=gen,
            device=device).to(torch.bfloat16)
        work.append((mk(cfg.num_heads), mk(cfg.num_kv_heads),
                     mk(cfg.num_kv_heads)))
    _reset_launches()
    outs = [ops.flash_mha(*a, causal=True) for a in work]
    torch.cuda.synchronize()
    launches = _launches()
    if launches["flash_attention"] != len(work) or any(
            v for k, v in launches.items() if k != "flash_attention"):
        raise AssertionError(f"ops.flash_mha launches {launches}")
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("ops.flash_mha gave a non-finite value")
    return dict(calls=len(work), launches=launches)


# ---------------------------------------------------------------------------
# phases 13 and 13b: the Mamba2 families
# ---------------------------------------------------------------------------

def hybrid_serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """The serve launcher's continuous lane for ``--arch zamba2-2.7b`` (a
    bankless ``ModelRuntime`` from the seed, ``ServeEngine``) at full width
    and depth: 8 requests (prompts of 16-128 tokens, 16 new tokens each) on
    4 slots. The first run is the counted main-path run: one ssd launch
    per Mamba layer per prefill, no other kernel of the port; ``repeats``
    runs give the median rate; one more runs under the profiler."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = ModelRuntime(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params_bytes = tree_bytes(rt.params)
    rng = np.random.default_rng(seed + 300)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                        size=HYBRID_REQUESTS)
    work = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
            for n in lens]

    def drive():
        eng = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
        for prompt in work:
            eng.add_request(prompt, max_new_tokens=16)
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        return eng, results, time.perf_counter() - t0

    warm = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
    warm.add_request([1, 2, 3], max_new_tokens=2)
    warm.run()
    _reset_launches()
    eng, results, wall = drive()
    launches = _launches()
    if len(results) != HYBRID_REQUESTS or any(len(v) != 16
                                              for v in results.values()):
        raise AssertionError(f"served {len(results)} of {HYBRID_REQUESTS} "
                             f"requests: "
                             f"{ {k: len(v) for k, v in results.items()} }")
    if not all(0 <= t < cfg.padded_vocab() for v in results.values()
               for t in v):
        raise AssertionError("served a token outside the vocabulary")
    want = cfg.num_layers * eng.stats["prefills"]
    if launches["ssd"] != want or any(v for k, v in launches.items()
                                      if k != "ssd"):
        raise AssertionError(f"hybrid serving launched {launches}; the "
                             f"design is ssd x {want} (one per Mamba layer "
                             f"per prefill) and nothing else")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w = drive()
        if again != results:
            raise AssertionError("a repeated hybrid run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    _SPENT["timed"] += sum(walls)
    return dict(layers=cfg.num_layers, requests=len(results),
                prompt_lens=[int(n) for n in lens], tokens=toks,
                wall_s=walls, wall_median_s=wall_med, tok_s=toks / wall_med,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"], setup_s=setup_s,
                launches=launches, params_bytes=params_bytes,
                peak_mem_gb=peak_gb, profile=_profile(drive))


def hybrid_launcher_run(arch: str) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch>`` on the card
    (the continuous lane, 8 mixed-length requests): it must serve them all."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(["--arch", arch, "--requests", "8",
                                "--prompt-len", "128", "--max-new", "16",
                                "--mixed-lengths"])
    text = buf.getvalue()
    if rc != 0 or "[continuous] served 8 requests" not in text:
        raise AssertionError(f"the serve launcher failed (rc {rc}):\n{text}")
    return dict(rc=rc, wall_s=time.perf_counter() - t0,
                report=text.strip().splitlines())


def _decode_logits(cfg, rt, tokens, device) -> torch.Tensor:
    """Token-by-token ``decode_step`` from the empty state: (1, T, Vp)."""
    fam = api.family_ops(cfg)
    state = fam.init_decode_state(cfg, 1, tokens.shape[1] + 1, device)
    step = steps.build_decode_step(cfg)
    out = []
    for t in range(tokens.shape[1]):
        _, lg, state = step(rt.params, None, tokens[:, t:t + 1], state,
                            torch.as_tensor([t], device=device))
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def _rel_gap(a, b) -> tuple:
    scale = max(1.0, b.abs().max().item())
    err = (a.float() - b.float()).abs().max().item()
    return err, err / scale


def ssm_check_phase(ssm_cfg, hybrid_cfg, seed: int, device) -> dict:
    """f32, TF32 off. mamba2-130m at its full config, T = 512: the card's
    forward (SSD kernel) against the same forward on the CPU (plain
    versions, the same params) and against token-by-token decode on the
    card (the state-space duality); zamba2-2.7b at full width and 12
    layers, T = 320: the duality; both: the first token ``ServeEngine``
    serves equals the forward's argmax at the prompt's last position. Gaps
    relative to max|logit|, each within SSM_LOGIT_REL."""
    out = {}
    rng = np.random.default_rng(seed + 400)
    for name, cfg, t_len in (("mamba2-130m", ssm_cfg, SSM_CHECK_T),
                             ("zamba2-2.7b", hybrid_cfg, HYBRID_CHECK_T)):
        rt = ModelRuntime(cfg, seed=seed, device=device)
        toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, t_len)),
                               device=device)
        _reset_launches()
        with torch.inference_mode():
            full, _ = api.forward(cfg, rt.params, {"tokens": toks})
        forward_ssd = _launches()["ssd"]
        if forward_ssd != cfg.num_layers:
            raise AssertionError(f"{name} forward launched ssd "
                                 f"{forward_ssd} times, not {cfg.num_layers}")
        res = dict(layers=cfg.num_layers, T=t_len, forward_ssd=forward_ssd,
                   max_logit=full.abs().max().item())
        if name == "mamba2-130m":
            cpu = torch.device("cpu")
            cpu_params = _to(rt.params, cpu)
            with torch.inference_mode():
                ref_logits, _ = api.forward(cfg, cpu_params,
                                            {"tokens": toks.cpu()})
            err, rel = _rel_gap(full.cpu(), ref_logits)
            if not rel <= SSM_LOGIT_REL:
                raise AssertionError(f"{name}: card forward vs CPU forward "
                                     f"{rel:.3e} of max|logit|")
            res.update(cpu_max_abs=err, cpu_rel=rel)
            del cpu_params, ref_logits
        t0 = time.perf_counter()
        dec = _decode_logits(cfg, rt, toks, device)
        torch.cuda.synchronize()
        err, rel = _rel_gap(dec, full)
        if not rel <= SSM_LOGIT_REL:
            raise AssertionError(f"{name}: decode vs forward {rel:.3e} of "
                                 f"max|logit| (duality)")
        res.update(duality_max_abs=err, duality_rel=rel,
                   decode_s=time.perf_counter() - t0)
        plen = 100
        eng = ServeEngine(rt, max_batch=2, max_len=SERVE_MAX_LEN, eos_id=-1)
        rid = eng.add_request(toks[0, :plen].tolist(), max_new_tokens=2)
        first = eng.run()[rid][0]
        with torch.inference_mode():
            head, _ = api.forward(cfg, rt.params, {"tokens": toks[:, :plen]})
        want = int(torch.argmax(head[0, -1]))
        if first != want:
            raise AssertionError(f"{name}: served first token {first} != "
                                 f"forward argmax {want}")
        res.update(first_token=first)
        out[name] = res
        del rt, full, dec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3g: the GS-class library on the card (its block products are bdmm
# launches) and Algorithm 1
# ---------------------------------------------------------------------------

GS_LIB_D = 8192                     # qwen2-72b's width
GS_LIB_B = 32
GS_LIB_T = 128                      # gs_apply / gs_apply_T tokens (a prefill bucket)
GS_LIB_N = 8192                     # gs_matmul: the columns of W (the wq slab)
GS_LIB_ORDER = 3                    # gs_factors_apply: factors of gs_order_layout
PROJ_REL = 1e-3                     # a GS member's recovery: error / ||A||_F
PROJ_D = 1024                       # the dense orthogonal A held against the CPU
PROJ_MATCH = 1e-4                   # card f32 error against CPU f64 error, relative


def gs_lib_layouts() -> dict:
    """GSOFT's square layout at d = 8192, b = 32, and one with rectangular
    blocks on both factors: L of r/2 blocks of 2b x b, R of r blocks of
    b/2 x b (d -> d/2 -> d)."""
    d, b = GS_LIB_D, GS_LIB_B
    r = d // b
    return {"gsoft": gs_lib.gsoft_layout(d, b),
            "rect": gs_lib.GSLayout(gs_lib.BlockDiagSpec(r // 2, 2 * b, b),
                                    gs_lib.BlockDiagSpec(r, b // 2, b),
                                    PermSpec.identity(), PermSpec.gs(r // 2),
                                    PermSpec.identity())}


def _plain_block_diag(blocks, x):
    """``block_diag_matmul`` through bdmm's plain version."""
    xt = x.reshape(-1, x.shape[-1]).contiguous()
    y = bk.bdmm_plain(xt[None], blocks.to(x.dtype).contiguous()[None])[0]
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


@contextlib.contextmanager
def _gs_plain():
    """The GS-class functions with their block products on the plain
    version (the yardstick and oracle of phase 3g)."""
    real = gs_lib.block_diag_matmul
    gs_lib.block_diag_matmul = _plain_block_diag
    try:
        yield
    finally:
        gs_lib.block_diag_matmul = real


def _gs_blocks(gen, spec, dtype, device):
    """Random blocks scaled by 1/sqrt(cols), so activations stay O(1)."""
    w = torch.randn(spec.param_shape, generator=gen, device=device)
    return (w / math.sqrt(spec.cols)).to(dtype).contiguous()


def check_gs_lib_case(fn_name, layout_name, dtype, gen, device) -> dict:
    """One GS-class function at d = 8192 against its plain version (the
    same function with bdmm's plain version), with times, the dense matmul
    of the materialized A as the library call, and the bound. It must
    launch bdmm once per factor and never the plain version."""
    if fn_name == "gs_factors_apply":
        lay = gs_lib.gs_order_layout(GS_LIB_D, GS_LIB_B, GS_LIB_ORDER)
        specs, d_in, d_out = lay.specs, lay.in_dim, lay.out_dim
    else:
        lay = gs_lib_layouts()[layout_name]
        specs, d_in, d_out = (lay.rspec, lay.lspec), lay.in_dim, lay.out_dim
    tokens = GS_LIB_N if fn_name == "gs_matmul" else GS_LIB_T

    def make():
        fs = [_gs_blocks(gen, s, dtype, device) for s in specs]
        if fn_name == "gs_matmul":
            x = torch.randn((d_in, tokens), generator=gen, device=device)
        elif fn_name == "gs_apply_T":
            x = torch.randn((1, tokens, d_out), generator=gen, device=device)
        else:
            x = torch.randn((1, tokens, d_in), generator=gen, device=device)
        return (*fs, x.to(dtype))

    def call(*a):
        if fn_name == "gs_factors_apply":
            return gs_lib.gs_factors_apply(lay, list(a[:-1]), a[-1])
        R, L, x = a
        return getattr(gs_lib, fn_name)(lay, L, R, x)

    def dense(*a):                       # A (d_out, d_in) in a's dtype
        if fn_name == "gs_factors_apply":
            return gs_lib.gs_factors_materialize(lay, list(a[:-1]))
        return gs_lib.gs_materialize(lay, a[1], a[0])

    def library(A, x):
        if fn_name == "gs_matmul":
            return A @ x
        if fn_name == "gs_apply_T":
            return x @ A
        return x @ A.T

    first = make()
    plain_calls = []
    real_plain = bk.bdmm_plain
    bk.bdmm_plain = lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k)
    try:
        before = bk.bdmm.launches
        y = call(*first)
        torch.cuda.synchronize()
        launched = bk.bdmm.launches - before
    finally:
        bk.bdmm_plain = real_plain
    if launched != len(specs) or plain_calls:
        raise AssertionError(f"{fn_name} ({layout_name}): {launched} bdmm "
                             f"launches for {len(specs)} factors, "
                             f"{len(plain_calls)} plain-version calls")
    with _gs_plain():
        want = call(*first)
    scale = max(1.0, want.float().abs().max().item())
    err = (y.float() - want.float()).abs().max().item()
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    if not _err_ok(err, tol):
        raise AssertionError(f"{fn_name} ({layout_name}, {dtype}): max|err| "
                             f"{err} > {tol}")
    es = torch.finfo(dtype).bits // 8
    nnz = sum(s.num_params for s in specs)
    nbytes = (tokens * (d_in + d_out) + nnz) * es
    sets = _weight_sets(first, make, nbytes)
    ms = time_ms(call, sets)
    with _gs_plain():
        plain_ms = time_ms(call, sets)
    A = dense(*first).to(dtype)
    lib_ms = time_ms(library, [(A, first[-1])])
    lib_err = (library(A, first[-1]).float() - want.float()).abs().max().item()
    del A
    bound_ms, bound_by = _bytes_bound(nbytes, 2 * tokens * nnz, dtype)
    return dict(kernel="bdmm", fn=fn_name, layout=layout_name,
                d_in=d_in, d_out=d_out, tokens=tokens,
                blocks=[list(s.param_shape) for s in specs],
                dtype=str(dtype).replace("torch.", ""), bdmm_launches=launched,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_err=lib_err,
                library_what="one dense matmul with the materialized A",
                bound_ms=bound_ms, bound_by=bound_by)


def gs_lib_cases():
    return ([(fn, lay) for fn in ("gs_apply", "gs_apply_T", "gs_matmul")
             for lay in ("gsoft", "rect")]
            + [("gs_factors_apply", f"order{GS_LIB_ORDER}")])


def projection_phase(seed: int, gen, device) -> dict:
    """Algorithm 1 on the card (f32): ``project_to_gs`` recovers a
    materialized GSOFT matrix at d = 8192, b = 32 (error within PROJ_REL of
    ||A||_F), timed; on a random dense orthogonal A at d = 1024 its error
    equals the CPU float64 projection's within PROJ_MATCH."""
    lay = gs_lib.gsoft_layout(GS_LIB_D, GS_LIB_B)
    r = GS_LIB_D // GS_LIB_B
    L0, R0 = _orth_factors(gen, 1, r, GS_LIB_B, torch.float32, device)
    A = gs_lib.gs_materialize(lay, L0[0], R0[0])
    L, R = gs_proj.project_to_gs(A, lay)
    torch.cuda.synchronize()
    if L.device != A.device or L.dtype != gs_proj.compute_dtype(A.device):
        raise AssertionError(f"project_to_gs ran on {L.device} in {L.dtype}")
    norm = torch.linalg.norm(A).item()
    err = gs_proj.gs_reconstruction_error(A, lay, L, R)
    if not (math.isfinite(err) and err <= PROJ_REL * norm):
        raise AssertionError(f"project_to_gs at d = {GS_LIB_D}: error {err} "
                             f"> {PROJ_REL} * ||A||_F = {PROJ_REL * norm}")
    ms = time_ms(lambda a: gs_proj.project_to_gs(a, lay), [(A,)])
    del A, L, R
    lay_s = gs_lib.gsoft_layout(PROJ_D, GS_LIB_B)
    g = np.random.default_rng(seed).normal(size=(PROJ_D, PROJ_D))
    q, rr = np.linalg.qr(g)
    q = q * np.sign(np.diag(rr))[None, :]
    Lc, Rc = gs_proj.project_to_gs(q, lay_s)                  # CPU, float64
    err_cpu = gs_proj.gs_reconstruction_error(q, lay_s, Lc, Rc)
    qd = torch.as_tensor(q, dtype=torch.float32, device=device)
    Lg, Rg = gs_proj.project_to_gs(qd, lay_s)
    err_card = gs_proj.gs_reconstruction_error(qd, lay_s, Lg, Rg)
    rel = abs(err_card - err_cpu) / err_cpu
    if not rel <= PROJ_MATCH:
        raise AssertionError(f"project_to_gs of a dense orthogonal A at d = "
                             f"{PROJ_D}: card f32 error {err_card} against "
                             f"CPU f64 {err_cpu} ({rel:.2e} > {PROJ_MATCH})")
    return dict(d=GS_LIB_D, b=GS_LIB_B, recovery_err=err, a_norm=norm,
                recovery_rel=err / norm, tol_rel=PROJ_REL, ms=ms,
                dense_d=PROJ_D, dense_err_card=err_card,
                dense_err_cpu_f64=err_cpu, dense_rel_gap=rel,
                dense_tol=PROJ_MATCH)


# ---------------------------------------------------------------------------
# phase 12: checkpoints and a resumed training run
# ---------------------------------------------------------------------------

RESUME_STEPS = 4                    # the uninterrupted run; the first stops at 2
RESUME_LOSS_REL = 1e-3


def _bit_equal(a: dict, b: dict, what: str) -> None:
    fa, fb = peft_lib.flatten_paths(a), peft_lib.flatten_paths(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"{what}: leaves {sorted(fa)} != {sorted(fb)}")
    for k in fa:
        if fa[k].dtype != fb[k].dtype or not torch.equal(fa[k], fb[k]):
            raise AssertionError(f"{what}: leaf {k} differs")


def _launcher_ckpt_run(cfg, seed: int, steps_n: int, ckpt_dir: str) -> dict:
    """``launch/train.py --ckpt-dir`` (GSOFT, b = 32) up to ``steps_n``,
    resuming from the directory's latest checkpoint when there is one."""
    argv = ["--arch", "qwen2-72b", "--peft", "gsoft", "--block-size",
            str(BDMM_BLOCK), "--steps", str(steps_n), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--warmup", "1", "--seed", str(seed), "--ckpt-dir", ckpt_dir,
            "--set", f"num_layers={cfg.num_layers}", f"remat={cfg.remat}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  launcher: {line}")
    final = [float(line.split()[2]) for line in out.splitlines()
             if line.startswith("final loss")]
    if rc != 0 or len(final) != 1 or not math.isfinite(final[0]):
        raise AssertionError(f"launcher --ckpt-dir returned {rc}: {out}")
    return dict(final_loss=final[0], resumed="resumed from step" in out,
                latest=CheckpointManager(ckpt_dir).latest_step())


def ckpt_resume_phase(cfg, seed: int, device) -> dict:
    """GSOFT (b = 32) through ``train()`` with ``ckpt_dir``: 2 steps with
    async saves, the saved {"trainable", "opt"} restored bit for bit, then
    ``train()`` again resuming to step 4, against an uninterrupted 4-step
    run (losses of steps 2-3 within RESUME_LOSS_REL; the largest adapter
    difference recorded); then the launcher twice (2 steps, then 3,
    resumed)."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=BDMM_BLOCK)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=TRAIN_LR))
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed,
                      vocab_size=min(cfg.vocab_size, 256))
    quiet = lambda msg: log(f"  train(): {msg}")  # noqa: E731

    def run(steps_n, ckpt_dir=None, logs=None):
        out = train_loop.train(
            cfg, tcfg, dcfg,
            train_loop.LoopConfig(steps=steps_n, log_every=1,
                                  ckpt_dir=ckpt_dir, async_ckpt=True),
            log_fn=logs.append if logs is not None else quiet, device=device)
        keep = {k: out[k] for k in ("trainable", "opt_state", "history")}
        del out
        torch.cuda.empty_cache()
        return keep

    t0 = time.perf_counter()
    full = run(RESUME_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        first = run(2, d)
        mgr = CheckpointManager(d)
        if mgr.latest_step() != 2 or mgr.extra() != {"data_step": 2}:
            raise AssertionError(f"checkpoint after 2 steps: latest "
                                 f"{mgr.latest_step()}, extra {mgr.extra()}")
        saved = mgr.restore(device=device)
        _bit_equal(saved["trainable"], first["trainable"], "restored trainable")
        _bit_equal(saved["opt"], first["opt_state"], "restored opt")
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
        logs = []
        _reset_launches()
        second = run(RESUME_STEPS, d, logs)
        resume_launches = _launches()
        for line in logs:
            log(f"  train(): {line}")
        if "resumed from step 2" not in logs:
            raise AssertionError(f"the second train() did not resume: {logs}")
    want = {h["step"]: h["loss"] for h in full["history"]}
    got = {h["step"]: h["loss"] for h in second["history"]}
    if sorted(got) != [2, 3]:
        raise AssertionError(f"the resumed run logged steps {sorted(got)}")
    loss_rel = {s: abs(got[s] - want[s]) / abs(want[s]) for s in got}
    if not all(math.isfinite(v) and v <= RESUME_LOSS_REL
               for v in loss_rel.values()):
        raise AssertionError(f"resumed losses {got} against uninterrupted "
                             f"{want}")
    fa = peft_lib.flatten_paths(second["trainable"])
    fb = peft_lib.flatten_paths(full["trainable"])
    adapter_diff = max((fa[k].float() - fb[k].float()).abs().max().item()
                       for k in fa)
    train_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as d:
        l1 = _launcher_ckpt_run(cfg, seed, 2, d)
        l2 = _launcher_ckpt_run(cfg, seed, 3, d)
    if l1["latest"] != 2 or not l2["resumed"] or l2["latest"] != 3:
        raise AssertionError(f"launcher --ckpt-dir runs {l1} {l2}")
    return dict(layers=cfg.num_layers, steps=RESUME_STEPS,
                losses_uninterrupted=[want[s] for s in sorted(want)],
                losses_resumed=[got[s] for s in sorted(got)],
                loss_rel_gap=loss_rel, loss_tol=RESUME_LOSS_REL,
                adapter_max_abs_diff=adapter_diff,
                checkpoint_bytes=ckpt_bytes, launches_resumed=resume_launches,
                train_s=train_s, launcher=[l1, l2])


def adapters_quant_ckpt_phase(cfg, seed: int, device) -> dict:
    """f32, TF32 off: 3 GSOFT tenants saved with ``save_adapters``;
    ``attach(<dir>)`` serves the tokens of ``attach({name: adapters},
    cfg)``. Then ``save_quantized`` of the int8 runtime and
    ``ModelRuntime.load_quantized``: codes and scales bit-equal, and the
    paged int8 engine serves the saved runtime's tokens (``q_matmul`` and
    ``gs_q_matmul`` run)."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    adapters = {n: perturbed_adapters(pcfg, base.params, seed + 20 + i,
                                      MIXED_SCALE, device)
                for i, n in enumerate(names)}
    prompt = np.random.default_rng(seed + 8).integers(1, cfg.vocab_size,
                                                      24).tolist()

    def serve(rt, engine):
        eng = engine(rt)
        rids = {n: eng.add_request(prompt, max_new_tokens=8, adapter=n)
                for n in names + [None]}
        res = eng.run()
        return {str(n): res[r] for n, r in rids.items()}

    contiguous = lambda rt: ServeEngine(rt, max_batch=4, max_len=64,  # noqa: E731
                                        eos_id=-1)
    paged = lambda rt: _paged_engine(rt, 4, 64)  # noqa: E731
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adapters_") as d:
        CheckpointManager(d).save_adapters(0, adapters, pcfg)
        from_dir = serve(base.attach(d), contiguous)
    eager = serve(base.attach(adapters, pcfg), contiguous)
    if from_dir != eager:
        raise AssertionError(f"attach(<dir>) served {from_dir}, attach("
                             f"adapters) {eager}")
    adapters_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qrt = base.quantized("int8")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as d:
        CheckpointManager(d).save_quantized(0, qrt.params, qrt.quant_cfg)
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                         if f.is_file())
        save_s = time.perf_counter() - t0
        lrt = ModelRuntime.load_quantized(d, cfg, device=device)
    load_s = time.perf_counter() - t0 - save_s
    if lrt.quant_cfg != qrt.quant_cfg:
        raise AssertionError(f"restored {lrt.quant_cfg} != {qrt.quant_cfg}")
    n_quant = 0
    for path, leaf in peft_lib.flatten_paths(qrt.params).items():
        other = peft_lib.flatten_paths(lrt.params)[path]
        pairs = ([(leaf.q, other.q), (leaf.scale, other.scale)]
                 if is_quant_tensor(leaf) else [(leaf, other)])
        n_quant += is_quant_tensor(leaf)
        if not is_quant_tensor(other) == is_quant_tensor(leaf) or not all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"load_quantized: leaf {path} differs")
    _reset_launches()
    want = serve(qrt.attach(adapters, pcfg), paged)
    got = serve(lrt.attach(adapters, pcfg), paged)
    launches = _launches()
    if got != want:
        raise AssertionError(f"load_quantized runtime served {got}, the "
                             f"saved runtime {want}")
    if launches["q_matmul"] == 0 or launches["gs_q_matmul"] == 0:
        raise AssertionError(f"the int8 runs launched {launches}")
    return dict(layers=cfg.num_layers, tenants=names, tokens=from_dir,
                adapters_s=adapters_s, int8_tokens=got,
                quant_leaves=n_quant, int8_checkpoint_bytes=ckpt_bytes,
                int8_save_s=save_s, int8_load_s=load_s, launches=launches,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


# ---------------------------------------------------------------------------
# phase 12c: the store-paged serve lane
# ---------------------------------------------------------------------------

STORE_LAYERS = 2                    # the store lane's depth (was 8)
STORE_TENANTS = 24
STORE_BUDGET = 6                    # adapters resident on the card at once
STORE_HOT = 4                       # tenants revisited after the cold sweep
STORE_REVISITS = 12
STORE_METHODS = ("gsoft", "boft", "householder")   # as benchmarks/store_bench.py
STORE_NEW = 8
STORE_CHECK_TENANTS = 6             # the f32 check: two per method, budget 3
# the profiled run serves the first requests of the cold sweep only: the
# trace of the whole traffic (some 10^5 device events) takes over a minute
# to process
STORE_PROFILED = 12


def store_cfgs(n: int) -> dict:
    return {f"tenant{i:02d}": peft_lib.PEFTConfig(
                method=STORE_METHODS[i % len(STORE_METHODS)],
                block_size=BDMM_BLOCK) for i in range(n)}


def _save_store(cfgs, params, seed: int, scale: float, device, d) -> dict:
    """Perturbed adapters for ``cfgs`` saved as one adapter-bank checkpoint
    in ``d``; returns {name: adapters} (on the card)."""
    adapters = {n: perturbed_adapters(c, params, seed + 1 + i, scale, device)
                for i, (n, c) in enumerate(cfgs.items())}
    CheckpointManager(d).save_adapters(0, adapters, cfgs)
    return adapters


def store_serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """24 tenants (gsoft / boft / householder round-robin, b = 32) saved
    with ``save_adapters`` and opened lazily by ``attach(<dir>,
    hbm_budget=6)``; a cold sweep (one request per tenant, seeded order),
    then 12 revisits of 4 tenants, prompts of 16-128 tokens, 8 new tokens,
    4 slots of ``ServeEngine``. Every run attaches the directory anew, so
    each repeats the same page-ins. The first run is the counted main-path
    run; ``repeats`` runs give the median rate; one more runs under the
    profiler (the first STORE_PROFILED requests); then the launcher serves
    the directory."""
    cfgs = store_cfgs(STORE_TENANTS)
    names = list(cfgs)
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    d = tmp.name
    adapters = _save_store(cfgs, base.params, seed + 300, 0.05, device, d)
    fp32_bytes = {m: max(sum(v.numel() * 4 for e in adapters[n].values()
                             for v in e.values())
                         for n in names if cfgs[n].method == m)
                  for m in STORE_METHODS}
    del adapters
    torch.cuda.empty_cache()
    disk_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                     if f.is_file())
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 400)
    sweep = [names[i] for i in rng.permutation(len(names))]
    hot = [names[i] for i in rng.permutation(len(names))[:STORE_HOT]]
    order = sweep + [hot[i % STORE_HOT] for i in range(STORE_REVISITS)]
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=len(order))
    work = [(rng.integers(1, cfg.vocab_size, size=int(n)).tolist(), a)
            for a, n in zip(order, lens)]
    state = {}

    def drive(n=len(work)):
        rt = base.attach(d, hbm_budget=STORE_BUDGET)
        eng = ServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN, eos_id=-1)
        for prompt, adapter in work[:n]:
            eng.add_request(prompt, max_new_tokens=STORE_NEW, adapter=adapter)
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        state["rt"] = rt
        return eng, results, time.perf_counter() - t0

    # every GSOFT rotation reads the bank by slot id: record the ids and the
    # bank's slot count of each call (checked after the run, no sync in it)
    seen = []
    real_bank = ops.gs_fused_T_bank

    def recording(x, L, R, ids):
        seen.append((ids, L.shape[0]))
        return real_bank(x, L, R, ids)

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    ops.gs_fused_T_bank = recording
    try:
        eng, results, wall = drive()
    finally:
        ops.gs_fused_T_bank = real_bank
    launches = _launches()
    slot = _slot_launches()
    rt = state["rt"]
    bank = rt.bank
    stats = bank.stats()
    snap = REGISTRY.snapshot(
        prefix=bank._page_in_ms.name.rsplit("/", 1)[0] + "/")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(results) != len(work) or any(len(v) != STORE_NEW
                                        for v in results.values()):
        raise AssertionError(f"served {len(results)} of {len(work)} requests")
    check_slot_path("store serve", launches, slot, ("gs_fused_T",))
    caps = bank.caps
    if len(seen) != launches["gs_fused_T"] or any(
            a != caps["gsoft"] + 1 for _, a in seen):
        raise AssertionError(f"gs_fused_T_bank saw banks of "
                             f"{sorted({a for _, a in seen})} slots, "
                             f"{len(seen)} calls of {launches['gs_fused_T']}")
    max_id = int(torch.stack([i.max() for i, _ in seen]).max().item())
    if max_id > caps["gsoft"]:
        raise AssertionError(f"a gs_fused_T_bank id {max_id} is no compact "
                             f"id of a {caps['gsoft'] + 1}-slot stack")
    if launches["bdmm"] == 0:
        raise AssertionError(f"the BOFT tenants never launched bdmm: "
                             f"{launches}")
    if stats["evictions"] == 0 or stats["misses"] == 0:
        raise AssertionError(f"no paging under the budget: {stats}")
    # each tenant's first token comes from finite prefill logits
    prefill = steps.build_prefill_step(cfg)
    first_ok = {}
    for name in names:
        prompt, _ = next(w for w in work if w[1] == name)
        uslot = bank.acquire(name)
        if uslot is None:
            raise AssertionError(f"{name} stalled on an idle bank")
        req = peft_lib.PrefillRequest(
            batch={"tokens": torch.as_tensor([prompt], device=device)},
            last_idx=torch.as_tensor(len(prompt) - 1), ctx=rt.context([uslot]))
        logits, _ = prefill(rt.params, req, rt.decode_state(1, len(prompt) + 1))
        bank.release(name)
        first_ok[name] = bool(torch.isfinite(logits.float()).all())
    if not all(first_ok.values()):
        raise AssertionError(f"non-finite first-token logits: {first_ok}")
    walls = [wall]
    for _ in range(repeats - 1):
        _, again, w = drive()
        if again != results:
            raise AssertionError("a repeated store run served other tokens")
        walls.append(w)
    toks = eng.stats["tokens_generated"]
    wall_med = float(np.median(walls))
    _SPENT["timed"] += sum(walls)
    state.clear()
    del rt, bank
    prof = _profile(lambda: drive(STORE_PROFILED))
    prof["requests"] = STORE_PROFILED
    state.clear()
    torch.cuda.empty_cache()
    out = dict(layers=cfg.num_layers, tenants=len(names),
               methods=dict(sorted(Counter_(c.method for c in cfgs.values())
                                   .items())),
               budget=STORE_BUDGET, caps=caps, requests=len(results),
               cold=len(sweep), revisits=STORE_REVISITS, hot=hot,
               tokens=toks, wall_s=walls, wall_median_s=wall_med,
               tok_s=toks / wall_med, decode_steps=eng.stats["decode_steps"],
               admission_stalls=eng.stats["admission_stalls"],
               launches=launches, slot_launches=slot,
               gs_fused_T_bank_max_id=max_id, bank_stats=stats,
               bank_snapshot=snap, fp32_tenant_bytes=fp32_bytes,
               store_disk_bytes=disk_bytes, peak_mem_gb=peak_gb,
               setup_s=setup_s, profile=prof)
    del base
    torch.cuda.empty_cache()
    out["launcher"] = store_launcher_run(d)
    tmp.cleanup()
    return out


def store_launcher_run(d: str) -> dict:
    """``launch/serve.py --store-dir <dir> --hbm-adapter-budget 6`` at
    full width and 8 layers: 8 requests round-robin over the store's
    first tenants; its output is echoed into this log."""
    argv = ["--arch", "qwen2-72b", "--set", f"num_layers={STORE_LAYERS}",
            "--store-dir", d, "--hbm-adapter-budget", str(STORE_BUDGET),
            "--requests", "8", "--prompt-len", "64", "--max-new",
            str(STORE_NEW)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  launcher: {line[:300]}")
    if rc != 0 or "served 8 requests" not in out or "adapter store:" not in out:
        raise AssertionError(f"serve launcher --store-dir returned {rc}: {out}")
    torch.cuda.empty_cache()
    return dict(argv=argv, report=[line for line in out.splitlines()
                                   if "served" in line or "store" in line])


def store_check_phase(cfg, seed: int, device) -> dict:
    """f32, TF32 off: 6 tenants (two per method) under budget 3 (one compact
    slot per method). On 2 slots of ``ServeEngine``, tenants of one method
    queue back to back, so every admission past the first of a method
    evicts; tenant00 comes back after its eviction. Every request's tokens
    equal the tenant's solo merged run; then the store-paged bank serves the
    eager padded bank's tokens, unquantized and over int8."""
    cfgs = store_cfgs(STORE_CHECK_TENANTS)
    names = list(cfgs)
    base = ModelRuntime(cfg, seed=seed, device=device)
    prompt = np.random.default_rng(seed + 9).integers(1, cfg.vocab_size,
                                                      24).tolist()
    order = [names[i] for i in (0, 3, 1, 4, 2, 5, 0)]

    def serve(rt, names_):
        eng = ServeEngine(rt, max_batch=2, max_len=64, eos_id=-1)
        rids = [(n, eng.add_request(prompt, max_new_tokens=8, adapter=n))
                for n in names_]
        res = eng.run()
        return [(str(n), res[r]) for n, r in rids], eng

    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_check_") as d:
        adapters = _save_store(cfgs, base.params, seed + 500, MIXED_SCALE,
                               device, d)
        paged = base.attach(d, hbm_budget=3)
        got, eng = serve(paged, order)
        stats = paged.bank.stats()
    if stats["evictions"] == 0 or stats["build_cache_hits"] == 0:
        raise AssertionError(f"tenant00 was not evicted and paged in again: "
                             f"{stats}")
    solo = {}
    for name in names:
        merged = ModelRuntime(cfg, base.params, device=device,
                              adapters=adapters[name], peft_cfg=cfgs[name])
        solo[name] = _one(merged, prompt, None)
        del merged
        torch.cuda.empty_cache()
    bad = [(n, t, solo[n]) for n, t in got if t != solo[n]]
    if bad:
        raise AssertionError(f"store tokens differ from solo merged: {bad}")
    everyone = names + [None]
    padded = {}
    for label, rt in (("f32", base), ("int8", base.quantized("int8"))):
        eager, _ = serve(rt.attach(adapters, cfgs), everyone)
        store, _ = serve(rt.attach(
            store_lib.AdapterStore.from_adapters(adapters, cfgs),
            hbm_budget=3), everyone)
        if store != eager:
            raise AssertionError(f"{label}: store-paged {store} != padded "
                                 f"{eager}")
        padded[label] = eager
    return dict(layers=cfg.num_layers, tenants=names, order=order,
                tokens=got, solo=solo, bank_stats=stats,
                admission_stalls=eng.stats["admission_stalls"],
                distinct_tokens=len({tuple(t) for _, t in got}),
                padded_tokens=padded,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)



# ---------------------------------------------------------------------------
# phase 3h: the image lane's kernel shapes
# ---------------------------------------------------------------------------

IMAGE_ROWS = 8                      # the image engine's batch (max_batch)
IMAGE_BLOCK = 8                     # the launcher's demo bank: block size 8


def image_pairs(cfg) -> list:
    """(channels d, tokens a row = pixels) of every ``wc`` channel mix of
    the image family at ``cfg``: the conv layers' (width, HxW) and the
    down layers' (2 width, HxW / 4) of each block."""
    lc = image_model.lip_cfg(cfg)
    pairs = set()
    for bi, width in enumerate(lc.block_widths()):
        side = lc.image_size // 2 ** bi
        if lc.depth // 5 > 1:
            pairs.add((width, side * side))
        pairs.add((2 * width, (side // 2) ** 2))
    return sorted(pairs)


def image_kernel_phase(cfg, gen, device) -> list:
    """Phase 3h: the kernels the image lane runs, at its shapes, against
    their plain versions: the banked rotation (``gs_fused_T_bank``), the
    fused int8 product (``gs_q_matmul_bank``, N = d), ``q_matmul`` (M = 8
    rows x pixels, K = N = d) and ``bdmm`` (blocks as stored and read
    transposed) at 8 rows, b = 8, bf16, every (d, pixels) pair; then
    ``gs_fused`` in f32 at b = 8 on a d x d slab (the merge of a tenant into
    a ``wc``) for every width."""
    run = []
    bf = torch.bfloat16
    for d, t in image_pairs(cfg):
        c = check_case("gs_fused_T", IMAGE_ROWS, t, d, IMAGE_BLOCK, bf, gen,
                       device)
        run.append(c)
        log(f"image kernel gs_fused_T  B={IMAGE_ROWS} T={t:4d} d={d:4d} b=8 "
            f"route {c['route']} tt={c['tt']} cluster={c['cluster']} err "
            f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms {c['ms']:.4f} "
            f"plain {c['plain_ms']:.4f} lib {c['library_ms']:.4f} bound "
            f"{c['bound_ms']:.5f} ({c['bound_by']})")
        c = check_gsq_case(IMAGE_ROWS, t, d, d, IMAGE_BLOCK, bf, gen, device)
        run.append(c)
        log(f"image kernel gs_q_matmul B={IMAGE_ROWS} T={t:4d} d=N={d:4d} b=8 "
            f"plan={c['plan']} rotation {c['rotation_route']} err "
            f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms {c['ms']:.4f} "
            f"plain {c['plain_ms']:.4f} lib {c['library_ms']:.4f} bound "
            f"{c['bound_ms']:.5f} ({c['bound_by']})")
        c = check_qmm_case(IMAGE_ROWS * t, d, d, bf, gen, device)
        run.append(c)
        log(f"image kernel q_matmul    M={IMAGE_ROWS * t:4d} K=N={d:4d} "
            f"tokens={c['tokens']} boxes={c['boxes']} stages={c['stages']} "
            f"ctas={c['ctas']} splits={c['k_splits']} err "
            f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms {c['ms']:.4f} "
            f"plain {c['plain_ms']:.4f} lib {c['library_ms']:.4f} bound "
            f"{c['bound_ms']:.5f} ({c['bound_by']})")
        for trans in (False, True):
            c = check_bdmm_case(IMAGE_ROWS, t, d, IMAGE_BLOCK, bf, gen,
                                device, trans)
            run.append(c)
            log(f"image kernel bdmm        B={IMAGE_ROWS} T={t:4d} d={d:4d} "
                f"b=8 {'T ' if trans else '  '}{c['route']} "
                f"{c['geometry']} err {c['max_abs_err']:.2e} (tol "
                f"{c['tol']:.0e}) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"lib {c['library_ms']:.4f} bound {c['bound_ms']:.5f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
    for d in sorted({d for d, _ in image_pairs(cfg)}):
        c = check_case("gs_fused", 1, d, d, IMAGE_BLOCK, torch.float32, gen,
                       device)
        run.append(c)
        log(f"image kernel gs_fused    merge T=d={d:4d} b=8 f32 route "
            f"{c['route']} err {c['max_abs_err']:.2e} (tol {c['tol']:.0e}) "
            f"ms {c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
            f"{c['library_ms']:.4f} bound {c['bound_ms']:.5f} "
            f"({c['bound_by']})")
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# phase 14: static, streaming and traced serving (qwen2-72b, 8 layers)
# ---------------------------------------------------------------------------

TRACED_REQUESTS = 8
TRACED_NEW = (4, 16)                # new tokens drawn in this range
STREAM_LOAD = 0.7                   # arrivals at 0.7x the up-front request rate
KV_STALL_PAGES = 24                 # phase 14c's pool: one request takes <= 18
PROFILE_RANGES = ("prefill", "decode")  # what the static engine opens


def _slo_summary(slo) -> dict:
    rep = slo.report()
    return dict(ttft_ms=rep["ttft_ms"], tpot_ms=rep["tpot_ms"],
                tok_s=rep["tok_s"], stall_rate=rep["stall_rate"],
                stalls=rep["stalls"], requests=rep["window_requests"])


def _check_traces(tracer, results, phase: str) -> None:
    """Every request has one complete trace: submit, a prefill span, one
    first token (the first token time), and as many tokens as it served."""
    if tracer.pending_count or len(tracer.finished) != len(results):
        raise AssertionError(f"{phase}: {len(tracer.finished)} traces "
                             f"finished, {tracer.pending_count} pending, for "
                             f"{len(results)} requests")
    for tr in tracer.finished:
        if not (tr.complete and tr.token_times[0] == tr.t_first
                and tr.n_tokens == len(results[tr.rid])):
            raise AssertionError(f"{phase}: trace of request {tr.rid} is not "
                                 f"complete: {tr.events()[:4]}")


def _traced_work(cfg, seed: int, names) -> list:
    """(prompt, new tokens, adapter): prompts of 16-128 tokens, 4-16 new
    tokens, round-robin over ``names``."""
    rng = np.random.default_rng(seed + 300)
    return [(rng.integers(1, cfg.vocab_size, size=int(
                rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))).tolist(),
             int(rng.integers(TRACED_NEW[0], TRACED_NEW[1] + 1)),
             names[i % len(names)]) for i in range(TRACED_REQUESTS)]


def _drive(make, work, tracer=None):
    """One engine from ``make(tracer)`` serving ``work`` queued up front:
    (engine, {rid: tokens}, wall seconds)."""
    eng = make(tracer)
    for prompt, n, adapter in work:
        kw = {} if adapter is None else {"adapter": adapter}
        eng.add_request(prompt, max_new_tokens=n, **kw)
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return eng, results, time.perf_counter() - t0


def static_traced_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """Phase 14 a-c at full width. (a) ``StaticServeEngine`` on a runtime
    with one GSOFT adapter merged (b = 32: the merge launches ``gs_fused``)
    serves 8 mixed-length requests, 4 a batch; median rate of 3 runs beside
    ``ServeEngine`` on the same merged runtime and requests; a profile of
    one static run with the dispatches named. (b) ``ServeEngine`` over a
    3-tenant GSOFT bank (the merged runtime freed first): up-front runs
    with tracing off and on in turns (3 each; the rate ratio is reported,
    not gated; tokens equal), then ``drive_streaming`` with Poisson
    arrivals at 0.7x the up-front request rate under a ``TraceRecorder``
    and ``SLOMonitor``: TTFT / TPOT percentiles, stalls, every trace
    complete, Chrome and JSONL exports that parse. (c) the paged int8 lane
    with the tracer under a KV pool of 24 pages: at least one ``kv`` stall,
    ``q_matmul``, ``gs_q_matmul`` and ``paged_decode`` launched."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    out = dict(layers=cfg.num_layers)

    # (a) one adapter merged offline: the static engine against the
    # continuous one on the same runtime
    adapter = perturbed_adapters(pcfg, base.params, seed + 11, 0.05, device)
    _reset_launches()
    t0 = time.perf_counter()
    merged = ModelRuntime(cfg, base.params, device=device, adapters=adapter,
                          peft_cfg=pcfg)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_launches = _launches()
    if merge_launches["gs_fused"] == 0:
        raise AssertionError("the static lane's merge never launched gs_fused")
    del adapter
    work = _traced_work(cfg, seed, [None])
    engines = {
        "static": lambda tr: StaticServeEngine(merged, max_batch=4,
                                               max_len=SERVE_MAX_LEN,
                                               eos_id=-1, tracer=tr),
        "continuous": lambda tr: ServeEngine(merged, max_batch=4,
                                             max_len=SERVE_MAX_LEN, eos_id=-1,
                                             tracer=tr)}
    rates, tokens, steps_ = {}, {}, {}
    for name, make in engines.items():
        _drive(make, [([1, 2, 3], 2, None)])                   # warm
        walls = []
        for _ in range(repeats):
            eng, res, wall = _drive(make, work)
            walls.append(wall)
            if name in tokens and res != tokens[name]:
                raise AssertionError(f"a repeated {name} run served other "
                                     "tokens")
            tokens[name] = res
        if len(tokens[name]) != TRACED_REQUESTS or any(
                len(tokens[name][i]) != work[i][1]
                for i in range(TRACED_REQUESTS)):
            raise AssertionError(f"{name}: served {tokens[name]}")
        _SPENT["timed"] += sum(walls)
        toks = eng.stats["tokens_generated"]
        rates[name] = dict(wall_s=walls, tok_s=toks / float(np.median(walls)),
                           tokens=toks, decode_steps=eng.stats["decode_steps"],
                           prefills=eng.stats["prefills"])
    tracer = TraceRecorder(profiler_annotations=True)
    out["static"] = dict(
        rates, merge_s=merge_s, merge_launches=merge_launches,
        weight_slices=_slices(pcfg, base.params),
        static_equals_continuous=tokens["static"] == tokens["continuous"],
        profile=_profile(lambda: _drive(engines["static"], work, tracer),
                         ranges=PROFILE_RANGES))
    del merged, engines
    torch.cuda.empty_cache()

    # (b) a 3-tenant bank: tracing off / on, then streaming arrivals
    names = ["tenant_a", "tenant_b", "tenant_c"]
    banked = base.attach({n: perturbed_adapters(pcfg, base.params,
                                                seed + 21 + i, 0.05, device)
                          for i, n in enumerate(names)}, pcfg)
    work = _traced_work(cfg, seed + 1, names + [None])

    def make(tr):
        return ServeEngine(banked, max_batch=4, max_len=SERVE_MAX_LEN,
                           eos_id=-1, tracer=tr)

    _drive(make, [([1, 2, 3], 2, n) for n in names])           # warm
    _reset_launches()
    _, upfront, wall = _drive(make, work)
    launches, slot = _launches(), _slot_launches()
    check_slot_path("traced serve", launches, slot, ("gs_fused_T",))
    walls = {"off": [wall], "on": []}
    for i in range(2 * repeats - 1):      # on, off, on, ...: in turns
        traced = i % 2 == 0
        tracer = TraceRecorder(slo=SLOMonitor()) if traced else None
        eng, res, w = _drive(make, work, tracer)
        if res != upfront:
            raise AssertionError("tracing changed the served tokens")
        walls["on" if traced else "off"].append(w)
        if traced:
            _check_traces(tracer, upfront, "traced serve")
    _SPENT["timed"] += sum(walls["off"]) + sum(walls["on"])
    toks = eng.stats["tokens_generated"]
    rate = {k: toks / float(np.median(v)) for k, v in walls.items()}
    req_per_s = TRACED_REQUESTS / float(np.median(walls["off"]))
    arrival_rate = STREAM_LOAD * req_per_s
    arrivals = np.cumsum(np.random.default_rng(seed + 400).exponential(
        1.0 / arrival_rate, size=TRACED_REQUESTS))
    slo = SLOMonitor()
    tracer = TraceRecorder(slo=slo)
    eng = make(tracer)
    t0 = time.perf_counter()
    streamed = launch_serve.drive_streaming(
        eng, [dict(prompt=p, max_new_tokens=n,
                   **({} if a is None else {"adapter": a}))
              for p, n, a in work], arrivals)
    torch.cuda.synchronize()
    stream_wall = time.perf_counter() - t0
    _SPENT["timed"] += stream_wall
    _check_traces(tracer, streamed, "streaming serve")
    with tempfile.TemporaryDirectory() as d:
        n_jsonl = tracer.export_jsonl(f"{d}/trace.jsonl")
        n_chrome = tracer.export_chrome(f"{d}/trace.json")
        with open(f"{d}/trace.jsonl") as f:
            rows = [json.loads(line) for line in f]
        with open(f"{d}/trace.json") as f:
            doc = json.load(f)
    if len(rows) != n_jsonl or len(doc["traceEvents"]) != n_chrome:
        raise AssertionError("a trace export does not parse back whole")
    out["traced"] = dict(
        launches=launches, slot_launches=slot, wall_s=walls,
        tok_s_off=rate["off"], tok_s_on=rate["on"],
        rate_ratio_on_off=rate["on"] / rate["off"],
        request_rate_upfront=req_per_s, arrival_rate=arrival_rate,
        arrivals_s=arrivals.tolist(), stream_wall_s=stream_wall,
        stream_tok_s=eng.stats["tokens_generated"] / stream_wall,
        stream_tokens_equal_upfront=streamed == upfront,
        slo=_slo_summary(slo), jsonl_events=n_jsonl,
        chrome_events=n_chrome)

    # (c) the paged int8 lane with the tracer, under a small KV pool
    qrt = banked.quantized("int8", release_source=True)
    del banked, base
    torch.cuda.empty_cache()
    budget = KV_STALL_PAGES * kv_page_bytes(cfg, PAGE_SIZE)
    slo = SLOMonitor()
    tracer = TraceRecorder(slo=slo)
    _reset_launches()
    eng, res, wall = _drive(
        lambda tr: PagedServeEngine(qrt, max_batch=4, max_len=SERVE_MAX_LEN,
                                    eos_id=-1, page_size=PAGE_SIZE,
                                    prefill_chunk=PREFILL_CHUNK,
                                    hbm_kv_budget=budget, tracer=tr),
        work, tracer)
    launches, slot = _launches(), _slot_launches()
    for name in ("q_matmul", "gs_q_matmul", "paged_decode"):
        if launches[name] == 0:
            raise AssertionError(f"the traced paged int8 lane never launched "
                                 f"{name}: {launches}")
    check_slot_path("traced paged int8", launches, slot, ("gs_q_matmul",))
    _check_traces(tracer, res, "traced paged int8")
    kv_stalls = slo.report()["stalls"].get("kv", 0)
    if kv_stalls < 1 or eng.kv_stats()["kv_stalls"] < 1:
        raise AssertionError(f"the {eng.num_pages}-page pool never stalled "
                             f"admission: {eng.kv_stats()}")
    out["paged_int8"] = dict(launches=launches, slot_launches=slot,
                             wall_s=wall, num_pages=eng.num_pages,
                             kv_stats=eng.kv_stats(), slo=_slo_summary(slo),
                             tok_s=eng.stats["tokens_generated"] / wall)
    del qrt, eng
    torch.cuda.empty_cache()
    return out


def launcher_lane_run(argv, must) -> dict:
    """``launch/serve.py`` with ``argv`` on the card: it must return 0 and
    print every string of ``must``; its output is echoed into this log."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  launcher: {line[:300]}")
    if rc != 0 or not all(m in out for m in must):
        raise AssertionError(f"serve launcher {argv} returned {rc}: {out}")
    torch.cuda.empty_cache()
    return dict(argv=argv, wall_s=time.perf_counter() - t0,
                report=[line for line in out.splitlines()
                        if line.startswith(("[", "slo", "trace"))])


def static_check_phase(cfg, seed: int, device) -> dict:
    """Phase 14e, f32 (TF32 off): on one GSOFT adapter (b = 32), the static
    engine's greedy tokens on the merged runtime equal ``ServeEngine``'s on
    the same runtime and ``ServeEngine``'s on a banked runtime serving that
    tenant (three ragged prompts)."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    adapter = perturbed_adapters(pcfg, base.params, seed + 13, 0.05, device)
    merged = ModelRuntime(cfg, base.params, device=device, adapters=adapter,
                          peft_cfg=pcfg)
    banked = base.attach({"a": adapter}, pcfg)
    rng = np.random.default_rng(seed + 8)
    work = [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for n, m in ((24, 8), (9, 6), (17, 8))]
    tokens = {}
    for name, eng, adapter_name in (
            ("static", StaticServeEngine(merged, max_batch=3, max_len=64,
                                         eos_id=-1), None),
            ("continuous", ServeEngine(merged, max_batch=2, max_len=64,
                                       eos_id=-1), None),
            ("banked", ServeEngine(banked, max_batch=2, max_len=64,
                                   eos_id=-1), "a")):
        rids = [eng.add_request(p, max_new_tokens=m,
                                **({} if adapter_name is None
                                   else {"adapter": adapter_name}))
                for p, m in work]
        res = eng.run()
        tokens[name] = [res[r] for r in rids]
    if not tokens["static"] == tokens["continuous"] == tokens["banked"]:
        raise AssertionError(f"static {tokens['static']}, continuous "
                             f"{tokens['continuous']}, banked "
                             f"{tokens['banked']} differ")
    return dict(layers=cfg.num_layers, tokens=tokens["static"],
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


# ---------------------------------------------------------------------------
# phase 15: image serving (lipconvnet-15)
# ---------------------------------------------------------------------------

IMAGE_TENANTS = 6
IMAGE_METHODS = ("gsoft", "boft", "householder")   # as --demo-methods
IMAGE_REQUESTS = 64
IMAGE_PROFILED = 12                 # the profile: the first dozen requests
IMAGE_LOGIT_REL = 1e-3              # f32 banked vs solo merged, of max|logit|
LIPSCHITZ_TOL = 1e-3                # six Taylor terms: near-isometric convs
ISOMETRY_TOL = 1e-4                 # f32: an orthogonal channel mix keeps
                                    # every row's norm to rounding


def image_cfgs() -> dict:
    return {f"t{i}": peft_lib.PEFTConfig(
        method=IMAGE_METHODS[i % len(IMAGE_METHODS)], block_size=IMAGE_BLOCK)
        for i in range(IMAGE_TENANTS)}


def _image_bank(cfg, seed: int, device):
    """(base runtime, banked runtime, adapters, their PEFTConfigs): the
    launcher's demo bank of ``IMAGE_TENANTS`` tenants."""
    base = ModelRuntime(cfg, seed=seed, device=device)
    cfgs = image_cfgs()
    ads = launch_serve.make_demo_adapters(list(cfgs), base.params, cfgs,
                                          device, seed=seed + 1)
    return base, base.attach(ads, cfgs), ads, cfgs


def _images(cfg, n: int, seed: int, device) -> np.ndarray:
    return synthetic.image_batch(cfg, n, seed, device)["images"].cpu().numpy()


def _serve_images(rt, images, names) -> tuple:
    """(engine, logits (n, C) in request order, classes, wall seconds)."""
    eng = ImageServeEngine(rt, max_batch=IMAGE_ROWS)
    rids = [eng.add_request(img, adapter=names[i % len(names)])
            for i, img in enumerate(images)]
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (eng, np.stack([eng.result_logits[r] for r in rids]),
            [res[r][0] for r in rids], wall)


def image_serve_phase(cfg, seed: int, device, repeats: int = 3) -> dict:
    """Phase 15 a-b: ``ImageServeEngine`` (8 rows a batch) over a bank of 6
    tenants (gsoft, boft, householder round-robin, b = 8) and the base slot,
    64 images; every GSOFT rotation through the bank read by slot id,
    ``bdmm`` for the BOFT rows; median images/s of 3 runs, peak memory, a
    profile of the first 12 requests. Then the same over int8 weights (the
    GSOFT rotation fused: ``gs_q_matmul`` by slot id, no ``gs_fused_T``),
    and the bankless int8 model (``q_matmul`` on every ``wc``)."""
    t0 = time.perf_counter()
    base, rt, _, cfgs = _image_bank(cfg, seed, device)
    setup_s = time.perf_counter() - t0
    names = list(cfgs) + [None]
    images = _images(cfg, IMAGE_REQUESTS, seed + 2, device)
    out = dict(params_bytes=tree_bytes(base.params), setup_s=setup_s)
    for lane, run_rt, gate in (("bf16", rt, ("gs_fused_T", "bdmm")),
                               ("int8", None, ("gs_q_matmul", "bdmm"))):
        if lane == "int8":
            run_rt = rt.quantized("int8")
        _serve_images(run_rt, images[:IMAGE_ROWS], names)        # warm
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        eng, logits, classes, wall = _serve_images(run_rt, images, names)
        launches, slot = _launches(), _slot_launches()
        for name in gate:
            if launches[name] == 0:
                raise AssertionError(f"image {lane} lane never launched "
                                     f"{name}: {launches}")
        check_slot_path(f"image {lane}", launches, slot, gate[:1])
        if lane == "int8" and launches["gs_fused_T"]:
            raise AssertionError(f"the int8 image lane rotated outside the "
                                 f"fused product: {launches}")
        if not (np.isfinite(logits).all() and len(classes) == IMAGE_REQUESTS
                and all(0 <= c < cfg.num_classes for c in classes)):
            raise AssertionError(f"image {lane}: bad logits or classes")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = [wall]
        for _ in range(repeats - 1):
            _, lg, cl, w = _serve_images(run_rt, images, names)
            if cl != classes or not np.array_equal(lg, logits):
                raise AssertionError(f"a repeated image {lane} run differs")
            walls.append(w)
        _SPENT["timed"] += sum(walls)
        out[lane] = dict(
            requests=IMAGE_REQUESTS, wall_s=walls,
            images_s=IMAGE_REQUESTS / float(np.median(walls)),
            batches=eng.stats["decode_steps"], launches=launches,
            slot_launches=slot, peak_mem_gb=peak_gb,
            bdmm_by_route=dict(bk.bdmm.launches_by_route),
            profile=_profile(lambda: _serve_images(
                run_rt, images[:IMAGE_PROFILED], names)))
    bare = ModelRuntime(cfg, run_rt.params, device=device)
    _reset_launches()
    _, _, cl, w = _serve_images(bare, images[:2 * IMAGE_ROWS], [None])
    if _launches()["q_matmul"] == 0:
        raise AssertionError("the bankless int8 image model never launched "
                             "q_matmul")
    out["int8_bankless"] = dict(launches=_launches(), wall_s=w,
                                requests=2 * IMAGE_ROWS)
    del base, rt, run_rt, bare
    torch.cuda.empty_cache()
    return out


def image_check_phase(cfg, seed: int, device) -> dict:
    """Phase 15d, f32 (TF32 off): 16 images (two a tenant, four on the base
    slot) through the banked engine: each tenant's logits equal its solo
    merged runtime's within IMAGE_LOGIT_REL of max|logit|, the base slot's
    equal the bankless engine's bit for bit; the banked net stays
    1-Lipschitz on seeded pairs (every tenant and the base). Over int8
    weights: every tenant's banked logits equal its exact (unquantized)
    merged model's within IMAGE_LOGIT_REL (an identity ``wc`` quantizes
    exactly and the rotation stays in float), and lie within
    QUANT_LOGIT_REL of max|logit| of "merge, then quantize" for the tenants
    whose merged Q is block-diagonal (GSOFT, BOFT, as phase 5b holds
    qwen2's GSOFT); a Householder tenant's merged Q is dense, so its int8
    codes round every entry of it, and that gap is recorded, not gated."""
    base, banked, ads, cfgs = _image_bank(cfg, seed, device)
    names = list(cfgs) + [None, None]
    images = _images(cfg, 2 * IMAGE_ROWS, seed + 3, device)
    _, logits, _, _ = _serve_images(banked, images, names)
    _, bare, _, _ = _serve_images(base, images, [None])
    idx = {n: [i for i in range(len(images)) if names[i % len(names)] == n]
           for n in set(names)}
    if not np.array_equal(logits[idx[None]], bare[idx[None]]):
        raise AssertionError("the base slot's logits differ from the "
                             "bankless model's")
    qbanked = banked.quantized("int8")
    _, qlogits, _, _ = _serve_images(qbanked, images, names)
    gaps, qgap, mq_gap = {}, {}, {}
    for name, pcfg in cfgs.items():
        merged = ModelRuntime(cfg, base.params, device=device,
                              adapters=ads[name], peft_cfg=pcfg)
        x = torch.as_tensor(images[idx[name]], device=device)
        want = merged.infer(x).float().cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        tol = IMAGE_LOGIT_REL * scale
        gaps[name] = float(np.abs(logits[idx[name]] - want).max())
        qgap[name] = float(np.abs(qlogits[idx[name]] - want).max()) / scale
        if not (_err_ok(gaps[name], tol)
                and _err_ok(qgap[name], IMAGE_LOGIT_REL)):
            raise AssertionError(f"{name}: banked logits differ from its "
                                 f"solo merged run by {gaps[name]} (tol "
                                 f"{tol}), over int8 by {qgap[name]} of "
                                 f"max|logit| (tol {IMAGE_LOGIT_REL})")
        mq = merged.quantized("int8").infer(x).float().cpu().numpy()
        mq_gap[name] = float(np.abs(qlogits[idx[name]] - mq).max()) / scale
        if pcfg.method != "householder" and not _err_ok(mq_gap[name],
                                                        QUANT_LOGIT_REL):
            raise AssertionError(f"{name}: banked int8 logits "
                                 f"{mq_gap[name]:.3f} of max|logit| from "
                                 f"merge-then-quantize")
        del merged
    # 1-Lipschitz: one row per tenant and the base, x and a nearby y
    rows = list(cfgs) + [None, None]
    ids = torch.as_tensor([banked.bank.slot(n) for n in rows], device=device)
    x = torch.as_tensor(_images(cfg, IMAGE_ROWS, seed + 4, device),
                        device=device)
    y = x + 0.1 * torch.as_tensor(_images(cfg, IMAGE_ROWS, seed + 5, device),
                                  device=device)
    ctx = banked.context(ids)
    fx, fy = banked.infer(x, ctx), banked.infer(y, ctx)
    ratio = _ratio(fx, fy, x, y).cpu()
    if not bool((ratio <= 1 + LIPSCHITZ_TOL).all()):
        raise AssertionError(f"a banked row is not 1-Lipschitz: {ratio}")
    return dict(logit_max_abs_err=gaps, lipschitz_ratio=ratio.tolist(),
                isometry=_layer_isometry(cfg, banked.params, ctx, seed + 6,
                                         device),
                int8_rel_gap_to_exact=qgap, int8_rel_gap_to_merge_quant=mq_gap,
                allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def _ratio(fx, fy, x, y) -> torch.Tensor:
    """||f(x) - f(y)|| / ||x - y|| for each row."""
    return (fx - fy).flatten(1).norm(dim=1) / (x - y).flatten(1).norm(dim=1)


def _layer_isometry(cfg, params, ctx, seed: int, device) -> dict:
    """The banked net where it should be an isometry: at every layer, on
    seeded feature maps of that layer's shape (one row a slot of ``ctx``),
    the ratio of the GS-SOC convs (plain ``F.conv2d``, six Taylor terms:
    recorded) and of the channel mix behind them (``wc`` through each
    row's rotation from the bank: ``gs_fused_T_bank`` for GSOFT, ``bdmm``
    for BOFT, plain torch for Householder). Every row of every mix must
    keep its norm within ``ISOMETRY_TOL``: a rotation that is not
    orthogonal fails here, whatever the head and the channel selection
    contract."""
    lc = image_model.lip_cfg(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = int(ctx.slots.shape[0])
    mix_dev, conv, n = 0.0, [], 0
    for bi, width in enumerate(lc.block_widths()):
        block = params[f"block{bi}"]
        h = lc.image_size >> bi
        layers = [(f"conv{li}", lc.layer_spec(width), h, width)
                  for li in range(lc.depth // 5 - 1)]
        # down: the conv on 4w channels after space-to-depth, then the mix
        # on the 2w channels it keeps
        layers.append(("down", lc.layer_spec(4 * width), h // 2, 2 * width))
        for name, spec, hw, kept in layers:
            x, y = (torch.randn((rows, hw, hw, spec.channels), generator=gen,
                                device=device) for _ in range(2))
            kernels = {k: block[name][k].float() for k in ("m1", "m2")
                       if k in block[name]}
            u = conv_lib.gs_soc_layer(spec, kernels, x)
            v = conv_lib.gs_soc_layer(spec, kernels, y)
            conv.append(_ratio(u, v, x, y))
            u, v = u[..., :kept].contiguous(), v[..., :kept].contiguous()
            rot = ctx.rotator(ctx.group(f"block{bi}", name))
            mu = image_model._channel_mix(u, block[name]["wc"], rot, "wc")
            mv = image_model._channel_mix(v, block[name]["wc"], rot, "wc")
            dev = float((_ratio(mu, mv, u, v) - 1).abs().max())
            if not dev <= ISOMETRY_TOL:
                raise AssertionError(
                    f"block{bi}.{name}: a banked channel mix changed a row's "
                    f"norm by {dev:.2e} (tol {ISOMETRY_TOL})")
            mix_dev = max(mix_dev, dev)
            n += 1
    conv = torch.cat(conv)
    return dict(layers=n, mix_max_dev=mix_dev, conv_min=float(conv.min()),
                conv_max=float(conv.max()))


def phase_14(full, seed: int, device) -> dict:
    """Phase 14 as ``main()`` runs it, gates and log included: the static,
    traced and streaming lanes (14a-c) of qwen2-72b at ``SERVE_LAYERS``
    layers, bf16; the launcher's static and streaming lanes (14d); the
    f32 check at ``CHECK_LAYERS`` layers (14e)."""
    cfg8 = full.with_overrides(num_layers=SERVE_LAYERS)
    cfg2 = full.with_overrides(num_layers=CHECK_LAYERS, dtype="f32",
                               param_dtype="f32")
    log(f"static / traced serve: qwen2-72b full width, {SERVE_LAYERS} layers, "
        f"bf16, {TRACED_REQUESTS} requests, 4 a batch")
    traced = static_traced_phase(cfg8, seed, device)
    st, tr, pq = traced["static"], traced["traced"], traced["paged_int8"]
    log(f"static lane: merge {st['merge_s']:.1f} s, launches "
        f"{ {k: v for k, v in st['merge_launches'].items() if v} } "
        f"({st['weight_slices']} weight slices); static "
        f"{['%.3f' % w for w in st['static']['wall_s']]} s, median "
        f"{st['static']['tok_s']:.1f} tok/s ({st['static']['decode_steps']} "
        f"decode steps, {st['static']['prefills']} prefills); continuous on "
        f"the same runtime {['%.3f' % w for w in st['continuous']['wall_s']]}"
        f" s, median {st['continuous']['tok_s']:.1f} tok/s "
        f"({st['continuous']['decode_steps']} decode steps); equal tokens "
        f"{st['static_equals_continuous']}")
    sp = st["profile"]
    log(f"static lane profile: wall {sp['wall_s']:.3f} s, device busy "
        f"{sp['device_busy_s']:.3f} s (idle share {sp['idle_share']}, the "
        f"host's operators traced too); ranges (count, host ms, kernels' "
        f"device ms, device span ms) "
        f"{ {k: (v['count'], round(v['host_ms'], 1), round(v['device_ms'], 1), round(v['device_span_ms'], 1)) for k, v in sp['ranges'].items()} }"
        f"; top {[(k['name'][:40], round(k['device_ms'], 1), k['count']) for k in sp['top'][:6]]}")
    log(f"traced serve: tracing off {tr['tok_s_off']:.1f} / on "
        f"{tr['tok_s_on']:.1f} tok/s (ratio {tr['rate_ratio_on_off']:.3f}); "
        f"streaming at {tr['arrival_rate']:.2f} req/s ({STREAM_LOAD} x "
        f"{tr['request_rate_upfront']:.2f}): {tr['stream_tok_s']:.1f} tok/s, "
        f"TTFT ms {tr['slo']['ttft_ms']}, TPOT ms {tr['slo']['tpot_ms']}, "
        f"stalls {tr['slo']['stalls']}; tokens equal the up-front run "
        f"{tr['stream_tokens_equal_upfront']}; exports {tr['jsonl_events']} "
        f"JSONL / {tr['chrome_events']} Chrome events; slot-id launches "
        f"{tr['slot_launches']}")
    log(f"traced paged int8: {pq['num_pages']} pages, kv_stats "
        f"{pq['kv_stats']}; TTFT ms {pq['slo']['ttft_ms']}, TPOT ms "
        f"{pq['slo']['tpot_ms']}, stalls {pq['slo']['stalls']}; launches "
        f"{ {k: v for k, v in pq['launches'].items() if v} }")
    static_launch = launcher_lane_run(
        ["--arch", "qwen2-72b", "--set", f"num_layers={SERVE_LAYERS}",
         "--engine", "static", "--peft-demo", "--requests", "8",
         "--prompt-len", "64", "--max-new", "8", "--mixed-lengths"],
        ["[static] served 8 requests"])
    with tempfile.TemporaryDirectory() as launch_dir:
        trace_out = Path(launch_dir) / "trace.jsonl"
        stream_launch = launcher_lane_run(
            ["--arch", "qwen2-72b", "--set", f"num_layers={SERVE_LAYERS}",
             "--requests", "8", "--prompt-len", "64", "--max-new", "8",
             "--mixed-lengths", "--arrival-rate", "4", "--trace",
             "--trace-out", str(trace_out), "--log-json",
             "--report-interval", "0.5"],
            ["[continuous] served 8 requests", "trace: 8 requests",
             '"event": "summary"'])
        with open(trace_out) as f:
            stream_launch["jsonl_events"] = len([json.loads(line)
                                                 for line in f])
    log(f"static / traced check: {CHECK_LAYERS} layers, f32, TF32 off")
    scheck14 = static_check_phase(cfg2, seed, device)
    log(f"static check: static == continuous (merged) == banked tokens "
        f"{scheck14['tokens']}")
    torch.cuda.empty_cache()
    return dict(static_traced=traced,
                launchers_14=[static_launch, stream_launch],
                static_check=scheck14)


def phase_15(lip, seed: int, device) -> dict:
    """Phase 15 as ``main()`` runs it, gates and log included: image
    serving of ``lip`` (lipconvnet-15 full) in bf16 and int8 (15a-b), the
    launcher's image lane (15c), the f32 checks (15d)."""
    log(f"image serve: lipconvnet-15 full (widths {lip.base_width}-"
        f"{lip.base_width * 16}, {lip.num_classes} classes), bf16, "
        f"{IMAGE_TENANTS} tenants {IMAGE_METHODS} b={IMAGE_BLOCK}, "
        f"{IMAGE_REQUESTS} images, {IMAGE_ROWS} a batch")
    image = image_serve_phase(lip, seed, device)
    for lane in ("bf16", "int8"):
        im = image[lane]
        ip = im["profile"]
        log(f"image {lane}: {['%.3f' % w for w in im['wall_s']]} s, median "
            f"{im['images_s']:.1f} images/s; {im['batches']} batches; peak "
            f"{im['peak_mem_gb']:.2f} GB; launches "
            f"{ {k: v for k, v in im['launches'].items() if v} } (slot-id "
            f"{im['slot_launches']}; bdmm by route {im['bdmm_by_route']})")
        log(f"image {lane} profile ({IMAGE_PROFILED} requests): wall "
            f"{ip['wall_s']:.3f} s, device busy {ip['device_busy_s']:.3f} s "
            f"(idle share {ip['idle_share']}), port kernels "
            f"{ip['port_kernels_device_s']:.4f} s "
            f"{ {k: round(v, 2) for k, v in ip['port_device_ms_by_kernel'].items()} }"
            f" ms; top {[(k['name'][:40], round(k['device_ms'], 2), k['count']) for k in ip['top'][:6]]}")
    log(f"image int8 bankless: launches "
        f"{ {k: v for k, v in image['int8_bankless']['launches'].items() if v} }")
    image_launch = launcher_lane_run(
        ["--arch", "lipconvnet-15", "--family", "image", "--demo-adapters",
         "3", "--trace"], ["[continuous] served 8 requests", "ttft_ms"])
    log("image check: lipconvnet-15 full, f32, TF32 off")
    icheck = image_check_phase(lip.with_overrides(dtype="f32",
                                                  param_dtype="f32"),
                               seed, device)
    iso = icheck["isometry"]
    log(f"image check: banked == solo merged within {IMAGE_LOGIT_REL} of "
        f"max|logit| (max|diff| "
        f"{ {k: '%.2e' % v for k, v in icheck['logit_max_abs_err'].items()} }"
        f"); base slot == bankless bit for bit; every channel mix an "
        f"isometry per row: |ratio - 1| <= {iso['mix_max_dev']:.2e} (tol "
        f"{ISOMETRY_TOL}) over {iso['layers']} layers; the GS-SOC convs' "
        f"ratios {iso['conv_min']:.5f}-{iso['conv_max']:.5f}; whole-net "
        f"ratios {['%.4f' % v for v in icheck['lipschitz_ratio']]} (<= 1 + "
        f"{LIPSCHITZ_TOL}); banked int8 vs the exact model "
        f"{ {k: '%.1e' % v for k, v in icheck['int8_rel_gap_to_exact'].items()} }"
        f" of max|logit| (tol {IMAGE_LOGIT_REL}), vs merge-then-quantize "
        f"{ {k: '%.3f' % v for k, v in icheck['int8_rel_gap_to_merge_quant'].items()} }"
        f" (tol {QUANT_LOGIT_REL}, GSOFT and BOFT tenants)")
    torch.cuda.empty_cache()
    return dict(image_serve=image, image_launcher=image_launch,
                image_check=icheck)


# ---------------------------------------------------------------------------
# phase 16: scale-out — the EngineCluster (replicas sharing the card) and
# tensor-parallel serving (the degenerate tp = 1 mesh, then tp = 2 as two
# gloo ranks on the one card)
# ---------------------------------------------------------------------------

CLUSTER_TENANTS = 8                 # benchmarks/serve_bench.py _lane_cluster
CLUSTER_BUDGET = 4                  # device slots a replica: half the tenants
CLUSTER_REQUESTS = 32
CLUSTER_BATCH = 4
CLUSTER_MAX_LEN = 40
CLUSTER_BLOCK = 8
CLUSTER_PROMPTS = (4, 12)           # prompt lengths, U[4, 12]
# phase 16's depth: cut from SERVE_LAYERS (8) for phase 18's time
SCALE_OUT_LAYERS = 4
TP_BLOCK = 32                       # the TP lanes' GSOFT / BOFT block size
TP_REQUESTS = 8
TP_NEW = 8
TP_MAX_LEN = 64
TP_METHODS = ("gsoft", "gsoft", "gsoft", "boft")   # 3 GSOFT tenants + BOFT
TP_LOGIT_REL = 2.0 ** -4            # bf16, 8 layers: tp = 2 vs tp = 1 logits,
                                    # of max|logit| (partials round to bf16
                                    # and add in fp32 in another order)
TP_KERNELS = ("gs_fused_T", "bdmm", "q_matmul", "gs_q_matmul",
              "paged_decode", "ssd")


def _cluster_work(names, seed: int) -> list:
    """Mixed lengths, round-robin over the tenants: prompts U[4, 12], new
    tokens U[2, 16] (as ``_lane_cluster``'s ``mixed_workload(n, 12, 16)``)."""
    rng = np.random.default_rng(seed + 3)
    lo, hi = CLUSTER_PROMPTS
    return [{"prompt": rng.integers(1, 200, size=int(rng.integers(lo, hi + 1)))
             .tolist(), "max_new_tokens": int(rng.integers(2, 17)),
             "adapter": names[i % len(names)]}
            for i in range(CLUSTER_REQUESTS)]


def _serve_all(eng, work) -> list:
    rids = [eng.add_request(**w) for w in work]
    out = eng.run()
    return [out[r] for r in rids]


def _per_replica_launches(cl) -> list:
    """Count each replica's kernel launches: every launch of a tick is made
    inside the replica's ``step_launch`` (admission, prefill, decode)."""
    per = [Counter_() for _ in cl.engines]
    for i, eng in enumerate(cl.engines):
        def wrapped(orig=eng.step_launch, i=i):
            before, slot0 = _launches(), _slot_launches()
            out = orig()
            after, slot1 = _launches(), _slot_launches()
            per[i].update({k: after[k] - before[k] for k in after})
            per[i]["gs_fused_T_slot"] += (slot1["gs_fused_T"]
                                          - slot0["gs_fused_T"])
            return out
        eng.step_launch = wrapped
    return per


def cluster_phase(base, seed: int, device, repeats: int = 3) -> dict:
    """16a: 8 tenants (4 GSOFT, 4 BOFT, b = 8) in a store, each replica a
    store-paged bank of 4 slots; 32 mixed-length requests queued up front
    through 1 and then 2 replicas on the one card, each after a warm-up
    run. Greedy tokens must be equal; each replica of the pair must read
    the GSOFT bank by slot id in ``gs_fused_T`` and launch ``bdmm``."""
    names = [f"t{i}" for i in range(CLUSTER_TENANTS)]
    cfgs = {n: peft_lib.PEFTConfig(
                method="gsoft" if i < CLUSTER_TENANTS // 2 else "boft",
                block_size=CLUSTER_BLOCK)
            for i, n in enumerate(names)}
    ads = launch_serve.make_demo_adapters(names, base.param_shapes, cfgs,
                                          device, seed=seed + 16)
    store = store_lib.AdapterStore.from_adapters(ads, cfgs)
    work = _cluster_work(names, seed)
    out, outputs = {}, {}
    for n in (1, 2):
        cl = EngineCluster([ServeEngine(base.attach(store,
                                                    hbm_budget=CLUSTER_BUDGET),
                                        max_batch=CLUSTER_BATCH,
                                        max_len=CLUSTER_MAX_LEN, eos_id=-1)
                            for _ in range(n)])
        warm = _serve_all(cl, work)          # page-ins, homes, allocator
        per = _per_replica_launches(cl)
        walls, toks = [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            toks.append(_serve_all(cl, work))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        _SPENT["timed"] += sum(walls)
        if any(t != warm for t in toks):
            raise AssertionError(f"cluster of {n}: reruns changed tokens")
        outputs[n] = warm
        ntok = sum(len(t) for t in warm)
        ad = cl.adapter_stats()
        out[f"replicas_{n}"] = dict(
            wall_s=walls, tok_s=ntok / float(np.median(walls)),
            tokens=ntok, page_ins=ad["misses"], bank_hits=ad["hits"],
            evictions=ad["evictions"],
            affinity_hit_rate=cl.affinity_hit_rate(), routing=cl.routing,
            per_replica_launches=[{k: v for k, v in p.items() if v}
                                  for p in per])
        if n == 2:
            for i, p in enumerate(per):
                if not (p["gs_fused_T_slot"] > 0 and p["bdmm"] > 0
                        and p["gs_fused_T_slot"] == p["gs_fused_T"]):
                    raise AssertionError(
                        f"cluster replica {i}: launches {dict(p)} — each "
                        "replica must read its GSOFT bank by slot id in "
                        "gs_fused_T and launch bdmm")
        del cl
        torch.cuda.empty_cache()
    if outputs[1] != outputs[2]:
        raise AssertionError("cluster: tokens at 2 replicas differ from 1")
    out["tokens_equal"] = True
    out["speedup"] = out["replicas_2"]["tok_s"] / out["replicas_1"]["tok_s"]
    out["store"] = store
    return out


def cluster_kernel_phase(full, gen, device) -> list:
    """16a's kernels against their plain versions at the cluster lane's
    shapes (bf16): b = 8 (``CLUSTER_BLOCK``) on qwen2-72b's whole rows, d =
    d_model (r = 1024 blocks) and d = d_ff (r = 3696), for the decode rows
    (B = ``CLUSTER_BATCH``, T = 1) and each prefill bucket of the lane's
    prompts (B = 1): ``gs_fused_T`` by slot id (the GSOFT tenants) and
    ``bdmm`` with the blocks read as stored and transposed (BOFT)."""
    lo, hi = CLUSTER_PROMPTS
    buckets = sorted({prompt_bucket(n, CLUSTER_MAX_LEN)
                      for n in range(lo, hi + 1)})
    rows = []
    for d in (full.d_model, full.d_ff):
        for B, T in [(CLUSTER_BATCH, 1)] + [(1, t) for t in buckets]:
            rows.append(check_case("gs_fused_T", B, T, d, CLUSTER_BLOCK,
                                   torch.bfloat16, gen, device))
            for trans in (False, True):
                rows.append(check_bdmm_case(B, T, d, CLUSTER_BLOCK,
                                            torch.bfloat16, gen, device,
                                            trans=trans))
            torch.cuda.empty_cache()
    return rows


def _tp_adapters(params, device, seed: int):
    names = [f"a{i}" for i in range(len(TP_METHODS))]
    cfgs = {n: peft_lib.PEFTConfig(method=m, block_size=TP_BLOCK)
            for n, m in zip(names, TP_METHODS)}
    return launch_serve.make_demo_adapters(names, params, cfgs, device,
                                           seed=seed + 61), cfgs


def _tp_work(names, seed: int) -> list:
    rng = np.random.default_rng(seed + 7)
    keys = list(names) + [None]
    return [{"prompt": rng.integers(1, 200, size=int(rng.integers(8, 33)))
             .tolist(), "max_new_tokens": TP_NEW,
             "adapter": keys[i % len(keys)]} for i in range(TP_REQUESTS)]


def _probe_logits(rt, seed: int, device) -> torch.Tensor:
    """Last-position logits of one (4, 16) prefill, rows on slots 1..4."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)
    toks = torch.randint(1, 200, (4, 16), generator=gen, device=device)
    req = peft_lib.PrefillRequest(batch={"tokens": toks},
                                  ctx=rt.context(torch.arange(1, 5,
                                                              device=device)))
    logits, _ = rt.prefill_fn()(rt.params, req, rt.decode_state(4, 16))
    return logits[:, -1].float()


def _bank_gather_probe(rt, device) -> dict:
    """One decode step of 4 rows on slots 1..4 through a split runtime's
    bank: the bytes this rank received to gather the GSOFT blocks of the
    batch's slots (``TPShard.count_bank_gather``), per layer."""
    before = rt.shard.bank_gather_bytes
    rt.decode_fn()(rt.params, rt.context(torch.arange(1, 5, device=device)),
                   torch.ones((4, 1), dtype=torch.int64, device=device),
                   rt.decode_state(4, 16),
                   torch.zeros(4, dtype=torch.int64, device=device))
    return dict(rows=4, layers=rt.cfg.num_layers,
                bytes_per_layer=(rt.shard.bank_gather_bytes - before)
                / rt.cfg.num_layers)


def tp_lanes(cfg2, cfg8, cfgz, seed: int, device, mesh=None,
             base8=None) -> dict:
    """The TP lanes, split or whole: at ``CHECK_LAYERS`` f32 (TF32 off) the
    contiguous bank lane (3 GSOFT tenants + BOFT, b = 32), int8 banked and
    paged int8; zamba2-2.7b full in f32 (``cfgz``: the Mamba2 super-blocks
    and the shared attention block); at ``cfg8``'s depth in bf16 the bank
    lane's tokens and one prefill's logits. Each lane's launches are
    counted from zero."""
    out = {}
    rt = ModelRuntime(cfg2, seed=seed, device=device, mesh=mesh)
    ads, cfgs = _tp_adapters(rt.param_shapes, device, seed)
    banked = rt.attach(ads, cfgs)
    qrt = banked.quantized("int8")
    work = _tp_work(cfgs, seed)
    lanes = (("bank", banked, ServeEngine), ("int8", qrt, ServeEngine),
             ("paged_int8", qrt, None))
    for name, r, eng_cls in lanes:
        eng = (eng_cls(r, max_batch=4, max_len=TP_MAX_LEN, eos_id=-1)
               if eng_cls else _paged_engine(r, 4, TP_MAX_LEN))
        _reset_launches()
        toks = _serve_all(eng, work)
        out[name] = dict(tokens=toks, launches=_launches(),
                         slot_launches=_slot_launches())
    if banked.shard is not None:
        out["bank_gather"] = _bank_gather_probe(banked, device)
    p = rt.params["layers"]
    out["local"] = dict(wq=tuple(p["attn"]["wq"].shape),
                        wo=tuple(p["attn"]["wo"].shape),
                        mlp_wo=tuple(p["mlp"]["wo"].shape),
                        kv_heads=rt.kv_heads)
    del rt, banked, qrt, eng, lanes, p
    gc.collect()
    torch.cuda.empty_cache()
    zrt = ModelRuntime(cfgz, seed=seed, device=device, mesh=mesh)
    _reset_launches()
    zwork = _tp_work({}, seed)
    out["hybrid"] = dict(tokens=_serve_all(ServeEngine(
        zrt, max_batch=4, max_len=TP_MAX_LEN, eos_id=-1), zwork),
        launches=_launches(),
        ssd_heads=zrt.params["blocks"]["mamba"]["A_log"].shape[-1])
    del zrt
    gc.collect()
    torch.cuda.empty_cache()
    rt8 = base8 if base8 is not None else ModelRuntime(
        cfg8, seed=seed, device=device, mesh=mesh)
    ads8, cfgs8 = _tp_adapters(rt8.param_shapes, device, seed)
    b8 = rt8.attach(ads8, cfgs8)
    _reset_launches()
    out["bf16"] = dict(tokens=_serve_all(ServeEngine(
        b8, max_batch=4, max_len=TP_MAX_LEN, eos_id=-1), work),
        launches=_launches())
    out["bf16"]["logits"] = _probe_logits(b8, seed, device).cpu().numpy()
    del b8, rt8
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, world: int, port: int, seed: int, cfgs, device,
             queue) -> None:
    """One rank of 16d: two processes on the one card over gloo."""
    import os
    import traceback
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        torch.set_num_threads(2)        # two ranks share the host's cores
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = serve_mesh(world, device=device, backend="gloo")
        res = tp_lanes(*cfgs, seed, device, mesh=mesh)
        queue.put((rank, res))
    except Exception:                                # noqa: BLE001
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_kernel_phase(full, gen, device) -> list:
    """16d's kernels against their plain versions at tp = 2's local shapes
    (bf16, timed in this process): ``q_matmul`` at the local N (wq, wk /
    wv, wi / wg, the LM head) and K (attention and MLP wo), ``gs_q_matmul``
    at the local N of wq and wi, ``paged_decode`` at 32 / 4 heads. The
    rotations (``gs_fused_T``, ``bdmm``) run on whole rows under TP, the
    shapes of phases 3 and 3c."""
    D, F, hd = full.d_model, full.d_ff, full.d_head
    H, K, V = full.num_heads // 2, full.num_kv_heads // 2, full.padded_vocab()
    rows = []
    for k, n in ((D, H * hd), (D, K * hd), (D, F // 2), (D, V // 2),
                 (H * hd, D), (F // 2, D)):
        rows.append(check_qmm_case(4, k, n, torch.bfloat16, gen, device))
    for n in (H * hd, F // 2):
        rows.append(check_gsq_case(4, 1, D, n, TP_BLOCK, torch.bfloat16,
                                   gen, device))
    local = full.with_overrides(num_heads=H, num_kv_heads=K, head_dim=hd)
    rows.append(check_paged_case(local, PAGE_SIZE, "ctx144", torch.bfloat16,
                                 gen, device))
    # zamba2 at tp = 2: 40 of its 80 SSD heads, P = N = 64, fp32 as the
    # model feeds the scan, one prefill bucket
    zamba = get_config("zamba2-2.7b")
    rows.append(check_ssd_case(1, 128, zamba.ssm_heads // 2,
                               zamba.ssm_headdim, zamba.ssm_state,
                               torch.float32, gen, device))
    torch.cuda.empty_cache()
    return rows


def phase_16(full, seed: int, device, gen) -> dict:
    """Phase 16 as ``main()`` runs it, gates and log included: (a) the
    cluster at 1 and 2 replicas, (b) the launcher's ``--replicas 2`` and
    ``--tp 1`` lanes, (c) the degenerate tp = 1 mesh bit-equal to no mesh,
    (d) tp = 2 as two gloo ranks on the card against tp = 1, and the TP
    kernel shapes against their plain versions."""
    t_phase = time.perf_counter()
    cfg8 = full.with_overrides(num_layers=SCALE_OUT_LAYERS)
    cfg2 = full.with_overrides(num_layers=CHECK_LAYERS, dtype="f32",
                               param_dtype="f32")
    base = ModelRuntime(cfg8, seed=seed, device=device)
    log(f"cluster: qwen2-72b full width, {SCALE_OUT_LAYERS} layers, bf16; "
        f"{CLUSTER_TENANTS} tenants (GSOFT / BOFT, b = {CLUSTER_BLOCK}), "
        f"{CLUSTER_BUDGET} slots a replica, {CLUSTER_REQUESTS} requests")
    cl = cluster_phase(base, seed, device)
    for n in (1, 2):
        r = cl[f"replicas_{n}"]
        log(f"cluster {n} replica(s): {['%.3f' % w for w in r['wall_s']]} s, "
            f"median {r['tok_s']:.1f} tok/s, {r['tokens']} tokens, page-ins "
            f"{r['page_ins']}, evictions {r['evictions']}, affinity hit rate "
            f"{r['affinity_hit_rate']:.3f}, routing {r['routing']}; "
            f"launches a replica {r['per_replica_launches']}")
    log(f"cluster: tokens equal at 1 and 2 replicas; speedup "
        f"{cl['speedup']:.3f} (not gated: one card, one host thread)")
    ccases = cluster_kernel_phase(full, gen, device)
    for c in ccases:
        log(f"cluster kernel {c['kernel']:10s} B={c['B']} T={c['T']} "
            f"d={c['d']} b={c['b']} trans={c.get('trans', '-')} err "
            f"{c['max_abs_err']:.2e} ms {c['ms']:.4f} plain "
            f"{c['plain_ms']:.4f} lib {c['library_ms']:.4f} bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']})")
    with tempfile.TemporaryDirectory() as d:
        cl.pop("store").save(d)
        launch_replicas = launcher_lane_run(
            ["--arch", "qwen2-72b", "--set", f"num_layers={SCALE_OUT_LAYERS}",
             "--replicas", "2", "--store-dir", d, "--hbm-adapter-budget",
             str(CLUSTER_BUDGET), "--requests", "16", "--prompt-len", "12",
             "--max-new", "8", "--mixed-lengths"],
            ["cluster: 2 replica(s), 16 requests", "replica[0]",
             "replica[1]", "bank: hit_rate=", "routing: 16 routed"])
    launch_tp1 = launcher_lane_run(
        ["--arch", "qwen2-72b", "--set", f"num_layers={SCALE_OUT_LAYERS}",
         "--tp", "1", "--engine", "paged", "--quantize", "int8",
         "--requests", "8", "--prompt-len", "64", "--max-new", "8"],
        ["cluster: 1 replica(s), 8 requests", "kv: pool=",
         "quantized base weights (int8)", "[paged] served 8 requests"])
    # (c) the degenerate mesh: the same runtime, bit for bit
    mesh1 = serve_mesh(1, device=device)
    meshed = ModelRuntime(cfg8, base.params, device=device, mesh=mesh1)
    if meshed.shard is not None:
        raise AssertionError("a tp = 1 mesh split the model")
    ads, cfgs = _tp_adapters(base.param_shapes, device, seed)
    cfgs = {k: v for k, v in cfgs.items() if v.method == "gsoft"}
    ads = {k: ads[k] for k in cfgs}
    work = _tp_work(cfgs, seed)
    tp1 = {}
    for name in ("bank", "paged_int8"):
        pair = []
        for rt in (base, meshed):
            r = rt.attach(ads, cfgs)
            if name == "paged_int8":
                r = r.quantized("int8")
                eng = _paged_engine(r, 4, TP_MAX_LEN)
            else:
                eng = ServeEngine(r, max_batch=4, max_len=TP_MAX_LEN,
                                  eos_id=-1)
            pair.append(_serve_all(eng, work))
            del r, eng
            torch.cuda.empty_cache()
        if pair[0] != pair[1]:
            raise AssertionError(f"tp = 1 {name}: the meshed runtime's tokens "
                                 "differ from the unmeshed runtime's")
        tp1[name] = pair[1]
    del meshed
    log(f"tp = 1 (a world of one, {torch.distributed.get_backend()}): "
        f"3-tenant GSOFT bank and paged int8 tokens equal the unmeshed "
        f"runtime's bit for bit")
    # (d) tp = 2: the whole model's lanes here, the split ones in two ranks
    t_ref = time.perf_counter()
    cfgz = get_config("zamba2-2.7b").with_overrides(dtype="f32",
                                                    param_dtype="f32")
    ref = tp_lanes(cfg2, cfg8, cfgz, seed, device, base8=base)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    log(f"this process holds {torch.cuda.memory_allocated(device) / 1e9:.1f} "
        "GB before the ranks start")
    log(f"tp = 1 reference lanes: {time.perf_counter() - t_ref:.1f} s")
    t_spawn = time.perf_counter()
    ranks = _spawn_ranks(_tp_rank, 2, (seed, (cfg2, cfg8, cfgz), device),
                         "16")
    log(f"tp = 2 ranks (gloo, one card): {time.perf_counter() - t_spawn:.1f} s")
    tp2 = {"local": ranks[0]["local"], "launches": {}}
    for lane in ("bank", "int8", "paged_int8", "hybrid"):
        for i, r in enumerate(ranks):
            if r[lane]["tokens"] != ref[lane]["tokens"]:
                raise AssertionError(f"tp = 2 {lane} (f32): rank {i}'s tokens "
                                     "differ from tp = 1")
        tp2["launches"][lane] = [{k: v for k, v in r[lane]["launches"].items()
                                  if v} for r in ranks]
    seen = Counter_()
    for lane in tp2["launches"].values():
        for per_rank in lane:
            seen.update(per_rank)
    missing = [k for k in TP_KERNELS if seen[k] < 2]
    if missing:
        raise AssertionError(f"tp = 2: kernels {missing} never launched on "
                             f"the split path: {tp2['launches']}")
    want = ref["bf16"]["logits"]
    scale = float(np.abs(want).max())
    gaps = [float(np.abs(r["bf16"]["logits"] - want).max()) for r in ranks]
    if not all(g <= TP_LOGIT_REL * scale for g in gaps):
        raise AssertionError(f"tp = 2 bf16 logits: max|gap| {gaps} > "
                             f"{TP_LOGIT_REL} x {scale}")
    diff = [sum(a != b for ra, rb in zip(r["bf16"]["tokens"],
                                         ref["bf16"]["tokens"])
                for a, b in zip(ra, rb)) for r in ranks]
    ntok = sum(len(t) for t in ref["bf16"]["tokens"])
    tp2.update(bf16_logit_gap=gaps, bf16_logit_scale=scale,
               bf16_tokens_differing=diff, bf16_tokens=ntok,
               bf16_launches=[{k: v for k, v in r["bf16"]["launches"].items()
                               if v} for r in ranks])
    tp2["hybrid_ssd_heads"] = [r["hybrid"]["ssd_heads"] for r in ranks]
    tp2["bank_gather"] = [r["bank_gather"] for r in ranks]
    if not all(g["bytes_per_layer"] > 0 for g in tp2["bank_gather"]):
        raise AssertionError(f"tp = 2: the split GSOFT bank gathered "
                             f"nothing: {tp2['bank_gather']}")
    log(f"tp = 2: f32 tokens equal tp = 1 on both ranks (bank, int8, paged "
        f"int8, zamba2 full: SSD heads a rank {tp2['hybrid_ssd_heads']}); "
        f"local wq {tp2['local']['wq']}, wo {tp2['local']['wo']}, MLP "
        f"wo {tp2['local']['mlp_wo']}, kv heads {tp2['local']['kv_heads']}; "
        f"launches {tp2['launches']}")
    log(f"tp = 2 GSOFT bank gather (b = {TP_BLOCK}, fp32 factors split "
        f"over r): one decode step of 4 rows received "
        f"{[g['bytes_per_layer'] for g in tp2['bank_gather']]} bytes a "
        f"layer on ranks 0, 1")
    log(f"tp = 2 bf16 ({SCALE_OUT_LAYERS} layers): logits max|gap| {gaps} of "
        f"max|logit| {scale:.3f} (tol {TP_LOGIT_REL}); tokens differing "
        f"{diff} of {ntok}")
    kcases = tp_kernel_phase(full, gen, device)
    for c in kcases:
        shape = {k: c[k] for k in ("M", "K", "N", "B", "T", "d", "H", "KH",
                                   "D", "P") if k in c}
        lib = ("none" if c["library_ms"] is None
               else f"{c['library_ms']:.4f}")
        log(f"tp kernel {c['kernel']:12s} {shape} err {c['max_abs_err']:.2e} "
            f"ms {c['ms']:.4f} plain {c['plain_ms']:.4f} lib {lib} bound "
            f"{c['bound_ms']:.4f} ({c['bound_by']})")
    _PHASE_S["16 scale-out"] = time.perf_counter() - t_phase
    if torch.distributed.is_initialized():      # the world of one of (b), (c)
        torch.distributed.destroy_process_group()
    return dict(cluster=cl, cluster_kernel_cases=ccases,
                launcher_16=[launch_replicas, launch_tp1],
                tp1=tp1, tp2=tp2, tp_kernel_cases=kcases)


# ---------------------------------------------------------------------------
# phase 17: the Mamba2 families trained on the card (the ssd_bwd kernel),
# and training on a (data x model) mesh: gloo ranks sharing the one card
# ---------------------------------------------------------------------------

SSD_BWD_F32_REL = 1e-4              # each gradient, of its own max |ref|
SSD_BWD_BF16_REL = 2e-2             # bf16 outputs: one rounding, 2^-8
SSD_BWD_PASSES = 2                  # the backward's operations in forward counts
SSM_TRAIN_STEPS = 3
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 2, 256
SSM_TRAIN_LR = 1e-2                 # one fixed batch: the loss must fall
SSM_GRAD_SEQ = 200                  # the FD check's T: four kernel chunks, ragged
SSM_FD_DIRECTIONS = 3               # random directions a family, each checked
# qwen2-72b at full width, depth cut to 1 layer: the mesh runs are two and
# four processes sharing the card's 80 GB, and 2 f32 layers (16.5 GB whole,
# with the rotated copies, their gradients and the GS workspace about 33 GB
# a rank at (2, 1), 21 GB at (2, 2)) do not fit twice or four times
MESH_LAYERS = 1
MESH_BATCH, MESH_SEQ = 8, 64
MESH_STEPS = 3
MESH_MICRO = 2
MESH_REL = 2e-3                     # tests/distributed_runner.py train_cell
MESH_MU_REL = 2e-3                  # AdamW's first moments, of a leaf's max |ref|
MESH_BLOCK = 32
MESH_ZAMBA_LAYERS = 2               # one super-block: 2 Mamba layers + shared
PSUM_REL = 1e-2                     # tests/distributed_runner.py
GPIPE_MICRO, GPIPE_ROWS = 4, 2
GPIPE_REL = 2.0 ** -6               # bf16: of max |ref| (sums in other orders)
DECODE_DP_REL = 1e-4                # f32, of max |logit|
# the two-rank meshes of 17c / 17d, (data, model) and the pipeline axis
MESHES_2 = {"2x1": (2, 1), "1x2": (1, 2)}


def ssd_bwd_cases():
    """(Nb, T, H, P, N, dtype): zamba2's training shape (2 x 256, 80 heads,
    P = N = 64) in f32 and bf16, mamba2-130m's (24 heads, N = 128), a
    ragged T = 1000, and N at the kernels' MAX_N."""
    z, m = (80, 64, 64), (24, 64, 128)
    return [(2, 256) + z + (torch.float32,), (2, 256) + z + (torch.bfloat16,),
            (2, 256) + m + (torch.float32,), (1, 1000) + z + (torch.float32,),
            (1, 256, 8, 64, ssdk.MAX_N, torch.float32)]


def ssd_bwd_bound(nb, t, h, p, n, dtype) -> tuple:
    """Bytes (x, loga, B, C, dy read once; dx, dloga, dB, dC written once)
    over the memory rate, or SSD_BWD_PASSES times the forward's operations
    2 Nb T H (N + P + 2 N P) over the fp32 rate."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * (2 * nb * t * h * p + nb * t * h + 2 * nb * t * h * n) * es
    flops = SSD_BWD_PASSES * 2 * nb * t * h * (n + p + 2 * n * p)
    return _bytes_bound(nbytes, flops, torch.float32)


def check_ssd_bwd_case(nb, t, h, p, n, dtype, gen, device) -> dict:
    """``ssd_bwd`` against autograd through the plain scan (fp32 inputs
    taken from the same values): each of dx, dloga, dB, dC within its
    tolerance of its own max |ref|; timed from the forward's states."""
    def mk(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    x = mk(nb, t, h, p)
    loga = (-(torch.randn((nb, t, h), generator=gen, device=device).abs())
            * 0.3).to(dtype)
    B, C = mk(nb, t, h, n, scale=0.5), mk(nb, t, h, n, scale=0.5)
    dy = mk(nb, t, h, p)
    args = (x, loga, B, C, dy)
    saved = ssdk.ssd_fwd(x, loga, B, C, states=True)[1]
    got = ssdk.ssd_bwd(*args, saved=saved)
    torch.cuda.synchronize()
    want = ssdk.ssd_bwd_plain(*(a.float() for a in args))
    rel_tol = SSD_BWD_F32_REL if dtype == torch.float32 else SSD_BWD_BF16_REL
    errs, rels = {}, {}
    for name, g, w in zip(("dx", "dloga", "dB", "dC"), got, want):
        if g.dtype != dtype:
            raise AssertionError(f"ssd_bwd {name} came back {g.dtype}")
        errs[name] = (g.float() - w).abs().max().item()
        rels[name] = errs[name] / max(w.abs().max().item(), 1e-30)
        if not (math.isfinite(rels[name]) and rels[name] <= rel_tol):
            raise AssertionError(f"ssd_bwd Nb={nb} T={t} H={h} P={p} N={n} "
                                 f"{dtype}: {name} rel err {rels[name]} > "
                                 f"{rel_tol}")
    ms = time_ms(lambda *a: ssdk.ssd_bwd(*a, saved=saved), [args])
    plain_ms = time_ms(ssdk.ssd_bwd_plain, [args])
    bound_ms, bound_by = ssd_bwd_bound(nb, t, h, p, n, dtype)
    return dict(kernel="ssd_bwd", Nb=nb, T=t, H=h, P=p, N=n,
                dtype=str(dtype).replace("torch.", ""),
                max_abs_err=max(errs.values()), abs_errs=errs, rel_errs=rels,
                tol_rel=rel_tol, ms=ms, plain_ms=plain_ms, library_ms=None,
                library_what="none: no single PyTorch call computes the "
                             "scan's gradient",
                bound_ms=bound_ms, bound_by=bound_by,
                bound_ops_passes=SSD_BWD_PASSES)


def _fixed_batch(cfg, seq: int, batch: int, seed: int, device) -> dict:
    """The training loop's first batch: ``seq`` tokens a row, and the vlm's
    patches or the encoder-decoder's frames (``LMDataSource``'s
    ``frontend``)."""
    return {k: torch.as_tensor(v, device=device) for k, v in LMDataSource(
        DataConfig(seq_len=seq, global_batch=batch, seed=seed,
                   vocab_size=min(cfg.vocab_size, 256)),
        frontend=synthetic.frontend_shape(cfg, seq)).batch_at(0).items()}


def ssm_train_phase(cfg, seed: int, device) -> dict:
    """GSOFT (b = 32) training steps of an ``ssm`` / ``hybrid`` model on
    one fixed batch: the loss must fall, and every step must launch
    ``ssd`` twice a Mamba layer (forward, and again under remat) and
    ``ssd_bwd`` once, besides the GS kernels."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=SSM_TRAIN_LR))
    torch.cuda.reset_peak_memory_stats()
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = peft_lib.init_peft(pcfg, params, device=device, seed=seed)
    trainable, frozen = peft_lib.trainable_and_frozen(pcfg, params, adapters)
    opt_state = optim.init(tcfg.opt, trainable)
    batch = _fixed_batch(cfg, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, seed, device)
    step = steps.build_train_step(cfg, tcfg)
    losses, times, launches = [], [], []
    for _ in range(SSM_TRAIN_STEPS):
        _reset_launches()
        t0 = time.perf_counter()
        trainable, opt_state, m = step(frozen, trainable, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(_launches())
    _SPENT["timed"] += sum(times)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, adapters, trainable, frozen, opt_state
    torch.cuda.empty_cache()
    per_step = {"ssd": 2 * cfg.num_layers if cfg.remat == "full"
                else cfg.num_layers, "ssd_bwd": cfg.num_layers}
    for i, got in enumerate(launches):
        for name, n in per_step.items():
            if got[name] != n:
                raise AssertionError(f"{cfg.name} step {i}: {name} launched "
                                     f"{got[name]} times, the design says {n}")
        for name in ("gs_fused", "gs_fused_grads"):
            if got[name] == 0:
                raise AssertionError(f"{cfg.name} step {i}: no {name} launch")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: losses {losses} do not fall")
    tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    return dict(arch=cfg.name, layers=cfg.num_layers, remat=cfg.remat,
                batch=SSM_TRAIN_BATCH, seq=SSM_TRAIN_SEQ, losses=losses,
                step_s=times, tok_s=tokens * (len(times) - 1) / sum(times[1:]),
                peak_mem_gb=peak, launches_per_step=launches[-1],
                design_per_step=per_step)


def _mesh_train(cfg, seed: int, device, mesh=None, method: str = "gsoft",
                n_steps: int = MESH_STEPS, ref_mu=None) -> dict:
    """``n_steps`` train steps (MESH_MICRO microbatches of the fixed global
    batch) of ``method`` (b = MESH_BLOCK), on ``mesh`` or in one process:
    losses, how far the adapters moved, launches, the rank's local widths,
    and AdamW's first moments: held leaf by leaf against ``ref_mu`` (a
    path: the one-process run's, saved) where given, returned (on the host)
    by the one-process run."""
    pcfg = peft_lib.PEFTConfig(method=method, block_size=MESH_BLOCK)
    ocfg = optim.OptimizerConfig(learning_rate=1e-3)
    rt = ModelRuntime(cfg, seed=seed, device=device, mesh=mesh)
    adapters = peft_lib.init_peft(pcfg, rt.param_shapes, device=device,
                                  seed=seed)
    start = {k: v.clone() for k, v in peft_lib.flatten_paths(adapters).items()}
    opt_state = optim.init(ocfg, adapters)
    step = steps.build_train_step(cfg, steps.TrainStepConfig(
        peft=pcfg, opt=ocfg, num_microbatches=MESH_MICRO), mesh)
    batch = _fixed_batch(cfg, MESH_SEQ, MESH_BATCH, seed, device)
    losses = []
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        adapters, opt_state, m = step(rt.params, adapters, opt_state, batch)
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    launches = _launches()
    moved = sum(float((v - start[k]).abs().sum())
                for k, v in peft_lib.flatten_paths(adapters).items())
    p = rt.params
    local = ({"wq": tuple(p["layers"]["attn"]["wq"].shape),
              "mlp_wo": tuple(p["layers"]["mlp"]["wo"].shape)}
             if "attn" in p.get("layers", {}) else
             {"wz": tuple(p["blocks"]["mamba"]["wz"].shape)})
    mu = peft_lib.flatten_paths(opt_state["mu"])
    out = dict(losses=losses, moved=moved, launches=launches, wall_s=wall,
               local=local, method=method)
    if ref_mu is not None:
        out["mu_rel"] = _mu_gap(mu, torch.load(ref_mu, map_location=device))
    elif mesh is None:
        out["mu"] = {k: v.cpu() for k, v in mu.items()}
    del rt, adapters, opt_state, step, mu
    torch.cuda.empty_cache()
    return out


def _mu_gap(mu: dict, ref: dict) -> dict:
    """Each leaf's max |mu - ref| over its max |ref| (AdamW's first
    moments: the gradients' running sums, so a leaf's gradient scale shows
    where the losses, under Adam's per-element normalisation, cannot)."""
    if mu.keys() != ref.keys():
        raise AssertionError(f"first moments: leaves {sorted(mu)} vs "
                             f"{sorted(ref)}")
    return {k: float((mu[k].float() - ref[k].float()).abs().max())
            / max(float(ref[k].abs().max()), 1e-30) for k in ref}


def _p17_ckpt(cfg, seed: int, device, meshes, d: str) -> dict:
    """17d: the params placed on (1, 2) saved (gathered whole, rank 0
    writes), restored onto (2, 1): bit for bit the whole tree."""
    from repro_torch.sharding import specs as shard_specs
    src = meshes["1x2"]
    rt = ModelRuntime(cfg, seed=seed, device=device, mesh=src)
    spec = shard_specs.ShardingRules(cfg, src).serve_params_tree(
        rt.param_shapes)
    t0 = time.perf_counter()
    CheckpointManager(d).save(1, rt.params, mesh=src, spec_tree=spec)
    save_s = time.perf_counter() - t0
    del rt
    torch.cuda.empty_cache()
    dst = meshes["2x1"]
    whole = ModelRuntime(cfg, seed=seed, device=device).params
    dspec = shard_specs.ShardingRules(cfg, dst).serve_params_tree(whole)
    t0 = time.perf_counter()
    got = CheckpointManager(d).restore(whole, device=device, mesh=dst,
                                       spec_tree=dspec)
    restore_s = time.perf_counter() - t0
    a, b = peft_lib.flatten_paths(got), peft_lib.flatten_paths(whole)
    equal = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    nbytes = sum(v.numel() * v.element_size() for v in b.values())
    del got, whole, a, b
    torch.cuda.empty_cache()
    return dict(bit_equal=equal, bytes=nbytes, save_s=save_s,
                restore_s=restore_s)


def _p17_psum(seed: int, device, mesh) -> dict:
    """17d: ``compressed_psum_mean`` over 'data' = 2 of rank-dependent
    GSOFT-sized gradients against their exact mean."""
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_mean, init_error_buffer
    g = {}
    for r in range(2):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 100 + r)
        g[r] = {"L": torch.randn((2, 256, 32, 32), generator=gen,
                                 device=device),
                "R": torch.randn((2, 924, 32, 32), generator=gen,
                                 device=device) * 1e-3}
    mine = g[dist.get_rank()]
    red, err = compressed_psum_mean(mine, init_error_buffer(mine), mesh,
                                    ("data",))
    rel = max(float((red[k] - (g[0][k] + g[1][k]) / 2).abs().max())
              / float(torch.maximum(g[0][k].abs().max(), g[1][k].abs().max()))
              for k in red)
    return dict(rel_err=rel, tol=PSUM_REL,
                err_finite=all(bool(torch.isfinite(e).all())
                               for e in err.values()))


def _gpipe_layers(cfg, seed: int, device) -> dict:
    """Two full-width decoder layers (stacked), drawn from ``seed``."""
    from repro_torch.models.attention import init_attention
    from repro_torch.models.layers import init_stacked_mlp
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"attn_norm": torch.zeros((2, cfg.d_model), dtype=cfg.weight_dtype,
                                     device=device),
            "attn": init_attention(gen, cfg, 2, device),
            "mlp_norm": torch.zeros((2, cfg.d_model), dtype=cfg.weight_dtype,
                                    device=device),
            "mlp": init_stacked_mlp(gen, 2, cfg.d_model, cfg.d_ff,
                                    cfg.mlp_type, cfg.weight_dtype, device)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _p17_gpipe(cfg, seed: int, device, mesh) -> dict:
    """17d: GPipe over 2 stages, one full-width decoder layer a stage, bf16,
    GPIPE_MICRO microbatches: outputs and the stage's weight gradients of
    mean(out^2) against the two layers run in sequence, microbatch by
    microbatch, in this process."""
    from repro_torch.models.transformer import _decoder_layer, _slice
    from repro_torch.sharding.pipeline import (gpipe_forward,
                                               pipeline_bubble_fraction)
    stage = mesh.get_local_rank("pipe")
    stacked = _gpipe_layers(cfg, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    x = torch.randn((GPIPE_MICRO, GPIPE_ROWS, MESH_SEQ, cfg.d_model),
                    generator=gen, device=device).to(cfg.act_dtype)

    def leaf_copy(i):
        return peft_lib._map_paths(_slice(stacked, i), lambda _p, v:
                                   v.detach().clone().requires_grad_(True))

    def fn(p, h):
        return _decoder_layer(cfg, p, h)[0]      # (h, moe aux or None)

    mine = leaf_copy(stage)
    _sync(device)
    t0 = time.perf_counter()
    out = gpipe_forward(fn, mine, x, mesh, axis="pipe")
    out.float().pow(2).mean().backward()
    _sync(device)
    pipe_s = time.perf_counter() - t0
    both = [leaf_copy(0), leaf_copy(1)]
    outs = []
    for m in range(GPIPE_MICRO):
        outs.append(fn(both[1], fn(both[0], x[m])))
    ref = torch.stack(outs)
    ref.float().pow(2).mean().backward()
    out_rel = float((out.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
    g_mine = peft_lib.flatten_paths(mine)
    g_ref = peft_lib.flatten_paths(both[stage])
    grad_rel = max(float((g_mine[k].grad.float() - g_ref[k].grad.float())
                         .abs().max() / g_ref[k].grad.float().abs().max()
                         .clamp(min=1e-30))
                   for k in g_ref if g_ref[k].grad is not None
                   and g_ref[k].grad.abs().max() > 0)
    del stacked, mine, both, out, ref, outs
    torch.cuda.empty_cache()
    return dict(stage=stage, out_rel=out_rel, grad_rel=grad_rel,
                tol=GPIPE_REL, pipe_s=pipe_s,
                bubble=pipeline_bubble_fraction(2, GPIPE_MICRO))


def _p17_decode(cfg, seed: int, device, mesh) -> dict:
    """17d: one decode step of 8 rows split over 'data' = 2 (four a rank),
    gathered, against the same runtime's decode of all 8 in one call."""
    rt = ModelRuntime(cfg, seed=seed, device=device, mesh=mesh)
    fam = api.family_ops(cfg)
    tokens = torch.arange(1, 9, device=device)[:, None]
    pos = torch.tensor(0, device=device)
    whole_state = fam.init_decode_state(cfg, 8, 32, device)
    _, want, _ = steps.build_decode_step(cfg)(rt.params, None, tokens,
                                              whole_state, pos)
    mine = steps.local_rows(mesh, tokens)
    state = fam.init_decode_state(cfg, mine.shape[0], 32, device)
    _, got, _ = steps.build_decode_step(cfg, tp=rt.shard)(rt.params, None,
                                                          mine, state, pos)
    got = steps.gather_rows(mesh, got.float())
    rel = float((got - want.float()).abs().max() / want.float().abs().max())
    del rt, whole_state, state
    torch.cuda.empty_cache()
    return dict(rows=int(mine.shape[0]), rel=rel, tol=DECODE_DP_REL)


def _p17_work(world: int, seed: int, cfgs, device, work: str) -> dict:
    """17c / 17d on one rank of ``world`` (gloo ranks sharing the card:
    CUDA tensors staged through the host, a check of the split training
    path, never a speed). ``work``: a directory holding the one-process
    runs' first moments (``mu_qwen2.pt``, ``mu_zamba2.pt``) and room for
    17d's checkpoint."""
    from repro_torch.launch.mesh import make_axes_mesh, make_mesh
    qcfg, qsp, zcfg, bcfg = cfgs
    kind = device.type
    res = {}
    mu_q = os.path.join(work, "mu_qwen2.pt")
    if world == 4:
        res["2x2"] = _mesh_train(qcfg, seed, device,
                                 make_mesh(2, 2, device_type=kind),
                                 ref_mu=mu_q)
        return res
    meshes = {k: make_mesh(*v, device_type=kind) for k, v in MESHES_2.items()}
    pipe = make_axes_mesh((2,), ("pipe",), device_type=kind)
    res["2x1"] = _mesh_train(qcfg, seed, device, meshes["2x1"], ref_mu=mu_q)
    res["1x2"] = _mesh_train(qcfg, seed, device, meshes["1x2"], ref_mu=mu_q)
    res["1x2_sp"] = _mesh_train(qsp, seed, device, meshes["1x2"], ref_mu=mu_q)
    res["1x2_boft"] = _mesh_train(qcfg, seed, device, meshes["1x2"],
                                  method="boft", n_steps=1)
    res["zamba_1x2"] = _mesh_train(zcfg, seed, device, meshes["1x2"],
                                   ref_mu=os.path.join(work, "mu_zamba2.pt"))
    res["ckpt"] = _p17_ckpt(bcfg.with_overrides(num_layers=1), seed, device,
                            meshes, os.path.join(work, "ckpt"))
    res["psum"] = _p17_psum(seed, device, meshes["2x1"])
    res["gpipe"] = _p17_gpipe(bcfg, seed, device, pipe)
    res["decode"] = _p17_decode(qcfg, seed, device, meshes["2x1"])
    return res


def _mesh_rank(rank: int, world: int, port: int, seed: int, cfgs, device,
               work, queue) -> None:
    """One gloo rank of the mesh phases, which share their processes:
    ``cfgs`` = (17's configs, 20's configs), ``work`` = (17's directory,
    20's), either part None when it does not run; each part's seconds on
    this rank come back beside its results (``seconds``)."""
    import traceback

    import torch.distributed as dist
    try:
        _join_gloo(rank, world, port, device)
        res, spent = {}, {}
        for part, fn, c, w in (("17", _p17_work, cfgs[0], work[0]),
                               ("20", _p20_work, cfgs[1], work[1])):
            if c is not None:
                t0 = time.perf_counter()
                res.update(fn(world, seed, c, device, w))
                spent[part] = time.perf_counter() - t0
        res["seconds"] = spent
        queue.put((rank, res))
    except Exception:                                # noqa: BLE001
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _join_gloo(rank: int, world: int, port: int, device) -> None:
    """Join a gloo group of ``world`` processes on this host as ``rank``,
    on ``device`` (the ranks share the card), TF32 off, two host threads."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port),
                      PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo")


def _spawn_ranks(target, world: int, args: tuple, phase: str,
                 timeout: float = 600) -> list:
    """``target(rank, world, port, *args, queue)`` in ``world`` spawned
    processes; [rank 0's result, ...]. A rank that fails fails the phase;
    every process is joined or killed before this returns."""
    import socket
    import torch.multiprocessing as mp
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, port) + tuple(args)
                         + (queue,))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [v["error"] for v in got.values() if "error" in v]
    if errors:
        raise AssertionError(f"phase {phase} rank failed:\n{errors[0]}")
    return [got[r] for r in range(world)]


def _agree(name: str, got: list, want: list) -> float:
    gap = max(abs(a - b) - MESH_REL * abs(b) for a, b in zip(got, want))
    if not (all(map(math.isfinite, got)) and gap <= MESH_REL):
        raise AssertionError(f"{name}: losses {got} vs single-process {want} "
                             f"(rtol = atol = {MESH_REL})")
    return max(abs(a - b) for a, b in zip(got, want))


def phase_17(full, mamba, zamba, seed: int, device, gen, p20=None) -> dict:
    """17a ssd_bwd; 17b the Mamba2 families trained on the card; 17c
    training on (2, 1), (1, 2) with and without seq_parallel, and (2, 2);
    17d elastic restore, the compressed mean, GPipe, decode at data = 2.
    ``p20`` = (phase 20's rank configs, the directory of its one-process
    runs): its mesh runs share 17c's processes, and their results come
    back as ``p20_ranks`` (two ranks', four ranks')."""
    out = {}
    t_phase = time.perf_counter()
    out["ssd_bwd_cases"] = [check_ssd_bwd_case(*c, gen, device)
                            for c in ssd_bwd_cases()]
    for c in out["ssd_bwd_cases"]:
        log(f"ssd_bwd Nb={c['Nb']} T={c['T']} H={c['H']} P={c['P']} "
            f"N={c['N']} {c['dtype']}: rel errs "
            f"{ {k: '%.1e' % v for k, v in c['rel_errs'].items()} } (tol "
            f"{c['tol_rel']:.0e}); {c['ms']:.4f} ms vs plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']})")
    _PHASE_S["17a ssd_bwd"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    out["train"] = {}
    for cfg in (mamba, zamba):
        r = ssm_train_phase(cfg, seed, device)
        out["train"][cfg.name] = r
        log(f"ssm train {cfg.name}: {r['layers']} layers (full width and "
            f"depth), bf16, GSOFT b=32, {r['batch']}x{r['seq']} tokens, "
            f"losses {['%.4f' % v for v in r['losses']]}; "
            f"{r['tok_s']:.0f} tok/s, step {['%.2f' % s for s in r['step_s']]}"
            f" s; peak {r['peak_mem_gb']:.1f} GB; launches a step "
            f"{ {k: v for k, v in r['launches_per_step'].items() if v} }")
    out["grad"] = {}
    for name, cfg in (("mamba2-130m", mamba.with_overrides(
            num_layers=GRAD_LAYERS, dtype="f32", param_dtype="f32")),
                      ("zamba2-2.7b", zamba.with_overrides(
            num_layers=GRAD_LAYERS, attn_every=GRAD_LAYERS, dtype="f32",
            param_dtype="f32"))):
        k = SSM_FD_DIRECTIONS
        r = grad_phase(cfg, seed, device, "gsoft", seq=SSM_GRAD_SEQ,
                       directions=k, per_norm=True)
        for kn in ("ssd", "ssd_bwd"):
            if r["launches"][kn] == 0:
                raise AssertionError(f"{name} gradient: no {kn} launch")
        out["grad"][name] = r
        log(f"ssm grad {name} ({GRAD_LAYERS} layers f32, T={SSM_GRAD_SEQ}, "
            f"{k} random directions, |g| {r['grad_norm']:.4e}): directional "
            f"derivative vs central difference " + ", ".join(
                f"{d['directional_derivative']:.6e} vs "
                f"{d['central_difference']:.6e} (rel {d['rel_err']:.1e})"
                for d in r["directions"]) +
            f" (tol {FD_REL:.0e} of max(|derivative|, |g|)); launches "
            f"{ {kn: v for kn, v in r['launches'].items() if v} }")
    _PHASE_S["17b ssm training"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    # qwen2 (remat "none") gathers its row-split slices once a step and
    # keeps them for the backward; zamba2 (remat "full") gathers them for
    # each microbatch and again in the backward
    qcfg = full.with_overrides(num_layers=MESH_LAYERS, dtype="f32",
                               param_dtype="f32", remat="none")
    qsp = qcfg.with_overrides(seq_parallel=True)
    zcfg = zamba.with_overrides(num_layers=MESH_ZAMBA_LAYERS,
                                attn_every=MESH_ZAMBA_LAYERS, dtype="f32",
                                param_dtype="f32")
    bcfg = full.with_overrides(num_layers=MESH_LAYERS)
    ref_q = _mesh_train(qcfg, seed, device)
    ref_z = _mesh_train(zcfg, seed, device)
    gc.collect()
    torch.cuda.empty_cache()            # the ranks share the card
    with tempfile.TemporaryDirectory() as d:
        torch.save(ref_q.pop("mu"), os.path.join(d, "mu_qwen2.pt"))
        torch.save(ref_z.pop("mu"), os.path.join(d, "mu_zamba2.pt"))
        cfgs = ((qcfg, qsp, zcfg, bcfg), p20[0] if p20 else None)
        work = (d, p20[1] if p20 else None)
        ranks2 = _spawn_ranks(_mesh_rank, 2, (seed, cfgs, device, work), "17")
        ranks4 = _spawn_ranks(_mesh_rank, 4, (seed, cfgs, device, work), "17")
    if p20:
        out["p20_ranks"] = (ranks2, ranks4)
        log(f"17c's ranks ran phase 20's mesh runs too: "
            f"{[round(r['seconds']['20'], 1) for r in ranks2]} s on the two "
            f"ranks, {[round(r['seconds']['20'], 1) for r in ranks4]} on the "
            f"four (17's own {[round(r['seconds']['17'], 1) for r in ranks2]}"
            f", {[round(r['seconds']['17'], 1) for r in ranks4]})")
    mesh_runs = {}
    for name, ranks, want in (("2x1", ranks2, ref_q), ("1x2", ranks2, ref_q),
                              ("1x2_sp", ranks2, ref_q),
                              ("2x2", ranks4, ref_q),
                              ("zamba_1x2", ranks2, ref_z)):
        gaps = [_agree(f"mesh {name} rank {i}", r[name]["losses"],
                       want["losses"]) for i, r in enumerate(ranks)]
        if not all(r[name]["moved"] > 0 for r in ranks):
            raise AssertionError(f"mesh {name}: the adapters did not move")
        mu_rel = max(max(r[name]["mu_rel"].values()) for r in ranks)
        if not mu_rel <= MESH_MU_REL:
            bad = {k: v for r in ranks for k, v in r[name]["mu_rel"].items()
                   if not v <= MESH_MU_REL}
            raise AssertionError(f"mesh {name}: AdamW first moments off the "
                                 f"single-process run's by more than "
                                 f"{MESH_MU_REL} of a leaf's max: {bad}")
        mesh_runs[name] = dict(
            losses=[r[name]["losses"] for r in ranks], max_gap=max(gaps),
            mu_rel=mu_rel, mu_leaves=len(ranks[0][name]["mu_rel"]),
            wall_s=[r[name]["wall_s"] for r in ranks],
            local=ranks[0][name]["local"],
            launches=[{k: v for k, v in r[name]["launches"].items() if v}
                      for r in ranks])
        log(f"mesh {name}: losses {['%.5f' % v for v in ranks[0][name]['losses']]}"
            f" vs single {['%.5f' % v for v in want['losses']]} (max gap "
            f"{max(gaps):.1e}); first moments within {mu_rel:.1e} of each "
            f"leaf's max (tol {MESH_MU_REL:.0e}, "
            f"{mesh_runs[name]['mu_leaves']} leaves, every rank); local "
            f"{ranks[0][name]['local']}; launches "
            f"rank 0 {mesh_runs[name]['launches'][0]}")
    if any(r["zamba_1x2"]["launches"]["ssd_bwd"] == 0 for r in ranks2):
        raise AssertionError("zamba2 at (1, 2): no ssd_bwd launch")
    boft = [{k: v for k, v in r["1x2_boft"]["launches"].items() if v}
            for r in ranks2]
    for name in ("bdmm", "bdmm_dblocks"):
        if any(b.get(name, 0) == 0 for b in boft):
            raise AssertionError(f"BOFT at (1, 2): no {name} launch ({boft})")
    mesh_runs["1x2_boft"] = dict(launches=boft,
                                 losses=[r["1x2_boft"]["losses"]
                                         for r in ranks2])
    out["mesh"] = dict(single=dict(qwen2=ref_q, zamba2=ref_z),
                       runs=mesh_runs)
    _PHASE_S["17c mesh training"] = time.perf_counter() - t_phase

    ck = [r["ckpt"] for r in ranks2]
    if not all(c["bit_equal"] for c in ck):
        raise AssertionError(f"elastic restore (1, 2) -> (2, 1): {ck}")
    ps = [r["psum"] for r in ranks2]
    if not all(p["rel_err"] <= PSUM_REL and p["err_finite"] for p in ps):
        raise AssertionError(f"compressed_psum_mean: {ps}")
    gp = [r["gpipe"] for r in ranks2]
    if not all(g["out_rel"] <= GPIPE_REL and g["grad_rel"] <= GPIPE_REL
               for g in gp):
        raise AssertionError(f"gpipe vs sequential: {gp}")
    dec = [r["decode"] for r in ranks2]
    if not all(x["rel"] <= DECODE_DP_REL and x["rows"] == 4 for x in dec):
        raise AssertionError(f"decode at (2, 1): {dec}")
    out.update(elastic=ck, psum=ps, gpipe=gp, decode_dp=dec)
    log(f"elastic restore (1, 2) -> (2, 1): bit-equal, "
        f"{ck[0]['bytes'] / 1e9:.2f} GB (save {ck[0]['save_s']:.1f} s, "
        f"restore {ck[0]['restore_s']:.1f} s); compressed mean over data=2 "
        f"rel err {max(p['rel_err'] for p in ps):.1e} (tol {PSUM_REL:.0e}); "
        f"gpipe 2 stages x {GPIPE_MICRO} microbatches out rel "
        f"{max(g['out_rel'] for g in gp):.1e}, grads rel "
        f"{max(g['grad_rel'] for g in gp):.1e} (tol {GPIPE_REL:.1e}, bubble "
        f"{gp[0]['bubble']:.2f}); decode at (2, 1) rel "
        f"{max(x['rel'] for x in dec):.1e} (tol {DECODE_DP_REL:.0e})")
    return out


# ---------------------------------------------------------------------------
# 18. the MoE family and the other dense decoders
# ---------------------------------------------------------------------------

MOE_BATCH, MOE_SEQ = 2, 256         # 18a's input, 18c's batch
MOE_REL = 1e-4                      # 18a: card vs CPU, f32, of max |y|
MOE_AUX_ABS = 1e-5                  # 18a: the load-balance loss, card vs CPU
# 18c's depth: GSOFT on the experts of all 48 layers is about 1.9 G adapter
# parameters, which with AdamW's two moments do not fit beside 61 GB of
# bf16 weights
MOE_TRAIN_LAYERS = 4
# 18d: about 11 GB of bf16 weights, twice; 12 layers took 69.5 s, and with
# phase 20 (142.2 s alone) the script would pass 1100 s
MOE_SERVE_LAYERS = 8
MOE_STEPS = 3
MOE_LR = 1e-2                       # one fixed batch, 3 steps: the loss falls
STACK_SAMPLES = 3                   # 18b: slices held against the plain one
DENSE_CHECK_LAYERS = 2              # 18e: granite / mistral, full width
PREFIX_CHUNK, PREFIX_SEQ = 128, 512  # 18e: prefix_loop's 4 query chunks
PREFIX_REL = 1e-4                   # f32 prefix_loop vs dense, of max |logit|
# a GSOFT bank an MoE config serves: the attention projections (the expert
# stacks have two batch dims, which a bank refuses, as in JAX)
ATTN_TARGETS = (r".*/attn/(wq|wk|wv|wo)$",)


def moe_layer_phase(cfg, seed: int, device) -> dict:
    """18a: one full-width MoE layer (``models/moe.py``, plain torch) on the
    card against the same code on the CPU in f32: y within MOE_REL of max
    |y|, the load-balance loss within MOE_AUX_ABS, and the same kept /
    dropped choices, experts and slots; then its time in bf16 and the
    dropped share of the choices."""
    c32 = cfg.with_overrides(num_layers=1, dtype="f32", param_dtype="f32")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 31)
    p = {k: v[0] for k, v in moe_lib.init_moe(gen, c32, 1, torch.float32,
                                              device).items()}
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen,
                    device=device)
    seg = cfg.moe_segment
    y, aux = moe_lib.moe_layer(p, x, c32, seg)
    r = moe_lib.routing(p, x, c32, seg)
    pc = {k: v.cpu() for k, v in p.items()}
    yc, auxc = moe_lib.moe_layer(pc, x.cpu(), c32, seg)
    rc = moe_lib.routing(pc, x.cpu(), c32, seg)
    scale = max(1e-30, yc.abs().max().item())
    err = (y.cpu() - yc).abs().max().item()
    aux_err = abs(float(aux) - float(auxc))
    masks = {n: int((getattr(r, n).cpu() != getattr(rc, n)).sum())
             for n in ("idx", "slot", "keep")}
    if not (math.isfinite(err) and err <= MOE_REL * scale
            and aux_err <= MOE_AUX_ABS and not any(masks.values())):
        raise AssertionError(f"moe_layer card vs CPU: max|diff| {err} of "
                             f"max|y| {scale}, aux {aux_err}, differing "
                             f"routing entries {masks}")
    c16 = cfg.with_overrides(num_layers=1)
    pb = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in p.items()}
    xb = x.to(torch.bfloat16)
    ms = time_ms(lambda a, b: moe_lib.moe_layer(a, b, c16, seg), [(pb, xb)])
    rb = moe_lib.routing(pb, xb, c16, seg)
    return dict(E=cfg.moe_experts, k=cfg.moe_top_k, d=cfg.d_model,
                f_e=cfg.expert_d_ff, batch=MOE_BATCH, seq=MOE_SEQ,
                capacity=moe_lib._capacity(cfg, moe_lib.segment_len(
                    MOE_SEQ, seg)),
                rel_err=err / scale, aux=float(aux), aux_err=aux_err,
                masks_equal=True, choices=int(r.keep.numel()),
                dropped_share_f32=float((~r.keep).float().mean()),
                bf16_ms=ms, dropped_share_bf16=float(
                    (~rb.keep).float().mean()))


def moe_stack_cases(qwen3, phi) -> list:
    """(arch, projection, E, T, d) of one layer's expert stack: the GS
    rotation's tokens are the columns of W (T = d_out, d = d_in)."""
    out = []
    for cfg in (qwen3, phi):
        E, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
        out += [(cfg.name, "wi", E, f, d), (cfg.name, "wo", E, d, f)]
    return out


def stack_bound(kernel: str, E: int, T: int, d: int, b: int, dtype) -> tuple:
    """The least time of one launch over E rows: ``bound`` for the
    rotation; for the grads x and dy read, L and R read, dL and dR (fp32)
    written once, 8 E T d b operations."""
    if kernel == "gs_fused":
        return bound(E, T, d, b, dtype)
    es = torch.finfo(dtype).bits // 8
    return _bytes_bound(2 * E * T * d * es + 2 * E * d * b * (es + 4),
                        8 * E * T * d * b, dtype)


def check_stack_case(arch, proj, kernel, E, T, d, b, dtype, gen,
                     device, loop_too: bool = True) -> dict:
    """18b: ``kernel`` (``gs_fused`` or ``gs_fused_grads``) over a whole
    expert stack in ONE launch (the E slices are its rows), against its
    plain version on STACK_SAMPLES sampled slices and against the per-slice
    loop (E one-row launches), each timed; the
    library yardstick is the dense per-slice Q through ``bmm`` (the
    rotation) or the b x b sums as batched GEMMs (the grads). 19 takes a
    layer stack's rows the same way, without the loop (``loop_too``)."""
    r = d // b
    fn, plain = KERNELS[kernel]["fn"], KERNELS[kernel]["plain"]
    grads = kernel == "gs_fused_grads"
    L, R = _orth_factors(gen, E, r, b, dtype, device)
    x = torch.randn((E, T, d), generator=gen, device=device).to(dtype)
    args = ((x, torch.randn((E, T, d), generator=gen, device=device)
             .to(dtype), L, R) if grads else (x, L, R))

    def loop(*a):
        outs = [fn(*(t[i:i + 1] for t in a)) for i in range(E)]
        return (tuple(torch.cat(o) for o in zip(*outs)) if grads
                else torch.cat(outs))

    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise AssertionError(f"{kernel} over {E} rows launched "
                             f"{fn.launches - before} times")
    looped = loop(*args) if loop_too else out
    idx = torch.tensor(sorted({0, E // 2, E - 1})[:STACK_SAMPLES],
                       device=device)
    want = plain(*(t.index_select(0, idx) for t in args))

    def rel(a, w):
        return (a.float() - w.float()).abs().max().item() / max(
            1.0, w.float().abs().max().item())

    if grads:
        plain_err = max(rel(g.index_select(0, idx), w)
                        for g, w in zip(out, want))
        loop_err = max(rel(g, w) for g, w in zip(out, looped))
        tol = GRAD_REL
    else:
        plain_err = (out.index_select(0, idx).float()
                     - want.float()).abs().max().item()
        loop_err = (out.float() - looped.float()).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not (math.isfinite(plain_err) and plain_err <= tol
            and math.isfinite(loop_err) and loop_err <= tol):
        raise AssertionError(f"{kernel} {arch} {proj} E={E} T={T} d={d}: "
                             f"vs plain {plain_err}, vs the loop {loop_err} "
                             f"(tol {tol})")
    del out, looped, want
    ms = time_ms(fn, [args])
    loop_ms = time_ms(loop, [args]) if loop_too else None
    plain_ms = time_ms(plain, [args])
    if grads:
        a = torch.randn((E * r, b, T), generator=gen, device=device)
        c = torch.randn((E * r, T, b), generator=gen, device=device)
        lib_ms = time_ms(lambda p, q: (torch.bmm(p, q), torch.bmm(p, q)),
                         [(a, c)])
        lib_what = ("2 x bmm over E r blocks (b, T) @ (T, b), fp32: the "
                    "sums only")
        del a, c
        plan = gk.bwd_plan(E, T, r, b, gk._DTYPES[dtype], gk._num_sms(device))
    else:
        M = _dense(kernel, L, R, device)
        lib_ms = time_ms(torch.bmm, [(x, M)])
        lib_what = "bmm(x, dense Q per slice)"
        del M
        plan = gk.fwd_plan(E, T, r, b, gk._DTYPES[dtype], gk._num_sms(device))
    bound_ms, bound_by = stack_bound(kernel, E, T, d, b, dtype)
    del args, x, L, R
    torch.cuda.empty_cache()
    return dict(kernel=kernel, arch=arch, proj=proj, B=E, T=T, d=d, b=b,
                r=r, route=plan.route, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=plain_err,
                loop_err=loop_err if loop_too else None, tol=tol, ms=ms,
                loop_ms=loop_ms, loop_launches=E if loop_too else None,
                plain_ms=plain_ms,
                library_ms=lib_ms, library_what=lib_what,
                bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def per_slice_rotations(method: str = "gsoft"):
    """``adapters.materialize`` as the per-slice loop runs it: one
    rotation launch per weight slice (the method's ``stacked`` off)."""
    old = methods_lib.get(method)
    methods_lib.register(dataclasses.replace(old, stacked=False))
    try:
        yield
    finally:
        methods_lib.register(old)


def _train_argv(arch: str, cfg, steps_n: int, lr: float, seed: int) -> list:
    return ["--arch", arch, "--peft", "gsoft", "--block-size", "32",
            "--steps", str(steps_n), "--batch", str(MOE_BATCH), "--seq",
            str(MOE_SEQ), "--lr", str(lr), "--warmup", "1", "--seed",
            str(seed), "--no-resume", "--set", f"num_layers={cfg.num_layers}"]


def _launch_train(argv) -> dict:
    """``launch/train.py`` in this process; its output echoed to the log,
    its step lines parsed (loss, and moe_aux where it prints one)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  launcher: {line}")
    steps_ = [line.split() for line in out.splitlines()
              if line.startswith("step ")]
    losses = [float(s[s.index("loss") + 1]) for s in steps_]
    auxs = [float(s[s.index("moe_aux") + 1]) for s in steps_
            if "moe_aux" in s]
    if rc != 0 or not losses or not all(map(math.isfinite, losses)):
        raise AssertionError(f"launch/train.py {argv} returned {rc}: {out}")
    return dict(argv=argv, losses=losses, moe_aux=auxs)


def _train_batch(cfg, seq: int, batch: int, seed: int, device) -> dict:
    """One fixed batch of ``seq`` positions a row: ``_fixed_batch`` with
    the vlm's text after its patches (``synthetic.text_len``)."""
    return _fixed_batch(cfg, synthetic.text_len(cfg, seq), batch, seed,
                        device)


def fixed_batch_train(cfg, seed: int, device, steps_n: int, lr: float,
                      profile: bool = False, before_after: bool = False,
                      seq: int = MOE_SEQ) -> dict:
    """GSOFT (b = 32) on one fixed batch of MOE_BATCH x ``seq`` positions
    (a vlm's patches and an encdec's frames included, ``_train_batch``):
    ``steps_n`` steps of ``build_train_step``, each one's launches equal to
    the design's (one rotation launch an adapted stack chunk); the losses
    must be finite and, over several steps, fall. ``profile``: one more step under the profiler (idle share);
    ``before_after``: one more with the per-slice loop, its launches and
    time. Returns the trained adapters too."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    tcfg = steps.TrainStepConfig(
        peft=pcfg, opt=optim.OptimizerConfig(learning_rate=lr))
    torch.cuda.reset_peak_memory_stats()
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = peft_lib.init_peft(pcfg, params, device=device, seed=seed)
    trainable, frozen = peft_lib.trainable_and_frozen(pcfg, params, adapters)
    opt_state = optim.init(tcfg.opt, trainable)
    step = steps.build_train_step(cfg, tcfg)
    batch = _train_batch(cfg, seq, MOE_BATCH, seed, device)
    per_step = {k: v for k, v in design_launches(pcfg, frozen).items() if v}
    losses, auxs, times = [], [], []
    for _ in range(steps_n):
        _reset_launches()
        t0 = time.perf_counter()
        trainable, opt_state, m = step(frozen, trainable, opt_state, batch)
        losses.append(float(m["loss"]))
        auxs.append(float(m["moe_aux"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: v for k, v in _launches().items() if v}
        if got != per_step:
            raise AssertionError(f"{cfg.name}: a step launched {got}, the "
                                 f"design says {per_step}")
    _SPENT["timed"] += sum(times)
    if not (all(map(math.isfinite, losses))
            and (steps_n == 1 or losses[-1] < losses[0])):
        raise AssertionError(f"{cfg.name}: losses {losses} do not fall")
    warm = times[1:] or times                 # the first step warms up
    out = dict(arch=cfg.name, layers=cfg.num_layers, batch=MOE_BATCH,
               seq=seq, lr=lr, losses=losses, moe_aux=auxs, step_s=times,
               tok_s=MOE_BATCH * seq * len(warm) / sum(warm),
               launches_per_step=per_step,
               adapted_slices=_slices(pcfg, frozen))
    if before_after:
        with per_slice_rotations():
            _reset_launches()
            t0 = time.perf_counter()
            step(frozen, trainable, opt_state, batch)
            torch.cuda.synchronize()
            out["per_slice_step_s"] = time.perf_counter() - t0
            out["per_slice_launches"] = {k: v for k, v in _launches().items()
                                         if v}
    if profile:
        out["profile"] = _profile(lambda: step(frozen, trainable, opt_state,
                                               batch))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["trained"] = trainable
    del params, adapters, frozen, opt_state, step
    torch.cuda.empty_cache()
    return out


def _work(cfg, seed: int, names, n: int = 8, new: int = 16) -> list:
    """``n`` requests (prompts of PROMPT_LENS tokens, ``new`` new tokens),
    round-robin over ``names``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=n)
    return [(rng.integers(1, cfg.vocab_size, size=int(k)).tolist(),
             names[i % len(names)], new) for i, k in enumerate(lens)]


PROFILED_REQUESTS = 2                # 18d's profiled runs: the first two


def serve_lane(rt, work, make, static: bool = False,
               profile: bool = True) -> dict:
    """One warm-up run, one counted run of ``work`` through the engine
    ``make(rt)`` (every request must finish with its tokens in the
    vocabulary), then, with ``profile``, the first PROFILED_REQUESTS
    requests under the profiler (the trace of the whole run takes a
    minute to process). ``static``: the requests name no adapter."""

    def drive(part=work):
        eng = make(rt)
        rids = [eng.add_request(p, max_new_tokens=n,
                                **({} if static else {"adapter": a}))
                for p, a, n in part]
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        return eng, [res[r] for r in rids], time.perf_counter() - t0

    drive()                                     # warm: the first prefills
    _reset_launches()
    eng, tokens, wall = drive()
    launches = {k: v for k, v in _launches().items() if v}
    slot = _slot_launches()
    _SPENT["timed"] += wall
    vp = rt.cfg.padded_vocab()
    if [len(t) for t in tokens] != [n for _, _, n in work] or not all(
            0 <= t < vp for seq in tokens for t in seq):
        raise AssertionError(f"served {[len(t) for t in tokens]} tokens")
    n_tok = sum(len(t) for t in tokens)
    return dict(requests=len(work), tokens=n_tok, wall_s=wall,
                tok_s=n_tok / wall, launches=launches, slot_launches=slot,
                decode_steps=eng.stats["decode_steps"],
                prefills=eng.stats["prefills"],
                profile=_profile(lambda: drive(work[:PROFILED_REQUESTS]))
                if profile else None)


def _paged(rt):
    return PagedServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN,
                            eos_id=-1, page_size=PAGE_SIZE,
                            prefill_chunk=PREFILL_CHUNK)


def _static(rt):
    return StaticServeEngine(rt, max_batch=4, max_len=SERVE_MAX_LEN,
                             eos_id=-1)


def _grow_adapters(pcfg, params, trained, device) -> dict:
    """An adapter tree for ``params`` whose leading layers are ``trained``
    (a shallower model's adapters, e.g. 18c's) and whose other layers keep
    the identity."""
    ad = peft_lib.init_peft(pcfg, params, device=device)
    for path, entry in trained.items():
        for k, v in entry.items():
            ad[path][k][:v.shape[0]] = v.to(ad[path][k].dtype)
    return ad


def moe_serve_phase(cfg, seed: int, device, trained) -> dict:
    """18d: qwen3-moe full width, MOE_SERVE_LAYERS layers, bf16: a paged
    engine over a GSOFT bank of the attention projections (3 tenants + the
    base, 8 requests on 4 slots), then a static engine on 18c's adapter
    merged (the expert stacks through ``gs_fused``, one launch a stack
    chunk)."""
    attn = peft_lib.PEFTConfig(method="gsoft", block_size=32,
                               target_patterns=ATTN_TARGETS)
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    rt = base.attach({n: perturbed_adapters(attn, base.params, seed + 1 + i,
                                            0.05, device)
                      for i, n in enumerate(names)}, attn)
    work = _work(cfg, seed, names + [None])
    setup_s = time.perf_counter() - t0
    paged = serve_lane(rt, work, _paged)
    check_slot_path("18d paged", paged["launches"], paged["slot_launches"],
                    ("gs_fused_T",))
    if not paged["launches"].get("paged_decode"):
        raise AssertionError(f"18d paged: launches {paged['launches']}")
    del rt
    ad = _grow_adapters(pcfg, base.params, trained, device)
    want = sum(ad_lib.rotation_launches(s, peft_lib.flatten_paths(
        base.params)[p]) for p, s in peft_lib.adapted_paths(
            pcfg, base.params).items())
    _reset_launches()
    t0 = time.perf_counter()
    merged = ModelRuntime(cfg, base.params, device=device, adapters=ad,
                          peft_cfg=pcfg)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_launches = gk.gs_fused.launches
    if merge_launches != want:
        raise AssertionError(f"18d merge: {merge_launches} gs_fused launches,"
                             f" the design says {want}")
    del base, ad
    gc.collect()
    torch.cuda.empty_cache()
    static = serve_lane(merged, [(p, None, n) for p, _, n in work], _static,
                        static=True)
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, setup_s=setup_s, paged=paged,
                merge_s=merge_s, merge_launches=merge_launches,
                static=static)


def prefix_loop_phase(cfg, seed: int, device) -> dict:
    """18e: ``attn_impl="prefix_loop"`` (PREFIX_CHUNK-token query chunks)
    against the dense schedule, the forward logits of PREFIX_SEQ tokens in
    f32 (TF32 off), within PREFIX_REL of max |logit|."""
    c32 = cfg.with_overrides(num_layers=DENSE_CHECK_LAYERS, dtype="f32",
                             param_dtype="f32", attn_chunk=PREFIX_CHUNK)
    params = ModelRuntime(c32, seed=seed, device=device).params
    batch = _fixed_batch(c32, PREFIX_SEQ, 1, seed, device)
    with torch.no_grad():
        dense, _ = api.forward(c32, params, batch)
        loop, _ = api.forward(c32.with_overrides(attn_impl="prefix_loop"),
                              params, batch)
    scale = max(1.0, dense.abs().max().item())
    err = (loop - dense).abs().max().item()
    del params, dense, loop
    torch.cuda.empty_cache()
    if not (math.isfinite(err) and err <= PREFIX_REL * scale):
        raise AssertionError(f"{cfg.name} prefix_loop vs dense: {err} of "
                             f"max|logit| {scale}")
    return dict(arch=cfg.name, layers=DENSE_CHECK_LAYERS, seq=PREFIX_SEQ,
                chunk=PREFIX_CHUNK, rel_err=err / scale, tol=PREFIX_REL)


def dense_serve_phase(cfg, seed: int, device) -> dict:
    """18e: a paged engine over a GSOFT bank (default targets, b = 32; 3
    tenants + the base, 8 requests on 4 slots), bf16."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    t0 = time.perf_counter()
    base = ModelRuntime(cfg, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    rt = base.attach({n: perturbed_adapters(pcfg, base.params, seed + 1 + i,
                                            0.05, device)
                      for i, n in enumerate(names)}, pcfg)
    setup_s = time.perf_counter() - t0
    out = serve_lane(rt, _work(cfg, seed, names + [None]), _paged,
                     profile=False)
    check_slot_path(f"18e {cfg.name}", out["launches"],
                    out["slot_launches"], ("gs_fused_T",))
    if not out["launches"].get("paged_decode"):
        raise AssertionError(f"18e {cfg.name}: launches {out['launches']}")
    del rt, base
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, layers=cfg.num_layers, setup_s=setup_s)


def phase_18(seed: int, device, gen) -> dict:
    """18a moe_layer card vs CPU; 18b the expert-stacked rotations; 18c
    qwen3-moe GSOFT training (fixed batch, the per-slice loop, the
    launcher) and its f32 gradients; 18d qwen3-moe serving (a paged
    attention bank, the static engine on the merged experts) and its f32
    bank-vs-merged gate; 18e gemma-7b (full, paged bank, training,
    prefix_loop), granite-34b and mistral-large-123b (2 layers: f32 gate,
    one bf16 step)."""
    qwen3, phi = get_config("qwen3-moe-30b-a3b"), get_config(
        "phi3.5-moe-42b-a6.6b")
    out = {}
    t_phase = time.perf_counter()
    a = out["moe_layer"] = moe_layer_phase(qwen3, seed, device)
    log(f"18a moe_layer qwen3-moe full width (d {a['d']}, E {a['E']}, top "
        f"{a['k']}, f_e {a['f_e']}), {a['batch']}x{a['seq']}, capacity "
        f"{a['capacity']}: card vs CPU f32 {a['rel_err']:.2e} of max|y| (tol "
        f"{MOE_REL:.0e}), aux {a['aux']:.5f} (gap {a['aux_err']:.1e}), kept /"
        f" dropped masks, experts and slots identical ({a['choices']} "
        f"choices, {a['dropped_share_f32']:.4f} dropped); bf16 "
        f"{a['bf16_ms']:.3f} ms, {a['dropped_share_bf16']:.4f} dropped")
    _PHASE_S["18a moe layer"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    out["stack_cases"] = []
    for arch, proj, E, T, d in moe_stack_cases(qwen3, phi):
        for kernel in ("gs_fused", "gs_fused_grads"):
            c = check_stack_case(arch, proj, kernel, E, T, d, 32,
                                 torch.bfloat16, gen, device)
            out["stack_cases"].append(c)
            log(f"18b {kernel:14s} {arch} {proj} E={E} T={T} d={d} r={c['r']}"
                f" {c['route']}: one launch {c['ms']:.4f} ms vs {E} "
                f"one-row launches {c['loop_ms']:.4f} ms; err vs plain "
                f"{c['max_abs_err']:.2e} vs loop {c['loop_err']:.2e} (tol "
                f"{c['tol']:.0e}); plain {c['plain_ms']:.3f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
    _PHASE_S["18b expert stacks"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    q4 = qwen3.with_overrides(num_layers=MOE_TRAIN_LAYERS)
    tr = fixed_batch_train(q4, seed, device, MOE_STEPS, MOE_LR, profile=True,
                           before_after=True)
    trained = tr.pop("trained")
    prof = tr["profile"]
    log(f"18c train qwen3-moe full width, {q4.num_layers} layers, bf16, "
        f"GSOFT b=32 ({tr['adapted_slices']} adapted slices), "
        f"{MOE_BATCH}x{MOE_SEQ}: losses "
        f"{['%.4f' % v for v in tr['losses']]}, moe_aux "
        f"{['%.4f' % v for v in tr['moe_aux']]}; {tr['tok_s']:.0f} tok/s; "
        f"peak {tr['peak_mem_gb']:.1f} GB; idle share {prof['idle_share']}; "
        f"launches a step {tr['launches_per_step']} (per-slice loop: "
        f"{tr['per_slice_launches']}, {tr['per_slice_step_s']:.2f} s a step "
        f"vs {min(tr['step_s']):.2f} s)")
    out["moe_train"] = tr
    out["moe_launcher"] = _launch_train(_train_argv(
        "qwen3-moe-30b-a3b", q4, MOE_STEPS, MOE_LR, seed))
    if len(out["moe_launcher"]["moe_aux"]) != len(
            out["moe_launcher"]["losses"]):
        raise AssertionError("the launcher's log lacks moe_aux")
    gc.collect()
    torch.cuda.empty_cache()
    g = out["moe_grad"] = grad_phase(qwen3.with_overrides(
        num_layers=GRAD_LAYERS, dtype="f32", param_dtype="f32"), seed,
        device, "gsoft", directions=SSM_FD_DIRECTIONS, per_norm=True)
    log(f"18c grad qwen3-moe ({GRAD_LAYERS} layers f32, |g| "
        f"{g['grad_norm']:.4e}): directional derivative vs central "
        f"difference " + ", ".join(
            f"{d['directional_derivative']:.6e} vs "
            f"{d['central_difference']:.6e} (rel {d['rel_err']:.1e})"
            for d in g["directions"]) + f" (tol {FD_REL:.0e})")
    _PHASE_S["18c moe training"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    q_serve = qwen3.with_overrides(num_layers=MOE_SERVE_LAYERS)
    sv = out["moe_serve"] = moe_serve_phase(q_serve, seed, device, trained)
    del trained
    log(f"18d serve qwen3-moe full width, {q_serve.num_layers} layers, bf16: "
        f"paged, attention bank (3 tenants + base), {sv['paged']['requests']}"
        f" requests on 4 slots: {sv['paged']['tok_s']:.1f} tok/s, idle "
        f"{sv['paged']['profile']['idle_share']} (first "
        f"{PROFILED_REQUESTS} requests), launches "
        f"{sv['paged']['launches']}; static on 18c's adapter merged "
        f"({sv['merge_launches']} gs_fused launches, {sv['merge_s']:.1f} s):"
        f" {sv['static']['tok_s']:.1f} tok/s, idle "
        f"{sv['static']['profile']['idle_share']}")
    attn = peft_lib.PEFTConfig(method="gsoft", block_size=32,
                               target_patterns=ATTN_TARGETS)
    mc = out["moe_check"] = merged_phase(qwen3.with_overrides(
        num_layers=CHECK_LAYERS, dtype="f32", param_dtype="f32"), seed,
        device, attn)
    log(f"18d check qwen3-moe {CHECK_LAYERS} layers f32: attention bank == "
        f"merged tokens {mc['tokens']}; decode logits max|diff| "
        f"{mc['logit_max_abs_err']:.2e} (tol {mc['logit_tol']:.1e})")
    _PHASE_S["18d moe serving"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    gemma = get_config("gemma-7b")
    ds = out["gemma_serve"] = dense_serve_phase(gemma, seed, device)
    log(f"18e serve gemma-7b full ({gemma.num_layers} layers, D "
        f"{gemma.d_head}), bf16, paged GSOFT bank: {ds['tok_s']:.1f} tok/s, "
        f"launches {ds['launches']}")
    gt = fixed_batch_train(gemma, seed, device, MOE_STEPS, MOE_LR)
    gt.pop("trained")
    out["gemma_train"] = gt
    log(f"18e train gemma-7b full, bf16, GSOFT b=32: losses "
        f"{['%.4f' % v for v in gt['losses']]}; {gt['tok_s']:.0f} tok/s; "
        f"peak {gt['peak_mem_gb']:.1f} GB; launches a step "
        f"{gt['launches_per_step']}")
    out["prefix_loop"] = prefix_loop_phase(gemma, seed, device)
    log(f"18e prefix_loop gemma-7b {DENSE_CHECK_LAYERS} layers f32, S="
        f"{PREFIX_SEQ}, chunk {PREFIX_CHUNK}: vs dense "
        f"{out['prefix_loop']['rel_err']:.2e} of max|logit| (tol "
        f"{PREFIX_REL:.0e})")
    for arch in ("granite-34b", "mistral-large-123b"):
        cfg = get_config(arch)
        c2 = cfg.with_overrides(num_layers=DENSE_CHECK_LAYERS)
        mc = merged_phase(c2.with_overrides(dtype="f32", param_dtype="f32"),
                          seed, device)
        st = fixed_batch_train(c2, seed, device, 1, MOE_LR)
        st.pop("trained")
        out[arch] = dict(check=mc, step=st)
        log(f"18e {arch} full width, {DENSE_CHECK_LAYERS} layers: f32 bank =="
            f" merged tokens {mc['tokens']} (logits {mc['logit_max_abs_err']:.2e}"
            f", tol {mc['logit_tol']:.1e}); bf16 GSOFT step loss "
            f"{st['losses'][0]:.4f}, launches {st['launches_per_step']}")
        gc.collect()
        torch.cuda.empty_cache()
    # the serving kernels at the new configs' shapes: the banked rotation
    # at a decode step (B = 4) of every rotated width, paged decode at
    # each config's heads (gemma's D = 256, granite's one kv head)
    out["kernel_cases"] = []
    for cfg in (qwen3, gemma, get_config("granite-34b"),
                get_config("mistral-large-123b")):
        widths = sorted({cfg.d_model, cfg.num_heads * cfg.d_head}
                        | ({cfg.d_ff} if not cfg.is_moe else set()))
        for d in widths:
            c = dict(check_case("gs_fused_T", 4, 1, d, 32, torch.bfloat16,
                                gen, device), arch=cfg.name)
            out["kernel_cases"].append(c)
            log(f"18e gs_fused_T {cfg.name} decode B=4 d={d} {c['route']}: "
                f"err {c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f}")
        c = dict(check_paged_case(cfg, PAGE_SIZE, "ctx144", torch.bfloat16,
                                  gen, device), arch=cfg.name)
        out["kernel_cases"].append(c)
        log(f"18e paged_decode {cfg.name} heads {cfg.num_heads}/"
            f"{cfg.num_kv_heads} D={cfg.d_head}: err {c['max_abs_err']:.2e} "
            f"(tol {c['tol']:.1e}) ms {c['ms']:.4f} plain {c['plain_ms']:.4f}"
            f" lib {c['library_ms']:.4f} bound {c['bound_ms']:.5f}")
        torch.cuda.empty_cache()
    _PHASE_S["18e dense decoders"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 19: the encoder-decoder (seamless-m4t-medium), the vlm (pixtral-12b)
# and the encoder classifier (the paper's GLUE setting)
# ---------------------------------------------------------------------------

P19_STEPS = 3
P19_LR = 1e-2                       # one fixed batch, 3 steps: the loss falls
ENCDEC_SEQ = 256                    # 19a: 2 x 256 tokens, 64 frames a row
VLM_SEQ = 512                       # 19b: 256 patches + 256 text tokens
VLM_SERVE_LAYERS = 8                # 19b: 8 of 40 layers, about 7 GB of bf16
VLM_TRAIN_LAYERS = 4
# pixtral's slots: 256 patches + a prompt of up to 128 + 16 new tokens
VLM_MAX_LEN = 512
P19_CHECK_TOKENS = 16               # the f32 checks' text tokens
# f32 card vs CPU (TF32 off): the same params and inputs, sums in another
# order (cuBLAS and the GS kernels against the CPU's BLAS and the plain
# versions), through 4 (19a) or 2 (19b) layers and a 256208 / 131072-column
# LM head: logits and loss within 1e-4 of their largest magnitude, adapter
# gradients within 1e-4 of each leaf's max |g|, as the CPU tests hold the
# port to JAX
CARD_CPU_REL = 1e-4
CARD_CPU_GRAD_REL = 1e-4
# 19c: RoBERTa-base's published widths (arXiv:1907.11692) through
# ``encoder_config``'s arguments: a RoBERTa-shaped proxy (RMSNorm, RoPE,
# GELU), f32
CLS_ARGS = dict(name="roberta-base-proxy", num_layers=12, d_model=768,
                num_heads=12, d_ff=3072, vocab_size=50265)
CLS_CLASSES = 2
CLS_BATCH, CLS_SEQ = 8, 128
CLS_CHECK_BATCH, CLS_CHECK_SEQ = 2, 32   # the card vs CPU gradients
# AdamW's first steps move each trained entry by about the rate: a head
# logit by about lr x d x |h| (the final norm gives |h| near 1), and every
# rotation of the 12-layer frozen random backbone at once. table1_glue's
# 5e-3 (d 64, 2 layers) took LoRA's loss from 0.76 to 9.8 in 3 steps at
# these widths on the card, 5e-4 OFT's from 0.72 to 2.66; at 2e-4 and 1e-4
# all four fell, at 1e-4 step by step
CLS_LR = 1e-4
CLS_METHODS = {                     # benchmarks/table1_glue.py's METHODS
    "lora": dict(method="lora", rank=8, alpha=16),
    "oft": dict(method="oft", block_size=16),
    "boft": dict(method="boft", block_size=8, boft_factors=2),
    "gsoft": dict(method="gsoft", block_size=8),
}


def p19_stack_cases(seamless, pixtral, cls_cfg) -> list:
    """(arch, projection, rows, T, d, b, dtype) of one training step's
    weight stacks at the new widths (rows: the stack's layers; T = d_out, d
    = d_in): seamless's attention (d 1024, r = b) and MLP wo (d 4096, r =
    128); pixtral's wq (d 5120, r = 160), attention wo (d 4096), MLP wo (d
    14336, r = 448) at the training depth, and patch_proj (d 1024, one
    row); the classifier's GSOFT b = 8 in f32 (route 2) at d 768 and its MLP
    wo (d 3072)."""
    S, P, C = seamless, pixtral, cls_cfg
    bf, f32 = torch.bfloat16, torch.float32
    return [
        (S.name, "attn wq", S.num_layers, S.d_model, S.d_model, 32, bf),
        (S.name, "mlp wo", S.num_layers, S.d_model, S.d_ff, 32, bf),
        (P.name, "attn wq", VLM_TRAIN_LAYERS, P.num_heads * P.d_head,
         P.d_model, 32, bf),
        (P.name, "attn wo", VLM_TRAIN_LAYERS, P.d_model,
         P.num_heads * P.d_head, 32, bf),
        (P.name, "mlp wo", VLM_TRAIN_LAYERS, P.d_model, P.d_ff, 32, bf),
        (P.name, "patch_proj wi", 1, P.d_model, P.frontend_dim, 32, bf),
        (C.name, "attn wq", C.num_layers, C.d_model, C.d_model, 8, f32),
        (C.name, "mlp wo", C.num_layers, C.d_model, C.d_ff, 8, f32)]


def p19_kernel_phase(seamless, pixtral, cls_cfg, gen, device) -> list:
    """19d: the kernels at the new shapes against their plain versions,
    timed, with bounds and library yardsticks: ``gs_fused`` and
    ``gs_fused_grads`` over each training stack (one launch over its
    rows), pixtral's banked serving rotation (``gs_fused_T`` by slot id:
    decode rows at d 5120 / 4096 / 14336, one request's 256 patches at d
    1024) and its int8 products (``gs_q_matmul`` at wq, ``q_matmul`` at the
    LM head), the classifier's OFT (b 16) and BOFT (b 8) ``bdmm`` and
    ``bdmm_dblocks`` at d 768, f32."""
    out = []
    for arch, proj, B, T, d, b, dtype in p19_stack_cases(seamless, pixtral,
                                                         cls_cfg):
        for kernel in ("gs_fused", "gs_fused_grads"):
            out.append(check_stack_case(arch, proj, kernel, B, T, d, b, dtype,
                                        gen, device, loop_too=False))
        torch.cuda.empty_cache()
    P = pixtral
    for B, T, d in ((4, 1, P.d_model), (4, 1, P.num_heads * P.d_head),
                    (4, 1, P.d_ff), (1, P.frontend_tokens, P.frontend_dim)):
        out.append(dict(check_case("gs_fused_T", B, T, d, 32, torch.bfloat16,
                                   gen, device), arch=P.name))
        torch.cuda.empty_cache()
    out.append(dict(check_gsq_case(4, 1, P.d_model, P.num_heads * P.d_head,
                                   32, torch.bfloat16, gen, device),
                    arch=P.name))
    out.append(dict(check_qmm_case(4, P.d_model, P.padded_vocab(),
                                   torch.bfloat16, gen, device), arch=P.name))
    for b in (16, 8):
        out.append(dict(check_bdmm_case(cls_cfg.num_layers, cls_cfg.d_model,
                                        cls_cfg.d_model, b, torch.float32,
                                        gen, device), arch=cls_cfg.name))
        out.append(dict(check_dblocks_case(cls_cfg.d_model, cls_cfg.d_model,
                                           b, torch.float32, gen, device),
                        arch=cls_cfg.name))
    torch.cuda.empty_cache()
    return out


def _serve_engine(max_len: int):
    return lambda rt: ServeEngine(rt, max_batch=4, max_len=max_len, eos_id=-1)


def _static_engine(max_len: int):
    return lambda rt: StaticServeEngine(rt, max_batch=4, max_len=max_len,
                                        eos_id=-1)


def _leaf_grads(loss_of, tree) -> tuple:
    """(loss, metrics, gradients): ``loss_of(leaves)`` differentiated with
    respect to every tensor of the nested dict ``tree`` (same nesting)."""
    leaves = tree_map(lambda v: v.detach().clone().requires_grad_(), tree)
    with torch.enable_grad():
        value, metrics = loss_of(leaves)
        grads = torch.autograd.grad(value, tree_leaves(leaves))
    return value.detach(), metrics, steps._rebuild(leaves, iter(grads))


def _grads_gap(got, want) -> float:
    """The largest |card - CPU| over the gradient leaves, each relative to
    that leaf's max |CPU gradient|."""
    return max((g.cpu() - w).abs().max().item()
               / max(1e-30, w.abs().max().item())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def card_cpu_phase(cfg, seed: int, device, batch: dict) -> dict:
    """f32, TF32 off: the forward logits, the loss and its adapter
    gradients (GSOFT b = 32, perturbed off the identity) on the card
    against the same params, adapters and batch on the CPU; fails past
    CARD_CPU_REL / CARD_CPU_GRAD_REL."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    params = ModelRuntime(cfg, seed=seed, device=device).params
    adapters = perturbed_adapters(pcfg, params, seed + 5, 0.05, device)
    cpu = torch.device("cpu")
    params_c, adapters_c, batch_c = (_to(t, cpu) for t in (params, adapters,
                                                          batch))
    with torch.no_grad():
        logits = api.forward(cfg, params, batch)[0].cpu()
        logits_c = api.forward(cfg, params_c, batch_c)[0]
    scale = max(1.0, logits_c.abs().max().item())
    err = (logits - logits_c).abs().max().item()
    del logits, logits_c
    grad_fn = steps.build_grad_fn(cfg, pcfg)
    _reset_launches()
    loss, _, grads = grad_fn(adapters, params, batch)
    launches = {k: v for k, v in _launches().items() if v}
    loss_c, _, grads_c = grad_fn(adapters_c, params_c, batch_c)
    gerr = _grads_gap(grads, grads_c)
    lerr = abs(float(loss) - float(loss_c)) / max(1.0, abs(float(loss_c)))
    del params, adapters, params_c, adapters_c, grads, grads_c
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(err) and err <= CARD_CPU_REL * scale
            and lerr <= CARD_CPU_REL and gerr <= CARD_CPU_GRAD_REL):
        raise AssertionError(
            f"{cfg.name} f32 card vs CPU: logits {err} of {scale}, loss "
            f"{lerr}, adapter gradients {gerr} (tol {CARD_CPU_REL} / "
            f"{CARD_CPU_GRAD_REL})")
    if not launches.get("gs_fused") or not launches.get("gs_fused_grads"):
        raise AssertionError(f"{cfg.name} f32 gradient: launches {launches}")
    return dict(layers=cfg.num_layers, enc_layers=cfg.enc_layers,
                logit_rel_err=err / scale, loss_rel_err=lerr,
                grad_rel_err=gerr, tol=CARD_CPU_REL,
                grad_tol=CARD_CPU_GRAD_REL, launches=launches)


def encdec_phase(cfg, seed: int, device) -> dict:
    """19a: seamless-m4t-medium full (12 + 12 layers, bf16): GSOFT b = 32
    on one fixed batch (2 x 256 tokens, 64 frames a row; 16 stacks: one
    ``gs_fused`` and one ``gs_fused_grads`` each a step), profiled once;
    ``launch/train.py`` 3 steps; the trained adapter merged (16
    ``gs_fused`` launches) and served through ``ServeEngine`` and
    ``StaticServeEngine`` (8 requests on 4 slots: zero frames, no port
    kernel on the merged path); ``launch/serve.py --peft-demo``; f32 at 2 +
    2 layers: card vs CPU with random frames."""
    out = {}
    tr = fixed_batch_train(cfg, seed, device, P19_STEPS, P19_LR,
                           profile=True, seq=ENCDEC_SEQ)
    trained = tr.pop("trained")
    want = {"gs_fused": 16, "gs_fused_grads": 16}
    if tr["launches_per_step"] != want:
        raise AssertionError(f"19a: a step launched "
                             f"{tr['launches_per_step']}, want {want}")
    out["train"] = tr
    argv = ["--arch", cfg.name, "--peft", "gsoft", "--block-size", "32",
            "--steps", str(P19_STEPS), "--batch", str(MOE_BATCH), "--seq",
            str(ENCDEC_SEQ), "--lr", str(P19_LR), "--warmup", "1", "--seed",
            str(seed), "--no-resume"]
    _reset_launches()
    out["launcher"] = _launch_train(argv)
    out["launcher"]["launches"] = {k: v for k, v in _launches().items() if v}
    if out["launcher"]["launches"].get("gs_fused_grads") != 16 * P19_STEPS:
        raise AssertionError(f"19a launcher: {out['launcher']['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    _reset_launches()
    t0 = time.perf_counter()
    merged = ModelRuntime(cfg, base.params, device=device, adapters=trained,
                          peft_cfg=pcfg)
    torch.cuda.synchronize()
    out["merge_s"] = time.perf_counter() - t0
    out["merge_launches"] = gk.gs_fused.launches
    if out["merge_launches"] != 16:
        raise AssertionError(f"19a merge: {out['merge_launches']} launches")
    del base, trained
    work = [(p, None, n) for p, _, n in _work(cfg, seed, [None])]
    out["serve"] = serve_lane(merged, work, _serve_engine(SERVE_MAX_LEN),
                              static=True)
    out["static"] = serve_lane(merged, work, _static_engine(SERVE_MAX_LEN),
                               static=True, profile=False)
    for lane in ("serve", "static"):
        if out[lane]["launches"]:
            raise AssertionError(f"19a {lane}: the merged model launched "
                                 f"{out[lane]['launches']}")
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    out["serve_launcher"] = launcher_lane_run(
        ["--arch", cfg.name, "--peft-demo", "--requests", "8"],
        ["[continuous] served 8 requests"])
    c32 = cfg.with_overrides(num_layers=2, enc_layers=2, dtype="f32",
                             param_dtype="f32")
    out["check"] = card_cpu_phase(c32, seed, device, _train_batch(
        c32, 2 * P19_CHECK_TOKENS, 1, seed, device))
    return out


def _vlm_launches(lane: dict, per_prefill: int, per_step: int,
                  name: str) -> dict:
    """The rotation launches a banked pixtral lane must make: every
    adapted projection of each prefill (patch_proj too) and of each decode
    step, each by slot id."""
    want = per_prefill * lane["prefills"] + per_step * lane["decode_steps"]
    got, slot = lane["launches"].get(name, 0), lane["slot_launches"][name]
    if got != want or slot != got:
        raise AssertionError(f"19b {name}: {got} launches ({slot} by slot "
                             f"id), the design says {want}")
    return dict(launches=got, design=want)


def vlm_bank_check(cfg, seed: int, device) -> dict:
    """f32: one GSOFT tenant banked (patch_proj rotated per request)
    against the model with it merged: greedy tokens through ``ServeEngine``
    equal, and one prefill with random patches gives logits within
    LOGIT_TOL of max |logit|."""
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    base = ModelRuntime(cfg, seed=seed, device=device)
    adapter = perturbed_adapters(pcfg, base.params, seed + 7, 0.05, device)
    banked = base.attach({"a": adapter}, pcfg)
    merged = ModelRuntime(cfg, base.params, device=device, adapters=adapter,
                          peft_cfg=pcfg)
    prompt = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, P19_CHECK_TOKENS).tolist()
    tokens = {}
    for name, rt, who in (("banked", banked, "a"), ("merged", merged, None)):
        eng = ServeEngine(rt, max_batch=1, max_len=VLM_MAX_LEN, eos_id=-1)
        rid = eng.add_request(prompt, max_new_tokens=8, adapter=who)
        tokens[name] = eng.run()[rid]
    if tokens["banked"] != tokens["merged"]:
        raise AssertionError(f"19b banked {tokens['banked']} != merged "
                             f"{tokens['merged']}")
    batch = _train_batch(cfg, cfg.frontend_tokens + P19_CHECK_TOKENS, 1,
                         seed, device)
    feed = {k: batch[k] for k in ("tokens", "patches")}
    last = torch.as_tensor(cfg.frontend_tokens + P19_CHECK_TOKENS - 1)
    logits = []
    _reset_launches()
    for rt, slot in ((banked, [1]), (merged, [0])):
        req = peft_lib.PrefillRequest(feed, last, rt.context(slot))
        logits.append(steps.build_prefill_step(cfg)(
            rt.params, req, rt.decode_state(1, VLM_MAX_LEN))[0].float())
    slot_launches = gk.gs_fused_T.slot_launches
    tol = LOGIT_TOL * max(1.0, logits[1].abs().max().item())
    err = (logits[0] - logits[1]).abs().max().item()
    del base, banked, merged, adapter
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"19b banked vs merged prefill logits: {err} "
                             f"(tol {tol})")
    if slot_launches != 7 * cfg.num_layers + 1:
        raise AssertionError(f"19b: the banked prefill made {slot_launches} "
                             "slot-id rotations")
    return dict(layers=cfg.num_layers, tokens=tokens["banked"],
                logit_max_abs_err=err, logit_tol=tol,
                prefill_slot_launches=slot_launches)


def vlm_phase(cfg, seed: int, device) -> dict:
    """19b: pixtral-12b at full width (d 5120, 32 / 8 heads, d_ff 14336,
    256 patches of 1024): served at VLM_SERVE_LAYERS layers (bf16) from a
    bank of 3 GSOFT tenants and the base (b = 32; the bank rotates
    patch_proj per request), 8 requests on 4 slots, then over int8 weights;
    trained at VLM_TRAIN_LAYERS layers (GSOFT b = 32, 2 x 512 positions:
    256 patches + 256 text; 7 layer stacks and patch_proj a step), profiled once; f32 at 2
    layers: banked tokens and prefill logits (random patches) equal the
    merged model's, and card vs CPU."""
    out = {}
    pcfg = peft_lib.PEFTConfig(method="gsoft", block_size=32)
    c8 = cfg.with_overrides(num_layers=VLM_SERVE_LAYERS)
    t0 = time.perf_counter()
    base = ModelRuntime(c8, seed=seed, device=device)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    rt = base.attach({n: perturbed_adapters(pcfg, base.params, seed + 1 + i,
                                            0.05, device)
                      for i, n in enumerate(names)}, pcfg)
    del base
    work = _work(c8, seed, names + [None])
    out["setup_s"] = time.perf_counter() - t0
    stacks = 7 * c8.num_layers      # wq wk wv wo, wi wg, MLP wo a layer
    lane = out["serve"] = serve_lane(rt, work, _serve_engine(VLM_MAX_LEN))
    lane["check"] = _vlm_launches(lane, stacks + 1, stacks, "gs_fused_T")
    qrt = rt.quantized("int8", release_source=True)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    lane = out["serve_int8"] = serve_lane(qrt, work,
                                          _serve_engine(VLM_MAX_LEN),
                                          profile=False)
    lane["check"] = _vlm_launches(lane, stacks + 1, stacks, "gs_q_matmul")
    heads = lane["prefills"] + lane["decode_steps"]
    if lane["launches"].get("q_matmul") != heads or \
            lane["launches"].get("gs_fused_T"):
        raise AssertionError(f"19b int8: launches {lane['launches']}")
    del qrt
    gc.collect()
    torch.cuda.empty_cache()
    c4 = cfg.with_overrides(num_layers=VLM_TRAIN_LAYERS)
    tr = fixed_batch_train(c4, seed, device, P19_STEPS, P19_LR,
                           profile=True, seq=VLM_SEQ)
    tr.pop("trained")
    want = {"gs_fused": 8, "gs_fused_grads": 8}   # 7 stacks + patch_proj
    if tr["launches_per_step"] != want:
        raise AssertionError(f"19b: a step launched "
                             f"{tr['launches_per_step']}, want {want}")
    out["train"] = tr
    gc.collect()
    torch.cuda.empty_cache()
    c2 = cfg.with_overrides(num_layers=2, dtype="f32", param_dtype="f32")
    out["banked_vs_merged"] = vlm_bank_check(c2, seed, device)
    out["check"] = card_cpu_phase(c2, seed, device, _train_batch(
        c2, c2.frontend_tokens + P19_CHECK_TOKENS, 1, seed, device))
    return out


def _cls_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    """benchmarks/table1_glue.py's task: random tokens, the label the last
    token's class."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device)
    return {"tokens": toks, "labels": toks[:, -1] % CLS_CLASSES}


def _cls_loss(cfg, pcfg, frozen, batch):
    """The classifier's loss of a trainable tree {"adapters", "head"}, the
    adapters applied to the frozen backbone (table1_glue's materialize)."""
    def loss_of(t):
        eff = peft_lib.materialize_tree(pcfg, frozen, t["adapters"])
        return encoder_model.classifier_loss(cfg, {**eff, "head": t["head"]},
                                             batch)
    return loss_of


def cls_steps(cfg, pcfg, params, trainable, batch, lr: float,
              design=None, name: str = "") -> tuple:
    """P19_STEPS AdamW steps (rate ``lr``) of the classifier's trainable
    tree on one batch, on the device its tensors lie on: (losses, seconds
    a step, the last step's metrics). With ``design`` (the card), each
    step's kernel launches must equal it."""
    ocfg = optim.OptimizerConfig(learning_rate=lr)
    opt = optim.init(ocfg, trainable)
    loss_of = _cls_loss(cfg, pcfg, params, batch)
    cuda = batch["tokens"].is_cuda
    losses, times = [], []
    for _ in range(P19_STEPS):
        _reset_launches()
        t0 = time.perf_counter()
        value, metrics, grads = _leaf_grads(loss_of, trainable)
        with torch.no_grad():
            trainable, opt, _ = optim.update(ocfg, grads, opt, trainable)
        losses.append(float(value))
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: v for k, v in _launches().items() if v}
        if design is not None and got != design:
            raise AssertionError(f"19c {name}: a step launched {got}, "
                                 f"the design says {design}")
    return losses, times, metrics


def classifier_phase(seed: int, device) -> dict:
    """19c: the encoder classifier at RoBERTa-base's widths (CLS_ARGS, f32,
    TF32 off), 2 classes, table1_glue's four adapter methods (LoRA r 8,
    OFT b 16, BOFT m 2 b 8, GSOFT b 8; the adapters and the head train, the
    backbone is frozen): the first step's gradients (on 2 x 32) card vs
    CPU, then 3 AdamW steps on one batch of 8 x 128 (the loss falls; each
    step's kernel launches as the design says)."""
    cfg = encoder_model.encoder_config(**CLS_ARGS)
    cpu = torch.device("cpu")
    params = encoder_model.init_encoder_classifier(cfg, CLS_CLASSES, seed,
                                                   device)
    params_c = _to(params, cpu)
    batch = _cls_batch(cfg, CLS_BATCH, CLS_SEQ, seed, device)
    small = _cls_batch(cfg, CLS_CHECK_BATCH, CLS_CHECK_SEQ, seed + 1, device)
    out = {"config": dict(CLS_ARGS, classes=CLS_CLASSES, batch=CLS_BATCH,
                          seq=CLS_SEQ)}
    for name, kw in CLS_METHODS.items():
        pcfg = peft_lib.PEFTConfig(**kw)
        trainable = {"adapters": perturbed_adapters(pcfg, params, seed + 3,
                                                    0.02, device),
                     "head": dict(params["head"])}
        g = _leaf_grads(_cls_loss(cfg, pcfg, params, small), trainable)[2]
        g_c = _leaf_grads(_cls_loss(cfg, pcfg, params_c, _to(small, cpu)),
                          _to(trainable, cpu))[2]
        gerr = _grads_gap(g, g_c)
        if not gerr <= CARD_CPU_GRAD_REL:
            raise AssertionError(f"19c {name}: card vs CPU gradients {gerr}")
        design = {k: v for k, v in design_launches(pcfg, params).items() if v}
        losses, times, metrics = cls_steps(cfg, pcfg, params, trainable,
                                           batch, CLS_LR, design, name)
        _SPENT["timed"] += sum(times)
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"19c {name}: losses {losses} do not fall")
        out[name] = dict(losses=losses, step_s=times, launches_per_step=design,
                         grad_rel_err=gerr, grad_tol=CARD_CPU_GRAD_REL,
                         accuracy=float(metrics["accuracy"]),
                         adapter_params=peft_lib.count_params(
                             trainable["adapters"]))
        del trainable, g, g_c
        torch.cuda.empty_cache()
    del params, params_c
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_19(seed: int, device, gen) -> dict:
    """19a seamless-m4t-medium (training, merged serving, the launchers,
    f32 card vs CPU); 19b pixtral-12b (banked and int8 banked serving,
    training, f32 banked == merged and card vs CPU); 19c the encoder
    classifier's four methods; 19d the kernels at the new shapes."""
    seamless = get_config("seamless-m4t-medium")
    pixtral = get_config("pixtral-12b")
    out = {}
    t_start, spent0 = time.perf_counter(), dict(_SPENT)
    t_phase = time.perf_counter()
    a = out["encdec"] = encdec_phase(seamless, seed, device)
    t, sv, st = a["train"], a["serve"], a["static"]
    log(f"19a seamless-m4t-medium full ({seamless.enc_layers} + "
        f"{seamless.num_layers} layers, d {seamless.d_model}), bf16, GSOFT "
        f"b=32, {MOE_BATCH}x{ENCDEC_SEQ} + frames: losses "
        f"{['%.4f' % v for v in t['losses']]}; {t['tok_s']:.0f} tok/s; peak "
        f"{t['peak_mem_gb']:.1f} GB; idle {t['profile']['idle_share']}; "
        f"launches a step {t['launches_per_step']}; launcher "
        f"{['%.4f' % v for v in a['launcher']['losses']]}; merge "
        f"{a['merge_launches']} gs_fused; merged ServeEngine "
        f"{sv['tok_s']:.1f} tok/s (idle {sv['profile']['idle_share']}), "
        f"static {st['tok_s']:.1f} tok/s; f32 2+2 layers card vs CPU logits "
        f"{a['check']['logit_rel_err']:.1e}, grads "
        f"{a['check']['grad_rel_err']:.1e}")
    _PHASE_S["19a encdec"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    b = out["vlm"] = vlm_phase(pixtral, seed, device)
    t, sv, q = b["train"], b["serve"], b["serve_int8"]
    log(f"19b pixtral-12b full width (d {pixtral.d_model}, "
        f"{pixtral.frontend_tokens} patches): serve {VLM_SERVE_LAYERS} "
        f"layers bf16, bank 3 + base: {sv['tok_s']:.1f} tok/s (idle "
        f"{sv['profile']['idle_share']}), gs_fused_T {sv['check']}; int8 "
        f"{q['tok_s']:.1f} tok/s, gs_q_matmul {q['check']}; train "
        f"{VLM_TRAIN_LAYERS} layers {MOE_BATCH}x{VLM_SEQ}: losses "
        f"{['%.4f' % v for v in t['losses']]}, {t['tok_s']:.0f} tok/s, peak "
        f"{t['peak_mem_gb']:.1f} GB, idle {t['profile']['idle_share']}, "
        f"launches {t['launches_per_step']}; f32 2 layers banked == merged "
        f"{b['banked_vs_merged']['tokens']} (prefill logits "
        f"{b['banked_vs_merged']['logit_max_abs_err']:.1e}), card vs CPU "
        f"logits {b['check']['logit_rel_err']:.1e}, grads "
        f"{b['check']['grad_rel_err']:.1e}")
    _PHASE_S["19b vlm"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    c = out["classifier"] = classifier_phase(seed, device)
    log("19c classifier (RoBERTa-base widths, f32, 8x128): " + "; ".join(
        f"{m} losses {['%.4f' % v for v in c[m]['losses']]} "
        f"{min(c[m]['step_s']):.3f} s a step, launches "
        f"{c[m]['launches_per_step']}, card vs CPU grads "
        f"{c[m]['grad_rel_err']:.1e}" for m in CLS_METHODS))
    _PHASE_S["19c classifier"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    cls_cfg = encoder_model.encoder_config(**CLS_ARGS)
    out["kernel_cases"] = p19_kernel_phase(seamless, pixtral, cls_cfg, gen,
                                           device)
    for k in out["kernel_cases"]:
        dims = " ".join(f"{f}={k[f]}" for f in ("B", "T", "d", "b", "M", "K",
                                                "N") if k.get(f) is not None)
        log(f"19d {k['kernel']} {k.get('arch', '')} {k.get('proj', '')} "
            f"{dims} {k['dtype']}: err {k['max_abs_err']:.2e} ms "
            f"{k['ms']:.4f} plain {k['plain_ms']:.4f} lib "
            f"{k['library_ms']:.4f} bound {k['bound_ms']:.5f} "
            f"({k['bound_by']})")
    _PHASE_S["19d kernel shapes"] = time.perf_counter() - t_phase
    kinds = {k: _SPENT[k] - spent0[k] for k in ("timed", "profiled")}
    kinds["total"] = time.perf_counter() - t_start
    kinds["set-up"] = kinds["total"] - kinds["timed"] - kinds["profiled"]
    out["spent"] = kinds
    log(f"19 took {kinds['total']:.1f} s: set-up {kinds['set-up']:.1f}, "
        f"timed {kinds['timed']:.1f}, profiled {kinds['profiled']:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 20: full fine-tuning on a (data x model) mesh, and the MoE family
# split over 'model' by its experts (expert parallelism), trained and
# served: gloo ranks sharing the one card, each run held to one process
# ---------------------------------------------------------------------------

# 20a: gemma-7b at full width, 1 layer, f32: about 1.06 G params (4.25 GB),
# whose step peaks at 36 GB for a whole replica (the params and moments,
# old and new, the gradients and the embedding's temporaries), so the two
# ranks of (2, 1) hold about 72 GB and the four of (2, 2) 4 x 18;
# qwen2-72b's 1-layer state does not fit twice
FT_LAYERS = 1
# 20b: qwen3-moe at full width, 2 layers f32 to train (GSOFT b = 32 on
# every projection, the expert stacks' adapters split with their experts),
# 4 layers to serve in bf16 (8 requests on 4 slots, an attention bank),
# where the partial sums round apart from the whole one's and greedy
# tokens part after a while (at smoke widths on the CPU too), so the
# differing tokens are counted; in f32 (CHECK_LAYERS) the tokens at tp = 2
# must equal tp = 1's
EP_LAYERS = 2
EP_SERVE_LAYERS = 4
NORM_REL = 1e-4                     # grad_norm: mesh vs one process, relative
# 20b's ragged mask: each row's valid tokens of MESH_SEQ; at (2, 2) data
# rank 1's rows of the first microbatch (rows 2, 3) hold none
EP_RAGGED = (64, 12, 0, 0, 48, 28, 20, 64)
LAUNCH_TIMEOUT = 300                # 20d: each launcher under torchrun, s


@contextlib.contextmanager
def counted_rows(calls: list):
    """``kernels.ops.gs_diff_rows`` (the GS rotation of a weight stack, one
    ``gs_fused`` launch forward and one ``gs_fused_grads`` backward) with
    each call's row count appended to ``calls``."""
    orig = ops.gs_diff_rows

    def rows(L, R, x):
        calls.append(int(x.shape[0]))
        return orig(L, R, x)

    ops.gs_diff_rows = rows
    try:
        yield
    finally:
        ops.gs_diff_rows = orig


def _routing_gap(got: list, want: list, first: int) -> dict:
    """A rank's own MoE routings ``got`` (each (experts, kept) of one
    ``route`` call, in call order) against the one process's ``want``
    (the same, with its router probabilities; the rank's rows): the
    choices whose expert or kept flag differ, those among the first
    ``first`` calls (the first step, where both sides start from the same
    weights), and at each token holding one, the gap between its k-th and
    (k+1)-th router probabilities (how near the tie was that flipped)."""
    if len(got) != len(want):
        return dict(calls=len(got), want_calls=len(want), differing=None,
                    first_step_differing=None, margins=[])
    differing, first_diff, margins = 0, 0, []
    for n, ((gi, gkeep), (wi, wkeep, wp)) in enumerate(zip(got, want)):
        bad = (gi != wi) | (gkeep != wkeep)
        if bool(bad.any()):
            differing += int(bad.sum())
            first_diff += int(bad.sum()) if n < first else 0
            top = wp[bad.any(-1)].topk(wi.shape[-1] + 1, dim=-1).values
            margins += (top[:, -2] - top[:, -1]).tolist()
    return dict(calls=len(got), differing=differing,
                first_step_differing=first_diff, margins=sorted(margins)[:8])


def _p20_train(cfg, seed: int, device, mesh=None, method: str = "full",
               ragged: bool = False, ref=None) -> dict:
    """MESH_STEPS AdamW steps (MESH_MICRO microbatches of the fixed
    MESH_BATCH x MESH_SEQ batch; ``ragged``: EP_RAGGED's mask) of full
    fine-tuning or of ``method`` (b = MESH_BLOCK, every projection), on
    ``mesh`` or in one process: losses, grad norms, launches, the row
    count of every GS stack rotation, the bytes gathered to rotate each
    weight, local shapes, peak memory and wall. ``ref`` (a path: the
    one-process run's first moments, each leaf's max |mu| and its MoE
    routings): the run replays those routings on its rows, then each first
    moment is held against the same block of the leaf, over the leaf's
    max, and the routings the run would have taken against the replayed
    ones. The one-process run returns those (on the host) as ``ref``
    instead."""
    from repro_torch.sharding import specs as shard_specs
    pcfg = peft_lib.PEFTConfig(method=method, block_size=MESH_BLOCK)
    ocfg = optim.OptimizerConfig(learning_rate=1e-3)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rt = ModelRuntime(cfg, seed=seed, device=device, mesh=mesh)
    rules = None if mesh is None else shard_specs.ShardingRules(cfg, mesh)
    p = rt.params
    local = {"wq": tuple(p["layers"]["attn"]["wq"].shape),
             "embed": tuple(p["embed"]["table"].shape)}
    if "moe" in p["layers"]:
        local["moe_wi"] = tuple(p["layers"]["moe"]["wi"].shape)
    if pcfg.is_peft:
        trainable = peft_lib.init_peft(pcfg, rt.param_shapes, device=device,
                                       seed=seed)
        spec = None if rules is None else rules.adapters_tree(trainable)
        if rules is not None:       # an expert stack's adapters: its experts'
            trainable = shard_specs.place(mesh, trainable, spec)
        frozen = p
    else:
        spec = None if rules is None else rules.serve_params_tree(
            rt.param_shapes)
        trainable, frozen = p, {}
    del rt, p
    opt_state = optim.init(ocfg, trainable)
    step = steps.build_train_step(cfg, steps.TrainStepConfig(
        peft=pcfg, opt=ocfg, num_microbatches=MESH_MICRO), mesh)
    batch = _fixed_batch(cfg, MESH_SEQ, MESH_BATCH, seed, device)
    if ragged:
        lens = torch.tensor(EP_RAGGED, device=device)
        batch["mask"] = (torch.arange(MESH_SEQ, device=device)[None, :]
                         < lens[:, None]).to(batch["mask"].dtype)
    # the one process records its MoE routings; a mesh run replays them on
    # its rows (one routing piece on both sides: past the first update,
    # Adam's normalisation turns rounding-level gradient gaps into weight
    # gaps of about the learning rate, which can flip near-tied choices)
    # and keeps the routings it would have taken in ``own``
    want, routes, own = None, [], []
    if ref is not None:
        want = torch.load(ref, map_location="cpu", mmap=True)
        dp_rows = (lambda t: shard_specs.local_slice(   # noqa: E731
            mesh, t, rules.batch_spec({"t": t}, t.shape[0])["t"]))
        want["routing"] = [tuple(dp_rows(t) for t in r)
                           for r in want["routing"]]
        routes = [moe_lib.Routing(i.to(device), None, slot.to(device),
                                  keep.to(device), None)
                  for i, keep, slot, _ in want["routing"]]
    losses, norms, rows = [], [], []
    with counted_rows(rows), routing_piece(routes, own):
        _reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(MESH_STEPS):
            trainable, opt_state, m = step(frozen, trainable, opt_state,
                                           batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        wall = time.perf_counter() - t0
        launches = _launches()
    if want is None:
        routes = [(r.idx.cpu(), r.keep.cpu(), r.slot.cpu(),
                   r.probs.detach().cpu()) for r in routes]
    own = [(r.idx.cpu(), r.keep.cpu()) for r in own]
    gathered = dict(step.split.gather_bytes) if mesh is not None else {}
    shard = step.split.shard if mesh is not None else None
    # the share of the kept choices that land on this rank's experts (the
    # expert load a rank carries; 1 / tp when it is even)
    mine = None
    if own and shard is not None and shard.experts_split:
        e0, n = shard.experts
        kept = [i[k] for i, k in own]
        mine = (sum(int(((i >= e0) & (i < e0 + n)).sum()) for i in kept)
                / max(1, sum(int(k.sum()) for _, k in own)))
    mu = peft_lib.flatten_paths(opt_state["mu"])
    del trainable, frozen, step, batch
    opt_state.pop("nu")
    out = dict(method=method, losses=losses, grad_norms=norms,
               launches={k: v for k, v in launches.items() if v},
               stack_rows=rows, gather_bytes=gathered, local=local,
               wall_s=wall, routings=len(routes), local_choices=mine,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card
               else None)
    if want is not None:
        if mu.keys() != want["mu"].keys():
            raise AssertionError(f"first moments: leaves {sorted(mu)} vs "
                                 f"{sorted(want['mu'])}")
        flat = peft_lib.flatten_paths(spec)
        out["mu_rel"] = {
            k: float((v.float() - shard_specs.local_slice(
                mesh, want["mu"][k], flat[k]).to(device).float()).abs().max())
            / max(want["max"][k], 1e-30) for k, v in mu.items()}
        out["routing"] = _routing_gap(
            own, [(i, keep, p) for i, keep, _, p in want["routing"]],
            len(own) // MESH_STEPS)
        del want, routes
    elif mesh is None:
        out["ref"] = dict(mu={k: v.cpu() for k, v in mu.items()},
                          max={k: float(v.abs().max()) for k, v in mu.items()},
                          routing=routes)
    del mu, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p20_serve(cfg, seed: int, device, mesh=None) -> dict:
    """20b's serving: qwen3-moe (experts split over 'model' on ``mesh``)
    through a paged engine over a GSOFT bank of the attention projections
    (3 tenants + the base, 8 requests on 4 slots): tokens, launches,
    slot-id launches, local shapes and wall."""
    attn = peft_lib.PEFTConfig(method="gsoft", block_size=32,
                               target_patterns=ATTN_TARGETS)
    rt = ModelRuntime(cfg, seed=seed, device=device, mesh=mesh)
    names = ["tenant_a", "tenant_b", "tenant_c"]
    banked = rt.attach({n: perturbed_adapters(attn, rt.param_shapes,
                                              seed + 1 + i, 0.05, device)
                        for i, n in enumerate(names)}, attn)
    work = _work(cfg, seed, names + [None])
    eng = _paged(banked)
    rids = [eng.add_request(p, max_new_tokens=n, adapter=a)
            for p, a, n in work]
    _reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    res = eng.run()
    _sync(device)
    wall = time.perf_counter() - t0
    p = rt.params["layers"]
    out = dict(tokens=[list(res[r]) for r in rids], wall_s=wall,
               launches={k: v for k, v in _launches().items() if v},
               slot_launches=_slot_launches(),
               local=dict(wq=tuple(p["attn"]["wq"].shape),
                          moe_wi=tuple(p["moe"]["wi"].shape),
                          moe_wo=tuple(p["moe"]["wo"].shape)))
    del rt, banked, eng, p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _p20_work(world: int, seed: int, cfgs, device, work: str) -> dict:
    """20a / 20b's mesh runs on one rank of ``world`` (gloo ranks sharing
    the card: a check of the split paths, never a speed). ``work`` holds
    the one-process runs' files (``ft.pt``, ``ep.pt``, ``ep_ragged.pt``)."""
    from repro_torch.launch.mesh import make_mesh
    gcfg, gsp, qcfg, qsp, scfg, scfg32 = cfgs
    kind = device.type
    ft, ep = os.path.join(work, "ft.pt"), os.path.join(work, "ep.pt")
    res = {}
    if world == 4:
        m = make_mesh(2, 2, device_type=kind)
        res["ft_2x2"] = _p20_train(gcfg, seed, device, m, ref=ft)
        res["ep_2x2"] = _p20_train(qcfg, seed, device, m, "gsoft", ref=ep)
        res["ep_2x2_ragged"] = _p20_train(
            qcfg, seed, device, m, "gsoft", ragged=True,
            ref=os.path.join(work, "ep_ragged.pt"))
        return res
    meshes = {k: make_mesh(*v, device_type=kind) for k, v in MESHES_2.items()}
    for name, cfg, mesh in (("2x1", gcfg, "2x1"), ("1x2", gcfg, "1x2"),
                            ("1x2_sp", gsp, "1x2")):
        res[f"ft_{name}"] = _p20_train(cfg, seed, device, meshes[mesh],
                                       ref=ft)
    for name, cfg in (("1x2", qcfg), ("1x2_sp", qsp)):
        res[f"ep_{name}"] = _p20_train(cfg, seed, device, meshes["1x2"],
                                       "gsoft", ref=ep)
    res["serve_tp2"] = _p20_serve(scfg, seed, device, meshes["1x2"])
    res["serve_tp2_f32"] = _p20_serve(scfg32, seed, device, meshes["1x2"])
    return res


def ep_stack_cases(qwen3) -> list:
    """(projection, rows, T, d, dtype) of a rank's expert stacks at tp =
    2: one layer's E / 2 experts in bf16 (wi on route 1; wo, r = 24 < b,
    on route 2), and the two-layer stacks 20b trains in f32."""
    E, d, f = qwen3.moe_experts // 2, qwen3.d_model, qwen3.expert_d_ff
    return [("wi", E, f, d, torch.bfloat16), ("wo", E, d, f, torch.bfloat16),
            ("wi", EP_LAYERS * E, f, d, torch.float32),
            ("wo", EP_LAYERS * E, d, f, torch.float32)]


def _torchrun(module: str, argv: list) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    module argv`` from the repo's root, in a session of its own (so every
    process it starts can be stopped together)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module] + list(argv),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def p20_launchers(seed: int) -> dict:
    """20d: ``launch/train.py --mesh 1,2 --peft full`` (gemma-7b, 1 layer,
    bf16) and ``launch/serve.py --arch qwen3-moe-30b-a3b --tp 2`` (4
    layers, bf16, paged), each as two ranks under torchrun sharing the card
    over gloo, both at once: exit 0 and their reports."""
    import signal
    runs = {
        "train": ("repro_torch.launch.train",
                  ["--arch", "gemma-7b", "--mesh", "1,2", "--peft", "full",
                   "--backend", "gloo", "--steps", "2", "--batch", "4",
                   "--seq", str(MESH_SEQ), "--microbatches", "2",
                   "--warmup", "1", "--seed", str(seed), "--no-resume",
                   "--set", f"num_layers={FT_LAYERS}"],
                  ("final loss",)),
        "serve": ("repro_torch.launch.serve",
                  ["--arch", "qwen3-moe-30b-a3b", "--tp", "2", "--backend",
                   "gloo", "--engine", "paged", "--requests", "8",
                   "--prompt-len", "64", "--max-new", "8", "--set",
                   f"num_layers={EP_SERVE_LAYERS}"],
                  ("cluster: 1 replica(s), 8 requests",
                   "[paged] served 8 requests")),
    }
    t0 = time.perf_counter()
    procs = {k: _torchrun(m, a) for k, (m, a, _) in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            text, _ = p.communicate(timeout=max(
                1.0, LAUNCH_TIMEOUT - (time.perf_counter() - t0)))
            lines = [ln for ln in text.splitlines() if "socket.cpp" not in ln]
            for ln in lines[-6:]:
                log(f"  {k} launcher: {ln}")
            if p.returncode != 0 or not all(m in text for m in runs[k][2]):
                raise AssertionError(f"torchrun {runs[k][0]} returned "
                                     f"{p.returncode}:\n" + "\n".join(
                                         lines[-150:]))
            out[k] = dict(argv=runs[k][1], rc=p.returncode, lines=lines)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    line = next(ln for ln in out["train"]["lines"] if "final loss" in ln)
    out["train"]["final_loss"] = float(line.split()[2])
    if not math.isfinite(out["train"]["final_loss"]):
        raise AssertionError(f"launch/train.py --peft full: {line}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def _p20_check(name: str, ranks: list, want: dict, kind: str) -> dict:
    """The gates of one mesh run against the one-process run: the MoE
    routings first (at the first step, where both sides start from the
    same weights, every rank's own experts and kept sets equal the same
    rows' of one process; later steps' flips are counted with their
    margins, and every step runs on the one process's routing piece: top-k
    is piecewise constant, so a flipped near-tie moves an expert's gradient
    past any tolerance), then every rank's losses (MESH_REL), grad norms
    (NORM_REL) and first moments leaf by leaf (MESH_MU_REL of the leaf's
    max)."""
    for i, r in enumerate(ranks):
        g = r[name].get("routing")
        if g is not None and g["first_step_differing"] != 0:
            raise AssertionError(f"{kind} {name} rank {i}: the first step's "
                                 f"routings differ from one process's ({g});"
                                 f" the margins are the flipped tokens' k-th "
                                 f"minus (k+1)-th router probabilities")
    gaps = [_agree(f"{kind} {name} rank {i}", r[name]["losses"],
                   want["losses"]) for i, r in enumerate(ranks)]
    norm_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r[name]["grad_norms"], want["grad_norms"]))
    if not norm_rel <= NORM_REL:
        raise AssertionError(f"{kind} {name}: grad norms "
                             f"{[r[name]['grad_norms'] for r in ranks]} vs "
                             f"{want['grad_norms']} (rel {norm_rel:.1e})")
    mu_rel = max(max(r[name]["mu_rel"].values()) for r in ranks)
    if not mu_rel <= MESH_MU_REL:
        bad = {k: v for r in ranks for k, v in r[name]["mu_rel"].items()
               if not v <= MESH_MU_REL}
        raise AssertionError(f"{kind} {name}: first moments off the "
                             f"one-process run's by more than {MESH_MU_REL} "
                             f"of a leaf's max: {bad}")
    return dict(losses=[r[name]["losses"] for r in ranks],
                grad_norms=ranks[0][name]["grad_norms"], max_gap=max(gaps),
                norm_rel=norm_rel, mu_rel=mu_rel,
                mu_leaves=len(ranks[0][name]["mu_rel"]),
                routing=[r[name].get("routing") for r in ranks],
                wall_s=[r[name]["wall_s"] for r in ranks],
                local=ranks[0][name]["local"],
                peak_gb=[r[name]["peak_gb"] for r in ranks],
                local_choices=[r[name]["local_choices"] for r in ranks],
                launches=[r[name]["launches"] for r in ranks],
                stack_rows=[r[name]["stack_rows"] for r in ranks],
                gather_bytes=[r[name]["gather_bytes"] for r in ranks])


def _ep_kernel_gates(name: str, run: dict, rows: int) -> None:
    """20b's kernel gates on one run (a rank's or the one process's): one
    stacked rotation (one ``gs_fused`` launch forward, one
    ``gs_fused_grads`` backward) per local expert stack (``rows`` = layers
    x local experts) per microbatch, a backward launch for every forward
    one, and no byte gathered to rotate an expert stack."""
    experts = sum(1 for n in run["stack_rows"] if n == rows)
    want = 3 * MESH_MICRO * MESH_STEPS          # wi, wg, wo a microbatch
    got = run["launches"]
    moe_bytes = sum(v for k, v in run["gather_bytes"].items() if "/moe/" in k)
    if not (experts == want and moe_bytes == 0
            and got.get("gs_fused", 0) >= experts
            and got.get("gs_fused") == got.get("gs_fused_grads")):
        raise AssertionError(f"{name}: {experts} expert-stack rotations "
                             f"({rows} rows; the design says {want}), launches"
                             f" {got}, {moe_bytes} expert bytes gathered")


def p20_prepare(seed: int, device, d: str) -> dict:
    """Phase 20's configs and its one-process runs: gemma-7b's full
    fine-tuning and qwen3-moe's GSOFT training (plain and ragged), their
    first moments and routings saved into ``d`` for the ranks, their kernel
    gates; qwen3-moe served at tp = 1 (bf16 and f32)."""
    t_phase = time.perf_counter()
    gemma, qwen3 = get_config("gemma-7b"), get_config("qwen3-moe-30b-a3b")
    f32 = dict(dtype="f32", param_dtype="f32", remat="none")
    gcfg = gemma.with_overrides(num_layers=FT_LAYERS, **f32)
    qcfg = qwen3.with_overrides(num_layers=EP_LAYERS, **f32)
    scfg = qwen3.with_overrides(num_layers=EP_SERVE_LAYERS)
    scfg32 = qwen3.with_overrides(num_layers=CHECK_LAYERS, dtype="f32",
                                  param_dtype="f32")
    refs = {}
    for name, cfg, method, ragged in (
            ("ft", gcfg, "full", False), ("ep", qcfg, "gsoft", False),
            ("ep_ragged", qcfg, "gsoft", True)):
        r = refs[name] = _p20_train(cfg, seed, device, method=method,
                                    ragged=ragged)
        torch.save(r.pop("ref"), os.path.join(d, f"{name}.pt"))
        gc.collect()
    for name in ("ep", "ep_ragged"):
        _ep_kernel_gates(f"20b one process {name}", refs[name],
                         EP_LAYERS * qwen3.moe_experts)
    if refs["ft"]["launches"]:
        raise AssertionError(f"20a full fine-tuning launched the port's "
                             f"kernels: {refs['ft']['launches']}")
    serve1 = {"bf16": _p20_serve(scfg, seed, device),
              "f32": _p20_serve(scfg32, seed, device)}
    gc.collect()
    torch.cuda.empty_cache()
    seconds = _PHASE_S["20 one-process runs"] = time.perf_counter() - t_phase
    log(f"20 one process (peak GB "
        f"{ {k: r['peak_gb'] for k, r in refs.items()} }): gemma-7b full FT "
        f"losses {['%.5f' % v for v in refs['ft']['losses']]} (grad norms "
        f"{['%.4e' % v for v in refs['ft']['grad_norms']]}); qwen3-moe "
        f"GSOFT {['%.5f' % v for v in refs['ep']['losses']]}, ragged "
        f"{['%.5f' % v for v in refs['ep_ragged']['losses']]} "
        f"({refs['ep']['routings']} routings a run); tp = 1 serve bf16 "
        f"{serve1['bf16']['wall_s']:.1f} s, launches "
        f"{serve1['bf16']['launches']}")
    return dict(cfgs=(gcfg, gcfg.with_overrides(seq_parallel=True), qcfg,
                      qcfg.with_overrides(seq_parallel=True), scfg, scfg32),
                refs=refs, serve1=serve1, experts=qwen3.moe_experts,
                qwen3=qwen3, seconds=seconds)


def phase_20(seed: int, device, gen, shared=None) -> dict:
    """20a full fine-tuning of gemma-7b (full width, 1 layer, f32) on (2,
    1), (1, 2) with and without seq_parallel and (2, 2), against one
    process; 20b qwen3-moe (full width, 2 layers, f32, GSOFT b = 32 on
    every projection) split over 'model' by its experts at (1, 2) with and
    without seq_parallel and (2, 2), and with a ragged mask at (2, 2),
    against one process (the routings first), then served at tp = 2 (4
    layers bf16, 2 f32, an attention bank) against tp = 1; 20c a rank's
    expert stacks through the GS kernels; 20d the launchers under
    torchrun. ``shared`` = (``p20_prepare``'s result, the two and four
    ranks' results) when phase 17's gloo ranks ran the mesh runs;
    without it this phase prepares and spawns its own."""
    out = {}
    t_start, spent0 = time.perf_counter(), dict(_SPENT)
    if shared is None:
        with tempfile.TemporaryDirectory() as d:
            prep = p20_prepare(seed, device, d)
            t_phase = time.perf_counter()
            args = (seed, (None, prep["cfgs"]), device, (None, d))
            ranks2 = _spawn_ranks(_mesh_rank, 2, args, "20")
            ranks4 = _spawn_ranks(_mesh_rank, 4, args, "20")
            _PHASE_S["20 ranks"] = time.perf_counter() - t_phase
    else:
        prep, (ranks2, ranks4) = shared
    # the mesh runs' seconds on each rank (in phase 17's processes when
    # shared: its spawns' start-up is 17c's)
    out["rank_seconds"] = [[r["seconds"]["20"] for r in ranks]
                           for ranks in (ranks2, ranks4)]
    refs, serve1, qwen3 = prep["refs"], prep["serve1"], prep["qwen3"]
    rows = EP_LAYERS * prep["experts"]
    runs = {}
    for name, ranks in (("ft_2x1", ranks2), ("ft_1x2", ranks2),
                        ("ft_1x2_sp", ranks2), ("ft_2x2", ranks4)):
        runs[name] = _p20_check(name, ranks, refs["ft"], "20a")
        if any(r[name]["launches"] for r in ranks):
            raise AssertionError(f"20a {name}: full fine-tuning launched "
                                 f"{[r[name]['launches'] for r in ranks]}")
    for name, ranks, ref in (("ep_1x2", ranks2, "ep"),
                             ("ep_1x2_sp", ranks2, "ep"),
                             ("ep_2x2", ranks4, "ep"),
                             ("ep_2x2_ragged", ranks4, "ep_ragged")):
        runs[name] = _p20_check(name, ranks, refs[ref], "20b")
        for i, r in enumerate(ranks):
            _ep_kernel_gates(f"20b {name} rank {i}", r[name],
                             rows // 2)
    for name, run in runs.items():
        log(f"{name}: losses {['%.5f' % v for v in run['losses'][0]]} (max "
            f"gap {run['max_gap']:.1e}), grad norm rel {run['norm_rel']:.1e},"
            f" first moments within {run['mu_rel']:.1e} of each leaf's max "
            f"({run['mu_leaves']} leaves, every rank); local "
            f"{run['local']}; launches rank 0 {run['launches'][0]}; "
            f"routing rank 0 {run['routing'][0]}; wall "
            f"{['%.1f' % w for w in run['wall_s']]} s; peak "
            f"{run['peak_gb']} GB a rank; kept choices on a rank's own "
            f"experts {run['local_choices']}")
    sv = {"bf16": [r["serve_tp2"] for r in ranks2],
          "f32": [r["serve_tp2_f32"] for r in ranks2]}
    for dt, lane in sv.items():
        for i, r in enumerate(lane):
            check_slot_path(f"20b serve tp = 2 {dt} rank {i}", r["launches"],
                            r["slot_launches"], ("gs_fused_T",))
            if not r["launches"].get("paged_decode"):
                raise AssertionError(f"20b serve {dt} rank {i}: "
                                     f"{r['launches']}")
            r["tokens_differing"] = sum(
                a != b for ra, rb in zip(r["tokens"], serve1[dt]["tokens"])
                for a, b in zip(ra, rb))
    for i, r in enumerate(sv["f32"]):
        if r["tokens"] != serve1["f32"]["tokens"]:
            raise AssertionError(f"20b serve tp = 2 (f32) rank {i}: tokens "
                                 f"differ from tp = 1: {r['tokens']} vs "
                                 f"{serve1['f32']['tokens']}")
    ntok = sum(len(t) for t in serve1["bf16"]["tokens"])
    log(f"20b serve qwen3-moe at tp = 2 (experts a rank "
        f"{sv['bf16'][0]['local']['moe_wi']}), paged, attention bank, 8 "
        f"requests: f32 ({CHECK_LAYERS} layers) tokens equal tp = 1 on both "
        f"ranks; bf16 ({EP_SERVE_LAYERS} layers) tokens differing "
        f"{[r['tokens_differing'] for r in sv['bf16']]} of {ntok};"
        f" launches bf16 {[r['launches'] for r in sv['bf16']]}, wall "
        f"{['%.1f' % r['wall_s'] for r in sv['bf16']]} s (gloo)")
    t_phase = time.perf_counter()
    out["stack_cases"] = []
    for proj, E, T, dd, dtype in ep_stack_cases(qwen3):
        for kernel in ("gs_fused", "gs_fused_grads"):
            c = check_stack_case(qwen3.name, proj, kernel, E, T, dd, 32,
                                 dtype, gen, device, loop_too=False)
            out["stack_cases"].append(c)
            log(f"20c {kernel:14s} {proj} rows={E} T={T} d={dd} r={c['r']} "
                f"{c['dtype']} {c['route']}: {c['ms']:.4f} ms, err vs plain "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}); plain "
                f"{c['plain_ms']:.3f} lib {c['library_ms']:.4f} bound "
                f"{c['bound_ms']:.4f} ({c['bound_by']})")
    # paged decode at a rank's heads (the bank's rotations take whole rows,
    # 18e's shapes)
    local = qwen3.with_overrides(num_heads=qwen3.num_heads // 2,
                                 num_kv_heads=qwen3.num_kv_heads // 2,
                                 head_dim=qwen3.d_head)
    c = out["paged_case"] = check_paged_case(local, PAGE_SIZE, "ctx144",
                                             torch.bfloat16, gen, device)
    log(f"20c paged_decode heads {local.num_heads}/{local.num_kv_heads} D="
        f"{local.d_head} (a rank's at tp = 2): err {c['max_abs_err']:.2e} "
        f"ms {c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
        f"{c['library_ms']:.4f} bound {c['bound_ms']:.5f} ({c['bound_by']})")
    _PHASE_S["20c expert stacks"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    out["launchers"] = p20_launchers(seed)
    _PHASE_S["20d launchers"] = time.perf_counter() - t_phase
    out.update(single=refs, runs=runs, serve_tp1=serve1, serve_tp2=sv)
    kinds = {k: _SPENT[k] - spent0[k] for k in ("timed", "profiled")}
    kinds["total"] = time.perf_counter() - t_start
    kinds["set-up"] = kinds["total"] - kinds["timed"] - kinds["profiled"]
    if shared is not None:      # the one-process runs, the ranks' share
        kinds["total"] += prep["seconds"] + sum(
            max(t) for t in out["rank_seconds"])
    out["spent"] = kinds
    log(f"20 took {kinds['total']:.1f} s (one-process runs "
        f"{prep['seconds']:.1f}, mesh runs a rank "
        f"{[round(max(t), 1) for t in out['rank_seconds']]}): timed "
        f"{kinds['timed']:.1f}, profiled {kinds['profiled']:.1f}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
            if dtype == torch.float32 and not f32_case(kernel, T, d):
                continue
            c = check_case(kernel, B, T, d, b, dtype, gen, device)
            cases.append(c)
            torch.cuda.empty_cache()
            blocks = ("" if c["library_blocks_ms"] is None else
                      f" blocks {c['library_blocks_ms']:.4f}")
            log(f"kernel {kernel:10s} B={B} T={T:5d} d={d:5d} b={b:3d} "
                f"{c['route'] or ''} {tuple(c['plan'].values())[1:]} "
                f"tt={c['tt']} cluster={c['cluster']} "
                f"{c['dtype']:8s} err {c['max_abs_err']:.2e} (tol "
                f"{c['tol']:.0e}) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"lib {c['library_ms']:.4f}{blocks} bound "
                f"{c['bound_ms']:.4f} ({c['bound_by']})")
    check_variants(cases)
    torch.cuda.empty_cache()

    # 3b. backward kernels against their plain versions
    bwd_cases_run = []
    slabs_bwd, large_bwd, wide_bwd = bwd_cases(full)
    for dtype in (torch.bfloat16, torch.float32):
        wb = 128 if dtype == torch.bfloat16 else 32
        for kernel, T, d, b in slabs_bwd + (
                large_bwd if dtype == torch.bfloat16 else []) + [
                    (k, t, d, wb) for k, t, d in wide_bwd]:
            c = check_bwd_case(kernel, T, d, b, dtype, gen, device)
            bwd_cases_run.append(c)
            log(f"kernel {kernel:14s} T={T:5d} d={d:5d} b={b:3d} "
                f"{c['route']:8s} splits={c['splits']} tokens={c['tokens']} "
                f"{c['dtype']:8s} dx err "
                f"{c['dx_abs_err']:.2e} (tol {c['tol']:.0e}) dL/dR rel err "
                f"{c['grad_rel_err']:.2e} (tol {GRAD_REL:.0e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()

    bwd_entry = bwd_entry_phase(full, gen, device)
    log(f"gs_diff with an input that needs a gradient (wi slab, bf16): "
        f"launches {({k: v for k, v in bwd_entry['launches'].items() if v})}"
        f", dx err {bwd_entry['dx_abs_err']:.2e} (tol {BF16_TOL:.0e})")
    torch.cuda.empty_cache()

    # 3c. bdmm kernels against their plain versions
    bdmm_run = bdmm_phase(full, gen, device)

    # 3d. quantized matmuls and paged decode attention against their plain
    # versions
    qcases = []
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in qmm_cases(full):
            if dtype == torch.float32 and M != 4:
                continue                    # f32: the decode rows only
            c = check_qmm_case(M, K, N, dtype, gen, device)
            qcases.append(c)
            log(f"kernel q_matmul     M={M:2d} K={K:5d} N={N:6d} tokens="
                f"{c['tokens']} ctas={c['ctas']} splits={c['k_splits']} "
                f"{c['dtype']:8s} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
        for B, T, d, N in gsq_cases(full):
            if dtype == torch.float32 and T != 1:
                continue
            c = check_gsq_case(B, T, d, N, 32, dtype, gen, device)
            qcases.append(c)
            log(f"kernel gs_q_matmul  B={B} T={T:2d} d={d:5d} N={N:5d} b=32 "
                f"slots={c['slots']} plan={c['plan']} rotation "
                f"{c['rotation_route']} {c['dtype']:8s} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms "
                f"{c['ms']:.4f} (rotation alone {c['rotation_ms']:.4f}, "
                f"q_matmul alone {c['q_matmul_ms']:.4f}) plain "
                f"{c['plain_ms']:.4f} lib {c['library_ms']:.4f} bound "
                f"{c['bound_ms']:.4f} ({c['bound_by']})")
            torch.cuda.empty_cache()
        for page, lens_name in PAGED_CASES:
            c = check_paged_case(full, page, lens_name, dtype, gen, device)
            qcases.append(c)
            torch.cuda.empty_cache()
            log(f"kernel paged_decode page={page:2d} W={c['W']} "
                f"splits={c['splits']} ctas={c['ctas']} "
                f"kv_len={c['kv_len']} {c['dtype']:8s} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.5f} "
                f"({c['bound_by']})")

    # 3e. the SSD scan against its plain version
    zamba = get_config("zamba2-2.7b")
    mamba = get_config("mamba2-130m")
    ssd_run = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in ssd_cases():
            c = check_ssd_case(*case, dtype, gen, device)
            ssd_run.append(c)
            log(f"kernel ssd Nb={c['Nb']} T={c['T']:4d} H={c['H']:2d} "
                f"P={c['P']} N={c['N']:3d} tile={c['p_tile']} "
                f"{c['dtype']:8s} err {c['max_abs_err']:.2e} (tol "
                f"{c['tol']:.1e}) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"lib none bound {c['bound_ms']:.5f} ({c['bound_by']})")
        torch.cuda.empty_cache()

    # 3f. flash attention against its plain version, through ops.flash_mha
    flash_run = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in flash_cases(full, zamba):
            c = check_flash_case(*case, dtype, gen, device)
            flash_run.append(c)
            log(f"kernel flash_attention {c['heads']:11s} H={c['H']}/"
                f"{c['KH']} D={c['D']:3d} S={c['Sq']:4d} causal="
                f"{int(c['causal'])} route={c['route']} splits="
                f"{c['splits']} {c['dtype']:8s} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.0e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib (SDPA) "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
    refusal = flash_refusal(device)
    log(f"flash_attention: non-causal Sk = 200 raises ValueError: {refusal}")
    flash_entry = flash_entry_phase(full, zamba, gen, device)
    log(f"flash_attention entry point ops.flash_mha: launches "
        f"{ {k: v for k, v in flash_entry['launches'].items() if v} }")

    # 3g. the GS-class library (block products through bdmm) and Algorithm 1
    t_phase = time.perf_counter()
    gs_lib_run = []
    for dtype in (torch.float32, torch.bfloat16):
        for fn_name, layout_name in gs_lib_cases():
            c = check_gs_lib_case(fn_name, layout_name, dtype, gen, device)
            gs_lib_run.append(c)
            log(f"gs library {fn_name:16s} {layout_name:6s} d={c['d_in']}->"
                f"{c['d_out']} tokens={c['tokens']} blocks={c['blocks']} "
                f"{c['dtype']:8s} bdmm launches {c['bdmm_launches']} err "
                f"{c['max_abs_err']:.2e} (tol {c['tol']:.1e}) ms "
                f"{c['ms']:.4f} plain {c['plain_ms']:.4f} lib (dense) "
                f"{c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})")
        torch.cuda.empty_cache()
    # the launches of the gated call of each case (not the timing loops')
    gs_lib_launches = dict({name: 0 for name in KERNELS},
                           bdmm=sum(c["bdmm_launches"] for c in gs_lib_run))
    proj = projection_phase(args.seed, gen, device)
    log(f"project_to_gs d={proj['d']} b={proj['b']} f32 on the card: "
        f"recovery error {proj['recovery_err']:.3e} of ||A||_F "
        f"{proj['a_norm']:.1f} ({proj['recovery_rel']:.2e}, tol "
        f"{PROJ_REL:.0e}), {proj['ms']:.2f} ms; dense orthogonal d="
        f"{proj['dense_d']}: error card {proj['dense_err_card']:.6f} vs CPU "
        f"f64 {proj['dense_err_cpu_f64']:.6f} (rel gap "
        f"{proj['dense_rel_gap']:.1e}, tol {PROJ_MATCH:.0e})")
    torch.cuda.empty_cache()
    _PHASE_S["3g gs library"] = time.perf_counter() - t_phase

    # 3h. the image lane's kernels at its shapes
    t_phase = time.perf_counter()
    lip = get_config("lipconvnet-15")
    image_run = image_kernel_phase(lip, gen, device)
    _PHASE_S["3h image kernels"] = time.perf_counter() - t_phase

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
        f"port kernels {prof['port_kernels_device_s']:.4f} s; "
        f"{_moved(prof)}; slot-id launches {serve['slot_launches']}")
    torch.cuda.empty_cache()

    # 4b. the serve launcher's paged int8 path, bf16, full width, depth cut
    log(f"paged int8 serve: qwen2-72b full width, {SERVE_LAYERS} layers, bf16 "
        f"-> int8 base weights, 3 GSOFT tenants (b=32) + base, page "
        f"{PAGE_SIZE}, chunk {PREFILL_CHUNK}")
    qserve = paged_quant_serve_phase(cfg8, args.seed, device)
    qprof = qserve["profile"]
    log(f"paged int8 serve: {qserve['requests']} requests, {qserve['tokens']} "
        f"tokens; wall {['%.3f' % w for w in qserve['wall_s']]} s, median "
        f"{qserve['tok_s']:.1f} tok/s (bf16 contiguous above: "
        f"{serve['tok_s']:.1f}); {qserve['decode_steps']} decode steps, "
        f"{qserve['prefills']} prefills; launches "
        f"{ {k: v for k, v in qserve['launches'].items() if v} }")
    log(f"paged int8 serve: params {qserve['params_bytes_bf16'] / 1e9:.3f} GB "
        f"bf16 -> {qserve['params_bytes_int8'] / 1e9:.3f} GB int8 (quantize "
        f"{qserve['quantize_s']:.1f} s, peak {qserve['quantize_peak_gb']:.1f} "
        f"GB); serving peak {qserve['serve_peak_gb']:.1f} GB; KV pages in use "
        f"at most {qserve['kv_pages_peak']} ({qserve['kv_bytes_peak'] / 1e6:.1f}"
        f" MB) of a {qserve['kv_pool_bytes'] / 1e6:.1f} MB pool against "
        f"{qserve['contiguous_kv_bytes'] / 1e6:.1f} MB contiguous; kv_stats "
        f"{qserve['kv_stats']}")
    log(f"paged int8 serve profile: wall {qprof['wall_s']:.3f} s, device busy "
        f"{qprof['device_busy_s']:.3f} s (idle share {qprof['idle_share']}), "
        f"port kernels {qprof['port_kernels_device_s']:.4f} s "
        f"{ {k: round(v, 2) for k, v in qprof['port_device_ms_by_kernel'].items()} } ms"
        f"; {_moved(qprof)}; slot-id launches {qserve['slot_launches']}")
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

    # 5b. paged and int8 against contiguous and merged, f32
    log(f"paged int8 check: {CHECK_LAYERS} layers, f32, TF32 off")
    qcheck = paged_quant_check_phase(cfg2, args.seed, device)
    log(f"paged int8 check: paged == contiguous tokens (f32 and int8) "
        f"{qcheck['tokens']['int8']['paged']}; base slot == bankless int8; "
        f"banked int8 vs merge-then-quantize decode logits max|diff| "
        f"{qcheck['quant_vs_merged_max_abs']:.3e} "
        f"({qcheck['quant_vs_merged_rel']:.2e} of max|logit|, tol "
        f"{QUANT_LOGIT_REL}); launches "
        f"{ {k: v for k, v in qcheck['launches'].items() if v} }")
    torch.cuda.empty_cache()

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
        f"port kernels {tprof['port_kernels_device_s']:.4f} s "
        f"{ {k: round(v, 2) for k, v in tprof['port_device_ms_by_kernel'].items()} } ms"
        f"; gs_fused share of busy {tprof['gs_fwd_share_of_busy']:.3f}; "
        f"W^T / dy token copies {tprof['copies_device_ms']:.2f} ms "
        f"({tprof['copies']} copies)")
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

    # 9. OFT / BOFT fine-tuning, bf16, full width, depth cut; one step each
    # of the methods that run no kernel of the port
    trains_bdmm = {}
    for method in ("oft", "boft"):
        log(f"train {method}: qwen2-72b full width, {TRAIN_LAYERS} layers, "
            f"bf16, remat full, b={BDMM_BLOCK}, batch {TRAIN_BATCH} x seq "
            f"{TRAIN_SEQ}, AdamW lr {TRAIN_LR}")
        t = train_phase(cfg4, args.seed, device, method=method)
        trains_bdmm[method] = t
        tp = t["profile"]
        log(f"train {method}: losses {['%.5f' % v for v in t['losses']]}; "
            f"step {['%.3f' % v for v in t['step_s']]} s, median "
            f"{t['step_median_s']:.3f} s, {t['tokens_per_s']:.1f} tok/s; "
            f"peak {t['peak_mem_gb']:.1f} GB; launches per step "
            f"{ {k: v for k, v in t['launches_per_step'].items() if v} } "
            f"(design {t['design_per_step']})")
        log(f"train {method} profile: wall {tp['wall_s']:.3f} s, device busy "
            f"{tp['device_busy_s']:.3f} s (idle share {tp['idle_share']}), "
            f"port kernels {tp['port_kernels_device_s']:.4f} s "
            f"{ {k: round(v, 2) for k, v in tp['port_device_ms_by_kernel'].items()} } ms")
        torch.cuda.empty_cache()
    cfg_q = full.with_overrides(num_layers=QUICK_LAYERS, remat="full")
    quick = []
    for method in ("householder", "givens", "lora"):
        q = quick_step_phase(cfg_q, args.seed, device, method)
        quick.append(q)
        log(f"train {method}: {QUICK_LAYERS} layers bf16, one step: loss "
            f"{q['loss']:.5f}, grad norm {q['grad_norm']:.3e}, "
            f"{q['step_s']:.3f} s, peak {q['peak_mem_gb']:.1f} GB; port "
            f"kernel launches {sum(q['launches'].values())}")

    # 10. OFT / BOFT gradients against a central difference, f32
    for method in ("oft", "boft"):
        g = grad_phase(cfg_g, args.seed, device, method)
        grads.append(g)
        log(f"grads {method}: directional derivative "
            f"{g['directional_derivative']:.6e}, central difference "
            f"{g['central_difference']:.6e} (h {g['h']:.2e}), rel err "
            f"{g['rel_err']:.2e} (tol {FD_REL:.0e}); launches "
            f"{ {k: v for k, v in g['launches'].items() if v} }")
        torch.cuda.empty_cache()

    # 11. mixed-method serving, bf16, full width, depth cut; then f32 checks
    cfg_mixed = full.with_overrides(num_layers=MIXED_SERVE_LAYERS)
    log(f"mixed serve: qwen2-72b full width, {MIXED_SERVE_LAYERS} layers, bf16, "
        f"tenants {list(mixed_cfgs())}")
    torch.cuda.reset_peak_memory_stats()
    mserve = mixed_serve_phase(cfg_mixed, args.seed, device)
    mprof = mserve["profile"]
    log(f"mixed serve: {mserve['requests']} requests, {mserve['tokens']} "
        f"tokens; wall {['%.3f' % w for w in mserve['wall_s']]} s, median "
        f"{mserve['tok_s']:.1f} tok/s; {mserve['decode_steps']} decode "
        f"steps; launches { {k: v for k, v in mserve['launches'].items() if v} }"
        f" (bdmm by route {mserve['bdmm_launches_by_route']})")
    log(f"mixed serve profile: wall {mprof['wall_s']:.3f} s, device busy "
        f"{mprof['device_busy_s']:.3f} s (idle share {mprof['idle_share']}), "
        f"port kernels {mprof['port_kernels_device_s']:.4f} s; "
        f"{_moved(mprof)}; slot-id launches {mserve['slot_launches']}")
    torch.cuda.empty_cache()
    log(f"mixed check: {CHECK_LAYERS} layers, f32, TF32 off")
    mcheck = mixed_check_phase(cfg2, args.seed, device)
    log(f"mixed check: every tenant == its solo merged run, base slot == "
        f"bankless; decode logits max|diff| "
        f"{ {k: '%.2e' % v for k, v in mcheck['logit_max_abs_err'].items()} }"
        f"; prefill logits moved from the base slot's by "
        f"{ {k: '%.2e' % v for k, v in mcheck['prefill_logit_gap_to_base'].items()} }"
        f"; {mcheck['distinct_tenant_tokens']} distinct token lists of 6")
    torch.cuda.empty_cache()

    # 12. checkpoints: a resumed training run, bf16, full width, 4 layers
    t_phase = time.perf_counter()
    log(f"checkpoints: qwen2-72b full width, {TRAIN_LAYERS} layers, bf16, "
        f"GSOFT b={BDMM_BLOCK}: train() 2 steps with async saves, resumed to "
        f"{RESUME_STEPS}, against {RESUME_STEPS} uninterrupted")
    resume = ckpt_resume_phase(cfg4, args.seed, device)
    log(f"checkpoints: restored state bit-equal to step 2's; losses resumed "
        f"{['%.6f' % v for v in resume['losses_resumed']]} vs uninterrupted "
        f"{['%.6f' % v for v in resume['losses_uninterrupted'][2:]]} (rel "
        f"gaps {['%.1e' % v for v in resume['loss_rel_gap'].values()]}, tol "
        f"{RESUME_LOSS_REL:.0e}); final adapters max|diff| "
        f"{resume['adapter_max_abs_diff']:.3e}; checkpoint "
        f"{resume['checkpoint_bytes'] / 1e6:.1f} MB; launcher final losses "
        f"{[round(x['final_loss'], 5) for x in resume['launcher']]}, resumed "
        f"{[x['resumed'] for x in resume['launcher']]}")
    torch.cuda.empty_cache()
    _PHASE_S["12 checkpoints + resume"] = time.perf_counter() - t_phase

    # 12b. adapters and int8 weights through checkpoints, f32
    t_phase = time.perf_counter()
    log(f"adapter / int8 checkpoints: qwen2-72b full width, {CHECK_LAYERS} "
        f"layers, f32, TF32 off")
    ackpt = adapters_quant_ckpt_phase(cfg2, args.seed, device)
    log(f"adapter / int8 checkpoints: attach(<dir>) == attach(adapters) "
        f"tokens for {ackpt['tenants']}; int8 checkpoint "
        f"{ackpt['int8_checkpoint_bytes'] / 1e9:.2f} GB (save "
        f"{ackpt['int8_save_s']:.1f} s, load {ackpt['int8_load_s']:.1f} s), "
        f"{ackpt['quant_leaves']} int8 leaves bit-equal, paged int8 tokens "
        f"equal; launches { {k: v for k, v in ackpt['launches'].items() if v} }")
    torch.cuda.empty_cache()
    _PHASE_S["12b adapter / int8 checkpoints"] = time.perf_counter() - t_phase

    # 12c. the store-paged serve lane, bf16, full width, depth cut
    t_phase = time.perf_counter()
    cfg_store = full.with_overrides(num_layers=STORE_LAYERS)
    log(f"store serve: qwen2-72b full width, {STORE_LAYERS} layers, bf16, "
        f"{STORE_TENANTS} tenants {STORE_METHODS} (b={BDMM_BLOCK}) on disk, "
        f"hbm_budget {STORE_BUDGET}")
    sserve = store_serve_phase(cfg_store, args.seed, device)
    sprof, sst = sserve["profile"], sserve["bank_stats"]
    log(f"store serve: {sserve['requests']} requests ({sserve['cold']} cold, "
        f"{sserve['revisits']} revisits of {STORE_HOT}), {sserve['tokens']} "
        f"tokens; wall {['%.3f' % w for w in sserve['wall_s']]} s, median "
        f"{sserve['tok_s']:.1f} tok/s; caps {sserve['caps']}; page-in p50 "
        f"{sst['page_in_ms_p50']:.1f} ms p95 {sst['page_in_ms_p95']:.1f} ms; "
        f"hit rate {sst['hit_rate']:.3f}; evictions {sst['evictions']}, "
        f"stalls {sst['admission_stalls']}; resident "
        f"{sst['resident_bank_bytes'] / 1e9:.3f} GB vs padded "
        f"{sst['padded_bank_bytes'] / 1e9:.3f} GB; peak "
        f"{sserve['peak_mem_gb']:.1f} GB; launches "
        f"{ {k: v for k, v in sserve['launches'].items() if v} }; slot-id "
        f"launches {sserve['slot_launches']}, largest id "
        f"{sserve['gs_fused_T_bank_max_id']}")
    log(f"store serve profile ({sprof['requests']} cold requests): wall "
        f"{sprof['wall_s']:.3f} s, device busy "
        f"{sprof['device_busy_s']:.3f} s (idle share {sprof['idle_share']}), "
        f"port kernels {sprof['port_kernels_device_s']:.4f} s; "
        f"{_moved(sprof)}")
    log(f"store serve launcher: {sserve['launcher']['report']}")
    torch.cuda.empty_cache()
    log(f"store check: {CHECK_LAYERS} layers, f32, TF32 off, "
        f"{STORE_CHECK_TENANTS} tenants, budget 3")
    scheck_store = store_check_phase(cfg2, args.seed, device)
    log(f"store check: every request == its tenant's solo merged run "
        f"({scheck_store['distinct_tokens']} distinct token lists; bank "
        f"evictions {scheck_store['bank_stats']['evictions']}, page-cache "
        f"hits {scheck_store['bank_stats']['build_cache_hits']}); store-paged "
        f"== padded bank, f32 and int8")
    torch.cuda.empty_cache()
    _PHASE_S["12c store lane + check"] = time.perf_counter() - t_phase

    # 13. hybrid serve: zamba2-2.7b at full width and depth, bf16
    log(f"hybrid serve: zamba2-2.7b full width, {zamba.num_layers} layers "
        f"(no cut), bf16, seed {args.seed}, {HYBRID_REQUESTS} requests on 4 "
        f"slots")
    hserve = hybrid_serve_phase(zamba, args.seed, device)
    hprof = hserve["profile"]
    log(f"hybrid serve: {hserve['requests']} requests, {hserve['tokens']} "
        f"tokens; wall {['%.3f' % w for w in hserve['wall_s']]} s, median "
        f"{hserve['tok_s']:.1f} tok/s; {hserve['decode_steps']} decode "
        f"steps, {hserve['prefills']} prefills; launches "
        f"{ {k: v for k, v in hserve['launches'].items() if v} }; params "
        f"{hserve['params_bytes'] / 1e9:.3f} GB; peak "
        f"{hserve['peak_mem_gb']:.2f} GB; setup {hserve['setup_s']:.1f} s")
    log(f"hybrid serve profile: wall {hprof['wall_s']:.3f} s, device busy "
        f"{hprof['device_busy_s']:.3f} s (idle share {hprof['idle_share']}), "
        f"port kernels {hprof['port_kernels_device_s']:.4f} s; top "
        f"{[(k['name'][:40], round(k['device_ms'], 1), k['count']) for k in hprof['top'][:6]]}")
    torch.cuda.empty_cache()
    hlaunch = hybrid_launcher_run("zamba2-2.7b")
    log(f"hybrid serve launcher: {hlaunch['report'][0]}")
    torch.cuda.empty_cache()

    # 13b. SSM checks, f32, TF32 off
    ssm_cfg = mamba.with_overrides(dtype="f32", param_dtype="f32")
    hyb_cfg = zamba.with_overrides(num_layers=HYBRID_CHECK_LAYERS,
                                   dtype="f32", param_dtype="f32")
    log(f"ssm check: mamba2-130m full config f32 T={SSM_CHECK_T}; "
        f"zamba2-2.7b full width {HYBRID_CHECK_LAYERS} layers f32 "
        f"T={HYBRID_CHECK_T}; TF32 off")
    scheck = ssm_check_phase(ssm_cfg, hyb_cfg, args.seed, device)
    for name, r in scheck.items():
        extra = (f"card vs CPU forward {r['cpu_rel']:.2e} of max|logit|; "
                 if "cpu_rel" in r else "")
        log(f"ssm check {name}: {extra}decode vs forward (duality) "
            f"{r['duality_rel']:.2e} of max|logit| {r['max_logit']:.2f} "
            f"(tol {SSM_LOGIT_REL:.0e}); first served token {r['first_token']}"
            f" == forward argmax; decode {r['decode_s']:.1f} s")

    # 14. static, streaming and traced serving, bf16, full width, depth cut
    t_phase = time.perf_counter()
    p14 = phase_14(full, args.seed, device)
    traced = p14["static_traced"]
    _PHASE_S["14 static / streaming / traced"] = time.perf_counter() - t_phase

    # 15. image serving: lipconvnet-15 full, bf16, then f32 checks
    t_phase = time.perf_counter()
    p15 = phase_15(lip, args.seed, device)
    image = p15["image_serve"]
    _PHASE_S["15 image"] = time.perf_counter() - t_phase

    # 16. scale-out: the cluster, the launcher's lanes, tp = 1 and tp = 2
    p16 = phase_16(full, args.seed, device, gen)

    # 17. training: the Mamba2 families on the card (ssd_bwd), and on a
    # (data x model) mesh as gloo ranks sharing the card; phase 20's mesh
    # runs share those ranks (its one-process runs go first, their first
    # moments in a temporary directory the ranks read)
    with tempfile.TemporaryDirectory() as d20:
        prep20 = p20_prepare(args.seed, device, d20)
        p17 = phase_17(full, mamba, zamba, args.seed, device, gen,
                       p20=(prep20["cfgs"], d20))

    # 18. the MoE family (qwen3-moe, phi-3.5-MoE's expert stacks) and the
    # other dense decoders (gemma-7b, granite-34b, mistral-large-123b)
    p18 = phase_18(args.seed, device, gen)

    # 19. the encoder-decoder (seamless-m4t-medium), the vlm (pixtral-12b)
    # and the encoder classifier
    p19 = phase_19(args.seed, device, gen)

    # 20. full fine-tuning on a mesh (gemma-7b) and expert parallelism
    # (qwen3-moe trained and served split over 'model'), gloo ranks
    p20 = phase_20(args.seed, device, gen,
                   shared=(prep20, p17.pop("p20_ranks")))

    # 21. report
    by_path = {"serve": serve["launches"],
               "merge": {"gs_fused": merged["merge_launches"]},
               "train": train["launches"],
               "gs_diff_input_grad": bwd_entry["launches"],
               "grads_double_gsoft": grads[1]["launches"],
               "train_oft": trains_bdmm["oft"]["launches"],
               "train_boft": trains_bdmm["boft"]["launches"],
               "serve_mixed": mserve["launches"],
               "serve_paged_int8": qserve["launches"],
               "check_paged_int8": qcheck["launches"],
               "gs_library": gs_lib_launches,
               "train_resumed": resume["launches_resumed"],
               "serve_store": sserve["launches"],
               "ckpt_paged_int8": ackpt["launches"],
               "serve_static_merge": traced["static"]["merge_launches"],
               "serve_traced": traced["traced"]["launches"],
               "serve_paged_int8_traced": traced["paged_int8"]["launches"],
               "serve_image": image["bf16"]["launches"],
               "serve_image_int8": image["int8"]["launches"],
               "serve_image_int8_bankless":
                   image["int8_bankless"]["launches"],
               "train_moe": {k: v * MOE_STEPS for k, v in
                             p18["moe_train"]["launches_per_step"].items()},
               "serve_moe_paged": p18["moe_serve"]["paged"]["launches"],
               "serve_moe_static_merge":
                   {"gs_fused": p18["moe_serve"]["merge_launches"]},
               "serve_moe_static": p18["moe_serve"]["static"]["launches"],
               "serve_gemma_paged": p18["gemma_serve"]["launches"],
               "train_gemma": {k: v * MOE_STEPS for k, v in
                               p18["gemma_train"]["launches_per_step"].items()},
               "train_seamless": {k: v * P19_STEPS for k, v in
                                  p19["encdec"]["train"][
                                      "launches_per_step"].items()},
               "train_seamless_launcher": p19["encdec"]["launcher"][
                   "launches"],
               "merge_seamless": {"gs_fused": p19["encdec"][
                   "merge_launches"]},
               "serve_pixtral_bank": p19["vlm"]["serve"]["launches"],
               "serve_pixtral_int8": p19["vlm"]["serve_int8"]["launches"],
               "train_pixtral": {k: v * P19_STEPS for k, v in
                                 p19["vlm"]["train"][
                                     "launches_per_step"].items()},
               **{f"train_classifier_{m}": {
                   k: v * P19_STEPS for k, v in
                   p19["classifier"][m]["launches_per_step"].items()}
                  for m in CLS_METHODS},
               # 20: rank 0 of each expert-parallel run and of tp = 2
               # serving (every rank's counts: mesh_train_launches)
               **{f"train_{n}_rank0": r["launches"][0]
                  for n, r in p20["runs"].items() if n.startswith("ep_")},
               **{f"serve_moe_tp2_{dt}_rank0": lane[0]["launches"]
                  for dt, lane in p20["serve_tp2"].items()}}
    main_case = {"gs_fused_T": ("gs_fused_T", 4, 1, full.d_model, 32,
                                "bfloat16"),
                 "gs_fused": ("gs_fused", 1, full.d_ff, full.d_model, 32,
                              "bfloat16"),
                 "gs_fused_bwd": ("gs_fused_bwd", 1, full.d_ff, full.d_model,
                                  32, "bfloat16"),
                 "gs_fused_grads": ("gs_fused_grads", 1, full.d_ff,
                                    full.d_model, 32, "bfloat16"),
                 "bdmm": ("bdmm", 1, full.d_ff, full.d_model, 32, "bfloat16"),
                 "bdmm_dblocks": ("bdmm_dblocks", 1, full.d_ff, full.d_model,
                                  32, "bfloat16")}
    # launches on the training path: GSOFT training (phase 7) for the
    # forward rotation and the grads-only backward; Double GSOFT's gradient
    # step (phase 8) for the transpose rotation; gs_diff with an input that
    # needs a gradient (phase 3b) for the fused backward with dx; OFT and
    # BOFT training (phase 9) for the bdmm kernels
    launches = {"gs_fused_T": grads[1]["launches"]["gs_fused_T"],
                "gs_fused": train["launches"]["gs_fused"],
                "gs_fused_bwd": bwd_entry["launches"]["gs_fused_bwd"],
                "gs_fused_grads": train["launches"]["gs_fused_grads"],
                "bdmm": sum(t["launches"]["bdmm"] for t in trains_bdmm.values()),
                "bdmm_dblocks": sum(t["launches"]["bdmm_dblocks"]
                                    for t in trains_bdmm.values())}
    all_cases = cases + bwd_cases_run + bdmm_run
    kernels = []
    # the GSOFT rotation launches of the serve phases that read the bank by
    # slot id (all of them: phases 4, 4b and 11 check it)
    slot_by_path = {"serve": serve["slot_launches"],
                    "serve_mixed": mserve["slot_launches"],
                    "serve_paged_int8": qserve["slot_launches"],
                    "serve_store": sserve["slot_launches"],
                    "serve_traced": traced["traced"]["slot_launches"],
                    "serve_paged_int8_traced":
                        traced["paged_int8"]["slot_launches"],
                    "serve_image": image["bf16"]["slot_launches"],
                    "serve_image_int8": image["int8"]["slot_launches"]}
    for name, key in main_case.items():
        c = next(c for c in all_cases
                 if (c["kernel"], c["B"], c["T"], c["d"], c["b"],
                     c["dtype"]) == key)
        mine = [x for x in all_cases if x["kernel"] == name]
        extra = {f"max_abs_err_{dt}": max(x["max_abs_err"] for x in mine
                                          if x["dtype"] == dt)
                 for dt in ("bfloat16", "float32")}
        if name in ("gs_fused_bwd", "gs_fused_grads", "bdmm_dblocks"):
            extra.update({f"max_grad_rel_err_{dt}": max(
                x["grad_rel_err"] for x in mine if x["dtype"] == dt)
                for dt in ("bfloat16", "float32")})
        if "library_what" in c:
            extra["library_what"] = c["library_what"]
        if name in ("gs_fused", "gs_fused_T"):
            extra.update(gs_route=c["route"],
                         library_blocks_ms=c["library_blocks_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            launches_by_path={p: v[name] for p, v in by_path.items()
                              if name in v},
            **({"slot_launches_by_path": {p: v[name] for p, v in
                                          slot_by_path.items() if v[name]}}
               if name == "gs_fused_T" else {}),
            max_abs_err=c["max_abs_err"], **extra,
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            shape=dict(B=c["B"], T=c["T"], d=c["d"], b=c["b"],
                       dtype=c["dtype"])))
    # the int8 paged path's kernels: launches from its main-path run (4b)
    q_main = {"q_matmul": dict(M=4, K=full.d_model, N=full.padded_vocab(),
                               dtype="bfloat16"),
              "gs_q_matmul": dict(B=4, T=1, d=full.d_model, N=full.d_model,
                                  dtype="bfloat16"),
              "paged_decode": dict(page=PAGE_SIZE, lens="ctx144",
                                   dtype="bfloat16")}
    for name, key in q_main.items():
        mine = [x for x in qcases if x["kernel"] == name]
        c = next(x for x in mine if all(x[k] == v for k, v in key.items()))
        extra = {f"max_abs_err_{dt}": max(x["max_abs_err"] for x in mine
                                          if x["dtype"] == dt)
                 for dt in ("bfloat16", "float32")}
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"],
            launches=qserve["launches"][name],
            launches_by_path={p: v[name] for p, v in by_path.items()
                              if name in v},
            **({"slot_launches_by_path": {p: v[name] for p, v in
                                          slot_by_path.items() if v[name]}}
               if name == "gs_q_matmul" else {}),
            max_abs_err=c["max_abs_err"], **extra, ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            library_what=c["library_what"], shape=key))
    # the SSD scan: launches from the hybrid serve's main-path run (13), the
    # case one zamba2 prefill gives it; flash attention: its entry point's
    ssd_main = dict(Nb=1, T=max(prefill_buckets()), H=zamba.ssm_heads,
                    dtype="float32")        # the model feeds the scan fp32
    flash_main = dict(heads="zamba2-2.7b", Sq=512, causal=True,
                      dtype="bfloat16")
    for name, key, runs, n in (
            ("ssd", ssd_main, ssd_run, hserve["launches"]["ssd"]),
            ("flash_attention", flash_main, flash_run,
             flash_entry["launches"]["flash_attention"])):
        c = next(x for x in runs if all(x[k] == v for k, v in key.items()))
        extra = {f"max_abs_err_{dt}": max(x["max_abs_err"] for x in runs
                                          if x["dtype"] == dt)
                 for dt in ("bfloat16", "float32")}
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=n,
            launches_by_path=({"serve_hybrid": n} if name == "ssd"
                              else {"ops.flash_mha": n}),
            max_abs_err=c["max_abs_err"], **extra, ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            library_what=c["library_what"], shape=key))
    # the SSD backward: launches from the training runs of 17b (every step
    # checked against the design), the case zamba2's training gives it
    bwd_main = dict(Nb=SSM_TRAIN_BATCH, T=SSM_TRAIN_SEQ, H=zamba.ssm_heads,
                    dtype="float32")
    runs17 = p17["ssd_bwd_cases"]
    c = next(x for x in runs17 if all(x[k] == v for k, v in bwd_main.items()))
    by_train = {f"train_{a}": r["launches_per_step"]["ssd_bwd"]
                * len(r["losses"]) for a, r in p17["train"].items()}
    kernels.append(dict(
        name="ssd_bwd", route="cuda", source=KERNELS["ssd_bwd"]["source"],
        replaces=KERNELS["ssd_bwd"]["replaces"],
        replaces_note=KERNELS["ssd_bwd"]["replaces_note"],
        launches=sum(by_train.values()), launches_by_path=by_train,
        max_abs_err=c["max_abs_err"],
        **{f"max_rel_err_{dt}": max(max(x["rel_errs"].values())
                                    for x in runs17 if x["dtype"] == dt)
           for dt in ("bfloat16", "float32")},
        ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
        bound_by=c["bound_by"], bound_ops_passes=SSD_BWD_PASSES,
        library_ms=None, library_what=c["library_what"], shape=bwd_main))
    for k in kernels:
        if k["name"] == "ssd":
            k["launches_by_path"].update(
                {f"train_{a}": r["launches_per_step"]["ssd"] * len(r["losses"])
                 for a, r in p17["train"].items()})
        # training on the mesh (17c, 20): each rank's launches at tp = 2's
        # local shapes (GSOFT: (1, 2); bdmm: one BOFT step at (1, 2); the
        # expert stacks' rotations: 20b; full fine-tuning, 20a: none)
        lanes = {n: r["launches"] for n, r in p17["mesh"]["runs"].items()}
        lanes.update({n: r["launches"] for n, r in p20["runs"].items()})
        mt = {lane: [r.get(k["name"], 0) for r in ranks]
              for lane, ranks in lanes.items()
              if any(r.get(k["name"], 0) for r in ranks)}
        if mt:
            k["mesh_train_launches"] = mt
    # tensor-parallel serving (16d): launches on each rank of tp = 2 and
    # the kernels at their local shapes
    case_fields = ("M", "K", "N", "B", "T", "d", "b", "trans", "H", "KH",
                   "D", "P", "dtype", "max_abs_err", "ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        # the cluster lane (16a): b = 8 on whole rows
        cc = [{f: c.get(f) for f in case_fields}
              for c in p16["cluster_kernel_cases"] if c["kernel"] == k["name"]]
        if cc:
            k["cluster_b8_cases"] = cc
        if k["name"] not in TP_KERNELS:
            continue
        k["tp2"] = dict(
            launches_by_lane={lane: [r.get(k["name"], 0) for r in ranks]
                              for lane, ranks in
                              p16["tp2"]["launches"].items()},
            local_cases=[{f: c.get(f) for f in case_fields}
                         for c in p16["tp_kernel_cases"]
                         if c["kernel"] == k["name"]])
    # the expert stacks (18b): one launch over every expert of a layer
    stack_fields = ("arch", "proj", "B", "T", "d", "b", "r", "route",
                    "dtype", "max_abs_err", "loop_err", "ms", "loop_ms",
                    "loop_launches", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_what")
    for k in kernels:
        sc = [{f: c.get(f) for f in stack_fields}
              for c in p18["stack_cases"] if c["kernel"] == k["name"]]
        if sc:
            k["moe_stack_cases"] = sc
        dc = [dict({f: c.get(f) for f in case_fields}, arch=c["arch"])
              for c in p18["kernel_cases"] if c["kernel"] == k["name"]]
        if dc:
            k["decoder_cases"] = dc
        # the encoder-decoder, vlm and classifier shapes (19d)
        ec = [dict({f: c.get(f) for f in case_fields}, arch=c["arch"],
                   proj=c.get("proj"))
              for c in p19["kernel_cases"] if c["kernel"] == k["name"]]
        if ec:
            k["encdec_vlm_classifier_cases"] = ec
        # a rank's expert stacks and paged decode heads at tp = 2 (20c)
        pc = [{f: c.get(f) for f in stack_fields}
              for c in p20["stack_cases"] if c["kernel"] == k["name"]]
        if pc:
            k["ep_stack_cases"] = pc
        if k["name"] == "paged_decode":
            k["ep_tp2_case"] = {f: p20["paged_case"].get(f)
                                for f in case_fields}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    spent = dict(_SPENT, build=build_s, phases=dict(_PHASE_S),
                 total=time.perf_counter() - _START)
    spent["set-up"] = (spent["total"] - build_s - _SPENT["timed"]
                       - _SPENT["profiled"])
    out.write_text(json.dumps(dict(card=card, build_s=build_s, spent=spent,
                                   cases=cases,
                                   bwd_cases=bwd_cases_run,
                                   bwd_entry=bwd_entry,
                                   bdmm_cases=bdmm_run, serve=serve,
                                   merged=merged, train=train, grads=grads,
                                   train_bdmm=trains_bdmm, quick=quick,
                                   mixed_serve=mserve, mixed_check=mcheck,
                                   quant_paged_cases=qcases,
                                   paged_int8_serve=qserve,
                                   paged_int8_check=qcheck,
                                   ssd_cases=ssd_run, flash_cases=flash_run,
                                   flash_refusal=refusal,
                                   flash_entry=flash_entry,
                                   hybrid_serve=hserve,
                                   hybrid_launcher=hlaunch,
                                   ssm_check=scheck,
                                   gs_library_cases=gs_lib_run,
                                   projection=proj, ckpt_resume=resume,
                                   adapters_int8_ckpt=ackpt,
                                   store_serve=sserve,
                                   store_check=scheck_store,
                                   image_cases=image_run,
                                   **p14, **p15, scale_out=p16,
                                   training=p17, moe_and_decoders=p18,
                                   encdec_vlm_classifier=p19,
                                   mesh_ft_and_experts=p20,
                                   kernels=kernels), indent=1,
                              default=str))
    log(f"details: {out}")
    total = time.perf_counter() - _START
    log(f"time: build {build_s:.1f} s, set-up "
        f"{total - build_s - _SPENT['timed'] - _SPENT['profiled']:.1f} s, "
        f"timed runs {_SPENT['timed']:.1f} s, profiled runs "
        f"{_SPENT['profiled']:.1f} s, total {total:.1f} s; of it the phases "
        f"{ {k: round(v, 1) for k, v in _PHASE_S.items()} } s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
