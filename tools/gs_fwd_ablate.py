"""Where route 1 of ``gs_fused`` spends its time, on one GPU, by ablation
(the card's profilers that count instructions do not run there).

    python3 tools/gs_fwd_ablate.py [--out FILE]

Builds variants of ``src/repro_torch/kernels/csrc/gs_fused.cu`` with nvcc,
each with a part of ``gs_fused_tc_kernel`` compiled out or changed (by text
substitutions on the source, which fail loudly if the source moved on), and
times each at the bf16 slabs of qwen2-72b at b = 32 (wi / wg 29568 x 8192,
MLP wo 8192 x 29568 with b not dividing r = 924, wq 8192 x 8192) with
``chip_smoke.time_ms``, beside ``y.copy_(x)`` on the same tensors:

* ``full`` — the kernel as it is (its output is checked against the plain
  version);
* ``no_writeback`` / ``no_c`` / ``no_a`` — without the write-back of y,
  stage (c) or stage (a);
* ``fetch_writeback`` — the x ring and the write-back only;
* ``fetch`` — the x ring only;
* ``plain_stores`` — y stored without the streaming hint.

The variants that skip work write wrong values; only their times mean
anything. Prints the card's name and power limit, each variant's registers
and spills as ptxas reports them, one line per shape, then one JSON line
(also written to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

torch, gk, build = cs.torch, cs.gk, cs.build
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
STAGE_A = ("    // (a) u = R x: U^T", "    __syncthreads();\n\n    // (c) z = L_g v")
STAGE_C = ("    // (c) z = L_g v", "    __syncthreads();\n\n    // y = P^T z: warp w")
WRITEBACK = ("    // y = P^T z: warp w", "  }\n  cp_async_wait<0>();\n}\n\n}  // namespace fwd")
SHAPES = ((29568, 8192), (8192, 29568), (8192, 8192))


def _cut(src: str, span: tuple) -> str:
    """``src`` without the text from span[0] up to (not including) span[1]."""
    i, j = src.index(span[0]), src.index(span[1])
    assert i < j and src.count(span[0]) == 1 and src.count(span[1]) == 1, span
    return src[:i] + src[j:]


def _variants(src: str) -> dict:
    plain = src.replace("st_cs16(", "st_wb16(").replace("st_cs2(", "st_wb2(")
    assert plain.count("st_wb16(") == 1 and plain.count("st_wb2(") == 1
    plain = plain.replace('#include "mma.cuh"\n', '''#include "mma.cuh"
namespace gs {
__device__ __forceinline__ void st_wb16(void* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }
__device__ __forceinline__ void st_wb2(void* p, bf16 v) { *reinterpret_cast<bf16*>(p) = v; }
}
''')
    return {"full": src, "no_writeback": _cut(src, WRITEBACK),
            "no_c": _cut(src, STAGE_C), "no_a": _cut(src, STAGE_A),
            "fetch_writeback": _cut(_cut(src, STAGE_A), STAGE_C),
            "fetch": _cut(_cut(_cut(src, STAGE_A), STAGE_C), WRITEBACK),
            "plain_stores": plain}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gs_fwd_ablate: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)   # git-ignored
    work = Path(tempfile.mkdtemp(prefix="ablate_", dir=build.BUILD_DIR))
    for h in CSRC.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    procs = {}
    for name, text in _variants((CSRC / "gs_fused.cu").read_text()).items():
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(work / f"{name}.so"),
             str(work / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    ptxas, libs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        ptxas[name] = [lines[i + 1].strip() + " | " + lines[i + 2].strip()
                       for i, line in enumerate(lines[:-2])
                       if "Function properties" in line and "tc_kernel" in line]
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.gs_fused_tc_bf16.argtypes = gk._FWD_TC_ARGTYPES
        lib.gs_fused_tc_bf16.restype = ctypes.c_int
        libs[name] = lib
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for T, d in SHAPES:
        r = d // 32
        L, R = cs._orth_factors(gen, 1, r, 32, torch.bfloat16, device)
        x = torch.randn((1, T, d), generator=gen, device=device).to(torch.bfloat16)
        y = torch.empty_like(x)
        plan = gk.fwd_plan(1, T, r, 32, "bf16", gk._num_sms(device))
        table = gk._tc_table_on(device, r)

        def run(lib):
            err = lib.gs_fused_tc_bf16(
                x.data_ptr(), L.data_ptr(), R.data_ptr(), table.data_ptr(),
                y.data_ptr(), 1, T, r, plan.tiles, plan.splits, plan.tokens,
                plan.window, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed with code {err}")
        run(libs["full"])
        torch.cuda.synchronize()
        err = (y.float() - gk.gs_fused_plain(x, L, R).float()).abs().max().item()
        if not err <= cs.BF16_TOL:
            raise AssertionError(f"T={T} d={d}: max|err| {err} > {cs.BF16_TOL}")
        ms = {n: cs.time_ms(lambda lib=lib: run(lib), [()]) for n, lib in libs.items()}
        rows.append(dict(T=T, d=d, max_abs_err=err, ms=ms,
                         copy_ms=cs.time_ms(lambda: y.copy_(x), [()]),
                         bound_ms=cs.bound(1, T, d, 32, torch.bfloat16)[0]))
    result = dict(card=card, ptxas=ptxas, shapes=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result) + "\n")
    print(card)
    for name, lines in ptxas.items():
        print(f"ptxas {name}: {lines}")
    for row in rows:
        print(f"T={row['T']} d={row['d']} bound {row['bound_ms']:.4f} copy_ "
              f"{row['copy_ms']:.4f} " + " ".join(
                  f"{n} {v:.4f}" for n, v in row["ms"].items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
