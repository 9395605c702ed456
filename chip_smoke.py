#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpulamm_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: compile every CUDA kernel from tpulamm_torch/csrc (one nvcc per
     source, all at once) and report the seconds
  3. kernels against their plain versions on the card: all six formats at
     M in {1, 8, 64}, N = 1024, K = 768 (three chunks), then Q4_0 at the
     LLaMA-7B projection shapes (qmm at M = 512, qmm_int8 at M = 1, and
     qmm_int8 also at M = 8 and 16, timed with no limit), with
     error, kernel / plain / library time (CUDA events, median of 20
     launches with a cold L2) and the least time the card could take;
     the int8 gemv's and prologue's ptxas register and spill lines;
     then qmm in all six formats at the reference shape 4096x11008x128
     (M = 128) and the 7B gate|up at M = 512: the same bits twice, GFLOPS,
     the share of the 1-pass bound and of the 2-pass floor
  3b. the flash kernels against flash_attention_ref on the card at the
     FLASH_CASES (bf16 and int8 + scales K/V, hd 64/128/256, G 1/4/8, B = 2
     with different qbase, holes and shifts, a qlen = 0 row, odd S, 56
     decode rows, a first 512-token ubatch), each the same bits twice, then
     timed at the long-context path's shapes (B = 1, Hkv = 32, hd = 128,
     G = 1; flash_attention at T = 512, S in {1024, 16385}; flash_decode at
     T = 1, S in {8193, 16385}; q8 and bf16) beside the plain version,
     scaled_dot_product_attention and the bound
  3c. the opt-in decode kernels against their plain versions on the card:
     qmm_int8_inkq bit for bit against qmm_int8 at the five 7B shapes in
     all six formats; ffn_fused at the 7B FFN (4096 -> 11008 -> 4096), M 1,
     4, 5, 8, 9 and 16, all six formats, silu and gelu (rel <= 1e-4, the
     same bits twice; Q4_0 timed at M 1, 8 and 16); mega_decode at 2 layers of
     LLaMA-7B and TinyLlama-1.1B width, spans 1024 and 2049 (max error <=
     1e-2 max|ref|, logits cosine >= 0.9999, the new K/V rows written into
     the cache); Q4_0 timed (ms, plain, library, bound)
  3d. stream_reduce against reduce_ref and a float64 column sum (within
     1e-5 sum|x| a column) with row tails to skip, block_rows 512 / 1024 /
     2048, cols 1024 and 256, 8 equal rows, the same bits twice; then the
     streaming probe's entry point (tools/stream_ceiling.py) on a 2 GiB
     buffer, and the kernel timed there beside its plain version,
     torch.sum(x, 0) and the bound: the card's measured streaming ceiling
  Every decode step below runs as a replay of a captured CUDA graph
  (runtime/decode_graph.py): each decode path holds its block's tokens
  against the same step called eagerly from the same cache (16-32 steps),
  counts the launches of the steps the blocks ran (an over-run included),
  prints the engine's graphs (capture seconds, count, pool memory) and
  profiles a step: wall and device ms, kernel launches (cudaLaunchKernel +
  cudaLaunchCooperativeKernel) apart from graph launches (cudaGraphLaunch)
  4. the slice at full width: a LLaMA-7B-shape Q4_0 GGUF (random blocks
     from a seed) served by Engine(n_ctx=2048) -- generate_fast on a
     512-token prompt for 128 greedy tokens (one block of 128 steps),
     twice; the launch counts of the second run must be 129 qmm (one
     ubatch) and 129 qmm_int8 per decode step, and both runs must give the
     same tokens; profiles of a 16-step block and of a decode_one step
  4c. the same model through Engine(megakernel=True, fused_ffn=True,
     int8_inkq=True): generate_fast twice as in 4 (launches of the second
     run: 129 qmm and 32 flash_attention for the ubatch, which reads the
     whole cache as the JAX megakernel engine does, then per decode step 1
     mega_decode and 1 qmm_int8_inkq for the lm head, nothing else; the
     same tokens), then 8 decode_one
     steps (per step 32 ffn_fused and 65 qmm_int8_inkq, nothing else);
     tok/s and profiles of a 16-step megakernel block, a megakernel step
     and a decode_one step (ffn_fused's ms a step)
  6. the measurement harness on the phase-4 model (32 layers), each entry
     point with its launch counts: tpulamm_torch.bench (Q4_0 4096x11008x128
     GFLOPS, its gate and JSON line), the perf_report matmul table (seven
     formats, each gated), cli.bench -p 512 -n 128 -r 2, cli.bench
     --batched -p 128 -n 32 -pl 1 -pl 4 -pl 8 -c 512, decode_roofline at
     the measured streaming ceiling; inside the --batched run every
     decode_batch_fast block is checked (exactly qmm_int8 129 x 32,
     nothing else), and after pl 4's warm-up block its greedy tokens
     against a host loop of decode_batch and against the eager steps of
     its graph, and a profile of one block (one device-to-host copy a
     block, none a step)
  4b. the long-context path at full width and depth: a CodeLlama-7B-shape
     Q4_0 GGUF (32 layers, vocab 32016, rope base 1e6, context 16384)
     served by Engine(n_ctx=16384, kv_dtype="q8_0") -- generate_fast on a
     12,000-token prompt (24 ubatches) for 64 greedy tokens (one block of
     64 steps); the launch counts must be flash_attention 23 x 32,
     flash_decode 64 x 32, qmm 24 x 128 and qmm_int8 64 x 128 (the lm
     head is dense); a profile of a 16-step block
  5. end-to-end numerics: the same width at 2 layers, the GPU engine
     against the port's plain path on the CPU (last prefill logits cosine
     >= 0.999; 8 teacher-forced decode steps cosine >= 0.99, the int8
     activations being the difference)
  5b. numerics through the flash kernels and a context shift: 2 layers,
     q8_0 KV, n_ctx 640, flash_attn=True on the card against the CPU's
     einsum path -- a 620-token prompt (two ubatches; cosine >= 0.999),
     then 32 teacher-forced decode steps (cosine >= 0.99 each) of which
     step 21 shifts the context; the host and device positions must agree
  5c. the megakernel at 2 layers of LLaMA-7B width over 8 teacher-forced
     steps: on the card against on the CPU (cosine >= 0.9999) and against
     the card's default decode path (cosine >= 0.99: f32 against int8
     activations)
  5d. batched decode at 2 layers of LLaMA-7B width, 3 slots: decode_batch
     on the card against the CPU's plain path over 8 teacher-forced steps
     (cosine >= 0.99 a slot and step), then decode_batch_sampled at temp 0
     with penalty_repeat 1.3, whose tokens must equal decode_batch + the
     host Sampler on the card; then decode_batch_fast blocks, greedy and
     at temp 0.9, against the eager steps of their graphs with the same
     seed (the same seed repeats, another does not)
Then one JSON line of the kernels and, last, the {"ok": true, ...} line.

Without CUDA it prints no result and exits with 1. It imports nothing of
JAX and nothing of the tpulamm package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.ops import ffn_fused as FF
from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import mega_decode as MD
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.ops.layers import rms_norm
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.runtime import decode_graph as DG
from tpulamm_torch.runtime.engine import Engine, Timings, forward
from tpulamm_torch.runtime.sampling import Sampler, SamplingParams
from tpulamm_torch.tools import int8_ablation as IA
from tpulamm_torch.tools import ffn_ablation as FAB
from tpulamm_torch.tools import mega_ablation as MA
from tpulamm_torch.tools import stream_ceiling as SC
from tpulamm_torch.tools.mega_ablation import step as mega_call
from tpulamm_torch.tools.synth import random_blocks, write_llama_gguf
from tpulamm_torch.tools.timing import nvidia_smi, time_ms

SEED = 1234
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tmp_smoke")                     # gitignored

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12               # outside the tensor cores

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
           GGMLType.Q8_0, GGMLType.Q2_K]
# LLaMA-7B projections as the engine runs them (N, K): fused QKV, wo,
# fused gate|up, down, lm head padded 32000 -> 32768
SHAPES_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096),
             "gate_up": (22016, 4096), "down": (4096, 11008),
             "lm_head": (32768, 4096)}
LLAMA_7B = dict(dim=4096, ffn=11008, n_head=32, vocab=32000)
# Code Llama 7B (Meta's release): LLaMA-7B widths, MHA, a 16k context
CODELLAMA_7B = dict(dim=4096, ffn=11008, n_head=32, vocab=32016,
                    n_ctx_train=16384, freq_base=1e6)
# TinyLlama-1.1B (its published config): GQA 32 / 4 heads, head_dim 64
TINYLLAMA = dict(dim=2048, ffn=5632, n_head=32, n_kv=4)
PREFILL_M, PROMPT, N_PREDICT = 512, 512, 128
LONG_CTX, LONG_PROMPT, LONG_PREDICT = 16384, 12000, 64
TOL_QMM, TOL_INT8 = 1e-4, 1e-5
# ffn_fused against its plain version: rel <= 1e-4 (f32 sums in another
# order over identical f32 weights); mega_decode: max error <= 1e-2 max|ref|
# (bf16 rounding flips of the residual stream from the f32 sum order) and
# the logits' cosine >= 0.9999
TOL_FFN, TOL_MEGA, COS_MEGA = 1e-4, 1e-2, 0.9999
# stream_reduce against the float64 column sum of the rows it reads:
# |got - ref| <= 1e-5 * sum |x| per column (f32 sums in a fixed order)
TOL_STREAM = 1e-5


def log(*a):
    print(*a, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |got - want|)"""
    d = float((got - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30), d


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# -- inputs ------------------------------------------------------------------
def flash_case(rng, device, *, B=2, Hkv=2, T=8, G=4, S=161, hd=64,
               kind="bf16", shift=False, empty_row=False, sharp=False,
               fresh=False):
    """Inputs of one flash-attention call (as tests/test_flash_attention.py
    builds them): the first `used` cells of each batch row live at
    positions 0..used-1 (the trash cell and the rest empty), the T queries
    at the last T of those positions; `fresh`: used = T, so qbase is 0 and
    the queries see the causal triangle of their own keys (a first
    ubatch); `shift` adds a seq_rm hole and a
    seq_add shift; `empty_row` gives batch row 1 qlen = 0; `sharp` scales
    q by 4, so that a few keys dominate each softmax and the outputs are
    near the size of v. kind "bf16": bf16 K/V; "q8": int8 codes with
    per-row f32 scales."""
    TG = T * G
    q = rng.standard_normal((B, Hkv, TG, hd), dtype=np.float32)
    if sharp:
        q *= 4.0
    kpos = np.full((B, S), -1, np.int32)
    qbase = np.zeros(B, np.int32)
    for b in range(B):
        used = T if fresh else max(T + 12, S - 1 - 8 * b - (S // 4) * (b % 2))
        kpos[b, :used] = np.arange(used)
        qbase[b] = used - T
        if shift:
            kpos[b, 5:9] = -1                      # seq_rm hole
            kpos[b, 12:used] -= 3                  # seq_add shift
            qbase[b] -= 3
    qlen = np.full(B, T, np.int32)
    if empty_row:
        qlen[1] = 0
    t = {"q": q, "kpos": kpos, "qbase": qbase, "qlen": qlen}
    if kind == "q8":
        t["k"] = rng.integers(-127, 128, (B, Hkv, S, hd), dtype=np.int8)
        t["v"] = rng.integers(-127, 128, (B, Hkv, S, hd), dtype=np.int8)
        t["ks"] = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
        t["vs"] = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
    else:
        t["k"] = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
        t["v"] = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
    out = {n: torch.from_numpy(a).to(device) for n, a in t.items()}
    if kind != "q8":
        out["k"] = out["k"].to(torch.bfloat16)
        out["v"] = out["v"].to(torch.bfloat16)
    out.setdefault("ks", None)
    out.setdefault("vs", None)
    return out


# phase-3b cases: both K/V kinds, hd 64/128/256, G 1/4/8, B = 2 with
# different qbase, holes and shifts, a row with qlen = 0, odd S; the sharp
# ones give outputs near the size of v at the path's head dim
FLASH_CASES = [
    dict(hd=64, G=4, T=8, S=161, kind="bf16", shift=True),
    dict(hd=64, G=8, T=1, S=161, kind="q8", empty_row=True),
    dict(hd=128, G=1, T=1, S=8193, Hkv=4, kind="q8", shift=True,
         empty_row=True),
    dict(hd=128, G=1, T=100, S=16385, Hkv=2, kind="bf16", shift=True),
    dict(hd=128, G=8, T=3, S=16385, Hkv=2, kind="q8", empty_row=True),
    dict(hd=128, G=4, T=70, S=8193, Hkv=2, kind="q8", shift=True),
    dict(hd=128, G=1, T=1, S=16385, Hkv=4, kind="q8", shift=True,
         sharp=True),
    dict(hd=128, G=1, T=64, S=2049, Hkv=4, kind="bf16", empty_row=True,
         sharp=True),
    dict(hd=256, G=4, T=16, S=8193, kind="bf16", empty_row=True),
    dict(hd=256, G=1, T=1, S=161, kind="q8", shift=True),
    # decode at G = 8, T = 7: 56 rows, four m16 row tiles in one block
    dict(hd=128, G=8, T=7, S=8193, Hkv=2, kind="q8", shift=True,
         empty_row=True),
    # a first 512-token ubatch: every live tile is on the causal diagonal
    dict(hd=128, G=1, T=512, S=1024, Hkv=2, kind="q8", fresh=True),
]
# elementwise |got - ref| <= TOL * (1 + |ref|): the JAX package's kernel
# tolerance for bf16 operands against the f32 plain version
TOL_FLASH = 2e-2
# scaled by the output's size, against the plain version on the operands
# as the kernel rounds them (q to bf16; K / V are bf16 or int8 codes
# already): max|got - ref| <= TOL_REL * max|ref| and rms(got - ref) <=
# TOL_REL * rms(ref). What is left is p's rounding to bf16, up to 2.8e-3
# of either on an H100; a dropped or mis-weighted chunk shows above it
TOL_FLASH_REL = 5e-3


def flash_refs(c, kw) -> tuple[torch.Tensor, torch.Tensor]:
    """flash_attention_ref on these inputs, and on them with q rounded to
    bf16 as the kernels round it."""
    def ref(q):
        return FA.flash_attention_ref(q, c["k"], c["v"], c["kpos"],
                                      c["qbase"], c["qlen"], c["ks"],
                                      c["vs"], **kw)
    return ref(c["q"]), ref(c["q"].to(torch.bfloat16).to(torch.float32))


def flash_err(got: torch.Tensor, refs, qlen) -> tuple[float, float, float]:
    """(max |got - ref|, then max |got - ref_q| over max |ref_q| and
    rms(got - ref_q) over rms(ref_q)) for refs = (ref, ref_q) of
    flash_refs; raises past either tolerance, on a NaN, or where a row
    with qlen = 0 is not exactly 0. On the CPU (a rehearsal: the wrappers
    return the plain version, q unrounded) ref stands for ref_q."""
    ref, ref_q = refs
    if not got.is_cuda:
        ref_q = ref
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("flash output holds a non-finite value")
    d = (got - ref).abs()
    err = float(d.max())
    if bool((d > TOL_FLASH * (1.0 + ref.abs())).any()):
        raise AssertionError(f"flash output off by {err} (tolerance "
                             f"{TOL_FLASH} + {TOL_FLASH}|ref|)")
    dq = got - ref_q
    rel = float(dq.abs().max()) / max(float(ref_q.abs().max()), 1e-30)
    rms = float(dq.square().mean().sqrt()) / max(
        float(ref_q.square().mean().sqrt()), 1e-30)
    if not (rel <= TOL_FLASH_REL and rms <= TOL_FLASH_REL):
        raise AssertionError(f"flash output off by {rel:.3e} of max|ref|, "
                             f"{rms:.3e} of rms(ref) (tolerance "
                             f"{TOL_FLASH_REL})")
    for b in range(got.shape[0]):
        if int(qlen[b]) == 0 and bool((got[b] != 0).any()):
            raise AssertionError(f"batch row {b} has qlen 0 but output "
                                 "is not exactly 0")
    return err, rel, rms


# -- timing ------------------------------------------------------------------
def bound_parts(qt: QTensor, m: int, peak_ops: float) -> tuple[float, float]:
    """(ms to move the bytes, ms to do the operations) of x (m, K) f32 @ W
    -> (m, N) f32: each input read once and the output written once at the
    HBM rate; 2mKN operations at `peak_ops`. The larger is the bound."""
    n, k = qt.mm_dims
    t_bytes = (qt.n_bytes + m * k * 4 + m * n * 4) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * n / peak_ops
    return t_bytes * 1e3, t_ops * 1e3


def time_case(kern, plain, x, qt, w_bf16, peak, device, reps):
    """(kernel ms, plain ms, library ms, bytes-bound ms, ops-bound ms);
    the library call is one bf16 torch.matmul with the weight already
    dequantized (timed here only; the port never calls it)."""
    xb = x.to(torch.bfloat16)
    t_k = time_ms(lambda: kern(x, qt), device, reps)
    t_p = time_ms(lambda: plain(x, qt), device, reps)
    t_l = time_ms(lambda: torch.matmul(xb, w_bf16), device, reps)
    return (t_k, t_p, t_l) + bound_parts(qt, x.shape[0], peak)


def case_line(case, name, rel, t_k, t_p, t_l, t_b, t_o, err="rel",
              library="bf16 matmul") -> str:
    b_ms = max(t_b, t_o)
    return (f"[kernels] {case}: {name} {err} {rel:.3e} | kernel {t_k:.4f} ms "
            f"| plain {t_p:.4f} ms | library({library}) {t_l:.4f} ms | "
            f"bound {b_ms:.4f} ms "
            f"({'bytes' if t_b >= t_o else 'operations'}) | "
            f"{b_ms / t_k:.1%} of bound")


# -- phases ------------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch: {kind}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return smi, kind


def phase_build() -> float:
    t0 = time.perf_counter()
    per_lib = kernels.build()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s for {sorted(per_lib) or 'nothing (cached)'}")
    for name in kernels.LIBS:
        logf = kernels.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    log(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels(device, rng, formats=FORMATS, small=(1024, 768),
                  small_m=(1, 8, 64), shapes=SHAPES_7B, prefill_m=PREFILL_M,
                  batch_m=(8, 16), reps=20) -> dict:
    """Hold each kernel against its plain version and time every case;
    the sums over the 7B shapes feed the kernels line. qmm_int8 is also
    timed over the 7B shapes at the batched decode's rows (batch_m)."""
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0,
                    "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                    "bytes_ms": 0.0, "ops_ms": 0.0}
             for name in ("qmm", "qmm_int8")}
    batch: dict[int, float] = {}
    logf = kernels.BUILD_DIR / "qmm_int8.log"
    if logf.exists():
        for line in IA.ptxas_lines(logf.read_text()):
            log(f"[kernels] qmm_int8 ptxas: {line}")

    def note(name, rel, ab):
        s = stats[name]
        s["max_abs_err"] = max(s["max_abs_err"], ab)
        tol = TOL_QMM if name == "qmm" else TOL_INT8
        if not rel <= tol:
            raise AssertionError(f"{name}: relative error {rel} > {tol}")

    def check_codes(x, qt):
        qx, sx, _ = Q.quantize_acts_cuda(x, qt.spec.group)
        rq, rs, _ = Q.quantize_acts(x, qt.spec.group)
        if not (torch.equal(qx, rq) and torch.equal(sx, rs)):
            raise AssertionError("qmm_int8: activation codes differ from "
                                 "the plain quantize_acts")

    n, k = small
    for qtype in formats:
        qt = QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                   (n, k), device=device)
        w_bf16 = dequant_mm(qt, torch.bfloat16)
        for m in small_m:
            x = torch.randn((m, k), device=device)
            cases = [("qmm", Q.qmm_cuda, Q.qmm_ref, PEAK_BF16_OPS)]
            if m <= Q.INT8_MAX_M:
                check_codes(x, qt)
                cases.append(("qmm_int8", Q.qmm_int8_cuda, Q.qmm_int8_ref,
                              PEAK_INT8_OPS))
            for name, kern, plain, peak in cases:
                rel, ab = rel_err(kern(x, qt), plain(x, qt))
                note(name, rel, ab)
                log(case_line(f"{qtype.name} M={m} N={n} K={k}", name, rel,
                              *time_case(kern, plain, x, qt, w_bf16, peak,
                                         device, reps)))
        del qt, w_bf16
    for label, (n, k) in shapes.items():
        qt = QTensor.from_gguf_raw(random_blocks(GGMLType.Q4_0, n, k, rng),
                                   GGMLType.Q4_0, (n, k), device=device)
        w_bf16 = dequant_mm(qt, torch.bfloat16)          # library yardstick
        for name, m, kern, plain, peak in (
                ("qmm", prefill_m, Q.qmm_cuda, Q.qmm_ref, PEAK_BF16_OPS),
                ("qmm_int8", 1, Q.qmm_int8_cuda, Q.qmm_int8_ref,
                 PEAK_INT8_OPS)):
            x = torch.randn((m, k), device=device)
            if name == "qmm_int8":
                check_codes(x, qt)
            rel, ab = rel_err(kern(x, qt), plain(x, qt))
            note(name, rel, ab)
            t_k, t_p, t_l, t_b, t_o = time_case(kern, plain, x, qt, w_bf16,
                                                peak, device, reps)
            s = stats[name]
            s["ms"] += t_k
            s["plain_ms"] += t_p
            s["library_ms"] += t_l
            s["bound_ms"] += max(t_b, t_o)
            s["bytes_ms"] += t_b
            s["ops_ms"] += t_o
            log(case_line(f"Q4_0 {label} M={m} N={n} K={k}", name, rel,
                          t_k, t_p, t_l, t_b, t_o))
        for m in batch_m:            # the batched decode's rows: no limit
            x = torch.randn((m, k), device=device)
            check_codes(x, qt)
            rel, ab = rel_err(Q.qmm_int8_cuda(x, qt), Q.qmm_int8_ref(x, qt))
            note("qmm_int8", rel, ab)
            t_m = time_ms(lambda: Q.qmm_int8_cuda(x, qt), device, reps)
            batch[m] = batch.get(m, 0.0) + t_m
            log(f"[kernels] Q4_0 {label} M={m} N={n} K={k}: qmm_int8 rel "
                f"{rel:.3e} | kernel {t_m:.4f} ms")
        del qt, w_bf16
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for m, t in batch.items():
        log(f"[kernels] qmm_int8 Q4_0 five 7B shapes M={m}: {t:.4f} ms, "
            f"{t / stats['qmm_int8']['ms']:.2f}x the M=1 {stats['qmm_int8']['ms']:.4f}"
            " ms (reported, no limit)")
    stats["qmm"]["formats"] = qmm_formats(device, rng, formats, reps=reps)
    return stats


# qmm per format: the reference shape of tpulamm_torch.bench (N 4096, K
# 11008, M 128) and the fused gate|up at the prefill ubatch (N 22016, K
# 4096, M 512)
QMM_FORMAT_SHAPES = [("ref", 4096, 11008, 128), ("gate_up", 22016, 4096, 512)]


def qmm_formats(device, rng, formats=FORMATS, shapes=QMM_FORMAT_SHAPES,
                reps=20) -> dict:
    """qmm in every format at QMM_FORMAT_SHAPES: held against qmm_ref
    (TOL_QMM) and the same bits twice, then timed; each case line gives
    GFLOPS and the share of the 1-pass bound (2MKN at the bf16 peak) and of
    the 2-pass floor (x_hi and x_lo through the tensor cores)."""
    out = {}
    for label, n, k, m in shapes:
        for qtype in formats:
            qt = QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                       (n, k), device=device)
            x = torch.randn((m, k), device=device)
            got = Q.qmm_cuda(x, qt)
            rel, _ = rel_err(got, Q.qmm_ref(x, qt))
            if not rel <= TOL_QMM:
                raise AssertionError(f"qmm {qtype.name} {label}: relative "
                                     f"error {rel} > {TOL_QMM}")
            if not torch.equal(got, Q.qmm_cuda(x, qt)):
                raise AssertionError(f"qmm {qtype.name} {label}: two calls "
                                     "gave different bits")
            t_k = time_ms(lambda: Q.qmm_cuda(x, qt), device, reps)
            t_b, t_o = bound_parts(qt, m, PEAK_BF16_OPS)
            gflops = 2.0 * m * k * n / t_k / 1e6
            out[f"{qtype.name} {label}"] = {"ms": t_k, "gflops": gflops}
            log(f"[kernels] qmm {qtype.name} {label} M={m} N={n} K={k}: rel "
                f"{rel:.3e}, same bits twice | kernel {t_k:.4f} ms, "
                f"{gflops:,.0f} GFLOPS | {max(t_b, t_o) / t_k:.1%} of the "
                f"1-pass bound, {2 * t_o / t_k:.1%} of the 2-pass floor")
            del qt, x, got
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


# flash timing at the long-context path's shapes (B = 1, Hkv = 32, hd = 128,
# G = 1): (kernel, T, S, kind); the q8 S = 16385 rows feed the kernels line
FLASH_TIMING = [("flash_attention", 512, 1024, "bf16"),
                ("flash_attention", 512, 1024, "q8"),
                ("flash_attention", 512, 16385, "bf16"),
                ("flash_attention", 512, 16385, "q8"),
                ("flash_decode", 1, 8193, "bf16"),
                ("flash_decode", 1, 8193, "q8"),
                ("flash_decode", 1, 16385, "bf16"),
                ("flash_decode", 1, 16385, "q8")]


def _flash_live(c, g: int) -> torch.Tensor:
    """(B, TG, S) bool: the (query row, key) pairs the mask lets through."""
    TG = c["q"].shape[2]
    t = torch.arange(TG, device=c["q"].device) // g
    qpos = c["qbase"][:, None].to(torch.int64) + t[None, :]
    kp = c["kpos"][:, None, :]
    return ((kp >= 0) & (kp <= qpos[:, :, None])
            & (t[None, :, None] < c["qlen"][:, None, None]))


def flash_bound(c, g: int) -> tuple[float, float]:
    """(ms to move the bytes, ms to do the operations) of one flash call
    on these inputs: q read and the f32 output written once, kpos, and the
    K / V rows (and scales) of the keys some query row can see; 4 hd
    operations per live (query row, key) pair at the bf16 peak."""
    B, Hkv, TG, hd = c["q"].shape
    live = _flash_live(c, g)
    keys = int(live.any(1).sum())
    pairs = int(live.sum())
    row = hd * (c["k"].element_size() + c["v"].element_size()) + 4 * sum(
        c[n] is not None for n in ("ks", "vs"))
    nbytes = (2 * c["q"].numel() * 4 + c["kpos"].numel() * 4
              + keys * Hkv * row)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4.0 * Hkv * hd * pairs / PEAK_BF16_OPS * 1e3)


def sdpa_call(c, g: int, scale: float):
    """One torch scaled_dot_product_attention over bf16 K / V (dequantized
    beforehand for q8) with the explicit boolean mask: the library
    yardstick, timed only."""
    k, v = c["k"], c["v"]
    if c["ks"] is not None:
        k = k.to(torch.float32) * c["ks"][..., None]
    if c["vs"] is not None:
        v = v.to(torch.float32) * c["vs"][..., None]
    q, k, v = (x.to(torch.bfloat16) for x in (c["q"], k, v))
    mask = _flash_live(c, g)[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def phase_flash(device, rng, cases=FLASH_CASES, timing=FLASH_TIMING,
                shape=(1, 32, 128), reps=20) -> dict:
    """The flash kernels against flash_attention_ref: every FLASH_CASES
    case through both wrappers, then the path's shapes, timed."""
    stats = {name: {"max_abs_err": 0.0} for name in FA.LAUNCHES}
    fns = {"flash_attention": FA.flash_attention,
           "flash_decode": FA.flash_decode}

    def run(fn, c, kw):
        return fn(c["q"], c["k"], c["v"], c["kpos"], c["qbase"], c["qlen"],
                  c["ks"], c["vs"], **kw)

    for case in cases:
        c = flash_case(rng, device, **case)
        kw = dict(scale=float(1.0 / np.sqrt(case["hd"])), g=case["G"])
        refs = flash_refs(c, kw)
        errs = []
        for name, fn in fns.items():
            got = run(fn, c, kw)
            err, rel, rms = flash_err(got, refs, c["qlen"])
            if not torch.equal(got, run(fn, c, kw)):
                raise AssertionError(f"{name} {case}: two calls gave "
                                     "different bits")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            errs.append(f"{name} {err:.3e} (bf16-q ref: {rel:.2e} of max, "
                        f"rms {rms:.2e}; same bits twice)")
        log(f"[flash] {case}: max|ref| {float(refs[0].abs().max()):.3e}, "
            f"max abs err {'; '.join(errs)}")
    B, Hkv, hd = shape
    for name, T, S, kind in timing:
        c = flash_case(rng, device, B=B, Hkv=Hkv, T=T, G=1, S=S, hd=hd,
                       kind=kind)
        kw = dict(scale=float(1.0 / np.sqrt(hd)), g=1)
        refs = flash_refs(c, kw)
        err, rel, rms = flash_err(run(fns[name], c, kw), refs, c["qlen"])
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        t_k = time_ms(lambda: run(fns[name], c, kw), device, reps)
        t_p = time_ms(lambda: run(FA.flash_attention_ref, c, kw), device,
                      reps)
        t_l = time_ms(sdpa_call(c, 1, kw["scale"]), device, reps)
        t_b, t_o = flash_bound(c, 1)
        log(case_line(f"{kind} B={B} Hkv={Hkv} hd={hd} T={T} S={S}", name,
                      err, t_k, t_p, t_l, t_b, t_o, err="abs err",
                      library="sdpa")
            + f" | bf16-q ref: {rel:.2e} of max, rms {rms:.2e}")
        if kind == "q8" and S == 16385:
            stats[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                               bound_ms=max(t_b, t_o), bytes_ms=t_b,
                               ops_ms=t_o)
        del c, refs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return stats


# -- slice 3: the opt-in decode kernels ----------------------------------------
def mega_case(rng, device, *, vocab: int = 4096, qtype=GGMLType.Q4_0,
              **kw) -> dict:
    """One megakernel step on a random llama stack
    (tools/mega_ablation.inputs: widths, layers, span, live cells, format,
    rope), and a random lm head and out_norm for logits."""
    c = MA.inputs(rng, device, qtype=qtype, **kw)
    dim = c["mega"].spec.dim
    head = QTensor.from_gguf_raw(random_blocks(qtype, vocab, dim, rng), qtype,
                                 (vocab, dim), device=device)
    out_norm = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(dim)).astype(
        np.float32)).to(device)
    return dict(c, head=head, out_norm=out_norm)


def mega_bound(c) -> tuple[float, float]:
    """(ms to move the bytes, ms to do the operations) of one step: every
    layer's planes, the live K / V rows, kpos, the norms, x and the outputs
    once at the HBM rate; the products' 2 N K operations at the bf16
    tensor-core rate and the attention's 4 hd a live key and head at the
    f32 rate (the kernel's types)."""
    spec = c["mega"].spec
    L, H, Hkv, hd = spec.n_layers, spec.n_heads, spec.n_kv_heads, spec.head_dim
    live = int((c["kpos"] >= 0).sum())
    planes = sum(lyr[k].n_bytes for lyr in c["mega"].layers
                 for k in MD.WEIGHTS)
    nbytes = (planes + 2 * L * Hkv * live * hd * 2 + c["kpos"].numel() * 4
              + 2 * L * spec.dim * 4 + 2 * spec.dim * 4
              + 2 * L * Hkv * hd * 4)
    macs = (spec.dim * spec.nqkv + H * hd * spec.dim + spec.dim * 2 * spec.ffn
            + spec.ffn * spec.dim)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            L * (2 * macs / PEAK_BF16_OPS
                 + 4 * H * hd * (live + 1) / PEAK_F32_OPS) * 1e3)


# phase-3c megakernel cases: (label, widths, span, live cells); 2 layers
MEGA_CASES = [("LLaMA-7B", dict(dim=4096, ffn=11008, n_head=32), 1024, 640),
              ("LLaMA-7B", dict(dim=4096, ffn=11008, n_head=32), 2049, 2047),
              ("TinyLlama-1.1B", TINYLLAMA, 1024, 640),
              ("TinyLlama-1.1B", TINYLLAMA, 2049, 2047)]


def phase_decode_kernels(device, rng, formats=FORMATS, shapes=SHAPES_7B,
                         ffn_dims=(4096, 11008), ffn_m=(1, 4, 5, 8, 9, 16),
                         ffn_timed=(1, 8, 16), mega_cases=MEGA_CASES,
                         reps=20) -> dict:
    """The three opt-in decode kernels against their plain versions on the
    card: qmm_int8_inkq bit for bit against qmm_int8 at the 7B shapes in
    every format; ffn_fused at the 7B FFN in every format at each M of
    ffn_m, silu and gelu, the same bits twice; mega_decode at 2 layers of
    two widths and two spans. Timed at Q4_0 (the int8 gemv at M = 1;
    ffn_fused at each M of ffn_timed, the kernels line at M = 1; mega at
    the first case)."""
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                    "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
                    "ops_ms": 0.0}
             for name in ("qmm_int8_inkq", "ffn_fused", "mega_decode")}

    def add(name, t_k, t_p, t_l, t_b, t_o):
        s = stats[name]
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bound_ms", max(t_b, t_o)), ("bytes_ms", t_b),
                       ("ops_ms", t_o)):
            s[key] = None if v is None else s[key] + v

    def q(qtype, n, k):
        return QTensor.from_gguf_raw(random_blocks(qtype, n, k, rng), qtype,
                                     (n, k), device=device)

    for qtype in formats:
        for label, (n, k) in shapes.items():
            qt = q(qtype, n, k)
            x = torch.randn((1, k), device=device)
            got = Q.qmm_int8_inkq_cuda(x, qt)
            if not torch.equal(got, Q.qmm_int8_cuda(x, qt)):
                raise AssertionError(f"qmm_int8_inkq {qtype.name} {label}: "
                                     "not bit-identical to qmm_int8")
            rel, ab = rel_err(got, Q.qmm_int8_inkq_ref(x, qt))
            stats["qmm_int8_inkq"]["max_abs_err"] = max(
                stats["qmm_int8_inkq"]["max_abs_err"], ab)
            if not rel <= TOL_INT8:
                raise AssertionError(f"qmm_int8_inkq: relative error {rel}")
            if qtype == GGMLType.Q4_0:
                t = time_case(Q.qmm_int8_inkq_cuda, Q.qmm_int8_inkq_ref, x,
                              qt, dequant_mm(qt, torch.bfloat16),
                              PEAK_INT8_OPS, device, reps)
                add("qmm_int8_inkq", *t)
                log(case_line(f"Q4_0 {label} M=1 N={n} K={k}",
                              "qmm_int8_inkq", rel, *t))
            del qt
        log(f"[decode] {qtype.name}: qmm_int8_inkq == qmm_int8 bit for bit "
            "at the five 7B shapes")
    dim, ffn = ffn_dims
    logf = kernels.BUILD_DIR / "ffn_fused.log"
    if logf.exists():
        for line in FAB.ptxas_lines(logf.read_text()):
            log(f"[decode] ffn_fused ptxas: {line}")
    for qtype in formats:
        gu, dn = q(qtype, 2 * ffn, dim), q(qtype, dim, ffn)
        rels = []
        for m in ffn_m:
            for act in ("silu", "gelu"):
                x = torch.randn((m, dim), device=device)
                got = FF.ffn_fused(x, gu, dn, act=act)
                if not torch.equal(got, FF.ffn_fused(x, gu, dn, act=act)):
                    raise AssertionError(f"ffn_fused {qtype.name} M={m} {act}: "
                                         "two runs differ")
                rel, ab = rel_err(got, FF.ffn_fused_ref(x, gu, dn, act=act))
                stats["ffn_fused"]["max_abs_err"] = max(
                    stats["ffn_fused"]["max_abs_err"], ab)
                if not (rel <= TOL_FFN and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"ffn_fused {qtype.name} M={m} {act}: "
                                         f"relative error {rel} > {TOL_FFN}")
                rels.append(f"M={m} {act} {rel:.2e}")
                if qtype != GGMLType.Q4_0 or act != "silu" or m not in ffn_timed:
                    continue
                t = (time_ms(lambda: FF.ffn_fused(x, gu, dn), device, reps),
                     time_ms(lambda: FF.ffn_fused_ref(x, gu, dn), device,
                             reps),
                     time_ms(FAB.library(x, gu, dn), device, reps)
                     ) + FAB.bound_ms(m, gu, dn)
                if m == 1:
                    add("ffn_fused", *t)
                log(case_line(f"Q4_0 M={m} dim={dim} ffn={ffn}", "ffn_fused",
                              rel, *t, library="2 bf16 matmul + silu"))
        log(f"[decode] {qtype.name} dim={dim} ffn={ffn}: ffn_fused the same "
            f"bits twice, rel {', '.join(rels)}")
        del gu, dn
    logf = kernels.BUILD_DIR / "mega_decode.log"
    if logf.exists():
        for line in MA.ptxas_lines(logf.read_text()):
            log(f"[decode] mega_decode_kernel ptxas: {line}")
    for i, (label, widths, span, live) in enumerate(mega_cases):
        c = mega_case(rng, device, **widths, span=span, live=live)
        got = mega_call(MD.mega_decode_layers, c)
        rows = [k[0, :, c["pos"]].clone() for k in c["k"] + c["v"]]
        want = mega_call(MD.mega_decode_layers_ref, c)
        errs, rels = [], []
        for name, a, b in zip(("x_out", "k_new", "v_new"), got, want):
            rel, ab = rel_err(a, b)
            errs.append(f"{name} {rel:.2e}")
            rels.append(rel)
            stats["mega_decode"]["max_abs_err"] = max(
                stats["mega_decode"]["max_abs_err"], ab)
            if not (rel <= TOL_MEGA and bool(torch.isfinite(a).all())):
                raise AssertionError(f"mega_decode {label} span {span}: "
                                     f"{name} off by {rel} of max|ref|")
        hd = c["mega"].spec.head_dim
        for row, new in zip(rows, list(got[1]) + list(got[2])):
            if not torch.equal(row, new.reshape(-1, hd).to(torch.bfloat16)):
                raise AssertionError("mega_decode did not write the new "
                                     "K/V row into the cache")

        def logits(xo):
            h = rms_norm(xo.to(torch.bfloat16), c["out_norm"], 1e-5)
            return Q.qmm_ref(h.to(torch.float32), c["head"])[0].cpu().numpy()
        cos = cosine(logits(got[0]), logits(want[0]))
        if not cos >= COS_MEGA:
            raise AssertionError(f"mega_decode {label} span {span}: logits "
                                 f"cosine {cos} < {COS_MEGA}")
        case = f"{label} 2 layers span={span} live={live}"
        if i == 0:
            t = (time_ms(lambda: mega_call(MD.mega_decode_layers, c), device,
                         reps),
                 time_ms(lambda: mega_call(MD.mega_decode_layers_ref, c),
                         device, 3), None) + mega_bound(c)
            add("mega_decode", *t)
            log(case_line(case, "mega_decode", rels[0], t[0], t[1],
                          float("nan"), t[3], t[4], library="none"))
        log(f"[decode] {case}: mega_decode max err / max|ref|: "
            f"{', '.join(errs)}; logits cosine {cos!r}")
        del c
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return stats


# phase-3d cases (total_rows, cols): row tails at every block size (the
# kernel skips them), cols 1024 and 256, a buffer of many tiles, and one
# shorter than a tile (the output is b alone)
STREAM_CASES = [(3 * 2048 + 777, 1024), (3 * 2048 + 777, 256),
                (41 * 2048 + 1000, 1024), (300, 256)]


def stream_err(got: torch.Tensor, x: torch.Tensor, b: float, br: int
               ) -> float:
    """max |got - ref| for ref the float64 column sum of the rows a
    block_rows = br reduce reads, plus b; raises past TOL_STREAM sum|x| a
    column or where the 8 rows differ."""
    n = x.shape[0] // br * br
    xs = x[:n].to(torch.float64)
    err = (got.to(torch.float64) - (xs.sum(0) + b)).abs()
    if not bool((err <= TOL_STREAM * xs.abs().sum(0)).all()):
        raise AssertionError(f"stream_reduce off by {float(err.max())} "
                             f"(block_rows {br}, {tuple(x.shape)})")
    if not bool((got == got[:1]).all()):
        raise AssertionError("stream_reduce: the 8 output rows differ")
    return float(err.max())


def phase_stream(device, rng, cases=STREAM_CASES, gb: float = 2.0,
                 reps: int = 20) -> dict:
    """stream_reduce against reduce_ref and a float64 column sum at
    STREAM_CASES and each block size, bit-identical over two runs; then the
    probe's entry point on a `gb` GiB buffer (its launches are the main
    path's), and the kernel timed beside its plain version, torch.sum and
    the bound on a buffer of the same size."""
    stats = {"max_abs_err": 0.0}
    for rows, cols in cases:
        x = torch.from_numpy(rng.standard_normal((rows, cols), dtype=np.float32)
                             ).to(device)
        b = torch.full((1, 1), 0.375, device=device)
        errs = []
        for br in SC.BLOCK_ROWS:
            run = SC.make_reduce(rows, cols, br)
            got = run(b, x)
            if not torch.equal(got, run(b, x)):
                raise AssertionError("stream_reduce: two runs differ")
            err = stream_err(got, x, 0.375, br)
            rel, _ = rel_err(got, SC.reduce_ref(x, b, br))
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            errs.append(f"block_rows {br}: {err:.3e} (vs reduce_ref {rel:.2e} "
                        "of max)")
        log(f"[stream] {rows}x{cols}, tail skipped, 8 equal rows, same bits "
            f"twice; max abs err vs f64: {'; '.join(errs)}")
    SC.reset_launches()
    SC.main([str(gb), "--device", str(device)])
    launches = SC.LAUNCHES["stream_reduce"]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    total_rows = int(gb * 2**30 / (SC.COLS * 4)) // 2048 * 2048
    x = torch.randn((total_rows, SC.COLS), generator=gen, device=device)
    rows = SC.probe(x)
    best = max(rows, key=lambda r: r["gbs"])
    br = best["block_rows"]
    b = torch.zeros((1, 1), device=device)
    got = SC.make_reduce(total_rows, SC.COLS, br)(b, x)
    stats["max_abs_err"] = max(stats["max_abs_err"],
                               stream_err(got, x, 0.0, br))
    t_p = time_ms(lambda: SC.reduce_ref(x, b, br), device, reps, flush=False)
    t_l = time_ms(lambda: torch.sum(x, 0), device, reps, flush=False)
    nbytes = SC.read_bytes(total_rows, SC.COLS, br) + 8 * SC.COLS * 4 + 4
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = SC.read_bytes(total_rows, SC.COLS, br) / 4 / PEAK_F32_OPS * 1e3
    stats.update(ms=best["ms"], plain_ms=t_p, library_ms=t_l,
                 bound_ms=max(t_b, t_o), bytes_ms=t_b, ops_ms=t_o,
                 launches=launches, ceiling_gbs=best["gbs"])
    log(case_line(f"{total_rows}x{SC.COLS} f32 block_rows={br}",
                  "stream_reduce", stats["max_abs_err"], best["ms"], t_p, t_l,
                  t_b, t_o, err="abs err", library="torch.sum(x, 0)"))
    log(f"[stream] measured streaming ceiling: {best['gbs']:.1f} GB/s "
        f"({best['pct']:.1f}% of 3.35 TB/s) at block_rows {br}; "
        f"{launches} launches in the probe run")
    del x, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return stats


def phase_opt_in(device, rng, path: str, n_layers: int, shape=LLAMA_7B,
                 prompt_len: int = PROMPT, n_predict: int = N_PREDICT,
                 decode_steps: int = 8) -> dict:
    """Slice 3 at full width: the phase-4 model through the opt-in decode
    kernels, Engine(megakernel=True, fused_ffn=True, int8_inkq=True): two
    generate_fast runs (the megakernel path), then decode_one steps (the
    fused FFN and in-kernel-quantized gemv path)."""
    t0 = time.perf_counter()
    eng = Engine(path, n_ctx=2048, megakernel=True, fused_ffn=True,
                 int8_inkq=True, device=device)
    if eng.mega is None:
        raise AssertionError("the model did not qualify for the megakernel")
    log(f"[opt-in] Engine(megakernel, fused_ffn, int8_inkq) load "
        f"{time.perf_counter() - t0:.2f} s")
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    ids_a, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    eng.timings = Timings()

    reset_port_launches()
    ids_b, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    mega_launches = port_launches()
    tm = eng.timings
    steps = tm.n_step                  # the blocks' steps, over-run included
    out = {"mega_decode_tok_s": (len(ids_b) - 1) / tm.t_eval,
           "mega_prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "mega_launches": mega_launches}
    log(f"[opt-in] generate_fast through the megakernel: prefill "
        f"{out['mega_prefill_tok_s']:.1f} tok/s, decode {len(ids_b) - 1} "
        f"tokens ({steps} steps in graph blocks) "
        f"{out['mega_decode_tok_s']:.2f} tok/s, launches {mega_launches}")
    if ids_a != ids_b:
        raise AssertionError("two megakernel runs gave different tokens")
    # the ubatch's forward reads the whole 2049-cell cache, as the JAX
    # megakernel engine's does, so each layer runs flash_attention
    want = {**{k: 0 for k in mega_launches}, "qmm": 4 * n_layers + 1,
            "flash_attention": n_layers, "mega_decode": steps,
            "qmm_int8_inkq": steps}
    if mega_launches != want:
        raise AssertionError(f"launch counts {mega_launches} != {want}")
    log(f"[opt-in] launch counts as expected: mega_decode and "
        f"qmm_int8_inkq (lm head) 1 per step x {steps}, qmm {4 * n_layers + 1}"
        f" and flash_attention {n_layers} for the ubatch; two runs gave the "
        "same tokens")
    check_against_eager(eng, "opt-in", ids_b, prompt_len, "mega")
    if device.type == "cuda":
        base = int(eng.n_past[0])
        out.update(profile_steps(
            eng, "mega_block",
            lambda: (eng.rollback(0, base),
                     eng._block("mega", 0, [5], [base], [1], 16, [0.0], 40,
                                0)),
            steps=2, per=16))
        eng.rollback(0, base)
        out["mega_step_ms"] = wall_ms(lambda: eng._mega_step(0, 5))
        eng.rollback(0, base)
        log(f"[opt-in] _mega_step (one graph replay, logits copied back): "
            f"{out['mega_step_ms']:.3f} ms a step, no profiler")
        out.update(profile_steps(eng, "mega", lambda: eng._mega_step(0, 5)))
    # decode_one: the forward with the fused FFN and the inkq gemv, one
    # graph replay a step; one step first, uncounted, captures it
    tok = int(np.argmax(eng.decode_one(0, ids_b[-1])))
    reset_port_launches()
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        lg = eng.decode_one(0, tok)
        if not np.isfinite(lg).all():
            raise AssertionError("decode_one logits not finite")
        tok = int(np.argmax(lg))
    t_one = time.perf_counter() - t0
    fused_launches = port_launches()
    out.update(fused_decode_tok_s=decode_steps / t_one,
               fused_launches=fused_launches)
    want = {**{k: 0 for k in fused_launches},
            "ffn_fused": n_layers * decode_steps,
            "qmm_int8_inkq": (2 * n_layers + 1) * decode_steps}
    log(f"[opt-in] {decode_steps} decode_one steps: "
        f"{out['fused_decode_tok_s']:.2f} tok/s, launches {fused_launches}")
    if fused_launches != want:
        raise AssertionError(f"launch counts {fused_launches} != {want}")
    log(f"[opt-in] launch counts as expected: ffn_fused {n_layers} and "
        f"qmm_int8_inkq {2 * n_layers + 1} per step, qmm_int8 0")
    if device.type == "cuda":
        out.update(profile_steps(eng, "fused", lambda: eng.decode_one(0, 5)))
        ms, n = out["fused_port_ms"].get("ffn_fused_kernel", (0.0, 0))
        log(f"[opt-in] ffn_fused in a decode_one step: {ms:.3f} ms of device "
            f"time over {n} launches, in {out['fused_wall_ms']:.3f} ms of wall "
            f"time with {out['fused_busy_ms']:.3f} ms of device time")
    out.update(graph_report(eng, "opt-in"))
    del eng
    return out


def phase_mega_numerics(device, rng, shape=LLAMA_7B, prompt_len: int = 64,
                        steps: int = 8) -> dict:
    """2 layers at full width, 8 teacher-forced megakernel steps: the card
    against the CPU's plain megakernel (cosine >= 0.9999), and against the
    card's default decode path (cosine >= 0.99: f32 activations against the
    default's int8 ones)."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "llama7b_shape_q4_0_2l_mega.gguf")
    write_llama_gguf(path, 2, rng, **shape)
    gpu = Engine(path, n_ctx=2048, megakernel=True, device=device)
    cpu = Engine(path, n_ctx=2048, megakernel=True, device="cpu")
    base = Engine(path, n_ctx=2048, device=device)
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    tok = int(np.argmax(cpu.prefill(0, prompt)))
    gpu.prefill(0, prompt)
    base.prefill(0, prompt)
    cos_cpu, cos_base = [], []
    for _ in range(steps):
        a = gpu._mega_step(0, tok)
        b = cpu._mega_step(0, tok)
        c = base.decode_one(0, tok)
        if not (np.isfinite(a).all() and a.shape == (shape["vocab"],)):
            raise AssertionError("megakernel logits not finite / misshapen")
        cos_cpu.append(cosine(a, b))
        cos_base.append(cosine(a, c))
        tok = int(np.argmax(b))
    log(f"[mega-numerics] 2 layers, {steps} teacher-forced steps: megakernel "
        f"on the card vs on the CPU min cosine {min(cos_cpu)!r} (>= 0.9999); "
        f"vs the default decode path min cosine {min(cos_base)!r} (>= 0.99)")
    if not min(cos_cpu) >= 0.9999:
        raise AssertionError(f"mega card vs CPU cosine {min(cos_cpu)} < 0.9999")
    if not min(cos_base) >= 0.99:
        raise AssertionError(f"mega vs default cosine {min(cos_base)} < 0.99")
    del gpu, cpu, base
    os.remove(path)
    return {"cos_cpu_min": min(cos_cpu), "cos_default_min": min(cos_base)}


def phase_long(device, rng, n_layers: int = 32, shape=CODELLAMA_7B,
               n_ctx: int = LONG_CTX, prompt_len: int = LONG_PROMPT,
               n_predict: int = LONG_PREDICT, n_ubatch: int = 512) -> dict:
    """Serve a CodeLlama-7B-shape Q4_0 model at a 16k context with a q8_0
    KV cache: one generate_fast run over a prompt of many ubatches."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"codellama7b_shape_q4_0_{n_layers}l.gguf")
    t0 = time.perf_counter()
    write_llama_gguf(path, n_layers, rng, **shape)
    log(f"[long] wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB, "
        f"{n_layers} layers) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = Engine(path, n_ctx=n_ctx, n_ubatch=n_ubatch, kv_dtype="q8_0",
                 device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    out_w = eng.params["output"]
    quant_head = isinstance(out_w, QTensor)
    weights = sum(v.n_bytes for lyr in eng.params["layers"] for v in lyr.values()
                  if isinstance(v, QTensor))
    head = (out_w.n_bytes if quant_head
            else out_w.numel() * out_w.element_size())
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in eng.cache.k + eng.cache.v)
    sc_bytes = sum(t.numel() * 4 for t in eng.cache.ks + eng.cache.vs)
    log(f"[long] Engine(n_ctx={n_ctx}, kv_dtype='q8_0') load {t_load:.2f} s: "
        f"{weights / 1e9:.3f} GB of layer projection planes, lm head "
        f"{head / 1e9:.3f} GB ({'Q4_0 planes' if quant_head else 'dense'}), "
        f"{kv_bytes / 1e9:.3f} GB of q8_0 K/V codes, {sc_bytes / 1e9:.3f} GB "
        "of row scales")
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    Q.reset_launches()
    FA.reset_launches()
    ids, _ = eng.generate_fast(prompt, n_predict=n_predict,
                               stop_on_eos=False)
    launches = {**Q.LAUNCHES, **FA.LAUNCHES}
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    tm = eng.timings
    steps = tm.n_step                  # the blocks' steps, over-run included
    out = {"layers": n_layers, "load_s": t_load,
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": (len(ids) - 1) / tm.t_eval,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "tokens": len(ids)}
    log(f"[long] {n_layers} layers, n_ctx {n_ctx}, q8_0 KV: prefill "
        f"{prompt_len} tokens {out['prefill_tok_s']:.1f} tok/s "
        f"({tm.t_prefill:.3f} s), decode {len(ids) - 1} tokens ({steps} "
        f"steps in graph blocks) {out['decode_tok_s']:.2f} tok/s, peak "
        f"memory {out['peak_mem_gb']:.3f} GB, launches {launches}")
    n_ub = -(-prompt_len // n_ubatch)
    # four fused projections a layer, plus the lm head where it is
    # quantized: a vocab that is not a multiple of 128 (32016) is stored
    # dense by both packages' loaders and runs as one dense matmul
    per_pass = 4 * n_layers + int(quant_head)
    # ubatch 0 runs at span n_ubatch < 1024 and takes the einsum; every
    # later ubatch (span >= 1024, T >= 64) flash_attention; every decode
    # step (span >= 8192, T * G = 1) flash_decode
    want = {"qmm": per_pass * n_ub, "qmm_int8": per_pass * steps,
            "qmm_int8_inkq": 0,
            "flash_attention": n_layers * (n_ub - 1),
            "flash_decode": n_layers * steps}
    if launches != want or steps != DG.pick_block(n_predict - 1, n_ctx):
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"({steps} decode steps)")
    check_against_eager(eng, "long", ids, prompt_len, "step", steps=16)
    lg = eng.decode_one(0, ids[-1])
    if not (np.isfinite(lg).all() and lg.shape == (shape["vocab"],)
            and all(0 <= t < shape["vocab"] for t in ids)):
        raise AssertionError("long-context logits not finite / misshapen")
    log(f"[long] launch counts as expected: {want}; logits finite")
    if device.type == "cuda":
        base = int(eng.n_past[0])
        # the run above captured its graph inside its timing: a block of
        # the same 64 steps again, its graph captured first
        out["block_ms"] = wall_ms(lambda: (
            eng.rollback(0, base), eng.decode_batch_fast({0: 5}, 64)), n=2) / 64
        eng.rollback(0, base)
        out["decode_one_ms"] = wall_ms(lambda: eng.decode_one(0, 5))
        eng.rollback(0, base)
        log(f"[long] a 64-step block: {out['block_ms']:.3f} ms a step "
            f"({1e3 / out['block_ms']:.2f} tok/s); decode_one "
            f"{out['decode_one_ms']:.3f} ms a step; no profiler")
        out.update(profile_steps(
            eng, "decode16k_block",
            lambda: (eng.rollback(0, base),
                     eng.decode_batch_fast({0: 5}, 16)),
            steps=2, per=16))
        # one more 512-token ubatch at the full 16385-cell span, then
        # decode steps: where the device time of each goes
        chunk = prompt[:n_ubatch]
        out.update(profile_steps(eng, "prefill16k",
                                 lambda: eng.prefill(0, chunk), steps=1))
        out.update(profile_steps(eng, "decode16k",
                                 lambda: eng.decode_one(0, 5)))
    out.update(graph_report(eng, "long"))
    del eng
    os.remove(path)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_shift(device, rng, shape=CODELLAMA_7B, n_ctx: int = 640,
                prompt_len: int = 620, steps: int = 32) -> dict:
    """2-layer CodeLlama-shape model, q8_0 KV: the card with flash_attn
    forced on (both kernels at short spans) against the CPU's einsum path,
    across a context shift."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "codellama7b_shape_q4_0_2l.gguf")
    write_llama_gguf(path, 2, rng, **shape)
    gpu = Engine(path, n_ctx=n_ctx, kv_dtype="q8_0", flash_attn=True,
                 device=device)
    cpu = Engine(path, n_ctx=n_ctx, kv_dtype="q8_0", device="cpu")
    FA.reset_launches()
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    a, b = gpu.prefill(0, prompt), cpu.prefill(0, prompt)
    if not (np.isfinite(a).all() and a.shape == (shape["vocab"],)):
        raise AssertionError("prefill logits not finite / misshapen")
    cos_prefill = cosine(a, b)
    cos_dec, shifted = [], []
    tok = int(np.argmax(b))
    for i in range(steps):
        before = int(gpu.n_past[0])
        a, b = gpu.decode_one(0, tok), cpu.decode_one(0, tok)
        if not np.isfinite(a).all():
            raise AssertionError("decode logits not finite")
        if int(gpu.n_past[0]) != before + 1:
            shifted.append(i + 1)
        cos_dec.append(cosine(a, b))
        tok = int(np.argmax(b))
    dev_pos = gpu.cache.pos[0, :n_ctx].cpu().numpy()
    launches = dict(FA.LAUNCHES)
    log(f"[shift] 2 layers, q8_0 KV, n_ctx {n_ctx}, flash_attn on the card: "
        f"prefill {prompt_len} tokens cosine {cos_prefill!r} (>= 0.999); "
        f"{steps} teacher-forced decode steps, min cosine {min(cos_dec)!r} "
        f"(>= 0.99), context shift at step(s) {shifted}, n_past "
        f"{int(gpu.n_past[0])}, flash launches {launches}")
    if not cos_prefill >= 0.999:
        raise AssertionError(f"prefill cosine {cos_prefill} < 0.999")
    if not min(cos_dec) >= 0.99:
        raise AssertionError(f"decode cosine {min(cos_dec)} < 0.99")
    if not shifted or int(gpu.n_past[0]) != int(cpu.n_past[0]):
        raise AssertionError("the context did not shift on both engines")
    if not (np.array_equal(dev_pos, gpu.cell_pos[0])
            and np.array_equal(gpu.cell_pos, cpu.cell_pos)):
        raise AssertionError("host cell_pos and device pos disagree")
    n_ub = -(-prompt_len // gpu.n_ubatch)
    if launches != {"flash_attention": 2 * n_ub, "flash_decode": 2 * steps}:
        raise AssertionError(f"flash launches {launches}")
    del gpu, cpu
    os.remove(path)
    return {"cos_prefill": cos_prefill, "cos_decode_min": min(cos_dec),
            "shift_steps": shifted}


def phase_slice(device, rng, n_layers: int = 32, shape=LLAMA_7B,
                prompt_len: int = PROMPT, n_predict: int = N_PREDICT,
                keep: bool = False) -> dict:
    """Serve a LLaMA-7B-shape Q4_0 model: two identical generate_fast runs,
    launch counts and speed from the second. keep: leave the GGUF for the
    next phase (its path is out["path"])."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"llama7b_shape_q4_0_{n_layers}l.gguf")
    t0 = time.perf_counter()
    write_llama_gguf(path, n_layers, rng, **shape)
    log(f"[slice] wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB, "
        f"{n_layers} layers) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = Engine(path, n_ctx=2048, device=device)
    t_load = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    weights = sum(v.n_bytes for lyr in eng.params["layers"] for v in lyr.values()
                  if isinstance(v, QTensor)) + eng.params["output"].n_bytes
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in eng.cache.k + eng.cache.v)
    log(f"[slice] Engine load {t_load:.2f} s: {weights / 1e9:.3f} GB of "
        f"projection planes, {kv_bytes / 1e9:.3f} GB of bf16 KV")
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    ids_a, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    eng.timings = Timings()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_port_launches()
    ids_b, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    launches = dict(Q.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    tm = eng.timings
    steps = tm.n_step                  # the blocks' steps, over-run included
    out = {"layers": n_layers, "load_s": t_load,
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": (len(ids_b) - 1) / tm.t_eval,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "tokens": len(ids_b), "steps": steps}
    log(f"[slice] {n_layers} layers: prefill {prompt_len} tokens "
        f"{out['prefill_tok_s']:.1f} tok/s, decode {len(ids_b) - 1} tokens "
        f"({steps} steps in graph blocks) {out['decode_tok_s']:.2f} tok/s, "
        f"peak memory {out['peak_mem_gb']:.3f} GB, launches {launches}")
    if ids_a != ids_b:
        raise AssertionError("two greedy runs on the card disagree")
    per_pass = 4 * n_layers + 1
    expect_launches("slice", {"qmm": per_pass, "qmm_int8": per_pass * steps})
    log(f"[slice] launch counts as expected: qmm {per_pass} for the ubatch, "
        f"qmm_int8 {per_pass} per decode step x {steps}; two runs gave the "
        "same tokens")
    check_against_eager(eng, "slice", ids_b, prompt_len, "step")
    if device.type == "cuda":
        base = int(eng.n_past[0])
        out["decode_one_ms"] = wall_ms(lambda: eng.decode_one(0, 5))
        eng.rollback(0, base)
        log(f"[slice] decode_one (one graph replay, logits copied back): "
            f"{out['decode_one_ms']:.3f} ms a step, no profiler")
        out.update(profile_steps(
            eng, "block", lambda: (eng.rollback(0, base),
                                   eng.decode_batch_fast({0: 5}, 16)),
            steps=2, per=16))
        out.update(profile_steps(eng, "decode", lambda: eng.decode_one(0, 5)))
        out.update(profile_steps(
            eng, "prefill", lambda: (eng.reset_slot(0), eng.prefill(0, prompt)),
            steps=1))
    out.update(graph_report(eng, "slice"))
    del eng
    if keep:
        out["path"] = path
    else:
        os.remove(path)
    return out


# -- slice 11: the decode blocks as CUDA graphs -------------------------------
def eager_block(eng, path: str, slots, tok, pos, act, n_steps: int,
                temp=None, top_k: int = 40, seed: int = 0) -> np.ndarray:
    """The reference of a block: the step its graph captured (the (B, 1)
    forward, or the megakernel step, then the sampler), called eagerly
    n_steps times from the same inputs, with its own buffers and, where it
    samples, its own generator seeded `seed` -> (n_steps, B) tokens. Its
    launches run eagerly and are counted."""
    B = len(tok)
    act = np.asarray(act, bool)
    temp = (np.zeros(B, np.float32) if temp is None
            else np.asarray(temp, np.float32))
    bufs = DG.StepBuffers(B, eng.device)
    if np.all(temp[act] <= 0.0):
        sample = DG.greedy
    else:
        gen = torch.Generator(device=eng.device)
        gen.manual_seed(seed)
        sample = DG.top_k_sampler(bufs, top_k, gen)
    if path == "mega":
        body = DG.mega_step(eng, MD.mega_decode_layers, bufs,
                            eng._mega_span(n_steps), slots, sample)
    else:
        body = DG.forward_step(eng, forward, bufs, eng._kv_span(n_steps),
                               slots, sample)
    bufs.stage(tok, pos, pos, act, temp)
    with torch.no_grad():
        for _ in range(n_steps):
            body()
    return bufs.out[1:1 + n_steps].cpu().numpy()


def check_against_eager(eng, label: str, ids: list, start0: int, path: str,
                        steps: int = 32) -> None:
    """Hold a generate_fast run's tokens (its first token at position
    start0) against eager_block from the same cache: the slot is rolled
    back to start0, the reference runs `steps` steps, and the slot is
    rolled back again."""
    eng.rollback(0, start0)
    ref = eager_block(eng, path, 0, [ids[0]], [start0], [1], steps)[:, 0]
    eng.rollback(0, start0)
    n = min(steps, len(ids) - 1)
    same = [int(t) for t in ref[:n]] == ids[1:1 + n]
    log(f"[{label}] the graph block's first {n} tokens "
        f"{'equal' if same else 'DIFFER FROM'} {n} eager steps of the same "
        "step")
    if not same:
        raise AssertionError(f"{label}: graph tokens {ids[1:1 + n]} != eager "
                             f"{ref[:n].tolist()}")


def wall_ms(call, n: int = 8) -> float:
    """Host wall ms of one call, over n calls after one more (which may
    capture a graph), with no profiler attached."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def graph_report(eng, label: str) -> dict:
    """Capture seconds, number of graphs and pool memory of an engine."""
    g = eng.graphs
    out = {"graphs": len(g.graphs), "capture_s": g.capture_s,
           "pool_mb": g.pool_bytes() / 2 ** 20}
    log(f"[{label}] decode graphs: {out['graphs']} captured in "
        f"{out['capture_s']:.2f} s, pool {out['pool_mb']:.1f} MiB "
        f"(keys {sorted(map(str, g.graphs))})")
    return out


def profile_steps(eng, label: str, step, steps: int = 4,
                  per: int = 1) -> dict:
    """torch.profiler over `steps` calls of `step`, each `per` decode
    steps: wall ms per decode step, the device's busy share (kernel time /
    wall), kernel launches and graph launches, the top ops by device time
    (and every kernel of the port's csrc) and by host time."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps / per
    events = prof.key_averages()
    from torch.autograd import DeviceType

    def dev_us(e):
        return e.self_device_time_total
    # kernel rows only: an operator's row repeats its kernels' time
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e3 / steps / per

    def calls(*keys):
        return sum(e.count for e in events if e.key in keys) / steps / per
    launches = calls("cudaLaunchKernel", "cudaLaunchCooperativeKernel")
    graphs = calls("cudaGraphLaunch")
    steps = steps * per
    log(f"[profile] {label}: {wall:.3f} ms wall per step, device busy "
        f"{busy:.3f} ms ({busy / wall:.1%}), {launches:g} kernel launches "
        f"(cudaLaunchKernel + cudaLaunchCooperativeKernel) and {graphs:g} "
        "graph launches (cudaGraphLaunch) per step")
    # the port's own kernels (csrc/), by entry name: ms and launches a step
    port = {}
    for e in kern:
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", e.key)
        if m:
            ms, n = port.get(m.group(1), (0.0, 0))
            port[m.group(1)] = (ms + dev_us(e) / 1e3 / steps, n + e.count // steps)
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    ranked = sorted(kern, key=dev_us, reverse=True)
    # the top 8, then the port's own kernels (csrc/, anonymous namespaces)
    # that ran fewer ms
    for e in ranked[:8] + [e for e in ranked[8:]
                           if "(anonymous namespace)" in e.key]:
        log(f"[profile] {label} kernel {dev_us(e) / 1e3 / steps:9.3f} ms/step "
            f"x{e.count // steps:<5d} {e.key[:90]}")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[profile] {label} host   {e.self_cpu_time_total / 1e3 / steps:9.3f}"
            f" ms/step x{e.count // steps:<5d} {e.key[:90]}")
    return {f"{label}_wall_ms": wall, f"{label}_busy_ms": busy,
            f"{label}_port_ms": port, f"{label}_kernel_launches": launches,
            f"{label}_graph_launches": graphs}


def phase_numerics(device, rng, shape=LLAMA_7B, prompt_len: int = 64,
                   steps: int = 8) -> dict:
    """2-layer full-width model: GPU engine against the CPU plain path."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "llama7b_shape_q4_0_2l.gguf")
    write_llama_gguf(path, 2, rng, **shape)
    gpu = Engine(path, n_ctx=2048, device=device)
    cpu = Engine(path, n_ctx=2048, device="cpu")
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    a, b = gpu.prefill(0, prompt), cpu.prefill(0, prompt)
    if not (np.isfinite(a).all() and a.shape == (shape["vocab"],)):
        raise AssertionError("prefill logits not finite / misshapen")
    cos_prefill = cosine(a, b)
    cos_dec = []
    tok = int(np.argmax(b))
    for _ in range(steps):
        a, b = gpu.decode_one(0, tok), cpu.decode_one(0, tok)
        if not np.isfinite(a).all():
            raise AssertionError("decode logits not finite")
        cos_dec.append(cosine(a, b))
        tok = int(np.argmax(b))
    log(f"[numerics] 2 layers, prefill {prompt_len} tokens: last-position "
        f"logit cosine GPU vs CPU {cos_prefill!r} (>= 0.999); "
        f"{steps} teacher-forced decode steps: min cosine "
        f"{min(cos_dec)!r} (>= 0.99)")
    if not cos_prefill >= 0.999:
        raise AssertionError(f"prefill cosine {cos_prefill} < 0.999")
    if not min(cos_dec) >= 0.99:
        raise AssertionError(f"decode cosine {min(cos_dec)} < 0.99")
    del gpu, cpu
    os.remove(path)
    return {"cos_prefill": cos_prefill, "cos_decode_min": min(cos_dec)}


# -- slice 4: the measurement harness and the batched decode path -------------
def run_tool(label: str, main, argv: list[str]) -> str:
    """Run a tool's entry point (its main(argv)), log what it printed and
    raise unless it returned 0; returns its standard output."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[{label}] {line}")
    log(f"[{label}] ran in {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{label} {' '.join(argv)} returned {rc}")
    return text


def port_launches() -> dict:
    return {**Q.LAUNCHES, **FA.LAUNCHES, **FF.LAUNCHES, **MD.LAUNCHES,
            **SC.LAUNCHES}


def reset_port_launches() -> None:
    for mod in (Q, FA, FF, MD, SC):
        mod.reset_launches()


def expect_launches(what: str, want: dict) -> dict:
    """Raise unless the port's launch counts are exactly `want` (every
    other kernel 0); returns them."""
    got = port_launches()
    full = {**{k: 0 for k in got}, **want}
    if got != full:
        raise AssertionError(f"{what}: launch counts {got} != {full}")
    return got


def count_dtoh(prof) -> int:
    """Device-to-host copies in a torch.profiler run."""
    return sum(e.count for e in prof.key_averages() if "DtoH" in e.key)


def phase_harness(device, rng, path: str, n_layers: int, ceiling_gbs: float,
                  pls=(1, 4, 8), n_pp: int = 128, n_tg: int = 32,
                  n_ctx: int = 512, pp: int = 512, tg: int = 128,
                  reps: int = 2, roofline_predict: int = 64,
                  bench_shape=None, mm_shape=None) -> dict:
    """Slice 4 at full width on the phase-4 model: the tools' entry points
    (tpulamm_torch.bench, the perf_report matmul table, cli.bench pp/tg and
    --batched, decode_roofline at the measured streaming ceiling), each
    with its launch counts. Inside the --batched run every
    decode_batch_fast block is checked: exactly qmm_int8, 4 n_layers + 1 a
    step; at pl 4 the block's greedy tokens against a host loop of
    decode_batch, and a profile of one block (no device-to-host copy a
    step)."""
    from tpulamm_torch import bench
    from tpulamm_torch.cli import bench as cli_bench
    from tpulamm_torch.tools import decode_roofline, perf_report
    out = {}
    dev = str(device)
    per_pass = 4 * n_layers + 1
    reset_port_launches()
    if bench_shape is None:
        line = run_tool("bench", bench.main, ["--device", dev])
        expect_launches("bench", {"qmm": 11 + 2})
        out["bench"] = json.loads(line.strip().splitlines()[-1])
    else:                                  # a CPU rehearsal at a small shape
        out["bench"] = bench.run(shape=bench_shape, device=device)
    reset_port_launches()
    if mm_shape is None:
        out["matmul_table"] = run_tool("perf_report", perf_report.main,
                                       ["--device", dev])
        expect_launches("perf_report", {"qmm": 6 * (20 + 2)})
    else:
        out["matmul"] = {q: perf_report.bench_matmul(q, shape=mm_shape,
                                                     device=device)
                         for q in perf_report.FORMATS}
    reset_port_launches()
    out["cli_bench"] = run_tool("cli.bench", cli_bench.main, [
        "-m", path, "-p", str(pp), "-n", str(tg), "-r", str(reps),
        "-o", "json", "--device", dev])
    # each rep (and the warm-up one): a prefill ubatch (qmm); then for tg a
    # 1-token prefill and a block of warm-up (n_predict 2: 16 steps), a
    # 1-token prefill, and generate_fast's 1-token prefill and its blocks
    # for tg - 1 tokens (qmm_int8)
    tg_steps = 3 + DG.pick_block(1, 2048) + DG.pick_block(tg - 1, 2048)
    expect_launches("cli.bench pp/tg", {
        "qmm": per_pass * (reps + 1),
        "qmm_int8": per_pass * (reps + 1) * tg_steps})
    out["blocks"] = blocks = {}
    orig = Engine.decode_batch_fast

    def checked(eng, toks, n_steps, **kw):
        """decode_batch_fast as cli.bench --batched calls it (a warm-up
        block, then the timed one, for each pl), with its launches counted
        a block; after the warm-up block at pl 4, the host-loop comparison
        and the profile, each followed by the engine state the block left."""
        pl = len(toks)
        reset_port_launches()
        t0 = time.perf_counter()
        res = orig(eng, toks, n_steps, **kw)
        dt = time.perf_counter() - t0
        expect_launches(f"decode_batch_fast pl={pl}",
                        {"qmm_int8": per_pass * n_steps})
        if not all(0 <= t < eng.cfg.vocab_size for v in res.values()
                   for t in v):
            raise AssertionError("decode_batch_fast tokens out of range")
        rows = eng._b_rows(toks) or eng.n_slots
        log(f"[harness] decode_batch_fast pl={pl} ({rows} rows): {n_steps} "
            f"steps in {dt:.3f} s, {pl * n_steps / dt:.1f} tok/s aggregate; "
            f"launches qmm_int8 {per_pass} x {n_steps}, nothing else")
        if pl in blocks:                                   # the timed block
            blocks[pl]["tok_s"] = pl * n_steps / dt
            return res
        blocks[pl] = {"rows": rows, "warm_tok_s": pl * n_steps / dt}
        if pl == 4:
            start = {s: int(eng.n_past[s]) - n_steps for s in toks}
            for s in toks:
                eng.rollback(s, start[s])
            host, c = {s: [] for s in toks}, dict(toks)
            for _ in range(n_steps):
                lg = eng.decode_batch(c)
                c = {s: int(np.argmax(lg[s])) for s in c}
                for s in c:
                    host[s].append(c[s])
            if host != res:
                raise AssertionError("decode_batch_fast greedy tokens differ "
                                     "from the decode_batch host loop")
            log(f"[harness] pl=4: decode_batch_fast tokens == {n_steps} steps "
                "of the decode_batch host loop")
            for s in toks:
                eng.rollback(s, start[s])
            b, tok, pos, act = eng._block_inputs(toks, n_steps, "reference")
            ref = eager_block(eng, "step", None, tok, pos, act, n_steps)
            for s in toks:
                eng.rollback(s, start[s])
            if {s: [int(t) for t in ref[:, s]] for s in toks} != res:
                raise AssertionError("decode_batch_fast tokens differ from "
                                     "the eager steps of its graph")
            log(f"[harness] pl=4: decode_batch_fast tokens == {n_steps} eager "
                f"steps of its graph's step ({b} rows)")
            graph_report(eng, "harness")
            reset_port_launches()
            orig(eng, toks, n_steps, **kw)
            expect_launches("decode_batch_fast pl=4, again",
                            {"qmm_int8": per_pass * n_steps})
            if device.type == "cuda":
                from torch.profiler import ProfilerActivity, profile
                for s in toks:
                    eng.rollback(s, start[s])
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    orig(eng, toks, n_steps, **kw)
                    wall = time.perf_counter() - t0
                dtoh = count_dtoh(prof)
                busy = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
                log(f"[profile] decode_batch_fast pl=4 block of {n_steps} "
                    f"steps: {wall * 1e3:.1f} ms wall, device busy "
                    f"{busy / 1e3:.1f} ms ({busy / 1e3 / (wall * 1e3):.1%}), "
                    f"{dtoh} device-to-host copies")
                if not 1 <= dtoh < n_steps:
                    raise AssertionError(f"{dtoh} device-to-host copies in a "
                                         f"block of {n_steps} steps")
                out.update(block_steps=n_steps, block_wall_ms=wall * 1e3,
                           block_busy_ms=busy / 1e3,
                           block_dtoh=dtoh)
        return res

    Engine.decode_batch_fast = checked
    try:
        out["cli_batched"] = run_tool("cli.bench --batched", cli_bench.main, [
            "-m", path, "--batched", "-p", str(n_pp), "-n", str(n_tg),
            *[a for pl in pls for a in ("-pl", str(pl))], "-c", str(n_ctx),
            "-o", "json", "--device", dev])
    finally:
        Engine.decode_batch_fast = orig
    if sorted(blocks) != sorted(pls):
        raise AssertionError(f"decode_batch_fast ran for pl {sorted(blocks)}")
    reset_port_launches()
    out["roofline"] = run_tool("decode_roofline", decode_roofline.main, [
        "-m", path, "--span", "512", "--n-predict", str(roofline_predict),
        "--bw-gbs", f"{ceiling_gbs:.1f}", "--device", dev])
    if {k for k, v in port_launches().items() if v} != {"qmm_int8"}:
        raise AssertionError(f"decode_roofline launches {port_launches()}")
    return out


def phase_batch_numerics(device, rng, shape=LLAMA_7B, n_slots: int = 3,
                         prompt_len: int = 32, steps: int = 8) -> dict:
    """2 layers at full width, 3 slots: decode_batch on the card against
    the CPU's plain path over teacher-forced steps (cosine >= 0.99 a slot),
    then decode_batch_sampled at temp 0 with penalty_repeat 1.3 on the card
    against decode_batch + the host Sampler on the card (equal tokens)."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, "llama7b_shape_q4_0_2l_batch.gguf")
    write_llama_gguf(path, 2, rng, **shape)
    gpu = Engine(path, n_ctx=512, n_slots=n_slots, device=device)
    cpu = Engine(path, n_ctx=512, n_slots=n_slots, device="cpu")
    cur, prompts = {}, {}
    for s in range(n_slots):
        prompts[s] = rng.integers(3, shape["vocab"],
                                  size=prompt_len + 5 * s).tolist()
        gpu.prefill(s, prompts[s])
        cur[s] = int(np.argmax(cpu.prefill(s, prompts[s])))
    cos = []
    for _ in range(steps):
        a, b = gpu.decode_batch(cur), cpu.decode_batch(cur)
        for s in cur:
            if not (np.isfinite(a[s]).all() and a[s].shape == (shape["vocab"],)):
                raise AssertionError("decode_batch logits not finite / misshapen")
            cos.append(cosine(a[s], b[s]))
        cur = {s: int(np.argmax(b[s])) for s in cur}
    log(f"[batch-numerics] 2 layers, {n_slots} slots, {steps} teacher-forced "
        f"decode_batch steps: min cosine card vs CPU {min(cos)!r} (>= 0.99)")
    if not min(cos) >= 0.99:
        raise AssertionError(f"decode_batch cosine {min(cos)} < 0.99")

    params = SamplingParams(temp=0.0, penalty_repeat=1.3)

    def samplers():
        out = {}
        for s in cur:
            smp = Sampler(params, shape["vocab"], eos_id=2, nl_id=13)
            for t in prompts[s] + [cur[s]]:
                smp.accept(t, apply_grammar=False)
            out[s] = smp
        return out
    start = {s: int(gpu.n_past[s]) for s in cur}
    host, c, smp = {s: [] for s in cur}, dict(cur), samplers()
    for _ in range(steps):
        lg = gpu.decode_batch(c)
        for s in c:
            c[s] = smp[s].sample(lg[s])
            smp[s].accept(c[s])
            host[s].append(c[s])
    for s in cur:
        gpu.rollback(s, start[s])
    got = gpu.decode_batch_sampled(cur, steps, samplers())
    log(f"[batch-numerics] decode_batch_sampled (temp 0, penalty_repeat 1.3) "
        f"{steps} steps: {'equal to' if got == host else 'DIFFERENT from'} "
        "decode_batch + host Sampler")
    if got != host:
        raise AssertionError(f"decode_batch_sampled {got} != host {host}")
    # the greedy and the sampled block graph against the eager steps of
    # their step, the same seed; a reseeded block repeats, another seed not
    for temp in (0.0, 0.9):
        for s in cur:
            gpu.rollback(s, start[s])
        got = gpu.decode_batch_fast(cur, 2 * steps, temp=temp, seed=5)
        for s in cur:
            gpu.rollback(s, start[s])
        b, tok, pos, act = gpu._block_inputs(cur, 2 * steps, "reference")
        ref = eager_block(gpu, "step", None, tok, pos, act, 2 * steps,
                          temp=np.where(act, temp, 0.0), seed=5)
        for s in cur:
            gpu.rollback(s, start[s])
        again = gpu.decode_batch_fast(cur, 2 * steps, temp=temp, seed=5)
        for s in cur:
            gpu.rollback(s, start[s])
        other = gpu.decode_batch_fast(cur, 2 * steps, temp=temp, seed=6)
        ok = ({s: [int(t) for t in ref[:, s]] for s in cur} == got == again
              and (temp == 0.0) == (other == got))
        log(f"[batch-numerics] decode_batch_fast temp {temp}, {2 * steps} "
            f"steps: graph tokens {'equal' if ok else 'DIFFER FROM'} the "
            "eager steps (seed 5); seed 5 again gives the same, seed 6 "
            f"{'the same' if other == got else 'others'}")
        if not ok:
            raise AssertionError(f"decode_batch_fast temp {temp}: graph {got}"
                                 f", eager {ref.T.tolist()}, again {again}, "
                                 f"seed 6 {other}")
    graph_report(gpu, "batch-numerics")
    del gpu, cpu
    os.remove(path)
    return {"cos_min": min(cos)}


# what the decode paths were predicted to do on CUDA graphs, written before
# the graphs' first chip run (PERF.md section 5): tok/s, or ms a step
GRAPH_PREDICTIONS = {
    "default generate_fast": "80-110 tok/s",
    "megakernel generate_fast": "220-240 tok/s",
    "fused FFN + inkq decode_one": "11-13 ms a step",
    "16k generate_fast": "75-90 tok/s",
    "batched pl 1 / 4 / 8": "85-110 / 300-400 / 550-750 tok/s",
}


def decode_summary(sl: dict, oi: dict, lc: dict, hs: dict) -> None:
    """One line for each decode path: tok/s (or ms a step), the profiled
    wall and device ms a step of its graph replays, beside the prediction."""
    def prof(d, label):
        return (f"{d[label + '_wall_ms']:.3f} ms wall, "
                f"{d[label + '_busy_ms']:.3f} ms busy a step (profiled)")
    bl = hs["blocks"]
    rows = [
        ("default generate_fast", f"{sl['decode_tok_s']:.2f} tok/s; "
         f"decode_one {sl['decode_one_ms']:.3f} ms", prof(sl, "block")),
        ("megakernel generate_fast", f"{oi['mega_decode_tok_s']:.2f} tok/s; "
         f"_mega_step {oi['mega_step_ms']:.3f} ms", prof(oi, "mega_block")),
        ("fused FFN + inkq decode_one",
         f"{1e3 / oi['fused_decode_tok_s']:.3f} ms a step", prof(oi, "fused")),
        ("16k generate_fast", f"{lc['decode_tok_s']:.2f} tok/s with its "
         f"capture, a 64-step block {1e3 / lc['block_ms']:.2f} tok/s",
         prof(lc, "decode16k_block")),
        ("batched pl 1 / 4 / 8", " / ".join(
            f"{bl[pl]['tok_s']:.1f}" for pl in sorted(bl)) + " tok/s",
         f"pl 4 block {hs['block_wall_ms'] / hs['block_steps']:.3f} ms wall,"
         f" {hs['block_busy_ms'] / hs['block_steps']:.3f} ms busy a step "
         "(profiled)"),
    ]
    for name, got, where in rows:
        log(f"[decode-paths] {name}: {got}; {where}; predicted "
            f"{GRAPH_PREDICTIONS[name]}")


def kernels_line(stats: dict, launches: dict) -> str:
    meta = {
        "qmm": ("tpulamm_torch/csrc/qmm.cu", "tpulamm/ops/pallas_qmm.py:576"),
        "qmm_int8": ("tpulamm_torch/csrc/qmm_int8.cu",
                     "tpulamm/ops/pallas_qmm.py:274"),
        "qmm_int8_inkq": ("tpulamm_torch/csrc/qmm_int8.cu",
                          "tpulamm/ops/pallas_qmm.py:431"),
        "flash_attention": ("tpulamm_torch/csrc/flash_attention.cu",
                            "tpulamm/ops/flash_attention.py:129"),
        "flash_decode": ("tpulamm_torch/csrc/flash_attention.cu",
                         "tpulamm/ops/flash_attention.py:266"),
        "ffn_fused": ("tpulamm_torch/csrc/ffn_fused.cu",
                      "tpulamm/ops/pallas_ffn.py:188"),
        "mega_decode": ("tpulamm_torch/csrc/mega_decode.cu",
                        "tpulamm/ops/pallas_decode.py:345"),
        "stream_reduce": ("tpulamm_torch/csrc/stream_reduce.cu",
                          "tpulamm/tools/stream_ceiling.py:28"),
    }
    out = []
    for name, (src, rep) in meta.items():
        s = stats[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[name],
                    "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                    "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                    "bound_by": ("bytes" if s["bytes_ms"] >= s["ops_ms"]
                                 else "operations"),
                    "library_ms": s["library_ms"]})
    return json.dumps({"kernels": out})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    smi, kind = phase_device()

    def done(tag):
        log(f"[{tag}] done ({time.perf_counter() - t_start:.0f} s elapsed)")
    phase_build()
    done("build")
    stats = phase_kernels(device, rng)
    done("kernels")
    stats.update(phase_flash(device, rng))
    done("flash")
    stats.update(phase_decode_kernels(device, rng))
    done("decode kernels")
    st = phase_stream(device, rng)
    stats["stream_reduce"] = st
    done("stream")
    sl = phase_slice(device, rng, keep=True)
    done("slice")
    try:
        oi = phase_opt_in(device, rng, sl["path"], sl["layers"])
        done("opt-in")
        hs = phase_harness(device, rng, sl["path"], sl["layers"],
                           st["ceiling_gbs"])
        done("harness")
    finally:
        os.remove(sl["path"])
    lc = phase_long(device, rng)
    done("long")
    phase_numerics(device, rng)
    done("numerics")
    phase_shift(device, rng)
    done("shift")
    phase_mega_numerics(device, rng)
    done("mega numerics")
    phase_batch_numerics(device, rng)
    done("batch numerics")
    decode_summary(sl, oi, lc, hs)
    log("[kernels] qmm / qmm_int8 / qmm_int8_inkq times are sums over the "
        "five 7B shapes (qmm at M=512, the int8 gemvs at M=1), launches of "
        "qmm / qmm_int8 from the slice-1 run (phase 4); flash times at B=1 "
        "Hkv=32 hd=128 S=16385 q8 (flash_attention T=512, flash_decode "
        "T=1), launches from the long-context run (phase 4b); ffn_fused at "
        "the 7B FFN, M=1, Q4_0, launches from the decode_one steps of phase "
        "4c; mega_decode at 2 layers of LLaMA-7B width, span 1024, "
        "qmm_int8_inkq and mega_decode launches from the megakernel "
        "generate_fast run of phase 4c; stream_reduce on the 2 GiB buffer "
        "at its fastest block_rows, launches from the probe's entry point "
        "(phase 3d)")
    log(f"[device] {smi}")
    launches = {"qmm": sl["launches"]["qmm"],
                "qmm_int8": sl["launches"]["qmm_int8"],
                "qmm_int8_inkq": oi["mega_launches"]["qmm_int8_inkq"],
                "flash_attention": lc["launches"]["flash_attention"],
                "flash_decode": lc["launches"]["flash_decode"],
                "ffn_fused": oi["fused_launches"]["ffn_fused"],
                "mega_decode": oi["mega_launches"]["mega_decode"],
                "stream_reduce": st["launches"]}
    log(kernels_line(stats, launches))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
