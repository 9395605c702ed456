#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpulamm_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. device: the card's name and power limit (nvidia-smi)
  2. build: compile every CUDA kernel from tpulamm_torch/csrc (one nvcc per
     source, all at once) and report the seconds
  3. kernels against their plain versions on the card: all six formats at
     M in {1, 8, 64}, N = 1024, K = 768 (three chunks), then Q4_0 at the
     LLaMA-7B projection shapes (qmm at M = 512, qmm_int8 at M = 1), with
     error, kernel / plain / library time (CUDA events, median of 20
     launches with a cold L2) and the least time the card could take
  4. the slice at full width: a LLaMA-7B-shape Q4_0 GGUF (random blocks
     from a seed) served by Engine(n_ctx=2048) -- generate_fast on a
     512-token prompt for 128 greedy tokens, twice; the launch counts of
     the second run must be 129 qmm (one ubatch) and 129 qmm_int8 per
     decode step, and both runs must give the same tokens
  5. end-to-end numerics: the same width at 2 layers, the GPU engine
     against the port's plain path on the CPU (last prefill logits cosine
     >= 0.999; 8 teacher-forced decode steps cosine >= 0.99, the int8
     activations being the difference)
Then one JSON line of the kernels and, last, the {"ok": true, ...} line.

Without CUDA it prints no result and exits with 1. It imports nothing of
JAX and nothing of the tpulamm package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGML_TYPE_SIZES, GGMLType
from tpulamm_torch.gguf.writer import GGUFWriter
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.runtime.engine import Engine, Timings

SEED = 1234
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tmp_smoke")                     # gitignored

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS = 989e12
PEAK_INT8_OPS = 1979e12

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
           GGMLType.Q8_0, GGMLType.Q2_K]
# LLaMA-7B projections as the engine runs them (N, K): fused QKV, wo,
# fused gate|up, down, lm head padded 32000 -> 32768
SHAPES_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096),
             "gate_up": (22016, 4096), "down": (4096, 11008),
             "lm_head": (32768, 4096)}
LLAMA_7B = dict(dim=4096, ffn=11008, n_head=32, vocab=32000)
PREFILL_M, PROMPT, N_PREDICT = 512, 512, 128
TOL_QMM, TOL_INT8 = 1e-4, 1e-5


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
def random_blocks(qtype: GGMLType, n: int, k: int, rng,
                  scale: float = 0.02 / 8) -> np.ndarray:
    """GGUF rows (n, row_bytes) of random codes with fp16 scales near
    `scale` (and mins near -8 * scale where the format has them)."""
    bs, tb = GGML_TYPE_SIZES[qtype]
    nb = k // bs
    raw = np.frombuffer(rng.bytes(n * nb * tb), np.uint8).reshape(n, nb, tb).copy()

    def f16(v):
        return np.asarray(v, np.float16).view(np.uint8).reshape(n, nb, 2)
    d = scale * rng.uniform(0.5, 1.5, size=(n, nb))
    if qtype == GGMLType.Q2_K:
        raw[..., 80:82] = f16(d / 4)                       # d
        raw[..., 82:84] = f16(d / 4)                       # dmin
    else:
        raw[..., 0:2] = f16(d)
        if qtype in (GGMLType.Q4_1, GGMLType.Q5_1):
            raw[..., 2:4] = f16(-8 * d)                    # m
    return raw.reshape(n, nb * tb)


def spm_vocab(n_vocab: int) -> dict:
    """Byte-fallback SPM vocab: specials + 256 byte tokens + fillers."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    while len(tokens) < n_vocab:
        tokens.append(f"<extra_{len(tokens)}>")
        ttypes.append(1)
    return {"tokens": tokens, "token_type": ttypes,
            "scores": [0.0] * 3 + [0.0] * 256 + [-1000.0] * (n_vocab - 259)}


def write_llama_gguf(path: str, n_layers: int, rng, dim: int, ffn: int,
                     n_head: int, vocab: int) -> None:
    """A LLaMA-shape Q4_0 GGUF with random blocks (norm weights 1)."""
    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "smoke",
          "llama.context_length": 2048, "llama.embedding_length": dim,
          "llama.block_count": n_layers, "llama.feed_forward_length": ffn,
          "llama.attention.head_count": n_head,
          "llama.attention.head_count_kv": n_head,
          "llama.rope.dimension_count": dim // n_head,
          "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.vocab_size": vocab}
    for key, val in md.items():
        w.add_kv(key, val)
    voc = spm_vocab(vocab)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", voc["tokens"])
    w.add_kv("tokenizer.ggml.scores", np.asarray(voc["scores"], np.float32))
    w.add_kv("tokenizer.ggml.token_type",
             np.asarray(voc["token_type"], np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)

    def q4(name, n, k):
        w.add_tensor(name, random_blocks(GGMLType.Q4_0, n, k, rng),
                     shape=(n, k), ggml_type=GGMLType.Q4_0)

    ones = np.ones(dim, np.float32)
    q4("token_embd.weight", vocab, dim)
    w.add_tensor("output_norm.weight", ones)
    q4("output.weight", vocab, dim)
    for i in range(n_layers):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", ones)
        w.add_tensor(p + "ffn_norm.weight", ones)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output"):
            q4(p + t + ".weight", dim, dim)
        q4(p + "ffn_gate.weight", ffn, dim)
        q4(p + "ffn_up.weight", ffn, dim)
        q4(p + "ffn_down.weight", dim, ffn)
    w.write()


# -- timing ------------------------------------------------------------------
_flush_buf: dict = {}
SPIN_CYCLES = 2_000_000            # ~1 ms of the card's clock


def time_ms(fn, device, reps: int = 20) -> float:
    """Median ms of `reps` calls, each timed by CUDA events with the L2
    flushed before it (a decode step finds every weight cold). A spin
    kernel ahead of the flush keeps the card busy while the host enqueues
    the call, so a wrapper's host time does not count as device time."""
    if device.type != "cuda":                    # CPU rehearsal only
        t = []
        for _ in range(max(2, reps // 10)):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))
    buf = _flush_buf.get(device)
    if buf is None:
        buf = _flush_buf[device] = torch.empty(64 << 20, dtype=torch.float32,
                                               device=device)   # 256 MB
    fn()                                                     # warm-up
    ev = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        buf.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize(device)
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


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


def case_line(case, name, rel, t_k, t_p, t_l, t_b, t_o) -> str:
    b_ms = max(t_b, t_o)
    return (f"[kernels] {case}: {name} rel {rel:.3e} | kernel {t_k:.4f} ms "
            f"| plain {t_p:.4f} ms | library(bf16 matmul) {t_l:.4f} ms | "
            f"bound {b_ms:.4f} ms "
            f"({'bytes' if t_b >= t_o else 'operations'}) | "
            f"{b_ms / t_k:.1%} of bound")


# -- phases ------------------------------------------------------------------
def phase_device() -> tuple[str, str]:
    smi = "not available"
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
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
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels(device, rng, formats=FORMATS, small=(1024, 768),
                  small_m=(1, 8, 64), shapes=SHAPES_7B, prefill_m=PREFILL_M,
                  reps=20) -> dict:
    """Hold each kernel against its plain version and time every case;
    the sums over the 7B shapes feed the kernels line."""
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0,
                    "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                    "bytes_ms": 0.0, "ops_ms": 0.0}
             for name in ("qmm", "qmm_int8")}

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
        del qt, w_bf16
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return stats


def phase_slice(device, rng, n_layers: int = 32, shape=LLAMA_7B,
                prompt_len: int = PROMPT, n_predict: int = N_PREDICT) -> dict:
    """Serve a LLaMA-7B-shape Q4_0 model: two identical generate_fast runs,
    launch counts and speed from the second."""
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
    Q.reset_launches()
    ids_b, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    launches = dict(Q.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    tm = eng.timings
    steps = len(ids_b) - 1
    out = {"layers": n_layers, "load_s": t_load,
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": steps / tm.t_eval, "peak_mem_gb": peak / 1e9,
           "launches": launches, "tokens": len(ids_b)}
    log(f"[slice] {n_layers} layers: prefill {prompt_len} tokens "
        f"{out['prefill_tok_s']:.1f} tok/s, decode {steps} steps "
        f"{out['decode_tok_s']:.2f} tok/s, peak memory "
        f"{out['peak_mem_gb']:.3f} GB, launches {launches}")
    if ids_a != ids_b:
        raise AssertionError("two greedy runs on the card disagree")
    per_pass = 4 * n_layers + 1
    want = {"qmm": per_pass, "qmm_int8": per_pass * steps}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    log(f"[slice] launch counts as expected: qmm {per_pass} for the ubatch, "
        f"qmm_int8 {per_pass} per decode step x {steps}; two runs gave the "
        "same tokens")
    if device.type == "cuda":
        out.update(profile_steps(eng, "decode", lambda: eng.decode_one(0, 5)))
        out.update(profile_steps(
            eng, "prefill", lambda: (eng.reset_slot(0), eng.prefill(0, prompt)),
            steps=1))
    del eng
    os.remove(path)
    return out


def profile_steps(eng, label: str, step, steps: int = 4) -> dict:
    """torch.profiler over `steps` calls of `step`: wall ms per call, the
    device's busy share (kernel time / wall) and the top ops by device
    and by host time."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    from torch.autograd import DeviceType

    def dev_us(e):
        return e.self_device_time_total
    # kernel rows only: an operator's row repeats its kernels' time
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e3 / steps
    launches = sum(e.count for e in events
                   if e.key == "cudaLaunchKernel") // steps
    log(f"[profile] {label}: {wall:.3f} ms wall per call, device busy "
        f"{busy:.3f} ms ({busy / wall:.1%}), {launches} cudaLaunchKernel "
        "calls per call")
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        log(f"[profile] {label} kernel {dev_us(e) / 1e3 / steps:9.3f} ms/call "
            f"x{e.count // steps:<5d} {e.key[:90]}")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[profile] {label} host   {e.self_cpu_time_total / 1e3 / steps:9.3f}"
            f" ms/call x{e.count // steps:<5d} {e.key[:90]}")
    return {f"{label}_wall_ms": wall, f"{label}_busy_ms": busy}


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


def kernels_line(stats: dict, launches: dict) -> str:
    meta = {
        "qmm": ("tpulamm_torch/csrc/qmm.cu", "tpulamm/ops/pallas_qmm.py:576"),
        "qmm_int8": ("tpulamm_torch/csrc/qmm_int8.cu",
                     "tpulamm/ops/pallas_qmm.py:274"),
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
    phase_build()
    stats = phase_kernels(device, rng)
    log(f"[kernels] all kernels match their plain versions "
        f"({time.perf_counter() - t_start:.0f} s elapsed)")
    sl = phase_slice(device, rng)
    log(f"[slice] done ({time.perf_counter() - t_start:.0f} s elapsed)")
    phase_numerics(device, rng)
    log(f"[numerics] done ({time.perf_counter() - t_start:.0f} s elapsed)")
    log("[kernels] times are sums over the five 7B shapes (qmm at M=512, "
        "qmm_int8 at M=1); launches from the main-path run")
    log(f"[device] {smi}")
    log(kernels_line(stats, sl["launches"]))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
