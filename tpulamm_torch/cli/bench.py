"""Parametric inference benchmark on the torch engine -- llama-bench and
batched-bench parity (counterpart of tpulamm.cli.bench).

Default mode mirrors examples/llama-bench: a matrix over prompt sizes (-p)
and generation lengths (-n), reporting pp/tg tokens/s with mean and
stddev over -r repetitions, in markdown / csv / json / sql. --batched
mirrors examples/batched-bench: a (pp, tg, pl) grid where pl sequences
decode together through Engine.decode_batch_fast.

    python -m tpulamm_torch.cli.bench -m model.gguf -p 512 -n 128
    python -m tpulamm_torch.cli.bench -m model.gguf --batched -pl 1 -pl 4
    (add --device cpu to run the plain path without a GPU)

--megakernel, --fused-ffn and --int8-inkq are the Engine options that the
JAX package spells TPULAMM_MEGAKERNEL, TPULAMM_FUSED_FFN and
TPULAMM_INT8_INKQ. --tp / --dp run the engine on a mesh (every rank on
--device), and --coordinator / --num-processes / --process-id over several
processes, each starting the same command (parallel.distributed).
--profile DIR writes a torch.profiler Chrome trace.
"""

from __future__ import annotations

import argparse
import json as jsonlib
import os
import statistics
import sys
import time

import numpy as np

from tpulamm_torch.parallel.distributed import (add_distributed_args,
                                                init_from_args)
from tpulamm_torch.runtime.kvcache import KV_CACHE_TYPES


def _pp_bench(engine, n_pp: int, reps: int) -> list[float]:
    rates = []
    toks = list(np.random.default_rng(0).integers(
        3, engine.cfg.vocab_size - 1, n_pp))
    for _ in range(reps + 1):           # the first rep warms up
        engine.reset_slot(0)
        t0 = time.perf_counter()
        engine.prefill(0, toks)
        rates.append(n_pp / (time.perf_counter() - t0))
    return rates[1:]


def _tg_bench(engine, n_tg: int, reps: int, fast: bool = True) -> list[float]:
    rates = []
    for _ in range(reps + 1):
        engine.reset_slot(0)
        if fast:
            # generate_fast: the sampling stays on the device
            engine.generate_fast([1], n_predict=2, temp=0.0,
                                 stop_on_eos=False)   # warm-up
            engine.reset_slot(0)
            engine.prefill(0, [1])
            t0 = time.perf_counter()
            engine.generate_fast([1], n_predict=n_tg, temp=0.0,
                                 stop_on_eos=False)
            rates.append(n_tg / (time.perf_counter() - t0))
        else:
            engine.prefill(0, [1])
            t0 = time.perf_counter()
            tok = 2
            for _ in range(n_tg):
                logits = engine.decode_one(0, tok)
                tok = int(np.argmax(logits))
            rates.append(n_tg / (time.perf_counter() - t0))
    return rates[1:]


def _batched_bench(engine, n_pp: int, n_tg: int, n_pl: int) -> dict:
    """batched-bench: pl sequences, each pp prompt + tg gen, one batch."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for s in range(n_pl):
        engine.reset_slot(s)
        engine.prefill(s, list(rng.integers(3, engine.cfg.vocab_size - 1,
                                            n_pp)))
    t_pp = time.perf_counter() - t0
    cur = {s: 2 for s in range(n_pl)}
    engine.decode_batch_fast(cur, n_tg)             # warm-up block
    for s in range(n_pl):
        engine.rollback(s, int(engine.n_past[s]) - n_tg)
    t0 = time.perf_counter()
    engine.decode_batch_fast(cur, n_tg)
    t_tg = time.perf_counter() - t0
    return {
        "pp": n_pp, "tg": n_tg, "pl": n_pl,
        "pp_ts": n_pl * n_pp / t_pp,
        "tg_ts": n_pl * n_tg / t_tg,
        "total_ts": n_pl * (n_pp + n_tg) / (t_pp + t_tg),
    }


def _print_batched(rows: list[dict], fmt: str) -> None:
    if fmt == "json":
        print(jsonlib.dumps(rows))
    elif fmt == "csv":
        print("pp,tg,pl,pp_ts,tg_ts,total_ts")
        for r in rows:
            print(f"{r['pp']},{r['tg']},{r['pl']},{r['pp_ts']:.2f},"
                  f"{r['tg_ts']:.2f},{r['total_ts']:.2f}")
    elif fmt == "sql":
        # llama-bench.cpp sql printer parity: CREATE TABLE + INSERTs
        print("CREATE TABLE IF NOT EXISTS batched_bench "
              "(pp INTEGER, tg INTEGER, pl INTEGER, pp_ts REAL, "
              "tg_ts REAL, total_ts REAL);")
        for r in rows:
            print("INSERT INTO batched_bench "
                  "(pp, tg, pl, pp_ts, tg_ts, total_ts) VALUES "
                  f"({r['pp']}, {r['tg']}, {r['pl']}, "
                  f"{r['pp_ts']:.2f}, {r['tg_ts']:.2f}, "
                  f"{r['total_ts']:.2f});")
    else:
        print(f"| {'PP':>6} | {'TG':>6} | {'PL':>4} | {'PP t/s':>10} "
              f"| {'TG t/s':>10} | {'T t/s':>10} |")
        print("|" + "|".join(["-" * 8, "-" * 8, "-" * 6, "-" * 12,
                              "-" * 12, "-" * 12]) + "|")
        for r in rows:
            print(f"| {r['pp']:>6} | {r['tg']:>6} | {r['pl']:>4} "
                  f"| {r['pp_ts']:>10.2f} | {r['tg_ts']:>10.2f} "
                  f"| {r['total_ts']:>10.2f} |")


def _print_tests(rows: list[dict], model_name: str, fmt: str) -> None:
    if fmt == "json":
        print(jsonlib.dumps([{"model": model_name, **row} for row in rows]))
    elif fmt == "csv":
        print("model,test,t/s,stddev")
        for row in rows:
            print(f"{model_name},{row['test']},{row['t/s']:.2f},"
                  f"{row['stddev']:.2f}")
    elif fmt == "sql":
        # llama-bench.cpp sql printer parity (llama-bench.cpp:1274)
        print("CREATE TABLE IF NOT EXISTS test "
              "(model TEXT, test TEXT, avg_ts REAL, stddev_ts REAL);")
        for row in rows:
            print("INSERT INTO test (model, test, avg_ts, stddev_ts) "
                  f"VALUES ('{model_name}', '{row['test']}', "
                  f"{row['t/s']:.2f}, {row['stddev']:.2f});")
    else:
        print(f"| {'model':<28} | {'test':>8} | {'t/s':>14} |")
        print(f"| {'-' * 28} | {'-' * 8} | {'-' * 14} |")
        for row in rows:
            print(f"| {model_name:<28} | {row['test']:>8} "
                  f"| {row['t/s']:>8.2f} ± {row['stddev']:<4.2f} |")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-bench")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--n-prompt", type=int, action="append", default=[],
                   help="prompt sizes (default 512)")
    p.add_argument("-n", "--n-gen", type=int, action="append", default=[],
                   help="generation lengths (default 128)")
    p.add_argument("-r", "--repetitions", type=int, default=3)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("-o", "--output", choices=["md", "csv", "json", "sql"],
                   default="md")
    p.add_argument("--host-loop", action="store_true",
                   help="time decode_one steps with host sampling instead "
                        "of generate_fast")
    p.add_argument("--batched", action="store_true",
                   help="batched-bench mode (pp/tg/pl grid)")
    p.add_argument("-pl", "--n-parallel", type=int, action="append",
                   default=[], help="parallel sequences (batched mode)")
    p.add_argument("--compute-dtype", default=None)
    p.add_argument("-ctk", "--cache-type-k", default="bfloat16",
                   choices=KV_CACHE_TYPES)
    p.add_argument("-ctv", "--cache-type-v", default=None,
                   choices=KV_CACHE_TYPES)
    p.add_argument("--megakernel", action="store_true",
                   help="one-slot decode through the decode megakernel")
    p.add_argument("--fused-ffn", action="store_true",
                   help="decode-size FFNs through the one-launch FFN kernel")
    p.add_argument("--int8-inkq", action="store_true",
                   help="the int8 gemv quantizes inside its launch")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks of the mesh (all on --device)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel (slot-sharding) mesh dimension")
    add_distributed_args(p)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace into DIR")
    args = p.parse_args(argv)
    from tpulamm_torch.cli._common import require_file
    require_file(p, args.model)
    init_from_args(args)

    from tpulamm_torch.runtime.engine import Engine
    pps = args.n_prompt or [512]
    tgs = args.n_gen or [128]
    pls = args.n_parallel or [1, 2, 4]
    kw = dict(n_ctx=args.ctx_size, compute_dtype=args.compute_dtype,
              kv_dtype=args.cache_type_k, kv_dtype_v=args.cache_type_v,
              megakernel=args.megakernel, fused_ffn=args.fused_ffn,
              int8_inkq=args.int8_inkq, tp=args.tp, dp=args.dp,
              device=args.device)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if args.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    if args.batched:
        engine = Engine(args.model, n_slots=max(pls), **kw)
        rows = [_batched_bench(engine, pp, tg, pl)
                for pp in pps for tg in tgs for pl in pls]
        _print_batched(rows, args.output)
    else:
        engine = Engine(args.model, **kw)
        rows = []
        for n_pp in pps:
            if n_pp > args.ctx_size:
                print(f"skipping pp{n_pp}: exceeds --ctx-size "
                      f"{args.ctx_size}", file=sys.stderr)
                continue
            r = _pp_bench(engine, n_pp, args.repetitions)
            rows.append({"test": f"pp{n_pp}", "t/s": statistics.mean(r),
                         "stddev": statistics.pstdev(r)})
        for n_tg in tgs:
            if n_tg + 2 > args.ctx_size:
                print(f"skipping tg{n_tg}: exceeds --ctx-size "
                      f"{args.ctx_size}", file=sys.stderr)
                continue
            r = _tg_bench(engine, n_tg, args.repetitions,
                          fast=not args.host_loop)
            rows.append({"test": f"tg{n_tg}", "t/s": statistics.mean(r),
                         "stddev": statistics.pstdev(r)})
        _print_tests(rows, args.model.rsplit("/", 1)[-1], args.output)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        out = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(out)
        print(f"trace written to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
