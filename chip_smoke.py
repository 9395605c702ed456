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
     qmm_int8 also at M = 5, 8 and 16 and qmm at the compound verify's
     M = 20, held to their plain versions and timed with no limit), with
     error, kernel / plain / library time (CUDA events, median of 20
     launches with a cold L2) and the least time the card could take;
     the int8 gemv's and prologue's ptxas register and spill lines;
     then qmm in all six formats at the reference shape 4096x11008x128
     (M = 128) and the 7B gate|up at M = 512: the same bits twice, GFLOPS,
     the share of the 1-pass bound and of the 2-pass floor
  3b. the flash kernels against flash_attention_ref on the card at the
     FLASH_CASES (bf16 and int8 + scales K/V, hd 64/128/256, G 1/4/8, B = 2
     with different qbase, holes and shifts, a qlen = 0 row, odd S, 56
     decode rows, a first 512-token ubatch; non-causal (bert) at hd 64,
     T 64 and 512, S 1024-2049, q8 and bf16, and a decode case), each the
     same bits twice, then
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
  3e. the kernels at the mesh's shard shapes: qmm at M = 512 and qmm_int8
     at M = 1 and 16 on a LLaMA-7B tp = 2 rank's five products (QKV
     6144 x 4096, gate|up 11008 x 4096, wo 4096 x 2048, the replicated
     w_down 4096 x 11008, the head 16384 x 4096; N x K), and ffn_fused at
     M = 1 on a Mistral-7B tp = 2 rank's gate|up and down shards, each
     against its plain version at the tolerances above, timed beside it
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
     block, none a step: counted from the host's calls at the dispatcher,
     and fewer than a step's worth in the profile's device records)
  7. the HTTP server (tpulamm_torch/server/server.py) on the phase-4 model
     with 4 slots, n_ctx 2048 and a bf16 cache, over loopback HTTP: four
     concurrent greedy streamed /completion requests (prompts of 40, 200,
     500 and 1,200 tokens, 64 tokens each), each then served alone and
     held to the concurrent text token for token (a parting only at a
     near tie of the alone run, top-two gap <= 1e-2 of max|logit|); a
     streamed chat completion against the same request unstreamed; a
     sampled request with penalties twice with one seed (the same text,
     the sampled tier); a GBNF request (its text parses); /embedding; a
     cache_prompt repeat; /metrics with each decode tier > 0; then
     /embedding of a 2-layer model of the same widths against the CPU
     plain embed (cosine >= 0.999); TTFT, tok/s a request (cold or warm)
     and in aggregate, graphs and pool, the tier counters and the launches
     (qmm, qmm_int8 and flash_attention each > 0)
  4b. the long-context path at full width: a CodeLlama-7B-shape Q4_0
     GGUF (16 layers since phase 11 came, 32 before; vocab 32016, rope
     base 1e6, context 16384) served by Engine(n_ctx=16384,
     kv_dtype="q8_0") -- generate_fast on a 12,000-token prompt (24
     ubatches) for 64 greedy tokens (one block of 64 steps); the launch
     counts must be flash_attention 23 x 16, flash_decode 64 x 16, qmm 24
     x 64 and qmm_int8 64 x 64 (the lm head is dense); a profile of a
     16-step block
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
  8. the quantizer and the quality path at LLaMA-7B width (dim 4096, ffn
     11008, 32 heads, vocab 32000), cut to 1 layer (2 before phase 11
     came): the host quantizer's time, the engines' loads and an F32
     source of ~1.85 GB bound the phase; each sub-step's seconds are
     printed. A seeded F32 GGUF (normal draws, std 0.02, norms 1; written
     in a thread while the kernels build); cli.gguf_dump on it and
     cli.quantize_stats -l blk.0.attn_q in all six formats; cli.quantize
     (main) to Q8_0, Q5_1, Q5_0, Q4_1, Q4_0 and Q2_K, each file's host
     seconds and bytes, its tensor types (norms F32, output.weight Q8_0
     below 8 bits) and rows 0-63 of blk.0.attn_q equal to the numpy
     quantizer byte for byte; tools.quality_table on the card (n_ctx 512,
     2 chunks of the repository's markdown; 4 before phase 10 came, cut
     to keep the script's time): ppl, dppl, KL and top-1 of
     each format, the KL order of tests/test_quality_deltas.py held, each
     margin printed
     (Q8_0 <= 1.5 Q5_0 + 1e-4, max(Q5) < 1.5 max(Q4), Q2_K > max(Q4)), its
     launches counted a format (0 for F32; 9 qmm a 512-token ubatch in
     each block format, nothing else) and its files equal to cli.quantize's;
     compute_perplexity of one 128-token chunk of the seven files on the
     CPU's plain engine at float32 compute, the reference, and on the
     card twice: at float32 compute, where both compute one function (ppl
     within 1e-3 relative), and at the default compute, bf16 activations
     and cache (ppl within 5e-3 relative, a bound set from the readings
     on an H100: at most 3.98e-3; the CPU engine at the default rounds
     each weight to bf16 where qmm does not, so it is no reference); at
     both, top-1 agreement >= 0.99 with a near tie of the CPU's logits
     (top-two gap <= 1e-2 of max|logit|) not counted as a miss, and the
     card's launches exactly 9 qmm in a block format, none in F32, and
     nothing else; perf_report
     --skip-matmul --e2e-pattern over the six files: pp512 and tg256 a
     format, with its launches (5 ubatches x 9 qmm a file; each
     generate_fast 9 qmm_int8 a forward, its 1-token prompt and every
     decode step, nothing else)
  9. the generation surface (slice 14). 9a, right after phase 7 on the
     phase-4 model: tpulamm_torch.cli.main in process (each run loads its
     own Engine; greedy, no repeat penalty), launches counted from 0 for
     each run -- a 512-token prompt for 64 tokens with --prompt-cache, run
     twice: the second reports reusing 511 of 512 prompt tokens and gives
     the same tokens (a parting only at a near tie, top-two gap <= 1e-2 of
     max|logit| of the logits on either run's path); the first launches
     exactly 129 qmm (one ubatch) and 129 qmm_int8 a decode step, the
     second 129 qmm_int8 for its one re-evaluated token and each step,
     nothing else; -r with a substring of the first run's text (the output
     stops at the piece that completes its first occurrence); --grammar
     (the text parses); --cfg-negative-prompt with --cfg-scale 1.5 (two
     slots: exactly 258 qmm for the two prompts and 129 qmm_int8 a
     two-row step; its first 8 tokens against decode_batch logits and
     apply_guidance on the host, near ties allowed); load s, prefill and
     decode tok/s and the host sampler's ms a token of each run. 9b, after
     phase 5d: a 1-layer model of LLaMA-7B width with fill-in-the-middle
     ids; beam_search (4 beams, 16 tokens: the same sequence, score within
     1e-3), batched (-np 4 -n 32), parallel (-np 4 -ns 8: each slot
     retires a sequence and prefills the next), infill,
     passkey (n_ctx 1024, --grp-attn-n 4: the text and the exit code of
     the CPU's; on random weights a MISS), save_load_state (exit 0) and
     embedding --json (cosine >= 0.999), each on the card in process and
     on the CPU's plain path in a subprocess of its own (one thread, all
     started together), greedy choices compared with the near-tie rule;
     each tool's seconds and launches (qmm and qmm_int8 > 0 where it
     decodes)
  10. the architecture axes (slice 15), after phase 8. 10a: a
     Mixtral-8x7B-width Q4_0 model (hidden 4096, intermediate 14336, 32 / 8
     heads, vocab 32000, 8 experts of which 2 a token, rope base 1e6; random
     blocks, an F32 router) cut to 2 layers, in Engine(n_ctx=4096):
     generate_fast on a 512-token prompt for 64 greedy tokens, twice (the
     same tokens; launches of the second run exactly 53 qmm for the ubatch
     and 53 qmm_int8 a decode step: 2 x (fused QKV + wo + 24 expert
     products) + the lm head, the 8-row router dense); a profiled decode
     step against the bytes the dense MoE reads (every expert) over 3.35
     TB/s; then a 64-token prompt and 8 teacher-forced decode steps against
     the CPU plain engine (cosine >= 0.999 / 0.99). 10b: a small model
     (dim 512, ffn 1536, head dim 64 or 128, vocab 1024, 2 layers, Q4_0) of
     each family of tools.synth.FAMILIES -- gpt2, falcon, bloom, mpt, phi2,
     gemma, persimmon, starcoder2, qwen2, stablelm, gptneox, bert,
     nomic-bert -- on the
     card against the CPU plain engine (64-token prefill cosine >= 0.999, 8
     teacher-forced decode steps >= 0.99; bert: Engine.embed, mean pooled,
     of 64 tokens >= 0.999 and of 8 >= 0.99), launches exactly one qmm a
     quantized projection for the prompt and, a step, one qmm_int8 a
     projection whose N has a divisor tile >= 1024 and one qmm each other
     (the counts written out in FAMILY_PASSES; at dim 512 wo and down take
     qmm); bert (non-causal) and falcon (parallel
     residual, one KV head)
     again with flash_attn=True (flash_attention 2 for the prompt,
     flash_decode 2 a step or for bert's 8-token embedding). 10c: the BPE
     tokenizer of the gpt2 model and the WPM one of the bert model (from
     their GGUFs' synthetic vocabularies) round-trip three texts. 10d: a
     bloom-7b1-width Q4_0 model (hidden 4096, intermediate 16384, 32
     heads, vocab 250880; ALiBi, a fused biased QKV, a plain gelu FFN, the
     tied head) cut to 2 layers, in Engine(n_ctx=2048): generate_fast on a
     512-token prompt for 64 greedy tokens through its captured decode
     graphs, twice (the same tokens; exactly 9 qmm for the ubatch and 9
     qmm_int8 a step, BLOOM_LAUNCHES), a profiled decode step against the
     GGUF bytes it must read, and the card against the CPU plain engine
     (64-token prefill cosine >= 0.999, 8 decode steps >= 0.99)
  11. speculation and segments. 11a, after phase 9a on the
     phase-4 model (the target, Engine(n_ctx=2048)) with a
     TinyLlama-1.1B-width Q4_0 draft (22 layers, 32 / 4 heads, vocab
     32000, its own seed): generate_speculative_fast at k 4, greedy, 512
     tokens in and 64 out, against generate_fast's greedy tokens (a
     parting only at a near tie, top-two gap <= 1e-2 of max|logit|), its
     launches exact (the prefills' qmm; 573 qmm_int8 a cycle: 4 draft
     steps x 89, the draft's last write 88, the (1, 5) verify 129); a
     profiled cycle (one graph launch); temp 0.8 twice with one seed (the
     same tokens); the target as its own draft (a second engine over the
     same weights) and its accept rate; tok/s against generate_fast's.
     11b: generate_prompt_lookup_fast on a repetitive prompt (129
     qmm_int8 a cycle), generate_speculative_tree with n_seq_dft 2 and
     generate_lookahead, each against greedy decoding (near ties
     allowed); then, after phase 9b, at 2 layers of LLaMA-7B width:
     eval_segmented of two branches and two probes on the card against the
     CPU plain engine (cosine >= 0.999 a row; the two probes' logits
     differ). 11c: the server with 4 slots
     plain, then with --lookup-decoding and -md (the target as its own
     draft): greedy streamed text equal (near ties allowed), the spec
     counters > 0, and a mix of two greedy and two sampled slots adding at
     least one spec block that is not a draft block (a compound verify);
     then the compound verify (B 4 x 5 rows, M = 20) of the stopped
     server's engine at exactly 9 qmm a cycle, its greedy slots' tokens
     against greedy decoding of each slot's history (near ties allowed).
     11d: cli.speculative in every mode (lookup, --ondevice, -md,
     -md --ondevice, -md -np 2, --lookahead) and
     cli.gritlm, in process, at 2 layers of TinyLlama width (a 1-layer
     draft), against the CPU plain path's greedy choices
  12. mamba and llava (slice 17), after phase 10. 12a: a mamba-2.8b-width
     Q4_0 model (state-spaces/mamba-2.8b-hf: hidden 2560, d_inner 5120,
     d_state 16, d_conv 4, dt_rank 160, vocab 50280, the tied head) cut to
     16 of its 64 layers, written by tools.synth.write_mamba_gguf through
     convert_hf, in Engine(n_ctx=1024): generate_fast on a 512-token prompt
     for one 64-step block through the step graph (the state's buffers
     static), twice (the same tokens; exactly 2 qmm a layer for the
     ubatch and 2 qmm_int8 a layer and step: ssm_in and ssm_out; ssm_x,
     ssm_dt and the 50,280-row head stay dense); a profiled decode step and
     prefill, the dense head timed alone against the step; the session
     file (MAGIC-recurrent) saved and loaded back in place (the state
     equal bit for bit, the next logits within 1e-6 of max|logit|); then 2
     layers of the same widths on the card against the CPU plain engine
     (64-token prefill cosine >= 0.999, 8 teacher-forced decode steps >=
     0.99; 17 greedy tokens at float32 compute, where both compute one
     function, parting only at a near tie; at the default compute, where
     the card's steps take int8 activations, any parting is printed). 12b: a
     full-width CLIP ViT-L/14-336 mmproj (openai/clip-vit-large-patch14-
     336: hidden 1024, 23 of 24 blocks written (llava reads layer -2), 16
     heads, ffn 4096, quick_gelu; llava-1.5's mlp projector to 4096) written
     by tools.synth.write_clip_gguf twice from one seed, the second with
     llava-v1.6-vicuna-7b's image_grid_pinpoints (spatial_unpad); a
     2-layer LLaMA-7B / Vicuna-7B-width Q4_0 language model with an SPM
     vocab: the card's bf16 encode of a 336 x 336 image against the CPU's
     f32 plain encode (cosine >= MIN_CLIP_COS) with the encode times; then
     cli.llava in process on a 336 x 336 .npy image (576 embeddings) and
     on a 672 x 672 one through anyres (2,928), n_ctx 4096, 16 greedy
     tokens, each launching flash_attention exactly once a layer for each
     ubatch (text or embeddings) of a bucket >= 64 at span >= 1,024
     (LLAVA_FLASH_UBATCHES: 3 and 7), and qmm and qmm_int8. 12c:
     make_bench_model --targets padtest,llava;
     longctx_bench in process on the 2-layer LLaMA-7B-width model at n_ctx
     8192 ({einsum, flash} x {bf16, q8_0}, 64 decode steps, the flash
     runs' greedy parity against einsum reported; flash_attention and
     flash_decode launched); preset running cli.main from a YAML file;
     collect_results over the JSON lines of tpulamm_torch.bench and the
     long-context rows
  13. training and LoRA (slice 18). 13a, started before the build in a
     process of its own (it launches none of the port's kernels, and the
     script waits for it before it times any): cli.train at TinyLlama-1.1B's
     published shape (hidden 2048, intermediate 5632, 22 layers, 32 / 4
     heads, vocab 32000 from a tools.synth vocab GGUF, rope base 1e4), ctx
     512, batch 4, 8 AdamW steps on the repository's prose, f32 without
     TF32: its seconds a step (the first apart), tokens/s, TFLOP/s against
     67 and max_memory_allocated; after phase 12 its F32 file quantized
     to Q4_0 (cli.quantize) and run by generate_fast, 512 tokens in and 64
     greedy out, exactly 89 qmm for the ubatch and 89 qmm_int8 a decode
     step. 13a': 2 layers of the same width, the card against the CPU
     from one init and the same batches (batch 2 x 64): the loss within
     1e-5 relative and each gradient's cosine >= 0.99999; 3 AdamW steps,
     the card's params within 1e-5 of each tensor's max|p| of the CPU's
     AdamW fed the card's gradients (each side's own steps printed: Adam
     turns the rounding of a gradient near its eps into the sign of a
     step); 2 L-BFGS steps (lr 1.0), each loss within 1e-4 relative, the
     line-search trials of each side printed; a step with gradient
     checkpointing against the same step without (cosine >= 0.99999).
     13b: 2 layers of LLaMA-7B width, Q4_0: cli.finetune (r 8, wq and
     wv, ctx 128, -b 4, 8 steps, no kernel launched), cli.export_lora,
     then cli.main --lora and cli.main on the
     exported file, 32 greedy tokens each: the same tokens (a parting only
     at a near tie), exactly 9 qmm for the ubatch and 9 qmm_int8 a step in
     both, the patched planes equal byte for byte (any difference
     printed); 2 finetune steps (batch 1) card against CPU: the losses
     within 1e-5 relative, the first step's resolved adapter gradients
     cosine >= 0.99999, the adapters within 1e-5 of max|a| and max|b| of
     the CPU's AdamW fed the card's gradients. 13c: tools.imatrix on the
     same base over 2 chunks of 512 on the card and on the CPU: the same
     tensors and counts, the column means within 1e-5 of each tensor's
     largest; cli.quantize --imatrix with the card's file (the base to
     Q5_0) differs from the plain Q5_0 file. 13d: quality_table --train
     (10 steps, 1 chunk), passkey_train (2 steps of batch 1 over 8
     documents, then evaluate at n_ctx 8192 with --grp-attn-n 4, 1 trial)
     and spec_bench (a target and a draft of 20 steps each, 32 tokens,
     k 4: the trained pair's accept rates). The CPU sides run in a process
     of their own (4 threads) while the card's run
  14. the mesh (slice 19). 14a, on phase 4's model: Engine(tp=2) against
     Engine(tp=1) on the card: the 512-token prefill's logits (cosine >=
     MESH_COS) and a second ubatch's at span 1,024, 64 greedy tokens of
     generate_fast (equal, or parted only at a near tie), exactly 258 qmm a
     ubatch, 258 qmm_int8 a decode step and 64 flash_attention at span
     1,024, prefill / decode tok/s and event ms a step beside tp = 1's.
     14b: the server at tp 2 x dp 2 with 4 slots over loopback HTTP: four
     concurrent greedy requests, each text equal to the request served
     alone, exactly 516 qmm a prefill ubatch and 516 qmm_int8 a step, the
     /metrics tier counters. 14c, at 2 layers of the same width: the
     server CLI in two processes on the one card (--coordinator,
     --num-processes 2, tp 2 across them, gloo, the broadcast channel): a
     completion equal to the one-process tp 2 server's, then the worker
     killed and the next request answered 503 within --mh-heartbeat. 14d:
     cli.main and cli.bench with --tp 2 (main's text that of --tp 1; both
     exactly twice --tp 1's launches), and 2 layers of Mistral-7B width
     with fused_ffn at tp 2 against tp 1 (ffn_fused on each rank's shards:
     exact launches, the same greedy tokens or a near-tie parting)
Then one JSON line of the kernels and, last, the {"ok": true, ...} line.

Without CUDA it prints no result and exits with 1. It imports nothing of
JAX and nothing of the tpulamm package.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpulamm_torch.cli import gguf_dump, quantize, quantize_stats
from tpulamm_torch.cli import gritlm as GRITLM
from tpulamm_torch.cli import main as gen_main
from tpulamm_torch.cli import speculative as SC_CLI
from tpulamm_torch.cli.perplexity import compute_perplexity
from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.grammar.engine import Grammar
from tpulamm_torch.ops import ffn_fused as FF
from tpulamm_torch.ops import flash_attention as FA
from tpulamm_torch.ops import kernels
from tpulamm_torch.ops import mega_decode as MD
from tpulamm_torch.ops import qmm as Q
from tpulamm_torch.ops.layers import rms_norm
from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
from tpulamm_torch.quant import formats
from tpulamm_torch.runtime import decode_graph as DG
from tpulamm_torch.runtime import spec_tree as ST
from tpulamm_torch.runtime import speculative as TS
from tpulamm_torch.runtime.engine import Engine, Timings, forward
from tpulamm_torch.runtime.kvcache import KVCache
from tpulamm_torch.runtime.lookahead import generate_lookahead
from tpulamm_torch.runtime.sampling import (Sampler, SamplingParams,
                                           apply_guidance, apply_penalties)
from tpulamm_torch.server import server as SV
from tpulamm_torch.tools import int8_ablation as IA
from tpulamm_torch.tools import ffn_ablation as FAB
from tpulamm_torch.tools import mega_ablation as MA
from tpulamm_torch.tools import stream_ceiling as SC
from tpulamm_torch.tools import perf_report
from tpulamm_torch.tools.quality_table import build_corpus, quality_table
from tpulamm_torch.tools.profile_window import HostDtoH, count_dtoh
from tpulamm_torch.tools.mega_ablation import step as mega_call
from tpulamm_torch.tools.synth import (FAMILIES, LLAVA16_PINPOINTS,
                                       random_blocks, write_clip_gguf,
                                       write_family_gguf, write_llama_gguf,
                                       write_mamba_gguf, write_mixtral_gguf)
from tpulamm_torch.tokenizer.spm import build_tokenizer
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
# mamba-2.8b's two products that tile (phase 12a): ssm_in 2560 -> 2 x 5120
# and ssm_out 5120 -> 2560, held in phase 3 at the prefill and decode rows
MAMBA_PROJ_SHAPES = {"mamba ssm_in": (10240, 2560),
                     "mamba ssm_out": (2560, 5120)}
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
               fresh=False, causal=True):
    """Inputs of one flash-attention call (as tests/test_flash_attention.py
    builds them): the first `used` cells of each batch row live at
    positions 0..used-1 (the trash cell and the rest empty), the T queries
    at the last T of those positions; `fresh`: used = T, so qbase is 0 and
    the queries see the causal triangle of their own keys (a first
    ubatch); `shift` adds a seq_rm hole and a
    seq_add shift; `empty_row` gives batch row 1 qlen = 0; `sharp` scales
    q by 4, so that a few keys dominate each softmax and the outputs are
    near the size of v. kind "bf16": bf16 K/V; "q8": int8 codes with
    per-row f32 scales. causal: the mask the kernels run the case with
    (flash_kw); the inputs do not depend on it."""
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
    # non-causal (bert): every query sees every live key, masked by kpos
    # alone; prefill at hd 64, G 1 (T 64 and 512, q8 and bf16), a decode
    dict(hd=64, G=1, T=64, S=1024, Hkv=2, kind="bf16", fresh=True,
         causal=False),
    dict(hd=64, G=1, T=512, S=1024, Hkv=2, kind="q8", fresh=True,
         causal=False),
    dict(hd=64, G=1, T=64, S=1025, Hkv=2, kind="q8", shift=True,
         causal=False),
    dict(hd=64, G=1, T=512, S=2049, Hkv=2, kind="bf16", shift=True,
         causal=False),
    dict(hd=64, G=1, T=8, S=1024, Hkv=4, kind="q8", fresh=True,
         causal=False),
]


def flash_kw(case: dict) -> dict:
    """The kernels' keywords for a FLASH_CASES case."""
    return dict(scale=float(1.0 / np.sqrt(case["hd"])), g=case["G"],
                causal=case.get("causal", True))
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
                  batch_m=(5, 8, 16), verify_m=(20,),
                  held=MAMBA_PROJ_SHAPES, reps=20) -> dict:
    """Hold each kernel against its plain version and time every case;
    the sums over the 7B shapes feed the kernels line. Over the 7B shapes
    qmm_int8 is also held and timed at the rows of the batched decode and
    of a (1, 1+k) verify (batch_m), and qmm at those of the compound
    verify, B x (1+k) = 20 at B = 4, k = 4 (verify_m). The held shapes
    are checked and timed as the 7B ones, at prefill_m and 1 row, outside
    the sums, from generators of their own (seed SEED + 23), so that the
    later phases draw the inputs they drew without them."""
    stats = {name: {"max_abs_err": 0.0, "ms": 0.0,
                    "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                    "bytes_ms": 0.0, "ops_ms": 0.0}
             for name in ("qmm", "qmm_int8")}
    batch: dict[tuple[str, int], float] = {}
    kerns = {"qmm": (Q.qmm_cuda, Q.qmm_ref),
             "qmm_int8": (Q.qmm_int8_cuda, Q.qmm_int8_ref)}
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
    held_gens = (np.random.default_rng(SEED + 23),
                 torch.Generator(device).manual_seed(SEED + 23))
    for label, (n, k) in {**shapes, **held}.items():
        summed = label in shapes
        r, gen = (rng, None) if summed else held_gens
        qt = QTensor.from_gguf_raw(random_blocks(GGMLType.Q4_0, n, k, r),
                                   GGMLType.Q4_0, (n, k), device=device)
        w_bf16 = dequant_mm(qt, torch.bfloat16)          # library yardstick
        for name, m, kern, plain, peak in (
                ("qmm", prefill_m, Q.qmm_cuda, Q.qmm_ref, PEAK_BF16_OPS),
                ("qmm_int8", 1, Q.qmm_int8_cuda, Q.qmm_int8_ref,
                 PEAK_INT8_OPS)):
            x = torch.randn((m, k), device=device, generator=gen)
            if name == "qmm_int8":
                check_codes(x, qt)
            rel, ab = rel_err(kern(x, qt), plain(x, qt))
            note(name, rel, ab)
            t_k, t_p, t_l, t_b, t_o = time_case(kern, plain, x, qt, w_bf16,
                                                peak, device, reps)
            log(case_line(f"Q4_0 {label} M={m} N={n} K={k}", name, rel,
                          t_k, t_p, t_l, t_b, t_o))
            if not summed:
                continue
            s = stats[name]
            s["ms"] += t_k
            s["plain_ms"] += t_p
            s["library_ms"] += t_l
            s["bound_ms"] += max(t_b, t_o)
            s["bytes_ms"] += t_b
            s["ops_ms"] += t_o
        # the batched decode's and the verifies' rows: times without limit
        for name, m in ([("qmm_int8", m) for m in batch_m]
                        + [("qmm", m) for m in verify_m] if summed else []):
            kern, plain = kerns[name]
            x = torch.randn((m, k), device=device)
            if name == "qmm_int8":
                check_codes(x, qt)
            rel, ab = rel_err(kern(x, qt), plain(x, qt))
            note(name, rel, ab)
            t_m = time_ms(lambda: kern(x, qt), device, reps)
            batch[name, m] = batch.get((name, m), 0.0) + t_m
            log(f"[kernels] Q4_0 {label} M={m} N={n} K={k}: {name} rel "
                f"{rel:.3e} | kernel {t_m:.4f} ms")
        del qt, w_bf16
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for (name, m), t in batch.items():
        m0 = 1 if name == "qmm_int8" else prefill_m
        log(f"[kernels] {name} Q4_0 five 7B shapes M={m}: {t:.4f} ms, "
            f"{t / stats[name]['ms']:.2f}x the M={m0} {stats[name]['ms']:.4f}"
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
        kw = flash_kw(case)
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
    weights = sum(w.n_bytes for w in quant_weights(eng))
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
        body = DG.forward_step(eng, eng._model_forward(), bufs,
                               eng._kv_span(n_steps), slots, sample)
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
    res = card_vs_cpu(gpu, cpu, prompt, steps)
    if res["shape"] != (shape["vocab"],):
        raise AssertionError(f"prefill logits of shape {res['shape']}")
    log(f"[numerics] 2 layers, prefill {prompt_len} tokens: last-position "
        f"logit cosine GPU vs CPU {res['cos_prefill']!r} (>= 0.999); "
        f"{steps} teacher-forced decode steps: min cosine "
        f"{min(res['cos_steps'])!r} (>= 0.99)")
    del gpu, cpu
    os.remove(path)
    return {"cos_prefill": res["cos_prefill"],
            "cos_decode_min": min(res["cos_steps"])}


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


# the seconds a profile stays open after its last synchronize
PROFILE_TAIL_S = 0.05


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
                # the copies are counted twice: by the host's calls
                # (HostDtoH, which misses none) and by the device records;
                # the window stays open PROFILE_TAIL_S after the block's
                # synchronize, since the profiler drops a device record
                # that it places after the window's end, and the block's
                # one copy is its last device activity (measured by
                # tools/profile_window.py)
                for s in toks:
                    eng.rollback(s, start[s])
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             acc_events=True) as prof:
                    with HostDtoH() as host_dtoh:
                        t0 = time.perf_counter()
                        orig(eng, toks, n_steps, **kw)
                        wall = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    time.sleep(PROFILE_TAIL_S)
                dtoh = count_dtoh(prof)
                busy = sum(e.self_device_time_total
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
                log(f"[profile] decode_batch_fast pl=4 block of {n_steps} "
                    f"steps: {wall * 1e3:.1f} ms wall, device busy "
                    f"{busy / 1e3:.1f} ms ({busy / 1e3 / (wall * 1e3):.1%}), "
                    f"device-to-host copies: {host_dtoh.n} asked for by "
                    f"the host, {dtoh} in the device records")
                if not (1 <= host_dtoh.n < n_steps and dtoh < n_steps):
                    raise AssertionError(
                        f"device-to-host copies in a block of {n_steps} "
                        f"steps: {host_dtoh.n} from the host, {dtoh} in the "
                        "device records")
                out.update(block_steps=n_steps, block_wall_ms=wall * 1e3,
                           block_busy_ms=busy / 1e3,
                           block_dtoh=host_dtoh.n, block_dtoh_device=dtoh)
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


# -- slice 12: the HTTP server ------------------------------------------------
# the four concurrent greedy requests: prompt tokens (the last spans three
# 512-token ubatches, so flash_attention runs)
SERVER_PROMPTS = (40, 200, 500, 1200)
# what phase 7 was predicted to do, written before its first chip run
# (PERF.md section 5)
SERVER_PREDICTIONS = {
    "ttft": "0.08-0.2 s for the first request served, 0.5-0.9 s the last",
    "aggregate": "110-180 tok/s over the window, 200-280 decode alone",
    "alone": "90-125 tok/s a request alone",
    "sampled": "15-40% below the same prompt's greedy run alone",
}


def http(base: str, path: str, body: dict | None = None,
         timeout: float = 300) -> dict:
    """One request to the server (GET without a body); raises unless it
    answers 200 -> its JSON, or the text of /metrics."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def http_stream(base: str, path: str, body: dict, graphs=None,
                timeout: float = 300) -> dict:
    """A streamed request: its pieces (one SSE chunk a token, its piece
    possibly empty, before the chunk that finishes), the
    seconds to the first and to the last piece, and whether a decode
    graph was captured while it decoded (`graphs`: the engine's dict)."""
    req = urllib.request.Request(
        base + path, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    pieces, times, n_graphs = [], [], []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.decode()
            if not line.startswith("data: ") or "[DONE]" in line:
                continue
            obj = json.loads(line[6:])
            ch = obj["choices"][0] if "choices" in obj else None
            piece = (obj["content"] if ch is None
                     else ch.get("delta", {}).get("content", ch.get("text")))
            finish = obj["stop"] if ch is None else ch["finish_reason"]
            if finish == "error":
                raise AssertionError(f"{path}: the server failed the request")
            if not finish:                     # a token's chunk
                pieces.append(piece or "")
                times.append(time.perf_counter() - t0)
                if graphs is not None:
                    n_graphs.append(len(graphs))
    if not times:
        raise AssertionError(f"{path}: no token came back")
    return {"pieces": pieces, "ttft": times[0], "t_last": times[-1],
            "tok_s": (len(times) - 1) / max(times[-1] - times[0], 1e-9),
            "cold": bool(n_graphs) and n_graphs[-1] > n_graphs[0]}


def boot_server(path: str, device, **kw):
    """The port's server in a thread on 127.0.0.1, port 0 -> (the started
    event, with .httpd and .sched, and the base URL); raises as soon as
    the thread ends without starting the server."""
    started = threading.Event()
    th = threading.Thread(target=SV.serve, args=(path,), daemon=True,
                          kwargs=dict(host="127.0.0.1", port=0,
                                      started=started, device=device, **kw))
    th.start()
    t0 = time.perf_counter()
    while not started.wait(timeout=0.5):
        if not th.is_alive() or time.perf_counter() - t0 > 300:
            raise AssertionError("the server did not start")
    started.thread = th
    return started, f"http://127.0.0.1:{started.httpd.server_port}"


def stop_server(started) -> None:
    """Stop the scheduler and the HTTP server and wait for their threads;
    the engine is then free for the calling thread."""
    started.sched.running = False
    started.httpd.shutdown()
    started.httpd.server_close()
    started.sched.join(timeout=60)
    started.thread.join(timeout=60)
    if started.sched.is_alive() or started.thread.is_alive():
        raise AssertionError("the server's threads did not stop")


def metrics_of(base: str) -> dict:
    text = http(base, "/metrics")
    return {ln.split()[0].split(":")[1]: float(ln.split()[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def near_tie(eng, prompt: list, k: int) -> tuple[float, float]:
    """`prompt` decoded greedily alone on a stopped server's engine (slot
    0: prefill, then k decode_one steps) -> the top-two gap of the logits
    that pick token k, and their max |logit|."""
    eng.reset_slot(0)
    lg = eng.prefill(0, prompt)
    for _ in range(k):
        lg = eng.decode_one(0, int(np.argmax(lg)))
    top = np.sort(lg)[-2:]
    return float(top[1] - top[0]), float(np.abs(lg).max())


def phase_server(device, rng, path: str, n_layers: int, smi: str,
                 shape=LLAMA_7B, prompts=SERVER_PROMPTS, n_predict: int = 64,
                 n_ctx: int = 2048, n_sampled: int = 64,
                 emb_text: str = "hi there") -> dict:
    """Slice 12 at full width: the port's HTTP server with 4 slots on the
    phase-4 model, driven over loopback HTTP -- four concurrent greedy
    streamed /completion requests, each then served alone (token for
    token the same, or parting only at a near tie of the alone run:
    top-two gap <= 1e-2 of max|logit|, reissued with n_probs 2), a
    streamed chat completion against the same request unstreamed, a
    sampled request with penalties twice with one seed (the same text, the
    sampled tier), a GBNF request (its text parses), an /embedding, a
    cache_prompt repeat, the /metrics tiers; then an /embedding of a
    2-layer model of the same widths against the port's CPU plain embed
    (cosine >= 0.999; "hi there" is 14 tokens, so its projections take
    the int8 gemv, M <= 16). Launches of qmm, qmm_int8 and flash_attention must
    each be > 0."""
    reset_port_launches()
    t_phase = time.perf_counter()
    started, base = boot_server(path, device, n_slots=4, n_ctx=n_ctx,
                                cache_type_k="bfloat16")
    sched = started.sched
    eng = sched.engine
    graphs = eng.graphs.graphs
    log(f"[server] {n_layers} layers, 4 slots, n_ctx {n_ctx}, bf16 cache: "
        f"up in {time.perf_counter() - t_phase:.1f} s at {base}")
    # ignore_eos: every request runs its n_predict tokens
    greedy = {"temperature": 0.0, "repeat_penalty": 1.0,
              "n_predict": n_predict, "ignore_eos": True}
    toks = [rng.integers(3, shape["vocab"], size=n).tolist() for n in prompts]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(toks)) as ex:
        futs = [ex.submit(http_stream, base, "/completion",
                          dict(greedy, prompt=p), graphs) for p in toks]
        conc = [f.result() for f in futs]
    window = time.perf_counter() - t0
    agg = sum(len(c["pieces"]) for c in conc) / window
    first = max(c["ttft"] for c in conc)
    dec_agg = sum(len(c["pieces"]) - 1 for c in conc) / (
        max(c["t_last"] for c in conc) - first)
    for n, c in zip(prompts, conc):
        log(f"[server] concurrent, prompt {n} tokens: TTFT "
            f"{c['ttft']:.3f} s, {len(c['pieces'])} tokens, decode "
            f"{c['tok_s']:.2f} tok/s, {'cold' if c['cold'] else 'warm'} "
            f"({smi})")
    log(f"[server] aggregate over the concurrent window ({window:.3f} s, "
        f"prefills included): {agg:.2f} tok/s; decode only, from the last "
        f"first token: {dec_agg:.2f} tok/s ({smi}); predicted "
        f"{SERVER_PREDICTIONS['aggregate']}, TTFT "
        f"{SERVER_PREDICTIONS['ttft']}")
    alone = [http_stream(base, "/completion", dict(greedy, prompt=p), graphs)
             for p in toks]
    parted = []
    for n, p, c, a in zip(prompts, toks, conc, alone):
        log(f"[server] alone, prompt {n} tokens: TTFT {a['ttft']:.3f} s, "
            f"decode {a['tok_s']:.2f} tok/s, "
            f"{'cold' if a['cold'] else 'warm'} ({smi}); predicted "
            f"{SERVER_PREDICTIONS['alone']}")
        if len(c["pieces"]) != n_predict or len(a["pieces"]) != n_predict:
            raise AssertionError(f"prompt {n}: {len(c['pieces'])} / "
                                 f"{len(a['pieces'])} tokens, not {n_predict}")
        if c["pieces"] != a["pieces"]:
            k = next(i for i, (x, y) in enumerate(zip(c["pieces"],
                                                      a["pieces"])) if x != y)
            probs = http(base, "/completion", dict(greedy, prompt=p,
                                                   n_probs=2))
            step = probs["completion_probabilities"][k]
            log(f"[server] prompt {n}: concurrent and alone part at token "
                f"{k}; n_probs 2 there: {step['probs']}")
            parted.append((n, p, k, c["pieces"][k], a["pieces"][k]))
    log(f"[server] greedy: {len(prompts) - len(parted)} of {len(prompts)} "
        "concurrent completions equal the same request served alone, token "
        "for token")

    chat = {"messages": [{"role": "user", "content": "Say something."}],
            "max_tokens": 16, "temperature": 0.0, "repeat_penalty": 1.0}
    whole = http(base, "/v1/chat/completions", chat)
    streamed = http_stream(base, "/v1/chat/completions", chat)
    text = whole["choices"][0]["message"]["content"]
    same = "".join(streamed["pieces"]) == text
    log(f"[server] chat: streamed chunks {'equal' if same else 'DIFFER FROM'}"
        f" the unstreamed text ({whole['usage']})")
    if not same:
        raise AssertionError(f"chat: streamed {streamed['pieces']} != "
                             f"{text!r}")

    m0 = metrics_of(base)
    sampled = {"prompt": toks[0], "n_predict": n_sampled, "temperature": 0.8,
               "repeat_penalty": 1.1, "top_p": 0.9, "seed": 1234,
               "ignore_eos": True}
    s1 = http_stream(base, "/completion", sampled, graphs)
    s2 = http_stream(base, "/completion", sampled, graphs)
    m1 = metrics_of(base)
    # the same prompt greedy, now that its graph is warm
    g2 = http_stream(base, "/completion", dict(greedy, prompt=toks[0],
                                               n_predict=n_sampled), graphs)
    same = s1["pieces"] == s2["pieces"]
    n_blocks = (m1["decode_sampled_blocks_total"]
                - m0["decode_sampled_blocks_total"])
    log(f"[server] sampled (temp 0.8, repeat_penalty 1.1, top_p 0.9, seed "
        f"1234) twice: {'the same' if same else 'DIFFERENT'} text; decode "
        f"{s1['tok_s']:.2f} ({'cold' if s1['cold'] else 'warm'}) / "
        f"{s2['tok_s']:.2f} ({'cold' if s2['cold'] else 'warm'}) tok/s "
        f"against {g2['tok_s']:.2f} greedy ({'cold' if g2['cold'] else 'warm'}"
        f") ({smi}); {n_blocks:g} "
        f"sampled blocks; predicted {SERVER_PREDICTIONS['sampled']}")
    if not same or len(s1["pieces"]) != n_sampled:
        raise AssertionError("sampled: one seed gave two texts")
    if not n_blocks > 0:
        raise AssertionError("sampled: the sampled tier did not run")

    gbnf = "root ::= [a-z ]+\n"
    t1 = time.perf_counter()
    g = http(base, "/completion", {"prompt": "the cat", "n_predict": 8,
                                   "temperature": 0.0, "grammar": gbnf})
    gr = Grammar.from_gbnf(gbnf)
    for ch in g["content"]:
        gr.accept_token(ch.encode())
    log(f"[server] GBNF {gbnf.strip()!r}: {g['content']!r} in "
        f"{time.perf_counter() - t1:.2f} s ({g['tokens_predicted']} tokens, "
        "the host grammar over every piece); it parses")
    if not (g["content"] and gr.can_stop()):
        raise AssertionError(f"GBNF: {g['content']!r} does not parse")

    emb = np.asarray(http(base, "/embedding", {"content": emb_text})[
        "embedding"])
    if not (emb.shape == (shape["dim"],) and np.isfinite(emb).all()):
        raise AssertionError(f"/embedding: shape {emb.shape} or not finite")

    cp = {"prompt": toks[1], "n_predict": 8, "temperature": 0.0,
          "repeat_penalty": 1.0, "cache_prompt": True}
    http(base, "/completion", cp)
    c0 = metrics_of(base)
    http(base, "/completion", cp)
    mt = metrics_of(base)
    cached = (mt["prompt_cached_tokens_total"]
              - c0["prompt_cached_tokens_total"])
    log(f"[server] cache_prompt repeat of the {prompts[1]}-token prompt: "
        f"{cached:g} prompt tokens from the cache")
    if not cached >= prompts[1] - 1:
        raise AssertionError(f"cache_prompt: {cached} cached tokens")
    tiers = {k: mt[f"decode_{k}_total"]
             for k in ("fast_blocks", "sampled_blocks", "slow_steps")}
    log(f"[server] /metrics: {tiers}, prompt tokens "
        f"{mt['prompt_tokens_total']:g}, cached "
        f"{mt['prompt_cached_tokens_total']:g}, predicted "
        f"{mt['tokens_predicted_total']:g}")
    if not all(v > 0 for v in tiers.values()):
        raise AssertionError(f"a decode tier did not run: {tiers}")
    stop_server(started)
    launches = port_launches()           # the 32-layer server's traffic
    gr_out = graph_report(eng, "server")
    if device.type == "cuda":
        # a step of the concurrent window: the four prompts' slots at their
        # lengths, one 8-step block at B = 4 (the multi-slot block length)
        for i, p in enumerate(toks):
            eng.reset_slot(i)
            eng.prefill(i, p)
        carry = {i: 5 for i in range(len(toks))}
        start = {i: int(eng.n_past[i]) for i in carry}

        def block():
            for i in carry:
                eng.rollback(i, start[i])
            eng.decode_batch_fast(carry, 8)
        gr_out.update(profile_steps(eng, "server_b4", block, steps=2, per=8))
    for n, p, k, got, want in parted:
        gap, big = near_tie(eng, p, k)
        log(f"[server] prompt {n}: at token {k} ({got!r} concurrent, "
            f"{want!r} alone) the top-two logits are {gap:.3e} apart, "
            f"{gap / big:.3e} of max|logit| (a near tie at <= 1e-2)")
        if not gap <= 1e-2 * big:
            raise AssertionError(f"prompt {n}: concurrent and alone part at "
                                 f"token {k}, not at a near tie")
    del eng, sched, started, graphs

    # the /embedding against the port's CPU plain embed, at 2 layers
    p2 = os.path.join(SMOKE_DIR, "llama7b_shape_q4_0_2l_embed.gguf")
    write_llama_gguf(p2, 2, rng, **shape)
    reset_port_launches()
    started, base = boot_server(p2, device, n_slots=1, n_ctx=256)
    card = np.asarray(http(base, "/embedding", {"content": emb_text})[
        "embedding"])
    stop_server(started)
    emb_launches = {k: v for k, v in port_launches().items() if v}
    del started
    ref = Engine(p2, n_ctx=256, device="cpu").embed(emb_text)
    os.remove(p2)
    cos = cosine(card, ref)
    log(f"[server] /embedding of {emb_text!r} at 2 layers: cosine with the "
        f"CPU plain embed {cos!r} (>= 0.999)")
    if not cos >= 0.999:
        raise AssertionError(f"/embedding cosine {cos} < 0.999")
    log(f"[server] launches of the 32-layer server's traffic: {launches}; "
        f"of the 2-layer /embedding: {emb_launches}")
    for k in ("qmm", "qmm_int8", "flash_attention"):
        if not launches[k] > 0:
            raise AssertionError(f"server: {k} was not launched")
    secs = time.perf_counter() - t_phase
    log(f"[server] phase 7 took {secs:.1f} s")
    return {"launches": launches, "aggregate_tok_s": agg,
            "decode_aggregate_tok_s": dec_agg, "tiers": tiers,
            "embed_cosine": cos, **gr_out}


# -- slice 13: the quantizer and the quality path ------------------------------
# cli.quantize's targets in quality_table's order
QUALITY_FORMATS = ("q8_0", "q5_1", "q5_0", "q4_1", "q4_0", "q2_k")
# card against the CPU's plain engine at float32 compute (compute_perplexity
# over one chunk): ppl within 1e-3 relative with the card at float32
# compute, where both compute one function, and within 5e-3 at the default
# compute (bf16 activations and cache; set from the readings on an H100,
# 4.4e-4-3.98e-3 over the seven formats); top-1 agreement >= 0.99 at both,
# counting no near tie of the CPU's logits (top-two gap <= 1e-2 of
# max|logit|) as a miss
TOL_PPL, MIN_TOP1, NEAR_TIE = 1e-3, 0.99, 1e-2
TOL_PPL_DEFAULT = 5e-3
# what phase 8 was predicted to do, written before its first chip run
# (PERF.md section 5)
QUALITY_PREDICTIONS = {
    "quantize": "host seconds a file: Q8_0, Q5_1, Q5_0, Q4_1, Q4_0 3-8; "
                "Q2_K 15-30",
    "pp512": "40,000-75,000 tok/s, the formats within 20%",
    "tg256": "900-1,600 tok/s, the formats within 15%",
    "KL": "Q8_0 1e-4-1e-3 < Q5_1 <= Q5_0 (5e-3-3e-2) < Q4_1 <= Q4_0 "
          "(2e-2-1e-1) < Q2_K (0.2-1.0); |dppl| <= 5% at >= 4 bits, Q2_K "
          "+10-40%; F32 ppl near 7e4",
    "card vs CPU": "ppl 1e-5-5e-4 relative in block formats, < 1e-5 F32",
    "phase": "150-300 s",
}


def expected_types(path: str, fmt: str) -> dict:
    """name -> the type cli.quantize gives each tensor of a LLaMA F32
    model: norms F32, output.weight Q8_0 below 8 bits, the rest fmt."""
    target = fmt.upper()
    out = {}
    for name, info in GGUFReader(path).tensors.items():
        if len(info.shape) < 2:
            out[name] = "F32"
        elif name == "output.weight" and target != "Q8_0":
            out[name] = "Q8_0"
        else:
            out[name] = target
    return out


def recorded_ppl(eng, toks: list, n_ctx: int) -> tuple[float, np.ndarray]:
    """compute_perplexity over one n_ctx chunk of `toks`, and the logits
    of every position of it."""
    seen = []
    prefill = eng.prefill

    def recording(*a, **kw):
        seen.append(prefill(*a, **kw))
        return seen[-1]
    eng.prefill = recording
    got = compute_perplexity(eng, "", n_ctx=n_ctx, progress=False,
                             tokens=toks[:n_ctx])
    eng.prefill = prefill
    if not (np.isfinite(seen[0]).all() and np.isfinite(got["ppl"])):
        raise AssertionError(f"logits or ppl not finite on {eng.device}")
    return got["ppl"], seen[0]


def quality_card_vs_cpu(path: str, device, toks: list, n_ctx: int) -> dict:
    """compute_perplexity over one n_ctx chunk of `toks` on the CPU's plain
    engine at float32 compute, and on the card twice: at float32 compute,
    where both compute one function (qmm's plain version is f32: qmm_ref),
    and at the default compute (bf16 activations and cache, what users
    run; the CPU engine at the default rounds each dequantized weight to
    bf16, as the JAX reference does, where qmm keeps it f32-grade, so the
    float32 CPU engine is the reference for both). For each card side: its
    ppl, the gap to the CPU's relative to it, the top-1 agreement of every
    position's logits (a near tie of the CPU's logits counts as agreeing),
    its launches and its seconds. The CPU side runs in a thread of its own
    while the card sides run: the CPU engine touches no CUDA and launches
    nothing."""
    def side(dev, **kw) -> tuple:
        t0 = time.perf_counter()
        eng = Engine(path, n_ctx=n_ctx + 1, device=dev, **kw)
        before = port_launches()
        got = recorded_ppl(eng, toks, n_ctx)
        after = port_launches()
        del eng
        return (got, {k: after[k] - before[k] for k in after},
                time.perf_counter() - t0)
    with ThreadPoolExecutor(1) as ex:
        cpu = ex.submit(side, torch.device("cpu"), compute_dtype="float32")
        card = {"f32": side(device, compute_dtype="float32"),
                "default": side(device)}
        (ppl_b, b), _, cpu_s = cpu.result()
    top2 = np.sort(b, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= NEAR_TIE * np.abs(b).max(axis=-1)
    out = {"ppl_cpu": ppl_b, "cpu_s": cpu_s}
    for key, ((ppl_a, a), launches, secs) in card.items():
        same = a.argmax(-1) == b.argmax(-1)
        out[key] = {"ppl": ppl_a, "rel": abs(ppl_a - ppl_b) / ppl_b,
                    "top1": float(np.mean(same | tie)),
                    "top1_strict": float(np.mean(same)),
                    "parted": int((~same).sum()), "launches": launches,
                    "s": secs}
    return out


def quality_source(rng, shape=LLAMA_7B, n_layers: int = 2) -> tuple:
    """Phase 8's seeded F32 source (normal draws, std 0.02, norms 1) ->
    (path, seconds to write it)."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    src = os.path.join(SMOKE_DIR, "quality_f32.gguf")
    t0 = time.perf_counter()
    write_llama_gguf(src, n_layers, rng, **shape, qtype=GGMLType.F32)
    return src, time.perf_counter() - t0


def phase_quality(device, rng, smi: str, shape=LLAMA_7B, n_layers: int = 2,
                  n_ctx: int = 512, n_chunks: int = 2, cmp_ctx: int = 128,
                  corpus: bytes | None = None, source=None) -> dict:
    """Phase 8: the quantizer and the quality path at full width. source:
    quality_source(rng, shape, n_layers)'s result, written beforehand
    (during the build), or None to write it here."""
    t_phase = time.perf_counter()
    src, write_s = (quality_source(rng, shape, n_layers) if source is None
                    else source)
    made = [src]
    steps = {"source write (during the build)" if source else
             "source write": write_s}
    try:
        log(f"[quality] F32 source, {n_layers} layers of LLaMA-7B width: "
            f"{os.path.getsize(src)} bytes written in {write_s:.1f} s"
            f"{' (during the build)' if source else ''}")
        t0 = time.perf_counter()
        run_tool("gguf_dump", gguf_dump.main, [src])
        run_tool("quantize_stats", quantize_stats.main,
                 ["-m", src, "-l", "blk.0.attn_q", "--per-layer"])
        steps["gguf_dump and quantize_stats"] = time.perf_counter() - t0
        t_q = time.perf_counter()
        cli_files, quant_s = {}, {}
        plain = GGUFReader(src).tensors["blk.0.attn_q.weight"].to_f32()[:64]
        for fmt in QUALITY_FORMATS:
            path = os.path.join(SMOKE_DIR, f"cli_{fmt}.gguf")
            made.append(path)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = quantize.main([src, path, fmt])
            quant_s[fmt] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"quantize {fmt} returned {rc}")
            rd = GGUFReader(path)
            types = {n: t.ggml_type.name for n, t in rd.tensors.items()}
            if types != expected_types(src, fmt):
                raise AssertionError(f"quantize {fmt}: tensor types {types}")
            info = rd.tensors["blk.0.attn_q.weight"]
            want = formats.QUANTIZERS[info.ggml_type](plain)
            if not np.array_equal(np.asarray(info.as_rows())[:64], want):
                raise AssertionError(f"quantize {fmt}: blk.0.attn_q rows "
                                     "0-63 differ from the numpy quantizer")
            cli_files[fmt] = path
            log(f"[quality] quantize {fmt}: {quant_s[fmt]:.1f} s (host), "
                f"{os.path.getsize(path)} bytes; types as expected; "
                "blk.0.attn_q rows 0-63 equal the numpy quantizer")

        steps["cli.quantize x 6"] = time.perf_counter() - t_q
        corpus = build_corpus() if corpus is None else corpus
        snaps = []

        def rec(line):
            log(f"[quality] {line} ({time.perf_counter() - t0:.1f} s)")
            snaps.append(port_launches())
        reset_port_launches()
        t0 = time.perf_counter()
        rows = quality_table(src, corpus=corpus, n_ctx=n_ctx,
                             n_chunks=n_chunks, log=rec, device=device)
        qt_s = time.perf_counter() - t0
        steps["quality_table (its 6 quantizes, 7 engines)"] = qt_s
        files = {fmt: os.path.join(SMOKE_DIR, f"quality_{fmt}.gguf")
                 for fmt in QUALITY_FORMATS}
        made += list(files.values()) + [
            os.path.join(SMOKE_DIR, "quality_base_logits.npz")]
        zero = {k: 0 for k in snaps[0]}
        for row, before, after in zip(rows, [zero] + snaps, snaps):
            got = {k: after[k] - before[k] for k in after}
            want = dict(zero)
            if row["format"] != "F32":
                want["qmm"] = (n_layers * 4 + 1) * 2 * n_chunks
            if got != want:
                raise AssertionError(f"quality_table {row['format']}: "
                                     f"launches {got} != {want}")
        kl = {r["format"]: r["kl"] for r in rows}
        log(f"[quality] quality_table, n_ctx {n_ctx}, {n_chunks} chunks of "
            f"the repository's markdown ({len(corpus)} bytes): "
            f"{qt_s:.1f} s; launches a format: 0 for F32, "
            f"{(n_layers * 4 + 1)} qmm a 512-token ubatch x "
            f"{2 * n_chunks} ubatches in each block format, nothing else")
        for r in rows:
            log(f"[quality] {r['format']:<5} ppl {r['ppl']!r} dppl "
                f"{r['dppl']!r} KL {r['kl']!r} top1 {r['top1_agree']!r}")
        if not (kl["Q8_0"] <= kl["Q5_0"] * 1.5 + 1e-4
                and max(kl["Q5_0"], kl["Q5_1"])
                < max(kl["Q4_0"], kl["Q4_1"]) * 1.5
                and kl["Q2_K"] > max(kl["Q4_0"], kl["Q4_1"])):
            raise AssertionError(f"KL order broken: {kl}")
        q4, q5 = max(kl["Q4_0"], kl["Q4_1"]), max(kl["Q5_0"], kl["Q5_1"])
        log("[quality] KL order held: Q8_0 <= 1.5 Q5_0 + 1e-4, "
            "max(Q5) < 1.5 max(Q4), Q2_K > max(Q4); margins (bound over "
            f"value) {(kl['Q5_0'] * 1.5 + 1e-4) / kl['Q8_0']:.1f}x, "
            f"{q4 * 1.5 / q5:.2f}x, {kl['Q2_K'] / q4:.2f}x")
        for fmt in QUALITY_FORMATS:
            if not filecmp.cmp(cli_files[fmt], files[fmt], shallow=False):
                raise AssertionError(f"{fmt}: quality_table's file differs "
                                     "from cli.quantize's")
            os.remove(cli_files[fmt])
        log("[quality] quality_table's six files equal cli.quantize's, "
            "byte for byte")

        held = corpus[int(len(corpus) * 0.95):]
        toks = (np.frombuffer(held, np.uint8).astype(np.int32) + 3).tolist()
        cmp_rows = {}
        # one ubatch a chunk: 9 qmm in a block format, nothing in F32
        per_chunk = (n_layers * 4 + 1) * -(-cmp_ctx // 512)
        bounds = {"f32": (TOL_PPL, MIN_TOP1),
                  "default": (TOL_PPL_DEFAULT, MIN_TOP1)}
        t0 = time.perf_counter()
        for fmt, path in [("f32", src)] + list(files.items()):
            c = quality_card_vs_cpu(path, device, toks, cmp_ctx)
            want = {k: 0 for k in c["f32"]["launches"]}
            if fmt != "f32":
                want["qmm"] = per_chunk
            for key, (tol, low) in bounds.items():
                r = c[key]
                log(f"[quality] {fmt} card at {key} compute vs CPU at "
                    f"float32, {cmp_ctx} tokens: ppl {r['ppl']!r} vs "
                    f"{c['ppl_cpu']!r} (rel {r['rel']:.3e}, <= {tol}); "
                    f"top-1 {r['top1']!r} ({r['parted']} parted, strict "
                    f"{r['top1_strict']!r}; >= {low}); launches "
                    f"{r['launches']}; s card {r['s']:.1f} / CPU "
                    f"{c['cpu_s']:.1f}")
                if not r["rel"] <= tol:
                    raise AssertionError(f"{fmt} at {key} compute: ppl card "
                                         f"vs CPU rel {r['rel']} > {tol}")
                if not r["top1"] >= low:
                    raise AssertionError(f"{fmt} at {key} compute: top-1 "
                                         f"{r['top1']} < {low}")
                if r["launches"] != want:
                    raise AssertionError(f"{fmt} at {key} compute: card "
                                         f"launches {r['launches']} != "
                                         f"{want}")
            cmp_rows[fmt] = c
        steps["card vs CPU (7 files, 3 engines each)"] = \
            time.perf_counter() - t0
        log(f"[quality] card vs CPU: {time.perf_counter() - t0:.1f} s")

        # each generate_fast of the e2e run (a 1-token prompt, then its
        # decode blocks) must launch 9 qmm_int8 a forward and nothing else
        per = n_layers * 4 + 1
        calls = []
        orig = Engine.generate_fast

        def counted(eng, prompt, **kw):
            before = port_launches()
            n0, p0 = eng.timings.n_step, eng.timings.n_prefill
            res = orig(eng, prompt, **kw)
            after = port_launches()
            got = {k: after[k] - before[k] for k in after}
            steps = eng.timings.n_step - n0
            fwd = steps + eng.timings.n_prefill - p0
            want = {**{k: 0 for k in got}, "qmm_int8": per * fwd}
            if got != want or len(prompt) != 1:
                raise AssertionError(f"generate_fast launches {got} != "
                                     f"{want} ({steps} steps)")
            calls.append(steps)
            return res
        reset_port_launches()
        t0 = time.perf_counter()
        pattern = os.path.join(SMOKE_DIR, "quality_{fmt}.gguf")
        Engine.generate_fast = counted
        try:
            text = run_tool("perf_report", perf_report.main,
                            ["--skip-matmul", "--e2e-pattern", pattern,
                             "--device", str(device)])
        finally:
            Engine.generate_fast = orig
        steps["perf_report --e2e-pattern (6 files)"] = \
            time.perf_counter() - t0
        got = port_launches()
        ubatches = 5 * len(QUALITY_FORMATS)     # bench_model: 1 + 4 a file
        if not (got["qmm"] == ubatches * (n_layers * 4 + 1)
                and got["qmm_int8"] > 0
                and got["qmm_int8"] % (n_layers * 4 + 1) == 0
                and all(v == 0 for k, v in got.items()
                        if k not in ("qmm", "qmm_int8"))):
            raise AssertionError(f"perf_report --e2e-pattern launches {got}")
        e2e = {}
        for line in text.splitlines():
            cells = [c.strip() for c in line.strip("|").split("|")]
            if cells and cells[0] in QUALITY_FORMATS:
                e2e[cells[0]] = (float(cells[1].replace(",", "")),
                                 float(cells[2].replace(",", "")))
        if sorted(e2e) != sorted(QUALITY_FORMATS):
            raise AssertionError(f"perf_report rows {sorted(e2e)}")
        if len(calls) != 4 * len(QUALITY_FORMATS):
            raise AssertionError(f"{len(calls)} generate_fast calls")
        by_fmt = dict(zip(("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k"),
                          (calls[i:i + 4] for i in range(0, len(calls), 4))))
        for fmt in QUALITY_FORMATS:
            log(f"[quality] {fmt}: quantize {quant_s[fmt]:.1f} s (host); "
                f"pp512 {e2e[fmt][0]:,.0f} tok/s, tg256 {e2e[fmt][1]:,.1f} "
                f"tok/s ({n_layers} layers); a decode step {per} qmm_int8 "
                f"and nothing else, in each of 4 generate_fast calls of "
                f"{by_fmt[fmt]} steps")
        log(f"[quality] perf_report launches: {got} ({ubatches} 512-token "
            "ubatches; every decode step and 1-token prefill 9 qmm_int8)")
        for key, val in QUALITY_PREDICTIONS.items():
            log(f"[quality] predicted {key}: {val}")
        log(f"[quality] {smi}")
    finally:
        for path in made:
            if os.path.exists(path):
                os.remove(path)
    secs = time.perf_counter() - t_phase
    for step, dt in steps.items():
        log(f"[quality] {step}: {dt:.1f} s")
    log(f"[quality] phase 8 took {secs:.1f} s")
    return {"rows": rows, "card_vs_cpu": cmp_rows, "e2e": e2e,
            "quantize_s": quant_s, "seconds": secs, "steps": steps}


# what the decode paths were predicted to do on CUDA graphs, written before
# the graphs' first chip run (PERF.md section 5): tok/s, or ms a step
GRAPH_PREDICTIONS = {
    "default generate_fast": "80-110 tok/s",
    "megakernel generate_fast": "220-240 tok/s",
    "fused FFN + inkq decode_one": "11-13 ms a step",
    # written for 32 layers; phase 4b has run 16 since phase 11 came
    "16k generate_fast": "75-90 tok/s at 32 layers",
    "batched pl 1 / 4 / 8": "85-110 / 300-400 / 550-750 tok/s",
}


# -- slice 14: the generation surface (cli.main and its tools) ---------------
# a parting of greedy tokens passes only at a near tie: the top-two gap of
# the logits that chose the token <= TIE of their max |logit|
TIE = 1e-2
GEN_PROMPT, GEN_PREDICT, GEN_CFG_CHECK = 512, 64, 8
GEN_GBNF = 'root ::= [a-z]+ " " [0-9]+'
TOOL_TEXT = "The quick brown fox jumps over the lazy dog."
PIECE_MAX = len("<extra_31999>")     # the longest piece of the synthetic vocab
BATCHED_N = 32
# beam_search's length-normalised score, card against CPU: within 1e-3 of
# |score| (an H100 run: 1.33e-3 apart at -7.39, 1.8e-4 of it)
BEAM_TOL = 1e-3


def tie_gap(logits) -> float:
    """Top-two gap of a logit vector over its max |logit|."""
    lg = np.asarray(logits, np.float64)
    top = np.sort(lg)[-2:]
    return float((top[1] - top[0]) / max(np.abs(lg).max(), 1e-30))


def first_parting(a: list, b: list) -> int | None:
    """Index of the first element where two sequences differ (a length
    difference counts at the shorter end), or None if they are equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def run_cli(label: str, main, argv: list[str]) -> tuple[int, str, str, float]:
    """A CLI's main(argv) with its stdout and stderr captured and logged
    -> (return code, stdout, stderr, seconds)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        dt = time.perf_counter() - t0
        for stream, tag in ((out, ""), (err, " err")):
            for line in stream.getvalue().splitlines():
                log(f"[{label}{tag}] {line[:300]}")
    return rc, out.getvalue(), err.getvalue(), dt


def read_logdir(d: str) -> dict:
    """The flat scalars of the one YAML run record cli.main --logdir wrote."""
    (name,) = os.listdir(d)
    rec = {}
    with open(os.path.join(d, name)) as f:
        for line in f:
            key, sep, val = line.partition(": ")
            if sep and not key.startswith("#"):
                try:
                    rec[key] = float(val)
                except ValueError:
                    rec[key] = val.strip()
    return rec


def session_tokens(path: str) -> list[int]:
    with np.load(path) as z:
        return [int(t) for t in z["tokens"]]


def gen_prompt(path: str, rng, n_tokens: int) -> tuple[str, list[int]]:
    """Lower-case letters that the model's byte-level vocab encodes to
    exactly n_tokens tokens (BOS and the leading space's bytes included)."""
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    r = GGUFReader(path)
    tok = build_tokenizer(r.metadata)
    r.close()
    n_head = len(tok.encode("a", special=True)) - 1
    text = "".join(chr(97 + int(c))
                   for c in rng.integers(0, 26, n_tokens - n_head))
    ids = tok.encode(text, special=True)
    if len(ids) != n_tokens:
        raise AssertionError(f"prompt of {len(ids)} tokens, not {n_tokens}")
    return text, ids


def penalized(logits, hist: list[int], last_n: int,
              repeat: float) -> np.ndarray:
    """The logits a greedy Sampler takes its choice from: the repeat
    penalty over the last last_n tokens of hist."""
    return apply_penalties(np.asarray(logits, np.float32), hist[-last_n:],
                           repeat, 0.0, 0.0)


def check_greedy_run(ref, prompt: list[int], want: list[int],
                     got: list[int], label: str) -> str:
    """The greedy tokens (no repeat penalty) of a prompt-cache run (the
    prompt's last token evaluated alone) against those of the run that
    wrote the cache (the prompt in one ubatch): equal, or parted at a near
    tie of ref's logits (slot 0) on either run's path, teacher-forced
    through its own tokens. Raises otherwise."""
    i = first_parting(want, got)
    if i is None:
        return "the same tokens"
    gaps = []
    for pieces, toks in (([prompt], want), ([prompt[:-1], prompt[-1:]], got)):
        ref.reset_slot(0)
        for piece in pieces:
            lg = ref.prefill(0, piece)
        for t in toks[:i]:
            lg = ref.decode_one(0, t)
        gaps.append(tie_gap(lg))
    if min(gaps) > TIE:
        raise AssertionError(f"{label}: parted at token {i} "
                             f"({want[i:i + 1]} vs {got[i:i + 1]}), top-two "
                             f"gaps {gaps} of max|logit| > {TIE}")
    return (f"parted at token {i} at a near tie (gaps {gaps[0]:.3g} / "
            f"{gaps[1]:.3g} of max|logit|)")


def main_run(label: str, path: str, argv: list[str], work: str):
    """cli.main on `path` with its launches counted from 0 and its timings
    from --logdir -> (rc, stdout, stderr, seconds, launches, timings)."""
    logdir = os.path.join(work, label)
    reset_port_launches()
    rc, out, err, dt = run_cli(label, gen_main.main,
                               ["-m", path, *argv, "--logdir", logdir])
    launches = {k: v for k, v in port_launches().items() if v}
    tm = read_logdir(logdir)
    log(f"[{label}] rc {rc}, {dt:.1f} s: load {tm['t_load_ms'] / 1e3:.2f} s, "
        f"prefill {int(tm['n_prompt_eval'])} tokens "
        f"{tm['prompt_tokens_per_s']:.1f} tok/s, decode "
        f"{int(tm['n_eval'])} evals {tm['eval_tokens_per_s']:.2f} tok/s, "
        f"host sampler {tm['t_sample_ms'] / max(tm['n_sample'], 1):.3f} ms a "
        f"token; launches {launches}")
    if rc != 0:
        raise AssertionError(f"{label}: cli.main returned {rc}")
    return out, err, dt, launches, tm


def phase_generation(device, rng, path: str, n_layers: int, smi: str,
                     shape=LLAMA_7B, prompt_len: int = GEN_PROMPT,
                     n_predict: int = GEN_PREDICT, n_ctx: int = 2048) -> dict:
    """Phase 9a: tpulamm_torch.cli.main in process on the phase-4 model: a
    prompt-cache run twice, a reverse prompt, a GBNF grammar and
    classifier-free guidance, each with its exact launch counts."""
    t_phase = time.perf_counter()
    work = os.path.join(SMOKE_DIR, "gen")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    per_pass = 4 * n_layers + 1
    text, ptoks = gen_prompt(path, rng, prompt_len)
    # no repeat penalty: a prompt-cache run feeds its Sampler only the
    # tokens it evaluates, so a penalty window would differ between runs
    base = ["-p", text, "-n", str(n_predict), "--temp", "0", "-c",
            str(n_ctx), "--repeat-penalty", "1.0", "--no-display-prompt",
            "--device", device.type]
    out = {}
    try:
        # a prompt-cache run, then the same command again
        cache = os.path.join(work, "prompt.cache")
        o1, _, dt1, l1, t1 = main_run("main-cache-1", path,
                                      base + ["--prompt-cache", cache], work)
        ids1 = session_tokens(cache)[prompt_len:]
        if int(t1["n_eval"]) != len(ids1):
            raise AssertionError(f"{len(ids1)} tokens, {t1['n_eval']} steps")
        expect_launches("main-cache-1", {"qmm": per_pass,
                                         "qmm_int8": per_pass * len(ids1)})
        o2, e2, dt2, l2, t2 = main_run("main-cache-2", path,
                                       base + ["--prompt-cache", cache], work)
        ids2 = session_tokens(cache)[prompt_len:]
        reuse = (f"prompt cache: reusing {prompt_len - 1} of {prompt_len} "
                 "prompt tokens")
        if reuse not in e2:
            raise AssertionError(f"main-cache-2: no {reuse!r} on stderr")
        # the one token left is a 1-row forward: the int8 gemv
        expect_launches("main-cache-2",
                        {"qmm_int8": per_pass * (1 + len(ids2))})
        ref = Engine(path, n_ctx=n_ctx, n_slots=2, device=device)
        same = check_greedy_run(ref, ptoks, ids1, ids2, "main-cache-2")
        if same == "the same tokens" and o2 != o1:
            raise AssertionError("main-cache-2: the same tokens, other text")
        log(f"[generation] prompt cache: run 2 reused {prompt_len - 1} of "
            f"{prompt_len} tokens and gave {same}; launches run 1 {l1} "
            f"(exactly {per_pass} qmm for the ubatch and {per_pass} qmm_int8 "
            f"for each of {len(ids1)} decode steps), run 2 {l2}")
        # a reverse prompt: the piece at the middle of the first run's text
        gen = o1[:-1]
        k = gen.find("<", len(gen) // 2)
        e = gen.find(">", k) if k >= 0 else -1
        rp = gen[k:e + 1] if e > k else gen[len(gen) // 2:len(gen) // 2 + 8]
        o3, _, dt3, l3, _ = main_run("main-reverse", path,
                                     base + ["-r", rp], work)
        stop, cut = gen.index(rp) + len(rp), o3[:-1]
        if not (gen.startswith(cut) and stop <= len(cut) < stop + PIECE_MAX):
            raise AssertionError(f"-r {rp!r}: output of {len(cut)} chars, "
                                 f"first occurrence ends at {stop}")
        log(f"[generation] -r {rp!r}: stopped at char {len(cut)} of "
            f"{len(gen)}, the piece that ends its first occurrence (char "
            f"{stop})")
        # a GBNF grammar: 12 tokens, each step masks the 32,000 pieces
        o4, _, dt4, l4, _ = main_run(
            "main-grammar", path,
            base[:2] + ["-n", "12"] + base[4:] + ["--grammar", GEN_GBNF],
            work)
        g = Grammar.from_gbnf(GEN_GBNF)
        g.accept_token(o4[:-1].encode())      # raises where it does not parse
        log(f"[generation] GBNF {GEN_GBNF!r}: {o4[:-1]!r} parses"
            f"{' (complete)' if g.can_stop() else ' (a prefix)'}")
        # classifier-free guidance: two slots, one batched step a token
        neg_text, neg = gen_prompt(path, rng, 64)
        cfg_cache = os.path.join(work, "cfg.cache")
        o5, _, dt5, l5, t5 = main_run(
            "main-cfg", path,
            base[:2] + ["-n", "16"] + base[4:] + [
                "--cfg-negative-prompt", neg_text, "--cfg-scale", "1.5",
                "--prompt-cache", cfg_cache], work)
        ids5 = session_tokens(cfg_cache)[prompt_len:]
        expect_launches("main-cfg", {"qmm": 2 * per_pass,
                                     "qmm_int8": per_pass * len(ids5)})
        ref.reset_slot(0)
        ref.reset_slot(1)
        g_lg, lg = ref.prefill(1, neg), ref.prefill(0, ptoks)
        parted = []
        for i, t in enumerate(ids5[:GEN_CFG_CHECK]):
            guided = apply_guidance(lg, g_lg, 1.5)
            if int(np.argmax(guided)) != t:
                gap = tie_gap(guided)
                if gap > TIE:
                    raise AssertionError(
                        f"main-cfg: token {i} is {t}, the host recomputation "
                        f"gives {int(np.argmax(guided))} (gap {gap:.3g})")
                parted.append((i, gap))
            both = ref.decode_batch({0: t, 1: t})
            lg, g_lg = both[0], both[1]
        log(f"[generation] CFG scale 1.5: the first {GEN_CFG_CHECK} tokens "
            f"against decode_batch + apply_guidance on the host: "
            f"{'all equal' if not parted else f'near ties at {parted}'}; "
            f"launches {l5} ({2 * per_pass} qmm for the two prompts, "
            f"{per_pass} qmm_int8 for each of {len(ids5)} two-row steps)")
        del ref
        out = {"load_s": t1["t_load_ms"] / 1e3,
               "prefill_tok_s": t1["prompt_tokens_per_s"],
               "decode_tok_s": t1["eval_tokens_per_s"],
               "sample_ms": t1["t_sample_ms"] / t1["n_sample"],
               "cfg_decode_tok_s": t5["eval_tokens_per_s"] / 2,
               "runs_s": [dt1, dt2, dt3, dt4, dt5]}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[generation] cli.main at {n_layers} layers: load "
        f"{out['load_s']:.2f} s, prefill {out['prefill_tok_s']:.1f} tok/s, "
        f"decode (decode_one + host Sampler) {out['decode_tok_s']:.2f} "
        f"tok/s, host sampler {out['sample_ms']:.3f} ms a token, CFG "
        f"{out['cfg_decode_tok_s']:.2f} tok/s; runs "
        f"{' / '.join(f'{s:.1f}' for s in out['runs_s'])} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {smi}")
    return out


# the tools at 2 layers: (name, recording mode, argv after -m)
def tool_cases(n_beams: int = 4) -> list[tuple[str, str, list[str]]]:
    return [
        ("beam_search", "beam", ["-p", TOOL_TEXT, "-b", str(n_beams),
                                 "-n", "16", "-c", "512"]),
        ("batched", "block", ["-p", TOOL_TEXT, "-np", "4", "-n",
                              str(BATCHED_N), "--temp", "0", "-c", "512"]),
        ("parallel", "sample", ["-np", "4", "-ns", "8", "-n", "16",
                                "--temp", "0", "-c", "512"]),
        ("infill", "sample", ["--in-prefix", "def add(a, b):\n    ",
                              "--in-suffix", "\n    return c", "-n", "16",
                              "--temp", "0", "-c", "512"]),
        ("passkey", "sample", ["--n-junk", "5", "--passkey", "31415",
                               "--pos", "2", "-c", "1024", "--grp-attn-n",
                               "4", "-n", "8"]),
        ("save_load_state", "argmax", ["-p", TOOL_TEXT, "-n", "16",
                                       "-c", "256"]),
        ("embedding", "none", ["-p", TOOL_TEXT, "-p", "a b c d e f g h",
                               "--json", "-c", "512"]),
    ]


@contextlib.contextmanager
def recording(mode: str):
    """Record what a tool chooses while it runs -> {"choices": [(token,
    tie_gap or None)], "beam": [ids, score] or None}. mode "sample": each
    Sampler.sample (its gap on the penalized logits); "argmax": the argmax
    of the logits Engine.prefill and decode_one return; "block": those and
    decode_batch_fast's tokens (no logits: gap None); "beam":
    beam_search's result."""
    from tpulamm_torch.runtime import beam as beam_mod
    rec = {"choices": [], "beam": None}
    saved = []

    def patch(obj, name, make):
        orig = getattr(obj, name)
        saved.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def on_sample(orig):
        def sample(self, logits):
            tok = orig(self, logits)
            p = self.params
            rec["choices"].append((int(tok), tie_gap(penalized(
                logits, self.prev, p.penalty_last_n, p.penalty_repeat)
                if p.penalty_last_n else logits)))
            return tok
        return sample

    def on_logits(orig):
        def call(self, *a, **kw):
            lg = orig(self, *a, **kw)
            if getattr(lg, "ndim", 0) == 1:
                rec["choices"].append((int(np.argmax(lg)), tie_gap(lg)))
            return lg
        return call

    def on_block(orig):
        def call(self, *a, **kw):
            res = orig(self, *a, **kw)
            for s in sorted(res):
                rec["choices"] += [(int(t), None) for t in res[s]]
            return res
        return call

    def on_beam(orig):
        def call(*a, **kw):
            ids, score = orig(*a, **kw)
            rec["beam"] = [list(ids), float(score)]
            return ids, score
        return call

    try:
        if mode == "sample":
            patch(Sampler, "sample", on_sample)
        if mode in ("argmax", "block"):
            patch(Engine, "prefill", on_logits)
            patch(Engine, "decode_one", on_logits)
        if mode == "block":
            patch(Engine, "decode_batch_fast", on_block)
        if mode == "beam":
            patch(beam_mod, "beam_search", on_beam)
        yield rec
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


def run_recorded(tool: str, mode: str, argv: list[str]) -> dict:
    """A tool's main(argv) with stdout and stderr captured and its choices
    recorded -> {"rc", "out", "err", "s", "choices", "beam"}."""
    import importlib
    mod = importlib.import_module(f"tpulamm_torch.cli.{tool}")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with recording(mode) as rec, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue(),
            "s": time.perf_counter() - t0, **rec}


def cpu_tool_main() -> int:
    """`python3 -c "import chip_smoke; chip_smoke.cpu_tool_main()" TOOL MODE
    ARGV_JSON`: the tool on the CPU's plain path, one thread, its result
    as one JSON line."""
    tool, mode, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    torch.set_num_threads(1)
    res = run_recorded(tool, mode, argv + ["--device", "cpu"])
    print(json.dumps(res), flush=True)
    return 0


def block_gap(path: str, device, res: dict, i: int,
              n: int = BATCHED_N) -> float:
    """batched's choice i (its first token, then each slot's block of n - 1
    tokens) has no logits: its gap, from a one-slot engine on `device`
    teacher-forced through the same slot's tokens."""
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    eng = Engine(path, n_ctx=512, device=device)
    toks = [t for t, _ in res["choices"]]
    first, blk = toks[0], n - 1
    s, j = divmod(i - 1, blk)
    lg = eng.prefill(0, build_tokenizer(eng.metadata).encode(TOOL_TEXT,
                                                             add_bos=True))
    for t in [first] + toks[1 + s * blk:1 + s * blk + j]:
        lg = eng.decode_one(0, t)
    return tie_gap(lg)


def compare_tool(path: str, device, tool: str, card: dict, cpu: dict) -> str:
    """The card's run of a tool against the CPU's: return codes, then the
    choices (a parting allowed only at a near tie of either side's logits;
    after it the texts may differ), the output text, beam_search's
    sequence and score (within BEAM_TOL of |score|: the card's decode
    takes int8 activations, the CPU's f32), embedding's cosine
    (>= 0.999)."""
    if tool == "embedding":
        a = np.asarray(json.loads(card["out"])["embeddings"], np.float64)
        b = np.asarray(json.loads(cpu["out"])["embeddings"], np.float64)
        cos = min(cosine(x, y) for x, y in zip(a, b))
        if a.shape != b.shape or not cos >= 0.999:
            raise AssertionError(f"embedding: cosine {cos} < 0.999")
        return f"{len(a)} vectors of {a.shape[1]}, min cosine {cos!r}"
    if tool == "beam_search":
        (ia, sa), (ib, sb) = card["beam"], cpu["beam"]
        if ia != ib or not abs(sa - sb) <= BEAM_TOL * abs(sb):
            raise AssertionError(f"beam_search: {ia} ({sa}) vs {ib} ({sb})")
        return f"the same {len(ia)} tokens, score {sa!r} vs {sb!r}"
    ta = [t for t, _ in card["choices"]]
    tb = [t for t, _ in cpu["choices"]]
    i = first_parting(ta, tb)
    if i is None:
        if re.sub(r"\s*[0-9.]+ t/s", " t/s", card["out"]) != \
                re.sub(r"\s*[0-9.]+ t/s", " t/s", cpu["out"]):
            raise AssertionError(f"{tool}: the same choices, other text")
        if card["rc"] != cpu["rc"]:
            raise AssertionError(f"{tool}: exit {card['rc']} vs {cpu['rc']}")
        return f"the same {len(ta)} choices and text, exit {card['rc']}"
    gaps = [g for g in (card["choices"][i][1] if i < len(ta) else None,
                        cpu["choices"][i][1] if i < len(tb) else None)
            if g is not None]
    if not gaps:
        gaps = [block_gap(path, device, card, i)]
    if min(gaps) > TIE:
        raise AssertionError(f"{tool}: choice {i} parted ({ta[i:i + 1]} vs "
                             f"{tb[i:i + 1]}) at gap {min(gaps):.3g} > {TIE}")
    return (f"parted at choice {i} of {len(ta)} at a near tie (gap "
            f"{min(gaps):.3g}); exit {card['rc']} vs {cpu['rc']}")


def phase_tools(device, rng, smi: str, shape=LLAMA_7B, n_layers: int = 2,
                cases=None, threads: int = 1) -> dict:
    """Phase 9b: each generation tool on the card beside the same tool on
    the CPU's plain path (a subprocess each, started together) on a model
    of n_layers of LLaMA-7B width with fill-in-the-middle ids."""
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR,
                        f"llama7b_shape_q4_0_{n_layers}l_fim.gguf")
    write_llama_gguf(path, n_layers, rng, **shape, fim=True)
    cases = tool_cases() if cases is None else cases
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here, "OMP_NUM_THREADS": str(threads)}
    procs, errs = {}, {}
    try:
        for tool, mode, argv in cases:
            # stderr to a file: a full pipe would stall the child
            errs[tool] = open(os.path.join(SMOKE_DIR, f"cpu_{tool}.err"),
                              "w+")
            procs[tool] = subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke; chip_smoke.cpu_tool_main()", tool, mode,
                 json.dumps(["-m", path] + argv)],
                cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=errs[tool], text=True)
        card = {}
        for tool, mode, argv in cases:
            reset_port_launches()
            res = run_recorded(tool, mode,
                               ["-m", path] + argv + ["--device", device.type])
            res["launches"] = {k: v for k, v in port_launches().items() if v}
            card[tool] = res
            for line in res["out"].splitlines()[:12]:
                log(f"[tools {tool}] {line[:200]}")
            log(f"[tools {tool}] card: exit {res['rc']}, {res['s']:.1f} s, "
                f"launches {res['launches']}")
            decodes = tool != "embedding"
            if not (res["launches"].get("qmm", 0) > 0 and (
                    not decodes or res["launches"].get("qmm_int8", 0) > 0)):
                raise AssertionError(f"{tool}: launches {res['launches']}")
            if tool in ("save_load_state", "beam_search", "batched",
                        "parallel", "infill", "embedding") and res["rc"] != 0:
                raise AssertionError(f"{tool} on the card exited {res['rc']}:"
                                     f" {res['err'][-500:]}")
        t_card = time.perf_counter() - t_phase
        out, failed = {}, []
        for tool, mode, argv in cases:
            so, _ = procs[tool].communicate(timeout=600)
            if procs[tool].returncode != 0:
                errs[tool].seek(0)
                failed.append(f"{tool} on the CPU: "
                              f"{errs[tool].read()[-2000:]}")
                continue
            cpu = json.loads(so.strip().splitlines()[-1])
            try:
                verdict = compare_tool(path, device, tool, card[tool], cpu)
            except AssertionError as e:
                failed.append(str(e))
                verdict = f"FAILED: {e}"
            log(f"[tools {tool}] CPU: exit {cpu['rc']}, {cpu['s']:.1f} s; "
                f"card vs CPU: {verdict}")
            out[tool] = {"card_s": card[tool]["s"], "cpu_s": cpu["s"],
                         "launches": card[tool]["launches"]}
        if failed:
            raise AssertionError("; ".join(failed))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        for f in errs.values():
            f.close()
            os.remove(f.name)
        os.remove(path)
    log(f"[tools] {len(cases)} tools: card side {t_card:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s; {smi}")
    return out


# -- slice 15: the architecture axes and the BPE / WPM tokenizers ------------
# Mixtral-8x7B's published config.json (mistralai/Mixtral-8x7B-v0.1)
MIXTRAL_8X7B = dict(dim=4096, ffn=14336, n_head=32, n_kv=8, vocab=32000,
                    n_expert=8, n_expert_used=2, n_ctx_train=32768,
                    freq_base=1e6)
# phase 10a's launch counts, written before its first chip run (PERF.md
# section 5): 2 layers x (fused QKV + wo + 24 expert products) + the lm
# head = 53 products, one qmm each for a 512-token ubatch and one qmm_int8
# each a decode step; the 8 x 4096 router does not tile and stays dense
MOE_LAUNCHES = {"qmm": 53, "qmm_int8": 53}
# what phase 10 was predicted to show, written before its first chip run
# (PERF.md section 5)
ARCH_PREDICTIONS = {
    "prefill tok/s": "15,000-25,000", "decode tok/s": "650-1,000",
    "decode busy ms": "0.8-1.2", "share of bound": "40-65%",
    "phase s": "70-110",
}
# bigscience/bloom-7b1's published config.json: ALiBi, a fused biased QKV,
# the embedding LayerNorm, a plain gelu FFN and the lm head tied to the
# 250,880-row token embedding; every projection tiles at this width
BLOOM_7B1 = dict(dim=4096, ffn=16384, n_head=32, vocab=250880)
# phase 10d's launch counts, written before its first chip run (PERF.md
# section 5): 2 layers x (fused QKV + wo + up + down) + the tied head = 9
# products, one qmm each for a 512-token ubatch and one qmm_int8 each a
# decode step (N of 12288, 4096, 16384 and 250880 all have a divisor tile
# of at least 1024), nothing else (ALiBi turns flash off; the megakernel
# and ffn_fused gates refuse a plain FFN)
BLOOM_LAUNCHES = {"qmm": 9, "qmm_int8": 9}
BLOOM_PREDICTIONS = {
    "prefill tok/s": "8,000-40,000", "decode tok/s": "800-1,600",
    "decode busy ms": "0.45-0.9", "share of bound": "27-55%",
    "phase s": "30-60",
}
# phase 10b's quantized projections a pass and, of them, those a decode
# step sends through qmm_int8, at dim 512, ffn 1536, head dim 64 (falcon
# 128), vocab 1024, 2 layers: N of 1024 (the head) or 1536 (a fused QKV of
# 8 full heads, an up or gate) or 3072 (gate and up fused) has a divisor
# tile of 1024 or more and takes qmm_int8; N of 512 (wo, down, split
# q / k / v under qk-norm) or 768 (a fused QKV with fewer KV heads) takes
# qmm. bert's rows are its 8-token embedding, which has no head.
FAMILY_PASSES = {
    "gpt2": (9, 5), "falcon": (9, 3), "bloom": (9, 5), "mpt": (9, 5),
    "phi2": (9, 5), "gemma": (9, 3), "persimmon": (13, 3),
    "starcoder2": (9, 3), "qwen2": (9, 3), "stablelm": (9, 5),
    "gptneox": (9, 5), "bert": (8, 4), "nomic-bert": (8, 4),
}
# the families phase 10b runs again with flash_attn=True: non-causal
# (bert) and parallel residual with one KV head (falcon)
FLASH_FAMILIES = ("bert", "falcon")
ARCH_TEXTS = ("The quick brown fox jumps over the lazy dog.",
              "It's 2024 and we'll see 1234 tokens, don't you think?",
              "Hello world! café naïve 北京")


def quant_weights(eng) -> list:
    """Every quantized projection of a forward pass (the MoE experts
    included), each one qmm / qmm_int8 launch."""
    out = [w for w in (eng.params.get("output"),) if isinstance(w, QTensor)]
    for lyr in eng.params["layers"]:
        for v in lyr.values():
            for w in (v if isinstance(v, list) else [v]):
                if isinstance(w, QTensor):
                    out.append(w)
    return out


def gguf_step_bytes(path: str) -> int:
    """The GGUF bytes a decode step must read: every tensor once but the
    token embedding, of which it reads one row (unless it is the tied lm
    head, then read whole)."""
    with GGUFReader(path) as r:
        tied = "output.weight" not in r.tensors
        return sum(t.n_bytes for name, t in r.tensors.items()
                   if tied or name != "token_embd.weight")


def card_vs_cpu(gpu, cpu, prompt: list, steps: int, ref=None) -> dict:
    """Last prefill logits (or the pooled embedding of an embedding model)
    and `steps` teacher-forced decode steps (a short embedding of the
    prompt's first 8 tokens) of the card against the CPU plain engine:
    cosines, held to >= 0.999 and >= 0.99. ref: the CPU side's outputs of
    an earlier call, reused."""
    embeds = gpu.params.get("output") is None
    if ref is None and embeds:
        ref = {"prefill": cpu.embed(prompt),
               "steps": [cpu.embed(prompt[:8])]}
    elif ref is None:
        b = cpu.prefill(0, prompt)
        ref = {"prefill": b, "steps": [], "toks": []}
        for _ in range(steps):
            ref["toks"].append(int(np.argmax(b)))
            b = cpu.decode_one(0, ref["toks"][-1])
            ref["steps"].append(b)
    if embeds:
        got = [gpu.embed(prompt), gpu.embed(prompt[:8])]
    else:
        gpu.reset_slot(0)
        got = [gpu.prefill(0, prompt)] + [gpu.decode_one(0, t)
                                          for t in ref["toks"]]
    if not all(np.isfinite(a).all() for a in got):
        raise AssertionError("card output not finite")
    out = {"cos_prefill": cosine(got[0], ref["prefill"]),
           "shape": got[0].shape,
           "cos_steps": [cosine(a, b) for a, b in zip(got[1:],
                                                     ref["steps"])],
           "ref": ref}
    if not (out["cos_prefill"] >= 0.999 and min(out["cos_steps"]) >= 0.99):
        raise AssertionError(f"card vs CPU cosine {out['cos_prefill']} "
                             f"(>= 0.999), steps {out['cos_steps']} "
                             "(>= 0.99)")
    return out


def drive_wide(tag: str, path: str, device, prompt: list, n_ctx: int,
               want: dict, n_predict: int = 64, cmp_prompt: int = 64,
               steps: int = 8) -> dict:
    """Phase 10's run of a wide 2-layer model at `path` in Engine(n_ctx):
    generate_fast twice through its captured decode graphs (the same
    tokens; the launches of the second run exactly want["qmm"] for the
    ubatch and want["qmm_int8"] a step); on the card a decode step's wall
    ms and profile (and a prefill's) against two bounds, the GGUF blocks
    the step must read and the planes the port reads, over 3.35 TB/s, its
    share given against the smaller; then the card against the CPU plain
    engine. The CPU side runs after the card's measurements: run beside
    them in a thread, it cut the timed prefill to a quarter in a
    whole-script run."""
    t0 = time.perf_counter()
    eng = Engine(path, n_ctx=n_ctx, device=device)
    t_load = time.perf_counter() - t0
    ids_a, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    eng.timings = Timings()
    reset_port_launches()
    ids_b, _ = eng.generate_fast(prompt, n_predict=n_predict,
                                 stop_on_eos=False)
    tm = eng.timings
    got = expect_launches(tag, {"qmm": want["qmm"],
                                "qmm_int8": want["qmm_int8"] * tm.n_step})
    if ids_a != ids_b:
        raise AssertionError(f"two greedy {tag} runs on the card disagree")
    L = eng.cfg.n_layers
    out = {"load_s": t_load, "steps": tm.n_step,
           "launches": {k: v for k, v in got.items() if v},
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": (len(ids_b) - 1) / tm.t_eval,
           "planes_gb": sum(w.n_bytes for w in quant_weights(eng)) / 1e9,
           "gguf_gb": gguf_step_bytes(path) / 1e9}
    log(f"[{tag}] Engine load {t_load:.2f} s; {L} layers: prefill "
        f"{len(prompt)} tokens {out['prefill_tok_s']:.1f} tok/s, decode "
        f"{len(ids_b) - 1} tokens ({tm.n_step} steps) "
        f"{out['decode_tok_s']:.2f} tok/s; launches {out['launches']} "
        f"(expected {want['qmm']} qmm for the ubatch, {want['qmm_int8']} "
        "qmm_int8 a step); two runs gave the same tokens")
    if device.type == "cuda":
        out["decode_one_ms"] = wall_ms(lambda: eng.decode_one(0, 5))
        out.update(profile_steps(eng, f"{tag}_decode",
                                 lambda: eng.decode_one(0, 5)))
        out.update(profile_steps(
            eng, f"{tag}_prefill",
            lambda: (eng.reset_slot(0), eng.prefill(0, prompt)), steps=1))
        ms = {k: out[f"{k}_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3
              for k in ("gguf", "planes")}
        out["bound_ms"] = min(ms.values())
        busy = out[f"{tag}_decode_busy_ms"]
        log(f"[{tag}] decode step: {out['decode_one_ms']:.3f} ms wall (no "
            f"profiler), {busy:.3f} ms on the device; it must read "
            f"{out['gguf_gb']:.4f} GB of GGUF blocks and reads "
            f"{out['planes_gb']:.4f} GB of planes: bound {ms['gguf']:.4f} "
            f"ms (blocks) / {ms['planes']:.4f} ms (planes) at 3.35 TB/s, "
            f"{out['bound_ms'] / busy:.1%} of the smaller")
    eng.reset_slot(0)
    cmp = card_vs_cpu(eng, Engine(path, n_ctx=512, device="cpu"),
                      prompt[:cmp_prompt], steps)
    log(f"[{tag}] card vs CPU plain engine ({L} layers): prefill "
        f"{cmp_prompt} tokens cosine {cmp['cos_prefill']!r} (>= 0.999); "
        f"{steps} teacher-forced decode steps min cosine "
        f"{min(cmp['cos_steps'])!r} (>= 0.99)")
    out.update(cos_prefill=cmp["cos_prefill"],
               cos_decode_min=min(cmp["cos_steps"]))
    return out


def phase_moe(device, rng, smi: str, shape=MIXTRAL_8X7B, n_layers: int = 2,
              n_ctx: int = 4096, prompt_len: int = PROMPT) -> dict:
    """Phase 10a: a Mixtral-8x7B-width Q4_0 model (random blocks, an F32
    router; the CPU side's f32 weights are ~12.6 GB at 2 layers) through
    drive_wide with MOE_LAUNCHES; every expert is read a step (the dense
    MoE)."""
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"mixtral_8x7b_width_q4_0_{n_layers}l.gguf")
    write_mixtral_gguf(path, n_layers, rng, **shape)
    with GGUFReader(path) as r:
        experts = sum(t.n_bytes for name, t in r.tensors.items()
                      if re.search(r"\.ffn_(gate|up|down)\.\d+\.", name))
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    out = drive_wide("moe", path, device, prompt, n_ctx, MOE_LAUNCHES)
    out["experts_gb"] = experts / 1e9
    log(f"[moe] the experts are {experts / 1e9:.4f} GB of GGUF blocks, all "
        f"{shape['n_expert']} a layer read a step (the dense MoE); router "
        "F32, dense")
    os.remove(path)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[moe] phase 10a {out['phase_s']:.1f} s; predicted "
        f"{ARCH_PREDICTIONS}; {smi}")
    return out


def phase_bloom(device, rng, smi: str, shape=BLOOM_7B1, n_layers: int = 2,
                n_ctx: int = 2048, prompt_len: int = PROMPT) -> dict:
    """Phase 10d: a bloom-7b1-width Q4_0 model (random blocks; ALiBi, the
    embedding LayerNorm, a biased fused QKV, a plain gelu FFN, the tied
    250,880-row head) through drive_wide with BLOOM_LAUNCHES."""
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"bloom_7b1_width_q4_0_{n_layers}l.gguf")
    write_family_gguf(path, "bloom", rng, n_layers=n_layers, **shape)
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    out = drive_wide("bloom", path, device, prompt, n_ctx, BLOOM_LAUNCHES)
    os.remove(path)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[bloom] phase 10d {out['phase_s']:.1f} s; predicted "
        f"{BLOOM_PREDICTIONS}; {smi}")
    return out


def phase_families(device, rng, prompt_len: int = 64, steps: int = 8,
                   n_ctx: int = 1024) -> dict:
    """Phase 10b: a small model of each architecture family of
    tools.synth.FAMILIES through the card's engine and the CPU plain
    engine (card_vs_cpu), with the qmm / qmm_int8 counts of
    FAMILY_PASSES; FLASH_FAMILIES again with flash_attn=True (flash_attention for the prompt,
    flash_decode for the steps or bert's short embedding). Then phase
    10c, the tokenizers of the gpt2 (BPE) and bert (WPM) models."""
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    out, toks = {}, {}
    for arch in FAMILIES:
        path = os.path.join(SMOKE_DIR, f"family_{arch}.gguf")
        write_family_gguf(path, arch, rng)
        gpu = Engine(path, n_ctx=n_ctx, device=device)
        cpu = Engine(path, n_ctx=n_ctx, device="cpu")
        per_pass, n_int8 = FAMILY_PASSES[arch]
        if len(quant_weights(gpu)) != per_pass:
            raise AssertionError(f"{arch}: {len(quant_weights(gpu))} "
                                 f"quantized projections, not {per_pass}")
        embeds = gpu.params.get("output") is None
        m_dec = 8 if embeds else 1
        prompt = rng.integers(5, gpu.cfg.vocab_size, size=prompt_len).tolist()
        runs = {}
        for mode in ("default",) + (("flash",) if arch in FLASH_FAMILIES
                                    else ()):
            if mode == "flash":
                gpu = Engine(path, n_ctx=n_ctx, flash_attn=True,
                             device=device)
            reset_port_launches()
            res = card_vs_cpu(gpu, cpu, prompt, steps,
                              runs.get("default", {}).get("ref"))
            n_dec = 1 if embeds else steps
            want = {"qmm": per_pass + (per_pass - n_int8) * n_dec,
                    "qmm_int8": n_int8 * n_dec}
            if mode == "flash":
                L = gpu.cfg.n_layers
                want.update(flash_attention=L, flash_decode=L * n_dec)
            got = expect_launches(f"{arch} {mode}", want)
            if not (got["qmm"] > 0 and got["qmm_int8"] > 0):
                raise AssertionError(f"{arch} {mode}: launches {got}")
            runs[mode] = {**res, "launches": {k: v for k, v in got.items()
                                              if v}}
            log(f"[families] {arch} {mode}: {gpu.cfg.n_layers} layers, "
                f"{per_pass} quantized projections a pass ({n_int8} through "
                f"qmm_int8 at M = {m_dec}); card vs CPU "
                f"{'pooled embedding' if embeds else 'prefill'} cosine "
                f"{res['cos_prefill']!r} (>= 0.999), "
                f"{'8-token embedding' if embeds else 'decode'} min cosine "
                f"{min(res['cos_steps'])!r} (>= 0.99); launches "
                f"{runs[mode]['launches']}")
        if gpu.tokenizer is not None:
            toks[arch] = gpu.tokenizer
        out[arch] = {m: {k: v for k, v in r.items() if k != "ref"}
                     for m, r in runs.items()}
        del gpu, cpu
        os.remove(path)
    t_fam = time.perf_counter() - t_phase
    out["tokenizers"] = phase_tokenizers(toks)
    log(f"[families] {len(FAMILIES)} families in {t_fam:.1f} s")
    return out


def phase_tokenizers(toks: dict) -> dict:
    """Phase 10c: the BPE tokenizer of the gpt2 model and the WPM one of
    the bert model, each built by build_tokenizer from the GGUF's
    synthetic vocab, round-trip ARCH_TEXTS: BPE decodes its ids back to
    the text; WPM (which lower-cases, strips accents and splits on
    punctuation) encodes its decoded text to the same ids."""
    from tpulamm_torch.tokenizer.bpe import BPETokenizer
    from tpulamm_torch.tokenizer.wpm import WPMTokenizer
    bpe, wpm = toks["gpt2"], toks["bert"]
    if not (isinstance(bpe, BPETokenizer) and isinstance(wpm, WPMTokenizer)):
        raise AssertionError(f"tokenizers {type(bpe)}, {type(wpm)}")
    out = {}
    for text in ARCH_TEXTS:
        ids = bpe.encode(text)
        if bpe.decode(ids) != text:
            raise AssertionError(f"BPE round trip of {text!r}: "
                                 f"{bpe.decode(ids)!r}")
        wids = wpm.encode(text)
        if wpm.encode(wpm.decode(wids)) != wids:
            raise AssertionError(f"WPM round trip of {text!r}: {wids}")
        out[text] = (len(ids), len(wids))
        log(f"[tokenizers] {text!r}: BPE {len(ids)} ids for "
            f"{len(text.encode())} bytes, WPM {len(wids)} ids "
            f"({wpm.decode(wids).strip()!r}); both round-trip")
    return out


# -- speculation and segments (phase 11) --------------------------------------
# TinyLlama-1.1B's published config with LLaMA's 32,000-token vocabulary
# (which TinyLlama shares): the draft of phase 11
TINYLLAMA_DRAFT = dict(TINYLLAMA, vocab=32000)
TINYLLAMA_LAYERS = 22
SPEC_K, SPEC_PREDICT = 4, 64
# predictions written before phase 11's first run on the card (PERF.md §5)
SPEC_PREDICTIONS = {
    "draft": "35-50 tok/s, accept rate < 0.01, 20-28 device ms a cycle",
    "self": "90-105 tok/s, accept rate 0.95-1.0",
    "sampled": "accept rate < 0.2 at temp 0.8",
    "lookup": "90-110 tok/s at accept < 0.1; above 116 where the greedy "
              "stream repeats",
    "tree": "30-45 tok/s",
    "lookahead": "5-10 tok/s (host loop, eager forwards)",
}


def spec_cycle_launches(n_layers_t: int, n_layers_d: int, k: int) -> int:
    """qmm_int8 launches of one draft-model cycle: k draft steps (4 a
    layer + the lm head), the draft's last KV write (no head), the
    (1, 1+k) target verify (4 a layer + the head; M = 1+k <= 16)."""
    return k * (4 * n_layers_d + 1) + 4 * n_layers_d + 4 * n_layers_t + 1


def parting_gap(ref, prompt: list, want: list, got: list, adjust=None):
    """(index of the first parting of got from want or None, the top-two
    gap over max|logit| of ref's logits there, teacher-forced through
    want and taken through adjust(logits, history); None where a length
    differs)."""
    i = first_parting(want, got)
    if i is None or i >= min(len(want), len(got)):
        return i, None
    ref.reset_slot(0)
    lg = ref.prefill(0, prompt)
    for t in want[:i]:
        lg = ref.decode_one(0, t)
    gap = tie_gap(lg if adjust is None else adjust(lg, prompt + want[:i]))
    ref.reset_slot(0)
    return i, gap


def greedy_parting(ref, prompt: list, want: list, got: list,
                   label: str, adjust=None) -> str:
    """got against plain greedy tokens `want` of the same prompt: equal, or
    parted at a near tie (top-two gap <= TIE of max|logit|) of ref's
    decode logits teacher-forced through want, taken through
    adjust(logits, history) where the greedy choice was made from adjusted
    logits (a repeat penalty). Raises otherwise."""
    i, gap = parting_gap(ref, prompt, want, got, adjust)
    if i is None:
        return f"the same {len(got)} tokens"
    if gap is None:
        raise AssertionError(f"{label}: {len(got)} tokens, want {len(want)}")
    if gap > TIE:
        raise AssertionError(f"{label}: parted at token {i} ({want[i]} vs "
                             f"{got[i]}), top-two gap {gap:.3g} > {TIE}")
    return f"parted at token {i} of {len(got)} at a near tie (gap {gap:.3g})"


def spec_run(label: str, fn, *a, **kw):
    """A speculator's call timed, its launches counted from 0 ->
    (tokens, stats, seconds, launches, decode tok/s after the first)."""
    target = a[0]
    target.timings = Timings()
    reset_port_launches()
    t0 = time.perf_counter()
    out, _, stats = fn(*a, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in port_launches().items() if v}
    tok_s = (len(out) - 1) / max(target.timings.t_eval, 1e-9)
    log(f"[spec] {label}: {len(out)} tokens in {dt:.2f} s, decode "
        f"{tok_s:.2f} tok/s, {stats.n_target_steps} cycles, drafted "
        f"{stats.n_drafted}, accepted {stats.n_accepted} (rate "
        f"{stats.accept_rate:.4f}), launches {launches}")
    return out, stats, dt, launches, tok_s


def cycle_profile(eng, label: str, mode_key: str, cur: int, start: int,
                  need: int, n_cycles: int = 4) -> dict:
    """torch.profiler over replays of the captured cycle of `mode_key`
    (the first graph of the engine whose key begins with it), each staged
    from the same position: wall and device ms a cycle."""
    key = next(k for k in eng.graphs.graphs if k[0] == mode_key)
    g = eng.graphs.graphs[key]

    def step():
        TS._stage1(g.bufs, cur, start, need, eng.n_ctx, 10 ** 6, -1, 0.0)
        for _ in range(n_cycles):
            g.replay()
    out = profile_steps(eng, label, step, steps=2, per=n_cycles)
    eng.rollback(0, start)
    return out


def weight_twin(eng):
    """A second Engine over `eng`'s weights (the same tensors) with a cache,
    step graphs, host mirrors and generator of its own: the target as its
    own draft, without a second load of the model."""
    import copy
    twin = copy.copy(eng)
    c = eng.cache
    twin.cache = KVCache.create(
        len(c.k), eng.n_slots, eng.n_ctx + 1, c.k[0].shape[1],
        c.k[0].shape[3], dtype=c.k[0].dtype, dtype_v=c.v[0].dtype,
        device=eng.device)
    twin.graphs = DG.DecodeGraphs(eng.device, eng.n_ctx)
    twin.n_past = np.zeros_like(eng.n_past)
    twin.cell_pos = np.full_like(eng.cell_pos, -1)
    twin.ga_i = np.zeros_like(eng.ga_i)
    twin._gen = torch.Generator(device=eng.device)
    twin.timings = Timings()
    return twin


def phase_speculation(device, rng, path: str, n_layers: int, smi: str,
                      shape=LLAMA_7B, prompt_len: int = PROMPT,
                      n_predict: int = SPEC_PREDICT, k: int = SPEC_K) -> dict:
    """Phase 11a and 11b at full width on the phase-4 model (the target,
    Engine(n_ctx=2048)): a TinyLlama-1.1B-width draft (22 layers, GQA 32 /
    4, vocab 32000, its own seed); generate_speculative_fast at k 4, greedy,
    512 tokens in and 64 out, against generate_fast's greedy tokens (a
    parting only at a near tie), with exact launches a cycle; a self draft
    (a second engine of the target file) and its accept rate; temp 0.8
    twice with one seed (the same tokens); a profiled cycle; then
    generate_prompt_lookup_fast on a repetitive prompt, the tree with
    n_seq_dft 2 and lookahead against greedy decoding."""
    t_phase = time.perf_counter()
    dpath = os.path.join(SMOKE_DIR, "tinyllama_shape_q4_0_22l.gguf")
    write_llama_gguf(dpath, TINYLLAMA_LAYERS, rng, **TINYLLAMA_DRAFT)
    target = Engine(path, n_ctx=2048, device=device)
    draft = Engine(dpath, n_ctx=2048, device=device)
    log(f"[spec] target {n_layers} layers (LLaMA-7B shape), draft "
        f"{TINYLLAMA_LAYERS} layers (TinyLlama-1.1B width, "
        f"{os.path.getsize(dpath) / 1e9:.3f} GB) loaded in "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    out = {}
    target.generate_fast(prompt, n_predict=n_predict, stop_on_eos=False)
    target.timings = Timings()
    plain, _ = target.generate_fast(prompt, n_predict=n_predict,
                                    stop_on_eos=False)
    out["plain_tok_s"] = (len(plain) - 1) / target.timings.t_eval
    log(f"[spec] generate_fast: {out['plain_tok_s']:.2f} tok/s decode "
        f"({smi})")
    # draft-model speculation, greedy: the first run captures the cycle
    TS.generate_speculative_fast(target, draft, prompt, n_predict=n_predict,
                                 n_draft=k, stop_on_eos=False)
    got, st, _, launches, tok_s = spec_run(
        "draft k=4 greedy", TS.generate_speculative_fast, target, draft,
        prompt, n_predict=n_predict, n_draft=k, stop_on_eos=False)
    per_cycle = spec_cycle_launches(n_layers, TINYLLAMA_LAYERS, k)
    expect_launches("spec draft", {
        "qmm": 4 * n_layers + 1 + 4 * TINYLLAMA_LAYERS + 1,
        "qmm_int8": per_cycle * st.n_target_steps})
    log(f"[spec] draft launches exact: qmm {4 * n_layers + 1} + "
        f"{4 * TINYLLAMA_LAYERS + 1} for the two prefills, qmm_int8 "
        f"{per_cycle} a cycle ({k} x {4 * TINYLLAMA_LAYERS + 1} draft steps "
        f"+ {4 * TINYLLAMA_LAYERS} for the draft's last write + "
        f"{4 * n_layers + 1} for the verify) x {st.n_target_steps} cycles")
    log(f"[spec] draft greedy vs generate_fast: "
        f"{greedy_parting(target, prompt, plain, got, 'draft')}")
    out.update(draft_tok_s=tok_s, draft_accept=st.accept_rate)
    out.update(cycle_profile(target, "spec_cycle", "spec", plain[0],
                             prompt_len, k))
    log(f"[spec] draft: {tok_s:.2f} tok/s against generate_fast's "
        f"{out['plain_tok_s']:.2f}, accept {st.accept_rate:.4f}, "
        f"{out['spec_cycle_busy_ms']:.3f} device ms a cycle ({smi}); "
        f"predicted {SPEC_PREDICTIONS['draft']}")
    # sampled, one seed twice
    runs = []
    for _ in range(2):
        runs.append(spec_run("draft k=4 temp 0.8 seed 5",
                             TS.generate_speculative_fast, target, draft,
                             prompt, n_predict=n_predict, n_draft=k,
                             temp=0.8, seed=5, stop_on_eos=False))
    if runs[0][0] != runs[1][0]:
        raise AssertionError("spec temp 0.8: one seed gave two outputs")
    out["sampled_accept"] = runs[0][1].accept_rate
    log(f"[spec] temp 0.8 twice with one seed: the same {len(runs[0][0])} "
        f"tokens, accept {out['sampled_accept']:.4f} ({smi}); predicted "
        f"{SPEC_PREDICTIONS['sampled']}")
    # the target as its own draft: a second engine over the same weights
    selfd = weight_twin(target)
    TS.generate_speculative_fast(target, selfd, prompt, n_predict=n_predict,
                                 n_draft=k, stop_on_eos=False)
    got, st, _, _, tok_s = spec_run(
        "self draft k=4 greedy", TS.generate_speculative_fast, target,
        selfd, prompt, n_predict=n_predict, n_draft=k, stop_on_eos=False)
    out.update(self_tok_s=tok_s, self_accept=st.accept_rate)
    log(f"[spec] self draft vs generate_fast: "
        f"{greedy_parting(target, prompt, plain, got, 'self')}; "
        f"{tok_s:.2f} tok/s, accept {st.accept_rate:.4f} ({smi}); "
        f"predicted {SPEC_PREDICTIONS['self']}")
    del selfd
    # 11b: prompt lookup on a repetitive prompt
    rep = (prompt[:64] * (prompt_len // 64))[:prompt_len]
    rplain, _ = target.generate_fast(rep, n_predict=n_predict,
                                     stop_on_eos=False)
    # (no warm-up run: the tok/s of lookup and the tree include capture)
    got, st, _, launches, tok_s = spec_run(
        "lookup k=4 greedy, capture included",
        TS.generate_prompt_lookup_fast, target, rep, n_predict=n_predict,
        n_draft=k, stop_on_eos=False)
    expect_launches("spec lookup", {
        "qmm": 4 * n_layers + 1,
        "qmm_int8": (4 * n_layers + 1) * st.n_target_steps})
    out.update(lookup_tok_s=tok_s, lookup_accept=st.accept_rate)
    log(f"[spec] lookup vs generate_fast: "
        f"{greedy_parting(target, rep, rplain, got, 'lookup')}; launches "
        f"exact ({4 * n_layers + 1} qmm_int8 a cycle); {tok_s:.2f} tok/s, "
        f"accept {st.accept_rate:.4f} ({smi}); predicted "
        f"{SPEC_PREDICTIONS['lookup']}")
    # the tree, n_seq_dft 2, with the TinyLlama-width draft
    n_tree = 32
    got, st, _, _, tok_s = spec_run(
        "tree k=4 n_seq_dft=2, capture included",
        ST.generate_speculative_tree, target, draft,
        prompt, n_predict=n_tree, n_draft=k, n_seq_dft=2, stop_on_eos=False)
    out["tree_tok_s"] = tok_s
    log(f"[spec] tree vs generate_fast: "
        f"{greedy_parting(target, prompt, plain[:n_tree], got, 'tree')}; "
        f"{tok_s:.2f} tok/s, drafted {st.n_drafted} ({smi}); predicted "
        f"{SPEC_PREDICTIONS['tree']}")
    del draft
    os.remove(dpath)
    # lookahead (host loop on eval_segmented); greedy, no penalty
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0)
    n_la = 16
    target.reset_slot(0)
    t0 = time.perf_counter()
    la, _, st = generate_lookahead(target, prompt, n_predict=n_la,
                                   sampling=greedy, W=4, N=3, G=4,
                                   stop_on_eos=False)
    dt = time.perf_counter() - t0
    log(f"[spec] lookahead W 4 N 3 G 4 vs generate_fast: "
        f"{greedy_parting(target, prompt, plain[:n_la], la, 'lookahead')}; "
        f"{n_la / dt:.2f} tok/s with its prefill, {st.n_target_steps} "
        f"steps, accepted {st.n_accepted} ({smi}); predicted "
        f"{SPEC_PREDICTIONS['lookahead']}")
    out.update(graph_report(target, "spec"))
    out["s"] = time.perf_counter() - t_phase
    log(f"[spec] phase 11a + 11b (full width) in {out['s']:.1f} s")
    return out


@contextlib.contextmanager
def spec_recording():
    """Record the tokens each speculator returns while a CLI runs ->
    {"out": [...]} (the last call's)."""
    from tpulamm_torch.runtime import lookahead as LA
    rec = {"out": None}
    saved = []
    for mod, name in ((TS, "generate_speculative"),
                      (TS, "generate_prompt_lookup"),
                      (TS, "generate_speculative_fast"),
                      (TS, "generate_prompt_lookup_fast"),
                      (ST, "generate_speculative_tree"),
                      (LA, "generate_lookahead")):
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def call(*a, _orig=orig, **kw):
            res = _orig(*a, **kw)
            rec["out"] = list(res[0])
            return res
        setattr(mod, name, call)
    try:
        yield rec
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


SPEC_CLI_MODES = {
    "lookup": ([], "host"),
    "lookup --ondevice": (["--ondevice"], "fast"),
    "-md": (["-md", "{draft}"], "host"),
    "-md --ondevice": (["-md", "{draft}", "--ondevice"], "fast"),
    "-md -np 2": (["-md", "{draft}", "-np", "2"], "fast"),
    "--lookahead": (["--lookahead", "-lw", "4", "-ln", "3", "-lg", "4"],
                    "host"),
}


def phase_spec_small(device, rng, smi: str, shape=LLAMA_7B,
                     n_layers: int = 2, n_ctx: int = 1024) -> dict:
    """Phase 11b's eval_segmented and 11c at 2 layers of LLaMA-7B width:
    eval_segmented of a branch layout on the card against the CPU plain
    engine (cosine >= 0.999 a row, the two probes apart); the server with
    4 slots, --lookup-decoding and -md (the target as its own draft), its
    greedy text against the plain server's (a parting only at a near tie),
    the spec counters > 0, a compound-verify block from a mix of greedy
    and sampled slots, and the compound verify's exact qmm launches and
    greedy tokens. 11d at 2 layers of TinyLlama
    width (a 1-layer draft): cli.speculative in every mode and cli.gritlm
    on the card against the CPU plain path's greedy choices."""
    t_phase = time.perf_counter()
    path = os.path.join(SMOKE_DIR, "llama7b_shape_q4_0_2l_spec.gguf")
    write_llama_gguf(path, n_layers, rng, **shape)
    out = {}
    gpu = Engine(path, n_ctx=n_ctx, device=device)
    cpu = Engine(path, n_ctx=n_ctx, device="cpu")
    prompt = rng.integers(3, shape["vocab"], size=64).tolist()
    n = len(prompt)
    pack = [1 | (1 << 16), 2 | (2 << 16)]
    batch = (np.array([11, 23, 40, 40], np.int32),
             np.array([n, n, n + 1, n + 1], np.int32),
             np.array(pack + pack, np.int32))
    lg = []
    for eng in (gpu, cpu):
        eng.prefill(0, prompt)
        lg.append(eng.eval_segmented(0, *batch))
    cos = [cosine(a, b) for a, b in zip(*lg)]
    if not (np.isfinite(lg[0]).all() and min(cos) >= 0.999):
        raise AssertionError(f"eval_segmented card vs CPU cosines {cos}")
    # each probe sees its own branch only: the same token at the same
    # position, two histories, two sets of logits
    apart = float(np.abs(lg[0][2] - lg[0][3]).max())
    if not apart > 1e-3 * float(np.abs(lg[0][2]).max()):
        raise AssertionError(f"eval_segmented: the two probes' logits on "
                             f"the card are within {apart:.3g}")
    log(f"[spec-small] eval_segmented (2 branches, 2 probes) card vs CPU: "
        f"cosines {[round(c, 8) for c in cos]} (>= 0.999); the probes "
        f"apart by {apart:.4g} on the card")
    del gpu
    # 11c: the server, plain, then --lookup-decoding -md (self draft)
    rep = (prompt[:16] * 4)
    greedy = {"temperature": 0.0, "repeat_penalty": 1.0, "n_predict": 48,
              "ignore_eos": True}
    pieces, engines = {}, {}
    for label, kw in (("plain", {}),
                      ("spec", dict(lookup_decoding=True,
                                    model_draft=path))):
        started, base = boot_server(path, device, n_slots=4, n_ctx=n_ctx,
                                    **kw)
        pieces[label] = [http_stream(base, "/completion",
                                     dict(greedy, prompt=p))["pieces"]
                         for p in (prompt, rep)]
        if label == "spec":
            m0 = metrics_of(base)
            # a mix of greedy and sampled slots: the compound verify
            sampled = {"temperature": 0.8, "top_k": 40, "top_p": 1.0,
                       "min_p": 0.0, "repeat_penalty": 1.0, "seed": 3,
                       "n_predict": 48, "ignore_eos": True}
            with ThreadPoolExecutor(4) as ex:
                list(ex.map(lambda b: http(base, "/completion", b), [
                    dict(greedy, prompt=prompt), dict(sampled, prompt=rep),
                    dict(greedy, prompt=rep), dict(sampled, prompt=prompt)]))
            m = metrics_of(base)
        engines[label] = started.sched.engine
        stop_server(started)
    spec = {key: m[key] for key in m if key.startswith("spec")}
    mixed = {key: m[key] - m0[key] for key in ("spec_blocks_total",
                                                "spec_draft_blocks_total")}
    n_verify = mixed["spec_blocks_total"] - mixed["spec_draft_blocks_total"]
    log(f"[spec-small] server counters after the requests: {spec}; the "
        f"mixed batch added {mixed['spec_blocks_total']:g} spec blocks, "
        f"{n_verify:g} of them not from the draft (compound verify)")
    if not (m["spec_blocks_total"] > 0 and m["spec_accepted_total"] > 0
            and m["spec_draft_blocks_total"] > 0 and n_verify > 0):
        raise AssertionError(f"server spec counters {spec}, the mixed "
                             f"batch's {mixed}")
    for p, a, b in zip((prompt, rep), pieces["plain"], pieces["spec"]):
        i = first_parting(a, b)
        verdict = f"the same {len(b)} tokens"
        if i is not None:
            gap, big = near_tie(engines["plain"], p, i)
            if gap > TIE * big:
                raise AssertionError(f"server: the speculative greedy text "
                                     f"parted at token {i}, gap "
                                     f"{gap / big:.3g}")
            verdict = f"parted at token {i} at a near tie ({gap / big:.3g})"
        log(f"[spec-small] speculative server vs plain server, greedy: "
            f"{verdict}")
    eng = engines.pop("spec")
    del engines
    # the compound verify on the stopped server's engine: exact launches
    hists = {s: (prompt[:20] * 2)[:30 + s] for s in range(4)}
    for s, h in hists.items():
        eng.reset_slot(s)
        eng.prefill(s, h)
    reset_port_launches()
    rows, accs, n_steps, posv, _ = eng.spec_lookup_block_multi(
        {s: 7 + s for s in range(4)}, hists, {s: 24 for s in range(4)},
        {s: -1 for s in range(4)}, {s: 0.8 * (s % 2) for s in range(4)},
        11, SPEC_K, 16, False, 40)
    expect_launches("compound verify",
                    {"qmm": (4 * n_layers + 1) * n_steps})
    log(f"[spec-small] compound verify (B 4 x {1 + SPEC_K} rows: M = "
        f"{4 * (1 + SPEC_K)} > 16), 2 greedy + 2 sampled slots: "
        f"{n_steps} cycles, exactly {4 * n_layers + 1} qmm a cycle, "
        f"accepted {accs[:n_steps].sum(axis=0).tolist()} a slot")
    # the greedy slots' tokens (qmm at M = 20) against greedy decoding of
    # each slot's history (the decode graphs: qmm_int8 at M = 1)
    for s in (0, 2):
        got = [int(t) for r in rows[:n_steps, s] for t in r if t >= 0]
        h = hists[s] + [7 + s]
        eng.reset_slot(0)
        want = eng.generate_fast(h, n_predict=len(got),
                                 stop_on_eos=False)[0]
        log(f"[spec-small] compound verify, greedy slot {s} against greedy "
            f"decoding of its history: "
            f"{greedy_parting(eng, h, want, got, f'verify slot {s}')}")
    del eng, cpu
    os.remove(path)
    # 11d: cli.speculative in every mode, cli.gritlm, on a 2-layer
    # TinyLlama-width target with a 1-layer draft of the same widths (the
    # CLIs load their engines each run)
    path = os.path.join(SMOKE_DIR, "tinyllama_shape_q4_0_2l_cli.gguf")
    dpath = os.path.join(SMOKE_DIR, "tinyllama_shape_q4_0_1l_cli.gguf")
    write_llama_gguf(path, n_layers, rng, **TINYLLAMA_DRAFT)
    write_llama_gguf(dpath, 1, rng, **TINYLLAMA_DRAFT)
    cpu = Engine(path, n_ctx=n_ctx, device="cpu")
    text = "the cat sat on the mat"
    base = ["-m", path, "-p", text, "-n", "16", "--draft", "3", "-c",
            str(n_ctx), "--ignore-eos", "--device", device.type]
    ids = cpu.tokenizer.encode(text, special=True)
    cpu.reset_slot(0)
    ref = {"fast": cpu.generate_fast(ids, n_predict=16, stop_on_eos=False)[0]}
    cpu.reset_slot(0)
    ref["host"] = cpu.generate(ids, n_predict=16,
                               sampling=SamplingParams(temp=0.0,
                                                       ignore_eos=True),
                               stop_on_eos=False)[0]
    for mode, (extra, kind) in SPEC_CLI_MODES.items():
        argv = base + [a.format(draft=dpath) for a in extra]
        with spec_recording() as rec:
            rc, _, err, dt = run_cli(f"spec-cli {mode}", SC_CLI.main, argv)
        if rc != 0 or rec["out"] is None:
            raise AssertionError(f"cli.speculative {mode}: exit {rc}")
        # the host modes choose from penalized logits (--repeat-penalty 1.1
        # over the last 64 tokens, the CLI's defaults)
        adjust = ((lambda lg, h: penalized(lg, h, 64, 1.1))
                  if kind == "host" else None)
        verdict = greedy_parting(cpu, ids, ref[kind], rec["out"],
                                 f"cli.speculative {mode}", adjust)
        log(f"[spec-small] cli.speculative {mode}: {verdict} against the "
            f"CPU's {kind} greedy choices, {dt:.1f} s")
    res = {}
    orig = Engine.generate_fast
    for where in (device.type, "cpu"):
        rec = {}

        def gen_fast(self, prompt, _orig=orig, _rec=rec, **kw):
            _rec["prompt"] = self._encode(prompt)
            _rec["toks"] = _orig(self, prompt, **kw)[0]
            return _rec["toks"], self.tokenizer.decode(_rec["toks"])
        Engine.generate_fast = gen_fast
        try:
            rc, gout, _, dt = run_cli(f"gritlm {where}", GRITLM.main,
                                      ["-m", path, "-c", str(n_ctx), "-n",
                                       "8", "--device", where])
        finally:
            Engine.generate_fast = orig
        if rc != 0:
            raise AssertionError(f"cli.gritlm on {where}: exit {rc}")
        res[where] = ([float(x) for x in re.findall(r"is: (-?[0-9.]+)",
                                                    gout)], rec)
    sims = np.abs(np.subtract(res[device.type][0], res["cpu"][0]))
    if len(res["cpu"][0]) != 4 or sims.max() > 1e-2:
        raise AssertionError(f"gritlm cosines card vs CPU {res}")
    crec, grec = res["cpu"][1], res[device.type][1]
    verdict = greedy_parting(cpu, crec["prompt"], crec["toks"], grec["toks"],
                             "gritlm")
    log(f"[spec-small] cli.gritlm: cosine matrix card vs CPU within "
        f"{sims.max():.4f}; generation {verdict}")
    del cpu
    for p in (path, dpath):
        os.remove(p)
    out["s"] = time.perf_counter() - t_phase
    log(f"[spec-small] phase 11b-d (2 layers) in {out['s']:.1f} s")
    return out


# -- phase 12: mamba and llava (slice 17) -------------------------------------

# state-spaces/mamba-2.8b-hf's config.json: hidden 2560, intermediate (d_inner)
# 5120, state 16, conv kernel 4, time_step_rank 160, vocab 50280, the head
# tied to the embedding; 64 layers, run at 16
MAMBA_2_8B = dict(dim=2560, d_inner=5120, d_state=16, d_conv=4, dt_rank=160,
                  vocab=50280)
MAMBA_LAYERS = 16
# openai/clip-vit-large-patch14-336, llava-1.5's and llava-v1.6's tower:
# hidden 1024, 24 layers (llava reads layer -2: 23 written), 16 heads, ffn
# 4096, image 336, patch 14, quick_gelu; llava-1.5's mlp projector to 4096
CLIP_VIT_L_336 = dict(hidden=1024, n_heads=16, n_layers=24, ffn=4096,
                      image=336, patch=14, proj_dim=4096, skip_last=1)
LLAVA_PROMPT = "USER: <image>\ndescribe the image ASSISTANT:"
# the card's bf16 CLIP encode against the CPU's f32 plain encode
MIN_CLIP_COS = 0.995
# phase 12's launch counts, written before its first chip run (PERF.md
# section 5): ssm_in and ssm_out tile and take qmm for a 512-token ubatch
# and qmm_int8 a decode step; ssm_x (N 192), ssm_dt (K 160) and the
# 50,280-row tied head do not tile and stay dense
MAMBA_LAUNCHES_A_LAYER = {"qmm": 2, "qmm_int8": 2}
# what phase 12 was predicted to show, written before its first chip run
# (PERF.md section 5)
MAMBA_PREDICTIONS = {
    "prefill tok/s": "3,000-8,000", "decode tok/s": "300-600",
    "decode busy ms": "1.5-3.0", "head share of a step": "25-40%",
    "phase 12a s": "30-60",
}
LLAVA_PREDICTIONS = {
    "clip encode ms (1 tile / 5 tiles)": "5-30 / 20-150",
    "embeddings (1.5 / anyres)": "576 / 2,928",
    "flash_attention (1.5 / anyres)": "4 / 12", "phase 12b s": "30-60",
}
# the prefill ubatches (n_ubatch 512) of each cli.llava run that launch
# flash_attention once a layer: those whose bucket has >= 64 rows at a span
# of >= 1,024 cells (Engine.flash_choice); the decode steps run einsum
# below span 8,192. LLAVA_PROMPT is 12 tokens before <image> (BOS
# included; bucket 16: einsum) and 39 after it (bucket 64: flash once the
# span is 1,024).
# 1.5: embeddings 512 (cells 524, span 1,024) + 64 (588) + the 39 text
# tokens (627) = 3 ubatches, 6 launches at 2 layers. anyres: embeddings
# 5 x 512 + 368 (cells up to 2,940) + the 39 text tokens = 7 ubatches, 14
# launches. (The prediction above, 4 / 12, left out the text ubatch.)
LLAVA_FLASH_UBATCHES = {"1.5": 3, "1.6": 7}


def phase_mamba(device, rng, smi: str, shape=MAMBA_2_8B,
                n_layers: int = MAMBA_LAYERS, cmp_layers: int = 2,
                prompt_len: int = PROMPT, n_steps: int = 64,
                n_ctx: int = 1024, cmp_prompt: int = 64,
                steps: int = 8) -> dict:
    """Phase 12a: a mamba-2.8b-width Q4_0 model cut to n_layers, written by
    tools.synth.write_mamba_gguf through convert_hf, in Engine(n_ctx):
    generate_fast on a 512-token prompt for one 64-step block through the
    step graph, twice (the same tokens; the second run's launches exactly
    MAMBA_LAUNCHES_A_LAYER x layers for the ubatch and a step); a profiled
    decode step and prefill, the dense head timed alone; the session file
    round trip (the state back in place, the next logits equal); then a
    cmp_layers model of the same widths on the card against the CPU plain
    engine (cosines at the default compute; greedy tokens at float32
    compute parting only at a near tie, and at the default compute
    printed)."""
    from tpulamm_torch.models.transformer import _proj
    from tpulamm_torch.runtime import session
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    seed = int(rng.integers(1 << 30))
    path = os.path.join(SMOKE_DIR, f"mamba_2_8b_width_q4_0_{n_layers}l.gguf")
    t0 = time.perf_counter()
    write_mamba_gguf(path, n_layers, seed, **shape)
    t_write = time.perf_counter() - t0
    prompt = rng.integers(3, shape["vocab"], size=prompt_len).tolist()
    t0 = time.perf_counter()
    eng = Engine(path, n_ctx=n_ctx, device=device)
    t_load = time.perf_counter() - t0
    lyr = eng.params["layers"][0]
    dense = [k for k in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out")
             if not isinstance(lyr[k], QTensor)]
    if not isinstance(eng.params["output"], QTensor):
        dense.append("output (tied)")
    if not eng.recurrent or dense != ["ssm_x", "ssm_dt", "output (tied)"]:
        raise AssertionError(f"mamba: recurrent {eng.recurrent}, dense "
                             f"{dense}")
    ids_a, _ = eng.generate_fast(prompt, n_predict=n_steps + 1,
                                 stop_on_eos=False)
    eng.timings = Timings()
    reset_port_launches()
    ids_b, _ = eng.generate_fast(prompt, n_predict=n_steps + 1,
                                 stop_on_eos=False)
    tm = eng.timings
    want = {k: v * n_layers for k, v in MAMBA_LAUNCHES_A_LAYER.items()}
    got = expect_launches("mamba", {"qmm": want["qmm"],
                                    "qmm_int8": want["qmm_int8"] * tm.n_step})
    if ids_a != ids_b or tm.n_step != n_steps:
        raise AssertionError(f"mamba: two greedy runs disagree or ran "
                             f"{tm.n_step} steps, not {n_steps}")
    out = {"write_s": t_write, "load_s": t_load, "layers": n_layers,
           "launches": {k: v for k, v in got.items() if v},
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": (len(ids_b) - 1) / tm.t_eval}
    log(f"[mamba] {n_layers} of 64 layers at mamba-2.8b width: write "
        f"{t_write:.2f} s (convert_hf, Q4_0), load {t_load:.2f} s; dense "
        f"{dense}; prefill {prompt_len} tokens {out['prefill_tok_s']:.1f} "
        f"tok/s, one {tm.n_step}-step generate_fast block "
        f"{out['decode_tok_s']:.2f} tok/s; launches {out['launches']} "
        f"(expected {want['qmm']} qmm for the ubatch and {want['qmm_int8']} "
        "qmm_int8 a step); two runs gave the same tokens")
    graph_report(eng, "mamba")
    if device.type == "cuda":
        out["decode_one_ms"] = wall_ms(lambda: eng.decode_one(0, 5))
        out.update(profile_steps(eng, "mamba_decode",
                                 lambda: eng.decode_one(0, 5)))
        out.update(profile_steps(
            eng, "mamba_prefill",
            lambda: (eng.reset_slot(0), eng.prefill(0, prompt)), steps=1))
        h = torch.randn(1, 1, shape["dim"], device=device).to(eng.cfg.cdtype)
        head = eng.params["output"]
        out["head_ms"] = time_ms(lambda: _proj(h, head, eng.cfg), device)
        st = eng.cache
        state_b = 2 * (st.conv[:, 0].numel() + st.ssm[:, 0].numel()) * 4
        gguf_b = gguf_step_bytes(path)
        port_b = (sum(w.n_bytes for w in quant_weights(eng))
                  + sum(lyr[k].numel() * lyr[k].element_size()
                        for lyr in eng.params["layers"]
                        for k in ("ssm_x", "ssm_dt"))
                  + head.numel() * (head.element_size() + 2 * 4) + state_b)
        busy = out["mamba_decode_busy_ms"]
        out["bound_ms"] = (gguf_b + state_b) / HBM_BYTES_PER_S * 1e3
        log(f"[mamba] decode step: {out['decode_one_ms']:.3f} ms wall (no "
            f"profiler), {busy:.3f} ms on the device; the dense tied head "
            f"alone {out['head_ms']:.4f} ms ({out['head_ms'] / busy:.1%} of "
            f"the step; bf16 {tuple(head.shape)} read, made f32 and read "
            f"again); it must read {gguf_b / 1e9:.4f} GB of GGUF blocks and "
            f"{state_b / 1e6:.2f} MB of state: bound {out['bound_ms']:.4f} ms "
            f"at 3.35 TB/s ({out['bound_ms'] / busy:.1%} of the step); the "
            f"port moves ~{port_b / 1e9:.4f} GB a step")
    # the session file: the state back into its buffers in place
    sess = os.path.join(SMOKE_DIR, "mamba.session")
    eng.reset_slot(0)
    eng.prefill(0, prompt[:cmp_prompt])
    saved = (eng.cache.conv.clone(), eng.cache.ssm.clone())
    t0 = time.perf_counter()
    session.save_session(sess, eng, prompt[:cmp_prompt])
    t_save = time.perf_counter() - t0
    before = eng.decode_one(0, 7)
    eng.reset_slot(0)
    ptr = eng.cache.ssm.data_ptr()
    toks = session.load_session(sess, eng)
    if (toks != prompt[:cmp_prompt] or int(eng.n_past[0]) != cmp_prompt
            or eng.cache.ssm.data_ptr() != ptr
            or not torch.equal(eng.cache.ssm, saved[1])
            or not torch.equal(eng.cache.conv, saved[0])):
        raise AssertionError("mamba: the session did not restore the state")
    after = eng.decode_one(0, 7)
    err = float(np.abs(after - before).max() / np.abs(before).max())
    if err > 1e-6:
        raise AssertionError(f"mamba: logits after the session load differ "
                             f"({err:.3g} of max|logit|)")
    log(f"[mamba] session file: {os.path.getsize(sess) / 1e6:.2f} MB saved in "
        f"{t_save:.3f} s, loaded in place (the state equal bit for bit), the "
        f"next step's logits within {err:.3g} of max|logit| (<= 1e-6)")
    os.remove(sess)
    del eng
    os.remove(path)
    # the card against the CPU plain engine at cmp_layers: logits at the
    # default compute (the card's decode steps take int8 activations);
    # greedy tokens at float32 compute, where both compute one function
    # (qmm at every M on the card), as phase 8 compares its perplexities
    path = os.path.join(SMOKE_DIR, f"mamba_2_8b_width_q4_0_{cmp_layers}l.gguf")
    write_mamba_gguf(path, cmp_layers, seed, **shape)
    gpu = Engine(path, n_ctx=256, device=device)
    cpu = Engine(path, n_ctx=256, device="cpu")
    cmp = card_vs_cpu(gpu, cpu, prompt[:cmp_prompt], steps)
    log(f"[mamba] card vs CPU plain engine ({cmp_layers} layers): prefill "
        f"{cmp_prompt} tokens cosine {cmp['cos_prefill']!r} (>= 0.999); "
        f"{steps} teacher-forced decode steps cosines "
        f"{[round(c, 6) for c in cmp['cos_steps']]} (>= 0.99)")
    greedy = {}
    for cdt, (g, c) in (("bfloat16", (gpu, cpu)), ("float32", (
            Engine(path, n_ctx=256, device=device, compute_dtype="float32"),
            Engine(path, n_ctx=256, device="cpu",
                   compute_dtype="float32")))):
        greedy[cdt] = [e.generate_fast(prompt[:cmp_prompt], n_predict=17,
                                       stop_on_eos=False)[0] for e in (g, c)]
        if cdt == "float32":
            verdict = greedy_parting(c, prompt[:cmp_prompt], greedy[cdt][1],
                                     greedy[cdt][0], "mamba greedy card vs "
                                     "CPU at float32")
        else:
            i, gap = parting_gap(c, prompt[:cmp_prompt], greedy[cdt][1],
                                 greedy[cdt][0])
            verdict = ("the same 17 tokens" if i is None else
                       f"parted at token {i}, the CPU's top-two gap {gap!r} "
                       "of max|logit| (not held: int8 activations)")
        log(f"[mamba] generate_fast 17 greedy tokens, card vs CPU at "
            f"{cdt} compute: {verdict}")
    del gpu, cpu
    os.remove(path)
    out.update(cos_prefill=cmp["cos_prefill"],
               cos_decode_min=min(cmp["cos_steps"]))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[mamba] phase 12a {out['phase_s']:.1f} s; predicted "
        f"{MAMBA_PREDICTIONS}; {smi}")
    return out


def host_ms(call, device, n: int = 3) -> float:
    """wall_ms on the card (synchronized), the host clock on the CPU."""
    if device.type == "cuda":
        return wall_ms(call, n)
    t0 = time.perf_counter()
    call()
    return (time.perf_counter() - t0) * 1e3


def phase_llava(device, rng, smi: str, clip=CLIP_VIT_L_336,
                lm_shape=LLAMA_7B, pinpoints=LLAVA16_PINPOINTS,
                lm_layers: int = 2, n_predict: int = 16,
                n_ctx: int = 4096) -> dict:
    """Phase 12b: a full-width CLIP ViT-L/14-336 mmproj (llava-1.5's mlp
    projector to 4096) written by tools.synth.write_clip_gguf through
    convert_hf_clip, twice from one seed: without and with llava-v1.6's
    image_grid_pinpoints (spatial_unpad, an image_newline); a language
    model of lm_layers at LLaMA-7B / Vicuna-7B width with an SPM vocab.
    The card's bf16 encode of a 336 x 336 image against the CPU's f32
    plain encode (cosine >= MIN_CLIP_COS) and the encode times; then
    cli.llava in process on a 336 x 336 .npy image (576 embeddings) and on
    a 672 x 672 one through anyres, each launching flash_attention as
    LLAVA_FLASH_UBATCHES says besides qmm and qmm_int8.
    Returns the language model's path (phase 12c uses it)."""
    from tpulamm_torch.cli import llava as LLAVA
    from tpulamm_torch.models import clip as CLIP
    t_phase = time.perf_counter()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    seed = int(rng.integers(1 << 30))
    lm = os.path.join(SMOKE_DIR, f"llava_lm_7b_width_q4_0_{lm_layers}l.gguf")
    write_llama_gguf(lm, lm_layers, rng, **lm_shape)
    mm = {}
    t0 = time.perf_counter()
    for tag, kw in (("1.5", {}), ("1.6", dict(pinpoints=pinpoints,
                                               merge="spatial_unpad"))):
        mm[tag] = os.path.join(SMOKE_DIR, f"mmproj_vit_l_336_{tag}.gguf")
        write_clip_gguf(mm[tag], seed, **clip, **kw)
    t_write = time.perf_counter() - t0
    base, proj = clip["image"], clip["proj_dim"]
    n_base = (base // clip["patch"]) ** 2
    imgs = {}
    for side in (base, 2 * base):
        imgs[side] = os.path.join(SMOKE_DIR, f"image_{side}.npy")
        np.save(imgs[side], rng.integers(0, 256, (side, side, 3),
                                         dtype=np.uint8))
    out = {"write_s": t_write}
    # the tower: the card's bf16 encode against the CPU's f32 plain encode
    ccfg, cp = CLIP.load_clip(mm["1.5"], device=device)
    pix = CLIP.preprocess_image(np.load(imgs[base]), ccfg)[None]
    emb = CLIP.encode_image(ccfg, cp, pix)
    out["encode_ms"] = host_ms(lambda: CLIP.encode_image(ccfg, cp, pix),
                               device)
    rcfg, rp = CLIP.load_clip(mm["1.5"], compute_dtype=torch.float32,
                              device="cpu")
    t0 = time.perf_counter()
    ref = CLIP.encode_image(rcfg, rp, pix).numpy()
    t_cpu = time.perf_counter() - t0
    del rp, cp
    cos = cosine(emb.cpu().numpy().ravel(), ref.ravel())
    if not cos >= MIN_CLIP_COS or emb.shape != (1, n_base, proj):
        raise AssertionError(f"CLIP: card vs CPU cosine {cos!r} (>= "
                             f"{MIN_CLIP_COS}), shape {tuple(emb.shape)}")
    acfg, ap = CLIP.load_clip(mm["1.6"], device=device)
    img2 = np.load(imgs[2 * base])
    n_any = CLIP.encode_image_anyres(acfg, ap, img2).shape[0]
    out["anyres_ms"] = host_ms(
        lambda: CLIP.encode_image_anyres(acfg, ap, img2), device)
    del ap
    log(f"[llava] CLIP ViT-L/14-336 ({ccfg.n_layers} blocks, bf16): mmproj "
        f"files written in {t_write:.2f} s; a {base} x {base} image -> "
        f"{tuple(emb.shape)} in {out['encode_ms']:.2f} ms wall on the card "
        f"(CPU f32 plain encode {t_cpu:.2f} s), cosine {cos!r} (>= "
        f"{MIN_CLIP_COS}); anyres {2 * base} x {2 * base} -> {n_any} "
        "embeddings (canvas "
        f"{CLIP.select_best_resolution((2 * base, 2 * base), pinpoints)}, "
        f"spatial_unpad) in {out['anyres_ms']:.2f} ms wall with the host "
        "preprocessing")
    runs = {}
    for tag, side, n_emb in (("1.5", base, n_base),
                             ("1.6", 2 * base, n_any)):
        reset_port_launches()
        rc, text, err, dt = run_cli(
            f"llava {tag}", LLAVA.main,
            ["-m", lm, "--mmproj", mm[tag], "--image", imgs[side], "-p",
             LLAVA_PROMPT, "-n", str(n_predict), "--temp", "0", "-c",
             str(n_ctx), "--verbose", "--device", str(device.type)])
        got = {k: v for k, v in port_launches().items() if v}
        want = LLAVA_FLASH_UBATCHES[tag] * lm_layers
        if (rc != 0 or got.get("flash_attention", 0) != want
                or not got.get("qmm") or not got.get("qmm_int8")
                or f"({n_emb}, {proj})" not in err):
            raise AssertionError(f"llava {tag}: rc {rc}, launches {got} "
                                 f"(flash_attention {want} expected), "
                                 f"{n_emb} embeddings expected")
        runs[tag] = {"s": dt, "launches": got, "embeds": n_emb}
        log(f"[llava] cli.llava {tag} ({side} x {side}, {n_emb} embeddings, "
            f"{lm_layers}-layer LLaMA-7B-width LM, n_ctx {n_ctx}): {dt:.2f} s "
            f"in process (loads included), launches {got} (flash_attention "
            f"{want} = {lm_layers} layers x ubatches of a bucket >= 64 at "
            "span >= 1,024)")
    out.update(runs=runs, lm=lm)
    for p in (*mm.values(), *imgs.values()):
        os.remove(p)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[llava] phase 12b {out['phase_s']:.1f} s; predicted "
        f"{LLAVA_PREDICTIONS}; {smi}")
    return out


def phase_harness_tools(device, lm: str, smi: str, n_ctx: int = 8192,
                        n_gen: int = 64) -> dict:
    """Phase 12c: the harness tools on the card. make_bench_model
    --targets padtest,llava (the files' tensor counts); longctx_bench in
    process on the 2-layer LLaMA-7B-width model at n_ctx 8192 ({einsum,
    flash} x {bf16, q8_0}, its greedy parity of flash against einsum,
    flash_attention and flash_decode launched); preset running cli.main
    from a YAML file; collect_results over the JSON lines of
    tpulamm_torch.bench and the long-context rows."""
    from tpulamm_torch import bench as BENCH
    from tpulamm_torch.tools import collect_results as CR
    from tpulamm_torch.tools import longctx_bench as LB
    from tpulamm_torch.tools import make_bench_model as MB
    from tpulamm_torch.tools import preset as PR
    t_phase = time.perf_counter()
    work = os.path.join(SMOKE_DIR, "harness12")
    os.makedirs(work, exist_ok=True)
    out = {}
    t0 = time.perf_counter()
    run_tool("make_bench_model", MB.main,
             ["--out", work, "--targets", "padtest,llava"])
    for name, n in (("padtest_q4.gguf", 2), ("llava_lm_q4.gguf", 4)):
        with GGUFReader(os.path.join(work, name)) as r:
            if r.metadata["llama.block_count"] != n:
                raise AssertionError(f"make_bench_model: {name}")
    out["make_bench_model_s"] = time.perf_counter() - t0
    rows_path = os.path.join(work, "longctx.json")
    reset_port_launches()
    run_tool("longctx_bench", LB.main,
             ["-m", lm, "--ctxs", str(n_ctx), "--n-gen", str(n_gen),
              "--json", rows_path, "--device",
              str(device.type)])
    got = {k: v for k, v in port_launches().items() if v}
    with open(rows_path) as f:
        rows = json.load(f)
    if (len(rows) != 4 or not got.get("flash_attention")
            or not got.get("flash_decode")):
        raise AssertionError(f"longctx_bench: {len(rows)} rows, launches "
                             f"{got}")
    out["longctx"] = rows
    log(f"[harness12] longctx_bench n_ctx {n_ctx}: launches {got}; parity "
        "of flash against einsum " + ", ".join(
            f"{r['kv']} {r['parity_vs_einsum']}" for r in rows
            if "parity_vs_einsum" in r))
    preset = os.path.join(work, "gen.yaml")
    with open(preset, "w") as f:
        f.write(f"tool: main\nmodel: {lm}\nprompt: \"The quick brown fox\"\n"
                f"n-predict: 8\ntemp: 0\ndevice: {device.type}\n")
    reset_port_launches()
    text = run_tool("preset", PR.main, [preset])
    got = {k: v for k, v in port_launches().items() if v}
    if not text.startswith("The quick brown fox") or not got.get("qmm_int8"):
        raise AssertionError(f"preset: {text[:80]!r}, launches {got}")
    results = os.path.join(work, "perf_results.jsonl")
    mm = BENCH.run(device=str(device))
    with open(results, "w") as f:
        f.write(json.dumps({"test": "matmult", "dtype": "q4_0",
                            "gflops": mm["gflops"], "device": mm["device"]})
                + "\n")
        for r in rows:
            f.write(json.dumps({"test": "inference",
                                "dtype": f"{r['attn']} {r['kv']}",
                                "prompt_tps": r["pp"], "gen_tps": r["tg"],
                                "device": mm["device"]}) + "\n")
    table = run_tool("collect_results", CR.main, [results])
    if ("matmul performance" not in table or table.count("| einsum ") != 2
            or table.count("| flash ") != 2):
        raise AssertionError("collect_results: tables missing")
    shutil.rmtree(work)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[harness12] phase 12c {out['phase_s']:.1f} s; {smi}")
    return out


# -- phase 13: training and LoRA (slice 18) -----------------------------------

# TinyLlama/TinyLlama-1.1B's published config.json: hidden 2048,
# intermediate 5632, 22 layers, 32 / 4 heads (head_dim 64), vocab 32000,
# rope base 1e4; trained from scratch by cli.train at ctx 512, batch 4, 8
# AdamW steps, on the repository's prose
TINYLLAMA_TRAIN = dict(embd=2048, ff=5632, layer=22, head=32, head_kv=4)
TRAIN_CTX, TRAIN_BATCH, TRAIN_STEPS = 512, 4, 8
TRAIN_SEED = SEED + 26
# 13a' (card against CPU at 2 layers of the same width, from one init and
# the same batches): the loss within 1e-5 relative and each gradient's
# cosine >= 0.99999; 2 L-BFGS steps (lr 1.0: 1-2 line-search trials a
# step) each loss within 1e-4 relative; one step with gradient
# checkpointing (remat) its gradients against the same step without, the
# same bound. 3 AdamW steps (lr 1e-3, 10 of warmup): the card's params
# within 1e-5 of each tensor's max|p| of the CPU's AdamW fed the card's
# gradients. Each side's own 3 steps are compared too, and printed, not
# held: Adam divides each element's gradient by its own size, so where a
# gradient sits near Adam's eps (1e-8) its rounding sets the step's sign
# (on an H100: 7.2e-5 and 8.9e-5 of max|p| in tok_emb in two runs)
TRAIN_CMP = dict(layers=2, batch=2, seq=64, lbfgs_lr=1.0, adamw_lr=1e-3)
TOL_TRAIN_LOSS, MIN_GRAD_COS, TOL_ADAMW, TOL_LBFGS = 1e-5, 0.99999, 1e-5, 1e-4
# 13b: LoRA (r 8 on wq, wv) on 2 layers of LLaMA-7B width, Q4_0; 13c: an
# imatrix over 2 chunks of 512 on the same base. Card against CPU for 2
# finetune steps (batch 1, ctx 128): the losses within 1e-5 relative; the
# first step's adapter gradients cosine >= 0.99999 where a gradient is
# resolved: its norm above 1e-4 of the largest, clear of f32 rounding
# over 4096-long sums (on this random base layer 1's wq B gradient has a
# norm of ~1e-8 against ~1e-2 on the card, 1.2e-6 of it, and a cosine of
# 0.79 card against CPU: rounding noise on either side); the adapters
# within 1e-5 of max|a| and max|b| of the CPU's AdamW fed the card's
# gradients (each side's own adapters are printed: a noise-level gradient
# takes a full Adam step of either sign).
# The imatrix column means within 1e-5 of each tensor's largest
LORA = dict(r=8, alpha=16, targets="wq,wv", ctx=128, batch=4, iters=8,
            n_gen=32, prompt=64)
TOL_LORA, TOL_IMATRIX, MIN_RESOLVED = 1e-5, 1e-5, 1e-4
# what phase 13 was predicted to show, written before its first chip run
# (PERF.md section 5)
TRAIN_PREDICTIONS = {
    "13a s a step": "0.30-0.60", "13a tokens/s": "3,400-6,800",
    "13a TFLOP/s": "22-44 (33-66% of 67)",
    "13a max_memory_allocated": "28-40 GB",
    "13a launches": "89 qmm a ubatch, 89 qmm_int8 a step",
    "13b launches": "9 qmm a ubatch, 9 qmm_int8 a step; the same tokens",
    "phase 13 s": "70-110 (the training child besides, during the build)",
}


def train_flops(cfg, n_tokens: int, seq_len: int) -> float:
    """Operations of one training step (forward + backward, 3x the
    forward): 6 x parameters x tokens for the products with the weights
    (the embedding gather excluded), plus the attention's two products,
    6 x 2 x T x hd x n_heads a token (the whole T x T square, as the
    masked einsum computes it)."""
    kvd = cfg.n_kv_heads * cfg.head_dim
    per_layer = (2 * cfg.dim * cfg.n_heads * cfg.head_dim + 2 * cfg.dim * kvd
                 + 3 * cfg.dim * cfg.ffn_dim)
    n_mm = cfg.n_layers * per_layer + cfg.vocab_size * cfg.dim
    attn = cfg.n_layers * 2 * seq_len * cfg.head_dim * cfg.n_heads
    return 6.0 * n_tokens * (n_mm + attn)


def train_cfg(n_layers: int):
    """The ModelConfig cli.train builds for TINYLLAMA_TRAIN's flags."""
    from tpulamm_torch.models.config import ModelConfig
    from tpulamm_torch.ops.rope import RopeParams
    t = TINYLLAMA_TRAIN
    return ModelConfig(arch="llama", vocab_size=32000, dim=t["embd"],
                       n_layers=n_layers, n_heads=t["head"],
                       n_kv_heads=t["head_kv"], ffn_dim=t["ff"],
                       n_ctx_train=TRAIN_CTX, norm_eps=1e-5,
                       rope=RopeParams(n_rot=t["embd"] // t["head"]),
                       compute_dtype="float32")


def train_files() -> dict:
    """The training inputs: a GGUF holding the synthetic SPM vocab (32000
    tokens, the phase-4 model's) and the repository's prose as text."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    vocab = os.path.join(SMOKE_DIR, "train_vocab.gguf")
    write_llama_gguf(vocab, 1, np.random.default_rng(SEED + 25), dim=256,
                     ffn=256, n_head=2, vocab=32000)
    text = os.path.join(SMOKE_DIR, "train_corpus.txt")
    with open(text, "w") as f:
        f.write(build_corpus().decode("utf-8", "replace"))
    return {"vocab": vocab, "text": text}


def corpus_tokens(files: dict) -> np.ndarray:
    """The corpus as cli.train tokenizes it with the vocab GGUF."""
    r = GGUFReader(files["vocab"])
    tok = build_tokenizer(r.metadata)
    r.close()
    with open(files["text"]) as f:
        return np.asarray(tok.encode(f.read(), add_bos=False), np.int32)


def child(call: str, args: list[str], log_path: str,
          env=None) -> subprocess.Popen:
    """`python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.CALL())"
    ARGS...` from this file's directory, its output to log_path."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-c",
             f"import sys, chip_smoke; sys.exit(chip_smoke.{call}())",
             *args], cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT)


def start_train(files: dict, device: str = "cuda") -> dict:
    """13a's training, started before the build in a process of its own:
    cli.train at TinyLlama-1.1B's shape on the card (its host-side draws
    of 1.1e9 initial weights and its 4.4 GB file write overlap nvcc)."""
    t = TINYLLAMA_TRAIN
    out = os.path.join(SMOKE_DIR, "train_tl_f32.gguf")
    argv = ["--train-data", files["text"], "--vocab-model", files["vocab"],
            "-o", out, "--embd", str(t["embd"]), "--head", str(t["head"]),
            "--head-kv", str(t["head_kv"]), "--layer", str(t["layer"]),
            "--ff", str(t["ff"]), "--ctx", str(TRAIN_CTX), "-b",
            str(TRAIN_BATCH), "--iters", str(TRAIN_STEPS), "--seed",
            str(TRAIN_SEED), "--device", device]
    stats = os.path.join(SMOKE_DIR, "train_tl.json")
    logp = os.path.join(SMOKE_DIR, "train_tl.log")
    return {"proc": child("train_main", [json.dumps(argv), stats], logp),
            "out": out, "stats": stats, "log": logp,
            "t0": time.perf_counter()}


def train_main() -> int:
    """The child of start_train: cli.train.main(ARGV_JSON) with every
    step logged and timed; writes its step seconds, losses, the seconds of
    the init, the steps and the file write, and max_memory_allocated as
    JSON to STATS_PATH."""
    from tpulamm_torch.cli import train as TCLI
    from tpulamm_torch.train import model as TMOD
    from tpulamm_torch.train import train as TTR
    argv, path = json.loads(sys.argv[1]), sys.argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    rec: dict = {}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                rec[name] = time.perf_counter() - t0
        return call
    orig = TTR.train

    def train(*a, **kw):
        params, losses = orig(*a, **{**kw, "log_every": 1, "stats": rec})
        rec["losses"] = losses
        return params, losses
    TTR.train = timed("train_s", train)
    TMOD.init_params = timed("init_s", TMOD.init_params)
    TMOD.save_params_gguf = timed("save_s", TMOD.save_params_gguf)
    t0 = time.perf_counter()
    rc = TCLI.main(argv)
    rec.update(total_s=time.perf_counter() - t0, rc=rc,
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if torch.cuda.is_available() else 0))
    with open(path, "w") as f:
        json.dump(rec, f)
    return rc


def finish_train(started: dict, timeout: float = 600.0) -> dict:
    """Wait for 13a's training process; its JSON record, its log printed."""
    rc = started["proc"].wait(timeout=timeout)
    wall = time.perf_counter() - started["t0"]
    with open(started["log"]) as f:
        for line in f.read().splitlines():
            log(f"[train13a] {line[:300]}")
    if rc != 0 or not os.path.exists(started["stats"]):
        raise AssertionError(f"cli.train at TinyLlama-1.1B shape: exit {rc}")
    with open(started["stats"]) as f:
        rec = json.load(f)
    os.remove(started["stats"])
    os.remove(started["log"])
    rec["wall_s"] = wall
    return rec


def train_refs_main() -> int:
    """`... chip_smoke.train_refs_main() CONFIG_JSON`: the CPU sides of
    13a', 13b and 13c into CONFIG["dir"]: at 2 layers of TinyLlama width
    the loss and gradients of one batch, the params after 3 AdamW steps
    and 2 L-BFGS steps' losses and trials; 2 finetune steps' losses,
    gradients and adapters; the imatrix of the LoRA base."""
    from tpulamm_torch.tools import imatrix as IM
    global TINYLLAMA_TRAIN, TRAIN_CTX, TRAIN_CMP, LORA
    cfg = json.loads(sys.argv[1])
    # the parent's sizes (the constants, unless a rehearsal changed them)
    TINYLLAMA_TRAIN, TRAIN_CTX = cfg["tl"], cfg["ctx"]
    TRAIN_CMP, LORA = cfg["cmp"], cfg["lora"]
    d = cfg["dir"]
    rec = {}
    t0 = time.perf_counter()
    res = train_cmp_side(torch.device("cpu"), cfg["files"])
    torch.save({k: res[k] for k in ("grads", "adamw")},
               os.path.join(d, "a_cpu.pt"))
    rec["a"] = {k: res[k] for k in ("loss", "lbfgs", "trials")}
    rec["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(lora_cmp_side(torch.device("cpu"), cfg["base"], cfg["files"]),
               os.path.join(d, "b_cpu.pt"))
    rec["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = IM.main(["-m", cfg["base"], "-f", cfg["files"]["text"], "-o",
                  os.path.join(d, "c_cpu.npz"), "-c", "512", "--chunks", "2",
                  "--device", "cpu"])
    rec["c_s"] = time.perf_counter() - t0
    with open(os.path.join(d, "refs.json"), "w") as f:
        json.dump(rec, f)
    return rc


def adamw_steps(tree, loss_fn, tc, batches, device, keep: bool) -> tuple:
    """n_steps of train.optim.AdamW on `tree` (updated in place), a batch
    from `batches` each, as train.optimize runs them -> (losses, each
    step's gradients as CPU tensors where keep)."""
    from tpulamm_torch.train import optim as TO
    from tpulamm_torch.train.train import value_and_grad
    leaves = TO.tree_leaves(tree)
    opt = TO.AdamW(tc)
    state = opt.init(leaves)
    losses, kept = [], []
    for _ in range(tc.n_steps):
        batch = torch.as_tensor(next(batches), device=device)
        loss, grads = value_and_grad(lambda t: loss_fn(t, batch), tree,
                                     leaves)
        losses.append(float(loss))
        if keep:
            # copies: update() turns the gradients' buffers into updates
            kept.append([g.to("cpu", copy=True) for g in grads])
        updates, state = opt.update(grads, state, leaves)
        TO.apply_updates(leaves, updates)
    return losses, kept


def replay_adamw(init: list, grads: list, tc) -> list:
    """train.optim.AdamW on the CPU from `init` (CPU tensors, copied), fed
    the gradients `grads` (a list a step) -> the final leaves."""
    from tpulamm_torch.train import optim as TO
    leaves = [x.clone() for x in init]
    opt = TO.AdamW(tc)
    state = opt.init(leaves)
    for g in grads:
        updates, state = opt.update([x.clone() for x in g], state, leaves)
        TO.apply_updates(leaves, updates)
    return leaves


def train_cmp_side(device, files: dict, init=None,
                   remat: bool = False) -> dict:
    """One side of 13a': at TRAIN_CMP's size, from init_params(seed
    TRAIN_SEED) (or `init`, CPU tensors of it) on `device` and
    sample_batches over the corpus: the loss and gradients of the first
    batch, the params after 3 AdamW steps (on the card with each step's
    gradients), 2 L-BFGS steps' losses and line-search trials, and with
    remat the first batch's gradients recomputed a layer at a time in the
    backward pass."""
    from tpulamm_torch.train import model as TMOD
    from tpulamm_torch.train import optim as TO
    from tpulamm_torch.train.train import (TrainConfig, optimize,
                                           sample_batches, value_and_grad)
    c = TRAIN_CMP
    cfg = train_cfg(c["layers"])
    if init is None:
        init = TMOD.init_params(cfg, seed=TRAIN_SEED, device="cpu")

    def fresh():
        return TO.tree_unflatten(init, [x.to(device, copy=True)
                                        for x in TO.tree_leaves(init)])
    data = corpus_tokens(files)

    def batches():
        return sample_batches(data, TrainConfig(batch_size=c["batch"],
                                                seq_len=c["seq"],
                                                seed=TRAIN_SEED))

    def loss_fn(t, b, remat=False):
        return TMOD.causal_lm_loss(t, cfg, b, remat=remat)
    first = torch.as_tensor(next(batches()), device=device)
    p = fresh()
    loss, grads = value_and_grad(lambda t: loss_fn(t, first), p,
                                 TO.tree_leaves(p))
    out = {"loss": float(loss), "grads": [g.cpu() for g in grads]}
    if remat:
        _, rg = value_and_grad(lambda t: loss_fn(t, first, True), p,
                               TO.tree_leaves(p))
        out["remat"] = [g.cpu() for g in rg]
    del p, grads
    q = fresh()
    out["adamw_losses"], out["adamw_grads"] = adamw_steps(
        q, loss_fn, TrainConfig(lr=c["adamw_lr"], n_steps=3), batches(),
        device, keep=remat)
    out["adamw"] = [x.cpu() for x in TO.tree_leaves(q)]
    del q
    st = {}
    _, losses = optimize(fresh(), loss_fn, TrainConfig(
        optimizer="lbfgs", lr=c["lbfgs_lr"], n_steps=2), batches(),
        log_every=0, stats=st)
    out.update(lbfgs=losses, trials=st["trials"])
    return out


def lora_cmp_side(device, base: str, files: dict) -> dict:
    """One side of 13b's comparison: 2 finetune steps (batch 1, ctx 128,
    the CLI's r, alpha and targets) of the adapters on the base densified
    on `device`, as train.lora.finetune_lora runs them -> each step's loss
    and adapter gradients, the initial and the final adapters (CPU)."""
    from tpulamm_torch.models.loader import load_model
    from tpulamm_torch.tools.imatrix import densify_params
    from tpulamm_torch.train import optim as TO
    from tpulamm_torch.train.lora import init_lora, merge_lora
    from tpulamm_torch.train.model import causal_lm_loss
    from tpulamm_torch.train.train import TrainConfig, sample_batches
    cfg, params, _ = load_model(base, compute_dtype="float32", device=device)
    dense = densify_params(params)
    tc = TrainConfig(batch_size=1, seq_len=LORA["ctx"], n_steps=2, seed=0)
    lora = init_lora(dense, r=LORA["r"], alpha=LORA["alpha"], seed=tc.seed,
                     targets=tuple(LORA["targets"].split(",")))
    init = [x.cpu().clone() for x in TO.tree_leaves(lora["layers"])]

    def loss_fn(adapters, batch):
        return causal_lm_loss(merge_lora(dense, {
            "r": LORA["r"], "alpha": LORA["alpha"], "layers": adapters}),
            cfg, batch)
    losses, grads = adamw_steps(lora["layers"], loss_fn, tc, sample_batches(
        corpus_tokens(files), tc), device, keep=True)
    return {"losses": losses, "grads": grads, "init": init,
            "final": [x.cpu() for x in TO.tree_leaves(lora["layers"])]}


def phase_train(device, rng, smi: str, files: dict, trained: dict,
                init2) -> dict:
    """Phase 13: training and LoRA. 13a: the TinyLlama-1.1B-shape model
    trained during the build (its step seconds, tokens/s, TFLOP/s, memory)
    quantized to Q4_0 and run by generate_fast; 13a' the card against the
    CPU at 2 layers; 13b LoRA finetune, export, --lora; 13c the imatrix;
    13d quality_table --train, passkey_train and spec_bench."""
    from tpulamm_torch.cli import export_lora as EXL
    from tpulamm_torch.cli import finetune as FTC
    from tpulamm_torch.tools import imatrix as IM
    from tpulamm_torch.tools import passkey_train as PKT
    from tpulamm_torch.tools import quality_table as QT
    from tpulamm_torch.tools import spec_bench as SB
    from tpulamm_torch.train import optim as TO
    t_phase = time.perf_counter()
    work = os.path.join(SMOKE_DIR, "train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    refs = None
    marks = {}
    t_step = [time.perf_counter()]

    def step_done(name):
        now = time.perf_counter()
        marks[name] = now - t_step[0]
        t_step[0] = now
    try:
        # 13b / 13c's base, then the CPU sides in a process of their own
        base = os.path.join(work, "lora_base_q4_0.gguf")
        write_llama_gguf(base, 2, rng, **LLAMA_7B)
        env = {**os.environ, "OMP_NUM_THREADS": "4"}
        refs = child("train_refs_main", [json.dumps(
            {"dir": work, "base": base, "files": files,
             "tl": TINYLLAMA_TRAIN, "ctx": TRAIN_CTX, "cmp": TRAIN_CMP,
             "lora": LORA})], os.path.join(work, "refs.log"), env=env)

        step_done("the LoRA base written, the CPU sides started")
        # 13a: the trained model's numbers, then its Q4_0 file served
        rec = trained
        n_tok = TRAIN_BATCH * TRAIN_CTX
        steps = rec["step_s"]
        later = float(np.median(steps[1:]))
        flops = train_flops(train_cfg(TINYLLAMA_TRAIN["layer"]), n_tok,
                            TRAIN_CTX)
        out["13a"] = {"first_step_s": steps[0], "step_s": later,
                      "tok_s": n_tok / later, "tflops": flops / later / 1e12,
                      "max_mem_gb": rec["max_memory_allocated"] / 1e9,
                      "losses": rec["losses"]}
        log(f"[train13a] cli.train, TinyLlama-1.1B shape (22 layers, 2048 / "
            f"5632, 32 / 4 heads, vocab 32000), ctx {TRAIN_CTX}, batch "
            f"{TRAIN_BATCH}, {TRAIN_STEPS} AdamW steps: first step "
            f"{steps[0]:.3f} s, then {later:.4f} s a step (median of "
            f"{len(steps) - 1}; {[round(s, 4) for s in steps[1:]]}); "
            f"{n_tok / later:,.0f} tokens/s; {flops / 1e12:.3f} TFLOP a step "
            f"-> {flops / later / 1e12:.2f} TFLOP/s, "
            f"{100 * flops / later / PEAK_F32_OPS:.1f}% of "
            f"{PEAK_F32_OPS / 1e12:.0f} (bound {flops / PEAK_F32_OPS:.4f} s a "
            f"step); max_memory_allocated "
            f"{rec['max_memory_allocated'] / 1e9:.2f} GB; losses "
            f"{[round(x, 4) for x in rec['losses']]}; the process "
            f"{rec['wall_s']:.1f} s (init {rec['init_s']:.1f}, steps "
            f"{rec['train_s']:.1f}, file write {rec['save_s']:.1f})")
        if not (np.isfinite(rec["losses"]).all()
                and rec["losses"][-1] < rec["losses"][0]):
            raise AssertionError(f"13a losses {rec['losses']}")
        q4 = os.path.join(work, "tl_q4_0.gguf")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = quantize.main([trained["out"], q4, "q4_0"])
        os.remove(trained["out"])
        if rc != 0:
            raise AssertionError(f"quantize of the trained model: {rc}")
        q_s = time.perf_counter() - t0
        eng = Engine(q4, n_ctx=1024, device=device)
        _, ids = gen_prompt(q4, rng, PROMPT)
        reset_port_launches()
        n0 = eng.timings.n_step
        toks, _ = eng.generate_fast(ids, n_predict=64, stop_on_eos=False)
        per = 4 * TINYLLAMA_TRAIN["layer"] + 1
        n_steps = eng.timings.n_step - n0
        got = expect_launches("13a generate_fast",
                              {"qmm": per, "qmm_int8": per * n_steps})
        if len(toks) != 64:
            raise AssertionError(f"13a: {len(toks)} tokens")
        log(f"[train13a] cli.quantize to Q4_0 {q_s:.1f} s; generate_fast "
            f"{PROMPT} in, 64 greedy out: launches {got} (exactly {per} qmm "
            f"for the ubatch and {per} qmm_int8 for each of {n_steps} decode "
            "steps)")
        del eng
        os.remove(q4)

        step_done("13a: quantize, load, generate_fast")
        # 13a': the card against the CPU at 2 layers of the same width
        a = train_cmp_side(device, files, init=init2, remat=True)
        step_done("13a': the card's side")
        out["13b"] = lora_phase(device, rng, base, files, work, FTC, EXL)
        step_done("13b")

        # 13c: the imatrix on the card, then quantize --imatrix with it
        card_npz = os.path.join(work, "c_card.npz")
        rc, _, _, c_s = run_cli("imatrix13c", IM.main, [
            "-m", base, "-f", files["text"], "-o", card_npz, "-c", "512",
            "--chunks", "2", "--device", device.type])
        if rc != 0:
            raise AssertionError(f"tools.imatrix: {rc}")
        qi = {}
        for tag, extra in (("imatrix", ["--imatrix", card_npz]),
                           ("plain", [])):
            qi[tag] = os.path.join(work, f"iq_{tag}.gguf")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = quantize.main(extra + [base, qi[tag], "q5_0"])
            if rc != 0:
                raise AssertionError(f"quantize {tag}: {rc}")
        if filecmp.cmp(qi["imatrix"], qi["plain"], shallow=False):
            raise AssertionError("quantize --imatrix wrote the plain file")
        log(f"[imatrix13c] tools.imatrix on the card {c_s:.1f} s (2 layers of "
            "LLaMA-7B width, 2 chunks of 512); cli.quantize --imatrix with "
            "its file (the Q4_0 base to Q5_0, the weighted search) differs "
            "from the plain Q5_0 file")

        step_done("13c")
        # 13d: the tools
        out["13d"] = tools_phase(device, work, QT, PKT, SB)

        step_done("13d")
        # the CPU sides
        t0 = time.perf_counter()
        rc = refs.wait(timeout=900)
        waited = time.perf_counter() - t0
        with open(os.path.join(work, "refs.log")) as f:
            for line in f.read().splitlines()[-20:]:
                log(f"[train-refs] {line[:300]}")
        if rc != 0:
            raise AssertionError(f"the CPU sides of phase 13: exit {rc}")
        with open(os.path.join(work, "refs.json")) as f:
            cpu = json.load(f)
        log(f"[train-refs] CPU sides: 13a' {cpu['a_s']:.1f} s, 13b "
            f"{cpu['b_s']:.1f} s, 13c {cpu['c_s']:.1f} s (waited "
            f"{waited:.1f} s after 13d)")
        step_done("waiting for the CPU sides")
        # each comparison logs its numbers; any bound missed raises after
        # all three are read
        missed = []
        for key, cmp_fn in (
                ("13a'", lambda: compare_train(a, cpu["a"], torch.load(
                    os.path.join(work, "a_cpu.pt")), TO.tree_leaves(init2))),
                ("13b'", lambda: compare_lora(out["13b"]["cmp"], torch.load(
                    os.path.join(work, "b_cpu.pt")))),
                ("13c", lambda: compare_imatrix(
                    card_npz, os.path.join(work, "c_cpu.npz")))):
            try:
                out[key] = cmp_fn()
            except AssertionError as e:
                missed.append(f"{key}: {e}")
        step_done("the comparisons")
        for name, dt in marks.items():
            log(f"[train] {name}: {dt:.1f} s")
        if missed:
            raise AssertionError("; ".join(missed))
    finally:
        if refs is not None and refs.poll() is None:
            refs.kill()
            refs.wait()
        shutil.rmtree(work, ignore_errors=True)
        for p in (files["vocab"], files["text"], trained["out"]):
            if os.path.exists(p):
                os.remove(p)
    out["phase_s"] = time.perf_counter() - t_phase
    for key, val in TRAIN_PREDICTIONS.items():
        log(f"[train] predicted {key}: {val}")
    log(f"[train] phase 13 {out['phase_s']:.1f} s; {smi}")
    return out


def lora_phase(device, rng, base: str, files: dict, work: str, FTC,
               EXL) -> dict:
    """13b: cli.finetune, cli.export_lora, cli.main --lora against cli.main
    on the exported file (tokens, launches, planes); the card's side of
    the 2-step finetune comparison."""
    ad = os.path.join(work, "adapter.gguf")
    argv = ["-m", base, "--train-data", files["text"], "-o", ad,
            "--lora-r", str(LORA["r"]), "--lora-alpha", str(LORA["alpha"]),
            "--targets", LORA["targets"], "--ctx", str(LORA["ctx"]), "-b",
            str(LORA["batch"]), "--iters", str(LORA["iters"]), "--device",
            device.type]
    reset_port_launches()
    rc, _, _, ft_s = run_cli("finetune13b", FTC.main, argv)
    if rc != 0:
        raise AssertionError(f"cli.finetune: {rc}")
    expect_launches("cli.finetune", {})
    baked = os.path.join(work, "baked.gguf")
    rc, _, _, ex_s = run_cli("export13b", EXL.main,
                             ["-m", base, "-o", baked, "-l", ad])
    if rc != 0:
        raise AssertionError(f"cli.export_lora: {rc}")
    text, ptoks = gen_prompt(base, rng, LORA["prompt"])
    per = 4 * 2 + 1
    runs = {}
    for tag, path, extra in (("lora", base, ["--lora", ad]),
                             ("baked", baked, [])):
        cache = os.path.join(work, f"{tag}.cache")
        o, _, dt, launches, tm = main_run(
            f"main13b-{tag}", path,
            ["-p", text, "-n", str(LORA["n_gen"]), "--temp", "0", "-c", "512",
             "--repeat-penalty", "1.0", "--no-display-prompt", "--device",
             device.type, "--prompt-cache", cache, *extra], work)
        ids = session_tokens(cache)[LORA["prompt"]:]
        if int(tm["n_eval"]) != len(ids):
            raise AssertionError(f"{tag}: {len(ids)} tokens, {tm['n_eval']} "
                                 "steps")
        expect_launches(f"main13b-{tag}", {"qmm": per,
                                           "qmm_int8": per * len(ids)})
        runs[tag] = (ids, dt)
    ea = Engine(base, n_ctx=512, lora_path=ad, device=device)
    eb = Engine(baked, n_ctx=512, device=device)
    diff = []
    for i, (la, lb) in enumerate(zip(ea.params["layers"],
                                     eb.params["layers"])):
        for key in ("wqkv_fused", "wo", "wgateup_fused", "w_down"):
            if not all(torch.equal(p, lb[key].planes[n])
                       for n, p in la[key].planes.items()):
                d = (dequant_mm(la[key]) - dequant_mm(lb[key])).abs().max()
                diff.append((i, key, float(d)))
    same = greedy_parting(ea, ptoks, runs["baked"][0], runs["lora"][0],
                          "13b --lora vs the exported file")
    if diff:
        log(f"[lora13b] planes differ: {diff} (largest dequantized "
            "difference each)")
    log(f"[lora13b] cli.finetune (r {LORA['r']}, {LORA['targets']}, ctx "
        f"{LORA['ctx']}, -b {LORA['batch']}, {LORA['iters']} steps) "
        f"{ft_s:.1f} s; cli.export_lora {ex_s:.1f} s; cli.main --lora "
        f"{runs['lora'][1]:.1f} s and on the exported file "
        f"{runs['baked'][1]:.1f} s, {LORA['n_gen']} greedy tokens: {same}; "
        f"launches exactly {per} qmm for the ubatch and {per} qmm_int8 a "
        f"step in both; patched planes "
        f"{'equal, byte for byte' if not diff else 'DIFFER'}")
    del ea, eb
    return {"same": same, "plane_diff": diff, "finetune_s": ft_s,
            "cmp": lora_cmp_side(device, base, files)}


def tools_phase(device, work: str, QT, PKT, SB) -> dict:
    """13d: quality_table --train, passkey_train (train and evaluate) and
    spec_bench on the card, at few steps and trials."""
    out = {}
    t0 = time.perf_counter()
    qpath = os.path.join(work, "quality", "q_f32.gguf")
    reset_port_launches()
    run_tool("quality13d", QT.main, ["--train", "-m", qpath, "--steps",
                                     "10", "--n-chunks", "1", "--device",
                                     device.type])
    got = port_launches()
    if not (got["qmm"] > 0 and all(v == 0 for k, v in got.items()
                                   if k != "qmm")):
        raise AssertionError(f"quality_table --train launches {got}")
    out["quality_s"] = time.perf_counter() - t0
    log(f"[tools13d] quality_table --train (10 steps of the dim-512, "
        f"8-layer byte model; 1 chunk): {out['quality_s']:.1f} s, launches "
        f"{ {k: v for k, v in got.items() if v} }")
    t0 = time.perf_counter()
    pk = os.path.join(work, "passkey.gguf")
    reset_port_launches()
    PKT.train_passkey(pk, n_steps=2, batch_size=1, n_docs=8, device=device,
                      log=lambda s: log(f"[tools13d passkey] {s}"))
    res = PKT.evaluate(pk, n_ctx=8192, ga_n=4, ga_w=1024, trials=1,
                       n_junk=50, device=device,
                       log=lambda s: log(f"[tools13d passkey] {s}"))
    out["passkey"] = res
    out["passkey_s"] = time.perf_counter() - t0
    log(f"[tools13d] passkey_train (2 steps, batch 1, 8 documents at seq "
        f"3072, remat) and evaluate (n_ctx 8192, --grp-attn-n 4, 1 trial): "
        f"{out['passkey_s']:.1f} s, {res['hits']}/{res['trials']} retrieved "
        f"(2 steps teach nothing: a MISS is expected); launches "
        f"{ {k: v for k, v in port_launches().items() if v} }")
    t0 = time.perf_counter()
    reset_port_launches()
    tgt, drf, tgt_q4, corpus = SB.ensure_models(
        20, out_dir=os.path.join(work, "spec"), device=device,
        log=lambda s: log(f"[tools13d spec] {s}"))
    rows = SB.bench_pair(tgt_q4, drf, corpus, n_predict=32, drafts=(0, 4),
                         device=device,
                         log=lambda s: log(f"[tools13d spec] {s}"))
    out["spec"] = rows
    out["spec_s"] = time.perf_counter() - t0
    got = port_launches()
    if not (got["qmm"] > 0 and got["qmm_int8"] > 0):
        raise AssertionError(f"spec_bench launches {got}")
    acc = {r["mode"]: r["accept"] for r in rows if r["accept"] is not None}
    log(f"[tools13d] spec_bench (target dim 512 x 8 layers Q4_0, draft dim "
        f"256 x 2 layers, 20 steps each on the repository's prose; 32 "
        f"tokens, k 4): {out['spec_s']:.1f} s; accept rates {acc}: a pair "
        f"trained 20 steps, near its initial weights; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    return out


def compare_train(card: dict, cpu: dict, cpu_t: dict, init: list) -> dict:
    """13a' bounds: the loss, each gradient's cosine, the card's AdamW
    params against the CPU's AdamW fed the card's gradients, the L-BFGS
    losses, the remat gradients; each side's own AdamW params printed."""
    from tpulamm_torch.train.train import TrainConfig
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    cos = min(cosine(a.numpy().ravel(), b.numpy().ravel())
              for a, b in zip(cpu_t["grads"], card["grads"]))
    replay = replay_adamw(init, card["adamw_grads"], TrainConfig(
        lr=TRAIN_CMP["adamw_lr"], n_steps=3))
    ad = max(rel_err(b, a)[0] for a, b in zip(replay, card["adamw"]))
    own = [rel_err(b, a)[0]
           for a, b in zip(cpu_t["adamw"], card["adamw"])]
    past = [(tuple(x.shape), round(g, 9)) for x, g in
            zip(cpu_t["adamw"], own) if g > TOL_ADAMW]
    lb = max(abs(a - b) / abs(a) for a, b in zip(cpu["lbfgs"],
                                                  card["lbfgs"]))
    rc = min(cosine(a.numpy().ravel(), b.numpy().ravel())
             for a, b in zip(card["grads"], card["remat"]))
    rr = max(rel_err(b, a)[0] for a, b in zip(card["grads"], card["remat"]))
    log(f"[train13a'] card vs CPU, 2 layers of TinyLlama width, batch "
        f"{TRAIN_CMP['batch']} x {TRAIN_CMP['seq']}: loss {card['loss']!r} "
        f"vs {cpu['loss']!r} (rel {rel:.3e}, <= {TOL_TRAIN_LOSS}); min "
        f"gradient cosine {cos!r} (>= {MIN_GRAD_COS}); 3 AdamW steps: the "
        f"card's params within {ad:.3e} of max|p| of the CPU's AdamW on the "
        f"card's gradients (<= {TOL_ADAMW}), each side on its own "
        f"gradients within {max(own):.3e} (not held; tensors past "
        f"{TOL_ADAMW}: {past}); 2 L-BFGS steps (lr "
        f"{TRAIN_CMP['lbfgs_lr']}): losses {card['lbfgs']} vs {cpu['lbfgs']} "
        f"(rel {lb:.3e}, <= {TOL_LBFGS}), line-search trials {card['trials']}"
        f" on the card, {cpu['trials']} on the CPU; remat step: gradients "
        f"cosine {rc!r}, within {rr:.3e} of max|g| of the step without")
    if not (rel <= TOL_TRAIN_LOSS and cos >= MIN_GRAD_COS
            and ad <= TOL_ADAMW and lb <= TOL_LBFGS and rc >= MIN_GRAD_COS):
        raise AssertionError("13a': a card-against-CPU bound missed")
    return {"loss_rel": rel, "grad_cos": cos, "adamw": ad, "own": max(own),
            "lbfgs": lb, "trials": (card["trials"], cpu["trials"]),
            "remat_cos": rc}


def compare_lora(card: dict, cpu: dict) -> dict:
    """13b's bounds over 2 finetune steps: the losses, the first step's
    resolved adapter gradients, the card's adapters against the CPU's
    AdamW fed the card's gradients; each side's own adapters printed."""
    from tpulamm_torch.train.train import TrainConfig
    rel = max(abs(a - b) / abs(a) for a, b in zip(cpu["losses"],
                                                  card["losses"]))
    g0c, g0p = card["grads"][0], cpu["grads"][0]
    norms = [float(g.norm()) for g in g0p]
    resolved = [i for i, n in enumerate(norms)
                if n > MIN_RESOLVED * max(norms)]
    coss = {i: cosine(g0p[i].numpy().ravel(), g0c[i].numpy().ravel())
            for i in range(len(norms)) if norms[i] > 0}
    cos = min(coss[i] for i in resolved)
    replay = replay_adamw(card["init"], card["grads"], TrainConfig(
        batch_size=1, seq_len=LORA["ctx"], n_steps=2, seed=0))
    gap = max(rel_err(b, a)[0] for a, b in zip(replay, card["final"]))
    own = max(rel_err(b, a)[0]
              for a, b in zip(cpu["final"], card["final"]))
    log(f"[lora13b] 2 finetune steps, card vs CPU: losses {card['losses']} "
        f"vs {cpu['losses']} (rel {rel:.3e}, <= {TOL_TRAIN_LOSS}); first "
        f"step's adapter gradients cosine {cos!r} over {len(resolved)} of "
        f"{len(norms)} resolved (>= {MIN_GRAD_COS}; norms "
        f"{[f'{n:.2e}' for n in norms]}, cosines of the nonzero "
        f"{ {i: round(c, 9) for i, c in coss.items()} }); the card's "
        f"adapters within "
        f"{gap:.3e} of max|a|, max|b| of the CPU's AdamW on the card's "
        f"gradients (<= {TOL_LORA}), each side on its own gradients within "
        f"{own:.3e} (not held)")
    if not (rel <= TOL_TRAIN_LOSS and cos >= MIN_GRAD_COS
            and gap <= TOL_LORA):
        raise AssertionError(f"13b card vs CPU: losses {rel}, cosine {cos},"
                             f" adapters {gap}")
    return {"loss_rel": rel, "grad_cos": cos, "adapters": gap, "own": own}


def compare_imatrix(card_npz: str, cpu_npz: str) -> dict:
    zc, zp = np.load(card_npz), np.load(cpu_npz)
    if sorted(zc.files) != sorted(zp.files):
        raise AssertionError("13c: the imatrix files' tensors differ")
    worst, elem = 0.0, 0.0
    for k in zc.files:
        if k.startswith("count::"):
            if int(zc[k]) != int(zp[k]):
                raise AssertionError(f"13c {k}: {zc[k]} != {zp[k]}")
            continue
        name = k[5:]
        mc = zc[k] / int(zc["count::" + name])
        mp = zp[k] / int(zp["count::" + name])
        worst = max(worst, float(np.abs(mc - mp).max() / np.abs(mp).max()))
        elem = max(elem, float((np.abs(mc - mp) / np.abs(mp)).max()))
    log(f"[imatrix13c] card vs CPU: {len(zc.files) // 2} tensors, counts "
        f"equal ({int(zc['count::output.weight'])} tokens); column means "
        f"within {worst:.3e} of each tensor's largest (<= {TOL_IMATRIX}), "
        f"{elem:.3e} relative at the worst column")
    if worst > TOL_IMATRIX:
        raise AssertionError(f"13c column means {worst}")
    return {"rel": worst, "elem_rel": elem}


# -- slice 19: the mesh for serving -------------------------------------------
# LLaMA-7B's projections as a tp = 2 rank runs them (N, K): its N-slice of
# the fused QKV and gate|up, its K-slice of wo, the replicated w_down (K =
# 11,008 is not a multiple of 2 x 256) and its half of the padded head
TP2_SHAPES = {"tp2 wqkv": (6144, 4096), "tp2 gate_up": (11008, 4096),
              "tp2 wo": (4096, 2048), "tp2 down (replicated)": (4096, 11008),
              "tp2 lm_head": (16384, 4096)}
# the fused FFN on a rank's shards needs a K-sharded w_down: Mistral-7B's
# ffn 14,336 splits (7,168 a rank); LLaMA-7B's FFN takes the gathered
# (unfused) path at tp 2
MISTRAL_7B = dict(dim=4096, ffn=14336, n_head=32, n_kv=8, vocab=32000)
TP2_FFN = (4096, 7168)                 # (dim, a rank's ffn)
MESH_COS = 0.999                       # phase 4's prefill limit (card_vs_cpu)
MESH_PROMPTS = (40, 120, 200, 300)     # 14b's four requests
# written before the first chip run (PERF.md section 5)
MESH_PREDICTIONS = {"tp2_prefill_tok_s": (5000.0, 6800.0),
                    "tp2_decode_tok_s": (60.0, 100.0)}


def phase_shards(device, reps: int = 20) -> dict:
    """Phase 3e: qmm at M = 512 and qmm_int8 at M = 1 and 16 on LLaMA-7B's
    tp = 2 shard shapes (TP2_SHAPES, Q4_0), and ffn_fused at M = 1 on a
    Mistral-7B tp = 2 rank's gate|up and down shards, each against its
    plain version at the phase-3 tolerances and timed beside it (no
    limit on the times), from a generator of its own (seed SEED + 28)."""
    rng = np.random.default_rng(SEED + 28)
    gen = torch.Generator(device).manual_seed(SEED + 28)
    out = {}

    def q(n, k):
        return QTensor.from_gguf_raw(random_blocks(GGMLType.Q4_0, n, k, rng),
                                     GGMLType.Q4_0, (n, k), device=device)
    for label, (n, k) in TP2_SHAPES.items():
        qt = q(n, k)
        w_bf16 = dequant_mm(qt, torch.bfloat16)
        for name, m, kern, plain, tol, peak in (
                ("qmm", PREFILL_M, Q.qmm_cuda, Q.qmm_ref, TOL_QMM,
                 PEAK_BF16_OPS),
                ("qmm_int8", 1, Q.qmm_int8_cuda, Q.qmm_int8_ref, TOL_INT8,
                 PEAK_INT8_OPS),
                ("qmm_int8", 16, Q.qmm_int8_cuda, Q.qmm_int8_ref, TOL_INT8,
                 PEAK_INT8_OPS)):
            x = torch.randn((m, k), device=device, generator=gen)
            rel, _ = rel_err(kern(x, qt), plain(x, qt))
            if not rel <= tol:
                raise AssertionError(f"{label} {name} M={m}: relative error "
                                     f"{rel} > {tol}")
            t = time_case(kern, plain, x, qt, w_bf16, peak, device, reps)
            out[label, name, m] = t[0]
            log(case_line(f"Q4_0 {label} M={m} N={n} K={k}", name, rel, *t))
        del qt, w_bf16
    dim, ffn = TP2_FFN
    gu, dn = q(2 * ffn, dim), q(dim, ffn)
    if not FF.ffn_fused_eligible(gu, dn, 1):
        raise AssertionError("ffn_fused: the Mistral-7B tp2 shards are not "
                             "eligible")
    x = torch.randn((1, dim), device=device, generator=gen)
    got = FF.ffn_fused(x, gu, dn)
    rel, _ = rel_err(got, FF.ffn_fused_ref(x, gu, dn))
    if not (rel <= TOL_FFN and bool(torch.isfinite(got).all())):
        raise AssertionError(f"ffn_fused tp2 shard: relative error {rel} > "
                             f"{TOL_FFN}")
    t = (time_ms(lambda: FF.ffn_fused(x, gu, dn), device, reps),
         time_ms(lambda: FF.ffn_fused_ref(x, gu, dn), device, reps),
         time_ms(FAB.library(x, gu, dn), device, reps)
         ) + FAB.bound_ms(1, gu, dn)
    out["ffn_fused"] = t[0]
    log(case_line(f"Q4_0 Mistral-7B tp2 shard M=1 dim={dim} ffn={ffn}",
                  "ffn_fused", rel, *t, library="2 bf16 matmul + silu"))
    for name, m in (("qmm", PREFILL_M), ("qmm_int8", 1), ("qmm_int8", 16)):
        s = sum(v for key, v in out.items() if key[1:] == (name, m))
        log(f"[kernels] {name} M={m} over a tp = 2 rank's five 7B shards: "
            f"{s:.4f} ms (x 2 ranks: {2 * s:.4f} ms)")
    return out


def event_ms(call, device, n: int = 3) -> float:
    """Device ms of one call by CUDA events (after one more), no
    profiler."""
    call()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / n


def mesh_run(eng, prompt: list, prompt2: list, n_predict: int, device,
             n_layers: int, ranks: int) -> dict:
    """14a's drive of one engine: the 512-token prefill (its launches
    exactly `ranks` x (4 x n_layers + 1) qmm), a second ubatch at span
    1,024 (flash_attention once a layer and rank), generate_fast (a qmm
    pass, then the same qmm_int8 count a step) and a 16-step block timed
    by CUDA events."""
    per = ranks * (4 * n_layers + 1)
    eng.reset_slot(0)
    reset_port_launches()
    lg = eng.prefill(0, prompt)
    expect_launches("mesh prefill", {"qmm": per})
    reset_port_launches()
    lg2 = eng.prefill(0, prompt2)
    expect_launches("mesh span-1024 ubatch",
                    {"qmm": per, "flash_attention": ranks * n_layers})
    eng.generate_fast(prompt, n_predict=n_predict, stop_on_eos=False)
    eng.timings = Timings()
    reset_port_launches()
    n_graphs = len(eng.graphs.graphs)
    t0 = time.perf_counter()
    ids, _ = eng.generate_fast(prompt, n_predict=n_predict,
                               stop_on_eos=False)
    wall = time.perf_counter() - t0
    tm = eng.timings
    out = {"logits": lg, "logits2": lg2, "ids": ids, "steps": tm.n_step,
           "prefill_tok_s": tm.n_prefill / tm.t_prefill,
           "decode_tok_s": (len(ids) - 1) / tm.t_eval, "wall_s": wall,
           "t_eval_s": tm.t_eval,
           "new_graphs": len(eng.graphs.graphs) - n_graphs}
    expect_launches("mesh generate_fast",
                    {"qmm": per, "qmm_int8": per * tm.n_step})
    base = int(eng.n_past[0])
    out["step_ms"] = event_ms(lambda: (eng.rollback(0, base),
                                       eng.decode_batch_fast({0: 5}, 16)),
                              device) / 16
    eng.rollback(0, base)
    return out


def phase_mesh(device, rng, path: str, n_layers: int, smi: str,
               prompt_len: int = PROMPT, n_predict: int = 64) -> dict:
    """Phase 14a-b on the phase-4 model. 14a: Engine(tp=2) at n_slots 1
    against Engine(tp=1) on the same card: the 512-token prefill's logits
    by cosine (>= MESH_COS), 64 greedy tokens of generate_fast (equal, or
    parted at a near tie of the tp = 1 logits), exact launches (258 qmm a
    ubatch, 258 qmm_int8 a step, 64 flash_attention for a ubatch at span
    1,024), prefill and decode tok/s and event ms a step beside tp = 1's.
    14b: the server with tp 2, dp 2 and 4 slots over loopback HTTP: four
    concurrent greedy requests, each text equal to the request served
    alone, 516 qmm a prefill ubatch and 516 qmm_int8 a step (4 ranks x
    129), the /metrics tier counters."""
    t_phase = time.perf_counter()
    prompt = rng.integers(3, LLAMA_7B["vocab"], size=prompt_len).tolist()
    prompt2 = rng.integers(3, LLAMA_7B["vocab"], size=prompt_len).tolist()
    res = {}
    for tp in (1, 2):
        t0 = time.perf_counter()
        eng = Engine(path, n_ctx=2048, tp=tp, device=device)
        load = time.perf_counter() - t0
        if tp == 2:
            c = eng.cfg_step
            if (c.row_attn, c.row_ffn, c.head_sharded) != ("psum", "gather",
                                                           True):
                raise AssertionError(f"tp 2 modes {c.row_attn}, {c.row_ffn},"
                                     f" head sharded {c.head_sharded}")
            if eng.mesh.describe() != ("mesh (dp 1, tp 2): 2 ranks on "
                                       f"{device}, 1 process"):
                raise AssertionError(eng.mesh.describe())
        r = res[tp] = mesh_run(eng, prompt, prompt2, n_predict, device,
                               n_layers, tp)
        r["load_s"] = load
        log(f"[mesh] tp {tp}: load {load:.2f} s, prefill {prompt_len} tokens "
            f"{r['prefill_tok_s']:.1f} tok/s, decode {len(r['ids']) - 1} "
            f"tokens {r['decode_tok_s']:.2f} tok/s ({r['steps']} steps; "
            f"generate_fast {r['wall_s']:.3f} s wall, {r['t_eval_s']:.3f} s "
            f"of decode, {r['new_graphs']} graphs captured in it), "
            f"{r['step_ms']:.3f} event ms a step of a 16-step block; launches "
            f"exact: {tp * (4 * n_layers + 1)} qmm a ubatch, as many "
            f"qmm_int8 a step, {tp * n_layers} flash_attention at span 1024")
        if tp == 1:
            ref = eng
        else:
            del eng
    cos = cosine(res[2]["logits"], res[1]["logits"])
    cos2 = cosine(res[2]["logits2"], res[1]["logits2"])
    if not (cos >= MESH_COS and cos2 >= MESH_COS):
        raise AssertionError(f"tp 2 vs tp 1 prefill cosine {cos}, {cos2} < "
                             f"{MESH_COS}")
    same = greedy_parting(ref, prompt, res[1]["ids"], res[2]["ids"],
                          "mesh tp2")
    log(f"[mesh] tp 2 vs tp 1: prefill logit cosine {cos!r} ({prompt_len} tokens), "
        f"{cos2!r} (the span-1024 ubatch) (>= {MESH_COS}); generate_fast "
        f"{same}; decode {res[2]['decode_tok_s'] / res[1]['decode_tok_s']:.3f}"
        f"x, prefill {res[2]['prefill_tok_s'] / res[1]['prefill_tok_s']:.3f}"
        f"x of tp 1; {smi}")
    del ref
    torch.cuda.empty_cache()
    # 14b: the dp 2 x tp 2 server, 4 slots
    t0 = time.perf_counter()
    started, base = boot_server(path, device, n_slots=4, n_ctx=2048, tp=2,
                                dp=2)
    eng = started.sched.engine
    per = 4 * (4 * n_layers + 1)
    try:
        reqs = [{"prompt": gen_prompt(path, rng, n)[0], "n_predict": 32,
                 "temperature": 0.0, "repeat_penalty": 1.0}
                for n in MESH_PROMPTS]
        http(base, "/completion", {**reqs[0], "n_predict": 4})   # warm
        eng.timings = Timings()
        reset_port_launches()
        with ThreadPoolExecutor(4) as ex:
            conc = list(ex.map(lambda r: http(base, "/completion", r), reqs))
        got = port_launches()
        steps = eng.timings.n_step
        want = {"qmm": per * len(reqs), "qmm_int8": per * steps}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"dp2 x tp2 server launches {got} != {want}")
        alone = [http(base, "/completion", r) for r in reqs]
        for i, (a, b) in enumerate(zip(conc, alone)):
            if a["content"] != b["content"]:
                raise AssertionError(f"request {i}: concurrent text differs "
                                     "from the request served alone")
        m = metrics_of(base)
    finally:
        stop_server(started)
    del eng
    torch.cuda.empty_cache()
    tiers = {k: m[k] for k in ("decode_fast_blocks_total",
                               "decode_sampled_blocks_total",
                               "decode_slow_steps_total",
                               "mh_workers_lost")}
    log(f"[mesh] server tp 2 x dp 2, 4 slots: four concurrent greedy requests"
        f" ({', '.join(map(str, MESH_PROMPTS))} tokens in, 32 out) equal to "
        f"each served alone; launches exact: {per} qmm a prefill ubatch x "
        f"{len(reqs)}, {per} qmm_int8 a step x {steps}; tiers {tiers}; "
        f"{time.perf_counter() - t0:.1f} s with its load")
    secs = time.perf_counter() - t_phase
    pl, ph = MESH_PREDICTIONS["tp2_prefill_tok_s"]
    dl, dh = MESH_PREDICTIONS["tp2_decode_tok_s"]
    log(f"[mesh] phase 14a-b {secs:.1f} s; tp 2 prefill "
        f"{res[2]['prefill_tok_s']:.1f} tok/s (predicted {pl:g}-{ph:g}), "
        f"decode {res[2]['decode_tok_s']:.2f} tok/s (predicted {dl:g}-"
        f"{dh:g}); {smi}")
    return {"tp1": {k: v for k, v in res[1].items() if "logits" not in k},
            "tp2": {k: v for k, v in res[2].items() if "logits" not in k},
            "seconds": secs}


def mh_server(path: str, pid: int, coord: int, http_port: int, bport: int,
              heartbeat: float, log_path: str, device):
    """One process of 14c's two-process server (the port's server CLI)."""
    argv = [sys.executable, "-m", "tpulamm_torch.server.server", "-m", path,
            "--device", device.type,
            "--tp", "2", "-np", "1", "-c", "512", "--coordinator",
            f"127.0.0.1:{coord}", "--num-processes", "2", "--process-id",
            str(pid), "--port", str(http_port), "--broadcast-port",
            str(bport), "--mh-heartbeat", str(heartbeat)]
    return subprocess.Popen(argv, stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh_small(device, rng, smi: str, n_layers: int = 2,
                     heartbeat: float = 5.0) -> dict:
    """Phase 14c-d at 2 layers of LLaMA-7B width. 14c: the two-process
    server on the one card (--coordinator, --num-processes 2, tp 2 across
    the processes, the broadcast channel): a completion equal to the
    one-process tp 2 server's, then the worker killed and the next request
    answered 503 within --mh-heartbeat. 14d: cli.main with --tp 2 (the
    tokens of --tp 1, exactly twice its launches), cli.bench with --tp 2
    (twice --tp 1's launches), and 2 layers of Mistral-7B width with
    fused_ffn at tp 2 (ffn_fused on each rank's shards, its partial sums
    added: 2 launches a layer and step) against tp 1."""
    from tpulamm_torch.cli import bench as BENCH_CLI
    t_phase = time.perf_counter()
    work = os.path.join(SMOKE_DIR, "mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "llama7b_2l.gguf")
    write_llama_gguf(path, n_layers, rng, **LLAMA_7B)
    text, _ = gen_prompt(path, rng, 48)
    req = {"prompt": text, "n_predict": 24, "temperature": 0.0}
    out = {}
    procs = []
    try:
        # 14c: the two processes load while the one-process server answers
        coord, http0, bport = free_port(), free_port(), free_port()
        procs = [mh_server(path, i, coord, http0, bport, heartbeat,
                           os.path.join(work, f"mh{i}.log"), device)
                 for i in (0, 1)]
        started, base = boot_server(path, device, n_slots=1, n_ctx=512, tp=2)
        try:
            one = http(base, "/completion", req)
        finally:
            stop_server(started)
        mh = f"http://127.0.0.1:{http0}"
        t0 = time.perf_counter()
        while True:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("a multi-host server process exited")
            try:
                http(mh, "/health", timeout=5)
                break
            except OSError:
                if time.perf_counter() - t0 > 240:
                    raise AssertionError("the two-process server is not up")
                time.sleep(0.5)
        t_up = time.perf_counter() - t0
        two = http(mh, "/completion", req)
        if two["content"] != one["content"]:
            raise AssertionError("two-process completion differs from the "
                                 "one-process tp 2 server's")
        procs[1].kill()
        procs[1].wait()
        t_kill, code = time.perf_counter(), None
        while code is None and time.perf_counter() - t_kill < 60:
            try:
                http(mh, "/completion", req, timeout=30)
            except urllib.error.HTTPError as e:
                code = e.code
        t_503 = time.perf_counter() - t_kill
        if code != 503 or t_503 > heartbeat:
            raise AssertionError(f"after the worker died: HTTP {code} in "
                                 f"{t_503:.2f} s (heartbeat {heartbeat} s)")
        lost = metrics_of(mh)["mh_workers_lost"]
        log(f"[mesh] two-process server (tp 2 across 2 processes on "
            f"{device}, gloo): up {t_up:.1f} s after the one-process "
            f"server's answer; {two['tokens_predicted']} tokens equal to "
            f"the one-process tp 2 server's; worker killed: HTTP 503 after "
            f"{t_503:.2f} s (heartbeat {heartbeat} s), mh_workers_lost "
            f"{lost:g}")
        out["t_503"] = t_503
        for p in procs:
            p.kill()
            p.wait()
        # 14d: cli.main and cli.bench at tp 1 and 2
        argv = ["-m", path, "-p", text, "-n", "16", "--temp", "0", "-c",
                "512", "--repeat-penalty", "1.0", "--no-display-prompt",
                "--device", device.type]
        runs = {}
        for tp in (1, 2):
            reset_port_launches()
            rc, o, _, dt = run_cli(f"mesh-main-tp{tp}", gen_main.main,
                                   argv + ["--tp", str(tp)])
            runs[tp] = (rc, o, {k: v for k, v in port_launches().items()
                                if v})
        if runs[1][1] != runs[2][1] or runs[1][0] or runs[2][0]:
            raise AssertionError("cli.main --tp 2 text differs from --tp 1")
        if runs[2][2] != {k: 2 * v for k, v in runs[1][2].items()}:
            raise AssertionError(f"cli.main launches tp 2 {runs[2][2]} != "
                                 f"2 x tp 1 {runs[1][2]}")
        log(f"[mesh] cli.main --tp 2: the text of --tp 1, launches "
            f"{runs[2][2]} = 2 x {runs[1][2]}")
        bl = {}
        for tp in (1, 2):
            reset_port_launches()
            rc, o, _, _ = run_cli(f"mesh-bench-tp{tp}", BENCH_CLI.main, [
                "-m", path, "-p", "128", "-n", "32", "-r", "1", "-c", "512",
                "-o", "json", "--tp", str(tp), "--device", device.type])
            bl[tp] = {k: v for k, v in port_launches().items() if v}
            if rc:
                raise AssertionError(f"cli.bench --tp {tp} returned {rc}")
            out[f"bench_tp{tp}"] = json.loads(o.strip().splitlines()[-1])
        if bl[2] != {k: 2 * v for k, v in bl[1].items()}:
            raise AssertionError(f"cli.bench launches tp 2 {bl[2]} != 2 x "
                                 f"tp 1 {bl[1]}")
        log(f"[mesh] cli.bench --tp 2: {out['bench_tp2']} against --tp 1 "
            f"{out['bench_tp1']}; launches {bl[2]} = 2 x {bl[1]}")
        os.remove(path)
        # 14d: the fused FFN on the ranks' shards (Mistral-7B width)
        mpath = os.path.join(work, "mistral7b_2l.gguf")
        write_llama_gguf(mpath, n_layers, rng, **MISTRAL_7B)
        prompt = rng.integers(3, MISTRAL_7B["vocab"], size=64).tolist()
        ids = {}
        for tp in (1, 2):
            eng = Engine(mpath, n_ctx=512, tp=tp, fused_ffn=True,
                         device=device)
            if tp == 2 and eng.cfg_step.row_ffn != "psum":
                raise AssertionError(f"Mistral tp 2 row_ffn "
                                     f"{eng.cfg_step.row_ffn}")
            eng.generate_fast(prompt, n_predict=16, stop_on_eos=False)
            eng.timings = Timings()
            reset_port_launches()
            ids[tp], _ = eng.generate_fast(prompt, n_predict=16,
                                           stop_on_eos=False)
            steps = eng.timings.n_step
            expect_launches(f"mistral fused tp{tp}", {
                "qmm": tp * (4 * n_layers + 1),
                "qmm_int8": tp * (2 * n_layers + 1) * steps,
                "ffn_fused": tp * n_layers * steps})
            if tp == 1:
                ref = eng
        same = greedy_parting(ref, prompt, ids[1], ids[2], "mistral tp2")
        log(f"[mesh] Mistral-7B width, 2 layers, fused_ffn: tp 2 {same} of "
            f"tp 1; ffn_fused {2 * n_layers} launches a step on the ranks' "
            f"shards (exact)")
        del ref, eng
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for i in (0, 1):
            lp = os.path.join(work, f"mh{i}.log")
            if os.path.exists(lp):
                for line in open(lp).read().splitlines()[-12:]:
                    log(f"[mesh mh{i}] {line[:300]}")
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 14c-d {out['seconds']:.1f} s; {smi}")
    return out


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
        ("16k generate_fast", f"{lc['layers']} layers: "
         f"{lc['decode_tok_s']:.2f} tok/s with its "
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
    # while nvcc builds the kernels: phase 13a's training in a process of
    # its own (it launches no kernel of the port), phase 8's F32 source and
    # 13a''s initial weights in threads (numpy's draws release the GIL)
    files = train_files()
    trained = start_train(files)
    q_src = None
    try:
        with ThreadPoolExecutor(2) as pre:
            q_job = pre.submit(quality_source,
                               np.random.default_rng(SEED + 13), LLAMA_7B, 1)
            init_job = pre.submit(cmp_init)
            phase_build()
            done("build")
            q_src, init2 = q_job.result(), init_job.result()
        # no kernel is timed while the training runs
        trained = {**finish_train(trained), "out": trained["out"]}
        done("training 13a")
        return run_phases(device, rng, smi, kind, files, trained, q_src,
                          init2, done)
    finally:
        proc = trained.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for path in ((q_src[0] if q_src else None), files["vocab"],
                     files["text"], trained["out"]):
            if path is not None and os.path.exists(path):
                os.remove(path)


def cmp_init() -> dict:
    """13a''s initial weights (init_params at TRAIN_CMP's depth), CPU."""
    from tpulamm_torch.train.model import init_params
    return init_params(train_cfg(TRAIN_CMP["layers"]), seed=TRAIN_SEED,
                       device="cpu")


def run_phases(device, rng, smi: str, kind: str, files: dict, trained: dict,
               q_src: tuple, init2: dict, done) -> int:
    """Phases 3-13, the kernels line and the last line."""
    stats = phase_kernels(device, rng)
    done("kernels")
    # phase 3e (slice 19), a generator of its own
    phase_shards(device)
    done("shard kernels")
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
        # a generator of its own, so the later phases draw what they drew
        # before this phase existed
        phase_server(device, np.random.default_rng(SEED + 7), sl["path"],
                     sl["layers"], smi)
        done("server")
        # generators of their own, as phase 7 has
        phase_generation(device, np.random.default_rng(SEED + 14),
                         sl["path"], sl["layers"], smi)
        done("generation")
        phase_speculation(device, np.random.default_rng(SEED + 19),
                          sl["path"], sl["layers"], smi)
        done("speculation")
        # phase 14a-b (slice 19), a generator of its own
        phase_mesh(device, np.random.default_rng(SEED + 29), sl["path"],
                   sl["layers"], smi)
        done("mesh")
    finally:
        os.remove(sl["path"])
    # 16 layers, cut from 32 to make room for phase 11 in the time limit
    lc = phase_long(device, rng, n_layers=16)
    done("long")
    phase_numerics(device, rng)
    done("numerics")
    phase_shift(device, rng)
    done("shift")
    phase_mega_numerics(device, rng)
    done("mega numerics")
    phase_batch_numerics(device, rng)
    done("batch numerics")
    # 1 layer, cut from 2 to keep the script inside its time limit
    phase_tools(device, np.random.default_rng(SEED + 15), smi, n_layers=1)
    done("tools")
    phase_spec_small(device, np.random.default_rng(SEED + 20), smi)
    done("speculation, 2 layers")
    # a generator of its own, as phase 7 has
    # 1 layer, cut from 2 to make room for phase 11 in the time limit
    phase_quality(device, np.random.default_rng(SEED + 13), smi, n_layers=1,
                  source=q_src)
    done("quality")
    # generators of their own, as phase 7 has
    phase_moe(device, np.random.default_rng(SEED + 16), smi)
    done("moe")
    phase_families(device, np.random.default_rng(SEED + 17))
    done("families")
    phase_bloom(device, np.random.default_rng(SEED + 18), smi)
    done("bloom")
    # phase 12 (slice 17), generators of their own
    phase_mamba(device, np.random.default_rng(SEED + 21), smi)
    done("mamba")
    lv = phase_llava(device, np.random.default_rng(SEED + 22), smi)
    done("llava")
    try:
        phase_harness_tools(device, lv["lm"], smi)
        done("harness tools")
    finally:
        os.remove(lv["lm"])
    # phase 13 (slice 18), a generator of its own
    phase_train(device, np.random.default_rng(SEED + 27), smi, files,
                trained, init2)
    done("train")
    # phase 14c-d (slice 19), a generator of its own
    phase_mesh_small(device, np.random.default_rng(SEED + 30), smi)
    done("mesh, 2 layers")
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
