"""tpulamm_torch -- the PyTorch / CUDA port of tpulamm.

The same engine as the JAX package beside it (GGUF models, weights kept
block-quantized on the device, every projection a fused dequant-matmul),
on an NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel of
the JAX package becomes a kernel written by hand for Hopper (csrc/). The
module names follow tpulamm's so each counterpart is easy to find. The
package imports torch and numpy, never jax and nothing of tpulamm.

Package map:
  gguf/      GGUF reader/writer (copies)
  quant/     repack planes (numpy), dense-type decode
  ops/       QTensor, the CUDA kernel wrappers (qmm) and their nvcc build,
             qmatmul dispatch, norms/activations, RoPE
  models/    config, the generic forward (every architecture but mamba),
             GGUF loader
  runtime/   KV cache, engine, decode graphs, host sampler, chat templates
  grammar/   GBNF parser and engine, JSON schema -> GBNF (copies)
  server/    the HTTP server (continuous batching over the engine's slots)
  tokenizer/ SPM (copy), BPE and WPM tokenizers
  utils/     file logging (copy)
  cli/       simple, bench
  csrc/      CUDA sources, built at first use into build/
"""

__version__ = "0.1.0"
