"""Tiny llama GGUFs shared by the port's parity tests (test_torch_*.py).

dim 256, 2 layers, 4 query / 2 KV heads, ffn 512, vocab 512 with a
byte-fallback SPM vocab: the shape tests/test_engine.py uses. Weights are a
seeded numpy draw (std 0.08, so greedy choices are not near-ties), written
by the JAX package's converter; both packages then read the same file.
"""

from tpulamm.gguf.constants import GGMLType
from tpulamm.tools.convert_hf import convert_hf_llama
from tpulamm.tools.make_bench_model import make_llama_sd, make_spm_vocab

VOCAB = 512


def write_tiny_llama(path: str, qtype=GGMLType.Q4_0, seed: int = 0) -> str:
    sd, cfg = make_llama_sd(dim=256, n_ff=512, n_layers=2, n_head=4, n_kv=2,
                            n_vocab=VOCAB, seed=seed)
    sd = {k: (v if k.endswith("norm.weight") else v * 4.0)
          for k, v in sd.items()}
    convert_hf_llama(sd, cfg, path, qtype=qtype, vocab=make_spm_vocab(VOCAB))
    return path
