"""Importance-matrix collection (examples/imatrix parity; counterpart of
tpulamm.tools.imatrix).

Runs calibration text through the model and accumulates the mean square of
every matmul input column, per weight tensor — the reference hooks
ggml_mul_mat via a graph callback (imatrix.cpp IMatrixCollector); here the
llama-family forward is instrumented directly, over the model's weights
densified to f32 on the device. The file is the JAX package's .npz: for
each weight tensor the sum over calibration tokens of the square of every
input column (`sum::<tensor name>`) and the number of tokens
(`count::<tensor name>`). `cli.quantize --imatrix` of either package reads
one written by either for weighted rounding (quant.weighted).

    python -m tpulamm_torch.tools.imatrix -m model.gguf -f text.txt \
        -o imatrix.npz [--chunks N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.ops.layers import rms_norm, silu
from tpulamm_torch.ops.rope import apply_rope


class Collector:
    def __init__(self):
        self.sums: dict[str, np.ndarray] = {}
        self.counts: dict[str, int] = {}

    def add(self, name: str, x) -> None:
        """x: (..., K) activations feeding `name` (rows = tokens); the
        column sums of squares are taken in f32 on x's device."""
        x = torch.as_tensor(x).to(torch.float32)
        x = x.reshape(-1, x.shape[-1])
        s = (x * x).sum(dim=0).cpu().numpy()
        if name in self.sums:
            self.sums[name] += s
            self.counts[name] += x.shape[0]
        else:
            self.sums[name] = s
            self.counts[name] = x.shape[0]

    def column_means(self) -> dict[str, np.ndarray]:
        return {n: self.sums[n] / max(self.counts[n], 1) for n in self.sums}

    def save(self, path: str) -> None:
        data = {f"sum::{n}": s for n, s in self.sums.items()}
        data.update({f"count::{n}": np.asarray(self.counts[n])
                     for n in self.counts})
        np.savez(path, **data)


def load_imatrix(path: str) -> dict[str, np.ndarray]:
    """name -> per-column mean square activation (the quantizer's qw)."""
    z = np.load(path)
    out = {}
    for key in z.files:
        if key.startswith("sum::"):
            name = key[5:]
            cnt = int(z[f"count::{name}"])
            out[name] = z[key] / max(cnt, 1)
    return out


@torch.no_grad()
def collect_imatrix(params: dict, cfg: ModelConfig, chunks,
                    progress=None) -> Collector:
    """Instrumented llama forward over dense params (loader tree densified
    by the caller, on its device); chunks: iterable of 1-D token arrays."""
    col = Collector()
    dev = params["tok_emb"].device

    def mm(name: str, x, w):
        col.add(name, x)
        return x @ w.T

    for ci, tokens in enumerate(chunks):
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=dev)[None]
        B, T = toks.shape
        h = params["tok_emb"][toks]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev).expand(B, T)
        mask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        mask = mask[None, None, None]
        hd = cfg.head_dim
        for il, layer in enumerate(params["layers"]):
            pre = f"blk.{il}."
            hn = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
            q = mm(pre + "attn_q.weight", hn, layer["wq"])
            k = mm(pre + "attn_k.weight", hn, layer["wk"])
            v = mm(pre + "attn_v.weight", hn, layer["wv"])
            q = apply_rope(q.reshape(B, T, cfg.n_heads, hd), positions,
                           cfg.rope)
            k = apply_rope(k.reshape(B, T, cfg.n_kv_heads, hd), positions,
                           cfg.rope)
            v = v.reshape(B, T, cfg.n_kv_heads, hd)
            group = cfg.n_heads // cfg.n_kv_heads
            qg = q.reshape(B, T, cfg.n_kv_heads, group, hd)
            scores = torch.einsum("bthgd,bshd->bhgts", qg, k) / np.sqrt(hd)
            scores = scores.masked_fill(~mask, -1e30)
            probs = torch.exp(scores - scores.amax(-1, keepdim=True))
            probs = probs / probs.sum(-1, keepdim=True)
            attn = torch.einsum("bhgts,bshd->bthgd", probs, v)
            attn = attn.reshape(B, T, cfg.n_heads * hd)
            h = h + mm(pre + "attn_output.weight", attn, layer["wo"])
            hn = rms_norm(h, layer["ffn_norm"], cfg.norm_eps)
            gate = mm(pre + "ffn_gate.weight", hn, layer["w_gate"])
            up = mm(pre + "ffn_up.weight", hn, layer["w_up"])
            mid = silu(gate) * up
            h = h + mm(pre + "ffn_down.weight", mid, layer["w_down"])
        hn = rms_norm(h, params["out_norm"], cfg.norm_eps)
        col.add("output.weight", hn)
        if progress:
            progress(ci)
    return col


def densify_params(params: dict) -> dict:
    """A loaded params tree with every QTensor dequantized to a dense f32
    (N, K) tensor on its device; dense leaves kept."""
    from tpulamm_torch.ops.qtensor import (QTensor, dequant_mm,
                                           gather_dequant_rows)

    def d(v):
        if isinstance(v, QTensor):
            if v.layout == "rows":
                idx = torch.arange(v.shape[0], device=v.device)
                return gather_dequant_rows(v, idx, torch.float32)
            return dequant_mm(v, torch.float32).T
        return v
    out = {k: d(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: d(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def main(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(prog="tpulamm-torch-imatrix")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", required=True, help="calibration text")
    p.add_argument("-o", "--output", default="imatrix.npz")
    p.add_argument("-c", "--chunk-size", type=int, default=512)
    p.add_argument("--chunks", type=int, default=0, help="max chunks (0=all)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "path)")
    args = p.parse_args(argv)

    from tpulamm_torch.models.loader import load_model
    from tpulamm_torch.runtime.engine import resolve_device
    from tpulamm_torch.tokenizer.spm import build_tokenizer
    dev = resolve_device(args.device)
    cfg, params, md = load_model(args.model, compute_dtype="float32",
                                 device=dev)
    assert cfg.arch == "llama", "imatrix collection supports llama-family"
    tokenizer = build_tokenizer(md)
    with open(args.file, errors="replace") as f:
        tokens = tokenizer.encode(f.read(), add_bos=False)
    n = len(tokens) // args.chunk_size
    if args.chunks:
        n = min(n, args.chunks)
    assert n > 0, "corpus shorter than one chunk"
    chunks = [tokens[i * args.chunk_size:(i + 1) * args.chunk_size]
              for i in range(n)]
    dense = densify_params(params)
    col = collect_imatrix(
        dense, cfg, chunks,
        progress=lambda i: print(f"chunk {i + 1}/{n}", file=sys.stderr))
    col.save(args.output)
    print(f"saved {args.output}: {len(col.sums)} tensors, "
          f"{sum(col.counts.values())} token-rows", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
