"""LoRA: low-rank adapters — apply at load and finetune on a frozen base
(counterpart of tpulamm.train.lora).

Parity with the reference's llama_model_apply_lora_from_file
(llama.h:436, llama.cpp ~12850: W += scale * B@A per matched tensor, where
scale = alpha/r) and examples/finetune (LoRA finetuning with frozen base
weights, checkpointed as a loadable adapter file).

Adapter file format (the JAX package's): GGUF with metadata
{adapter.type="lora", adapter.lora.r, adapter.lora.alpha} and tensors
"<gguf base name>.lora_a" (r, K) / ".lora_b" (N, r).
"""

from __future__ import annotations

import numpy as np
import torch

from tpulamm_torch.gguf.reader import GGUFReader
from tpulamm_torch.gguf.writer import GGUFWriter
from tpulamm_torch.models.config import ModelConfig
from tpulamm_torch.train.model import to_numpy

# param-tree key -> gguf tensor base name (llama arch)
_KEY2NAME = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
             "wo": "attn_output", "w_gate": "ffn_gate", "w_up": "ffn_up",
             "w_down": "ffn_down"}
_NAME2KEY = {v: k for k, v in _KEY2NAME.items()}


def init_lora(params: dict, r: int = 8, alpha: int = 16, seed: int = 0,
              targets: tuple[str, ...] = ("wq", "wv")) -> dict:
    """LoRA tree mirroring params: {layers: [{wq: {a, b}, ...}]}.
    A ~ N(0, 1/r), B = 0 (standard init: delta starts at zero); the JAX
    package's draws, on each weight's device and dtype."""
    rng = np.random.default_rng(seed)
    lora = {"r": r, "alpha": alpha, "layers": []}
    for layer in params["layers"]:
        entry = {}
        for key in targets:
            w = layer[key]
            n, k = w.shape
            a = rng.normal(0, 1.0 / r, (r, k)).astype(np.float32)
            entry[key] = {
                "a": torch.from_numpy(a).to(device=w.device, dtype=w.dtype),
                "b": torch.zeros((n, r), dtype=w.dtype, device=w.device),
            }
        lora["layers"].append(entry)
    return lora


def merge_lora(params: dict, lora: dict) -> dict:
    """W += (alpha/r) * B @ A — returns a new params tree (dense weights)."""
    scale = lora["alpha"] / lora["r"]
    out = dict(params)
    out["layers"] = []
    for layer, ladapt in zip(params["layers"], lora["layers"]):
        new = dict(layer)
        for key, ab in ladapt.items():
            new[key] = layer[key] + scale * (ab["b"] @ ab["a"])
        out["layers"].append(new)
    return out


def finetune_lora(params: dict, cfg: ModelConfig, data, tc,
                  r: int = 8, alpha: int = 16,
                  targets: tuple[str, ...] = ("wq", "wv"),
                  log=print) -> tuple[dict, list[float]]:
    """LoRA finetuning: base frozen, adapters trained (examples/finetune
    semantics) with make_optimizer(tc) on the adapters alone. Returns
    (lora tree, losses)."""
    from tpulamm_torch.train.model import causal_lm_loss
    from tpulamm_torch.train.train import optimize, sample_batches

    lora = init_lora(params, r=r, alpha=alpha, seed=tc.seed, targets=targets)

    def loss_fn(adapters, batch):
        merged = merge_lora(params, {"r": r, "alpha": alpha,
                                     "layers": adapters})
        return causal_lm_loss(merged, cfg, batch, remat=tc.remat)
    lora["layers"], losses = optimize(
        lora["layers"], loss_fn, tc, sample_batches(np.asarray(data), tc),
        log=log, prefix="lora step")
    return lora, losses


def save_lora_gguf(lora: dict, path: str) -> None:
    w = GGUFWriter(path)
    w.add_kv("general.architecture", "lora")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.r", int(lora["r"]))
    w.add_kv("adapter.lora.alpha", int(lora["alpha"]))
    for i, layer in enumerate(lora["layers"]):
        for key, ab in layer.items():
            base = f"blk.{i}.{_KEY2NAME[key]}.weight"
            w.add_tensor(base + ".lora_a", to_numpy(ab["a"]))
            w.add_tensor(base + ".lora_b", to_numpy(ab["b"]))
    w.write()


def load_lora_gguf(path: str) -> dict:
    """An adapter file -> the lora tree, its tensors f32 on the CPU."""
    rd = GGUFReader(path)
    r = int(rd.metadata.get("adapter.lora.r", 8))
    alpha = int(rd.metadata.get("adapter.lora.alpha", r * 2))
    layers: dict[int, dict] = {}
    for name, info in rd.tensors.items():
        if name.endswith(".lora_a") or name.endswith(".lora_b"):
            parts = name.split(".")          # blk, i, base, weight, lora_x
            i = int(parts[1])
            key = _NAME2KEY[parts[2]]
            ab = "a" if name.endswith("a") else "b"
            layers.setdefault(i, {}).setdefault(key, {})[ab] = \
                torch.from_numpy(np.array(info.to_f32(), np.float32))
    rd.close()
    n_layers = max(layers) + 1 if layers else 0
    return {"r": r, "alpha": alpha,
            "layers": [layers.get(i, {}) for i in range(n_layers)]}


def apply_lora_to_qparams(params: dict, lora: dict, cfg: ModelConfig) -> dict:
    """Apply an adapter to a LOADED inference model (QTensors included):
    dequantize -> add delta -> requantize to the original block format
    (llama_model_apply_lora_from_file does the same dequant/requant dance
    for quantized bases). The delta is scale * B @ A in f32 numpy and the
    dequantization runs on the CPU, as cli.export_lora's do, so a patched
    tensor's planes equal those of the file export_lora writes."""
    from tpulamm_torch.ops.qtensor import QTensor, dequant_mm
    from tpulamm_torch.quant.formats import quantize

    scale = lora["alpha"] / lora["r"]
    out = dict(params)
    out["layers"] = []
    for layer, ladapt in zip(params["layers"], lora["layers"]):
        new = dict(layer)
        for key, ab in ladapt.items():
            w = layer[key]
            delta = scale * (to_numpy(ab["b"]) @ to_numpy(ab["a"]))
            if isinstance(w, QTensor):
                dense = dequant_mm(w.to("cpu"), torch.float32).numpy().T
                raw = quantize(np.ascontiguousarray(dense + delta), w.qtype)
                new[key] = QTensor.from_gguf_raw(raw, w.qtype, w.shape,
                                                 layout=w.layout,
                                                 device=w.device)
            else:
                new[key] = w + torch.from_numpy(delta).to(w.device, w.dtype)
        out["layers"].append(new)
    return out
