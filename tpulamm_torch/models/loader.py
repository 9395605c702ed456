"""GGUF model loader -> (ModelConfig, params dict) on a torch device
(counterpart of tpulamm.models.loader, llama tensors).

Quantized tensors are repacked once (quant/repack.py, numpy; the layers
in parallel threads) into the mm or rows planes and copied to the device;
weights that do not tile (K % 256 or N % 128) are stored dense. A fused
attn_qkv weight is split into wq/wk/wv rows at load time (every row of a
block-quant tensor is coded on its own, so the split is exact).

`params_from_numpy` carries a params tree built elsewhere (the JAX
package's, with its arrays as numpy) across into the port's form.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from tpulamm_torch.gguf.constants import GGMLType
from tpulamm_torch.gguf.reader import GGUFReader, GGUFTensorInfo
from tpulamm_torch.models.config import ModelConfig, config_from_metadata
from tpulamm_torch.ops.qtensor import QTensor, plane_from_numpy
from tpulamm_torch.quant.formats import dequantize
from tpulamm_torch.quant.repack import SPECS

log = logging.getLogger("tpulamm_torch.loader")


def _dense(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        device=device, dtype=dtype)


def _mm_from_rows(raw_rows: np.ndarray, ggml_type: GGMLType,
                  shape: tuple[int, int], cfg: ModelConfig, device):
    n, k = shape
    if ggml_type in SPECS and k % 256 == 0 and n % 128 == 0:
        return QTensor.from_gguf_raw(raw_rows, ggml_type, (n, k), layout="mm",
                                     device=device)
    w = dequantize(raw_rows, ggml_type, k).reshape(n, k)
    if ggml_type in SPECS:
        log.warning("quant tensor (N=%d, K=%d) not tile-aligned; "
                    "storing dense", n, k)
    dt = torch.float32 if ggml_type == GGMLType.F32 else cfg.cdtype
    return _dense(w, dt, device)


class _TensorMap:
    """Name-probing access over the GGUF tensor table."""

    def __init__(self, tensors: dict[str, GGUFTensorInfo], cfg: ModelConfig,
                 device):
        self.t = tensors
        self.cfg = cfg
        self.device = device

    def has(self, name: str) -> bool:
        return name + ".weight" in self.t

    def req(self, name: str) -> GGUFTensorInfo:
        key = name + ".weight"
        if key not in self.t:
            raise KeyError(f"model tensor missing: {key}")
        return self.t[key]

    def f32(self, info: GGUFTensorInfo) -> torch.Tensor:
        return _dense(info.to_f32(), torch.float32, self.device)

    def mm(self, out: dict, pkey: str, name: str, required=False):
        """matmul weight + optional bias -> out[pkey], out[bias key]"""
        key = name + ".weight"
        if key not in self.t:
            if required:
                raise KeyError(f"model tensor missing: {key}")
            return
        info = self.t[key]
        out[pkey] = _mm_from_rows(info.as_rows(), info.ggml_type,
                                  (info.shape[-2], info.shape[-1]), self.cfg,
                                  self.device)
        if name + ".bias" in self.t:
            out[_bias_key(pkey)] = self.f32(self.t[name + ".bias"])

    def norm(self, out: dict, pkey: str, name: str):
        if name + ".weight" not in self.t:
            return
        out[pkey] = self.f32(self.t[name + ".weight"])
        if name + ".bias" in self.t:
            out[pkey + "_b"] = self.f32(self.t[name + ".bias"])


def _bias_key(pkey: str) -> str:
    return {"wq": "bq", "wk": "bk", "wv": "bv", "wo": "bo",
            "w_gate": "b_gate", "w_up": "b_up", "w_down": "b_down",
            "output": "output_b"}.get(pkey, pkey + "_b")


def _split_qkv(tm: _TensorMap, info: GGUFTensorInfo, cfg: ModelConfig):
    """Split a fused attn_qkv weight into (wq, wk, wv) by rows, exactly:
    contiguous q | k | v row blocks."""
    hd, H, Hkv, dim = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.dim
    rows = info.as_rows()
    assert rows.shape[0] == (H + 2 * Hkv) * hd, \
        f"attn_qkv rows {rows.shape[0]} != (H+2Hkv)*hd {(H + 2 * Hkv) * hd}"
    qi = np.arange(0, H * hd)
    ki = np.arange(H * hd, (H + Hkv) * hd)
    vi = np.arange((H + Hkv) * hd, (H + 2 * Hkv) * hd)
    parts = [_mm_from_rows(np.ascontiguousarray(rows[sel]), info.ggml_type,
                           (len(sel), dim), cfg, tm.device)
             for sel in (qi, ki, vi)]
    return parts, (qi, ki, vi)


def _layer_params(tm: _TensorMap, cfg: ModelConfig, i: int) -> dict[str, Any]:
    pre = f"blk.{i}."
    out: dict[str, Any] = {}
    tm.norm(out, "attn_norm", pre + "attn_norm")
    tm.norm(out, "ffn_norm", pre + "ffn_norm")
    if tm.has(pre + "attn_qkv"):
        (out["wq"], out["wk"], out["wv"]), (qi, ki, vi) = \
            _split_qkv(tm, tm.req(pre + "attn_qkv"), cfg)
        bkey = pre + "attn_qkv.bias"
        if bkey in tm.t:
            b = tm.t[bkey].to_f32()
            for key, sel in (("bq", qi), ("bk", ki), ("bv", vi)):
                out[key] = _dense(b[sel], torch.float32, tm.device)
    else:
        tm.mm(out, "wq", pre + "attn_q", required=True)
        tm.mm(out, "wk", pre + "attn_k", required=True)
        tm.mm(out, "wv", pre + "attn_v", required=True)
    tm.mm(out, "wo", pre + "attn_output", required=True)
    tm.mm(out, "w_gate", pre + "ffn_gate", required=True)
    tm.mm(out, "w_up", pre + "ffn_up", required=True)
    tm.mm(out, "w_down", pre + "ffn_down", required=True)
    return out


def load_model(path: str, *, compute_dtype: str | None = None,
               device="cpu") -> tuple[ModelConfig, dict[str, Any], dict]:
    """Returns (config, params, metadata); metadata keeps the tokenizer
    KVs. Params live on `device`."""
    reader = GGUFReader(path)
    cfg = config_from_metadata(reader.metadata)
    if compute_dtype:
        cfg.compute_dtype = compute_dtype
    from tpulamm_torch.models.transformer import unsupported_features
    missing = unsupported_features(cfg)
    if missing:
        reader.close()
        raise NotImplementedError(f"{cfg.arch}: features not ported yet: "
                                  f"{missing} (ROADMAP queue 1)")
    tm = _TensorMap(reader.tensors, cfg, device)
    params: dict[str, Any] = {}
    emb = tm.req("token_embd")
    n, k = emb.shape
    if emb.ggml_type in SPECS:
        params["tok_emb"] = QTensor.from_gguf_raw(
            np.asarray(emb.data), emb.ggml_type, (n, k), layout="rows",
            device=device)
    else:
        dt = torch.float32 if emb.ggml_type == GGMLType.F32 else cfg.cdtype
        params["tok_emb"] = _dense(emb.to_f32(), dt, device)
    tm.norm(params, "out_norm", "output_norm")
    if tm.has("output"):
        tm.mm(params, "output", "output", required=True)
    else:
        # tied embeddings: the lm head reuses token_embd
        cfg.tie_embeddings = True
        params["output"] = _mm_from_rows(emb.as_rows(), emb.ggml_type, (n, k),
                                         cfg, device)
    # the layers repack in parallel threads: numpy releases the GIL in the
    # copies and bit operations that take the time (about 4x faster on 8
    # cores at LLaMA-7B shape)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        params["layers"] = list(ex.map(lambda i: _layer_params(tm, cfg, i),
                                       range(cfg.n_layers)))
    md = dict(reader.metadata)
    reader.close()
    return cfg, params, md


def params_from_numpy(params, cfg: ModelConfig, device="cpu"):
    """A params tree whose quantized weights are objects with `qtype`,
    `shape`, `layout` and a `planes` dict of arrays (the JAX package's
    QTensor), and whose other leaves are arrays, -> the port's params on
    `device`. Arrays go through numpy; bf16 leaves stay bf16."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, cfg, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_from_numpy(v, cfg, device) for v in params]
    if params is None:
        return None
    if hasattr(params, "planes") and hasattr(params, "layout"):
        return QTensor(qtype=GGMLType(int(params.qtype)),
                       shape=tuple(int(s) for s in params.shape),
                       layout=params.layout,
                       planes={k: plane_from_numpy(np.asarray(v), device)
                               for k, v in params.planes.items()})
    arr = np.asarray(params)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if arr.dtype == np.float16:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(np.array(arr)).to(device)
