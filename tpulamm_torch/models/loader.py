"""GGUF model loader -> (ModelConfig, params dict) on a torch device
(counterpart of tpulamm.models.loader) for every architecture of
models.config.

Quantized tensors are copied to the device as GGUF blocks and repacked
there once (quant/repack.py, torch ops; the token embedding, the lm head
and the layers in parallel threads) into the mm or rows planes;
weights that do not tile (K % 256 or N % 128) are stored dense. A fused
attn_qkv weight is split into wq/wk/wv rows at load time (every row of a
block-quant tensor is coded on its own, so the split is exact;
persimmon's per-head interleaved rows included). Optional tensors
(biases, second norms, q/k norms, the MoE router and experts, mpt's act
scales, learned positions) are probed by name, as the reference's
`required=false` create_tensor calls are; the forward uses what is there.

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


class AbortError(RuntimeError):
    """Raised when the abort callback requests cancellation mid-compute
    (ggml_abort_callback parity, ggml.c:18328 / llama.h:654)."""


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

    def matmul(self, info: GGUFTensorInfo):
        """A weight used as x @ W.T: an mm QTensor, or dense."""
        return _mm_from_rows(info.as_rows(), info.ggml_type,
                             (info.shape[-2], info.shape[-1]), self.cfg,
                             self.device)

    def mm(self, out: dict, pkey: str, name: str, required=False):
        """matmul weight + optional bias -> out[pkey], out[bias key]"""
        key = name + ".weight"
        if key not in self.t:
            if required:
                raise KeyError(f"model tensor missing: {key}")
            return
        out[pkey] = self.matmul(self.t[key])
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
    """Split a fused attn_qkv weight into (wq, wk, wv) by rows, exactly.
    Contiguous q | k | v row blocks (falcon, gpt2, starcoder, bloom, mpt,
    qwen, phi2, codeshell); persimmon interleaves them per head, rows
    (head, [q|k|v], head_dim) (build_persimmon, llama.cpp:6225-6232)."""
    hd, H, Hkv, dim = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.dim
    rows = info.as_rows()
    if cfg.qk_norm and cfg.arch == "persimmon":
        idx = np.arange(rows.shape[0]).reshape(H, 3, hd)
        qi, ki, vi = idx[:, 0].ravel(), idx[:, 1].ravel(), idx[:, 2].ravel()
    else:
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
    """One block's tensors by the JAX loader's names (loader.py:147-218)."""
    pre = f"blk.{i}."
    out: dict[str, Any] = {}
    for pkey, name in (("attn_norm", "attn_norm"),
                       ("attn_norm_2", "attn_norm_2"),
                       ("attn_q_norm", "attn_q_norm"),
                       ("attn_k_norm", "attn_k_norm"),
                       ("attn_out_norm", "attn_output_norm"),
                       ("layer_out_norm", "layer_output_norm"),
                       ("ffn_norm", "ffn_norm")):
        tm.norm(out, pkey, pre + name)
    if cfg.arch == "mamba":
        # the SSM block (loader.py:158-170): the four projections as matmul
        # weights (ssm_x and ssm_dt, F32 in the file, stay dense; ssm_dt's
        # bias lands in ssm_dt_b), the conv, A and D f32
        for pkey in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out"):
            tm.mm(out, pkey, pre + pkey, required=True)
        for pkey in ("ssm_conv1d", "ssm_a", "ssm_d"):
            out[pkey] = tm.f32(tm.req(pre + pkey))
        if pre + "ssm_conv1d.bias" in tm.t:
            out["ssm_conv1d_b"] = tm.f32(tm.t[pre + "ssm_conv1d.bias"])
        return out
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
    if cfg.n_expert > 0 and tm.has(pre + "ffn_gate_inp"):
        # MoE (build_llama :5797): the router and each expert's gate, down
        # and up, as lists
        out["ffn_gate_inp"] = tm.matmul(tm.req(pre + "ffn_gate_inp"))
        for part in ("gate", "down", "up"):
            out[f"ffn_{part}_exp"] = [
                tm.matmul(tm.req(f"{pre}ffn_{part}.{e}"))
                for e in range(cfg.n_expert)]
    else:
        tm.mm(out, "w_gate", pre + "ffn_gate")
        tm.mm(out, "w_up", pre + "ffn_up", required=True)
        tm.mm(out, "w_down", pre + "ffn_down", required=True)
        if pre + "ffn.act.scales" in tm.t:   # mpt LLM_TENSOR_FFN_ACT (:543)
            out["ffn_act_scales"] = tm.f32(tm.t[pre + "ffn.act.scales"])
    return out


def parse_kv_override(s: str) -> tuple[str, Any]:
    """Parse a --override-kv item 'key=type:value' (llama_model_kv_override
    format, common.cpp): types int, float, bool, str."""
    key, _, tv = s.partition("=")
    typ, _, val = tv.partition(":")
    if not key or not typ or val == "":
        raise ValueError(f"bad --override-kv {s!r}; want KEY=TYPE:VALUE")
    cast = {"int": int, "float": float, "str": str,
            "bool": lambda v: v.lower() in ("1", "true", "yes")}.get(typ)
    if cast is None:
        raise ValueError(f"bad --override-kv type {typ!r} "
                         "(int|float|bool|str)")
    return key, cast(val)


def load_model(path: str, *, compute_dtype: str | None = None,
               device="cpu", kv_overrides: dict[str, Any] | None = None,
               abort=None) -> tuple[ModelConfig, dict[str, Any], dict]:
    """Returns (config, params, metadata); metadata keeps the tokenizer
    KVs. Params live on `device`.

    kv_overrides: GGUF metadata values applied before the hyperparameters
    are read (llama_model_kv_override / --override-kv).
    abort: optional callback () -> bool checked before each layer is
    loaded; True cancels the load with AbortError (a progress callback
    returning false, test-model-load-cancel.cpp)."""
    reader = GGUFReader(path)
    if kv_overrides:
        reader.metadata.update(kv_overrides)
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

    def embedding():
        if emb.ggml_type in SPECS:
            return QTensor.from_gguf_raw(
                np.asarray(emb.data), emb.ggml_type, (n, k), layout="rows",
                device=device)
        dt = torch.float32 if emb.ggml_type == GGMLType.F32 else cfg.cdtype
        return _dense(emb.to_f32(), dt, device)

    def head():
        out: dict[str, Any] = {}
        if tm.has("output"):
            tm.mm(out, "output", "output", required=True)
        elif cfg.tie_embeddings:
            out["output"] = _mm_from_rows(emb.as_rows(), emb.ggml_type,
                                          (n, k), cfg, device)
        return out

    tm.norm(params, "tok_norm", "token_embd_norm")
    tm.norm(params, "out_norm", "output_norm")
    for pkey, name in (("type_emb", "token_types"),
                       ("pos_emb", "position_embd")):
        if tm.has(name):
            params[pkey] = _dense(tm.req(name).to_f32(), cfg.cdtype, device)
    if not tm.has("output") and cfg.arch not in ("bert", "nomic-bert"):
        # tied embeddings: the lm head reuses token_embd (minicpm; the
        # fallbacks of llm_load_tensors, llama.cpp:158-162, :454, :801);
        # bert is an embedding model with no lm head
        cfg.tie_embeddings = True

    # the token embedding, the head and the layers load in parallel
    # threads: the reads of the mapped file and the copies to the device
    # release the GIL (the embedding and the head are most of a model of a
    # layer or two)
    def layer(i):
        if abort is not None and abort():
            raise AbortError(f"model load cancelled at layer {i}")
        return _layer_params(tm, cfg, i)
    try:
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            emb_f, head_f = ex.submit(embedding), ex.submit(head)
            layers = list(ex.map(layer, range(cfg.n_layers)))
            params = {"tok_emb": emb_f.result(), **params,
                      **head_f.result(), "layers": layers}
    except AbortError:
        reader.close()
        raise
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
