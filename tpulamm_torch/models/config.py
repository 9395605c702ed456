"""Model hyperparameters from GGUF metadata — all reference architectures.

Parity with llm_load_hparams (llama.cpp:3262-3640) plus the per-arch
structural facts encoded in the reference's graph-building functions
(llm_build_context::build_* , llama.cpp:5708-8308) and its rope-type table
(llama_rope_type, llama.cpp:13118-13162). Arch-prefixed keys
("llama.embedding_length", ...) follow the gguf-py constants.

Every architecture dispatched by llama_build_graph at b2430 is described
here: llama, baichuan, falcon, gpt2, mpt, starcoder, persimmon, refact,
bert, nomic-bert, bloom, stablelm, qwen, qwen2, phi2, plamo, codeshell,
orion, internlm2, minicpm, gemma, starcoder2, mamba.

Counterpart of tpulamm.models.config with a torch compute dtype. The port
parses every architecture's metadata and runs all of them:
models.transformer the attention ones, models.mamba mamba.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from tpulamm_torch.ops.rope import RopeParams


@dataclass
class ModelConfig:
    arch: str = "llama"
    vocab_size: int = 32000
    dim: int = 2048                 # n_embd
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    ffn_dim: int = 5632
    n_ctx_train: int = 2048
    norm_eps: float = 1e-5
    rope: RopeParams = field(default_factory=lambda: RopeParams(n_rot=64))
    tie_embeddings: bool = False
    # compute policy
    compute_dtype: str = "bfloat16"
    # MoE (mixtral-style, llama.cpp:5797; minicpm shares the branch)
    n_expert: int = 0
    n_expert_used: int = 0

    # -- structural flags (one generic forward serves every arch) -----------
    norm_type: str = "rms"          # "rms" | "ln" (LLM_NORM_RMS vs LLM_NORM)
    parallel_residual: bool = False # falcon/phi2/plamo: h += attn_out+ffn(attn_norm_h)
    post_norm: bool = False         # bert family: norm AFTER each residual add
    ffn_act: str = "silu"           # silu | gelu | relu | relu_sqr
    pos_emb: bool = False           # learned absolute positions (gpt2/starcoder/bert)
    tok_norm: bool = False          # embedding layernorm (bloom/bert)
    causal: bool = True             # bert: KV attention.causal = false
    pooling: str = "none"           # none | mean | cls  (bert embeddings)
    qk_norm: bool = False           # persimmon per-head q/k layernorm
    max_alibi_bias: float = 0.0     # >0 enables ALiBi (mpt/bloom/refact/baichuan-13B)
    clamp_kqv: float = 0.0          # mpt: clamp fused qkv activations
    emb_scale: float = 1.0          # gemma sqrt(dim); minicpm 12.0
    res_scale: float = 1.0          # minicpm scale_depth/sqrt(n_layers)
    logit_scale: float = 1.0        # minicpm 256/dim
    head_dim_kv: int = 0            # {arch}.attention.key_length override (gemma)

    # -- mamba SSM hparams (llama.cpp:3596-3612) ----------------------------
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0

    # -- tensor-parallel execution context -----------------------------------
    # Set only on the per-rank cfg the Engine builds for a mesh
    # (parallel.mesh): n_heads / n_kv_heads above are then LOCAL (global //
    # tp), head_dim_kv holds the global head geometry, and the forward
    # completes the row-parallel projections and gathers a vocab-sharded lm
    # head across the tp ranks.
    tp: int = 1
    tp_axis: str | None = None
    head_sharded: bool = False      # lm head vocab axis sharded on tp
    # how each row-parallel projection completes its contraction:
    # "psum"   -- weight K-sharded: partial products summed over tp
    # "gather" -- weight replicated but activation feature-local (upstream
    #             col weight sharded): the activation is gathered first
    # "none"   -- nothing sharded on this path
    row_attn: str = "none"          # attn output projection (wo)
    row_ffn: str = "none"           # ffn down projection (w_down)
    row_moe: str = "none"           # per-expert down projections

    # attention kernel selection: None = auto (flash kernel on CUDA when
    # the span calls for it), True/False = force
    flash_attn: bool | None = None
    # opt-in decode kernels on CUDA (the JAX package's TPULAMM_FUSED_FFN and
    # TPULAMM_INT8_INKQ): the one-launch FFN for <= 16 rows, and the int8
    # gemv that quantizes its activations inside its launch
    fused_ffn: bool = False
    int8_inkq: bool = False

    @property
    def head_dim(self) -> int:
        # n_heads is local under tensor parallelism; head geometry is global
        return (self.head_dim_kv if self.head_dim_kv
                else self.dim // (self.n_heads * self.tp))

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


# Structural registry. rope: per llama_rope_type (llama.cpp:13118-13162).
# norm/act/residual topology: per each build_* function (llama.cpp:5708+).
ARCH_SPECS: dict[str, dict] = {
    "llama":      dict(norm="rms", rope="norm", act="silu"),
    "baichuan":   dict(norm="rms", rope="norm", act="silu"),
    "internlm2":  dict(norm="rms", rope="norm", act="silu"),
    "orion":      dict(norm="ln",  rope="norm", act="silu"),
    "minicpm":    dict(norm="rms", rope="norm", act="silu"),
    "plamo":      dict(norm="rms", rope="norm", act="silu",
                       parallel_residual=True),
    "codeshell":  dict(norm="ln",  rope="norm", act="gelu"),
    "starcoder":  dict(norm="ln",  rope="none", act="gelu", pos_emb=True),
    "starcoder2": dict(norm="ln",  rope="neox", act="gelu"),
    "gpt2":       dict(norm="ln",  rope="none", act="gelu", pos_emb=True),
    "gptj":       dict(norm="ln",  rope="norm", act="gelu",
                       parallel_residual=True),
    "gptneox":    dict(norm="ln",  rope="neox", act="gelu",
                       parallel_residual=True),
    "falcon":     dict(norm="ln",  rope="neox", act="gelu",
                       parallel_residual=True),
    "mpt":        dict(norm="ln",  rope="none", act="gelu"),
    "bloom":      dict(norm="ln",  rope="none", act="gelu", tok_norm=True,
                       alibi=8.0),
    "refact":     dict(norm="rms", rope="none", act="silu", alibi=8.0),
    "persimmon":  dict(norm="ln",  rope="neox", act="relu_sqr", qk_norm=True),
    "stablelm":   dict(norm="ln",  rope="neox", act="silu"),
    "qwen":       dict(norm="rms", rope="neox", act="silu"),
    "qwen2":      dict(norm="rms", rope="neox", act="silu"),
    "phi2":       dict(norm="ln",  rope="neox", act="gelu",
                       parallel_residual=True),
    "gemma":      dict(norm="rms", rope="neox", act="gelu"),
    "bert":       dict(norm="ln",  rope="none", act="gelu", pos_emb=True,
                       tok_norm=True, post_norm=True, causal=False),
    "nomic-bert": dict(norm="ln",  rope="neox", act="silu",
                       tok_norm=True, post_norm=True, causal=False),
    "mamba":      dict(norm="rms", rope="none", act="silu"),
}

_POOLING_NAMES = {0: "none", 1: "mean", 2: "cls"}  # llama_pooling_type enum


def _get(md: dict, key: str, default=None, required=False):
    if key in md:
        return md[key]
    if required:
        raise KeyError(f"GGUF metadata missing required key {key}")
    return default


def config_from_metadata(md: dict) -> ModelConfig:
    arch = _get(md, "general.architecture", required=True)
    if arch not in ARCH_SPECS:
        raise NotImplementedError(f"architecture {arch!r} not supported "
                                  f"(reference parity set: {sorted(ARCH_SPECS)})")
    spec = ARCH_SPECS[arch]
    p = arch  # key prefix
    dim = int(_get(md, f"{p}.embedding_length", required=True))
    n_heads = int(_get(md, f"{p}.attention.head_count",
                       required=(arch != "mamba")) or 1)
    n_kv = int(_get(md, f"{p}.attention.head_count_kv", n_heads) or n_heads)
    n_layers = int(_get(md, f"{p}.block_count", required=True))
    head_dim_kv = int(_get(md, f"{p}.attention.key_length", 0))
    head_dim = head_dim_kv if head_dim_kv else dim // max(n_heads, 1)
    n_rot = int(_get(md, f"{p}.rope.dimension_count", head_dim))
    n_ctx_train = int(_get(md, f"{p}.context_length", 2048))

    # rope scaling (llm_load_hparams rope section)
    scaling_type = _get(md, f"{p}.rope.scaling.type", "linear")
    factor = float(_get(md, f"{p}.rope.scaling.factor",
                        _get(md, f"{p}.rope.scale_linear", 1.0)))
    freq_scale = 1.0 / factor if factor not in (0.0, 1.0) else 1.0
    ext_factor = 1.0 if scaling_type == "yarn" else 0.0
    n_orig_ctx = int(_get(md, f"{p}.rope.scaling.original_context_length",
                          n_ctx_train))

    vocab = _get(md, f"{p}.vocab_size")
    if vocab is None:
        toks = _get(md, "tokenizer.ggml.tokens")
        vocab = len(toks) if toks is not None else 32000

    # per-arch scale constants (build_minicpm llama.cpp:7822-7955,
    # build_gemma :7961; baichuan-13B alibi :6012 via hparams :3395)
    emb_scale, res_scale, logit_scale = 1.0, 1.0, 1.0
    if arch == "minicpm":
        emb_scale = 12.0
        res_scale = 1.4 / math.sqrt(n_layers)
        logit_scale = 256.0 / dim
    elif arch == "gemma":
        emb_scale = math.sqrt(dim)

    alibi = float(spec.get("alibi", 0.0))
    if arch == "mpt":
        alibi = float(_get(md, f"{p}.attention.max_alibi_bias", 8.0))
    elif arch == "baichuan" and n_layers == 40:  # 13B (llama.cpp:3394-3397)
        alibi = 8.0

    causal = bool(_get(md, f"{p}.attention.causal", spec.get("causal", True)))
    pooling = _get(md, f"{p}.pooling_type", 0)
    pooling = _POOLING_NAMES.get(int(pooling), "none") \
        if not isinstance(pooling, str) else pooling
    if arch in ("bert", "nomic-bert") and pooling == "none":
        pooling = "mean"

    return ModelConfig(
        arch=arch,
        vocab_size=int(vocab),
        dim=dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        ffn_dim=int(_get(md, f"{p}.feed_forward_length", 4 * dim) or 4 * dim),
        n_ctx_train=n_ctx_train,
        norm_eps=float(_get(md, f"{p}.attention.layer_norm_rms_epsilon",
                            _get(md, f"{p}.attention.layer_norm_epsilon",
                                 1e-5))),
        rope=RopeParams(
            n_rot=n_rot,
            kind=spec["rope"],
            freq_base=float(_get(md, f"{p}.rope.freq_base", 10000.0)),
            freq_scale=freq_scale,
            ext_factor=ext_factor,
            n_orig_ctx=n_orig_ctx,
        ),
        n_expert=int(_get(md, f"{p}.expert_count", 0) or 0),
        n_expert_used=int(_get(md, f"{p}.expert_used_count", 0) or 0),
        norm_type=spec["norm"],
        # gptneox models carry the flag in metadata (HF use_parallel_residual;
        # sequential variants like pythia-*-deduped set it false)
        parallel_residual=bool(_get(md, f"{p}.use_parallel_residual",
                                    spec.get("parallel_residual", False))),
        post_norm=spec.get("post_norm", False),
        ffn_act=spec["act"],
        pos_emb=spec.get("pos_emb", False),
        tok_norm=spec.get("tok_norm", False),
        causal=causal,
        pooling=pooling,
        qk_norm=spec.get("qk_norm", False),
        max_alibi_bias=alibi,
        clamp_kqv=float(_get(md, f"{p}.attention.clamp_kqv", 0.0) or 0.0),
        emb_scale=emb_scale,
        res_scale=res_scale,
        logit_scale=logit_scale,
        head_dim_kv=head_dim_kv,
        ssm_d_conv=int(_get(md, f"{p}.ssm.conv_kernel", 0) or 0),
        ssm_d_inner=int(_get(md, f"{p}.ssm.inner_size", 0) or 0),
        ssm_d_state=int(_get(md, f"{p}.ssm.state_size", 0) or 0),
        ssm_dt_rank=int(_get(md, f"{p}.ssm.time_step_rank", 0) or 0),
    )
