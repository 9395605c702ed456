"""The port's generic forward against the JAX one for every attention
architecture the JAX package runs (mamba: tests/test_torch_mamba.py).

- forward parity: the tiny HF models of tests/test_archs_forward.py
  (converted by the JAX convert_hf at F32) and its 8 synthetic
  architectures, each loaded by both loaders; the port's logits (or
  bert's hidden states) within 1e-5 of max|ref| of the JAX forward's at
  f32 compute (the same weights; products and sums in another order).
- engines: a tiling Q4_0 MoE model and a parallel-residual (falcon MQA)
  model through both Engines at f32 compute: generate_fast's greedy
  tokens, n_past and the cell positions equal; bert's embedding through
  Engine.embed within 1e-5, and its non-causal input past n_ubatch raises
  as the JAX engine's does.
- the Q4_0 models of tools.synth.FAMILIES (and nomic-bert's) and the MoE
  one through both loaders and forwards, within the same 1e-5; the JAX
  params carried by params_from_numpy (expert lists included) give the
  port loader's forward exactly.
- gates: for every family of tools.synth.FAMILIES and the MoE model, the
  megakernel gate (build_mega) and the ffn_fused gate choose what the
  JAX gates choose; QKV is not fused under qk-norm (persimmon), as in the
  JAX engine; unsupported_features refuses no architecture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("transformers")
import transformers  # noqa: E402

from tpulamm.gguf.constants import GGMLType  # noqa: E402
from tpulamm.models import loader as jloader  # noqa: E402
from tpulamm.models.transformer import forward as jforward  # noqa: E402
from tpulamm.runtime.engine import Engine as JEngine  # noqa: E402
from tpulamm.runtime.kvcache import KVCache as JKVCache  # noqa: E402
from tpulamm.tools import convert_hf as CH  # noqa: E402
from tpulamm_torch.models import loader as tloader  # noqa: E402
from tpulamm_torch.models.config import ARCH_SPECS, ModelConfig  # noqa: E402
from tpulamm_torch.models.transformer import (forward as tforward,  # noqa: E402
                                              unsupported_features)
from tpulamm_torch.runtime.engine import Engine  # noqa: E402
from tpulamm_torch.runtime.kvcache import KVCache  # noqa: E402
from tpulamm_torch.tools.synth import (FAMILIES, write_family_gguf,  # noqa: E402
                                       write_mixtral_gguf)

TOKENS = np.array([[1, 5, 42, 7, 99, 3, 200, 17, 8, 61]], dtype=np.int64)
V = 256
TOL = 1e-5          # of max|ref|, f32 compute

# the HF models of tests/test_archs_forward.py: (class, config kwargs)
HF_MODELS = {
    "mixtral": ("MixtralForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-5)),
    "qwen2": ("Qwen2ForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5)),
    "gpt2": ("GPT2LMHeadModel", dict(
        vocab_size=V, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        activation_function="gelu_new")),
    "gptj": ("GPTJForCausalLM", dict(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
        n_positions=128)),
    "gptneox_parallel": ("GPTNeoXForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, rotary_pct=0.5,
        max_position_embeddings=128, use_parallel_residual=True)),
    "gptneox_sequential": ("GPTNeoXForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, rotary_pct=0.25,
        max_position_embeddings=128, use_parallel_residual=False)),
    "falcon": ("FalconForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, bias=False, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, alibi=False,
        layer_norm_epsilon=1e-5)),
    "falcon_40b_style_gqa": ("FalconForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_kv_heads=2, bias=False,
        multi_query=False, new_decoder_architecture=True,
        parallel_attn=True, alibi=False, layer_norm_epsilon=1e-5)),
    "starcoder_gptbigcode": ("GPTBigCodeForCausalLM", dict(
        vocab_size=V, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        multi_query=True, activation_function="gelu_pytorch_tanh")),
    "bloom_alibi": ("BloomForCausalLM", dict(
        vocab_size=V, hidden_size=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-5)),
    "mpt_alibi": ("MptForCausalLM", dict(
        vocab_size=V, d_model=64, n_layers=2, n_heads=4, max_seq_len=64)),
    "phi2_parallel_residual": ("PhiForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        partial_rotary_factor=0.5, hidden_act="gelu_new",
        layer_norm_eps=1e-5, max_position_embeddings=64)),
    "stablelm_partial_rope": ("StableLmForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.25, layer_norm_eps=1e-5,
        use_parallel_residual=False, use_qkv_bias=False,
        max_position_embeddings=64)),
    "starcoder2": ("Starcoder2ForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        hidden_act="gelu_pytorch_tanh", norm_epsilon=1e-5, use_bias=True,
        max_position_embeddings=64, layer_norm_epsilon=1e-5)),
    "gemma_head_dim_and_scales": ("GemmaForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, hidden_act="gelu_pytorch_tanh", rms_norm_eps=1e-5,
        max_position_embeddings=64)),
    "persimmon_qk_norm": ("PersimmonForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        partial_rotary_factor=0.5, hidden_act="relu2", qk_layernorm=True,
        layer_norm_eps=1e-5, max_position_embeddings=64)),
    "bert_embeddings": ("BertModel", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, hidden_act="gelu_new",
        max_position_embeddings=64, add_pooling_layer=False)),
}

# tests/test_archs_forward.py's synthetic architectures (arch, norm biases)
SYNTHETIC = {"baichuan": False, "internlm2": False, "orion": True,
             "minicpm": False, "plamo": False, "qwen": False,
             "refact": False, "codeshell": True}


def _hf_gguf(name: str, path: str) -> str:
    cls_name, kw = HF_MODELS[name]
    torch.manual_seed(0)
    cls = getattr(transformers, cls_name)
    model = cls(cls.config_class(**kw))
    model.eval()
    CH.convert_hf(model, path, qtype=GGMLType.F32)
    return path


def _synthetic_gguf(path: str, arch: str, norm_biases: bool) -> str:
    """test_archs_forward.py's synthetic model of `arch`, F32."""
    from tpulamm.gguf.writer import GGUFWriter
    dim, heads, ffn = 64, 4, 96
    kvs = {"embedding_length": dim, "block_count": 2,
           "feed_forward_length": ffn, "context_length": 64,
           "vocab_size": V, "attention.head_count": heads,
           "attention.head_count_kv": heads,
           "attention.layer_norm_rms_epsilon": 1e-5,
           "attention.layer_norm_epsilon": 1e-5}
    layer = {"attn_norm.weight": (dim,), "ffn_norm.weight": (dim,),
             "attn_output.weight": (dim, dim), "ffn_gate.weight": (ffn, dim),
             "ffn_up.weight": (ffn, dim), "ffn_down.weight": (dim, ffn)}
    if arch in ("qwen", "codeshell"):
        layer["attn_qkv.weight"] = (3 * dim, dim)
        layer["attn_qkv.bias"] = (3 * dim,)
    else:
        for t in ("q", "k", "v"):
            layer[f"attn_{t}.weight"] = (dim, dim)
    if arch == "plamo":
        del layer["ffn_norm.weight"]
    if norm_biases:
        layer["attn_norm.bias"] = (dim,)
        if "ffn_norm.weight" in layer:
            layer["ffn_norm.bias"] = (dim,)
    top = {"token_embd.weight": (V, dim), "output_norm.weight": (dim,),
           "output.weight": (V, dim)}
    if arch == "minicpm":
        del top["output.weight"]            # tied lm head
    if norm_biases:
        top["output_norm.bias"] = (dim,)
    rng = np.random.default_rng(0)
    w = GGUFWriter(path)
    w.add_kv("general.architecture", arch)
    for k, v in kvs.items():
        w.add_kv(f"{arch}.{k}", v)
    for name, shape in top.items():
        w.add_tensor(name, (rng.normal(size=shape) * 0.05).astype(np.float32))
    for i in range(2):
        for name, shape in layer.items():
            x = (rng.normal(size=shape) * 0.05).astype(np.float32)
            if "norm" in name:
                x = 1.0 + 0.1 * x
            w.add_tensor(f"blk.{i}.{name}", x)
    w.write()
    return path


def _jax_forward(path: str) -> np.ndarray:
    cfg, params, _ = jloader.load_model(path, compute_dtype="float32")
    B, T = TOKENS.shape
    cache = JKVCache.create(cfg.n_layers, B, T + 4, cfg.n_kv_heads,
                            cfg.head_dim, dtype=jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    out, _ = jforward(params, cfg, jnp.asarray(TOKENS, jnp.int32), pos,
                      cache, jnp.arange(B, dtype=jnp.int32), pos)
    return np.asarray(out)


def _port_forward(path: str) -> np.ndarray:
    cfg, params, _ = tloader.load_model(path, compute_dtype="float32",
                                        device="cpu")
    B, T = TOKENS.shape
    cache = KVCache.create(cfg.n_layers, B, T + 4, cfg.n_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    with torch.no_grad():
        out, _ = tforward(params, cfg, torch.from_numpy(TOKENS), pos, cache,
                          None, pos)
    return out.numpy()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: many tiny ops under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(HF_MODELS) + sorted(SYNTHETIC))
def test_forward_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.gguf")
    if name in HF_MODELS:
        _hf_gguf(name, path)
    else:
        _synthetic_gguf(path, name, SYNTHETIC[name])
    want = _jax_forward(path)
    got = _port_forward(path)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"{name}: {err:.3e} of max|ref|"


# -- engines ----------------------------------------------------------------
MOE = dict(dim=256, ffn=512, n_head=4, n_kv=2, vocab=512, n_expert=4,
           n_expert_used=2, n_ctx_train=512, freq_base=1e6)
N_CTX = 96


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Small tiling Q4_0 models: the MoE one and each synth family."""
    d = tmp_path_factory.mktemp("archs")
    out = {"moe": str(d / "moe.gguf")}
    write_mixtral_gguf(out["moe"], 2, np.random.default_rng(21), **MOE)
    for i, arch in enumerate(FAMILIES):
        out[arch] = str(d / f"{arch}.gguf")
        write_family_gguf(out[arch], arch, np.random.default_rng(30 + i),
                          dim=256, ffn=512, vocab=512, n_ctx_train=256)
    return out


@pytest.mark.parametrize("name", ["moe"] + list(FAMILIES))
def test_family_forward_matches_jax(models, name):
    """The Q4_0 models of tools.synth (the ones chip_smoke.py's phase 10
    runs at larger widths) through both loaders and forwards, f32 compute:
    every family's tensor map and axes, nomic-bert's too."""
    path = models[name]
    want = _jax_forward(path)
    got = _port_forward(path)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"{name}: {err:.3e} of max|ref|"


@pytest.mark.parametrize("arch", ["gpt2", "bert"])
def test_learned_positions_past_the_table(tmp_path, arch):
    """Positions past a learned position table (n_ctx above n_ctx_train)
    take its last row, as the JAX gather clamps, instead of raising."""
    path = str(tmp_path / f"{arch}.gguf")
    write_family_gguf(path, arch, np.random.default_rng(7), dim=256,
                      ffn=512, vocab=512, n_ctx_train=8)
    B, T = TOKENS.shape
    start = 4                     # positions 4..13 of an 8-row table
    cfg, jparams, _ = jloader.load_model(path, compute_dtype="float32")
    assert jparams["pos_emb"].shape[0] < start + T
    cache = JKVCache.create(cfg.n_layers, B, start + T, cfg.n_kv_heads,
                            cfg.head_dim, dtype=jnp.float32)
    jpos = jnp.broadcast_to(jnp.arange(start, start + T, dtype=jnp.int32),
                            (B, T))
    want = np.asarray(jforward(jparams, cfg, jnp.asarray(TOKENS, jnp.int32),
                               jpos, cache, jnp.arange(B, dtype=jnp.int32),
                               jpos)[0])
    tcfg, params, _ = tloader.load_model(path, compute_dtype="float32",
                                         device="cpu")
    cache = KVCache.create(tcfg.n_layers, B, start + T, tcfg.n_kv_heads,
                           tcfg.head_dim, dtype=torch.float32)
    pos = torch.arange(start, start + T, dtype=torch.int32).expand(B, T)
    with torch.no_grad():
        got = tforward(params, tcfg, torch.from_numpy(TOKENS), pos, cache,
                       None, pos)[0].numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"{arch}: {err:.3e} of max|ref|"


@pytest.mark.parametrize("name", ["moe", "persimmon", "bert"])
def test_params_from_numpy_carries_new_keys(models, name):
    """The JAX loader's params (expert lists, q/k norms, positions, token
    types) carried across by params_from_numpy give the port's loader's
    forward exactly."""
    from tpulamm_torch.ops.qtensor import QTensor
    path = models[name]
    _, jparams, _ = jloader.load_model(path, compute_dtype="float32")
    cfg, params, _ = tloader.load_model(path, compute_dtype="float32",
                                        device="cpu")
    carried = tloader.params_from_numpy(jparams, cfg, "cpu")
    assert sorted(carried["layers"][0]) == sorted(params["layers"][0])
    assert sorted(carried) == sorted(params)
    if name == "moe":
        assert all(isinstance(w, QTensor)
                   for w in carried["layers"][0]["ffn_up_exp"])
    B, T = TOKENS.shape
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    outs = []
    for p in (params, carried):
        cache = KVCache.create(cfg.n_layers, B, T + 4, cfg.n_kv_heads,
                               cfg.head_dim, dtype=torch.float32)
        with torch.no_grad():
            outs.append(tforward(p, cfg, torch.from_numpy(TOKENS), pos,
                                 cache, None, pos)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name,n_predict", [("moe", 20), ("falcon", 20),
                                            ("persimmon", 5)])
def test_engines_agree(models, name, n_predict):
    """generate_fast through both engines at f32 compute: the same greedy
    tokens, n_past and host cell positions."""
    path = models[name]
    je = JEngine(path, n_ctx=N_CTX, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=N_CTX, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(7).integers(3, 500, size=40).tolist()
    want, _ = je.generate_fast(prompt, n_predict=n_predict,
                               stop_on_eos=False)
    got, _ = te.generate_fast(prompt, n_predict=n_predict, stop_on_eos=False)
    assert got == want
    assert np.array_equal(te.n_past, np.asarray(je.n_past))
    assert np.array_equal(te.cell_pos, np.asarray(je.cell_pos))
    if name == "moe":
        # every expert product tiles: the MoE path runs through qmatmul
        from tpulamm_torch.ops.qtensor import QTensor
        lyr = te.params["layers"][0]
        assert all(isinstance(w, QTensor) for part in ("gate", "down", "up")
                   for w in lyr[f"ffn_{part}_exp"])
        assert "wqkv_fused" in lyr and not isinstance(lyr["ffn_gate_inp"],
                                                      QTensor)


def test_bert_embed_matches_jax(models):
    """bert (post-norm, non-causal, learned positions, token types,
    embedding norm) through Engine.embed with its mean pooling."""
    path = models["bert"]
    je = JEngine(path, n_ctx=N_CTX, n_ubatch=64, compute_dtype="float32",
                 kv_dtype=jnp.float32)
    te = Engine(path, n_ctx=N_CTX, n_ubatch=64, compute_dtype="float32",
                kv_dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(8).integers(5, 500, size=48).tolist()
    for pooling in (None, "cls", "none"):
        want = np.asarray(je.embed(toks, pooling=pooling))
        got = te.embed(toks, pooling=pooling)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    text = "the quick brown fox"
    assert te.tokenizer.encode(text) == je.tokenizer.encode(text)
    for eng in (je, te):
        with pytest.raises(ValueError, match="non-causal"):
            eng.embed(list(range(5, 70)))


def _ffn_gate(layer, cfg, m: int, eligible) -> bool:
    """The forward's ffn_fused gate, given the flag and the device."""
    return (layer.get("wgateup_fused") is not None
            and eligible(layer["wgateup_fused"], layer["w_down"], m)
            and cfg.ffn_act in ("silu", "gelu"))


@pytest.mark.parametrize("name", ["moe"] + list(FAMILIES))
def test_gates_match_jax(models, name):
    """build_mega and the ffn_fused gate choose as the JAX gates do
    (pallas_decode.py:528-545; transformer.py:377-394)."""
    from tpulamm.ops.pallas_ffn import ffn_fused_eligible as jelig
    from tpulamm_torch.ops.ffn_fused import ffn_fused_eligible as telig
    path = models[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULAMM_MEGAKERNEL", "1")
        je = JEngine(path, n_ctx=N_CTX, compute_dtype="float32")
    te = Engine(path, n_ctx=N_CTX, compute_dtype="float32", megakernel=True,
                device="cpu")
    assert (te.mega is None) == (je.mega is None)
    assert te.mega is None      # each departs from the llama topology
    for jl, tl in zip(je.params["layers"], te.params["layers"]):
        assert sorted(jl) == sorted(tl)
        for m in (1, 8, 16, 17):
            assert (_ffn_gate(tl, te.cfg, m, telig)
                    == _ffn_gate(jl, je.cfg, m, jelig))


def test_qkv_not_fused_under_qk_norm(models):
    """The JAX engine fuses QKV only without qk-norm (engine.py:399):
    persimmon normalizes q and k apart, so its wq / wk / wv stay."""
    te = Engine(models["persimmon"], n_ctx=N_CTX, device="cpu")
    je = JEngine(models["persimmon"], n_ctx=N_CTX)
    for lyr in (te.params["layers"][0], je.params["layers"][0]):
        assert "wqkv_fused" not in lyr and "wq" in lyr
    lyr = Engine(models["gpt2"], n_ctx=N_CTX, device="cpu").params["layers"][0]
    assert "wqkv_fused" in lyr and "bqkv_fused" in lyr


def test_unsupported_features_only_mamba():
    """Since mamba came (models/mamba.py), no architecture is refused."""
    for arch in ARCH_SPECS:
        cfg = ModelConfig(arch=arch)
        assert unsupported_features(cfg) == []
    flags = ModelConfig(post_norm=True, parallel_residual=True, pos_emb=True,
                        tok_norm=True, qk_norm=True, max_alibi_bias=8.0,
                        clamp_kqv=6.0, n_expert=8, causal=False,
                        ffn_act="relu_sqr")
    assert unsupported_features(flags) == []
