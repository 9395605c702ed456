"""Port parity for tools/convert_hf.py: the port's converter writes GGUF
files equal byte for byte to the JAX converter's.

Cases: the small random transformers models of tests/test_torch_archs.py
(every family convert_hf dispatches but llama and mamba) and a llama and a
mamba model, each at F32 and Q4_0 (the port quantizes with its own codec,
the JAX converter with its own: equal for Q4_0); convert_hf_llama from a
numpy state dict with an attribute config (the make_bench_model path,
with a vocab); convert_hf_clip with and without skip_last and a
projector; convert_hf from a state dict and a SimpleNamespace config;
vocab_from_hf on a WordPiece and a byte-level BPE tokenizer. Tolerance:
equal bytes, equal dicts.
"""

import filecmp
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
import transformers  # noqa: E402

from test_torch_archs import HF_MODELS  # noqa: E402
from tpulamm.gguf.constants import GGMLType  # noqa: E402
from tpulamm.tools import convert_hf as JCH  # noqa: E402
from tpulamm.tools.make_bench_model import (make_llama_sd,  # noqa: E402
                                            make_spm_vocab)
from tpulamm_torch.gguf.constants import GGMLType as TGGMLType  # noqa: E402
from tpulamm_torch.tools import convert_hf as CH  # noqa: E402

EXTRA = {
    "llama": ("LlamaForCausalLM", dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64)),
    "mamba": ("MambaForCausalLM", dict(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, state_size=8,
        conv_kernel=4, expand=2, time_step_rank=8, use_cache=False)),
}
MODELS = {**HF_MODELS, **EXTRA}


def _model(name):
    cls_name, kw = MODELS[name]
    torch.manual_seed(0)
    cls = getattr(transformers, cls_name)
    return cls(cls.config_class(**kw)).eval()


def _same(tmp_path, write_jax, write_port) -> None:
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    write_jax(a)
    write_port(b)
    assert filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("qtype", ["F32", "Q4_0"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_convert_hf_bytes_equal(tmp_path, name, qtype):
    m = _model(name)
    assert m.config.model_type in CH.CONVERTERS
    _same(tmp_path,
          lambda p: JCH.convert_hf(m, p, qtype=getattr(GGMLType, qtype)),
          lambda p: CH.convert_hf(m, p, qtype=getattr(TGGMLType, qtype)))


def test_state_dict_with_attribute_config(tmp_path):
    """No transformers model: a numpy state dict and a SimpleNamespace
    config, through convert_hf_llama (with a vocab) and convert_hf."""
    sd, cfg = make_llama_sd(dim=256, n_ff=512, n_layers=2, n_head=4, n_kv=2,
                            n_vocab=300, seed=3)
    voc = make_spm_vocab(300)
    _same(tmp_path,
          lambda p: JCH.convert_hf_llama(sd, cfg, p, qtype=GGMLType.Q4_0,
                                         vocab=voc),
          lambda p: CH.convert_hf_llama(sd, cfg, p, qtype=TGGMLType.Q4_0,
                                        vocab=voc))
    m = _model("mamba")
    ns = SimpleNamespace(**m.config.to_dict())
    sd = {k: v.float().numpy() for k, v in m.state_dict().items()}
    _same(tmp_path, lambda p: JCH.convert_hf(m, p),
          lambda p: CH.convert_hf(sd, p, config=ns))


@pytest.mark.parametrize("skip_last, proj", [(0, False), (1, True)])
def test_convert_hf_clip_bytes_equal(tmp_path, skip_last, proj):
    torch.manual_seed(3)
    hf = transformers.CLIPVisionConfig(
        hidden_size=64, num_attention_heads=2, num_hidden_layers=3,
        intermediate_size=128, image_size=32, patch_size=8,
        hidden_act="quick_gelu", layer_norm_eps=1e-5)
    vision = transformers.CLIPVisionModel(hf).eval()
    sd = {k: v.float().numpy() for k, v in vision.state_dict().items()}
    rng = np.random.default_rng(0)
    proj_sd = ({f"multi_modal_projector.linear_{i}.{p}": rng.standard_normal(
        (48, 64 if i == 1 else 48) if p == "weight" else 48).astype(
            np.float32) for i in (1, 2) for p in ("weight", "bias")}
        if proj else None)
    _same(tmp_path,
          lambda p: JCH.convert_hf_clip(sd, hf, p, proj_sd=proj_sd,
                                        skip_last=skip_last),
          lambda p: CH.convert_hf_clip(sd, hf, p, proj_sd=proj_sd,
                                       skip_last=skip_last))


def test_vocab_from_hf_equal(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat", "##s", "sat"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    bert = transformers.BertTokenizer(str(tmp_path / "vocab.txt"))
    enc = {"a": 0, "b": 1, "ab": 2, "Ġ": 3, "Ġab": 4, "<|endoftext|>": 5}
    (tmp_path / "vocab.json").write_text(json.dumps(enc))
    (tmp_path / "merges.txt").write_text("#version: 0.2\na b\nĠ ab\n")
    gpt2 = transformers.GPT2Tokenizer(str(tmp_path / "vocab.json"),
                                      str(tmp_path / "merges.txt"))
    for tok in (bert, gpt2):
        assert CH.vocab_from_hf(tok) == JCH.vocab_from_hf(tok)
