"""The port's BPE and WPM tokenizers against the JAX ones.

The vocabularies of tests/test_tokenizer_bpe_wpm.py (byte units and
merges; WordPiece words in GGUF form) and the synthetic ones of
tpulamm_torch.tools.synth feed both packages; ids must be equal on that
file's sentences, on hypothesis strings mixing letters, marks, digits,
CJK, emoji, every whitespace kind and apostrophes, and through
build_tokenizer from GGUF metadata. The port's GPT-2 pre-tokenizer (a
scanner, no `regex`) splits as the JAX package's `regex` pattern does.
Decoding the BPE ids gives the text back.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpulamm.tokenizer import bpe as jbpe
from tpulamm.tokenizer import spm as jspm
from tpulamm.tokenizer import wpm as jwpm
from tpulamm_torch.tokenizer import bpe as tbpe
from tpulamm_torch.tokenizer import spm as tspm
from tpulamm_torch.tokenizer import wpm as twpm
from tpulamm_torch.tools.synth import bpe_vocab, wpm_vocab

SENTENCES = [
    "Hello world!",
    "  leading spaces and   runs",
    "The 1234 numbers, punct!!! and CamelCase.",
    "don't you've we'll it's",
    "tab\tand\nnewline",
    "unicode: café naïve 北京 🚀",
    "",
    " ",
]
WPM_TEXTS = ["hello world", "the quick brown foxs", "unbelievable",
             "Hello, World!", "numbers 123 and punct?!", "北京 cafe",
             "HELLO THE WORLD", "ß", "aß"]

MERGES = ["h e", "l l", "he ll", "hell o", "Ġ w", "Ġw o", "Ġwo r",
          "Ġwor l", "Ġworl d", "t h", "th e", "Ġ t", "Ġt he", "a n",
          "an d", "i n", "in g", "o u", "Ġ a", "1 2", "12 3", "e r",
          "' s", "n 't", "Ġ n"]
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world",
         "the", "quick", "brown", "fox", "##s", "##ing", "##ed", "un",
         "##believ", "##able", "number", "##1", "##2", "##3", "1", "2", "3",
         ",", ".", "!", "?", "北", "京", "cafe", "naive"] + [
    chr(c) for c in range(ord("a"), ord("z") + 1)] + [
    "##" + chr(c) for c in range(ord("a"), ord("z") + 1)]


def _pair(mod_j, mod_t, cls, **kw):
    return (getattr(mod_j, cls)(jspm.Vocab(**kw)),
            getattr(mod_t, cls)(tspm.Vocab(**kw)))


@pytest.fixture(scope="module")
def bpe():
    tokens = list(jbpe.bytes_to_unicode().values()) + [
        m.replace(" ", "") for m in MERGES]
    return _pair(jbpe, tbpe, "BPETokenizer", tokens=tokens,
                 scores=[0.0] * len(tokens), token_types=[1] * len(tokens),
                 bos_id=-1, eos_id=-1, unk_id=0, add_bos=False,
                 model="gpt2", merges=list(MERGES))


@pytest.fixture(scope="module")
def wpm():
    toks, types = [], []
    for w in WORDS:
        if w.startswith("["):
            toks.append(w)
            types.append(3)
        else:
            toks.append(w[2:] if w.startswith("##") else "▁" + w)
            types.append(1)
    return _pair(jwpm, twpm, "WPMTokenizer", tokens=toks,
                 scores=[0.0] * len(toks), token_types=types, bos_id=2,
                 eos_id=3, unk_id=1, add_bos=True, model="bert")


def _md(voc: dict) -> dict:
    md = {"tokenizer.ggml.model": voc["model"],
          "tokenizer.ggml.tokens": voc["tokens"],
          "tokenizer.ggml.token_type": voc["token_type"],
          "tokenizer.ggml.bos_token_id": voc["bos"],
          "tokenizer.ggml.eos_token_id": voc["eos"]}
    if voc.get("merges"):
        md["tokenizer.ggml.merges"] = voc["merges"]
    if "unk" in voc:
        md["tokenizer.ggml.unknown_token_id"] = voc["unk"]
    return md


@pytest.fixture(scope="module")
def synth():
    """(JAX, port) tokenizers of the synthetic BPE and WPM vocabularies,
    built from GGUF metadata by each package's build_tokenizer."""
    out = {}
    for name, voc in (("bpe", bpe_vocab(1024)), ("wpm", wpm_vocab(1024))):
        md = _md(voc)
        out[name] = (jspm.build_tokenizer(md), tspm.build_tokenizer(md))
    assert type(out["bpe"][1]) is tbpe.BPETokenizer
    assert type(out["wpm"][1]) is twpm.WPMTokenizer
    return out


@pytest.mark.parametrize("text", SENTENCES)
def test_bpe_ids_match_jax(bpe, synth, text):
    for j, t in (bpe, synth["bpe"]):
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.encode(text)) == text


@pytest.mark.parametrize("text", SENTENCES + WPM_TEXTS)
def test_wpm_ids_match_jax(wpm, synth, text):
    for j, t in (wpm, synth["wpm"]):
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == j.decode(ids)


def test_special_tokens_partition(synth):
    for j, t in synth.values():
        text = "hello<|endoftext|>world [SEP] the"
        assert t.encode(text, special=True) == j.encode(text, special=True)


# letters, marks, digits, CJK, emoji, every whitespace kind, apostrophes;
# code points assigned in Python's Unicode database (see bpe.py)
_CHARS = st.one_of(
    st.characters(categories=["Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc",
                              "Nd", "Nl", "No", "Po", "Ps", "Sm", "So"]),
    st.characters(min_codepoint=0x4E00, max_codepoint=0x9FFF),
    st.characters(min_codepoint=0x1F300, max_codepoint=0x1FAFF),
    st.sampled_from(sorted(tbpe._WHITESPACE) + ["\x1c", "\u200b"]),
    st.sampled_from(["'", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d",
                     "’", " ", "  ", "a", "1"]),
)
_TEXTS = st.lists(_CHARS, max_size=24).map("".join)


@settings(max_examples=300, deadline=None)
@given(text=_TEXTS)
def test_mixed_unicode_matches_jax(bpe, wpm, synth, text):
    assert tbpe.gpt2_pretokenize(text) == jbpe._GPT2_PAT.findall(text)
    for j, t in (bpe, synth["bpe"]):
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == text
    for j, t in (wpm, synth["wpm"]):
        assert t.encode(text) == j.encode(text)
