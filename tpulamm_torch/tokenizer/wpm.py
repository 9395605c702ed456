"""WordPiece (BERT) tokenizer over GGUF vocab metadata (counterpart of
tpulamm.tokenizer.wpm).

Behavior-compatible with llm_tokenizer_wpm (llama.cpp:9911-10010):
normalization = NFD, drop accent marks and control chars, lowercase,
uniformize whitespace, pad punctuation and CJK chars with spaces; then per
whitespace word, prepend the phantom space (U+2581) and greedily take the
longest vocab prefix, skipping unknown characters; a word with no match at
all yields UNK. encode() appends SEP (eos) as the reference does, and
prepends CLS (bos) like llama_tokenize_internal's WPM branch.
"""

from __future__ import annotations

import unicodedata

from tpulamm_torch.tokenizer.spm import Vocab, partition_specials

_SPACE_ESC = "▁"


def _is_chinese_char(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B920 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab.tokens)}
        self.special = [(t, i) for i, t in enumerate(vocab.tokens)
                        if vocab.token_types[i] in (3, 4) and t]
        self.special.sort(key=lambda x: -len(x[0]))

    # -- public API ----------------------------------------------------------
    def encode(self, text: str, add_bos: bool | None = None,
               special: bool = False) -> list[int]:
        out: list[int] = []
        if add_bos is None:
            add_bos = self.vocab.add_bos
        if add_bos and self.vocab.bos_id >= 0:
            out.append(self.vocab.bos_id)          # [CLS]
        fragments = (partition_specials(text, self.special)
                     if special else [("raw", text)])
        for kind, frag in fragments:
            if kind == "tok":
                out.append(frag)
            else:
                self._wpm_encode(frag, out)
        if self.vocab.eos_id >= 0:
            out.append(self.vocab.eos_id)          # [SEP]
        return out

    def token_to_piece(self, tid: int, special: bool = False) -> str:
        v = self.vocab
        t = v.tokens[tid]
        if v.token_types[tid] in (3, 2):
            return t if special else ""
        return t.replace(_SPACE_ESC, " ")

    def token_bytes(self, tid: int) -> bytes:
        return self.token_to_piece(tid).encode("utf-8")

    def decode(self, ids: list[int], special: bool = False) -> str:
        return "".join(self.token_to_piece(t, special) for t in ids)

    # -- internals ------------------------------------------------------------
    def _preprocess(self, text: str) -> list[str]:
        out = []
        for ch in unicodedata.normalize("NFD", text):
            cat = unicodedata.category(ch)
            if cat in ("Mn", "Cc", "Cf"):          # accents / control
                continue
            ch = ch.lower()
            if cat.startswith("Z") or ch in " \t\n\r":
                out.append(" ")
                continue
            cp = ord(ch)
            if cat.startswith("P") or (cp < 256 and not ch.isalnum()
                                       and not ch.isspace()) \
                    or _is_chinese_char(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out).split()

    def _wpm_encode(self, text: str, out: list[int]) -> None:
        for word in self._preprocess(text):
            w = _SPACE_ESC + word
            n = len(w)
            i = 0
            match_any = False
            while i < n:
                matched = False
                for j in range(n, i, -1):
                    tid = self.token_to_id.get(w[i:j])
                    if tid is not None:
                        out.append(tid)
                        matched = True
                        match_any = True
                        i = j
                        break
                if not matched:
                    i += 1                          # skip unknown char
            if not match_any:
                out.append(self.vocab.unk_id)
