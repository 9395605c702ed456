r"""GPT-2 style byte-level BPE tokenizer over GGUF vocab + merges
(counterpart of tpulamm.tokenizer.bpe).

Behavior-compatible with llm_tokenizer_bpe (llama.cpp:9632-9762): words from
GPT-2 pre-tokenization (bpe_gpt2_preprocess :9764), bytes mapped into the
visible-unicode space (unicode_byte_to_utf8 tables), then adjacent symbols
merged by lowest merge rank (llm_bigram_bpe queue; ties broken leftmost).
Token pieces decode back through the byte map (llama_token_to_piece BPE
branch, llama.cpp:14084).

The pre-tokenizer splits exactly as the GPT-2 pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+

does, without the `regex` package: a scanner over unicodedata's general
categories (L*, N*) and the White_Space set that `\s` matches.
"""

from __future__ import annotations

import heapq
import unicodedata

from tpulamm_torch.tokenizer.spm import (TOKEN_TYPE_CONTROL,
                                         TOKEN_TYPE_UNKNOWN, Vocab,
                                         partition_specials)

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the White_Space property: what the pattern's \s matches
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def _kind(ch: str) -> str:
    """"S" whitespace, "L" letter, "N" number, "O" anything else."""
    if ch in _WHITESPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def gpt2_pretokenize(text: str) -> list[str]:
    """The words the GPT-2 pattern finds in text, in order. At each
    position the pattern's alternatives are tried in turn: a contraction;
    an optional space then a run of one kind (letters, numbers, or
    others); a whitespace run that leaves its last character when a
    non-space follows; else a single whitespace character."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out: list[str] = []
    i = 0
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if c is not None:
                out.append(c)
                i += len(c)
                continue
        j = i + 1 if (text[i] == " " and i + 1 < n
                      and kinds[i + 1] != "S") else i
        k = kinds[j]
        e = j + 1
        while e < n and kinds[e] == k:
            e += 1
        if k == "S" and e < n and e - i > 1:
            e -= 1                     # \s+(?!\S): leave one before a word
        out.append(text[i:e])
        i = e
    return out


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte -> visible unicode char map (unicode_byte_to_utf8)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab.tokens)}
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(vocab.merges):
            l, _, r = m.partition(" ")
            self.ranks[(l, r)] = i
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
            out.append(self.vocab.bos_id)
        fragments = (partition_specials(text, self.special)
                     if special else [("raw", text)])
        for kind, frag in fragments:
            if kind == "tok":
                out.append(frag)
            else:
                self._bpe_encode(frag, out)
        if self.vocab.add_eos and self.vocab.eos_id >= 0:
            out.append(self.vocab.eos_id)
        return out

    def token_to_piece(self, tid: int, special: bool = False) -> str:
        v = self.vocab
        t = v.tokens[tid]
        tt = v.token_types[tid]
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN):
            return t if special else ""
        return bytes(_U2B.get(ch, ord("?")) for ch in t).decode(
            "utf-8", errors="replace")

    def token_bytes(self, tid: int) -> bytes:
        """Raw piece bytes through the byte map (may be partial UTF-8)."""
        t = self.vocab.tokens[tid]
        if self.vocab.token_types[tid] in (TOKEN_TYPE_CONTROL,
                                           TOKEN_TYPE_UNKNOWN):
            return b""
        return bytes(_U2B.get(ch, ord("?")) for ch in t)

    def decode(self, ids: list[int], special: bool = False) -> str:
        buf = bytearray()
        for tid in ids:
            t = self.vocab.tokens[tid]
            if self.vocab.token_types[tid] in (TOKEN_TYPE_CONTROL,
                                               TOKEN_TYPE_UNKNOWN):
                if special:
                    buf.extend(t.encode("utf-8"))
                continue
            buf.extend(_U2B.get(ch, ord("?")) for ch in t)
        return buf.decode("utf-8", errors="replace")

    # -- internals ------------------------------------------------------------
    def _bpe_encode(self, text: str, out: list[int]) -> None:
        for word in gpt2_pretokenize(text):
            w = "".join(_B2U[b] for b in word.encode("utf-8"))
            out.extend(self._merge_word(w))

    def _merge_word(self, w: str) -> list[int]:
        syms = list(w)
        n = len(syms)
        sizes = [1] * n
        prev = list(range(-1, n - 1))
        nxt = [i + 1 if i + 1 < n else -1 for i in range(n)]
        heap: list[tuple[int, int, int, str]] = []
        _ofs = list(range(n))   # char offset of each symbol (fixed)

        def try_add(left: int, right: int):
            if left == -1 or right == -1:
                return
            lt = w[_ofs[left]:_ofs[left] + sizes[left]]
            rt = w[_ofs[right]:_ofs[right] + sizes[right]]
            rank = self.ranks.get((lt, rt))
            if rank is None:
                return
            heapq.heappush(heap, (rank, left, right, lt + rt))

        for i in range(1, n):
            try_add(i - 1, i)

        while heap:
            rank, left, right, text = heapq.heappop(heap)
            if sizes[left] == 0 or sizes[right] == 0:
                continue
            lt = w[_ofs[left]:_ofs[left] + sizes[left]]
            rt = w[_ofs[right]:_ofs[right] + sizes[right]]
            if lt + rt != text:
                continue  # outdated entry
            sizes[left] += sizes[right]
            sizes[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        ids: list[int] = []
        i = 0
        while i != -1:
            t = w[_ofs[i]:_ofs[i] + sizes[i]]
            tid = self.token_to_id.get(t)
            if tid is not None:
                ids.append(tid)
            else:
                # per-char byte fallback (llm_tokenizer_bpe :9711-9720)
                for ch in t:
                    ids.append(self.token_to_id.get(ch, self.vocab.unk_id))
            i = nxt[i]
        return ids
