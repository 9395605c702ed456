"""SentencePiece-style (SPM) tokenizer over GGUF vocab metadata.

Copy of tpulamm.tokenizer.spm (pure Python path; no native core).

Behavior-compatible with llm_tokenizer_spm (llama.cpp:9484-9600) and
llama_tokenize_internal's SPM path (:10176-10225):

- input is split into UTF-8 characters, then adjacent symbols are merged
  greedily by vocab score (max-heap; ties broken by leftmost position)
- unmatched symbols are resegmented through the merge history and finally
  fall back to byte tokens ("<0xXX>")
- a leading space is prefixed to the first raw fragment (add_space_prefix)
  and spaces are escaped to U+2581 before matching
- special tokens partition the input first (tokenizer_st_partition,
  llama.cpp:10082) so their text never participates in merges
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

# token_type values (gguf tokenizer.ggml.token_type; llama.h llama_token_type)
TOKEN_TYPE_UNDEFINED = 0
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

_SPACE_ESC = "▁"  # ▁


@dataclass
class Vocab:
    tokens: list[str]
    scores: list[float]
    token_types: list[int]
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    model: str = "llama"  # "llama"=SPM, "gpt2"=BPE, "bert"=WPM
    merges: list[str] = field(default_factory=list)

    @classmethod
    def from_metadata(cls, md: dict) -> "Vocab":
        tokens = list(md["tokenizer.ggml.tokens"])
        n = len(tokens)
        scores = list(md.get("tokenizer.ggml.scores", [0.0] * n))
        ttypes = list(md.get("tokenizer.ggml.token_type",
                             [TOKEN_TYPE_NORMAL] * n))
        model = md.get("tokenizer.ggml.model", "llama")
        v = cls(
            tokens=tokens, scores=[float(s) for s in scores],
            token_types=[int(t) for t in ttypes],
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", 1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", 2)),
            unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0)),
            pad_id=int(md.get("tokenizer.ggml.padding_token_id", -1)),
            # BPE models default to no BOS (llm_load_vocab: add_bos is
            # true only for SPM/WPM unless the GGUF says otherwise)
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token",
                                model != "gpt2")),
            add_eos=bool(md.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix",
                                         True)),
            model=model,
            merges=list(md.get("tokenizer.ggml.merges", [])),
        )
        return v


def partition_specials(text: str, special: list[tuple[str, int]]):
    """Split on special-token literals (tokenizer_st_partition,
    llama.cpp:10082); shared by the SPM/BPE/WPM tokenizers."""
    fragments: list[tuple[str, object]] = [("raw", text)]
    for st_text, st_id in special:
        new_frags = []
        for kind, frag in fragments:
            if kind != "raw":
                new_frags.append((kind, frag))
                continue
            rest = frag
            while True:
                idx = rest.find(st_text)
                if idx < 0:
                    if rest:
                        new_frags.append(("raw", rest))
                    break
                if idx > 0:
                    new_frags.append(("raw", rest[:idx]))
                new_frags.append(("tok", st_id))
                rest = rest[idx + len(st_text):]
        fragments = new_frags
    return fragments


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab.tokens)}
        self.byte_tokens: dict[int, int] = {}
        for b in range(256):
            tid = self.token_to_id.get(f"<0x{b:02X}>")
            if tid is None:
                tid = self.token_to_id.get(chr(b))
            if tid is not None:
                self.byte_tokens[b] = tid
        # special tokens for partitioning: control + user-defined
        self.special: list[tuple[str, int]] = [
            (t, i) for i, t in enumerate(vocab.tokens)
            if vocab.token_types[i] in (TOKEN_TYPE_CONTROL,
                                        TOKEN_TYPE_USER_DEFINED) and t]
        self.special.sort(key=lambda x: -len(x[0]))

    # -- public API ----------------------------------------------------------
    def encode(self, text: str, add_bos: bool | None = None,
               special: bool = False) -> list[int]:
        out: list[int] = []
        if add_bos is None:
            add_bos = self.vocab.add_bos
        if add_bos and self.vocab.bos_id >= 0:
            out.append(self.vocab.bos_id)
        if not text:
            return out
        fragments = self._partition(text) if special else [("raw", text)]
        # llama.cpp b2430: the space prefix applies only when the VERY
        # FIRST fragment is raw — a leading special token (chat templates)
        # suppresses it
        first = True
        for kind, frag in fragments:
            if kind == "tok":
                out.append(frag)
                first = False
                continue
            raw = frag
            if first and self.vocab.add_space_prefix:
                raw = " " + raw
            first = False
            self._spm_encode(raw.replace(" ", _SPACE_ESC), out)
        if self.vocab.add_eos and self.vocab.eos_id >= 0:
            out.append(self.vocab.eos_id)
        return out

    def token_to_piece(self, tid: int, special: bool = False) -> str:
        """llama_token_to_piece (llama.cpp:14060-14100) semantics."""
        v = self.vocab
        t = v.tokens[tid]
        tt = v.token_types[tid]
        if tt == TOKEN_TYPE_BYTE:
            if t.startswith("<0x") and t.endswith(">"):
                return chr(int(t[3:-1], 16))
            return t
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN):
            return t if special else ""
        return t.replace(_SPACE_ESC, " ")

    def token_bytes(self, tid: int) -> bytes:
        """Raw bytes of a token's piece (llama_token_to_piece byte-exact;
        byte tokens yield their single raw byte, not its UTF-8 encoding)."""
        t = self.vocab.tokens[tid]
        tt = self.vocab.token_types[tid]
        if tt == TOKEN_TYPE_BYTE and t.startswith("<0x"):
            return bytes([int(t[3:-1], 16)])
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_UNKNOWN):
            return b""
        return t.replace(_SPACE_ESC, " ").encode("utf-8")

    def decode(self, ids: list[int], special: bool = False) -> str:
        # byte tokens may form multi-byte utf-8 sequences; build bytes
        buf = bytearray()
        for tid in ids:
            t = self.vocab.tokens[tid]
            tt = self.vocab.token_types[tid]
            if tt == TOKEN_TYPE_BYTE and t.startswith("<0x"):
                buf.append(int(t[3:-1], 16))
            else:
                piece = self.token_to_piece(tid, special)
                buf.extend(piece.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    # -- internals ------------------------------------------------------------
    def _partition(self, text: str):
        return partition_specials(text, self.special)

    def _spm_encode(self, text: str, out: list[int]) -> None:
        data = text.encode("utf-8")
        if not data:
            return
        # split into utf-8 characters (byte spans)
        spans: list[tuple[int, int]] = []   # (start, n_bytes); n=0 => merged
        i = 0
        while i < len(data):
            b = data[i]
            # reference lookup (llama.cpp decode_utf8): 0x80-0xBF -> 1
            n = 1 if b < 0xC0 else (2 if b < 0xE0 else (3 if b < 0xF0 else 4))
            n = min(n, len(data) - i)
            spans.append((i, n))
            i += n
        nsym = len(spans)
        prev = list(range(-1, nsym - 1))
        nxt = [i + 1 if i + 1 < nsym else -1 for i in range(nsym)]
        sizes = [n for _, n in spans]
        starts = [s for s, _ in spans]

        heap: list[tuple[float, int, int, int, int]] = []
        rev_merge: dict[bytes, tuple[int, int]] = {}

        def try_add(left: int, right: int):
            if left == -1 or right == -1:
                return
            t = data[starts[left]:starts[left] + sizes[left] + sizes[right]]
            tid = self.token_to_id.get(t.decode("utf-8", errors="ignore"))
            # decode errors: partial utf-8 can't match a vocab entry anyway
            if tid is None:
                return
            heapq.heappush(heap, (-self.vocab.scores[tid], left, right,
                                  sizes[left] + sizes[right], tid))
            rev_merge[bytes(t)] = (left, right)

        for i in range(1, nsym):
            try_add(i - 1, i)

        while heap:
            _, left, right, size, _ = heapq.heappop(heap)
            if sizes[left] == 0 or sizes[right] == 0 or \
                    sizes[left] + sizes[right] != size:
                continue
            sizes[left] += sizes[right]
            sizes[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        def resegment(i: int):
            t = data[starts[i]:starts[i] + sizes[i]]
            tid = self.token_to_id.get(t.decode("utf-8", errors="ignore"))
            if tid is not None:
                out.append(tid)
                return
            p = rev_merge.get(bytes(t))
            if p is None:
                for b in t:
                    out.append(self.byte_tokens.get(b, self.vocab.unk_id))
                return
            resegment(p[0])
            resegment(p[1])

        i = 0
        while i != -1:
            resegment(i)
            i = nxt[i]


def build_tokenizer(md: dict):
    """Factory from GGUF metadata (llm_load_vocab equivalent). The port
    carries the SPM tokenizer only; BPE and WPM vocabularies raise."""
    vocab = Vocab.from_metadata(md)
    if vocab.model in ("llama", "spm"):
        return SPMTokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r} is not "
                              "ported (ROADMAP queue 1: tokenizers)")
