"""Grammar-constrained sampling engine (pushdown stacks over GBNF rules).

Copy of tpulamm.grammar.engine.

Port of the reference's grammar machinery semantics
(llama.cpp:10234-10666): a set of pushdown stacks, each positioned at a
terminal (char range) element; accepting a code point advances every stack
that matches; candidate tokens are rejected iff no stack can accept their
full code-point sequence (including a trailing partial UTF-8 byte sequence,
llama_partial_utf8 / llama_grammar_match_partial_char). EOS is legal only
when some stack is empty (llama_sample_grammar llama.cpp:11125-11165).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpulamm_torch.grammar.gbnf import (ALT, CHAR, CHAR_ALT, CHAR_NOT,
                                        CHAR_RNG_UPPER, END, RULE_REF,
                                        ParseState, parse_gbnf)

Pos = tuple[int, int]       # (rule id, element index)
Stack = tuple[Pos, ...]


@dataclass(frozen=True)
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(data: bytes, partial: PartialUtf8
                ) -> tuple[list[int], PartialUtf8]:
    """decode_utf8 (llama.cpp:10284-10345): code points + trailing partial.

    Deliberate fix over the reference: a continuation byte (0x80-0xBF) at
    sequence start is invalid UTF-8 and is reported as such; the reference's
    lookup table masks it to a 7-bit char, which lets stray byte tokens
    alias into grammar-legal ASCII (e.g. <0xB4> passing as '4')."""
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]
    cps: list[int] = []
    value, n_remain = partial.value, partial.n_remain
    i = 0
    while i < len(data) and n_remain > 0:
        b = data[i]
        if (b >> 6) != 2:
            return [0], PartialUtf8(0, -1)      # invalid sequence
        value = (value << 6) + (b & 0x3F)
        i += 1
        n_remain -= 1
    if partial.n_remain > 0 and n_remain == 0:
        cps.append(value)
    while i < len(data):
        first = data[i]
        if (first >> 6) == 2:                   # continuation at start
            return [], PartialUtf8(0, -1)
        n_remain = lookup[first >> 4] - 1
        if n_remain < 0:
            return [0], PartialUtf8(0, n_remain)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        i += 1
        while i < len(data) and n_remain > 0:
            value = (value << 6) + (data[i] & 0x3F)
            i += 1
            n_remain -= 1
        if n_remain == 0:
            cps.append(value)
    return cps, PartialUtf8(value, n_remain)


class Grammar:
    def __init__(self, state: ParseState, start_rule: str = "root"):
        self.rules = state.rules
        self.partial_utf8 = PartialUtf8()
        self.stacks: list[Stack] = []
        rid = state.start_rule(start_rule)
        # loop over alternates of start rule (llama_grammar_init)
        i = 0
        rule = self.rules[rid]
        while True:
            stack: list[Pos] = []
            if not self._is_end(rule[i]):
                stack.append((rid, i))
            self._advance(tuple(stack), self.stacks)
            while not self._is_end(rule[i]):
                i += 1
            if rule[i][0] == ALT:
                i += 1
            else:
                break

    @classmethod
    def from_gbnf(cls, text: str, start_rule: str = "root") -> "Grammar":
        return cls(parse_gbnf(text), start_rule)

    # -- element helpers ------------------------------------------------------
    def _el(self, pos: Pos):
        return self.rules[pos[0]][pos[1]]

    @staticmethod
    def _is_end(el) -> bool:
        return el[0] in (END, ALT)

    def _match_char(self, pos: Pos, chr_: int) -> tuple[bool, Pos]:
        """llama_grammar_match_char: match + position after the range."""
        rule = self.rules[pos[0]]
        i = pos[1]
        t, v = rule[i]
        positive = t == CHAR
        assert positive or t == CHAR_NOT
        found = False
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                found = found or (rule[i][1] <= chr_ <= rule[i + 1][1])
                i += 2
            else:
                found = found or rule[i][1] == chr_
                i += 1
            if rule[i][0] != CHAR_ALT:
                break
        return found == positive, (pos[0], i)

    def _match_partial(self, pos: Pos, partial: PartialUtf8) -> bool:
        """llama_grammar_match_partial_char."""
        rule = self.rules[pos[0]]
        i = pos[1]
        positive = rule[i][0] == CHAR
        value, n_remain = partial.value, partial.n_remain
        if n_remain < 0 or (n_remain == 1 and value < 2):
            return False
        low = value << (n_remain * 6)
        high = low | ((1 << (n_remain * 6)) - 1)
        if low == 0:
            if n_remain == 2:
                low = 1 << 11
            elif n_remain == 3:
                low = 1 << 16
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                if rule[i][1] <= high and low <= rule[i + 1][1]:
                    return positive
                i += 2
            else:
                if low <= rule[i][1] <= high:
                    return positive
                i += 1
            if rule[i][0] != CHAR_ALT:
                break
        return not positive

    def _advance(self, stack: Stack, new_stacks: list[Stack]):
        """llama_grammar_advance_stack: expand until tops are terminals."""
        if not stack:
            if stack not in new_stacks:
                new_stacks.append(stack)
            return
        pos = stack[-1]
        t, v = self._el(pos)
        if t == RULE_REF:
            rid = v
            i = 0
            rule = self.rules[rid]
            while True:
                new_stack = list(stack[:-1])
                nxt = (pos[0], pos[1] + 1)
                if not self._is_end(self._el(nxt)):
                    new_stack.append(nxt)
                if not self._is_end(rule[i]):
                    new_stack.append((rid, i))
                self._advance(tuple(new_stack), new_stacks)
                while not self._is_end(rule[i]):
                    i += 1
                if rule[i][0] == ALT:
                    i += 1
                else:
                    break
        elif t in (CHAR, CHAR_NOT):
            if stack not in new_stacks:
                new_stacks.append(stack)
        else:
            raise AssertionError(f"stack top on element type {t}")

    def _accept_cp(self, stacks: list[Stack], chr_: int) -> list[Stack]:
        """llama_grammar_accept: advance all stacks on a code point."""
        new_stacks: list[Stack] = []
        for stack in stacks:
            if not stack:
                continue
            ok, after = self._match_char(stack[-1], chr_)
            if ok:
                new_stack = list(stack[:-1])
                if not self._is_end(self._el(after)):
                    new_stack.append(after)
                self._advance(tuple(new_stack), new_stacks)
        return new_stacks

    # -- candidate rejection (llama_grammar_reject_candidates) -----------------
    def _reject_for_stack(self, stack: Stack, candidates: list) -> list:
        # candidates: (index, cp_offset_list, partial)
        rejects = []
        if not stack:
            for tok in candidates:
                idx, cps, partial = tok
                if cps or partial.n_remain != 0:
                    rejects.append(tok)
            return rejects
        pos = stack[-1]
        next_candidates = []
        for tok in candidates:
            idx, cps, partial = tok
            if not cps:
                if partial.n_remain != 0 and \
                        not self._match_partial(pos, partial):
                    rejects.append(tok)
            elif self._match_char(pos, cps[0])[0]:
                next_candidates.append((idx, cps[1:], partial))
            else:
                rejects.append(tok)
        _, after = self._match_char(pos, 0)
        stack_after = list(stack[:-1])
        if not self._is_end(self._el(after)):
            stack_after.append(after)
        next_stacks: list[Stack] = []
        self._advance(tuple(stack_after), next_stacks)
        for idx, cps, partial in self._rejects(next_stacks, next_candidates):
            # restore the consumed code point
            orig = next(t for t in candidates if t[0] == idx)
            rejects.append((idx, orig[1], partial))
        return rejects

    def _rejects(self, stacks: list[Stack], candidates: list) -> list:
        if not candidates:
            return []
        assert stacks, "grammar stacks exhausted"
        rejects = self._reject_for_stack(stacks[0], candidates)
        for st in stacks[1:]:
            rejects = self._reject_for_stack(st, rejects)
        return rejects

    # -- public API -------------------------------------------------------------
    def can_stop(self) -> bool:
        """EOS allowed iff some stack is empty."""
        return any(not s for s in self.stacks)

    def reject_tokens(self, pieces: dict[int, bytes]) -> list[int]:
        """Token ids (from {id: piece-bytes}) the grammar cannot accept."""
        candidates = []
        empty_piece: list[int] = []
        for tid, piece in pieces.items():
            if not piece:
                empty_piece.append(tid)
                continue
            cps, partial = decode_utf8(piece, self.partial_utf8)
            candidates.append((tid, cps, partial))
        rejected = [idx for idx, _, _ in self._rejects(self.stacks, candidates)]
        return rejected + empty_piece

    def accept_token(self, piece: bytes) -> None:
        """llama_grammar_accept_token: advance state by a generated piece."""
        cps, self.partial_utf8 = decode_utf8(piece, self.partial_utf8)
        stacks = self.stacks
        for cp in cps:
            stacks = self._accept_cp(stacks, cp)
        assert stacks, "grammar rejected an accepted token (engine bug)"
        self.stacks = stacks
