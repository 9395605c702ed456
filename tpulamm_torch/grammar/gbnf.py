"""GBNF grammar parser.

Copy of tpulamm.grammar.gbnf.

Behavior-compatible with common/grammar-parser.cpp (440 LoC): parses the
BNF-like grammar files under the reference's grammars/*.gbnf into flat rules
of grammar elements. Rule layout matches llama_grammar_element semantics —
each rule is a list of elements where ALT separates alternate definitions
and END terminates the rule; repetition operators are rewritten into
synthesized recursive rules (S* -> S' ::= S S' | ; parse_sequence
grammar-parser.cpp:190-223).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# element types — same meaning as llama_gretype (llama.h:284-305)
END = 0            # end of rule definition
ALT = 1            # start of alternate definition
RULE_REF = 2       # non-terminal element: reference to another rule
CHAR = 3           # terminal: character (code point or rule start)
CHAR_NOT = 4       # inverse char(s) ([^a], [^a-b], [^abc])
CHAR_RNG_UPPER = 5 # modifies preceding CHAR{,_ALT,_NOT} to inclusive range
CHAR_ALT = 6       # modifies preceding CHAR{,_RNG_UPPER} to add alternate


Element = tuple[int, int]  # (type, value)

_WORD = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-")
_ESCAPES = {"t": ord("\t"), "r": ord("\r"), "n": ord("\n"),
            "\\": ord("\\"), '"': ord('"'), "[": ord("["), "]": ord("]")}


@dataclass
class ParseState:
    symbol_ids: dict[str, int] = field(default_factory=dict)
    rules: list[list[Element]] = field(default_factory=list)

    def start_rule(self, name: str = "root") -> int:
        if name not in self.symbol_ids:
            raise ValueError(f"grammar has no {name!r} rule")
        return self.symbol_ids[name]


class _Parser:
    def __init__(self, src: str):
        self.s = src
        self.i = 0
        self.state = ParseState()

    # -- low-level ------------------------------------------------------------
    def _c(self, off: int = 0) -> str:
        j = self.i + off
        return self.s[j] if j < len(self.s) else ""

    def _space(self, newline_ok: bool):
        while True:
            c = self._c()
            if c in (" ", "\t") or (newline_ok and c in ("\r", "\n")):
                self.i += 1
            elif c == "#":
                while self._c() and self._c() not in ("\r", "\n"):
                    self.i += 1
            else:
                return

    def _name(self) -> str:
        j = self.i
        while self._c() in _WORD and self._c():
            self.i += 1
        if self.i == j:
            raise ValueError(f"expecting name at offset {self.i}")
        return self.s[j:self.i]

    def _hex(self, size: int) -> int:
        v = self.s[self.i:self.i + size]
        if len(v) != size:
            raise ValueError(f"expecting {size} hex chars at offset {self.i}")
        self.i += size
        return int(v, 16)

    def _char(self) -> int:
        c = self._c()
        if c == "\\":
            e = self._c(1)
            self.i += 2
            if e == "x":
                return self._hex(2)
            if e == "u":
                return self._hex(4)
            if e == "U":
                return self._hex(8)
            if e in _ESCAPES:
                return _ESCAPES[e]
            raise ValueError(f"unknown escape \\{e} at offset {self.i}")
        if not c:
            raise ValueError("unexpected end of input")
        self.i += 1
        return ord(c)

    def _sym_id(self, name: str) -> int:
        return self.state.symbol_ids.setdefault(name, len(self.state.symbol_ids))

    def _gen_id(self, base: str) -> int:
        nid = len(self.state.symbol_ids)
        self.state.symbol_ids[f"{base}_{nid}"] = nid
        return nid

    def _add_rule(self, rid: int, rule: list[Element]):
        while len(self.state.rules) <= rid:
            self.state.rules.append([])
        self.state.rules[rid] = rule

    # -- grammar productions ----------------------------------------------------
    def _sequence(self, rule_name: str, out: list[Element], nested: bool):
        last_sym_start = len(out)
        while self._c():
            c = self._c()
            if c == '"':
                self.i += 1
                last_sym_start = len(out)
                while self._c() != '"':
                    out.append((CHAR, self._char()))
                self.i += 1
                self._space(nested)
            elif c == "[":
                self.i += 1
                start_type = CHAR
                if self._c() == "^":
                    self.i += 1
                    start_type = CHAR_NOT
                last_sym_start = len(out)
                while self._c() != "]":
                    ch = self._char()
                    t = CHAR_ALT if last_sym_start < len(out) else start_type
                    out.append((t, ch))
                    if self._c() == "-" and self._c(1) != "]":
                        self.i += 1
                        out.append((CHAR_RNG_UPPER, self._char()))
                self.i += 1
                self._space(nested)
            elif c in _WORD:
                name = self._name()
                rid = self._sym_id(name)
                self._space(nested)
                last_sym_start = len(out)
                out.append((RULE_REF, rid))
            elif c == "(":
                self.i += 1
                self._space(True)
                sub_id = self._gen_id(rule_name)
                self._alternates(rule_name, sub_id, True)
                last_sym_start = len(out)
                out.append((RULE_REF, sub_id))
                if self._c() != ")":
                    raise ValueError(f"expecting ')' at offset {self.i}")
                self.i += 1
                self._space(nested)
            elif c in "*+?":
                if last_sym_start == len(out):
                    raise ValueError(f"expecting item before {c!r} at "
                                     f"offset {self.i}")
                # S* -> S' ::= S S' | ; S+ -> S' ::= S S' | S; S? -> S' ::= S |
                sub_id = self._gen_id(rule_name)
                sub: list[Element] = list(out[last_sym_start:])
                if c in "*+":
                    sub.append((RULE_REF, sub_id))
                sub.append((ALT, 0))
                if c == "+":
                    sub.extend(out[last_sym_start:])
                sub.append((END, 0))
                self._add_rule(sub_id, sub)
                del out[last_sym_start:]
                out.append((RULE_REF, sub_id))
                self.i += 1
                self._space(nested)
            else:
                break

    def _alternates(self, rule_name: str, rid: int, nested: bool):
        rule: list[Element] = []
        self._sequence(rule_name, rule, nested)
        while self._c() == "|":
            rule.append((ALT, 0))
            self.i += 1
            self._space(True)
            self._sequence(rule_name, rule, nested)
        rule.append((END, 0))
        self._add_rule(rid, rule)

    def _rule(self):
        name = self._name()
        self._space(False)
        rid = self._sym_id(name)
        if self.s[self.i:self.i + 3] != "::=":
            raise ValueError(f"expecting ::= at offset {self.i}")
        self.i += 3
        self._space(True)
        self._alternates(name, rid, False)
        c = self._c()
        if c == "\r":
            self.i += 2 if self._c(1) == "\n" else 1
        elif c == "\n":
            self.i += 1
        elif c:
            raise ValueError(f"expecting newline or end at offset {self.i}")
        self._space(True)

    def parse(self) -> ParseState:
        self._space(True)
        while self._c():
            self._rule()
        # validate rule refs (grammar-parser.cpp parse tail)
        for rule in self.state.rules:
            for t, v in rule:
                if t == RULE_REF and (v >= len(self.state.rules)
                                      or not self.state.rules[v]):
                    raise ValueError(f"undefined rule id {v}")
        return self.state


def parse_gbnf(src: str) -> ParseState:
    return _Parser(src).parse()
