"""Port parity: tpulamm_torch's copies of the grammar parser and engine,
the JSON-schema compiler, the chat templates and the log layer against the
JAX package's modules, on the same inputs.

Cases come from tests/test_grammar.py, tests/test_json_schema.py,
tests/test_embed_chat_cfg.py and tests/test_log.py, plus the GBNF files
in grammars/. Every result must be equal: parsed rules, acceptance,
rejected token sets along seeded token-piece streams, grammar text,
rendered prompts, and the constrained Sampler's tokens.
"""

import pathlib
import random

import numpy as np
import pytest

from tpulamm.grammar import engine as jge
from tpulamm.grammar import gbnf as jgbnf
from tpulamm.grammar import json_schema as jjs
from tpulamm.runtime import chat as jchat
from tpulamm.runtime import sampling as jsamp
from tpulamm.utils import log as jlog
from tpulamm_torch.grammar import engine as tge
from tpulamm_torch.grammar import gbnf as tgbnf
from tpulamm_torch.grammar import json_schema as tjs
from tpulamm_torch.runtime import chat as tchat
from tpulamm_torch.runtime import sampling as tsamp
from tpulamm_torch.utils import log as tlog

ROOT = pathlib.Path(__file__).resolve().parent.parent

ARITH = r"""
root  ::= (expr "=" term "\n")+
expr  ::= term ([-+*/] term)*
term  ::= [0-9]+
"""

JSONISH = r"""
root   ::= object
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}"
value  ::= object | array | string | number | "true" | "false" | "null"
array  ::= "[" ws ( value ("," ws value)* )? "]"
string ::= "\"" [a-zA-Z0-9 ]* "\""
number ::= "-"? [0-9]+ ("." [0-9]+)?
ws     ::= [ \t\n]*
"""

GRAMMARS = {
    "arith": ARITH,
    "jsonish": JSONISH,
    "structure": 'root ::= "ab" [c-e] | sub\nsub ::= "x"+\n',
    "escapes": r'root ::= [^a-z\n] "\x41B"' + "\n",
    "utf8": 'root ::= [à-ÿ] "!"\n',
    "letters": "root ::= [a-z ]+\n",
    **{f"file_{p.stem}": p.read_text()
       for p in sorted((ROOT / "grammars").glob("*.gbnf"))},
}

BAD_GRAMMARS = ["root = bad\n", "root ::= undefined-rule\n",
                'root ::= *"x"\n', ""]

PERSON = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}},
    },
    "required": ["name", "age"],
}

SCHEMAS = [
    {"type": "integer"}, {"type": "number"}, {"type": "boolean"},
    {"type": "null"}, {"type": "string"}, PERSON, {},
    {"type": "object", "properties": {"a": {"type": "integer"},
                                      "b": {"type": "boolean"},
                                      "c": {"type": "null"}}},
    {"enum": ["red", "green", 7, None]}, {"const": {"k": [1, 2]}},
    {"type": ["string", "null"]},
    {"oneOf": [{"type": "integer"}, {"type": "boolean"}]},
    {"allOf": [
        {"type": "object", "properties": {"a": {"type": "integer"}},
         "required": ["a"]},
        {"type": "object", "properties": {"b": {"type": "boolean"}},
         "required": ["b"]}]},
    {"$defs": {"node": {
        "type": "object",
        "properties": {"v": {"type": "integer"},
                       "next": {"oneOf": [{"$ref": "#/$defs/node"},
                                          {"type": "null"}]}},
        "required": ["v", "next"]}},
     "$ref": "#/$defs/node"},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1,
     "maxItems": 3},
    {"prefixItems": [{"type": "integer"}, {"type": "boolean"}]},
    {"type": "string", "minLength": 2, "maxLength": 4},
    {"type": "object",
     "properties": {"a": {"type": "array", "items": {"type": "integer"}},
                    "b": {"type": "array", "items": {"type": "integer"}}}},
]

BAD_SCHEMAS = [{"type": "frobnicate"}, {"$ref": "#/$defs/missing"},
               {"$ref": "http://elsewhere/schema"}]

MSGS = [
    {"role": "system", "content": "You are a helpful assistant"},
    {"role": "user", "content": "Hello"},
    {"role": "assistant", "content": "Hi there"},
    {"role": "user", "content": "Who are you"},
]

TEMPLATES = ["chatml", "llama2", "zephyr", "gemma", "monarch",
             "{% if ... %}<<SYS>>[INST]...", "{{ some totally custom jinja }}",
             "<|im_start|>{{ role }}", "<start_of_turn>", "<|user|>"]


def _state(st):
    return st.rules, dict(st.symbol_ids)


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_parse_gbnf_equal(name):
    assert _state(tgbnf.parse_gbnf(GRAMMARS[name])) == \
        _state(jgbnf.parse_gbnf(GRAMMARS[name]))


@pytest.mark.parametrize("text", BAD_GRAMMARS)
def test_parse_errors_equal(text):
    errs = []
    for mod in (jgbnf, tgbnf):
        try:
            mod.parse_gbnf(text)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[1] == errs[0]


def _accepts(mod, g_text: str, s: str) -> bool:
    g = mod.Grammar.from_gbnf(g_text)
    try:
        for ch in s:
            g.accept_token(ch.encode("utf-8"))
    except AssertionError:
        return False
    return g.can_stop()


@pytest.mark.parametrize("name,s", [
    ("arith", "1+2=3\n"), ("arith", "12*34=408\n"), ("arith", "7=7\n1+1=2\n"),
    ("arith", "1+2=3"), ("arith", "a+b=c\n"), ("arith", "1 + 2 = 3\n"),
    ("jsonish", "{}"), ("jsonish", '{"a": [1, 2, {"b": "c"}], "d": null}'),
    ("jsonish", '{"a" 1}'), ("utf8", "é!"), ("utf8", "e!"),
    ("file_json", '{"k": [1, true, "s"]}'), ("file_list", "- a\n- b\n"),
    ("file_arithmetic", "1+2*(3-4)\n"),
])
def test_acceptance_equal(name, s):
    assert _accepts(tge, GRAMMARS[name], s) == \
        _accepts(jge, GRAMMARS[name], s)


PIECES = [c.encode() for c in "0123456789+-*/=\n{}[]\",: abcxyz"] + [
    b"12", b"+3", b"=4\n", b'{"', b'":', b"true", b"null", b"ab ",
    "é".encode()[:1], "é".encode()[1:], "é!".encode(), b"\xff", b""]


@pytest.mark.parametrize("name", ["arith", "jsonish", "utf8", "letters",
                                  "file_json", "file_list"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_piece_streams_equal(name, seed):
    """A seeded walk over token pieces: at each step both engines reject
    the same pieces and agree on can_stop; the walk takes an allowed
    piece (the same one) in both."""
    rng = random.Random(seed)
    jg = jge.Grammar.from_gbnf(GRAMMARS[name])
    tg = tge.Grammar.from_gbnf(GRAMMARS[name])
    cands = dict(enumerate(PIECES))
    for _ in range(40):
        rej = tg.reject_tokens(cands)
        assert sorted(rej) == sorted(jg.reject_tokens(cands))
        assert tg.can_stop() == jg.can_stop()
        allowed = [i for i in cands if i not in set(rej) and cands[i]]
        if not allowed:
            break
        piece = cands[rng.choice(allowed)]
        jg.accept_token(piece)
        tg.accept_token(piece)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["arith", "jsonish"])
def test_constrained_sampler_equal(name, seed):
    """The port's Sampler with the port's Grammar picks the JAX Sampler's
    tokens from the same logits (the server's grammar path)."""
    rng = np.random.default_rng(seed)
    pieces = PIECES[:-1] + [b""]
    eos = len(pieces) - 1
    out = []
    samplers = [
        mod.Sampler(mod.SamplingParams(temp=0.0), vocab_size=len(pieces),
                    eos_id=eos, grammar=g.Grammar.from_gbnf(GRAMMARS[name]),
                    token_pieces=pieces)
        for mod, g in ((jsamp, jge), (tsamp, tge))]
    for _ in range(30):
        logits = rng.normal(size=len(pieces)).astype(np.float32) * 3
        toks = [s.sample(logits) for s in samplers]
        assert toks[1] == toks[0]
        if toks[0] == eos:
            break
        for s in samplers:
            s.accept(toks[0])
        out.append(toks[0])
    assert out


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_to_grammar_equal(i):
    got = tjs.schema_to_grammar(SCHEMAS[i])
    assert got == jjs.schema_to_grammar(SCHEMAS[i])
    tgbnf.parse_gbnf(got)


def test_json_grammar_and_prop_order_equal():
    assert tjs.json_grammar() == jjs.json_grammar()
    assert tjs.schema_to_grammar(PERSON, ["age", "name"]) == \
        jjs.schema_to_grammar(PERSON, ["age", "name"])


@pytest.mark.parametrize("schema", BAD_SCHEMAS)
def test_bad_schemas_raise_alike(schema):
    errs = []
    for mod in (jjs, tjs):
        with pytest.raises(ValueError) as e:
            mod.schema_to_grammar(schema)
        errs.append(str(e.value))
    assert errs[1] == errs[0]


@pytest.mark.parametrize("add_assistant", [True, False])
@pytest.mark.parametrize("tmpl", TEMPLATES)
def test_chat_templates_equal(tmpl, add_assistant):
    for msgs in (MSGS, MSGS[1:2], MSGS[1:]):
        assert tchat.apply_chat_template(tmpl, msgs, add_assistant) == \
            jchat.apply_chat_template(tmpl, msgs, add_assistant)


@pytest.mark.parametrize("md", [
    {}, {"tokenizer.chat_template": "{% if ... %}<<SYS>>[INST]..."},
    {"tokenizer.chat_template": "<start_of_turn>model"},
    {"tokenizer.chat_template": "<|im_start|>"},
    {"tokenizer.chat_template": 7},
])
def test_template_from_metadata_equal(md):
    assert tchat.template_from_metadata(md) == jchat.template_from_metadata(md)


def test_log_yaml_and_timings_equal(tmp_path):
    rec = {"model": "m.gguf", "n": 3, "ok": True, "f": 1.5,
           "tricky": "a: b #x", "items": [1, "two"], "none": None}
    texts = [open(mod.dump_yaml(str(tmp_path / name), "main", rec)).read()
             for name, mod in (("j", jlog), ("t", tlog))]
    assert texts[1] == texts[0]
    from tpulamm.runtime.engine import Timings as JT
    from tpulamm_torch.runtime.engine import Timings as TT
    kw = dict(t_load=0.5, t_prefill=2.0, n_prefill=100, t_eval=1.0,
              n_eval=50, t_sample=0.25, n_sample=40)
    assert tlog.timings_record(TT(**kw)) == jlog.timings_record(JT(**kw))


def test_log_file_tee_and_callback(tmp_path, capsys):
    """The port's log layer writes what the JAX one writes."""
    out = []
    for name, mod in (("j", jlog), ("t", tlog)):
        got = []
        path = str(tmp_path / f"{name}.log")
        mod.open_file(path)
        mod.set_callback(lambda lvl, txt: got.append((lvl, txt)))
        mod.log("file-only line")
        mod.log_tee("tee line", level="warn")
        mod.set_callback(None)
        mod.log("after")
        mod.close_file()
        text = open(path).read()
        out.append((got, [ln.split("] ", 1)[-1] for ln in text.splitlines()],
                    capsys.readouterr().err.count("tee line")))
    assert out[1] == out[0]
