"""JSON-schema -> GBNF grammar compiler.

Copy of tpulamm.grammar.json_schema.

Role parity with the reference's `examples/json-schema-to-grammar.py`
(147 LoC): turn a JSON schema into a GBNF grammar usable by the grammar
engine so generation is constrained to schema-conforming JSON. This is a
fresh implementation with a wider feature set than the reference script
(which left `required` and `prefixItems` as TODOs):

  - types: object / array / string / number / integer / boolean / null
  - `enum` and `const` (arbitrary JSON literals)
  - `oneOf` / `anyOf` (alternation), shallow `allOf` (merged objects)
  - `$ref` into `#/$defs/...` or `#/definitions/...` (incl. recursion)
  - objects: `properties` with `required` honored — optional properties
    may be omitted (the emitted rule keeps commas balanced); property
    order = required-first declaration order, overridable via prop_order
  - `additionalProperties`/bare `object`/`{}` fall back to free-form
    JSON value rules (same shape as grammars/json.gbnf)
  - arrays: `items`, `prefixItems`, `minItems` / `maxItems`
  - strings: `minLength` / `maxLength`

Whitespace between tokens is constrained to at most one space, matching
the reference's SPACE_RULE stance (prevents infinite-whitespace
runaway). The output always defines a `root` rule.
"""

from __future__ import annotations

import json
import re

_PRIMITIVES = {
    "space": '" "?',
    "boolean": '("true" | "false") space',
    "number": '"-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? '
              '([eE] [-+]? [0-9]+)? space',
    "integer": '"-"? ("0" | [1-9] [0-9]*) space',
    "null": '"null" space',
    "string": '"\\"" string-char* "\\"" space',
    "string-char": '[^"\\\\] | "\\\\" (["\\\\/bfnrt] | "u" [0-9a-fA-F] '
                   '[0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])',
}

# free-form JSON value rules, used for untyped schemas and
# additionalProperties; equivalent shape to grammars/json.gbnf
_VALUE_RULES = {
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space (string ":" space value ("," space string ":" '
              'space value)*)? "}" space',
    "array": '"[" space (value ("," space value)*)? "]" space',
}

_NAME_RE = re.compile(r"[^a-zA-Z0-9-]+")
_PENDING = "<pending>"   # reserved-rule placeholder (see _resolve_ref)


def _literal(value) -> str:
    """A GBNF string literal matching json.dumps(value) exactly."""
    text = json.dumps(value)
    out = text.replace("\\", "\\\\").replace('"', '\\"') \
              .replace("\r", "\\r").replace("\n", "\\n")
    return f'"{out}"'


class SchemaCompiler:
    def __init__(self, schema: dict, prop_order: list[str] | None = None):
        self.schema = schema
        self.prop_order = {n: i for i, n in enumerate(prop_order or [])}
        self.rules: dict[str, str] = {"space": _PRIMITIVES["space"]}
        self._by_body: dict[str, str] = {}       # rule body -> rule name
        self._ref_names: dict[str, str] = {}     # $ref pointer -> rule name

    # -- rule table -----------------------------------------------------------

    def _prim(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = _PRIMITIVES[name]
            if name == "string":
                self.rules["string-char"] = _PRIMITIVES["string-char"]
        return name

    def _value_rules(self) -> str:
        for n in ("string", "number", "boolean", "null"):
            self._prim(n)
        for n, body in _VALUE_RULES.items():
            self.rules.setdefault(n, body)
        return "value"

    def _add(self, name: str, body: str) -> str:
        """Install a rule, deduplicating identical bodies and resolving
        name collisions with numeric suffixes."""
        name = _NAME_RE.sub("-", name).strip("-") or "rule"
        if self.rules.get(name) is _PENDING:
            self.rules[name] = body          # fill the reserved slot
            self._by_body.setdefault(body, name)
            return name
        if body in self._by_body and name != "root":
            return self._by_body[body]
        if name in self.rules and self.rules[name] != body:
            i = 1
            while f"{name}{i}" in self.rules:
                i += 1
            name = f"{name}{i}"
        self.rules[name] = body
        if name != "root":
            self._by_body.setdefault(body, name)
        return name

    # -- schema walk ----------------------------------------------------------

    def _deref(self, ref: str):
        if not isinstance(ref, str) or not ref.startswith("#/"):
            raise ValueError(f"only local $ref supported, got {ref!r}")
        node = self.schema
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"unresolvable $ref {ref!r}")
            node = node[part]
        return node

    def _resolve_ref(self, ref: str, name: str) -> str:
        if ref in self._ref_names:
            return self._ref_names[ref]
        node = self._deref(ref)
        rule_name = _NAME_RE.sub("-", ref.rsplit("/", 1)[-1]) or name
        # pre-register so recursive schemas terminate; the reserved name
        # must be FRESH — recursion references are emitted against it
        # before the body lands, so a collision with an existing rule
        # would silently point the recursion at the wrong definition
        if rule_name in self.rules:
            i = 1
            while f"{rule_name}{i}" in self.rules:
                i += 1
            rule_name = f"{rule_name}{i}"
        self.rules[rule_name] = _PENDING
        self._ref_names[ref] = rule_name
        final = self.visit(node, rule_name)
        if self.rules.get(rule_name) is _PENDING:
            # body was deduplicated into another rule: alias the name
            self.rules[rule_name] = final
        self._ref_names[ref] = rule_name
        return rule_name

    def visit(self, schema, name: str) -> str:
        """Compile one schema node; returns the rule name to reference."""
        if schema is True or schema == {}:
            return self._value_rules()
        if schema is False:
            raise ValueError("`false` schema matches nothing")
        if not isinstance(schema, dict):
            raise ValueError(f"unsupported schema node: {schema!r}")

        if "$ref" in schema:
            return self._resolve_ref(schema["$ref"], name)
        if "const" in schema:
            return self._add(name, f'{_literal(schema["const"])} space')
        if "enum" in schema:
            alts = " | ".join(_literal(v) for v in schema["enum"])
            return self._add(name, f"({alts}) space")
        for key in ("oneOf", "anyOf"):
            if key in schema:
                alts = " | ".join(
                    self.visit(sub, f"{name}-alt{i}")
                    for i, sub in enumerate(schema[key]))
                return self._add(name, alts)
        if "allOf" in schema:
            merged: dict = {}
            for sub in schema["allOf"]:
                if "$ref" in sub:
                    sub = self._deref(sub["$ref"])
                if sub.get("type", "object") != "object":
                    raise ValueError("allOf supports object members only")
                merged.setdefault("properties", {}).update(
                    sub.get("properties", {}))
                merged.setdefault("required", []).extend(
                    sub.get("required", []))
            merged["type"] = "object"
            return self.visit(merged, name)

        stype = schema.get("type")
        if isinstance(stype, list):
            alts = " | ".join(self.visit(dict(schema, type=t), f"{name}-{t}")
                              for t in stype)
            return self._add(name, alts)

        if stype == "object" or (stype is None and "properties" in schema):
            return self._object(schema, name)
        if stype == "array" or (stype is None and (
                "items" in schema or "prefixItems" in schema)):
            return self._array(schema, name)
        if stype == "string":
            return self._string(schema, name)
        if stype in ("number", "integer", "boolean", "null"):
            return self._prim(stype)
        if stype is None:
            return self._value_rules()
        raise ValueError(f"unsupported schema type {stype!r}")

    # -- composite rules ------------------------------------------------------

    def _object(self, schema: dict, name: str) -> str:
        props = schema.get("properties")
        if not props:
            # free-form object (additionalProperties or bare {"type":"object"})
            self._value_rules()
            return "object"
        required = set(schema.get("required", list(props)))
        order = sorted(props, key=lambda p: (
            self.prop_order.get(p, len(self.prop_order)),
            list(props).index(p)))

        def kv(prop: str) -> str:
            rule = self.visit(props[prop], f"{name}-{prop}")
            return f'{_literal(prop)} space ":" space {rule}'

        req = [kv(p) for p in order if p in required]
        opt = [kv(p) for p in order if p not in required]
        if req:
            body = req[0]
            body += "".join(f' "," space {k}' for k in req[1:])
            body += "".join(f' ("," space {k})?' for k in opt)
            inner = body
        else:
            # no required props: alternation on which optional comes first,
            # each followed by an independently-optional comma'd tail
            alts = []
            for i in range(len(opt)):
                tail = "".join(f' ("," space {k})?' for k in opt[i + 1:])
                alts.append(f"{opt[i]}{tail}")
            inner = "(" + " | ".join(alts) + ")?" if alts else ""
        return self._add(name, f'"{{" space {inner} "}}" space'.strip())

    def _array(self, schema: dict, name: str) -> str:
        if "prefixItems" in schema:
            parts = [self.visit(sub, f"{name}-item{i}")
                     for i, sub in enumerate(schema["prefixItems"])]
            seq = ' "," space '.join(parts)
            rest = ""
            if schema.get("items") not in (None, False):
                extra = self.visit(
                    schema["items"] if isinstance(schema.get("items"), dict)
                    else {}, f"{name}-item")
                rest = f' ("," space {extra})*'
            return self._add(name, f'"[" space {seq}{rest} "]" space')
        item = self.visit(schema.get("items", {}) or {}, f"{name}-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        more = f'("," space {item})'
        if hi is None:
            inner = (f"{item} {more}*" if lo <= 1
                     else f"{item} {' '.join([more] * (lo - 1))} {more}*")
            if lo == 0:
                inner = f"({inner})?"
        else:
            hi = int(hi)
            if hi < lo:
                raise ValueError("maxItems < minItems")
            if hi == 0:
                inner = ""
            else:
                inner = f"{item}"
                inner += "".join([f" {more}"] * max(lo - 1, 0))
                inner += "".join([f" {more}?"] * (hi - max(lo, 1)))
                if lo == 0:
                    inner = f"({inner})?"
        return self._add(name, f'"[" space {inner} "]" space'
                         .replace("  ", " "))

    def _string(self, schema: dict, name: str) -> str:
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        if lo == 0 and hi is None:
            return self._prim("string")
        self._prim("string")                   # installs string-char
        ch = "string-char"
        body = " ".join([f"({ch})"] * lo)
        if hi is None:
            body = f"{body} ({ch})*" if lo else f"({ch})*"
        else:
            body += "".join([f" ({ch})?"] * (int(hi) - lo))
        return self._add(name, f'"\\"" {body} "\\"" space')

    # -- output ---------------------------------------------------------------

    def compile(self) -> str:
        top = self.visit(self.schema, "root")
        if top != "root":
            self.rules["root"] = top
        order = ["root"] + sorted(n for n in self.rules if n != "root")
        return "\n".join(f"{n} ::= {self.rules[n]}" for n in order) + "\n"


def schema_to_grammar(schema, prop_order: list[str] | None = None) -> str:
    """Compile a JSON schema (dict or JSON text) to GBNF grammar text."""
    if isinstance(schema, (str, bytes)):
        schema = json.loads(schema)
    return SchemaCompiler(schema, prop_order).compile()


def json_grammar() -> str:
    """Grammar for arbitrary JSON (response_format: json_object)."""
    return schema_to_grammar({})


def main(argv=None) -> int:
    import argparse
    import sys
    p = argparse.ArgumentParser(
        prog="tpulamm-json-schema-to-grammar",
        description="Generate a GBNF grammar (for --grammar-file / the "
                    "server grammar param) constraining output to a JSON "
                    "schema")
    p.add_argument("schema", help='schema file, or "-" for stdin')
    p.add_argument("--prop-order", default="",
                   help="comma-separated property-name precedence")
    args = p.parse_args(argv)
    text = sys.stdin.read() if args.schema == "-" else \
        open(args.schema).read()
    order = [s for s in args.prop_order.split(",") if s]
    sys.stdout.write(schema_to_grammar(text, order))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
