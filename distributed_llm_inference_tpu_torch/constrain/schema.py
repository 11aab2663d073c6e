"""JSON-schema subset / generic-JSON grammar -> regex (schema-guided decoding).

The supported schema subset (the serving contract): `type` object / array /
string / number / integer / boolean / null, `enum`, object `properties` +
`required`, array `items`. Anything else raises SchemaError -> a clean 400
at the serving edge, never a silently-wrong grammar.

Termination discipline: every produced regex is BOUNDED — strings cap at
MAX_STRING_LEN chars, numbers at fixed digit widths, arrays at MAX_ITEMS
elements, and the generic-JSON grammar (`json_object`) recurses to
MAX_DEPTH. A bounded grammar compiles to an ACYCLIC DFA, so constrained
greedy decode provably terminates (the accept-with-no-continuation state
forces EOS) instead of letting the model pad a string literal until the
token budget dies. Output is compact JSON (no inter-token whitespace) for
the same reason: an unconstrained whitespace loop never has to end.

Object semantics: properties are emitted in declaration order, every
declared property present (`required` is validated to be a subset of
`properties`; optional properties are currently always emitted — still
schema-valid, and it keeps the comma grammar regular). This is the same
simplification the early schema-guided-decoding literature ships.
"""

from __future__ import annotations

import json

from .regex import escape_literal

# Bounded-grammar constants. Every counted repetition costs its bound in
# DFA states, and the state count multiplies across schema fields — these
# are sized so a realistic schema stays in the low hundreds of states
# (the [S, V] device tables and the Python trie walk both scale with S).
MAX_STRING_LEN = 24
MAX_ITEMS = 4
MAX_DEPTH = 2
_INT_DIGITS = 9
_FRAC_DIGITS = 4


class SchemaError(ValueError):
    """Unsupported or malformed schema."""


# one JSON string character: anything but quote/backslash/control, or a
# \-escape (JSON's single-char escape list; \uXXXX is omitted — its 4-hex
# tail costs 5 states per string position, a 3x table for a escape the
# sampler never needs since raw UTF-8 is allowed)
_CHAR = r'([^"\\\x00-\x1f]|\\["\\/bfnrt])'
_STRING = f'"{_CHAR}{{0,{MAX_STRING_LEN}}}"'
_INTEGER = f"-?(0|[1-9][0-9]{{0,{_INT_DIGITS - 1}}})"
_NUMBER = (
    f"{_INTEGER}(\\.[0-9]{{1,{_FRAC_DIGITS}}})?([eE][+-]?[0-9]{{1,2}})?"
)
_BOOLEAN = "(true|false)"
_NULL = "null"


def _enum_regex(values: list) -> str:
    if not values:
        raise SchemaError("enum must be a non-empty list")
    alts = []
    for v in values:
        if not isinstance(v, (str, int, float, bool)) and v is not None:
            raise SchemaError(f"enum values must be JSON scalars, got {v!r}")
        alts.append(escape_literal(json.dumps(v)))
    return "(" + "|".join(alts) + ")"


def _object_regex(schema: dict, depth: int) -> str:
    props = schema.get("properties")
    if props is None:
        return _generic_value(depth)  # untyped object: generic, bounded
    if not isinstance(props, dict) or not props:
        raise SchemaError("properties must be a non-empty object")
    required = schema.get("required", [])
    if not isinstance(required, list):
        raise SchemaError("required must be a list")
    unknown = [k for k in required if k not in props]
    if unknown:
        raise SchemaError(
            f"required names {unknown} missing from properties"
        )
    fields = [
        f'"{escape_literal(k)}":{schema_to_regex(v, depth)}'
        for k, v in props.items()
    ]
    return "\\{" + ",".join(fields) + "\\}"


def _array_regex(schema: dict, depth: int) -> str:
    items = schema.get("items")
    item = (
        schema_to_regex(items, depth) if items is not None
        else _generic_value(depth)
    )
    return f"\\[({item}(,{item}){{0,{MAX_ITEMS - 1}}})?\\]"


# the GENERIC grammar (untyped values / json_object mode) multiplies its
# own size once per nesting level, so it runs on tighter bounds than the
# schema-typed grammar: without a schema there is no structure to spend
# states on, only breadth. These also bound the WORST-CASE derivation
# (~160 bytes) — an adversarial argmax must complete its object inside an
# ordinary decode budget, or every truncated reply breaks the
# guaranteed-JSON contract.
_GEN_STRING_LEN = 12
_GEN_ITEMS = 2
_GEN_STRING = f'"{_CHAR}{{0,{_GEN_STRING_LEN}}}"'


def _generic_value(depth: int) -> str:
    """Any JSON value, nesting bounded at `depth` (json_object mode)."""
    scalar = f"({_GEN_STRING}|{_NUMBER}|{_BOOLEAN}|{_NULL})"
    if depth <= 0:
        return scalar
    inner = _generic_value(depth - 1)
    obj = (
        f'\\{{({_GEN_STRING}:{inner}(,{_GEN_STRING}:{inner})'
        f"{{0,{_GEN_ITEMS - 1}}})?\\}}"
    )
    arr = f"\\[({inner}(,{inner}){{0,{_GEN_ITEMS - 1}}})?\\]"
    return f"({scalar}|{obj}|{arr})"


def schema_to_regex(schema: dict, depth: int = MAX_DEPTH) -> str:
    if not isinstance(schema, dict):
        raise SchemaError(f"schema must be an object, got {type(schema).__name__}")
    if depth < 0:
        raise SchemaError(f"schema nests deeper than {MAX_DEPTH}")
    if "enum" in schema:
        return _enum_regex(schema["enum"])
    t = schema.get("type")
    if t is None:
        return _generic_value(min(depth, MAX_DEPTH))
    if isinstance(t, list):
        return "(" + "|".join(
            schema_to_regex({**schema, "type": x}, depth) for x in t
        ) + ")"
    if t == "object":
        return _object_regex(schema, depth - 1)
    if t == "array":
        return _array_regex(schema, depth - 1)
    if t == "string":
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _BOOLEAN
    if t == "null":
        return _NULL
    raise SchemaError(f"unsupported schema type {t!r}")


def constraint_to_regex(spec: dict) -> str:
    """Normalized constraint spec (tables.parse_constraint_spec) -> the one
    regex everything compiles through."""
    kind = spec["kind"]
    if kind == "regex":
        return spec["pattern"]
    if kind == "choices":
        return "(" + "|".join(escape_literal(c) for c in spec["choices"]) + ")"
    if kind == "json_schema":
        return schema_to_regex(spec["schema"])
    if kind == "json_object":
        # a generic JSON OBJECT (OpenAI json_object mode promises an
        # object, not any value), members bounded like _generic_value
        inner = _generic_value(MAX_DEPTH - 1)
        return (
            f'\\{{({_GEN_STRING}:{inner}(,{_GEN_STRING}:{inner})'
            f"{{0,{_GEN_ITEMS - 1}}})?\\}}"
        )
    raise SchemaError(f"unknown constraint kind {kind!r}")
