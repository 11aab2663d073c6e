"""Grammar-constrained structured-output decoding (the JAX package's
constrain/ in the PyTorch port: regex.py, schema.py and vocab.py are
copies; tables.py and fleet.py upload their tables with torch).

Host-side compiler that turns a constraint spec — a regex, a choice list,
or a JSON schema subset — into a DFA over the tokenizer vocabulary:

  * `regex.py`   — regex subset -> byte-level DFA (Thompson NFA + subset
    construction; full-match semantics);
  * `schema.py`  — JSON-schema subset / generic-JSON grammar -> regex;
  * `vocab.py`   — token id -> byte string extraction (byte fallback,
    HF BPE byte-decoder, sentencepiece);
  * `tables.py`  — DFA x vocab trie -> dense `(num_states, vocab)`
    allowed-mask + transition tables (the arrays shipped to device);
  * `fleet.py`   — per-fleet combined table registry for the continuous
    engine (admission acquires by constraint hash, release frees).

The device side is deliberately tiny: the sampler masks logits with
`mask[state]` and advances `state = trans[state, token]` — two gathers
per decode step on the device, zero host work per token
(ops/sampling.py, engine/generate.py). EOS is only ever allowed in DFA
accept states, and an accept state with no live continuation allows ONLY
EOS — so "force EOS when the grammar is complete" falls out of the table
construction rather than any special-case device code.
"""

from .regex import RegexError, compile_regex, escape_literal
from .schema import SchemaError, constraint_to_regex
from .tables import (
    CompiledConstraint,
    ConstraintError,
    compile_constraint,
    constraint_key,
    parse_constraint_spec,
)
from .vocab import TokenVocab
from .fleet import FleetConstraintTable

__all__ = [
    "CompiledConstraint",
    "ConstraintError",
    "FleetConstraintTable",
    "RegexError",
    "SchemaError",
    "TokenVocab",
    "compile_constraint",
    "compile_regex",
    "constraint_key",
    "constraint_to_regex",
    "escape_literal",
    "parse_constraint_spec",
]
