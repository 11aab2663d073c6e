"""DFA x vocab -> the dense device tables, plus constraint-spec plumbing.

`compile_constraint` is the one host-side entry: a normalized spec
(parse_constraint_spec) compiles through schema.py -> regex.py into a
byte DFA, then a byte-level TRIE over the token vocabulary is walked once
per live DFA state to produce

  * mask [num_states, vocab] bool — token allowed in state s iff its whole
    byte string stays inside LIVE DFA states (an accept state stays
    reachable), plus EOS exactly in accept states;
  * next_state [num_states, vocab] int32 — where the token's bytes land
    (0 where disallowed — unreachable by construction, the mask bans it).

The trie shares prefix walks across the vocab (one DFS per state, dead
byte prunes the whole subtree) — compile cost is O(states x trie nodes)
instead of O(states x vocab x token_len).

EOS forcing needs no special case: an accept state with no live outgoing
byte has an all-False row except EOS, so the masked sampler can only end
the generation there. A non-accepting state whose row comes out all-False
(possible when no single token covers a required byte sequence) gets EOS
as a documented escape hatch — strictly better than the NaN an all -inf
logits row would produce.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np

from .regex import compile_regex
from .schema import constraint_to_regex
from .vocab import TokenVocab


class ConstraintError(ValueError):
    """Malformed constraint spec (serving edge answers 400)."""


def parse_constraint_spec(raw) -> dict:
    """Validate a wire-format constraint into {"kind": ..., ...}.

    Wire format (the /generate "constraint" field): an object with exactly
    one of `regex` (string), `choices` (non-empty list of non-empty
    strings), `json_schema` (object), or `json_object` (true). The OpenAI
    `response_format` translator produces the same normalized dict.
    """
    if not isinstance(raw, dict):
        raise ConstraintError(
            f"constraint must be an object, got {type(raw).__name__}"
        )
    keys = [k for k in ("regex", "choices", "json_schema", "json_object")
            if raw.get(k) is not None]
    unknown = set(raw) - {"regex", "choices", "json_schema", "json_object"}
    if unknown:
        raise ConstraintError(
            f"unknown constraint fields {sorted(unknown)}"
        )
    if len(keys) != 1:
        raise ConstraintError(
            "constraint needs exactly one of 'regex', 'choices', "
            "'json_schema', 'json_object'"
        )
    kind = keys[0]
    if kind == "regex":
        pat = raw["regex"]
        if not isinstance(pat, str) or not pat:
            raise ConstraintError("constraint regex must be a non-empty string")
        return {"kind": "regex", "pattern": pat}
    if kind == "choices":
        ch = raw["choices"]
        if not (isinstance(ch, list) and ch
                and all(isinstance(c, str) and c for c in ch)):
            raise ConstraintError(
                "constraint choices must be a non-empty list of non-empty "
                "strings"
            )
        return {"kind": "choices", "choices": list(ch)}
    if kind == "json_schema":
        sch = raw["json_schema"]
        if not isinstance(sch, dict):
            raise ConstraintError("json_schema must be a schema object")
        return {"kind": "json_schema", "schema": sch}
    if raw["json_object"] is not True:
        raise ConstraintError("json_object must be true")
    return {"kind": "json_object"}


def constraint_key(spec: dict) -> str:
    """Canonical hash of a normalized spec — the compiled-artifact cache
    key (engine LRU + the continuous fleet's residency registry)."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass
class CompiledConstraint:
    """The device-ready artifact. State 0 is the DFA start state."""

    mask: np.ndarray  # [S, V] bool
    next_state: np.ndarray  # [S, V] int32
    start: int
    key: str
    spec: dict
    # device -> (mask, next_state) tensors (device_tables)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_states(self) -> int:
        return self.mask.shape[0]

    def device_tables(self, device) -> tuple:
        """(mask [S, V] bool, next_state [S, V] int32) as torch tensors on
        `device`, uploaded once per artifact and device (the engine's
        artifact cache keeps them warm across requests). int32 suffices:
        the transitions index rows of an [S, V] table with S <=
        MAX_DFA_STATES, and the gathers take int32 row indices."""
        import torch

        dev = torch.device(device)
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = (torch.from_numpy(self.mask).to(dev),
                              torch.from_numpy(self.next_state).to(dev))
        return self._dev[key]

    def state_bias(self, state: int) -> np.ndarray:
        """[V] f32 added to the PREFILL logits when the FSM sits at
        `state`: 0 where the state allows the token, a -1e9 floor
        otherwise — rides the existing logit_bias operand, so constrained
        prefill reuses the already-compiled bias program variants. The
        scheduler's crash-recovery continuation prefill samples from a
        mid-constraint state (the DFA advanced over the salvaged tokens),
        hence the state parameter."""
        return np.where(self.mask[state], 0.0, -1e9).astype(np.float32)

    def start_bias(self) -> np.ndarray:
        """state_bias at the DFA start state (the cold-admission case:
        the first token is sampled by prefill, before any decode-loop
        state exists)."""
        return self.state_bias(self.start)

    def advance(self, state: int, token_id: int) -> int:
        """Host-side single-step advance (admission / chunked-stop paths)."""
        return int(self.next_state[state, token_id])


class _Trie:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict = {}
        self.token_ids: list = []


def _build_trie(vocab: TokenVocab) -> _Trie:
    root = _Trie()
    for tid, bs in enumerate(vocab.tokens):
        if not bs:
            continue
        node = root
        for b in bs:
            nxt = node.children.get(b)
            if nxt is None:
                nxt = node.children[b] = _Trie()
            node = nxt
        node.token_ids.append(tid)
    return root


def compile_constraint(raw_or_spec: dict, vocab: TokenVocab,
                       trie: Optional[_Trie] = None) -> CompiledConstraint:
    """Wire-format or normalized spec -> CompiledConstraint.

    Raises ConstraintError (bad spec), SchemaError (unsupported schema),
    or RegexError (unsupported/oversized pattern) — all ValueError
    subclasses, so the engine's invalid_request envelope covers them.
    """
    spec = (
        raw_or_spec if "kind" in raw_or_spec
        else parse_constraint_spec(raw_or_spec)
    )
    dfa = compile_regex(constraint_to_regex(spec))
    if trie is None:
        trie = _build_trie(vocab)
    S, V = dfa.n_states, vocab.vocab_size
    mask = np.zeros((S, V), bool)
    nxt = np.zeros((S, V), np.int32)
    live_states = np.flatnonzero(dfa.live)
    trans = dfa.trans
    live = dfa.live

    for s in live_states:
        # iterative DFS over (trie node, dfa state) — dead bytes prune
        # whole subtrees, shared prefixes walk once
        stack = [(trie, int(s))]
        while stack:
            node, st = stack.pop()
            for tid in node.token_ids:
                mask[s, tid] = True
                nxt[s, tid] = st
            for b, child in node.children.items():
                t = int(trans[st, b])
                if t >= 0 and live[t]:
                    stack.append((child, t))

    for e in vocab.eos_ids:
        if 0 <= e < V:
            mask[np.flatnonzero(dfa.accept), e] = True
            nxt[:, e] = np.arange(S, dtype=np.int32)
    # escape hatch: a live non-accept state no token can serve would hand
    # the sampler an all -inf row (NaN); allow EOS there instead
    stuck = ~mask.any(axis=1)
    if stuck.any() and vocab.eos_ids:
        mask[stuck, vocab.eos_ids[0]] = True

    return CompiledConstraint(
        mask=mask, next_state=nxt, start=int(dfa.start),
        key=constraint_key(spec), spec=spec,
    )
