"""PyTorch port vs JAX package: the grammar-constraint compiler
(constrain/). The port's regex.py, schema.py and vocab.py are copies and
tables.py / fleet.py upload with torch, so every host-side artifact must
equal the JAX package's array for array over the same TokenVocab:

  * compile_regex's DFA and compile_constraint's mask / next_state / start
    / key / spec for regexes (UTF-8 literals too), choice lists, JSON
    schemas and json_object;
  * TokenVocab.from_tokenizer over the byte tokenizer, an HF tokenizer
    (a stand-in vocabulary in sentencepiece and GPT-2 spellings) and a
    duck-typed one, and _token_str_to_bytes on synthetic strings;
  * the errors (RegexError, SchemaError, ConstraintError, the DFA state
    cap) raised alike, with the same messages;
  * FleetConstraintTable over one scripted acquire / release sequence:
    offsets, refusals, buckets, compaction, numpy tables, stats and the
    three gauges; and the port's static device pair, which must equal the
    numpy tables after every step while keeping its storage.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_llm_inference_tpu import constrain as JC  # noqa: E402
from distributed_llm_inference_tpu.constrain import vocab as JV  # noqa: E402
from distributed_llm_inference_tpu.utils import metrics as JMet  # noqa: E402
from distributed_llm_inference_tpu.utils import tokenizer as JTok  # noqa: E402
from distributed_llm_inference_tpu_torch import constrain as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.constrain import vocab as TV  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import metrics as TMet  # noqa: E402
from distributed_llm_inference_tpu_torch.utils import tokenizer as TTok  # noqa: E402

V = 300  # a vocab wider than the byte tokenizer's 259 ids: ids past it map to None

SPECS = [
    {"regex": r"(red|green|blue)"},
    {"regex": r"[0-9]{2,4}(\.[0-9])?"},
    {"regex": r"-?(0|[1-9][0-9]{0,3})(\.[0-9]{1,2})?"},
    {"regex": r"\w+@\w+\.(com|org)"},
    {"regex": r"[^x-z]{1,3}"},
    {"regex": r"\s*\d\s*"},
    {"regex": r"[0-9]{3}-[0-9]{4}"},
    {"regex": "héllo|日本語|ü+"},  # UTF-8 literals walk their bytes
    {"choices": ["alpha", "beta", "alphabet"]},
    {"choices": ["on", "off", "ñandú"]},
    {"json_object": True},
    {"json_schema": {"type": "object",
                     "properties": {"name": {"type": "string"},
                                    "age": {"type": "integer"}},
                     "required": ["name", "age"]}},
    {"json_schema": {"type": "object",
                     "properties": {"color": {"enum": ["red", "green", "blue"]},
                                    "ok": {"type": "boolean"},
                                    "tags": {"type": "array",
                                             "items": {"type": "string"}}},
                     "required": ["color", "ok"]}},
    {"json_schema": {"type": "array", "items": {"type": "number"}}},
    {"json_schema": {"enum": ["north", "south", 42, True, None]}},
]


def _vocabs(vocab_size=V, eos=(2,), special=(0, 1)):
    """The same byte-tokenizer vocabulary in each package."""
    return (JC.TokenVocab.from_tokenizer(JTok.ByteTokenizer(), vocab_size,
                                         eos_ids=eos, special_ids=special),
            TC.TokenVocab.from_tokenizer(TTok.ByteTokenizer(), vocab_size,
                                         eos_ids=eos, special_ids=special))


def _assert_art_equal(j, t):
    assert np.array_equal(t.mask, j.mask) and t.mask.dtype == j.mask.dtype
    assert np.array_equal(t.next_state, j.next_state)
    assert t.next_state.dtype == j.next_state.dtype == np.int32
    assert (t.start, t.key, t.spec) == (j.start, j.key, j.spec)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: next(iter(s)))
def test_compile_constraint_equals_jax(spec):
    jv, tv = _vocabs()
    assert tv.tokens == jv.tokens and tv.eos_ids == jv.eos_ids
    j = JC.compile_constraint(spec, jv)
    t = TC.compile_constraint(spec, tv)
    _assert_art_equal(j, t)
    # the normalized spec and a caller-built trie give the same artifact
    from distributed_llm_inference_tpu_torch.constrain.tables import _build_trie

    _assert_art_equal(j, TC.compile_constraint(TC.parse_constraint_spec(spec), tv,
                                               _build_trie(tv)))
    # host walks and the first token's bias agree too
    for s in range(j.num_states):
        np.testing.assert_array_equal(t.state_bias(s), j.state_bias(s))
    np.testing.assert_array_equal(t.start_bias(), j.start_bias())


@pytest.mark.parametrize("pattern", [s["regex"] for s in SPECS if "regex" in s])
def test_compile_regex_dfa_equals_jax(pattern):
    j, t = JC.compile_regex(pattern), TC.compile_regex(pattern)
    for f in ("trans", "accept", "live"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.start, t.n_states) == (j.start, j.n_states)
    assert TC.escape_literal(pattern) == JC.escape_literal(pattern)


@pytest.mark.parametrize("spec", SPECS[-5:], ids=lambda s: next(iter(s)))
def test_constraint_to_regex_equals_jax(spec):
    js, ts = JC.parse_constraint_spec(spec), TC.parse_constraint_spec(spec)
    assert ts == js
    assert TC.constraint_to_regex(ts) == JC.constraint_to_regex(js)
    assert TC.constraint_key(ts) == JC.constraint_key(js)


@pytest.mark.parametrize("s", [
    "<0x0A>", "<0xFF>", "<0xZZ>", "▁the", "▁", "▁▁x", "hello", "Ġworld",
    "ĊĠĠ", "âĢľ", "日本", "a▁b", "<s>", "<0x4>",
])
def test_token_str_to_bytes_equals_jax(s):
    assert TV._token_str_to_bytes(s) == JV._token_str_to_bytes(s)


class _FakeHF:
    """A stand-in for a transformers tokenizer: the attributes
    TokenVocab.from_tokenizer reads (vocab_size, all_special_ids,
    convert_ids_to_tokens)."""

    def __init__(self, strs, special):
        self._strs = strs
        self.vocab_size = len(strs)
        self.all_special_ids = list(special)

    def convert_ids_to_tokens(self, ids):
        return [self._strs[i] for i in ids]


HF_STRS = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
           + ["▁the", "▁a", "ing", "Ġworld", "hello", "ĊĠ", "日本", "", "▁▁"])


def _hf(cls, strs, special):
    tok = object.__new__(cls)  # no transformers needed: _tok is all it reads
    tok._tok = _FakeHF(strs, special)
    return tok


class _Duck:
    """A tokenizer of neither class: per-id decode, lossy ids rejected."""

    def decode(self, ids, skip_special_tokens=False):
        i = ids[0]
        if i % 7 == 0:
            raise ValueError("no such id")
        if i % 5 == 0:
            return "�"
        return chr(0x41 + i % 50) * (1 + i % 3)


@pytest.mark.parametrize("which", ["byte", "hf", "duck"])
def test_token_vocab_equals_jax(which):
    if which == "byte":
        pair = (JTok.ByteTokenizer(), TTok.ByteTokenizer())
        size = V
    elif which == "hf":
        pair = (_hf(JTok.HFTokenizer, HF_STRS, (0, 1, 2)),
                _hf(TTok.HFTokenizer, HF_STRS, (0, 1, 2)))
        size = len(HF_STRS) + 3  # a padded model vocab: the tail maps to None
    else:
        pair = (_Duck(), _Duck())
        size = 120
    j = JC.TokenVocab.from_tokenizer(pair[0], size, eos_ids=(2,), special_ids=(0, 1))
    t = TC.TokenVocab.from_tokenizer(pair[1], size, eos_ids=(2,), special_ids=(0, 1))
    assert t.tokens == j.tokens
    assert (t.eos_ids, t.vocab_size) == (j.eos_ids, j.vocab_size)
    assert any(b is not None for b in t.tokens)
    spec = {"regex": "(the|a) (world|hello)!?" if which == "hf" else "[A-Z]{1,6}"}
    _assert_art_equal(JC.compile_constraint(spec, j), TC.compile_constraint(spec, t))


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and message are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("bad", [
    ("regex", r"a(?=b)"), ("regex", r"\1"), ("regex", "("), ("regex", "a{3,2}"),
    ("regex", r"[ab]*a[ab]{15}"),  # the subset construction's state cap
    ("regex", "a{600}"),
    ("spec", "regex"), ("spec", {}), ("spec", {"regex": "a", "choices": ["b"]}),
    ("spec", {"regex": ""}), ("spec", {"choices": []}), ("spec", {"choices": ["a", 3]}),
    ("spec", {"json_object": "yes"}), ("spec", {"json_schema": "x"}),
    ("spec", {"bogus": 1}),
    ("schema", {"type": "tuple"}),
    ("schema", {"type": "object", "properties": {"a": {"type": "string"}},
                "required": ["b"]}),
    ("schema", {"enum": []}), ("schema", {"enum": [{"nested": 1}]}),
], ids=lambda b: f"{b[0]}")
def test_errors_raised_alike(bad):
    kind, arg = bad
    vocabs = _vocabs()

    def run(pkg, vocab):
        if kind == "regex":
            return lambda: pkg.compile_regex(arg)
        if kind == "spec":
            return lambda: pkg.compile_constraint(arg, vocab)
        return lambda: pkg.compile_constraint({"json_schema": arg}, vocab)

    want = _raised(run(JC, vocabs[0]))
    got = _raised(run(TC, vocabs[1]))
    assert want is not None and got == want
    assert got[0] in ("RegexError", "SchemaError", "ConstraintError")
    # each is a ValueError: the engine's invalid_request envelope covers it
    assert issubclass(getattr(TC, got[0]), ValueError)


def _gauges(registry):
    return tuple(registry.get(n).labels().value for n in (
        "dli_constraint_entries_resident", "dli_constraint_states_resident",
        "dli_constraint_backpressure_total"))


def test_fleet_table_scripted_sequence_equals_jax():
    """One scripted acquire / release sequence through both registries:
    every offset or refusal, stats, numpy table and gauge equal; the
    port's device pair equals the numpy tables after every step, and
    keeps one storage throughout (rows rewritten in place; a bucket is a
    view of its first rows)."""
    jv, tv = _vocabs(256, special=(0, 1, 2))
    specs = [{"choices": ["aa"]}, {"choices": ["bbb"]}, {"regex": "[a-z]{28}"},
             {"regex": "[0-9]{3}-[0-9]{4}"}, {"regex": "[a-z]{40}"},
             {"regex": "x{50}"}, {"regex": "[ab]{1,90}"}]
    jarts = [JC.compile_constraint(s, jv) for s in specs]
    tarts = [TC.compile_constraint(s, tv) for s in specs]
    jreg, treg = JMet.MetricsRegistry(), TMet.MetricsRegistry()
    jt = JC.FleetConstraintTable(256, max_states=128, registry=jreg)
    tt = TC.FleetConstraintTable(256, max_states=128, registry=treg)
    script = [("acquire", 0), ("acquire", 0), ("acquire", 1), ("acquire", 2),
              ("release", 0), ("release", 0), ("acquire", 3), ("release", 1),
              ("release", 3), ("release", 0), ("acquire", 2), ("acquire", 4),
              ("acquire", 5), ("release", 2), ("release", 2), ("release", 4),
              ("acquire", 6), ("acquire", 0), ("release", 6), ("release", 0),
              ("acquire", 1), ("release", 9)]
    storage = None
    for op, i in script:
        if op == "acquire":
            assert tt.fits(tarts[i]) == jt.fits(jarts[i])
            assert tt.acquire(tarts[i]) == jt.acquire(jarts[i]), (op, i)
        else:
            key = jarts[i].key if i < len(jarts) else "absent"
            jt.release(key)
            tt.release(key)
        assert tt.stats() == jt.stats() and tt.any_active == jt.any_active
        jm, jtr = jt.numpy_tables()
        tm, ttr = tt.numpy_tables()
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ttr, jtr)
        dm, dtr = tt.device_tables("cpu")
        np.testing.assert_array_equal(dm.numpy(), jm)
        np.testing.assert_array_equal(dtr.numpy(), jtr)
        if storage is None:
            storage = (dm.untyped_storage().data_ptr(), dtr.untyped_storage().data_ptr())
        assert (dm.untyped_storage().data_ptr(),
                dtr.untyped_storage().data_ptr()) == storage
        assert _gauges(treg) == _gauges(jreg)
    assert _gauges(treg)[2] >= 1  # the script met a full table
    assert tt.device_bytes() == 128 * 256 * 5
    assert tt.uploads > 0 and tt.upload_bytes > 0


def test_artifact_device_tables_upload_once():
    _, tv = _vocabs()
    art = TC.compile_constraint({"choices": ["no", "yes"]}, tv)
    m, t = art.device_tables("cpu")
    assert m.dtype == torch.bool and t.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), art.mask)
    np.testing.assert_array_equal(t.numpy(), art.next_state)
    assert art.device_tables(torch.device("cpu"))[0] is m  # cached per device
