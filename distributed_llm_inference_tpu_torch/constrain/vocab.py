"""Token id -> byte string extraction for the constraint compiler.

The DFA runs over UTF-8 bytes, so every sampleable token id needs its exact
byte string. Three extraction paths, matching the tokenizers the stack
serves with (utils/tokenizer.py):

  * ByteTokenizer — the offline fallback: id = byte + OFFSET, exact by
    construction;
  * HF fast/BPE tokenizers — GPT-2-style byte-to-unicode vocabularies
    decode through the standard `bytes_to_unicode` inverse map;
    sentencepiece vocabularies map `▁` to space and `<0xNN>` byte
    tokens to their byte;
  * anything else — per-id `decode([id])`, rejected (token unusable under
    constraints) when the round-trip is lossy (U+FFFD).

Tokens that map to None (special tokens, lossy ids, ids past the
tokenizer's range in a padded model vocab) are simply never allowed by any
constraint mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _gpt2_unicode_to_bytes() -> dict:
    """Inverse of the GPT-2 `bytes_to_unicode` table (the printable-char
    embedding every byte-level BPE vocab uses)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_U2B = None


def _token_str_to_bytes(s: str) -> Optional[bytes]:
    """One HF vocab token string -> bytes, or None when unmappable."""
    global _U2B
    if s.startswith("<0x") and s.endswith(">") and len(s) == 6:
        try:
            return bytes([int(s[3:5], 16)])  # sentencepiece byte token
        except ValueError:
            return None
    if "▁" in s:  # sentencepiece word-start marker
        return s.replace("▁", " ").encode("utf-8")
    if _U2B is None:
        _U2B = _gpt2_unicode_to_bytes()
    if all(c in _U2B for c in s):
        return bytes(_U2B[c] for c in s)
    return s.encode("utf-8")


@dataclasses.dataclass
class TokenVocab:
    """Per-id byte strings + the stop/special bookkeeping tables.py needs.

    tokens[i] is the byte string id `i` appends to the output text, or None
    when the id must never be sampled under a constraint (special token,
    lossy mapping, out of tokenizer range).
    """

    tokens: list
    eos_ids: tuple  # allowed exactly in DFA accept states
    vocab_size: int

    @classmethod
    def from_tokenizer(cls, tokenizer, vocab_size: int,
                       eos_ids: tuple, special_ids: tuple) -> "TokenVocab":
        """`eos_ids`: cfg.all_stop_ids — any of them may end a completed
        constraint. `special_ids`: never sampleable (pad/bos + stop ids)."""
        from ..utils.tokenizer import ByteTokenizer, HFTokenizer

        banned = set(int(i) for i in special_ids) | set(
            int(i) for i in eos_ids
        )
        tokens: list = [None] * vocab_size
        if isinstance(tokenizer, ByteTokenizer):
            off = ByteTokenizer.OFFSET
            for i in range(off, min(vocab_size, 256 + off)):
                if i not in banned:
                    tokens[i] = bytes([i - off])
        elif isinstance(tokenizer, HFTokenizer):
            tok = tokenizer._tok
            special = set(
                int(i) for i in getattr(tok, "all_special_ids", []) or []
            ) | banned
            n = min(vocab_size, int(tok.vocab_size))
            strs = tok.convert_ids_to_tokens(list(range(n)))
            for i, s in enumerate(strs):
                if i in special or not isinstance(s, str) or not s:
                    continue
                tokens[i] = _token_str_to_bytes(s)
        else:
            # generic duck-typed tokenizer (tests): per-id decode, lossy
            # round-trips rejected
            for i in range(vocab_size):
                if i in banned:
                    continue
                try:
                    s = tokenizer.decode([i], skip_special_tokens=False)
                except Exception:
                    continue
                if s and "�" not in s:
                    tokens[i] = s.encode("utf-8")
        return cls(tokens=tokens, eos_ids=tuple(int(i) for i in eos_ids),
                   vocab_size=vocab_size)
