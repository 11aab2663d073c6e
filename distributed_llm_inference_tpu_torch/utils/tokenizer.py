"""Tokenizers.

A copy of the JAX package's utils/tokenizer.py. The HF tokenizer is
optional (used when a local tokenizer directory is given) and a
dependency-free byte-level tokenizer is the offline default, so the whole
serving stack runs with zero network egress.
"""

from __future__ import annotations

from typing import Optional, Sequence


class ByteTokenizer:
    """Reversible byte-level tokenizer: id = byte + 3; 0/1/2 = pad/bos/eos.

    Vocab of 259 fits any model config with vocab_size >= 259; for tiny test
    configs it simply never emits ids above 258.
    """

    OFFSET = 3

    def __init__(self, pad_id: int = 0, bos_id: int = 1, eos_id: int = 2):
        self.pad_token_id = pad_id
        self.bos_token_id = bos_id
        self.eos_token_id = eos_id

    @property
    def vocab_size(self) -> int:
        return 256 + self.OFFSET

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return [self.bos_token_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if i >= self.OFFSET and i < 256 + self.OFFSET
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Thin wrapper over a transformers tokenizer (local files only)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.pad_token_id = (
            self._tok.pad_token_id
            if self._tok.pad_token_id is not None
            else self._tok.eos_token_id
        )
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    @property
    def has_chat_template(self) -> bool:
        return bool(getattr(self._tok, "chat_template", None))

    def apply_chat_template(self, messages: list) -> str:
        """Render [{role, content}, ...] through the tokenizer's own jinja
        chat template (the one the checkpoint shipped with), ending with
        the assistant generation header."""
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )


def load_tokenizer(
    name_or_path: Optional[str] = None,
    *,
    pad_id=0,
    bos_id=1,
    eos_id=2,
    strict: bool = False,
):
    """HF tokenizer when a local path/cache resolves; byte fallback otherwise.

    strict=True re-raises on a failed explicit path instead of silently
    degrading to bytes (serving with the wrong tokenizer produces garbled
    output with status 'success' — a deployment should fail loudly).
    """
    if name_or_path:
        try:
            return HFTokenizer(name_or_path)
        except Exception as e:
            if strict:
                raise
            import logging

            logging.getLogger(__name__).warning(
                "tokenizer '%s' failed to load (%s); falling back to ByteTokenizer",
                name_or_path,
                e,
            )
    return ByteTokenizer(pad_id=pad_id, bos_id=bos_id, eos_id=eos_id)
