"""Chat prompt templating (a copy of the JAX package's engine/chat.py).

The TinyLlama-Chat Zephyr-style format is the behavioral spec; other model
families get their own template or passthrough.
"""

from __future__ import annotations

TINYLLAMA_SYSTEM = "You are a helpful assistant."


def format_chat_prompt(
    user_message: str, system: str = TINYLLAMA_SYSTEM, arch: str = "llama",
    template: str = None,
) -> str:
    """TinyLlama chat format — identical layout to the reference's
    format_chat_prompt (orchestration.py:66). GPT-2 has no chat format;
    the raw prompt passes through. template overrides the arch-derived
    default ("tinyllama" | "gemma" | "none"; cfg.chat_template)."""
    if template is None:
        template = "none" if arch == "gpt2" else "tinyllama"
    if template == "none":
        return user_message
    # ONE rendering exists per template: the single-turn format is the
    # multi-turn renderer applied to [system, user] (empty system string =
    # omit/blank the system turn, template-dependent, as before)
    return format_chat_messages(
        [{"role": "system", "content": system},
         {"role": "user", "content": user_message}],
        arch=arch, template=template,
    )


def format_chat_messages(
    messages: list, arch: str = "llama", template: str = None,
) -> str:
    """Render a full OpenAI-style message list ([{role, content}, ...])
    into one prompt string, ending with the assistant generation header.

    Multi-turn generalization of `format_chat_prompt` (the reference only
    ever formats a single user turn, orchestration.py:60-67); the
    single-turn output of both functions is byte-identical per template.
    Roles: "system" (first message only), "user", "assistant".
    """
    if template is None:
        template = "none" if arch == "gpt2" else "tinyllama"
    system = None
    turns = []
    for i, m in enumerate(messages):
        role, content = m.get("role"), m.get("content", "")
        if not isinstance(content, str):
            raise ValueError("message content must be a string")
        if role == "system":
            if i != 0:
                raise ValueError("system message must come first")
            system = content
        elif role in ("user", "assistant"):
            turns.append((role, content))
        else:
            raise ValueError(f"unknown role {role!r}")
    if not turns or turns[-1][0] != "user":
        raise ValueError("messages must end with a user turn")

    if template == "none":
        parts = [system] if system else []
        parts += [c for _, c in turns]
        return "\n".join(parts)
    # non-passthrough templates: same default system text as
    # format_chat_prompt, so single-turn renders stay byte-identical
    if system is None:
        system = TINYLLAMA_SYSTEM
    if template == "gemma":
        out = []
        folded = not system  # system folds into the FIRST USER turn
        for role, content in turns:
            tag = "user" if role == "user" else "model"
            if role == "user" and not folded:
                content = f"{system}\n\n{content}"
                folded = True
            out.append(f"<start_of_turn>{tag}\n{content}<end_of_turn>\n")
        return "".join(out) + "<start_of_turn>model\n"
    if template == "phi3":
        out = [f"<|system|>\n{system}<|end|>\n"] if system else []
        out += [f"<|{role}|>\n{content}<|end|>\n" for role, content in turns]
        return "".join(out) + "<|assistant|>\n"
    if template != "tinyllama":
        raise ValueError(f"unknown chat template {template!r}")
    out = [f"<|system|>\n{system}</s>\n"]
    out += [f"<|{role}|>\n{content}</s>\n" for role, content in turns]
    return "".join(out) + "<|assistant|>\n"
