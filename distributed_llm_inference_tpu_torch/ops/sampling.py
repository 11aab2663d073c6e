"""Token sampling: temperature / top-k / top-p / min-p / penalties /
logit bias / greedy (the JAX package's ops/sampling.py in PyTorch).

The knobs may be Python numbers (one request) or tensors that broadcast
against the logits' leading axes (per-row knobs, e.g. [B, 1]). Random
draws come from an explicit `torch.Generator`, so a fixed seed gives a
fixed stream; it is not the JAX package's stream (the two RNGs differ),
which is why the tests hold the filters to the JAX ones on the same
logits and compare greedy tokens, never sampled ones.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def _t(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype or like.dtype, device=like.device)


def apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
    """logits / temperature, with t floored at 1e-6."""
    return logits / _t(temperature, logits).clamp_min(1e-6)


def top_k_filter(logits: torch.Tensor, k) -> torch.Tensor:
    """Keep the k highest logits (ties at the k-th value kept), the rest
    to NEG_INF; k <= 0 disables."""
    vocab = logits.shape[-1]
    k = _t(k, logits, torch.int64)
    k_eff = k.clamp(1, vocab)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.broadcast_to(k_eff - 1, logits.shape[:-1] + (1,))
    threshold = torch.gather(sorted_logits, -1, idx)
    filtered = torch.where(logits < threshold, NEG_INF, logits)
    return torch.where(k <= 0, logits, filtered)


def _descending(logits: torch.Tensor):
    """Descending sort with the JAX package's tie order (its reversed
    stable ascending argsort puts the LAST of equal values first)."""
    flipped = torch.flip(logits, dims=(-1,))
    sorted_logits, idx = torch.sort(flipped, dim=-1, descending=True, stable=True)
    return sorted_logits, logits.shape[-1] - 1 - idx


def top_p_filter(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filtering: drop tokens whose cumulative probability
    exceeds p, shifted one slot so the first token over it is kept;
    p >= 1 disables."""
    sorted_logits, sort_idx = _descending(logits)
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    remove = cum > _t(p, cum)
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    sorted_filtered = torch.where(remove, NEG_INF, sorted_logits)
    filtered = torch.empty_like(sorted_filtered).scatter_(-1, sort_idx, sorted_filtered)
    return torch.where(_t(p, logits) >= 1.0, logits, filtered)


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for tokens present in the
    context, positive logits divide by the penalty, negative multiply.
    penalty <= 0 or == 1 disables; presence: [..., V] bool."""
    p = _t(penalty, logits)
    penalized = torch.where(logits > 0, logits / p, logits * p)
    out = torch.where(presence, penalized, logits)
    return torch.where((p <= 0) | (p == 1.0), logits, out)


def apply_oai_penalties(logits: torch.Tensor, counts: torch.Tensor,
                        freq_penalty, pres_penalty) -> torch.Tensor:
    """OpenAI penalties over generated-token counts:
    logits -= freq * count + pres * (count > 0); 0.0 disables either."""
    f = _t(freq_penalty, logits, torch.float32)
    pr = _t(pres_penalty, logits, torch.float32)
    c = counts.float()
    out = logits - f * c - pr * (c > 0).float()
    return torch.where((f == 0.0) & (pr == 0.0), logits, out)


def min_p_filter(logits: torch.Tensor, min_p) -> torch.Tensor:
    """HF MinPLogitsWarper: drop tokens below min_p * max_prob;
    min_p <= 0 disables."""
    probs = torch.softmax(logits.float(), dim=-1)
    mp = _t(min_p, probs)
    floor = mp * probs.amax(dim=-1, keepdim=True)
    filtered = torch.where(probs < floor, NEG_INF, logits)
    return torch.where(mp <= 0.0, logits, filtered)


def sample_token(
    generator: torch.Generator,
    logits: torch.Tensor,
    temperature,
    top_k,
    top_p,
    greedy,
    min_p=None,
    rep_penalty=None,
    freq_penalty=None,
    pres_penalty=None,
    presence: torch.Tensor = None,
    counts: torch.Tensor = None,
    bias: torch.Tensor = None,
    allowed: torch.Tensor = None,
) -> torch.Tensor:
    """Full sampling stack -> int64 token ids, shape logits.shape[:-1].

    Order as in the JAX package: logit bias on the raw logits, then the
    repetition penalty and the OpenAI penalties (these apply to the greedy
    argmax too), then the grammar-constraint mask `allowed` ([..., V]
    bool, None = unconstrained; constrain/): disallowed tokens drop to
    NEG_INF, so a +100 bias never resurrects one and the greedy argmax
    obeys it too; then greedy bypass (a true argmax, first index on ties)
    or the warpers — temperature, top-k, top-p, min-p over ONE descending
    sort — and a categorical draw from `generator`."""
    logits = logits.float()
    if bias is not None:
        logits = logits + bias.float()
    if rep_penalty is not None and presence is not None:
        logits = apply_repetition_penalty(logits, presence, rep_penalty)
    if counts is not None and freq_penalty is not None:
        logits = apply_oai_penalties(logits, counts, freq_penalty, pres_penalty)
    if allowed is not None:
        # the table compiler keeps >= 1 allowed token in every row (EOS at
        # worst), so a masked row is never all NEG_INF
        logits = torch.where(allowed, logits, NEG_INF)
    greedy_t = torch.as_tensor(greedy)
    if greedy_t.dim() == 0 and bool(greedy_t):
        return torch.argmax(logits, dim=-1)
    sampled = _sample_warped(generator, logits, temperature, top_k, top_p, min_p)
    if greedy_t.dim() == 0:
        return sampled
    # per-row flags: mixed rows resolve row-wise
    return torch.where(greedy_t.to(logits.device), torch.argmax(logits, dim=-1), sampled)


def _sample_warped(generator, logits, temperature, top_k, top_p, min_p):
    """The warper pipeline + categorical draw (the non-greedy half of
    sample_token)."""
    scaled = apply_temperature(logits, temperature)
    vocab = scaled.shape[-1]
    sorted_logits, sort_idx = _descending(scaled)
    rank = torch.arange(vocab, device=scaled.device)
    k = _t(top_k, scaled, torch.int64)
    keep = (k <= 0) | (rank < k.clamp(1, vocab))
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    over = cum > _t(top_p, cum)
    keep_p = ~torch.cat([torch.zeros_like(over[..., :1]), over[..., :-1]], dim=-1)
    keep = keep & ((_t(top_p, cum) >= 1.0) | keep_p)
    if min_p is not None:
        mp = _t(min_p, probs)
        keep = keep & ((mp <= 0.0) | (probs >= mp * probs[..., :1]))
    sorted_filtered = torch.where(keep, sorted_logits, NEG_INF)
    # categorical draw by the exponential race: argmax(p / E), E ~ Exp(1)
    race = torch.empty_like(sorted_filtered).exponential_(generator=generator)
    race.clamp_min_(torch.finfo(torch.float32).tiny)
    draw = torch.argmax(torch.softmax(sorted_filtered, dim=-1) / race, dim=-1)
    return torch.gather(sort_idx, -1, draw[..., None])[..., 0]


def top_n_probs(logits: torch.Tensor, n: int = 5):
    """Top-n (prob, token) pairs for debug observability."""
    probs = torch.softmax(logits.float(), dim=-1)
    top = torch.topk(probs, n, dim=-1)
    return top.values, top.indices


def stable_top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values: the order of jax.lax.top_k and
    of jnp.argsort(-x) (a stable sort), which torch.topk does not
    promise. Beams, score alternatives and the MoE router rank by it."""
    idx = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx
