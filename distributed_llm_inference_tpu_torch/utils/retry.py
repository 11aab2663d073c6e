"""Shared HTTP retry/backoff policy for every upstream caller.

A copy of the JAX package's utils/retry.py, which imports no jax (the
port copies such modules rather than import the JAX package). Only this
paragraph differs.

One copy of the discipline the serving edge's clients must agree on —
the interactive client (client.py) and the router tier's upstream calls
(serving/router.py) used to need identical Retry-After parsing and
jittered exponential backoff, and duplicated logic is how the two ends
of a retry loop drift apart:

  * 429 (shed load) and 503 (draining replica / deadline / restarting
    scheduler) are the two RETRYABLE statuses the serving edge hands
    out — anything else (400, 500 incl. poison) is the caller's bug or
    a server fault that every retry would hit again.
  * A parseable Retry-After header is SERVER-DIRECTED delay and always
    wins over local backoff: the server knows its own drain/overload
    horizon, the client does not.
  * Local backoff is exponential with FULL JITTER on the upper half, so
    a herd of retrying clients decorrelates instead of re-stampeding.
"""

from __future__ import annotations

import random
from typing import Optional

# the two retryable statuses the serving edge emits (see
# serving/server.py's envelope -> status mapping)
RETRY_STATUSES = (429, 503)

# ceiling on any locally computed delay (seconds)
BACKOFF_CAP_S = 8.0


# jaxlint: decode-unreachable -- client-side policy helper; no in-package caller
def is_retryable(status: int) -> bool:
    """True for the statuses a well-behaved caller may retry blindly."""
    return status in RETRY_STATUSES


def parse_retry_after(value) -> Optional[float]:
    """Seconds from a Retry-After header value, or None when absent or
    unparseable (the HTTP-date form and junk both fall back to local
    backoff — guessing at a malformed server hint is worse than jitter).
    Negative values clamp to 0 (retry immediately)."""
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return None


def backoff_delay(attempt: int, base_s: float = 0.5,
                  cap_s: float = BACKOFF_CAP_S, rng=None) -> float:
    """Jittered exponential delay for the `attempt`-th retry (0-based):
    uniformly drawn from the upper half of min(cap, base * 2^attempt)."""
    upper = min(cap_s, base_s * (2 ** attempt))
    r = (rng or random).random()
    return upper * (0.5 + r / 2)


def retry_delay(attempt: int, retry_after=None, base_s: float = 0.5,
                cap_s: float = BACKOFF_CAP_S, rng=None) -> float:
    """The delay before the `attempt`-th retry: the server-directed
    Retry-After when it parses, else jittered exponential backoff."""
    ra = parse_retry_after(retry_after)
    if ra is not None:
        return ra
    return backoff_delay(attempt, base_s=base_s, cap_s=cap_s, rng=rng)


def overload_retry_after(depth: int, per_cycle: int = 1,
                         cap_s: float = BACKOFF_CAP_S) -> int:
    """Queue-depth-derived Retry-After hint (whole seconds, >= 1) for a
    shed-load rejection: roughly one second per dispatch cycle the
    backlog needs to clear (`depth / per_cycle`), bounded by `cap_s`.
    Deliberately coarse — the point is that a deeper backlog tells
    clients to stay away LONGER, so their backoff is server-directed
    instead of uniformly hammering an overloaded queue."""
    cycles = depth // max(1, int(per_cycle)) + 1
    return int(min(cap_s, float(cycles)))
