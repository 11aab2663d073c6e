"""Client library + interactive CLI (the source system's layer L5, its
Test.py client), for the PyTorch port's server.

A copy of the JAX package's client.py, which imports no jax (the port
copies such modules rather than import the JAX package): only this
paragraph, the first line, one comment and the CLI's description
differ, and its
imports point at the port's own utils/retry.py and utils/tracing.py.

    python -m distributed_llm_inference_tpu_torch.client \\
        --url http://127.0.0.1:5000 --prompt "Hello" --max-tokens 20 --stream

Same flow as DistributedLLMClient: health check, worker sweep, generate
with perf-stat printing (Test.py:83-88), an interactive chat REPL with
`workers`/`health`/`quit` commands (Test.py:105-144), and a 3-option menu
(Test.py:147-188). stdlib urllib only — no requests dependency.
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request
from typing import Any, Optional

# bounded-retry policy shared with the router tier (utils/retry.py):
# 429/503 retryable, Retry-After wins over jittered exponential backoff
from .utils.retry import RETRY_STATUSES, retry_delay
from .utils.tracing import SpanContext


class DistributedLLMClient:
    def __init__(self, base_url: str = "http://127.0.0.1:5000", timeout: float = 200.0,
                 max_retries: int = 3, retry_backoff_s: float = 0.5):
        # 200 s default mirrors Test.py:71's request timeout; a warm server
        # answers in milliseconds-to-seconds, but a first kernel build is slow.
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # bounded retry on 429/503 with jittered exponential backoff,
        # honoring the server's Retry-After (the drain path sends one);
        # 0 retries restores the old fail-fast behavior
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # trace id of the most recent POST — the client ROOTS each
        # request's trace (W3C traceparent), so the whole fleet hop chain
        # is fetchable afterwards at GET /debug/traces/{last_trace_id}
        self.last_trace_id: Optional[str] = None

    def _trace_headers(self) -> dict:
        ctx = SpanContext.new_root()
        self.last_trace_id = ctx.trace_id
        return {"Content-Type": "application/json",
                "traceparent": ctx.header()}

    def _get(self, path: str, timeout: Optional[float] = None) -> dict:
        with urllib.request.urlopen(
            f"{self.base_url}{path}", timeout=timeout or self.timeout
        ) as r:
            return json.loads(r.read())

    def _retry_delay(self, attempt: int, retry_after) -> float:
        """Server-directed delay when Retry-After parses, else jittered
        exponential backoff (utils/retry.py — the one copy of the policy
        this client shares with the router's upstream calls)."""
        return retry_delay(attempt, retry_after, base_s=self.retry_backoff_s)

    def _post(self, path: str, payload: dict, timeout: Optional[float] = None) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(payload).encode(),
            headers=self._trace_headers(),
            method="POST",
        )
        for attempt in range(self.max_retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=timeout or self.timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except Exception:
                    body = {"error": str(e), "status": "failed"}
                if e.code in RETRY_STATUSES and attempt < self.max_retries:
                    time.sleep(self._retry_delay(
                        attempt, e.headers.get("Retry-After")
                    ))
                    continue
                return body
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                # connection refused / timeout: error envelope, not a traceback
                # (keeps the interactive REPL alive across server restarts).
                # NOT retried: a timed-out POST may have generated server-side.
                return {"error": f"connection failed: {e}", "status": "failed"}
        return {"error": "retries exhausted", "status": "failed"}

    # -- reference-parity surface (Test.py:18-103) --------------------------
    def check_health(self) -> dict:
        """Orchestrator liveness (Test.py:18-33)."""
        try:
            return self._get("/health", timeout=5)
        except Exception as e:
            return {"status": "offline", "error": str(e)}

    def check_workers(self) -> dict:
        """Per-stage health sweep (Test.py:35-52)."""
        try:
            return self._get("/workers", timeout=5)
        except Exception as e:
            return {"error": str(e)}

    def generate(
        self,
        prompt: str,
        max_tokens: int = 20,
        temperature: float = 0.7,
        verbose: bool = True,
        **kw: Any,
    ) -> dict:
        """Generate + print perf stats (Test.py:54-103)."""
        result = self._post(
            "/generate",
            {"prompt": prompt, "max_tokens": max_tokens, "temperature": temperature, **kw},
        )
        if verbose:
            if result.get("status") == "success":
                print(f"\n🤖 Response: {result.get('response', '')}")
                print(
                    f"   ⏱  {result.get('time_taken')} | "
                    f"{result.get('tokens_generated')} tokens | "
                    f"{result.get('tokens_per_sec')} tok/s | "
                    f"TTFT {result.get('ttft_s')}s"
                )
                # disaggregated serving detail (router envelopes): which
                # replica ran the token loop, and whether its prefix
                # arrived over the KV fabric instead of a local prefill
                extras = []
                if result.get("replica"):
                    extras.append(f"replica {result['replica']}")
                if result.get("kv_fabric_blocks"):
                    extras.append(
                        f"{result['kv_fabric_blocks']} KV blocks via fabric"
                    )
                if result.get("prefix_cached_tokens"):
                    extras.append(
                        f"{result['prefix_cached_tokens']} prefix tokens cached"
                    )
                if extras:
                    print(f"   🔀 {' | '.join(extras)}")
            else:
                print(f"\n❌ {result.get('error', 'unknown error')}")
        return result

    def generate_stream(self, prompt: str, max_tokens: int = 20, **kw: Any):
        """Stream a generation: print deltas as they arrive (NDJSON lines
        from a --continuous server), return the final envelope.

        Retry discipline: only a PRE-STREAM rejection (HTTP 429/503 — the
        stream never opened, zero output reached us) is retried. Once the
        200 stream opens, NOTHING is retried: partial generation output
        may already be on the user's screen, and replaying the request
        would bill and print it twice. Mid-stream failures arrive as a
        normal done-event and are returned as-is."""
        req = urllib.request.Request(
            f"{self.base_url}/generate",
            data=json.dumps(
                {"prompt": prompt, "max_tokens": max_tokens, "stream": True, **kw}
            ).encode(),
            headers=self._trace_headers(),
            method="POST",
        )
        final: dict = {}
        for attempt in range(self.max_retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    print("\n🤖 ", end="", flush=True)
                    for line in r:
                        ev = json.loads(line)
                        if ev.get("done"):
                            final = ev
                            break
                        print(ev.get("delta", ""), end="", flush=True)
                # failures arrive as a normal done-event over HTTP 200 (queue
                # full, deadline) — and a dropped connection leaves final empty
                if final.get("status") == "success":
                    print(
                        f"\n   ⏱  {final.get('time_taken')} | "
                        f"{final.get('tokens_generated')} tokens | "
                        f"{final.get('tokens_per_sec')} tok/s | "
                        f"TTFT {final.get('ttft_s')}s"
                    )
                else:
                    print(f"\n❌ {final.get('error', 'stream ended without a result')}")
            except urllib.error.HTTPError as e:
                try:
                    final = json.loads(e.read())
                except Exception:
                    final = {"error": str(e), "status": "failed"}
                if e.code in RETRY_STATUSES and attempt < self.max_retries:
                    time.sleep(self._retry_delay(
                        attempt, e.headers.get("Retry-After")
                    ))
                    continue
                print(f"\n❌ {final.get('error', 'unknown error')}")
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                # never retried: the stream may have started (partial output)
                final = {"error": f"connection failed: {e}", "status": "failed"}
                print(f"\n❌ {final['error']}")
            return final
        return final

    # -- interactive REPL (Test.py:105-144) ---------------------------------
    def interactive_chat(self):
        print("\n💬 Interactive chat — 'workers', 'health', or 'quit'")
        while True:
            try:
                line = input("\nYou: ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not line:
                continue
            if line.lower() in ("quit", "exit"):
                break
            if line.lower() == "workers":
                print(json.dumps(self.check_workers(), indent=2, default=str))
                continue
            if line.lower() == "health":
                print(json.dumps(self.check_health(), indent=2))
                continue
            self.generate(line, max_tokens=15)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(
        description="distributed_llm_inference_tpu_torch client")
    ap.add_argument("--url", default="http://127.0.0.1:5000")
    ap.add_argument("--prompt", default=None, help="one-shot prompt (skips menu)")
    ap.add_argument("--max-tokens", type=int, default=20)
    ap.add_argument(
        "--stream", action="store_true",
        help="stream tokens as they decode (server must run --continuous)",
    )
    ap.add_argument(
        "--json", action="store_true", dest="constrain_json",
        help="grammar-constrain the output to valid JSON (server-side "
             "token masking, not prompting)",
    )
    ap.add_argument(
        "--regex", default=None, metavar="PATTERN", dest="constrain_regex",
        help="grammar-constrain the output to fullmatch PATTERN",
    )
    args = ap.parse_args(argv)

    kw = {}
    if args.constrain_regex is not None:
        kw["constraint"] = {"regex": args.constrain_regex}
    elif args.constrain_json:
        kw["constraint"] = {"json_object": True}

    client = DistributedLLMClient(args.url)
    if args.prompt is not None:
        if args.stream:
            client.generate_stream(args.prompt, max_tokens=args.max_tokens, **kw)
        else:
            client.generate(args.prompt, max_tokens=args.max_tokens, **kw)
        return

    # 3-option menu (Test.py:147-188)
    print("1) single prompt  2) interactive chat  3) quick test")
    try:
        choice = input("choice: ").strip()
    except (EOFError, KeyboardInterrupt):
        return
    if choice == "1":
        prompt = input("prompt: ").strip()
        client.generate(prompt, max_tokens=args.max_tokens)
    elif choice == "2":
        client.interactive_chat()
    else:
        print("health:", json.dumps(client.check_health()))
        print("workers:", json.dumps(client.check_workers(), default=str))
        client.generate("Hello", max_tokens=15)


if __name__ == "__main__":
    main()
