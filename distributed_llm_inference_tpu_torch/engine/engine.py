"""InferenceEngine: the request-level solo engine (the single-device part
of the JAX package's engine/engine.py in PyTorch).

tokenize -> chat template -> bucket plan -> (chunked) prefill -> early-exit
decode -> detokenize -> perf sample, with the JAX engine's response
envelope. One lock serializes generations. The same bucket plan and chunk
boundaries as the JAX engine (`_plan_ingest` / `_ingest`), so greedy
output on the same weights is token-identical.

Not ported yet: speculative decoding, beam search, the prefix cache,
grammar constraints, runtime adapters and scoring. A request or config
asking for one gets a ValueError naming it (an `invalid_request`
envelope, HTTP 400 at the server).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

import torch

from ..config import EngineConfig, ModelConfig
from ..models import api as M
from ..utils.logging import get_logger, request_id_context
from ..utils.metrics import (
    DEFAULT_SIZE_BUCKETS,
    MetricsRegistry,
    percentile,
    register_supervisor_metrics,
)
from ..utils.tokenizer import load_tokenizer
from ..utils.tracing import FlightRecorder, Trace
from . import generate as G
from . import paged as P

log = get_logger("engine")

DECODE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
# generate_batch pads the row count up to one of these
BATCH_BUCKETS = (1, 2, 4, 8, 16)


def not_ported(feature: str) -> ValueError:
    return ValueError(
        f"{feature} is not ported to the PyTorch engine yet "
        f"(ROADMAP.md \"Solo-engine features\")"
    )


class SingleDeviceBackend:
    """Whole model on one device: prefill, chunked extend and the decode
    loop of engine/generate.py over one parameter dictionary."""

    name = "single-device"
    n_stages = 1

    def __init__(self, cfg: ModelConfig, params, device):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)

    def init_cache(self, batch: int, max_seq: int):
        return M.init_kv_cache(self.cfg, batch, max_seq=max_seq, device=self.device)

    def prefill(self, tokens, prompt_len, cache, generator, sampling,
                valid_start=None, presence=None, bias=None):
        return G.prefill(
            self.cfg, self.params, tokens, prompt_len, cache, generator,
            sampling, valid_start, 0, presence, bias,
        )

    def extend(self, tokens, pos, cache):
        return G.extend(self.cfg, self.params, tokens, pos, cache)

    def prefill_at(self, tokens, pos, valid_len, cache, generator, sampling,
                   presence=None, bias=None):
        return G.prefill(
            self.cfg, self.params, tokens, valid_len, cache, generator,
            sampling, None, pos, presence, bias,
        )

    def decode(self, first_token, cache, start_pos, limit, generator, sampling,
               valid_start=None, presence=None, counts=None, bias=None, *,
               max_steps, with_logprobs=False):
        return G.decode(
            self.cfg, self.params, first_token, cache, start_pos, limit,
            generator, sampling, valid_start, presence, counts, bias,
            max_steps=max_steps, with_logprobs=with_logprobs,
        )

    # -- the continuous fleet (engine/continuous.py) --------------------------
    # The flags ContinuousEngine checks, as the JAX one does.
    supports_slots = True
    supports_ragged_fill = True
    supports_mixed_step = True

    def decode_slots(self, state, cache, generator, sparams, *, num_steps):
        return G.decode_slots(self.cfg, self.params, state, cache, generator,
                              sparams, num_steps=num_steps)

    @property
    def supports_paged(self) -> bool:
        return self.cfg.arch == "llama"

    def init_paged_pool(self, n_blocks, block_size):
        return P.init_pool(self.cfg, n_blocks, block_size, device=self.device)

    def insert_slot_paged(self, pool, scratch, state, sparams, slot, table_row,
                          *arm):
        return P.insert_slot_paged(self.cfg, pool, scratch, state, sparams, slot,
                                   table_row, *arm)

    def decode_slots_paged(self, state, pool, table, generator, sparams, *,
                           num_steps, pages=None):
        return P.decode_slots_paged(
            self.cfg, self.params, state, pool, table, generator, sparams,
            num_steps=num_steps, pages=pages,
        )

    def extend_ragged_paged(self, tokens, tok_row, tok_pos, meta, pool, table,
                            pages=None):
        return P.extend_ragged_paged(self.cfg, self.params, tokens, tok_row,
                                     tok_pos, meta, pool, table, pages=pages)

    def prefill_ragged_paged(self, tokens, tok_row, tok_pos, meta, pool, table,
                             sample_at, generator, sampling, presence=None,
                             bias=None, pages=None):
        return P.prefill_ragged_paged(
            self.cfg, self.params, tokens, tok_row, tok_pos, meta, pool, table,
            sample_at, generator, sampling, presence=presence, bias=bias,
            pages=pages,
        )

    def health(self) -> list[dict]:
        """Per-device health: a timed device probe (utils/probe.py), the
        in-process analogue of the source system's 5 s-timeout /workers
        sweep."""
        from ..utils.probe import probe_device

        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [{"stage": 0, "devices": [str(dev)], **probe_device(dev)}]

    def arm_slot_paged(self, state, sparams, slot, *arm):
        return P.arm_slot_only(self.cfg, state, sparams, slot, *arm)

    def mixed_step_ragged(self, tokens, tok_row, tok_pos, dec_flag, meta,
                          pool, table, state, sparams, generator, dec_idx, arm,
                          spec=None, spec_toks=None, dev=None, pages=None):
        return P.mixed_step_ragged(
            self.cfg, self.params, tokens, tok_row, tok_pos, dec_flag, meta,
            pool, table, state, sparams, generator, dec_idx, arm,
            spec=spec, spec_toks=spec_toks, dev=dev, pages=pages,
        )


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any = None,
        backend: Any = None,
        tokenizer: Any = None,
        engine_cfg: EngineConfig = EngineConfig(),
        seed: int = 0,
        device="cuda",
    ):
        if engine_cfg.prefix_cache_entries > 0:
            raise not_ported("the prefix KV cache (prefix_cache_entries > 0)")
        if engine_cfg.adapter_slots > 0:
            raise ValueError(
                "runtime adapters (adapter_slots > 0) are not ported to the "
                "PyTorch engine yet (ROADMAP.md \"Adapters\")"
            )
        if backend is None:
            if params is None:
                gen = torch.Generator(device=device).manual_seed(seed)
                params = M.init_params(cfg, gen)
            backend = SingleDeviceBackend(cfg, params, device)
        self.cfg = cfg
        self.backend = backend
        self.device = backend.device
        self.engine_cfg = engine_cfg
        self.tokenizer = tokenizer or load_tokenizer(
            None, pad_id=cfg.pad_token_id, bos_id=cfg.bos_token_id,
            eos_id=cfg.eos_token_id,
        )
        self.adapters = None  # the server's `adapter` field checks this
        self._lock = threading.Lock()
        # per-request seeds for requests that bring none
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.request_count = 0
        # rolling per-request samples for the /stats percentiles; own lock
        # (self._lock is held for a whole generation)
        self._samples = collections.deque(maxlen=256)
        self._samples_lock = threading.Lock()
        self._samples_total = 0  # guarded-by: _samples_lock
        self.metrics = MetricsRegistry()
        self._m_ttft = self.metrics.histogram(
            "dli_ttft_seconds", "time to first token", ("engine",)
        )
        self._m_tpot = self.metrics.histogram(
            "dli_tpot_seconds", "inter-token time (decode)", ("engine",)
        )
        self._m_duration = self.metrics.histogram(
            "dli_request_duration_seconds", "end-to-end request latency",
            ("engine",),
        )
        self._m_requests = self.metrics.counter(
            "dli_requests_total", "served generations", ("engine", "model")
        )
        self._m_failures = self.metrics.counter(
            "dli_request_failures_total", "failed generations",
            ("engine", "error_type"),
        )
        self._m_tokens = self.metrics.counter(
            "dli_tokens_generated_total", "generated tokens", ("engine",)
        )
        self._m_batch_size = self.metrics.histogram(
            "dli_batch_rows", "rows per batched fleet", ("engine",),
            buckets=DEFAULT_SIZE_BUCKETS,
        )
        self._m_deadline_exceeded = self.metrics.counter(
            "dli_deadline_exceeded_total",
            "requests failed by their end-to-end deadline_ms",
        ).labels()
        self._m_wedged = self.metrics.gauge(
            "dli_engine_wedged",
            "abandoned deadline-overrun device calls still running",
        ).labels()
        register_supervisor_metrics(self.metrics)
        # control-plane events (admissions, preemptions, crashes,
        # quarantines, restarts): the continuous supervisor dumps the
        # ring into its crash report; GET /debug/flight serves it
        self.flight = FlightRecorder()
        # reusable KV cache buffers (solo, and one per batch bucket): stale
        # contents between requests are never attended — prefill rewrites
        # the slots it uses and the causal mask hides the rest
        self._cache = None
        self._batch_caches: dict = {}
        # abandoned deadline-overrun calls: token -> {"what", "since"}
        self._wedged: dict = {}  # guarded-by: _wedged_lock
        self._wedged_lock = threading.Lock()

    # -- helpers ------------------------------------------------------------
    def _generator(self, seed: Optional[int]) -> torch.Generator:
        """The request's generator: its own seed, else the next engine seed."""
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._seed_gen))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _with_deadline(self, fn, what: str, deadline_s: Optional[float] = None,
                       exceeded_type: str = "timeout"):
        """Run fn() under the per-request deadline: an overrun returns a
        timeout envelope while the stuck call is abandoned to a daemon
        thread (the engine lock frees when it finishes)."""
        deadline = (
            deadline_s if deadline_s is not None
            else self.engine_cfg.request_deadline_s
        )
        if not deadline:
            return fn()
        box: dict = {}
        token = object()

        def run():
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller thread
                box["exc"] = e
            finally:
                with self._wedged_lock:
                    box["done"] = True
                    self._wedged.pop(token, None)
                    self._m_wedged.set(len(self._wedged))

        t = threading.Thread(target=run, daemon=True, name=f"engine-{what}")
        t.start()
        t.join(deadline)
        if t.is_alive():
            log.error("request_deadline_exceeded", what=what, deadline_s=deadline)
            with self._wedged_lock:
                if not box.get("done"):
                    self._wedged[token] = {"what": what, "since": time.monotonic()}
                    self._m_wedged.set(len(self._wedged))
            return {
                "error": f"Error: request exceeded the {deadline:g}s deadline",
                "status": "failed",
                "error_type": exceeded_type,
            }
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    def wedged_info(self) -> list[dict]:
        """Abandoned deadline-overrun calls still occupying the device,
        oldest first: [{"what", "age_s"}]."""
        now = time.monotonic()
        with self._wedged_lock:
            entries = [
                {"what": e["what"], "age_s": round(now - e["since"], 1)}
                for e in self._wedged.values()
            ]
        return sorted(entries, key=lambda e: -e["age_s"])

    def max_wedged_age(self) -> Optional[float]:
        info = self.wedged_info()
        return info[0]["age_s"] if info else None

    def _buckets(self):
        return tuple(b for b in self.engine_cfg.prefill_buckets
                     if b <= self.cfg.max_seq_len)

    def _clamp_decode(self, frame: int, max_tokens: int,
                      capacity: Optional[int] = None) -> tuple[int, int]:
        """Cache-capacity discipline: frame + generated must fit the
        capacity (default max_seq_len; the continuous fleet passes its
        per-slot budget), also bounded by the largest decode bucket.
        Returns (max_tokens, decode_bucket)."""
        cap = capacity if capacity is not None else self.cfg.max_seq_len
        max_tokens = max(1, min(int(max_tokens), cap - frame - 1,
                                DECODE_BUCKETS[-1]))
        return max_tokens, G.pick_bucket(DECODE_BUCKETS, max_tokens)

    def _plan(self, longest_prompt: int, max_tokens: int):
        """Bucketing/clamping for BATCHED requests (left-padded: the whole
        bucket is the position frame). Returns (bucket, max_tokens,
        decode_bucket)."""
        buckets = self._buckets()
        if not buckets or longest_prompt > buckets[-1]:
            raise ValueError(
                f"prompt length {longest_prompt} exceeds max prefill bucket "
                f"{buckets[-1] if buckets else 0}"
            )
        bucket = G.pick_bucket(buckets, longest_prompt)
        max_tokens, decode_bucket = self._clamp_decode(bucket, max_tokens)
        return bucket, max_tokens, decode_bucket

    def _row_tokens(self, first_id: int, row_out: list, n: int) -> list:
        """One row's emitted ids (a stop token as first excluded)."""
        head = [first_id] if first_id not in self.cfg.all_stop_ids else []
        return head + list(row_out[:n])

    @staticmethod
    def _truncate_at_stop(text: str, stop) -> tuple:
        """Cut `text` at the earliest stop string; returns (text, hit)."""
        if not stop:
            return text, False
        cut = min(
            (i for i in (text.find(s) for s in stop if s) if i >= 0),
            default=-1,
        )
        if cut < 0:
            return text, False
        return text[:cut], True

    def _record_sample(self, ttft: float, per_stream_tps: float, tokens: int,
                       elapsed: Optional[float] = None, engine: str = "solo"):
        """The one seam feeding both /stats percentiles and /metrics."""
        with self._samples_lock:
            self._samples.append(
                {"ttft_s": ttft, "tokens_per_sec": per_stream_tps, "tokens": tokens}
            )
            self._samples_total += 1
        self._m_ttft.labels(engine=engine).observe(ttft)
        self._m_tokens.labels(engine=engine).inc(tokens)
        if elapsed is not None:
            self._m_duration.labels(engine=engine).observe(elapsed)
            if tokens > 1:
                self._m_tpot.labels(engine=engine).observe(
                    max(0.0, elapsed - ttft) / (tokens - 1)
                )

    # -- main entry ----------------------------------------------------------
    def generate(
        self,
        prompt: str,
        max_tokens: int = 20,
        temperature: float = 0.7,
        top_k: int = 50,
        top_p: float = 0.9,
        greedy: bool = False,
        chat: bool = True,
        seed: Optional[int] = None,
        debug: bool = False,
        speculative: bool = False,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        stop: Optional[list] = None,
        logprobs: bool = False,
        logit_bias: Optional[dict] = None,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
        constraint: Optional[dict] = None,
        request_id: Optional[str] = None,
        slo_class: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> dict:
        """Full generation; returns the JAX engine's response envelope.

        debug=True adds "top_predictions" (top-5 first-token candidates).
        logprobs=True adds per-token log-probabilities under the raw
        model distribution. speculative=True, num_beams > 1 and a
        constraint are not ported yet: invalid_request."""
        t_start = time.time()
        trace = Trace(request_id)
        with request_id_context(trace.request_id):
            dl_s, dl_type = self._resolve_deadline(deadline_ms)
            if dl_s is not None and dl_s <= 0:
                self._m_deadline_exceeded.inc()
                result = {
                    "error": "Error: request exceeded its deadline_ms "
                    "budget before generation",
                    "status": "failed",
                    "error_type": "deadline_exceeded",
                }
                return self._finish_request(result, trace, engine="solo")

            def locked():
                with self._lock:
                    trace.checkpoint("queue_wait")
                    return self._generate_locked(
                        prompt, max_tokens, temperature, top_k, top_p, greedy,
                        chat, seed, t_start, debug, min_p, repetition_penalty,
                        stop, logprobs, logit_bias, frequency_penalty,
                        presence_penalty, trace,
                    )

            try:
                if speculative:
                    raise not_ported("speculative decoding")
                if num_beams > 1:
                    raise not_ported("beam search (num_beams > 1)")
                if constraint is not None:
                    raise not_ported("grammar constraints")
                result = self._with_deadline(
                    locked, "generate", deadline_s=dl_s, exceeded_type=dl_type
                )
            except ValueError as e:
                # caller-caused: tagged so the serving edge answers 400
                log.warning("invalid_request", error=str(e))
                result = {"error": f"Error: {e}", "status": "failed",
                          "error_type": "invalid_request"}
            except Exception as e:
                log.error("generate_failed", exc_info=True, error=str(e))
                result = {"error": f"Error: {e}", "status": "failed"}
            if result.get("error_type") == "deadline_exceeded":
                self._m_deadline_exceeded.inc()
            if slo_class is not None:
                result.setdefault("slo_class", slo_class)
            return self._finish_request(result, trace, engine="solo")

    def score(self, prompt: str, top_n: int = 0) -> dict:
        raise not_ported("teacher-forced scoring (score)")

    def _resolve_deadline(self, deadline_ms) -> tuple:
        """(deadline_s, exceeded_type): the smaller of the request's
        deadline_ms budget and the engine-wide cap binds."""
        cfg_s = self.engine_cfg.request_deadline_s
        if deadline_ms is None:
            return None if not cfg_s else cfg_s, "timeout"
        req_s = float(deadline_ms) / 1e3
        if cfg_s and cfg_s < req_s:
            return cfg_s, "timeout"
        return req_s, "deadline_exceeded"

    def _finish_request(self, result: dict, trace: Trace, engine: str,
                        record: bool = True) -> dict:
        """Attach request_id + timings, count the request (unless
        record=False: warmup traffic), log it once."""
        result.setdefault("request_id", trace.request_id)
        result.setdefault("timings", trace.timings())
        status = result.get("status")
        if not record:
            return result
        if status == "success":
            self._m_requests.labels(engine=engine, model=self.cfg.name).inc()
        else:
            self._m_failures.labels(
                engine=engine, error_type=result.get("error_type", "internal"),
            ).inc()
        log.info(
            "request_done", request_id=trace.request_id, status=status,
            engine=engine, tokens=result.get("tokens_generated"),
            **result["timings"],
        )
        return result

    def _plan_ingest(self, prompt_len: int, p0: int, buckets: tuple,
                     capacity: Optional[int] = None):
        """Plan feeding ids[p0:] into the cache at offset p0: (n_full,
        rem, bucket, chunk) — n_full full-`chunk` extend() calls, then a
        final `bucket`-padded sampling chunk of `rem` valid tokens — or
        None when no plan fits the capacity (default max_seq_len; the
        continuous fleet plans against its per-slot budget). The final
        chunk's pads also write K/V, so its end must stay inside it."""
        cap = capacity if capacity is not None else self.cfg.max_seq_len
        if not buckets or prompt_len > cap - 2:
            return None
        tail = prompt_len - p0
        chunk = buckets[-1]
        n_full = max(0, (tail - 1) // chunk)  # leaves >= 1 sampling token
        rem = tail - n_full * chunk
        fitting = [b for b in buckets if b >= rem and p0 + n_full * chunk + b <= cap]
        if not fitting:
            return None
        return n_full, rem, fitting[0], chunk

    def _prefix_plan(self, prefix, ids: list, capacity: Optional[int] = None,
                     ragged: bool = False):
        """(p0, entry, plan) for an admission (the JAX engine's shared
        planner), on the cold path only: prefix None, so p0 = 0 and entry
        None. ragged=True (the paged fleet's ragged ingest) has no bucket
        ladder: any prompt of 1 .. capacity - 2 tokens is served and plan
        is ("ragged", prompt_len); plan None means the prompt does not fit."""
        if prefix is not None:
            raise not_ported("the prefix KV cache (prefix_cache_entries > 0)")
        prompt_len = len(ids)
        if ragged:
            cap = capacity if capacity is not None else self.cfg.max_seq_len
            ok = 1 <= prompt_len <= cap - 2
            return 0, None, ("ragged", prompt_len) if ok else None
        return 0, None, self._plan_ingest(prompt_len, 0, self._buckets(), capacity)

    def _tokens(self, rows: list) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long, device=self.device)

    def _ingest(self, ids, p0, plan, cache, generator, sampling, presence=None,
                bias=None):
        """Feed ids[p0:] into `cache` per a `_plan_ingest` plan: n_full
        extend() calls, then the final bucket-padded sampling chunk
        (prefill at offset 0, prefill_at otherwise). Returns (first,
        logits, cache)."""
        be = self.backend
        n_full, rem, bucket, chunk = plan
        for c in range(n_full):
            start = p0 + c * chunk
            cache = be.extend(self._tokens([ids[start:start + chunk]]), start, cache)
        tail_start = p0 + n_full * chunk
        tokens = self._tokens([ids[tail_start:] + [self.cfg.pad_token_id] * (bucket - rem)])
        if tail_start == 0:
            return be.prefill(tokens, len(ids), cache, generator, sampling,
                              presence=presence, bias=bias)
        return be.prefill_at(tokens, tail_start, rem, cache, generator,
                             sampling, presence=presence, bias=bias)

    def _ingest_with_prefix(self, prefix, ids, p0, entry, plan, cache,
                            generator, sampling, presence=None, bias=None):
        """The JAX engine's splice / ingest / store sequence, on the cold
        path only (prefix None: nothing to splice or store)."""
        if prefix is not None or entry is not None:
            raise not_ported("the prefix KV cache (prefix_cache_entries > 0)")
        return self._ingest(ids, p0, plan, cache, generator, sampling,
                            presence=presence, bias=bias)

    def render_chat(self, prompt_or_messages) -> str:
        """Chat-format a prompt string or an OpenAI-style message list
        with the model's template."""
        from .chat import format_chat_messages

        messages = (
            [{"role": "user", "content": prompt_or_messages}]
            if isinstance(prompt_or_messages, str)
            else prompt_or_messages
        )
        if self.cfg.chat_template == "hf":
            if not getattr(self.tokenizer, "has_chat_template", False):
                raise ValueError(
                    "chat_template='hf' needs an HF tokenizer with a chat "
                    "template; the serving tokenizer has none"
                )
            return self.tokenizer.apply_chat_template(messages)
        return format_chat_messages(
            messages, arch=self.cfg.arch, template=self.cfg.chat_template
        )

    def _bias_array(self, logit_bias) -> Optional[torch.Tensor]:
        """{token_id: bias} -> dense [V] float32 on validated ids, or None."""
        if not logit_bias:
            return None
        b = torch.zeros((self.cfg.vocab_size,), dtype=torch.float32)
        for tid, v in logit_bias.items():
            t = int(tid)
            if not 0 <= t < self.cfg.vocab_size:
                raise ValueError(
                    f"logit_bias token id {t} outside vocab "
                    f"[0, {self.cfg.vocab_size})"
                )
            b[t] = float(v)
        return b.to(self.device)

    def _presence_rows(self, rows: list) -> torch.Tensor:
        """[len(rows), V] bool: each row's token-id set."""
        out = torch.zeros((len(rows), self.cfg.vocab_size), dtype=torch.bool)
        for b, ids in enumerate(rows):
            out[b, torch.tensor(ids, dtype=torch.long)] = True
        return out.to(self.device)

    def _decode_textual_stop_chunks(self, first, cache, prompt_len, max_tokens,
                                    generator, sampling, dkw, logprobs, stop):
        """Decode in chunks that escalate up DECODE_BUCKETS when textual
        `stop` strings are set, checking the text between chunks, so a
        stop that matches early does not decode the whole budget. Returns
        (out [1, N] list rows, n_gen, step_lps or None, cache)."""
        budget = max_tokens - 1  # the first token came from prefill
        collected: list = []
        lps: list = []
        token = first
        pos = prompt_len
        first_id = int(first[0])
        finished = first_id in self.cfg.all_stop_ids
        rung = 0
        while budget > 0 and not finished:
            chunk_bucket = DECODE_BUCKETS[min(rung, len(DECODE_BUCKETS) - 1)]
            rung += 1
            limit = min(budget, chunk_bucket)
            res = self.backend.decode(
                token, cache, pos, limit, generator, sampling,
                max_steps=chunk_bucket, with_logprobs=logprobs, **dkw,
            )
            out_i, n_i, cache = res[:3]
            n = int(n_i[0])
            row = out_i[0, :n].tolist()
            collected += row
            if logprobs:
                lps += res[3][0, :n].tolist()
            if n < limit:  # stop token inside the chunk
                break
            budget -= n
            pos += n
            if dkw.get("presence") is not None and row:
                pres = dkw["presence"].clone()
                pres[0, torch.tensor(row, device=pres.device)] = True
                dkw = dict(dkw, presence=pres)
            if dkw.get("counts") is not None and row:
                cnt = dkw["counts"].clone()
                cnt[0].index_add_(
                    0, torch.tensor(row, device=cnt.device),
                    torch.ones(len(row), dtype=cnt.dtype, device=cnt.device),
                )
                dkw = dict(dkw, counts=cnt)
            text = self.tokenizer.decode(
                ([first_id] if first_id not in self.cfg.all_stop_ids else [])
                + collected,
                skip_special_tokens=True,
            )
            if any(s in text for s in stop):
                break
            token = self._tokens([row[-1]]) if row else token
        return [collected], [len(collected)], ([lps] if logprobs else None), cache

    # guarded-by: _lock
    def _generate_locked(
        self, prompt, max_tokens, temperature, top_k, top_p, greedy, chat,
        seed, t_start, debug=False, min_p=0.0, repetition_penalty=1.0,
        stop=None, logprobs=False, logit_bias=None, frequency_penalty=0.0,
        presence_penalty=0.0, trace=None,
    ):
        cfg = self.cfg
        self.request_count += 1
        bias = self._bias_array(logit_bias)
        text = self.render_chat(prompt) if chat else prompt
        ids = self.tokenizer.encode(text)
        prompt_len = len(ids)

        buckets = self._buckets()
        if self._cache is None:
            self._cache = self.backend.init_cache(1, cfg.max_seq_len)
        plan = self._plan_ingest(prompt_len, 0, buckets)
        if plan is None:
            if prompt_len > cfg.max_seq_len - 2:
                raise ValueError(
                    f"prompt length {prompt_len} exceeds the cache capacity "
                    f"(max_seq_len {cfg.max_seq_len} less decode headroom)"
                )
            if buckets and prompt_len > buckets[-1]:
                raise ValueError(
                    f"prompt length {prompt_len} cannot be chunk-prefilled: "
                    f"no prefill bucket fits the final chunk within "
                    f"max_seq_len {cfg.max_seq_len}"
                )
            raise ValueError(
                f"prompt length {prompt_len} exceeds max prefill bucket "
                f"{buckets[-1] if buckets else 0}"
            )
        bucket = plan[2]
        max_tokens, decode_bucket = self._clamp_decode(prompt_len, max_tokens)
        sampling = G.default_sampling(
            temperature, top_k, top_p, greedy, min_p, repetition_penalty,
            frequency_penalty, presence_penalty,
        )
        oai_pen = frequency_penalty != 0.0 or presence_penalty != 0.0
        presence = (
            self._presence_rows([ids]) if repetition_penalty != 1.0 else None
        )
        generator = self._generator(seed)

        cache = self._cache
        first, logits, cache = self._ingest(
            ids, 0, plan, cache, generator, sampling, presence=presence, bias=bias
        )
        first_id = int(first[0])  # waits for the device: TTFT
        ttft = time.time() - t_start
        if trace is not None:
            trace.checkpoint("prefill")

        if presence is not None:
            presence = G.presence_update(presence, first)
        dkw = {"presence": presence}
        if oai_pen:
            dkw["counts"] = G.count_update(
                torch.zeros((1, cfg.vocab_size), dtype=torch.int32,
                            device=self.device),
                first,
            )
        if bias is not None:
            dkw["bias"] = bias
        step_lps = None
        if stop:
            out, n_gen, step_lps, cache = self._decode_textual_stop_chunks(
                first, cache, prompt_len, max_tokens, generator, sampling,
                dkw, logprobs, stop,
            )
        else:
            res = self.backend.decode(
                first, cache, prompt_len, max_tokens - 1, generator, sampling,
                max_steps=decode_bucket, with_logprobs=logprobs, **dkw,
            )
            out, n_gen, cache = res[0].tolist(), res[1].tolist(), res[2]
            if logprobs:
                step_lps = res[3].tolist()
        self._cache = cache
        if trace is not None:
            trace.checkpoint("decode")

        gen_ids = self._row_tokens(first_id, out[0], int(n_gen[0]))
        response = self.tokenizer.decode(gen_ids, skip_special_tokens=True)
        response, stopped = self._truncate_at_stop(response, stop)
        if trace is not None:
            trace.checkpoint("detokenize")

        token_logprobs = token_strings = None
        if logprobs:
            # first token: log_softmax of the prefill logits; decode steps
            # from the decode loop — every GENERATED token
            token_logprobs = []
            if first_id not in cfg.all_stop_ids:
                lp0 = torch.log_softmax(logits[0].float(), dim=-1)
                token_logprobs.append(round(float(lp0[first_id]), 6))
            token_logprobs += [round(float(x), 6)
                               for x in step_lps[0][: int(n_gen[0])]]
            token_strings = [
                self.tokenizer.decode([t]) for t, _ in zip(gen_ids, token_logprobs)
            ]

        top_predictions = None
        if debug:
            from ..ops.sampling import top_n_probs

            probs, tids = top_n_probs(logits, 5)
            top_predictions = [
                {"token": self.tokenizer.decode([int(t)]), "id": int(t),
                 "prob": round(float(p), 5)}
                for p, t in zip(probs[0].tolist(), tids[0].tolist())
            ]

        elapsed = time.time() - t_start
        n = len(gen_ids)
        tps = n / elapsed if elapsed > 0 else 0.0
        self._record_sample(ttft, tps, n, elapsed=elapsed)
        log.info(
            "request", model=cfg.name, backend=self.backend.name,
            prompt_len=prompt_len, bucket=bucket, tokens=n,
            ttft_s=round(ttft, 4), tokens_per_sec=round(tps, 2),
            elapsed_s=round(elapsed, 3),
        )
        result = {
            "prompt": prompt,
            "response": response,
            "status": "success",
            "time_taken": f"{elapsed:.2f}s",
            "tokens_generated": n,
            "prompt_tokens": prompt_len,
            "tokens_per_sec": f"{tps:.2f}",
            "ttft_s": round(ttft, 4),
            "backend": self.backend.name,
            # judged against the CLAMPED budget
            "finish_reason": "stop" if stopped or n < max_tokens else "length",
        }
        if stopped:
            result["stopped"] = True
        if token_logprobs is not None:
            result["token_logprobs"] = token_logprobs
            result["token_strings"] = token_strings
        if top_predictions is not None:
            result["top_predictions"] = top_predictions
        return result

    # -- batched entry -------------------------------------------------------
    def generate_batch(
        self,
        prompts: list,
        max_tokens: int = 20,
        temperature: float = 0.7,
        top_k: int = 50,
        top_p: float = 0.9,
        greedy: bool = False,
        chat: bool = True,
        seed: Optional[int] = None,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        stop: Optional[list] = None,
        constraint: Optional[dict] = None,
        request_id: Optional[str] = None,
        slo_class: Optional[str] = None,
        deadline_ms: Optional[float] = None,
    ) -> dict:
        """One batch for N prompts (shared sampling params): ragged prompts
        LEFT-pad to a shared bucket, so every row shares one position
        frame and per-row pad slots are masked through valid_start."""
        t_start = time.time()
        trace = Trace(request_id)

        def locked():
            with self._lock:
                trace.checkpoint("queue_wait")
                return self._generate_batch_locked(
                    prompts, max_tokens, temperature, top_k, top_p, greedy,
                    chat, seed, t_start, min_p, repetition_penalty, stop,
                    frequency_penalty, presence_penalty, trace,
                )

        with request_id_context(trace.request_id):
            dl_s, dl_type = self._resolve_deadline(deadline_ms)
            if dl_s is not None and dl_s <= 0:
                self._m_deadline_exceeded.inc()
                return self._finish_request(
                    {"error": "Error: request exceeded its deadline_ms "
                     "budget before generation", "status": "failed",
                     "error_type": "deadline_exceeded"},
                    trace, engine="batch",
                )
            try:
                if constraint is not None:
                    raise not_ported("grammar constraints")
                result = self._with_deadline(
                    locked, "generate_batch", deadline_s=dl_s,
                    exceeded_type=dl_type,
                )
                if result.get("error_type") == "deadline_exceeded":
                    self._m_deadline_exceeded.inc()
            except ValueError as e:
                log.warning("invalid_batch_request", error=str(e))
                result = {"error": f"Error: {e}", "status": "failed",
                          "error_type": "invalid_request"}
            except Exception as e:
                log.error("generate_batch_failed", exc_info=True, error=str(e))
                result = {"error": f"Error: {e}", "status": "failed"}
            return self._finish_request(result, trace, engine="batch")

    # guarded-by: _lock
    def _generate_batch_locked(
        self, prompts, max_tokens, temperature, top_k, top_p, greedy, chat,
        seed, t_start, min_p=0.0, repetition_penalty=1.0, stop=None,
        frequency_penalty=0.0, presence_penalty=0.0, trace=None,
    ):
        cfg = self.cfg
        if not prompts or not all(isinstance(p, str) and p for p in prompts):
            raise ValueError("prompts must be a non-empty list of non-empty strings")
        self.request_count += 1
        B = len(prompts)
        if B > BATCH_BUCKETS[-1]:
            raise ValueError(
                f"batch size {B} exceeds the maximum {BATCH_BUCKETS[-1]}; "
                f"split the request"
            )
        ids = [self.tokenizer.encode(self.render_chat(p) if chat else p)
               for p in prompts]
        plens = [len(i) for i in ids]
        bucket, max_tokens, decode_bucket = self._plan(max(plens), max_tokens)
        # pad the row count to a batch bucket; dummy rows are single-pad
        # prompts, sliced off the results below
        Bb = G.pick_bucket(BATCH_BUCKETS, B)
        pad = cfg.pad_token_id
        rows = ids + [[pad]] * (Bb - B)
        row_lens = plens + [1] * (Bb - B)
        tokens = self._tokens(
            [[pad] * (bucket - n) + row for row, n in zip(rows, row_lens)]
        )
        valid_start = torch.tensor([bucket - n for n in row_lens],
                                   dtype=torch.int32, device=self.device)
        sampling = G.default_sampling(
            temperature, top_k, top_p, greedy, min_p, repetition_penalty,
            frequency_penalty, presence_penalty,
        )
        oai_pen = frequency_penalty != 0.0 or presence_penalty != 0.0
        presence = (
            self._presence_rows(rows) if repetition_penalty != 1.0 else None
        )
        generator = self._generator(seed)
        cache = self._batch_caches.pop(Bb, None)
        if cache is None:
            cache = self.backend.init_cache(Bb, cfg.max_seq_len)
        first, logits, cache = self.backend.prefill(
            tokens, bucket, cache, generator, sampling, valid_start,
            presence=presence,
        )
        # dummy rows start finished (first token forced to EOS), so the
        # decode loop's all-finished exit still fires
        first[B:] = cfg.eos_token_id
        firsts = first.tolist()  # waits for the device: TTFT
        ttft = time.time() - t_start
        if trace is not None:
            trace.checkpoint("prefill")
        if presence is not None:
            presence = G.presence_update(presence, first)
        counts = None
        if oai_pen:
            counts = G.count_update(
                torch.zeros((Bb, cfg.vocab_size), dtype=torch.int32,
                            device=self.device),
                first,
            )
        out, n_gen, cache = self.backend.decode(
            first, cache, bucket, max_tokens - 1, generator, sampling,
            valid_start, presence, counts, max_steps=decode_bucket,
        )
        out, n_gen = out.tolist(), n_gen.tolist()
        if trace is not None:
            trace.checkpoint("decode")
        # keep ONE batch cache (the bucket just used)
        self._batch_caches.clear()
        self._batch_caches[Bb] = cache

        results = []
        total_tokens = 0
        for b in range(B):
            row = self._row_tokens(firsts[b], out[b], n_gen[b])
            total_tokens += len(row)
            text = self.tokenizer.decode(row, skip_special_tokens=True)
            text, row_stopped = self._truncate_at_stop(text, stop)
            entry = {
                "prompt": prompts[b],
                "response": text,
                "tokens_generated": len(row),
                "prompt_tokens": plens[b],
                "status": "success",
                "finish_reason": (
                    "stop" if row_stopped or len(row) < max_tokens else "length"
                ),
            }
            if row_stopped:
                entry["stopped"] = True
            results.append(entry)
        if trace is not None:
            trace.checkpoint("detokenize")
        elapsed = time.time() - t_start
        tps = total_tokens / elapsed if elapsed > 0 else 0.0
        self._record_sample(ttft, tps / B, total_tokens, elapsed=elapsed,
                            engine="batch")
        self._m_batch_size.labels(engine="batch").observe(B)
        log.info(
            "batch_request", model=cfg.name, backend=self.backend.name,
            batch=B, batch_bucket=Bb, bucket=bucket, tokens=total_tokens,
            ttft_s=round(ttft, 4), aggregate_tokens_per_sec=round(tps, 2),
            elapsed_s=round(elapsed, 3),
        )
        return {
            "results": results,
            "status": "success",
            "batch_size": B,
            "time_taken": f"{elapsed:.2f}s",
            "tokens_generated": total_tokens,
            "tokens_per_sec": f"{tps:.2f}",
            "ttft_s": round(ttft, 4),
            "backend": self.backend.name,
        }

    # -- perf stats ----------------------------------------------------------
    def stats(self) -> dict:
        """Rolling p50/p90/p99 over recent requests (TTFT seconds,
        tokens/sec) plus the lifetime sample count."""
        with self._samples_lock:
            samples = list(self._samples)
            samples_total = self._samples_total
        ttfts = [s["ttft_s"] for s in samples]
        tpss = [s["tokens_per_sec"] for s in samples]
        return {
            "window": len(samples),
            "samples_total": samples_total,
            "ttft_p50_s": percentile(ttfts, 0.5),
            "ttft_p90_s": percentile(ttfts, 0.9),
            "ttft_p99_s": percentile(ttfts, 0.99),
            "tokens_per_sec_p50": percentile(tpss, 0.5),
            "tokens_per_sec_p90": percentile(tpss, 0.9),
            "tokens_per_sec_p99": percentile(tpss, 0.99),
            "tokens_total": sum(s["tokens"] for s in samples),
        }

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Wait for the in-flight generation (the engine lock) to finish;
        False when the deadline expired first."""
        t0 = time.time()
        while self._lock.locked():
            if deadline_s is not None and time.time() - t0 > deadline_s:
                return False
            time.sleep(0.05)
        return True

    def health(self) -> dict:
        out = {
            "status": "healthy",
            "model": self.cfg.name,
            "backend": self.backend.name,
            "n_stages": getattr(self.backend, "n_stages", 1),
            "requests_served": self.request_count,
            "stats": self.stats(),
        }
        wedged = self.wedged_info()
        if wedged:
            out["status"] = "degraded"
            out["wedged"] = wedged
        return out

    def workers(self) -> dict:
        """The /workers sweep: each stage's device probe. A generation
        holding the engine lock means a timed-out probe is queued behind
        real work, not unreachable: it reports "busy", not "offline"."""
        stages = self.backend.health()
        if self._lock.locked():
            for s in stages:
                if s.get("status") == "offline":
                    s["status"] = "busy"
                    s["error"] = "probe queued behind an in-flight generation"
        return {
            "workers": {f"stage_{s['stage']}": s for s in stages},
            "total": len(stages),
        }
