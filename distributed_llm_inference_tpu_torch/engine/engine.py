"""InferenceEngine: the request-level solo engine (the single-device part
of the JAX package's engine/engine.py in PyTorch).

tokenize -> chat template -> bucket plan -> (chunked) prefill -> early-exit
decode -> detokenize -> perf sample, with the JAX engine's response
envelope. One lock serializes generations. The same bucket plan and chunk
boundaries as the JAX engine (`_plan_ingest` / `_ingest`), so greedy
output on the same weights is token-identical.

`_prefix_plan` is the JAX engine's shared prefix planner: the paged
fleet (engine/continuous.py) drives it with its block-prefix index
(engine/block_prefix.py) when `prefix_cache_entries > 0`.

`set_draft` attaches a draft model: the solo engine's two-model
speculation and the continuous fleet's draft-model speculation
(engine/continuous.py) run it.

The runtime adapter pool (engine/adapters.py, `self.adapters`) rides the
continuous paged fleet; the backend writes its pages in place
(`write_adapter_page`).

Grammar constraints (constrain/): a request's `constraint` (a regex, a
choice list, a JSON schema or any JSON object) compiles through the
engine's LRU into a DFA over the vocabulary; the first token's mask rides
the prefill's bias operand, and the decode loop masks and advances the
FSM on the device (engine/generate.py). `generate_batch` runs one shared
constraint over every row.

The solo engine's features, as the JAX engine has them: greedy
`speculative=True` decodes through prompt-lookup n-gram drafts, or
through the attached draft model's chain, each verified by one T = 1 + G
forward (`SPEC_DRAFT_LEN`); `num_beams > 1` runs HF beam search over the
prompt's prefill tiled to the beams; `score` is teacher-forced scoring
(the OpenAI echo + logprobs route); `prefix_cache_entries > 0` keeps
prompt-prefix snapshots (engine/prefix.py), spliced back on a hit.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models import api as M
from ..utils.logging import get_logger, request_id_context
from ..utils.metrics import (
    DEFAULT_SIZE_BUCKETS,
    MetricsRegistry,
    percentile,
    register_adapter_metrics,
    register_kv_cache_metrics,
    register_spec_metrics,
    register_supervisor_metrics,
)
from ..serving.trace_store import TraceStore
from ..utils import faults
from ..utils.tokenizer import load_tokenizer
from ..utils.tracing import FlightRecorder, Trace
from . import generate as G
from . import paged as P
from .prefix import PrefixCache

log = get_logger("engine")

DECODE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
# generate_batch pads the row count up to one of these
BATCH_BUCKETS = (1, 2, 4, 8, 16)


def batch_buckets_for(granularity: int) -> tuple:
    """The batch-bucket ladder for a backend's row-count quantum (the 1F1B
    schedule's dp x microbatches): BATCH_BUCKETS at 1, else (g, 2g, 4g,
    ...) up past BATCH_BUCKETS[-1], so every batch size the API admits maps
    to a bucket warmup ran. The request path and warmup share it."""
    if granularity <= 1:
        return BATCH_BUCKETS
    out = [granularity]
    while out[-1] < BATCH_BUCKETS[-1]:
        out.append(out[-1] * 2)
    return tuple(out)


# speculation: drafted tokens verified per forward (the KV headroom
# _clamp_decode reserves past the last emitted token)
SPEC_DRAFT_LEN = 4


class SingleDeviceBackend:
    """Whole model on one device: prefill, chunked extend and the decode
    loop of engine/generate.py over one parameter dictionary."""

    name = "single-device"
    n_stages = 1
    # left-padded batches with per-row valid_start (the queue coalesces
    # into them)
    supports_ragged = True

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
               valid_start=None, presence=None, counts=None, bias=None,
               constraint=None, *, max_steps, with_logprobs=False):
        return G.decode(
            self.cfg, self.params, first_token, cache, start_pos, limit,
            generator, sampling, valid_start, presence, counts, bias,
            constraint, max_steps=max_steps, with_logprobs=with_logprobs,
        )

    # grammar-constrained decoding (constrain/): the FSM state and the mask
    # tables thread through decode; the first token rides the bias operand
    supports_constrain = True
    # teacher-forced scoring (OpenAI echo + logprobs, lm-eval loglikelihood)
    supports_score = True

    def score_chunk(self, tokens, pos, cache, *, top_n=0):
        return G.score_chunk(self.cfg, self.params, tokens, pos, cache,
                             top_n=top_n)

    # beam search (HF generate(num_beams=N)); the cache reorders by parent
    # beam each step
    supports_beam = True

    def decode_beam(self, logits0, cache, start_pos, limit, length_penalty, *,
                    max_steps, num_beams, early_stopping):
        return G.decode_beam(
            self.cfg, self.params, logits0, cache, start_pos, limit,
            length_penalty, max_steps=max_steps, num_beams=num_beams,
            early_stopping=early_stopping,
        )

    # greedy prompt-lookup speculation (a request opts in)
    supports_speculative = True

    def decode_speculative(self, first_token, cache, hist, hist_len, limit, *,
                           max_steps, draft_len):
        return G.decode_speculative(
            self.cfg, self.params, first_token, cache, hist, hist_len, limit,
            max_steps=max_steps, draft_len=draft_len,
        )

    # two-model speculation over the draft set_draft attaches
    supports_draft = True

    def decode_draft_speculative(self, dcfg, dparams, first_token, cache,
                                 dcache, start_pos, limit, *, max_steps,
                                 draft_len):
        return G.decode_draft_speculative(
            self.cfg, self.params, dcfg, dparams, first_token, cache, dcache,
            start_pos, limit, max_steps=max_steps, draft_len=draft_len,
        )

    # -- the continuous fleet (engine/continuous.py) --------------------------
    # The flags ContinuousEngine checks, as the JAX one does.
    supports_slots = True
    supports_ragged_fill = True
    supports_mixed_step = True

    def decode_slots(self, state, cache, generator, sparams, *, num_steps):
        return G.decode_slots(self.cfg, self.params, state, cache, generator,
                              sparams, num_steps=num_steps)

    def insert_slot(self, cache, scratch, state, sparams, slot, *arm):
        return G.insert_slot(self.cfg, cache, scratch, state, sparams, slot, *arm)

    # constrained slot decode (the dense fleet's constrained tenants; the
    # fleet tables come from constrain/fleet.py)
    supports_constrained_slots = True

    def decode_slots_constrained(self, state, cache, generator, sparams, fsm,
                                 cmask, ctrans, *, num_steps):
        return G.decode_slots_constrained(
            self.cfg, self.params, state, cache, generator, sparams, fsm, cmask,
            ctrans, num_steps=num_steps)

    @property
    def supports_paged(self) -> bool:
        return self.cfg.arch in ("llama", "gpt2")

    def init_paged_pool(self, n_blocks, block_size):
        return P.init_pool(self.cfg, n_blocks, block_size, device=self.device)

    def insert_slot_paged(self, pool, scratch, state, sparams, slot, table_row,
                          *arm):
        return P.insert_slot_paged(self.cfg, pool, scratch, state, sparams, slot,
                                   table_row, *arm)

    def fill_scratch_paged(self, pool, table_row, scratch=None):
        # block-level prefix sharing: the contiguous scratch view of a
        # hit's mapped blocks, written into `scratch` in place (the pool
        # is only read: other block tables keep reading those blocks)
        return P.gather_scratch_blocks(pool, table_row, out=scratch)

    # the warm-recovery shadow seam (engine/shadow.py); the fleet gates
    # its shadow on these, as the JAX one does
    def gather_shadow_blocks(self, pool, block_ids):
        return P.gather_shadow_blocks(pool, block_ids)

    def restore_shadow_blocks(self, pool, blocks, block_ids):
        return P.restore_shadow_blocks(pool, blocks, block_ids)

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

    def write_adapter_page(self, page: int, updates: dict):
        """Write one adapter into page `page` of the paged lora leaves
        (engine/adapters.py), IN PLACE: updates = {base leaf: (a [L, in,
        r], b [L, r, out]) float32 host arrays}, cast to the model dtype on
        the host. A new tensor would leave every captured CUDA graph
        reading the old leaf. On the card each copy goes up through pinned
        memory on the current stream, the one the fleet's worker launches
        on, so it lands after every launch already in flight and before
        the first launch that reads the page."""
        layers = self.params["layers"]
        cuda = self.device.type == "cuda"
        for leaf, (a, b) in updates.items():
            for suffix, val in (("a", a), ("b", b)):
                dst = layers[f"lora_{leaf}_{suffix}"]
                src = torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(dst.dtype)
                if cuda:
                    src = src.pin_memory()
                dst[:, page].copy_(src, non_blocking=cuda)


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
        # the paged runtime LoRA pool (engine/adapters.AdapterPool), wired
        # by runtime.create_engine (EngineConfig.adapter_slots > 0) or
        # adapters.attach_adapter_pool; None: base-only serving
        self.adapters = None
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
        self._m_speculative = self.metrics.counter(
            "dli_speculative_requests_total",
            "requests served speculatively", ("engine",),
        )
        register_supervisor_metrics(self.metrics)
        register_kv_cache_metrics(self.metrics)
        register_spec_metrics(self.metrics)
        register_adapter_metrics(self.metrics)
        # the per-process span store the serving edge records into (the
        # replica's request spans and their stage children, fabric pulls
        # and serves, sampled launch attribution; GET /debug/traces), and
        # the control-plane events (admissions, preemptions, crashes,
        # quarantines, restarts) the continuous supervisor dumps into its
        # crash report (GET /debug/flight). Both bounded, host-side only
        self.trace_store = TraceStore(service=f"replica-{engine_cfg.replica_class}")
        self.flight = FlightRecorder()
        # reusable KV cache buffers (solo, and one per batch bucket): stale
        # contents between requests are never attended — prefill rewrites
        # the slots it uses and the causal mask hides the rest
        self._cache = None
        self._batch_caches: dict = {}
        # abandoned deadline-overrun calls: token -> {"what", "since"}
        self._wedged: dict = {}  # guarded-by: _wedged_lock
        self._wedged_lock = threading.Lock()
        # prefix KV snapshots of the solo path (engine/prefix.py): off at
        # 0 entries, and dropped for a cache layout that cannot snapshot
        # (checked against the live buffer per request)
        self._prefix = None
        if engine_cfg.prefix_cache_entries > 0:
            self._prefix = PrefixCache(
                engine_cfg.prefix_cache_entries, engine_cfg.prefix_chunk,
                registry=self.metrics, scope="solo",
            )
        # (cfg, params) of the draft model (set_draft), or None, and the
        # solo draft speculation's reusable draft cache
        self._draft = None
        self._draft_cache = None
        # grammar-constraint compiled artifacts (constrain/): an LRU by
        # canonical constraint hash. The token vocab and its trie are built
        # once, lazily, and shared by every compile; an artifact keeps its
        # device tables, so a repeated constraint uploads nothing. Own
        # lock: the fleet's worker and request threads both compile
        self._constraint_cache = collections.OrderedDict()
        self._constraint_vocab = None
        self._constraint_trie = None
        self._constraint_lock = threading.Lock()

    def set_draft(self, dcfg: ModelConfig, dparams: Any = None, seed: int = 1):
        """Attach a draft model for two-model speculation: the solo
        engine's (`speculative=True`) and the fleet's draft-model
        speculation (engine/continuous.py, spec_draft_model). It must
        share the target's tokenizer (its tokens are compared with the
        target's argmax), of either family. It runs on the target's
        device with the target's attention route; random weights from
        `seed` when `dparams` is None."""
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}; draft and target must share a "
                f"tokenizer"
            )
        dcfg = dcfg.replace(attn_impl=self.cfg.attn_impl)
        if dparams is None:
            dparams = M.init_params(
                dcfg, torch.Generator(device=self.device).manual_seed(seed))
        self._draft = (dcfg, dparams)
        self._draft_cache = None

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

    def _clamp_decode(self, frame: int, max_tokens: int, headroom: int = 0,
                      capacity: Optional[int] = None) -> tuple[int, int]:
        """Cache-capacity discipline: frame + generated (+ `headroom`
        scratch slots, the speculative drafts written past the last
        emitted token) must fit the capacity (default max_seq_len; the
        continuous fleet passes its per-slot budget), also bounded by the
        largest decode bucket. Returns (max_tokens, decode_bucket)."""
        cap = capacity if capacity is not None else self.cfg.max_seq_len
        max_tokens = max(1, min(int(max_tokens), cap - frame - 1 - headroom,
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
                       elapsed: Optional[float] = None, engine: str = "solo",
                       trace_id: Optional[str] = None):
        """The one seam feeding both /stats percentiles and /metrics.
        `trace_id`, when the request carried a fleet trace context,
        becomes the latency histograms' exemplar for the bucket it lands
        in (/stats "exemplars")."""
        with self._samples_lock:
            self._samples.append(
                {"ttft_s": ttft, "tokens_per_sec": per_stream_tps, "tokens": tokens}
            )
            self._samples_total += 1
        self._m_ttft.labels(engine=engine).observe(ttft, trace_id=trace_id)
        self._m_tokens.labels(engine=engine).inc(tokens)
        if elapsed is not None:
            self._m_duration.labels(engine=engine).observe(elapsed, trace_id=trace_id)
            if tokens > 1:
                self._m_tpot.labels(engine=engine).observe(
                    max(0.0, elapsed - ttft) / (tokens - 1), trace_id=trace_id
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
        _trace: Optional[Trace] = None,
    ) -> dict:
        """Full generation; returns the JAX engine's response envelope.

        debug=True adds "top_predictions" (top-5 first-token candidates).
        logprobs=True adds per-token log-probabilities under the raw
        model distribution. constraint (the /generate wire format, see
        constrain.parse_constraint_spec) guarantees the response matches
        it; it does not compose with num_beams > 1 or speculative.
        speculative=True speculates for a GREEDY request with no penalty,
        bias or logprobs (the draft model's chain when one is attached,
        else prompt-lookup n-grams), and decodes plainly otherwise: every
        emitted token is still the argmax. num_beams > 1 runs beam search
        (length_penalty, early_stopping as in HF); sampling knobs, bias and
        logprobs are ignored there, the OpenAI penalties refused. _trace:
        a trace to continue (serving/queue.py hands its own)."""
        t_start = time.time()
        trace = _trace if _trace is not None else Trace(request_id)
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
                    if num_beams > 1:
                        return self._beam_locked(
                            prompt, max_tokens, num_beams, length_penalty,
                            early_stopping, chat, t_start, stop, trace,
                        )
                    return self._generate_locked(
                        prompt, max_tokens, temperature, top_k, top_p, greedy,
                        chat, seed, t_start, debug, min_p, repetition_penalty,
                        stop, logprobs, logit_bias, frequency_penalty,
                        presence_penalty, constraint, trace, speculative,
                    )

            try:
                if constraint is not None and (num_beams > 1 or speculative):
                    # no per-beam FSM threads the beam reorder, and a
                    # speculative verify compares drafts with an unmasked
                    # argmax: refused by name, never silently unconstrained
                    what = "num_beams > 1" if num_beams > 1 else "speculative"
                    raise ValueError(f"constraint does not compose with {what}")
                if num_beams > 1 and (frequency_penalty != 0.0
                                      or presence_penalty != 0.0):
                    # the beam path is a pure max-score search with no
                    # per-beam counts: refused, never silently unpenalized
                    raise ValueError(
                        "frequency_penalty/presence_penalty are not supported "
                        "with num_beams > 1; drop the penalties or use sampling"
                    )
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
        """Teacher-forced per-token log-probabilities of `prompt` itself
        (no generation): the OpenAI echo + logprobs + max_tokens=0 pattern
        of evaluation harnesses. top_n (0..5): each position's top-N
        alternatives too."""
        t_start = time.time()

        def locked():
            with self._lock:
                return self._score_locked(prompt, int(top_n), t_start)

        try:
            return self._with_deadline(locked, "score")
        except ValueError as e:
            log.warning("invalid_request", error=str(e))
            return {"error": f"Error: {e}", "status": "failed",
                    "error_type": "invalid_request"}
        except Exception as e:
            log.error("score_failed", exc_info=True, error=str(e))
            return {"error": f"Error: {e}", "status": "failed"}

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
            if result.get("speculative"):
                self._m_speculative.labels(engine=engine).inc()
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
                     ragged: bool = False, adapter: Optional[str] = None):
        """Prefix lookup + ingest planning, the JAX engine's one copy for
        every serving path: lookup -> plan the tail -> cold fallback when
        no tail plan fits -> mark hit / miss on the PLANNED outcome (a
        lookup hit that fell back cold is a miss). Returns (p0, entry,
        plan).

        `prefix` is a planner with lookup(ids) -> (p0, entry, key) and
        mark(key, hit, depth): the paged fleet's BlockPrefixIndex (entry =
        the shared physical block ids the caller maps into its table), a
        PrefixCache (engine/prefix.py; entry = the snapshot the caller
        splices), or None for a plain cold plan. adapter is passed through to lookup
        only when not None.

        ragged=True (the paged fleet's ragged ingest): no bucket ladder,
        so any tail of >= 1 token is served and the deepest lookup depth
        is used AS IS (exact chunk depth, never degraded); plan is
        ("ragged", tail_len), None only when the prompt does not fit the
        capacity. Bucketed: when the deepest depth leaves a tail no bucket
        fits, the depth walks down one planner granule (`prefix.chunk`)
        at a time before falling back cold."""
        buckets = self._buckets()
        prompt_len = len(ids)
        p0, entry, pkey = 0, None, None
        if prefix is not None:
            if adapter is not None:
                p0, entry, pkey = prefix.lookup(ids, adapter=adapter)
            else:
                p0, entry, pkey = prefix.lookup(ids)
        if ragged:
            cap = capacity if capacity is not None else self.cfg.max_seq_len
            ok = 1 <= prompt_len <= cap - 2
            plan = ("ragged", prompt_len - p0) if ok else None
            if plan is None or not p0:
                entry = None
                if plan is None:
                    p0 = 0
            if prefix is not None:
                prefix.mark(pkey, hit=bool(p0), depth=p0)
            return p0, entry, plan
        plan = self._plan_ingest(prompt_len, p0, buckets, capacity)
        step = getattr(prefix, "chunk", 0)
        while plan is None and p0 > step > 0:
            p0 -= step
            plan = self._plan_ingest(prompt_len, p0, buckets, capacity)
        if plan is None and p0:
            p0 = 0
            plan = self._plan_ingest(prompt_len, 0, buckets, capacity)
        if not p0:
            entry = None
        if prefix is not None:
            prefix.mark(pkey, hit=bool(p0) and plan is not None, depth=p0)
        return p0, entry, plan

    def _tokens(self, rows: list) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long, device=self.device)

    def _ingest(self, ids, p0, plan, cache, generator, sampling, presence=None,
                bias=None, backend=None):
        """Feed ids[p0:] into `cache` per a `_plan_ingest` plan: n_full
        extend() calls, then the final bucket-padded sampling chunk
        (prefill at offset 0, prefill_at otherwise), through `backend`
        (default the engine's; the draft model's for its ingest). Returns
        (first, logits, cache)."""
        be = backend or self.backend
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
        """Splice a prefix hit into the cache, ingest the tail, then store
        the whole prompt's KV back (engine/prefix.py). Splice before the
        ingest and store after it: the stored snapshot must cover the
        whole prompt."""
        if entry is not None:
            cache = prefix.splice(entry, cache, p0)
        first, logits, cache = self._ingest(ids, p0, plan, cache, generator,
                                            sampling, presence=presence, bias=bias)
        if prefix is not None:
            prefix.store(ids, len(ids), cache)
        return first, logits, cache

    def _draft_ingest(self, ids: list, dcache):
        """Prefill the whole prompt into the draft model's cache (two-model
        speculation): the same _ingest sequence as the target, through a
        single-device backend over the draft's weights. No prefix cache;
        the draft's sampled first token is discarded, only its K/V
        matters."""
        dcfg, dparams = self._draft
        plan = self._plan_ingest(len(ids), 0, self._buckets())
        if plan is None:  # the target's plan accepted this prompt
            raise ValueError(f"prompt length {len(ids)} exceeds draft ingest capacity")
        _, _, dcache = self._ingest(
            ids, 0, plan, dcache, self._generator(0), G.default_sampling(greedy=True),
            backend=SingleDeviceBackend(dcfg, dparams, self.device),
        )
        return dcache

    # guarded-by: _lock
    def _beam_locked(self, prompt, max_tokens, num_beams, length_penalty,
                     early_stopping, chat, t_start, stop, trace=None):
        """Beam search: prefill the prompt ONCE (batch 1, in the solo
        cache), tile its K/V and first-position logits to num_beams rows,
        then decode_beam. The prompt must fit one prefill bucket."""
        cfg = self.cfg
        self.request_count += 1
        if not getattr(self.backend, "supports_beam", False):
            raise ValueError(
                f"backend {self.backend.name!r} does not support beam search; "
                f"serve num_beams > 1 on the single-device backend"
            )
        if not 2 <= num_beams <= 16:
            raise ValueError("num_beams must be between 2 and 16")
        text = self.render_chat(prompt) if chat else prompt
        ids = self.tokenizer.encode(text)
        prompt_len = len(ids)
        buckets = self._buckets()
        if not buckets or prompt_len > buckets[-1]:
            raise ValueError(
                f"prompt length {prompt_len} exceeds max prefill bucket "
                f"{buckets[-1] if buckets else 0} (beam search prefills in "
                f"one bucket)"
            )
        bucket = G.pick_bucket(buckets, prompt_len)
        max_tokens, decode_bucket = self._clamp_decode(prompt_len, max_tokens)
        tokens = self._tokens([ids + [cfg.pad_token_id] * (bucket - prompt_len)])
        if self._cache is None:
            self._cache = self.backend.init_cache(1, cfg.max_seq_len)
        _, logits, cache1 = self.backend.prefill(
            tokens, prompt_len, self._cache, self._generator(0),
            G.default_sampling(greedy=True),
        )
        # every beam starts from the same prompt: the batch-1 cache (and
        # an int8 cache's scales) and the [1, V] logits tiled to the beams
        cache = G.tile_cache(cache1, num_beams)
        logits = logits.repeat(num_beams, 1)
        ttft = time.time() - t_start
        if trace is not None:
            trace.checkpoint("prefill")
        out, n_gen, scores, cache = self.backend.decode_beam(
            logits, cache, prompt_len, max_tokens, length_penalty,
            max_steps=decode_bucket, num_beams=num_beams,
            early_stopping=early_stopping,
        )
        out, n_gen, scores = out.tolist(), n_gen.tolist(), scores.tolist()
        del cache
        self._cache = cache1  # the batch-1 cache, stale rows masked
        if trace is not None:
            trace.checkpoint("decode")
        beams = []
        for b in range(num_beams):
            n = int(n_gen[b])
            txt = self.tokenizer.decode(out[b][:n], skip_special_tokens=True)
            txt, b_stopped = self._truncate_at_stop(txt, stop)
            beams.append({"text": txt, "score": round(float(scores[b]), 6),
                          "tokens": n, "stopped": b_stopped})
        best = beams[0]
        if trace is not None:
            trace.checkpoint("detokenize")
        elapsed = time.time() - t_start
        n = best["tokens"]
        tps = n / elapsed if elapsed > 0 else 0.0
        self._record_sample(ttft, tps, n, elapsed=elapsed)
        log.info("beam_request", model=cfg.name, backend=self.backend.name,
                 num_beams=num_beams, tokens=n, elapsed_s=round(elapsed, 3))
        result = {
            "prompt": prompt,
            "response": best["text"],
            "status": "success",
            "time_taken": f"{elapsed:.2f}s",
            "tokens_generated": n,
            "prompt_tokens": prompt_len,
            "tokens_per_sec": f"{tps:.2f}",
            "ttft_s": round(ttft, 4),
            "backend": self.backend.name,
            "num_beams": num_beams,
            "beams": beams,
            "finish_reason": "stop" if best["stopped"] or n < max_tokens else "length",
        }
        if best["stopped"]:
            result["stopped"] = True
        return result

    # guarded-by: _lock
    def _score_locked(self, prompt: str, top_n: int, t_start: float) -> dict:
        cfg = self.cfg
        self.request_count += 1
        if not getattr(self.backend, "supports_score", False):
            raise ValueError(
                f"backend {self.backend.name!r} does not support scoring; "
                f"serve echo/logprobs scoring on the single-device backend"
            )
        if not 0 <= top_n <= 5:
            raise ValueError("top_n must be between 0 and 5")
        ids = self.tokenizer.encode(prompt)
        if len(ids) < 2:
            raise ValueError("scoring needs at least 2 tokens")
        buckets = self._buckets()
        if not buckets or len(ids) > cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(ids)} exceeds max_seq_len {cfg.max_seq_len}"
            )
        # the chunked prefill's plan: full chunks of the largest bucket,
        # then a padded final bucket; each chunk's LAST distribution scores
        # the next chunk's first token across the boundary
        chunk = buckets[-1]
        n_full = max(0, (len(ids) - 1) // chunk)
        rem = len(ids) - n_full * chunk
        fitting = [b for b in buckets if b >= rem]
        if not fitting or n_full * chunk + fitting[0] > cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(ids)} cannot be chunk-scored within "
                f"max_seq_len {cfg.max_seq_len}"
            )
        bucket = fitting[0]
        if self._cache is None:
            self._cache = self.backend.init_cache(1, cfg.max_seq_len)
        cache = self._cache
        pad = cfg.pad_token_id
        lps: list = []
        tops: list = []
        prev_last = None  # [V] numpy: the previous chunk's last distribution

        def top_dict(values, ids_):
            # distinct ids can decode to one string (byte-level tokenizers):
            # keep the first (best) logprob per string
            d: dict = {}
            for v, i in zip(values, ids_):
                s_ = self.tokenizer.decode([int(i)])
                if s_ not in d:
                    d[s_] = round(float(v), 6)
            return d

        for c in range(n_full + 1):
            if c < n_full:
                rows = ids[c * chunk:(c + 1) * chunk]
                toks = self._tokens([rows])
            else:
                rows = ids[n_full * chunk:]
                toks = self._tokens([rows + [pad] * (bucket - rem)])
            within, top_v, top_i, last_lp, cache = self.backend.score_chunk(
                toks, c * chunk, cache, top_n=top_n)
            within = within[0].cpu().numpy()
            top_v, top_i = top_v[0].cpu().numpy(), top_i[0].cpu().numpy()
            if c > 0:
                # the chunk's first token, from the previous chunk's last
                # position (one [V] row per chunk, on the host)
                lps.append(float(prev_last[rows[0]]))
                if top_n:
                    idx = np.argpartition(-prev_last, top_n - 1)[:top_n]
                    idx = idx[np.argsort(-prev_last[idx])]
                    tops.append(top_dict(prev_last[idx], idx))
            valid = (len(rows) if c < n_full else rem) - 1
            lps.extend(float(x) for x in within[:valid])
            if top_n:
                for t in range(valid):
                    tops.append(top_dict(top_v[t], top_i[t]))
            prev_last = last_lp[0].cpu().numpy()
        self._cache = cache

        lps = [round(x, 6) for x in lps]
        elapsed = time.time() - t_start
        result = {
            "prompt": prompt,
            "status": "success",
            "prompt_tokens": len(ids),
            # the OpenAI convention: the first token has no conditional
            "token_logprobs": [None] + lps,
            "token_strings": [self.tokenizer.decode([t]) for t in ids],
            "logprob_sum": round(sum(lps), 6),
            "time_taken": f"{elapsed:.2f}s",
            "backend": self.backend.name,
        }
        if top_n:
            result["top_logprobs"] = [None] + tops
        return result

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

    def _compile_constraint(self, raw: dict):
        """Wire-format constraint -> CompiledConstraint through the engine
        LRU (engine_cfg.constraint_cache_entries). A malformed spec, an
        unsupported schema or an oversized DFA raises ValueError (the
        caller's invalid_request envelope)."""
        from .. import constrain as C

        if not getattr(self.backend, "supports_constrain", False):
            raise ValueError(
                f"backend {self.backend.name!r} does not support "
                f"constrained decoding; serve constrained requests on the "
                f"single-device backend"
            )
        spec = C.parse_constraint_spec(raw)
        key = C.constraint_key(spec)
        with self._constraint_lock:
            art = self._constraint_cache.get(key)
            if art is not None:
                self._constraint_cache.move_to_end(key)
                return art
            if self._constraint_vocab is None:
                self._constraint_vocab = C.TokenVocab.from_tokenizer(
                    self.tokenizer, self.cfg.vocab_size,
                    eos_ids=self.cfg.all_stop_ids,
                    special_ids=(self.cfg.pad_token_id, self.cfg.bos_token_id),
                )
                from ..constrain.tables import _build_trie

                self._constraint_trie = _build_trie(self._constraint_vocab)
            art = C.compile_constraint(spec, self._constraint_vocab,
                                       self._constraint_trie)
            self._constraint_cache[key] = art
            while len(self._constraint_cache) > max(
                    1, self.engine_cfg.constraint_cache_entries):
                self._constraint_cache.popitem(last=False)
            return art

    def _constraint_bias(self, art, bias, state: Optional[int] = None):
        """Fold the mask of FSM state `state` (the DFA start by default)
        into the (possibly absent) logit_bias operand for the FIRST token,
        which prefill samples before any decode FSM exists: -1e9 in fp32
        on every banned token, which a +100 user bias cannot resurrect."""
        st = art.start if state is None else state
        mask_bias = torch.from_numpy(art.state_bias(st)).to(self.device)
        return mask_bias if bias is None else bias + mask_bias

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
                                    generator, sampling, dkw, logprobs, stop,
                                    cart=None, fsm=None):
        """Decode in chunks that escalate up DECODE_BUCKETS when textual
        `stop` strings are set, checking the text between chunks, so a
        stop that matches early does not decode the whole budget. With a
        constraint (`cart`, the FSM state `fsm` after the first token) the
        host re-walks each chunk's tokens through the DFA, once per chunk,
        so the next chunk resumes at the right state. Returns (out [1, N]
        list rows, n_gen, step_lps or None, cache)."""
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
            if cart is not None and row:
                for t in row:
                    fsm = cart.advance(fsm, t)
                dkw = dict(dkw, constraint=(
                    torch.tensor([fsm], dtype=torch.int32, device=self.device),
                ) + dkw["constraint"][1:])
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
        presence_penalty=0.0, constraint=None, trace=None, speculative=False,
    ):
        # chaos hook (utils/faults.py point "solo"): inside the deadline
        # wrapper, so a wedge_s > deadline rule exercises the abandoned-call
        # path: engine._wedged fills, /ready flips 503 past --wedge-unready,
        # and a router ejects the replica until the sleep drains
        faults.check("solo", tag=prompt)
        cfg = self.cfg
        self.request_count += 1
        bias = self._bias_array(logit_bias)
        cart = self._compile_constraint(constraint) if constraint else None
        if cart is not None:
            bias = self._constraint_bias(cart, bias)
            if trace is not None:
                trace.checkpoint("constraint_compile")
        text = self.render_chat(prompt) if chat else prompt
        ids = self.tokenizer.encode(text)
        prompt_len = len(ids)

        buckets = self._buckets()
        if self._cache is None:
            self._cache = self.backend.init_cache(1, cfg.max_seq_len)
        if self._prefix is not None and not PrefixCache.compatible(self._cache):
            log.info("prefix_cache_disabled", reason="cache layout")
            self._prefix = None
        # prefix lookup and the ingest plan (engine/prefix.py)
        p0, entry, plan = self._prefix_plan(self._prefix, ids)
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
        # a penalty or a logit bias changes the argmax the verify compares
        # with, and the speculative loops record no per-step logprobs:
        # such requests decode plainly
        spec_ok = (speculative and greedy and repetition_penalty == 1.0
                   and frequency_penalty == 0.0 and presence_penalty == 0.0
                   and bias is None and not logprobs)
        # the draft model wins over prompt lookup when one is attached
        use_draft = (spec_ok and self._draft is not None
                     and getattr(self.backend, "supports_draft", False))
        use_spec = (spec_ok and not use_draft
                    and getattr(self.backend, "supports_speculative", False))
        max_tokens, decode_bucket = self._clamp_decode(
            prompt_len, max_tokens,
            headroom=SPEC_DRAFT_LEN if (use_spec or use_draft) else 0,
        )
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
        first, logits, cache = self._ingest_with_prefix(
            self._prefix, ids, p0, entry, plan, cache, generator, sampling,
            presence=presence, bias=bias,
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
        fsm0 = None
        if cart is not None:
            # the FSM state after the (bias-masked) first token, walked on
            # the host off the first id already fetched; the decode loop
            # then advances it on the device with no host read per token
            fsm0 = cart.advance(cart.start, first_id)
            cm, ct = cart.device_tables(self.device)
            dkw["constraint"] = (
                torch.tensor([fsm0], dtype=torch.int32, device=self.device), cm, ct)
        step_lps = None
        if use_draft:
            dcfg, dparams = self._draft
            if self._draft_cache is None:
                self._draft_cache = M.init_kv_cache(dcfg, 1, max_seq=cfg.max_seq_len,
                                                    device=self.device)
            dcache = self._draft_ingest(ids, self._draft_cache)
            res = self.backend.decode_draft_speculative(
                dcfg, dparams, first, cache, dcache, prompt_len, max_tokens - 1,
                max_steps=decode_bucket, draft_len=SPEC_DRAFT_LEN,
            )
            out, n_gen, cache = res[0].tolist(), res[1].tolist(), res[2]
            self._draft_cache = res[3]
        elif use_spec:
            # the token history: the prompt, then every emitted token (H
            # fixed per model: max_seq_len + the draft overshoot)
            hist = torch.zeros((1, cfg.max_seq_len + SPEC_DRAFT_LEN + 2),
                               dtype=torch.long, device=self.device)
            hist[0, :prompt_len] = self._tokens(ids)
            res = self.backend.decode_speculative(
                first, cache, hist, prompt_len, max_tokens - 1,
                max_steps=decode_bucket, draft_len=SPEC_DRAFT_LEN,
            )
            out, n_gen, cache = res[0].tolist(), res[1].tolist(), res[2]
        elif stop:
            out, n_gen, step_lps, cache = self._decode_textual_stop_chunks(
                first, cache, prompt_len, max_tokens, generator, sampling,
                dkw, logprobs, stop, cart=cart, fsm=fsm0,
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
        if p0:
            result["prefix_cached_tokens"] = p0
        if stopped:
            result["stopped"] = True
        if token_logprobs is not None:
            result["token_logprobs"] = token_logprobs
            result["token_strings"] = token_strings
        if use_spec or use_draft:
            # the solo loops keep acceptance on the device; the fleet
            # reports "fleet" with its drafted / accepted counts
            result["speculative"] = True
            result["spec_path"] = "solo"
        if cart is not None:
            result["constrained"] = True
        if use_draft:
            result["draft_model"] = self._draft[0].name
        if top_predictions is not None:
            result["top_predictions"] = top_predictions
        return result

    def warmup(self) -> dict:
        """Run every solo serving shape once before traffic, so no request
        pays a kernel build or load, or a first call at a new shape: a
        prefill per prefill bucket (the flash kernel at each chunk width),
        plain and penalized, the chunked extend at the largest bucket, and
        one decode step per decode bucket, plain, penalized and with
        log-probabilities (the JAX engine's warmup program list; the port
        runs them eagerly, so each is run once rather than compiled); then
        one verify iteration of the speculative loop a `speculative`
        request takes: with a draft attached, the draft's ingest per
        prefill bucket and its chunked variant first, then the draft
        loop; else the prompt-lookup loop. On a fleet-granular backend (the
        1F1B schedule) also a batched prefill and decode step per bucket of
        its batch ladder (batch_buckets_for). Returns {"programs": N,
        "seconds": wall}."""
        t0 = time.time()
        buckets = self._buckets()
        if not buckets:
            raise ValueError(
                f"warmup needs at least one prefill bucket <= max_seq_len "
                f"{self.cfg.max_seq_len}; got prefill_buckets="
                f"{self.engine_cfg.prefill_buckets}"
            )
        sampling = G.default_sampling(greedy=True)
        gen = self._generator(0)
        pad = self.cfg.pad_token_id
        presence = torch.zeros((1, self.cfg.vocab_size), dtype=torch.bool,
                               device=self.device)
        n = 0
        with self._lock:
            cache = self._cache
            if cache is None:
                cache = self.backend.init_cache(1, self.cfg.max_seq_len)
            for pres in (None, presence):
                for bucket in buckets:
                    _, _, cache = self.backend.prefill(
                        self._tokens([[pad] * bucket]), 1, cache, gen, sampling,
                        presence=pres)
                    n += 1
            if hasattr(self.backend, "extend"):  # the context ring has none
                cache = self.backend.extend(self._tokens([[pad] * buckets[-1]]), 0, cache)
                n += 1
            # a first token that is no stop token, so each decode runs its step
            first = self._tokens([next(t for t in range(self.cfg.vocab_size)
                                       if t not in self.cfg.all_stop_ids)])
            for kw in ({}, {"presence": presence}, {"with_logprobs": True}):
                for db in DECODE_BUCKETS:
                    res = self.backend.decode(first, cache, 1, 1, gen, sampling,
                                              max_steps=db, **kw)
                    cache = res[2]
                    n += 1
            db = DECODE_BUCKETS[0]
            if self._draft is not None and getattr(self.backend, "supports_draft",
                                                   False):
                dcfg, dparams = self._draft
                dcache = self._draft_cache
                if dcache is None:
                    dcache = M.init_kv_cache(dcfg, 1, max_seq=self.cfg.max_seq_len,
                                             device=self.device)
                for bucket in buckets:
                    dcache = self._draft_ingest([pad] * bucket, dcache)
                    n += 1
                chunked_len = buckets[-1] + 1
                if self._plan_ingest(chunked_len, 0, buckets) is not None:
                    dcache = self._draft_ingest([pad] * chunked_len, dcache)
                    n += 1
                _, _, cache, dcache = self.backend.decode_draft_speculative(
                    dcfg, dparams, first, cache, dcache, 1, 1, max_steps=db,
                    draft_len=SPEC_DRAFT_LEN)
                self._draft_cache = dcache
                n += 1
            elif getattr(self.backend, "supports_speculative", False):
                hist = torch.zeros((1, self.cfg.max_seq_len + SPEC_DRAFT_LEN + 2),
                                   dtype=torch.long, device=self.device)
                _, _, cache = self.backend.decode_speculative(
                    first, cache, hist, 1, 1, max_steps=db, draft_len=SPEC_DRAFT_LEN)
                n += 1
            gran = getattr(self.backend, "batch_granularity", 1)
            if gran > 1:
                # a fleet-granular backend's fleet programs (the 1F1B
                # schedule): one batched prefill and decode step per bucket
                # of its ladder, each bucket's cache kept for its requests
                for Bb in batch_buckets_for(gran):
                    bc = self._batch_caches.pop(Bb, None)
                    if bc is None:
                        bc = self.backend.init_cache(Bb, self.cfg.max_seq_len)
                    rows = self._tokens([[pad] * buckets[0]] * Bb)
                    vs = torch.full((Bb,), buckets[0] - 1, dtype=torch.int32,
                                    device=self.device)
                    f, _, bc = self.backend.prefill(rows, buckets[0], bc, gen, sampling, vs)
                    _, _, bc = self.backend.decode(first.expand(Bb).contiguous(), bc,
                                                   buckets[0], 1, gen, sampling, vs,
                                                   max_steps=DECODE_BUCKETS[0])
                    self._batch_caches[Bb] = bc
                    n += 2
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._cache = cache  # the first request reuses the buffer
        out = {"programs": n, "seconds": round(time.time() - t0, 2)}
        log.info("warmup", **out)
        return out

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
        _trace: Optional[Trace] = None,
    ) -> dict:
        """One batch for N prompts (shared sampling params): ragged prompts
        LEFT-pad to a shared bucket, so every row shares one position
        frame and per-row pad slots are masked through valid_start.
        _trace: a trace to continue (serving/queue.py hands its own)."""
        t_start = time.time()
        trace = _trace if _trace is not None else Trace(request_id)

        def locked():
            with self._lock:
                trace.checkpoint("queue_wait")
                return self._generate_batch_locked(
                    prompts, max_tokens, temperature, top_k, top_p, greedy,
                    chat, seed, t_start, min_p, repetition_penalty, stop,
                    frequency_penalty, presence_penalty, constraint, trace,
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
        frequency_penalty=0.0, presence_penalty=0.0, constraint=None, trace=None,
    ):
        cfg = self.cfg
        if not prompts or not all(isinstance(p, str) and p for p in prompts):
            raise ValueError("prompts must be a non-empty list of non-empty strings")
        if cfg.arch != "llama":
            raise ValueError(
                f"batched generation is llama-family only (left-padding needs "
                f"relative positions); model arch is {cfg.arch!r}"
            )
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
        # prompts, sliced off the results below. A fleet-granular backend
        # (1F1B: rows % (dp * M) == 0) pads on its granularity ladder, the
        # one warmup runs
        gran = getattr(self.backend, "batch_granularity", 1)
        Bb = G.pick_bucket(batch_buckets_for(gran), B)
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
        # one shared grammar constraint: every row decodes under the SAME
        # tables, each walking its own FSM state
        cart = self._compile_constraint(constraint) if constraint else None
        generator = self._generator(seed)
        cache = self._batch_caches.pop(Bb, None)
        if cache is None:
            cache = self.backend.init_cache(Bb, cfg.max_seq_len)
        pkw = {"presence": presence}
        if cart is not None:
            # the first token's mask rides the bias operand ([V] broadcasts
            # over the rows), as on the solo path
            pkw["bias"] = self._constraint_bias(cart, None)
            if trace is not None:
                trace.checkpoint("constraint_compile")
        first, logits, cache = self.backend.prefill(
            tokens, bucket, cache, generator, sampling, valid_start, **pkw,
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
        bkw = {}
        if cart is not None:
            # each row's FSM state after its first token, walked on the host
            # off the firsts already fetched (the dummy rows' EOS firsts
            # start finished: their state is inert)
            fsm0 = [cart.advance(cart.start, int(t)) for t in firsts]
            cm, ct = cart.device_tables(self.device)
            bkw["constraint"] = (torch.tensor(fsm0, dtype=torch.int32,
                                              device=self.device), cm, ct)
        out, n_gen, cache = self.backend.decode(
            first, cache, bucket, max_tokens - 1, generator, sampling,
            valid_start, presence, counts, max_steps=decode_bucket, **bkw,
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
        result = {
            "results": results,
            "status": "success",
            "batch_size": B,
            "time_taken": f"{elapsed:.2f}s",
            "tokens_generated": total_tokens,
            "tokens_per_sec": f"{tps:.2f}",
            "ttft_s": round(ttft, 4),
            "backend": self.backend.name,
        }
        if cart is not None:
            result["constrained"] = True
        return result

    # -- perf stats ----------------------------------------------------------
    def stats(self) -> dict:
        """Rolling p50/p90/p99 over recent requests (TTFT seconds,
        tokens/sec) plus the lifetime sample count, and the solo prefix
        cache's counts when it is on."""
        with self._samples_lock:
            samples = list(self._samples)
            samples_total = self._samples_total
        ttfts = [s["ttft_s"] for s in samples]
        tpss = [s["tokens_per_sec"] for s in samples]
        out = {
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
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        # the metrics -> traces pivot: each latency bucket names the most
        # recent traced request that landed in it
        snap = self.metrics.snapshot()
        exemplars: dict = {}
        for fam in ("dli_ttft_seconds", "dli_tpot_seconds",
                    "dli_request_duration_seconds"):
            for series in snap.get(fam, {}).get("series", []):
                if series.get("exemplars"):
                    exemplars.setdefault(fam, {}).update(series["exemplars"])
        if exemplars:
            out["exemplars"] = exemplars
        return out

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
