"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch twin on the card, then serves
tinyllama-1.1b (published widths, 22 layers, bf16, random weights from
seed 0) through the port's own HTTP server, solo, as the continuous
paged fleet (chunked and whole-prefill) and as the dense slot fleet,
and checks that the served requests went through the kernels. Phases,
each of which fails the run:

  (a) the device, `nvidia-smi`'s name and power limit, the kernel build;
  (b) flash_attend vs its plain twin at tinyllama's attention shapes
      (H=32, KV=4, Dh=64, S=2048), bf16 and fp32, with its launch plan,
      kernel, twin, SDPA-yardstick and bound times (the kernel and SDPA,
      over the whole cache and over the live slice, timed in turn);
  (c) three solo /generate requests (greedy, sampled, and a prompt longer
      than the largest prefill bucket so chunked extend runs), the greedy
      one repeated; the kernel's launch count must rise by n_layers per
      T>1 chunk;
  (d) the same model's logits with attn_impl="kernel" vs "plain";
  (e) a profiled solo request: TTFT, tokens/s, device idle share;
  (f) paged_flash_attend and ragged_paged_attend vs their twins at
      tinyllama's widths over shuffled block tables (16-token blocks,
      1024-token slots), bf16 and fp32, with window / per-layer window /
      softcap / scale variants, kernel and twin times and the bound; the
      paged decode kernel (csrc/decode_walk.cuh's split-KV walk through
      the block table) with its split count, repeats bit-equal, timed as
      medians of calls in turn with flash_attend_slots over a dense cache
      that holds the same rows at the same positions (the cost of the
      table), and at the fleet's B=8 its profiled device time; the ragged
      kernel (csrc/flash_walk.cuh's flash walk through the block table,
      split over a thread-block cluster) with its plan, repeats
      bit-equal, timed as medians of calls, a launch of one table row in
      turn with flash_attend over that row as a dense cache, and on the
      fleet's mixed launch its profiled device time;
  (g) the fleet (`--continuous 8 --kv-pool-blocks 513 --kv-block-size 16
      --continuous-max-seq 1024`) serving 8 concurrent requests of 8 to
      700 prompt tokens through the HTTP server: every request answers,
      mixed launches carry decode rows and prompt chunks at once, each
      mixed launch runs ragged_paged_attend once per layer and each decode
      chunk paged_flash_attend once per layer and step, a greedy request
      repeats exactly on the idle fleet, and every pool block comes back;
  (h) scripted mixed launches and a decode step through the kernels vs
      attn_impl="plain" (logits and greedy tokens), and one mixed launch
      and one decode chunk under torch.cuda.set_sync_debug_mode("error");
  (i) per-request TTFT and tokens/s, the wave's aggregate tokens/s, the
      device idle share and kernels per token of one profiled mixed
      launch and one decode chunk;
  (j) the int4 / int8 kernels vs their twins: q4_matmul_rows at
      tinyllama's projection shapes (R = 1, 8, 32; bf16 and fp32; its
      grid plan; the kernel and torch.matmul against the dequantized
      weight, the yardstick, timed in turn), and
      the int8-cache variants of flash_attend (a subset of (b)'s cases)
      and of the two paged kernels ((f)'s cases over int8 pools);
  (k) the same model under `--quant int4 --kv-quant int8`: the fleet
      wave of (g) through the HTTP server, with q4_matmul_rows launched
      (7 x 22 + 1) times per decode step and twice per mixed launch and
      the int8 paged kernels as in (g), then one solo request whose
      prompt chunks through the int8 flash_attend;
  (l) the quantized fleet's kernel path vs its plain attention path, and
      the sync check, as in (h);
  (m) the quantized wave's TTFT and tokens/s, its profiled mixed launch
      and decode chunk, the kernels' JSON line (eight entries), and as
      the last line {"ok": true, "device": {...}}.

Run after (i), on the raw engine, before (j):

  (n) flash_attend_slots (csrc/slots_attention.cu, a split-KV kernel:
      each row's live range shared by n_split blocks, cp.async tiles,
      tensor-core products for bf16, partials merged in a fixed order)
      driven directly, as the JAX package's bench.py drives its kernel
      (no serving hook selects it), then against its twin at bench.py's
      shapes (8 slots, S=8192, pos 1024), the dense fleet's (S=1024, tile
      edges, pos = S), S=1000, B=1 at split edges (the most splits) and
      B=32 on both sides of every tile edge (the fewest), window None /
      256, bf16 and fp32, repeats bit-equal; the kernel and SDPA timed in
      turn in one loop (median of 30 cold-L2 calls each), the twin and
      the einsum (attend over the whole cache, the JAX yardstick) as
      means; then bench.py's call captured in a CUDA graph, its replay
      bit-equal to an eager call under the sync check after pos changes
      in place;
  (o) the dense fleet (`--continuous 8 --continuous-max-seq 1024`, no
      pool) serving (g)'s wave: flash_attend n_layers times per T>1
      prefill chunk, no paged kernel and no flash_attend_slots (decode
      keeps the einsum, the JAX gate), a greedy repeat, a decode chunk
      under the sync check, kernel vs plain logits of a dense admission,
      a profiled decode chunk;
  (p) the paged fleet of (g) with chunked_prefill=False (ragged
      whole-prefill) and ragged_prefill=False (bucketed, scattered into
      the blocks) on a 4-request wave: n_layers prefill-kernel launches
      per prefill launch, paged_flash_attend at decode, every block back;
  (q) the fleet's CUDA graphs (engine/graphs.py), after (p) on the raw
      engine and after (m) on the quantized one: the mixed launch (arming,
      then with the idle arm: one graph serves both), the paged decode
      chunk and the dense decode chunk, each captured and replayed on
      (h)'s operands under set_sync_debug_mode("error"), every replay
      bit-equal to the eager body on a clone of its buffers with the same
      generator state, the kernel counters moving by the capture's deltas
      per replay; replay and eager wall, device busy and idle share and
      kernels per token side by side, the paged attention kernels' device
      ms by kernel name, the ragged kernel's per mixed launch, and on the
      quantized engine the q4 kernels'.

Run after (q) on the raw engine, before (j), each on 2-slot paged fleets
(16-token blocks, 1024-token slots) through the HTTP server ("r" is the
ragged kernel's `--only` run, so the letters skip it):

  (s) KV preemption under the default policy ("swap", recomputing with no
      KV shadow): on a 65-block pool, A (600 prompt + 256 new tokens, 54
      blocks) decodes when B (300 + 64, 23 blocks) arrives, so B is placed
      only by preempting A; both answer in full, A's envelope carries
      `preempted` and `recovered`, every block comes back, each launch kind
      is captured once and replayed after the resume, the two paged kernels
      launched n_layers times per ragged launch and per decode step, and A's
      tokens fetched before its preemption equal A's run alone on the same
      fleet (whether the rest does, and where it parts, is printed); the
      pair's wall, tokens/s and the time from A's preemption to its first
      resumed token;
  (t) the supervisor: a one-shot transient fault (utils/faults.py) at
      admission, alloc, prefill, decode_launch and fetch in turn, each
      answered in full after one restart with the pool clean, the graphs
      still captured once and the tokens fetched before the crash those of
      the unfaulted run (the restart's wall, crash to the next launch,
      printed); a poison prompt quarantined (HTTP 500, "poison") within two
      strikes while its fleet-mate answers; last, on a fleet of its own, a
      fault on every decode launch until the restart budget is spent: 503
      "unavailable" for every request, /ready 503 "scheduler_dead", no block
      leaked;
  (u) the health sweep: /workers answers worker_1 online with probe_ms, and
      online or busy (never offline) while a long request runs; / answers
      the HTML status page; /profiler/start, one request, /profiler/stop
      leaves a trace that names the port's kernels; /debug/flight holds (s)'s
      and (t)'s preempt, crash, restart, quarantine and scheduler_dead
      events.

`python3 chip_smoke.py --only s` runs (a), then (s), (t) and (u) alone on
the raw engine (about two minutes).

`python3 chip_smoke.py --only j` runs (a) and (j)'s q4_matmul_rows cases
alone, with the kernel's build log (registers, spills); `--only b` runs
(a), (b), a sweep of flash_attend's cluster sizes and the kernels line's
two flash_attend entries at (c)'s chunk shapes, with its build log;
`--only f` runs (a) and (f)'s and (j)'s paged_flash_attend cases with
the kernels line's two paged_flash_attend entries and the paged source's
build log; `--only r` runs (a) and (f)'s and (j)'s ragged_paged_attend
cases, a sweep of its plans (cluster, min_share) with 16 decode rows
timed in turn with paged_flash_attend, and the kernels line's two ragged
entries, with the paged source's build log. All four also run from an
older checkout of the package (the split count, the plans and the sweep
are then left out), so that parent and change can be timed in one call.

The fleets of (g), (k), (o) and (p) serve through those graphs: each
checks one capture per launch kind and every later launch a replay.

It needs a CUDA device and the repository: with no card, or run from a
directory that holds nothing else of the repository, it exits non-zero
and prints no result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

MODEL = "tinyllama-1.1b"
DEVICE = "cuda"
# small on purpose: the long prompt below chunk-prefills through extend()
PREFILL_BUCKETS = (64, 128)
H, KV, DH, S = 32, 4, 64, 2048  # tinyllama's attention widths and cache
# kernel vs twin on the card: fp32 differs only in summation order; bf16
# outputs round to bf16's ~3 significant digits
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernel path vs plain path logits through 22 bf16 layers. The logits
# have a spread (std) of ~1 with these random weights, and each layer's
# attention output may round one bf16 ulp apart on the two paths: on the
# CPU, at half tinyllama's width and full depth, that rounding alone
# gives a max difference of 0.07. A wrong mask or tile walk moves logits
# by O(1).
LOGITS_ATOL = 0.25
# the quantized fleet's logits, kernel path vs plain attention path
# (q4_matmul_rows runs on both): the bf16 ulp of (d) and (h), plus the
# int8 cache, where a K/V value the two paths round to neighbouring bf16
# values may be stored one int8 step (~absmax / 127) apart. A CPU run of
# tests/test_torch_kv_quant.py puts one such step at ~2e-3 of a logit; a
# wrong mask, tile walk or scale moves logits by O(1).
QUANT_LOGITS_ATOL = 0.25
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s by input type
# (fp32 runs on the CUDA cores, not the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# Timer.alternating's device-side spin before each timed call: ~0.2 ms
# at the H100's ~1.98 GHz, longer than a wrapper's host time
HEAD_START_CYCLES = 400_000

# logprobs pin every emitted token: random weights mostly emit ids past
# the byte tokenizer's 259, which decode to no text
GREEDY = {"prompt": "The history of the printing press begins", "max_tokens": 32,
          "greedy": True, "chat": False, "logprobs": True}
SAMPLED = {"prompt": "Write a short poem about the sea.", "max_tokens": 32,
           "temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}
# the T>1 chunks (T, pos) that (c)'s four requests run: `--only b` times
# the kernels line's flash_attend entries at them without serving
SOLO_CHUNKS = [(64, 0), (128, 0), (128, 0), (128, 128), (128, 256), (128, 384),
               (128, 512), (64, 640), (64, 0)]
LONG = {"prompt": " ".join(
            f"Paragraph {i}: the quick brown fox jumps over the lazy dog."
            for i in range(12)),
        "max_tokens": 16, "greedy": True, "chat": False}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, averaged over `reps` launches, each from a
    cold L2 (a 256 MB write between launches): on the served path every
    layer's attention meets its own K/V after the layer's weights have
    streamed through the cache."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / reps

    def alternating(self, fns, reps: int) -> list:
        """The median device time of each of `fns`, called in turn `reps`
        times, each call from a cold L2: the card's drift from call to
        call falls on all of them alike. A device-side spin of
        HEAD_START_CYCLES after the flush lets the host enqueue the call
        before the card reaches it, so the span holds the call's kernels
        and not the wrapper's host time (~30 us a call on that host)."""
        torch = self.torch
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        times = [[] for _ in fns]
        for _ in range(reps):
            for t, fn in zip(times, fns):
                self.flush.zero_()
                torch.cuda._sleep(HEAD_START_CYCLES)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                t.append(e0.elapsed_time(e1))
        return [statistics.median(t) for t in times]

    def device_ms(self, fn, reps: int):
        """The device time of fn's own kernels per call (torch.profiler),
        each call from a cold L2: the kernels alone, without the launch
        and event overhead that a span of `alternating` holds. After an
        earlier profiled phase a trace may lose a few of its first
        kernels: where fn launches each of its kernels once, the sum of
        each kernel's mean stands for the call; otherwise a trace that
        lost any is not measured (None)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and "FillFunctor" not in e.name]
        by_name = {}
        for e in kern:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if not kern:
            return None
        if all(len(us) % reps == 0 for us in by_name.values()):
            return sum(map(sum, by_name.values())) / reps / 1e3
        if all(len(us) <= reps for us in by_name.values()):
            return sum(sum(us) / len(us) for us in by_name.values()) / 1e3
        return None


def kv_row_bytes(dtype_name, int8):
    """Bytes of one position's K or V row of one KV head: Dh elements, or
    Dh int8 bytes and a 4-byte scale."""
    return DH + 4 if int8 else DH * (4 if dtype_name == "float32" else 2)


def flash_work(B, T, pos, valid_start, window, dtype_name, int8=False):
    """(bytes, FLOPs) the attention of this call needs: q read and o
    written once, each live K/V row read once, and 4*Dh FLOPs per head for
    each (query, key) pair the mask lets through (the two products)."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = 2 * B * T * H * DH * esize
    pairs = 0
    for b in range(B):
        vs = valid_start[b] if valid_start is not None else 0
        lo_min = None
        for t in range(T):
            q_pos = pos + t
            lo = vs
            if window is not None and window > 0:
                lo = max(lo, q_pos - window + 1)
            pairs += max(q_pos + 1 - lo, 0)
            lo_min = lo if lo_min is None else min(lo_min, lo)
        nbytes += 2 * KV * kv_row_bytes(dtype_name, int8) * max(pos + T - lo_min, 0)
    return nbytes, 4 * DH * H * pairs


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def int8_leaf(torch, x):
    """x [..., Dh] as an int8 cache leaf (data and per-row scales)."""
    from distributed_llm_inference_tpu_torch.ops import kv_quant as K

    return K.KVQuant(*K.quantize_chunk(x))


def flash_case(torch, timer, fa, *, dtype_name, B, T, pos, valid_start=None,
               window=None, softcap=None, scale=None, seed=0, reps=15, int8=False,
               profile=False):
    """One kernel-vs-twin comparison with its times, over a raw or an int8
    cache; returns a dict. SDPA, the yardstick, runs twice in the same
    loop: over the whole cache (the tables' column) and over the live
    slice k[:, :, :pos + T] (the dead keys' work left out). With
    `profile`, the kernel's and SDPA's own device time per call too."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, T, H, DH, generator=g, device=DEVICE).to(dt)
    k = torch.randn(B, KV, S, DH, generator=g, device=DEVICE)
    v = torch.randn(B, KV, S, DH, generator=g, device=DEVICE)
    k, v = (int8_leaf(torch, k), int8_leaf(torch, v)) if int8 else (k.to(dt), v.to(dt))
    vs = (torch.tensor(valid_start, dtype=torch.int32, device=DEVICE)
          if valid_start is not None else None)
    kw = dict(window=window, softcap=softcap, scale=scale)
    got = fa.flash_attend(q, k, v, pos, vs, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attend_plain(q, k, v, pos, vs, **kw)
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), "flash_attend: non-finite output")
    check(torch.equal(got, fa.flash_attend(q, k, v, pos, vs, **kw)),
          "flash_attend gave other bits on a repeat")
    plain_ms = timer.ms(lambda: fa.flash_attend_plain(q, k, v, pos, vs, **kw),
                        max(2, reps // 4))
    kernel = lambda: fa.flash_attend(q, k, v, pos, vs, **kw)  # noqa: E731
    fns = [kernel]
    # SDPA has no softcap and reads no int8 cache: no single call computes those
    if softcap is None and not int8:
        q_pos = pos + torch.arange(T, device=DEVICE)
        kv_pos = torch.arange(S, device=DEVICE)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None and window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        mask = mask[None, None].expand(B, 1, T, S)
        if vs is not None:
            mask = mask & (kv_pos[None, None, None, :] >= vs[:, None, None, None])
        live = pos + T
        mask, live_mask = mask.contiguous(), mask[..., :live].contiguous()
        qt = q.transpose(1, 2)
        k_live, v_live = k[:, :, :live], v[:, :, :live]
        fns.append(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
        fns.append(lambda: F.scaled_dot_product_attention(
            qt, k_live, v_live, attn_mask=live_mask, scale=scale, enable_gqa=True))
    # the kernel and SDPA in turn: medians of `reps` cold-L2 calls each
    ms, library_ms, library_live_ms = (timer.alternating(fns, reps) + [None, None])[:3]
    device_ms = library_device_ms = None
    if profile:
        device_ms = timer.device_ms(kernel, 10)
        if len(fns) > 1:
            library_device_ms = timer.device_ms(fns[1], 10)
    nbytes, flops = flash_work(B, T, pos, valid_start, window, dtype_name, int8)
    bound_ms, bound_by = bound(nbytes, flops, dtype_name)
    # the launch plan (an older checkout, timed by `--only b`, has none)
    plan = (fa.flash_plan(B, T, H, KV, S, DH, fa._sm_count(q.device), q.element_size(),
                          1 if int8 else None, pos)._asdict()
            if hasattr(fa, "flash_plan") else None)
    return dict(dtype=dtype_name, int8=int8, B=B, T=T, pos=pos, valid_start=valid_start,
                window=window, softcap=softcap, scale=scale, max_abs_err=err,
                atol=ATOL[dtype_name], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_live_ms=library_live_ms,
                device_ms=device_ms, library_device_ms=library_device_ms,
                bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes, flops=flops,
                plan=plan)


def cluster_sweep(torch, timer, fa):
    """flash_attend at (c)'s chunk shapes and a full 2048-token prefill,
    bf16, with each cluster size launched in turn (medians of 20 cold-L2
    calls): the measurement that `flash_plan`'s choice rests on."""
    print("(b) cluster sweep, bf16 B=1: medians of 20 cold-L2 calls in turn, ms "
          "per cluster size; * = flash_plan's choice")
    g = torch.Generator(device=DEVICE).manual_seed(3)
    for T, pos in sorted(set(SOLO_CHUNKS)) + [(2048, 0)]:
        q = torch.randn(1, T, H, DH, generator=g, device=DEVICE).to(torch.bfloat16)
        k = torch.randn(1, KV, S, DH, generator=g, device=DEVICE).to(torch.bfloat16)
        v = torch.randn(1, KV, S, DH, generator=g, device=DEVICE).to(torch.bfloat16)
        chosen = fa.flash_plan(1, T, H, KV, S, DH, fa._sm_count(q.device), pos=pos)
        plans = [chosen._replace(cluster=c, blocks=chosen.blocks // chosen.cluster * c)
                 for c in (1, 2, 4, 8)]
        times = timer.alternating(
            [lambda p=p: fa.flash_attend(q, k, v, pos, plan=p) for p in plans], 20)
        print(f"    T={T} pos={pos}: " + " ".join(
            f"{p.cluster}{'*' if p.cluster == chosen.cluster else ''}={t:.4f}"
            for p, t in zip(plans, times)))


def fmt_ms(x):
    return "n/a" if x is None else format(x, ".4f")


def phase_b(torch, timer, fa, int8=False):
    """flash_attend vs its twin at tinyllama's shapes (with an int8 cache:
    a subset of the cases)."""
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        for B in (1, 4):
            for T in (64, 512, 2048):
                for pos in (0, 700):
                    if T + pos <= S and not (int8 and (B, T) == (4, 2048)):
                        cases.append(dict(dtype_name=dtype_name, B=B, T=T, pos=pos,
                                          int8=int8))
        cases += [dict(c, int8=int8) for c in [
            dict(dtype_name=dtype_name, B=4, T=512, pos=700,
                 valid_start=[0, 37, 300, 700]),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, window=256),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, softcap=30.0),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, scale=0.2),
        ]]
    rows = []
    tag, name = ("(j)", "flash_attend[int8]") if int8 else ("(b)", "flash_attend")
    print(f"{tag} {name} vs plain twin, H={H} KV={KV} Dh={DH} S={S}; device "
          f"ms per call, cold L2; kernel, sdpa (whole cache) and sdpa_live (the "
          f"live slice): medians of 15 calls in turn; plan (cluster, blocks)")
    for i, c in enumerate(cases):
        r = flash_case(torch, timer, fa, seed=i, **c)
        rows.append(r)
        extra = {k: r[k] for k in ("valid_start", "window", "softcap", "scale")
                 if r[k] is not None}
        plan = r["plan"]
        print(f"    {r['dtype']:8s} B={r['B']} T={r['T']:4d} pos={r['pos']:3d} "
              f"{json.dumps(extra) if extra else '':28s} "
              + (f"cluster={plan['cluster']} blocks={plan['blocks']} " if plan else "")
              + f"err={r['max_abs_err']:.3g} (atol {r['atol']:g}) kernel={r['ms']:.4f} "
              f"plain={r['plain_ms']:.4f} sdpa={fmt_ms(r['library_ms'])} "
              f"sdpa_live={fmt_ms(r['library_live_ms'])} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.4f} of it)")
    bad = [r for r in rows if not r["max_abs_err"] <= r["atol"]]
    check(not bad, f"{name} disagrees with its twin in {len(bad)} case(s)")
    return rows


def post(port, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def chunk_shapes(engine, body):
    """The T>1 chunks (T, pos) the solo engine runs for this request's
    prompt: its own bucket plan, n_full extend() chunks then the final
    bucket-padded one."""
    text = engine.render_chat(body["prompt"]) if body.get("chat", True) else body["prompt"]
    n_full, _rem, bucket, chunk = engine._plan_ingest(
        len(engine.tokenizer.encode(text)), 0, engine._buckets())
    return [(chunk, c * chunk) for c in range(n_full)] + [(bucket, n_full * chunk)]


def phase_c(torch, engine, fa):
    """Serve three requests (and the greedy one again) through the port's
    HTTP server; every T>1 chunk must launch the kernel once per layer."""
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    L = engine.cfg.n_layers
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64)
    server.start()
    try:
        check(get(server.port, "/health")[1]["status"] == "healthy", "/health")
        results, shapes = {}, []
        fa.flash_attend.launches = 0  # the main path's run starts here
        for name, body in (("greedy", GREEDY), ("sampled", SAMPLED),
                           ("long", LONG), ("greedy_again", GREEDY)):
            chunks = chunk_shapes(engine, body)
            before = fa.flash_attend.launches
            code, r, wall = post(server.port, body)
            launched = fa.flash_attend.launches - before
            results[name] = (code, r, wall)
            shapes += chunks
            print(f"(c) {name}: HTTP {code} tokens={r.get('tokens_generated')} "
                  f"finish={r.get('finish_reason')} ttft_s={r.get('ttft_s')} "
                  f"tokens_per_sec={r.get('tokens_per_sec')} wall_s={wall:.3f} "
                  f"chunks={chunks} kernel_launches={launched}")
            check(code == 200 and r.get("status") == "success", f"{name}: {r}")
            check(r["tokens_generated"] == body["max_tokens"]
                  or r["finish_reason"] == "stop",
                  f"{name}: {r['tokens_generated']} of {body['max_tokens']} tokens "
                  f"without a stop")
            check(launched == L * len(chunks),
                  f"{name}: {launched} kernel launches for {len(chunks)} T>1 "
                  f"chunk(s) of {L} layers")
        launches = fa.flash_attend.launches
        check(launches > 0, "the served requests never launched flash_attend")
        check(len(chunk_shapes(engine, LONG)) > 1, "the long prompt did not chunk")
        g1, g2 = results["greedy"][1], results["greedy_again"][1]
        check((g1["response"], g1["token_logprobs"])
              == (g2["response"], g2["token_logprobs"]),
              "the repeated greedy request gave other tokens")
        stats = get(server.port, "/stats")[1]
        print(f"(c) /stats: {json.dumps(stats)}")
    finally:
        server.shutdown()
    return results, shapes, launches


def phase_d(torch, engine):
    """Kernel path vs plain path on the served model: a prefill chunk and a
    chunk at an offset, logits at every position."""
    from distributed_llm_inference_tpu_torch.models import api as M

    cfg_k = engine.cfg
    cfg_p = cfg_k.replace(attn_impl="plain")
    params = engine.backend.params
    g = torch.Generator(device=DEVICE).manual_seed(1)
    toks = torch.randint(3, cfg_k.vocab_size, (1, 160), generator=g, device=DEVICE)
    out = {}
    with torch.no_grad():
        for cfg in (cfg_k, cfg_p):
            cache = M.init_kv_cache(cfg, 1, max_seq=S, device=DEVICE)
            a, cache = M.forward(cfg, params, toks[:, :96], cache, 0)
            b, cache = M.forward(cfg, params, toks[:, 96:], cache, 96)
            out[cfg.attn_impl] = torch.cat([a, b], dim=1)
    k, p = out["kernel"], out["plain"]
    check(bool(torch.isfinite(k).all()) and k.shape == (1, 160, cfg_k.vocab_size),
          "kernel-path logits not finite or misshapen")
    err = (k - p).abs().max().item()
    mean_err = (k - p).abs().mean().item()
    top2 = p[0, -1].topk(2).values
    gap = (top2[0] - top2[1]).item()
    tok_k, tok_p = int(k[0, -1].argmax()), int(p[0, -1].argmax())
    print(f"(d) logits kernel vs plain: max_abs_err={err:.4g} (atol {LOGITS_ATOL}) "
          f"mean_abs_err={mean_err:.4g} "
          f"logit spread (std)={p.std().item():.3f}; first greedy token "
          f"kernel={tok_k} plain={tok_p} (plain top-2 gap {gap:.4g})")
    check(err <= LOGITS_ATOL, "kernel-path logits disagree with the plain path")
    # a greedy token can only be pinned where the top-2 gap exceeds the
    # logits' own tolerance
    check(tok_k == tok_p or gap <= 2 * err, "first greedy token differs")
    return err


def busy_union_us(kernels) -> float:
    """Device busy time: the union of the kernels' intervals, in us."""
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return busy_us


def phase_profile(torch, engine):
    """Where a warm greedy request's time goes, from one run under
    torch.profiler (which adds host time of its own): the device's busy
    share (the union of kernel intervals over the request's wall time),
    kernels per generated token, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = engine.generate(GREEDY["prompt"], max_tokens=GREEDY["max_tokens"],
                            greedy=True, chat=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(r["status"] == "success", f"profiled request: {r}")
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = busy_union_us(kern)
    n_tok = r["tokens_generated"]
    print(f"(e) profiled greedy request: wall_ms={wall_us / 1e3:.2f} "
          f"timings={json.dumps(r['timings'])} tokens={n_tok}")
    if not kern:
        print("(e) device busy share: not measured (the profiler recorded no "
              "device kernels)")
        return
    print(f"(e) device busy_ms={busy_us / 1e3:.2f} busy_share={busy_us / wall_us:.4f} "
          f"idle_share={1 - busy_us / wall_us:.4f} kernels={len(kern)} "
          f"kernels_per_token={len(kern) / max(n_tok, 1):.1f}")
    for ms, count, name in top_kernels(kern, 8):
        print(f"    {ms:8.3f} ms {count:5d}x  {name[:100]}")


def kernels_line(torch, timer, fa, shapes, launches, int8=False):
    """flash_attend's JSON entry (or its int8-cache variant's), timed at
    the main path's own chunk shapes (bf16, B=1, as served) and averaged
    per launch over them; each shape's kernel and SDPA times, profiled
    device times and plan printed on a line of their own."""
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "library_live_ms", "device_ms",
            "library_device_ms", "nbytes", "flops")
    tot = dict.fromkeys(keys, 0.0)  # a key turns None where a case has none
    n = 0
    err = 0.0
    name = "flash_attend[int8]" if int8 else "flash_attend"
    for i, ((T, pos), c) in enumerate(sorted(counts.items())):
        r = flash_case(torch, timer, fa, dtype_name="bfloat16", B=1, T=T, pos=pos,
                       seed=100 + i, reps=20, int8=int8, profile=True)
        check(r["max_abs_err"] <= r["atol"], f"{name} at main-path shape {T, pos}")
        err = max(err, r["max_abs_err"])
        for key in keys:
            tot[key] = None if tot[key] is None or r[key] is None else tot[key] + c * r[key]
        n += c
        plan = r["plan"]
        print(f"    {name} main-path chunk T={T} pos={pos} x{c}: "
              + (f"cluster={plan['cluster']} blocks={plan['blocks']} " if plan else "")
              + f"kernel={r['ms']:.4f} sdpa={fmt_ms(r['library_ms'])} "
              f"sdpa_live={fmt_ms(r['library_live_ms'])} profiled kernel="
              f"{fmt_ms(r['device_ms'])} profiled sdpa={fmt_ms(r['library_device_ms'])} "
              f"bound={r['bound_ms']:.6f}")
    bound_ms, bound_by = bound(tot["nbytes"], tot["flops"], "bfloat16")
    mean = {k: None if v is None else v / n for k, v in tot.items()}
    return {
        "name": name,
        "route": "cuda",
        "source": "distributed_llm_inference_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distributed_llm_inference_tpu/ops/flash_attention.py:84",
        "launches": launches,
        "max_abs_err": err,
        "ms": mean["ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": bound_ms / n,
        "bound_by": bound_by,
        # no single PyTorch call attends an int8 cache: SDPA's keys are None
        "library_ms": mean["library_ms"],
        # SDPA over the live slice, and both calls' profiled device time
        "library_live_ms": mean["library_live_ms"],
        "device_ms": mean["device_ms"],
        "library_device_ms": mean["library_device_ms"],
        "shapes": f"bf16 B=1 H={H} KV={KV} Dh={DH} S={S}"
                  + (", int8 cache" if int8 else "") + ", (T, pos) per chunk: "
                  + ", ".join(f"{s}x{c}" for s, c in sorted(counts.items())),
    }


# -- the continuous paged fleet: phases (f) to (i) ------------------------------

BLOCK, SLOT_MB = 16, 64  # the fleet's 16-token pool blocks, 1024-token slots
RAGGED_W, RAGGED_TILE = 128, 8  # the mixed launch's width (step budget), query tile
SPECIAL_POS = [0, 15, 16, 700, 1023]  # block edges, a deep and the last position
PAGED_REPS = 20  # cold-L2 calls of the paged decode kernel (and the slots reference), in turn
RAGGED_REPS = 20  # cold-L2 calls of the ragged kernel (and the flash_attend reference), in turn
# (label, static kwargs, per-layer window operand)
PAGED_VARIANTS = [("", {}, None), ("window=256", {"window": 256}, None),
                  ("window_dyn=300", {}, 300), ("softcap=30", {"softcap": 30.0}, None),
                  ("scale=0.2", {"scale": 0.2}, None)]
FLEET = dict(n_slots=8, chunk_steps=16, chunk_lag=2, slot_max_seq=1024,
             kv_pool_blocks=513, kv_block_size=BLOCK)
FLEET_PROMPT_TOKENS = (8, 24, 60, 120, 200, 330, 480, 700)
FLEET_NEW_TOKENS = 32
SAMPLED_KNOBS = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}


def paged_pool(torch, dt, rows, seed, int8=False):
    """A random pool [N, KV, 16, Dh] (raw, or int8 with its scales) and
    `rows` block tables of 64 blocks each, drawn from a shuffled
    permutation of blocks 1..N-1 (0 is the trash block), so the kernels'
    table walk really jumps."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = rows * SLOT_MB + 1
    pool_k = torch.randn(n, KV, BLOCK, DH, generator=g, device=DEVICE)
    pool_v = torch.randn(n, KV, BLOCK, DH, generator=g, device=DEVICE)
    if int8:
        pool_k, pool_v = int8_leaf(torch, pool_k), int8_leaf(torch, pool_v)
    else:
        pool_k, pool_v = pool_k.to(dt), pool_v.to(dt)
    perm = torch.randperm(n - 1, generator=g, device=DEVICE)[: rows * SLOT_MB] + 1
    return g, pool_k, pool_v, perm.reshape(rows, SLOT_MB).to(torch.int32).contiguous()


def paged_work(row_queries, width, dtype_name, window, index_bytes, int8=False):
    """(bytes, FLOPs) of one paged attention launch: q read once for the
    live query rows only (the kernel never reads a padding row), o written
    once for all `width` rows (padding rows get zeros), each table row's
    live keys' K/V rows read once with the table entries that locate them,
    the per-query or per-tile indices (`index_bytes`), and 4*Dh FLOPs per
    head for each (query, key) pair the mask lets through. row_queries:
    {table row: [query positions]}."""
    esize = 4 if dtype_name == "float32" else 2
    live = sum(len(qs) for qs in row_queries.values())
    nbytes = (live + width) * H * DH * esize + index_bytes
    pairs = 0
    for qs in row_queries.values():
        lows = [max(0, q - window + 1) if window else 0 for q in qs]
        pairs += sum(q + 1 - lo for q, lo in zip(qs, lows))
        lo, hi = min(lows), max(qs)
        nbytes += (2 * KV * kv_row_bytes(dtype_name, int8) * (hi + 1 - lo)
                   + 4 * (hi // BLOCK - lo // BLOCK + 1))
    return nbytes, 4 * DH * H * pairs


def dense_rows(torch, pool, table):
    """The pool's rows of each table row as a dense cache [B, KV, MB*bs, Dh]
    (an int8 pool: its data and its scales [B, KV, MB*bs] alike): key p of
    row b at position p, as the block table places it."""
    from distributed_llm_inference_tpu_torch.ops import kv_quant as K

    if isinstance(pool, K.KVQuant):
        return K.KVQuant(dense_rows(torch, pool.q, table),
                         dense_rows(torch, pool.s[..., None], table)[..., 0].contiguous())
    B, MB = table.shape
    _, KV_, bs, Dh = pool.shape
    return pool[table.long()].permute(0, 2, 1, 3, 4).reshape(B, KV_, MB * bs, Dh).contiguous()


def paged_decode_case(torch, timer, pa, args, kw, wd, int8, profile):
    """paged_flash_attend vs its twin, timed as medians of PAGED_REPS cold-L2
    calls (`Timer.alternating`); on a raw pool with the slots kernel's
    variants (no per-layer window, softcap or scale), flash_attend_slots
    over a dense cache holding the same rows at the same positions timed
    in turn with it: the cost of the table (a reference only; it must
    agree with the paged kernel within atol). `profile`: the kernels'
    profiled device ms too. Returns a dict."""
    q, pk, pv, table, pos = args
    got = pa.paged_flash_attend(*args, wd, **kw)
    again = pa.paged_flash_attend(*args, wd, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "paged_flash_attend gave other bits on a repeat")
    check(bool(torch.isfinite(got.float()).all()), "paged_flash_attend: non-finite output")
    want = pa.paged_flash_attend_plain(*args, wd, **kw)
    err = (got.float() - want.float()).abs().max().item()
    fns = [lambda: pa.paged_flash_attend(*args, wd, **kw)]
    slots_err = None
    if not int8 and wd is None and set(kw) <= {"window"}:
        dk, dv = dense_rows(torch, pk, table), dense_rows(torch, pv, table)
        window = kw.get("window")
        slots = pa.flash_attend_slots(q, dk, dv, pos, window=window)
        slots_err = (slots.float() - got.float()).abs().max().item()
        fns.append(lambda: pa.flash_attend_slots(q, dk, dv, pos, window=window))
    times = timer.alternating(fns, PAGED_REPS)
    plain_ms = timer.ms(lambda: pa.paged_flash_attend_plain(*args, wd, **kw), 3)
    device_ms = (timer.device_ms(lambda: pa.paged_flash_attend(*args, wd, **kw), 10)
                 if profile else None)
    n_split = (pa._paged_splits(q.shape[0], KV, table.shape[1], pk.shape[2] if not int8
                                else pk.q.shape[2], pa._sm_count(q.device))
               if hasattr(pa, "_paged_splits") else None)
    return dict(max_abs_err=err, ms=times[0], slots_ms=times[1] if len(times) > 1 else None,
                slots_err=slots_err, plain_ms=plain_ms, device_ms=device_ms,
                n_split=n_split)


def ragged_case(torch, timer, pa, fa, args, kw, wd, int8, dense, profile):
    """ragged_paged_attend vs its twin, a repeat bit-equal, timed as medians
    of RAGGED_REPS cold-L2 calls (`Timer.alternating`); `dense` = (row,
    start, n, offset) for a launch of one table row's n queries: then
    flash_attend over that row's keys as a dense cache, the same walk
    without the table, timed in turn with it (a reference; it must agree
    with the ragged kernel within atol). `profile`: the kernel's profiled
    device ms too. Returns a dict, the kernel's output under "out"."""
    q, pk, pv, table, meta = args
    got = pa.ragged_paged_attend(*args, wd, **kw)
    again = pa.ragged_paged_attend(*args, wd, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "ragged_paged_attend gave other bits on a repeat")
    check(bool(torch.isfinite(got.float()).all()), "ragged_paged_attend: non-finite output")
    want = pa.ragged_paged_attend_plain(*args, wd, **kw)
    err = (got.float() - want.float()).abs().max().item()
    kernel = lambda: pa.ragged_paged_attend(*args, wd, **kw)  # noqa: E731
    fns = [kernel]
    dense_err = None
    if dense is not None:
        row, start, n, off = dense
        dk, dv = (dense_rows(torch, pool, table[row:row + 1]) for pool in (pk, pv))
        qd = q[off:off + n][None].contiguous()
        flash = lambda: fa.flash_attend(qd, dk, dv, start, None, wd, **kw)  # noqa: E731
        dense_err = (flash()[0].float() - got[off:off + n].float()).abs().max().item()
        fns.append(flash)
    times = timer.alternating(fns, RAGGED_REPS)
    plain_ms = timer.ms(lambda: pa.ragged_paged_attend_plain(*args, wd, **kw), 3)
    device_ms = timer.device_ms(kernel, 10) if profile else None
    # the launch plan (an older checkout, timed by `--only r`, has none)
    plan = None
    if hasattr(pa, "ragged_plan"):
        N, KV_, bs, _ = (pk.q if int8 else pk).shape
        G = meta.shape[0]
        plan = pa.ragged_plan(G, q.shape[0] // G, H, KV_, table.shape[1], bs, DH,
                              pa._sm_count(q.device), q.element_size(),
                              1 if int8 else None)._asdict()
    return dict(max_abs_err=err, ms=times[0], dense_ms=times[1] if len(times) > 1 else None,
                dense_err=dense_err, plain_ms=plain_ms, device_ms=device_ms, plan=plan,
                out=got)


def ragged_plans(P):
    """The mixed launches of (f), laid out by the fleet's own planner at
    its width: table row -> entries (row, start, length, kind)."""
    dec = [(b, p, 1, P.RAGGED_DECODE) for b, p in enumerate(SPECIAL_POS + [64, 333, 517])]
    return {
        "8 decode + 56-token chunk at 0": dec + [(8, 0, 56, P.RAGGED_PREFILL)],
        "128-token chunk at 640": [(0, 640, 128, P.RAGGED_PREFILL)],
        "5-token prefill row at 37": [(0, 37, 5, P.RAGGED_PREFILL)],
    }


def phase_f(torch, timer, pa, P, fa, int8=False, which="all"):
    """paged_flash_attend and ragged_paged_attend vs their twins, over raw
    pools or (int8=True) int8 pools; `which`: "decode" or "ragged" for one
    kernel's cases alone."""
    tag, suffix = ("(j)", "[int8]") if int8 else ("(f)", "")
    print(f"{tag} paged kernels{suffix} vs plain twins, H={H} KV={KV} Dh={DH}, "
          f"{BLOCK}-token blocks, {SLOT_MB} shuffled blocks per table row; device "
          f"ms per call, cold L2, repeats bit-equal; paged_flash_attend: medians "
          f"of {PAGED_REPS} calls in turn with flash_attend_slots over the same "
          f"rows as a dense cache (slots=, raw pools without window_dyn, softcap "
          f"or scale); ragged_paged_attend: medians of {RAGGED_REPS} calls, on a "
          f"launch of one table row in turn with flash_attend over that row as a "
          f"dense cache (dense=); plan (cluster, min_share)")
    rows = []

    def record(kernel, dtype_name, case, label, kw, wdyn, args, row_queries,
               width, index_bytes, dense=None):
        wd = None if wdyn is None else torch.tensor([wdyn], dtype=torch.int32,
                                                    device=DEVICE)
        profile = dtype_name == "bfloat16" and label == "" and case in (
            f"B={FLEET['n_slots']}", next(iter(ragged_plans(P))))
        if kernel == "paged_flash_attend":
            extra = paged_decode_case(torch, timer, pa, args, kw, wd, int8, profile)
        else:
            extra = ragged_case(torch, timer, pa, fa, args, kw, wd, int8, dense, profile)
        got = extra.pop("out", None)
        err, ms, plain_ms = extra.pop("max_abs_err"), extra.pop("ms"), extra.pop("plain_ms")
        nbytes, flops = paged_work(row_queries, width, dtype_name,
                                   kw.get("window") or wdyn, index_bytes, int8)
        bound_ms, bound_by = bound(nbytes, flops, dtype_name)
        r = dict(kernel=kernel + suffix, dtype=dtype_name, case=case, variant=label,
                 max_abs_err=err, atol=ATOL[dtype_name], ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes, flops=flops,
                 **extra)
        rows.append(r)
        if kernel == "paged_flash_attend":
            more = (f"n_split={extra['n_split']} slots={fmt_ms(extra['slots_ms'])} "
                    + (f"(err vs slots {extra['slots_err']:.3g}) "
                       if extra["slots_err"] is not None else ""))
        else:
            plan = extra["plan"]
            more = ((f"cluster={plan['cluster']} min_share={plan['min_share']} "
                     if plan else "")
                    + (f"dense={fmt_ms(extra['dense_ms'])} (err vs dense "
                       f"{extra['dense_err']:.3g}) " if extra["dense_ms"] is not None else ""))
        more += (f"profiled={fmt_ms(extra['device_ms'])} "
                 if extra["device_ms"] is not None else "")
        print(f"    {kernel + suffix:25s} {dtype_name:8s} {case:31s} {label:14s} "
              f"err={err:.3g} (atol {r['atol']:g}) kernel={ms:.4f} {more}"
              f"plain={plain_ms:.4f} bound={bound_ms:.5f} ({bound_by}, "
              f"{bound_ms / ms:.4f} of it)")
        return got

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for B in (1, 8, 32) if which != "ragged" else ():
            g, pk, pv, table = paged_pool(torch, dt, B, seed=B, int8=int8)
            extra = torch.randint(0, SLOT_MB * BLOCK, (B,), generator=g,
                                  device=DEVICE).tolist()
            pos_list = [700] if B == 1 else (SPECIAL_POS + extra)[:B]
            pos = torch.tensor(pos_list, dtype=torch.int32, device=DEVICE)
            q = torch.randn(B, 1, H, DH, generator=g, device=DEVICE).to(dt)
            for label, kw, wdyn in PAGED_VARIANTS:
                record("paged_flash_attend", dtype_name, f"B={B}", label, kw, wdyn,
                       (q, pk, pv, table, pos), {b: [p] for b, p in enumerate(pos_list)},
                       B, 4 * B)
        if which == "decode":
            continue
        for i, (name, entries) in enumerate(ragged_plans(P).items()):
            g, pk, pv, table = paged_pool(torch, dt, 9, seed=100 + i, int8=int8)
            meta_np, tok_row, _, offsets, _ = P.build_ragged_meta(
                entries, width=RAGGED_W, tile=RAGGED_TILE)
            meta = torch.from_numpy(meta_np).to(DEVICE)
            dead = torch.from_numpy(tok_row < 0).to(DEVICE)
            q = torch.randn(RAGGED_W, H, DH, generator=g, device=DEVICE).to(dt)
            row_queries = {}
            for row, start, n, _ in entries:
                row_queries.setdefault(row, []).extend(range(start, start + n))
            # a launch of one table row: flash_attend over that row as a dense cache
            dense = ((entries[0][0], entries[0][1], entries[0][2], int(offsets[0]))
                     if len(entries) == 1 else None)
            for label, kw, wdyn in PAGED_VARIANTS:
                got = record("ragged_paged_attend", dtype_name, name, label, kw, wdyn,
                             (q, pk, pv, table, meta), row_queries, RAGGED_W,
                             16 * meta.shape[0], dense)
                # launch padding and the rows past a tile's q_len: zeros
                check(got[dead].float().abs().sum().item() == 0.0,
                      f"ragged_paged_attend{suffix} wrote non-zeros to padding ({name})")
    bad = [r for r in rows if not r["max_abs_err"] <= r["atol"]
           or not (r.get("slots_err") is None or r["slots_err"] <= r["atol"])
           or not (r.get("dense_err") is None or r["dense_err"] <= r["atol"])]
    check(not bad, f"paged kernels{suffix} disagree with their twins in {len(bad)} case(s)")
    return rows


def ragged_sweep(torch, timer, pa, P):
    """ragged_paged_attend on (f)'s launches and on 16 decode rows (bf16,
    raw pool), each cluster size with every rank walking its share
    (min_share 0) and with the ranks of a short tile walking fewer
    (RAGGED_MIN_SHARE), timed in turn (medians of RAGGED_REPS cold-L2
    calls): the measurement that `ragged_plan`'s choice rests on. The
    decode launch is timed in turn with paged_flash_attend over the same
    rows (the decode walk: keys as the mma's M)."""
    print(f"(f) ragged sweep, bf16: medians of {RAGGED_REPS} cold-L2 calls in turn, ms "
          f"per (cluster, min_share); * = ragged_plan's choice")
    decode_pos = SPECIAL_POS + [64, 333, 517, 127, 128, 255, 256, 511, 512, 900, 1000]
    launches = dict(ragged_plans(P))
    launches["16 decode rows"] = [(b, p, 1, P.RAGGED_DECODE) for b, p in enumerate(decode_pos)]
    for i, (name, entries) in enumerate(launches.items()):
        rows = max(e[0] for e in entries) + 1
        g, pk, pv, table = paged_pool(torch, torch.bfloat16, rows, seed=200 + i)
        meta_np = P.build_ragged_meta(entries, width=RAGGED_W, tile=RAGGED_TILE)[0]
        meta = torch.from_numpy(meta_np).to(DEVICE)
        q = torch.randn(RAGGED_W, H, DH, generator=g, device=DEVICE).to(torch.bfloat16)
        G = meta.shape[0]
        chosen = pa.ragged_plan(G, RAGGED_W // G, H, KV, SLOT_MB, BLOCK, DH,
                                pa._sm_count(q.device))
        plans = [chosen._replace(cluster=c, blocks=chosen.blocks // chosen.cluster * c,
                                 min_share=m)
                 for c in (1, 2, 4, 8) for m in (0, pa.RAGGED_MIN_SHARE)]
        fns = [lambda p=p: pa.ragged_paged_attend(q, pk, pv, table, meta, plan=p)
               for p in plans]
        if name == "16 decode rows":
            qd = q[:len(entries)].reshape(len(entries), 1, H, DH)
            pos = torch.tensor(decode_pos, dtype=torch.int32, device=DEVICE)
            fns.append(lambda: pa.paged_flash_attend(qd, pk, pv, table[:len(entries)], pos))
        times = timer.alternating(fns, RAGGED_REPS)
        print(f"    {name}: " + " ".join(
            f"({p.cluster},{p.min_share}){'*' if p == chosen else ''}={t:.4f}"
            for p, t in zip(plans, times))
            + (f" paged_flash_attend={times[-1]:.4f}" if len(times) > len(plans) else ""))


def fleet_prompt(i: int, n_tokens: int) -> str:
    """A prompt of exactly n_tokens byte-tokenizer tokens (BOS + one per
    ASCII character), different for each request."""
    text = " ".join(f"Request {i}, sentence {j}: the quick brown fox jumps over "
                    f"the lazy dog." for j in range(40))
    return text[: n_tokens - 1]


def wait_idle(port, timeout_s=60.0) -> dict:
    """/stats once the fleet holds no request and no queue."""
    t0 = time.time()
    while True:
        st = get(port, "/stats")[1]
        c = st["continuous"]
        if c["occupied"] == 0 and c["queued"] == 0:
            return st
        check(time.time() - t0 < timeout_s, f"the fleet did not go idle: {c}")
        time.sleep(0.05)


def reset_counts(pa, fa, Q):
    """Every kernel's launch counts to 0."""
    for wrapper in (pa.ragged_paged_attend, pa.paged_flash_attend, fa.flash_attend):
        wrapper.launches = wrapper.launches_int8 = 0
    Q.q4_matmul_rows.launches = 0
    pa.flash_attend_slots.launches = 0


def read_counts(pa, fa, Q):
    """Every kernel's launch count, by the name the kernels line gives it."""
    out = {}
    for name, wrapper in (("ragged_paged_attend", pa.ragged_paged_attend),
                          ("paged_flash_attend", pa.paged_flash_attend),
                          ("flash_attend", fa.flash_attend)):
        out[name] = wrapper.launches
        out[name + "[int8]"] = wrapper.launches_int8
    out["q4_matmul_rows"] = Q.q4_matmul_rows.launches
    out["flash_attend_slots"] = pa.flash_attend_slots.launches
    return out


def fleet_bodies(which):
    """The wave's request bodies: prompts of FLEET_PROMPT_TOKENS[i] tokens
    for i in `which`, greedy (even i) and sampled (odd i), 32 new tokens."""
    bodies = []
    for i in which:
        body = {"prompt": fleet_prompt(i, FLEET_PROMPT_TOKENS[i]),
                "max_tokens": FLEET_NEW_TOKENS, "chat": False}
        body.update({"greedy": True} if i % 2 == 0 else SAMPLED_KNOBS)
        bodies.append(body)
    return bodies


def serve_wave(server, bodies, pa, fa, Q):
    """POST the bodies at once; every kernel count starts at 0 just before
    (the main path's run) and is read once the fleet is idle again.
    Returns (results, wave seconds, launches, /stats before, /stats after)."""
    import threading

    before = get(server.port, "/stats")[1]["continuous"]
    results = [None] * len(bodies)

    def run(i):
        results[i] = post(server.port, bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    reset_counts(pa, fa, Q)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wave_s = time.perf_counter() - t0
    st = wait_idle(server.port)
    return results, wave_s, read_counts(pa, fa, Q), before, st["continuous"]


def check_wave(tag, results, which):
    """Every request of the wave answered in full, from the fleet."""
    for i, (code, r, wall) in zip(which, results):
        print(f"{tag} request {i} ({'greedy' if i % 2 == 0 else 'sampled'}): HTTP {code} "
              f"prompt_tokens={r.get('prompt_tokens')} tokens={r.get('tokens_generated')} "
              f"finish={r.get('finish_reason')} ttft_s={r.get('ttft_s')} "
              f"tokens_per_sec={r.get('tokens_per_sec')} "
              f"prefill_chunks={r.get('prefill_chunks')} wall_s={wall:.3f}")
        check(code == 200 and r.get("status") == "success"
              and r.get("backend") == "continuous", f"fleet request {i}: {r}")
        check(r["prompt_tokens"] == FLEET_PROMPT_TOKENS[i],
              f"request {i}: {r['prompt_tokens']} prompt tokens")
        check(r["tokens_generated"] == FLEET_NEW_TOKENS or r["finish_reason"] == "stop",
              f"request {i}: {r['tokens_generated']} tokens without a stop")


def check_graphs(tag, stats, kinds):
    """The fleet served through CUDA graphs: each launch kind (`kinds`:
    graph name -> its /stats launch counter) captured once, at its first
    launch, which ran eagerly, and every later launch a replay."""
    graphs = stats["graphs"]
    print(f"{tag} CUDA graphs: {json.dumps(graphs)}")
    check(set(graphs) == set(kinds), f"{tag}: graphs {sorted(graphs)}, not {sorted(kinds)}")
    for name, counter in kinds.items():
        g, n = graphs[name], stats["launches"][counter]
        check(g["captures"] == 1 and g["replays"] == n - 1 > 0,
              f"{tag}: {name} captured {g['captures']} times and replayed "
              f"{g['replays']} times for {n} launches")


def greedy_repeat(tag, server, body, in_wave):
    """A greedy request twice on the idle fleet: the same tokens."""
    again = [post(server.port, body)[1] for _ in range(2)]
    print(f"{tag} a greedy request of the wave again on the idle fleet, twice: tokens "
          f"{again[0]['tokens_generated']}, {again[1]['tokens_generated']}; "
          f"identical={again[0]['token_ids'] == again[1]['token_ids']}; "
          f"same as in the wave={again[0]['token_ids'] == in_wave['token_ids']}")
    check(again[0]["token_ids"] == again[1]["token_ids"],
          "a greedy request repeated on the idle fleet gave other tokens")


def phase_g(torch, engine, pa, fa, Q, tag="(g)"):
    """The fleet through the port's HTTP server: 8 concurrent requests. On
    a quantized engine (int4 weights, int8 pool; phase (k)) the int8
    paged kernels and q4_matmul_rows must carry the wave."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    cfg = engine.cfg
    L = cfg.n_layers
    quant = cfg.quant == "int4" and cfg.kv_quant == "int8"
    sfx = "[int8]" if quant else ""
    fleet = ContinuousEngine(engine, **FLEET)
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64,
                             continuous=fleet)
    server.start()
    try:
        t0 = time.time()
        w = fleet.warmup()
        check(w["ok"], f"fleet warmup: {w}")
        print(f"{tag} fleet {json.dumps(FLEET)}, quant={cfg.quant} "
              f"kv_quant={cfg.kv_quant}: step width "
              f"{fleet.stats()['scheduler']['step_width']}, tile {RAGGED_TILE}; "
              f"warmup request {time.time() - t0:.1f} s")
        which = range(len(FLEET_PROMPT_TOKENS))
        bodies = fleet_bodies(which)
        results, wave_s, launches, before, after = serve_wave(server, bodies, pa, fa, Q)
        mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
        both = (after["launches"]["mixed_with_decode_and_prefill"]
                - before["launches"]["mixed_with_decode_and_prefill"])
        chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
        check_wave(tag, results, which)
        print(f"{tag} wave: {wave_s:.3f} s; launches: {mixed} mixed ({both} with decode "
              f"rows and prompt chunks at once), {chunks} decode chunks of "
              f"{FLEET['chunk_steps']} steps; kernel launches {json.dumps(launches)}")
        ragged, paged = "ragged_paged_attend" + sfx, "paged_flash_attend" + sfx
        # every kernel not of this path: never launched
        expect_zero = [k for k in launches if k not in (ragged, paged, "q4_matmul_rows")]
        check(not any(launches[k] for k in expect_zero),
              f"the fleet launched kernels of another path: {launches}")
        check(both >= 1, "no mixed launch carried decode rows and prompt chunks at once")
        check(results[-1][1]["prefill_chunks"] >= 3,
              "the 700-token prompt did not span 3 mixed launches")
        check(launches[ragged] == L * mixed > 0,
              f"{ragged} launched {launches[ragged]} times "
              f"for {mixed} mixed launches of {L} layers")
        check(launches[paged] == L * FLEET["chunk_steps"] * chunks > 0,
              f"{paged} launched {launches[paged]} times for "
              f"{chunks} decode chunks of {FLEET['chunk_steps']} steps x {L} layers")
        # int4: every projection of a decode step (R = 8 rows) and the two
        # unembeds of a mixed launch; the mixed launch's 128-row
        # projections take the einsum, as in the JAX package
        q4_want = ((7 * L + 1) * FLEET["chunk_steps"] * chunks + 2 * mixed) if quant else 0
        check(launches["q4_matmul_rows"] == q4_want,
              f"q4_matmul_rows launched {launches['q4_matmul_rows']} times, "
              f"{q4_want} expected for {chunks} decode chunks and {mixed} mixed launches")
        free = after["paged"]["free_blocks"]
        print(f"{tag} /stats after the wave: continuous {json.dumps(after)}")
        check_graphs(tag, after, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
        check(free == FLEET["kv_pool_blocks"] - 1,
              f"{free} of {FLEET['kv_pool_blocks'] - 1} pool blocks free after the wave")
        greedy_repeat(tag, server, bodies[6], results[6][1])
        check(wait_idle(server.port)["continuous"]["paged"]["free_blocks"]
              == FLEET["kv_pool_blocks"] - 1, "pool blocks leaked by the repeats")
    finally:
        server.shutdown()
    return dict(results=results, wave_s=wave_s, launches=launches, mixed=mixed,
                chunks=chunks)


def scripted_fleet_logits(torch, cfg, params, P, M):
    """Logits at every live token of three scripted mixed launches (two
    prompts landing, then their decode rows beside a third prompt's
    chunks) and of one decode step of the three rows, over a fresh pool
    with shuffled tables."""
    g = torch.Generator(device=DEVICE).manual_seed(3)
    R = 3
    pool = P.init_pool(cfg, R * SLOT_MB + 1, BLOCK, device=DEVICE)
    table = (torch.randperm(R * SLOT_MB, generator=g, device=DEVICE) + 1).reshape(
        R, SLOT_MB).to(torch.int32).contiguous()
    ids = torch.randint(3, cfg.vocab_size, (R, SLOT_MB * BLOCK), generator=g,
                        device=DEVICE)
    pf, dec = P.RAGGED_PREFILL, P.RAGGED_DECODE
    launches = [[(0, 0, 100, pf), (1, 0, 20, pf)],
                [(0, 100, 1, dec), (1, 20, 1, dec), (2, 0, 64, pf)],
                [(0, 101, 1, dec), (1, 21, 1, dec), (2, 64, 50, pf)]]
    out = []
    with torch.no_grad():
        for entries in launches:
            meta, tok_row, tok_pos, _, _ = P.build_ragged_meta(
                entries, width=RAGGED_W, tile=RAGGED_TILE)
            row = torch.from_numpy(tok_row).to(DEVICE)
            pos = torch.from_numpy(tok_pos).to(DEVICE)
            toks = ids[row.clamp(min=0).long(), pos.long()]
            x = M.embed(cfg, params, toks[:, None], pos)
            x, pool = M.forward_layers(
                cfg, params["layers"], x, pool, pos, attn_seq_len=1,
                attn_hook=P.make_ragged_fill_hook(table, torch.from_numpy(meta).to(DEVICE),
                                                  row))
            out.append(M.unembed(cfg, params, x)[:, 0][row >= 0])
        pos = torch.tensor([102, 22, 114], dtype=torch.int32, device=DEVICE)
        toks = ids[torch.arange(R, device=DEVICE), pos.long()]
        x = M.embed(cfg, params, toks[:, None], pos)
        x, pool = M.forward_layers(cfg, params["layers"], x, pool, pos,
                                   attn_hook=P.make_paged_hook(table),
                                   attn_seq_len=SLOT_MB * BLOCK)
        out.append(M.unembed(cfg, params, x)[:, 0])
    return torch.cat(out)


def fleet_operands(torch, cfg, P, G):
    """Device-resident operands of one mixed launch of the fleet at its
    serving shape: 7 armed slots (greedy and sampled) with a decode row
    each, whose positions the launch derives on the device, and the
    8th slot's 56-token prompt landing whole and arming."""
    import numpy as np

    B, V = FLEET["n_slots"], cfg.vocab_size
    g = torch.Generator(device=DEVICE).manual_seed(5)
    pool = P.init_pool(cfg, B * SLOT_MB + 1, BLOCK, device=DEVICE)
    table = (torch.randperm(B * SLOT_MB, generator=g, device=DEVICE) + 1).reshape(
        B, SLOT_MB).to(torch.int32).contiguous()
    state, sparams = G.init_slots(B, V, device=DEVICE)
    none = torch.zeros(V, dtype=torch.bool, device=DEVICE)
    for b in range(B - 1):
        knobs = ((1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0) if b % 2 == 0
                 else (0.8, 40, 0.95, False, 0.0, 1.0, 0.0, 0.0))
        state, sparams = P.arm_slot_only(cfg, state, sparams, b, 100 + b,
                                         100 + 50 * b, FLEET_NEW_TOKENS, *knobs, none)
    entries = [(b, 0, 1, P.RAGGED_DECODE) for b in range(B - 1)]
    entries.append((B - 1, 0, 56, P.RAGGED_PREFILL))
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(
        entries, width=RAGGED_W, tile=RAGGED_TILE)
    dev = P.build_device_meta(entries, offsets, B - 1, width=RAGGED_W, tile=RAGGED_TILE)
    dec_flag = np.zeros(RAGGED_W, bool)
    dec_idx = np.zeros(B, np.int32)
    for b, off in zip(range(B - 1), offsets):
        dec_flag[off] = True
        dec_idx[b] = off
    arm = P.idle_mixed_arm(B, V, device=DEVICE)
    on = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    on[B - 1] = True
    idx = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    idx[B - 1] = offsets[-1] + 55
    arm = arm._replace(on=on, idx=idx, prompt_len=torch.full_like(idx, 56),
                       max_tokens=torch.full_like(idx, FLEET_NEW_TOKENS))
    d = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    toks = torch.randint(3, V, (RAGGED_W,), generator=g, device=DEVICE).to(torch.int32)
    return dict(
        tokens=toks, tok_row=d(tok_row), tok_pos=d(tok_pos), dec_flag=d(dec_flag),
        meta=d(meta), pool=pool, table=table, state=state, sparams=sparams,
        generator=torch.Generator(device=DEVICE).manual_seed(6), dec_idx=d(dec_idx),
        arm=arm, dev=P.DeviceMeta(*(d(a) for a in dev)),
    ), B - 1 + 56


def phase_h(torch, engine, P, G, M, tag="(h)", atol=LOGITS_ATOL):
    """Kernel path vs plain path over the pool, and the sync check (on a
    quantized engine, phase (l): q4_matmul_rows runs on both paths)."""
    cfg_k = engine.cfg
    cfg_p = cfg_k.replace(attn_impl="plain")
    params = engine.backend.params
    out = {cfg.attn_impl: scripted_fleet_logits(torch, cfg, params, P, M)
           for cfg in (cfg_k, cfg_p)}
    k, p = out["kernel"], out["plain"]
    check(bool(torch.isfinite(k).all()) and k.shape == p.shape,
          "fleet kernel-path logits not finite or misshapen")
    err = (k - p).abs().max().item()
    top2 = p.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    pinned = gap > 2 * err
    differ = (k.argmax(-1) != p.argmax(-1)) & pinned
    print(f"{tag} fleet logits kernel vs plain ({k.shape[0]} tokens of 3 mixed launches "
          f"and a decode step): max_abs_err={err:.4g} (atol {atol}) "
          f"mean_abs_err={(k - p).abs().mean().item():.4g}; greedy tokens pinned by "
          f"the top-2 gap: {int(pinned.sum())}, of which differ: {int(differ.sum())}")
    check(err <= atol, "fleet kernel-path logits disagree with the plain path")
    check(not bool(differ.any()), "a pinned greedy token differs between the paths")

    ops, _ = fleet_operands(torch, cfg_k, P, G)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, state, sparams, pool = P.mixed_step_ragged(cfg_k, params, **ops)
        emitted, mask, state, pool = P.decode_slots_paged(
            cfg_k, params, state, pool, ops["table"], ops["generator"], sparams,
            num_steps=FLEET["chunk_steps"])
        chunk = G.pack_chunk(emitted, mask, state.active)
        hosts = []
        for t in (packed, chunk):
            hosts.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            hosts[-1].copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev.synchronize()
    packed, chunk = (h.numpy() for h in hosts)
    B = FLEET["n_slots"]
    print(f"{tag} one mixed launch and one {FLEET['chunk_steps']}-step decode chunk under "
          f"set_sync_debug_mode('error'): no host sync; armed={packed[4].tolist()} "
          f"emitted per slot={chunk[FLEET['chunk_steps']:2 * FLEET['chunk_steps']].sum(0).tolist()}")
    check(packed[4].tolist() == [0] * (B - 1) + [1], "the landing prompt did not arm")
    check(packed[1].tolist() == [1] * (B - 1) + [0], "the decode rows did not emit")
    return err


def top_kernels(kernels, n):
    """The n kernels with the most device time: (ms, count, name)."""
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(t / 1e3, c, name) for name, (t, c) in top]


def profile_call(torch, fn):
    """Wall us, device busy us and the device kernels of one call, from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return wall_us, busy_union_us(kern), kern


def phase_i_profile(torch, engine, P, G, tag="(i)"):
    """One profiled mixed launch and one decode chunk at the fleet's
    serving shape (warm: each runs once before)."""
    cfg, params = engine.cfg, engine.backend.params
    K = FLEET["chunk_steps"]
    for label in ("warm", "profiled"):
        ops, n_tok = fleet_operands(torch, cfg, P, G)
        res = {}

        def mixed():
            res["m"] = P.mixed_step_ragged(cfg, params, **ops)

        def chunk():
            _, st, sp, pool = res["m"]
            res["c"] = P.decode_slots_paged(cfg, params, st, pool, ops["table"],
                                            ops["generator"], sp, num_steps=K)

        if label == "warm":
            mixed()
            chunk()
            torch.cuda.synchronize()
            continue
        for name, fn in (("mixed launch", mixed), (f"decode chunk of {K} steps", chunk)):
            wall_us, busy_us, kern = profile_call(torch, fn)
            n_kern = len(kern)
            tokens = n_tok if name == "mixed launch" else int(res["c"][1].sum())
            if not n_kern:
                print(f"{tag} profiled {name}: device busy share not measured (the "
                      f"profiler recorded no device kernels)")
                continue
            print(f"{tag} profiled {name}: wall_ms={wall_us / 1e3:.3f} "
                  f"device busy_ms={busy_us / 1e3:.3f} idle_share={1 - busy_us / wall_us:.4f} "
                  f"kernels={n_kern} tokens={tokens} kernels_per_token={n_kern / tokens:.1f}")
            for ms, count, kname in top_kernels(kern, 6):
                print(f"    {ms:8.3f} ms {count:5d}x  {kname[:100]}")


# -- int4 weights and the int8 KV cache: phases (j) to (m) ------------------------

# tinyllama's projections (in, out) and how many of each one decode step
# runs: per layer wq and wo, wk and wv, w_gate and w_up, w_down; the LM head
Q4_SHAPES = {(2048, 2048): 2 * 22, (2048, 256): 2 * 22, (2048, 5632): 2 * 22,
             (5632, 2048): 22, (2048, 32000): 1}
# q4 outputs are sums of 2048-5632 products of size ~in**-0.5 (the model's
# init): |y| < 8, where one bf16 ulp is 0.03 and the kernel and its twin
# may round the same fp32 sum to neighbours
Q4_ATOL = {"float32": 1e-4, "bfloat16": 6e-2}
Q4_REPS = 30


def q4_cases(torch, timer, Q):
    """q4_matmul_rows vs its twin at tinyllama's projection shapes, with
    torch.matmul against the dequantized weight (in x's dtype: the same
    product over 4x (bf16) or 8x (fp32) the weight bytes of the packed
    int4) as the yardstick; the kernel and the yardstick timed in turn,
    medians of Q4_REPS cold-L2 calls each."""
    print(f"(j) q4_matmul_rows vs plain twin (group 64); device ms per call, cold L2; "
          f"kernel and matmul(dequantized): medians of {Q4_REPS} calls in turn")
    rows = []
    g = torch.Generator(device=DEVICE).manual_seed(11)
    for (d_in, d_out) in Q4_SHAPES:
        w = Q.quantize_tensor4(torch.randn(d_in, d_out, generator=g, device=DEVICE)
                               * d_in ** -0.5)
        G = w.q.shape[0]
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            dense = Q.dequantize_tensor4(w, dt)
            esize = 4 if dtype_name == "float32" else 2
            for R in (1, 8, 32):
                x = torch.randn(R, d_in, generator=g, device=DEVICE).to(dt)
                got = Q.q4_matmul_rows(x, w)
                torch.cuda.synchronize()
                want = Q.q4_matmul_rows_plain(x, w)
                err = (got.float() - want.float()).abs().max().item()
                check(bool(torch.isfinite(got.float()).all()), "q4_matmul_rows: non-finite")
                check(torch.equal(got, Q.q4_matmul_rows(x, w)),
                      "q4_matmul_rows gave other bits on a repeat")
                ms, library_ms = timer.alternating(
                    [lambda: Q.q4_matmul_rows(x, w), lambda: x @ dense], Q4_REPS)
                plain_ms = timer.ms(lambda: Q.q4_matmul_rows_plain(x, w), 3)
                # the kernels alone (profiler), for the decode rows in bf16
                dev_ms = lib_dev_ms = None
                if dtype_name == "bfloat16" and R == FLEET["n_slots"]:
                    dev_ms = timer.device_ms(lambda: Q.q4_matmul_rows(x, w), 10)
                    lib_dev_ms = timer.device_ms(lambda: x @ dense, 10)
                nbytes = d_in * d_out // 2 + G * d_out * 4 + R * (d_in + d_out) * esize
                flops = 2 * R * d_in * d_out
                bound_ms, bound_by = bound(nbytes, flops, dtype_name)
                # the grid plan (an older checkout of the package, timed by
                # `--only j` for a before/after comparison, has none)
                plan = (Q.q4_plan(R, G, w.q.shape[1], d_out, Q._sm_count(x.device), esize)
                        if hasattr(Q, "q4_plan") else None)
                r = dict(shape=(d_in, d_out), dtype=dtype_name, R=R, max_abs_err=err,
                         atol=Q4_ATOL[dtype_name], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                         nbytes=nbytes, flops=flops, plan=plan and plan._asdict(),
                         device_ms=dev_ms, library_device_ms=lib_dev_ms)
                rows.append(r)
                print(f"    {dtype_name:8s} {d_in:4d}->{d_out:5d} G={G:2d} R={R:2d} "
                      + (f"n_split={plan.n_split} gps={plan.gps} stages={plan.stages} "
                         if plan else "")
                      + f"err={err:.3g} (atol {r['atol']:g}) kernel={ms:.4f} "
                      f"matmul(dequantized)={library_ms:.4f} plain={plain_ms:.4f} "
                      f"bound={bound_ms:.5f} ({bound_by}, {bound_ms / ms:.3f} of it)"
                      + ("" if dtype_name != "bfloat16" or R != FLEET["n_slots"] else
                         f"; profiled device ms kernel={fmt_ms(dev_ms)} "
                         f"matmul={fmt_ms(lib_dev_ms)}"))
    bad = [r for r in rows if not r["max_abs_err"] <= r["atol"]]
    check(not bad, f"q4_matmul_rows disagrees with its twin in {len(bad)} case(s)")
    return rows


def q4_line(rows, launches):
    """q4_matmul_rows' JSON entry: the bf16 R=8 cases (the fleet's decode
    rows and its mixed launch's unembeds), per launch, weighted by the
    projections of one decode step."""
    sel = [(r, Q4_SHAPES[r["shape"]]) for r in rows
           if r["dtype"] == "bfloat16" and r["R"] == FLEET["n_slots"]]
    n = sum(c for _, c in sel)

    def mean(key):
        return sum(r[key] * c for r, c in sel) / n

    _, bound_by = bound(sum(r["nbytes"] * c for r, c in sel),
                        sum(r["flops"] * c for r, c in sel), "bfloat16")
    return {
        "name": "q4_matmul_rows",
        "route": "cuda",
        "source": "distributed_llm_inference_tpu_torch/csrc/q4_matmul.cu",
        "replaces": "distributed_llm_inference_tpu/ops/quant.py:184",
        "launches": launches["q4_matmul_rows"],
        "max_abs_err": max(r["max_abs_err"] for r, _ in sel),
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": bound_by,
        # torch.matmul against the bf16-dequantized weight: the same
        # product over 4x the weight bytes
        "library_ms": mean("library_ms"),
        "shapes": "bf16 R=8, group 64, per launch over one decode step's "
                  "projections: " + ", ".join(f"{a}->{b} x{c}"
                                              for (a, b), c in Q4_SHAPES.items()),
    }


def phase_k_solo(torch, engine, pa, fa, Q):
    """One solo request on the quantized engine through the HTTP server,
    its prompt longer than the largest prefill bucket: every T>1 chunk
    launches the int8 flash_attend once per layer."""
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    L = engine.cfg.n_layers
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64)
    server.start()
    try:
        chunks = chunk_shapes(engine, LONG)
        reset_counts(pa, fa, Q)  # the solo path's run starts here
        code, r, wall = post(server.port, LONG)
        launches = read_counts(pa, fa, Q)
        print(f"(k) solo long prompt, --quant int4 --kv-quant int8: HTTP {code} "
              f"tokens={r.get('tokens_generated')} ttft_s={r.get('ttft_s')} "
              f"tokens_per_sec={r.get('tokens_per_sec')} wall_s={wall:.3f} "
              f"chunks={chunks} kernel launches {json.dumps(launches)}")
        check(code == 200 and r.get("status") == "success", f"solo int8: {r}")
        check(len(chunks) > 1, "the long prompt did not chunk")
        check(launches["flash_attend[int8]"] == L * len(chunks),
              f"{launches['flash_attend[int8]']} int8 flash_attend launches for "
              f"{len(chunks)} T>1 chunks of {L} layers")
        check(launches["flash_attend"] == 0, "the int8 cache ran the raw flash kernel")
        check(launches["q4_matmul_rows"] > 0, "the solo decode never ran q4_matmul_rows")
    finally:
        server.shutdown()
    return chunks, launches


def paged_line(rows, kernel, launches, replaces, pick, shapes):
    """A paged kernel's JSON entry, from its bf16 cases of (f) at the
    main path's shapes (no window, softcap or scale on tinyllama)."""
    sel = [r for r in rows if r["kernel"] == kernel and r["dtype"] == "bfloat16"
           and r["variant"] == "" and pick(r)]
    n = len(sel)
    _, bound_by = bound(sum(r["nbytes"] for r in sel), sum(r["flops"] for r in sel),
                        "bfloat16")
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": "distributed_llm_inference_tpu_torch/csrc/paged_attention.cu",
        "replaces": replaces,
        "launches": None if launches is None else launches[kernel],
        "max_abs_err": max(r["max_abs_err"] for r in sel),
        "ms": sum(r["ms"] for r in sel) / n,
        "plain_ms": sum(r["plain_ms"] for r in sel) / n,
        "bound_ms": sum(r["bound_ms"] for r in sel) / n,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call reads a block table
        "shapes": shapes,
    }
    if kernel.startswith("paged_flash_attend"):
        # medians of PAGED_REPS in turn; the split count, the kernels'
        # profiled device ms, and flash_attend_slots over the same rows as a
        # dense cache (raw pool only), a reference for the table's cost
        r = sel[0]
        entry.update(n_split=r["n_split"], device_ms=r["device_ms"],
                     slots_ms=r["slots_ms"])
    else:
        # medians of RAGGED_REPS in turn; the plan, each launch's median, the
        # mixed launch's profiled device ms, and flash_attend over a one-row
        # launch's row as a dense cache, a reference for the table's cost
        entry.update(plan=sel[0]["plan"], ms_by_case={r["case"]: r["ms"] for r in sel},
                     device_ms=next((r["device_ms"] for r in sel
                                     if r["device_ms"] is not None), None),
                     dense_ms={r["case"]: r["dense_ms"] for r in sel
                               if r["dense_ms"] is not None})
    return entry


def ragged_line(rows, launches, int8, P):
    """ragged_paged_attend's JSON entry (or its int8 pool's), the mean of
    the bf16 launches of (f) or (j) at the fleet's width."""
    return paged_line(
        rows, "ragged_paged_attend" + ("[int8]" if int8 else ""), launches,
        "distributed_llm_inference_tpu/ops/paged_attention.py:482", lambda r: True,
        ("bf16 q, int8 pool + fp32 scales, " if int8 else "bf16 ")
        + f"H={H} KV={KV} Dh={DH}, {BLOCK}-token blocks, width {RAGGED_W} in tiles of "
        f"{RAGGED_TILE}; ms: mean of the medians of {RAGGED_REPS} of the launches: "
        + ", ".join(ragged_plans(P)))


def paged_decode_line(rows, launches, int8):
    """paged_flash_attend's JSON entry (or its int8 pool's), from the bf16
    B=8 case of (f) or (j) at the fleet's positions."""
    name = "paged_flash_attend[int8]" if int8 else "paged_flash_attend"
    return paged_line(
        rows, name, launches, "distributed_llm_inference_tpu/ops/paged_attention.py:71",
        lambda r: r["case"] == f"B={FLEET['n_slots']}",
        ("bf16 q, int8 pool + fp32 scales, " if int8 else "bf16 ")
        + f"B={FLEET['n_slots']} H={H} KV={KV} Dh={DH}, {BLOCK}-token blocks, "
        f"positions {SPECIAL_POS} and 3 drawn in [0, 1024); ms: median of "
        f"{PAGED_REPS} in turn" + ("" if int8 else " with slots_ms, flash_attend_slots "
                                    "over the same rows as a dense cache"))


# -- the dense slot fleet and whole-prefill admission: phases (n) to (p) --------

# flash_attend_slots' cases: (label, B, S, per-row positions). bench.py's
# fleet-attention leg (8 slots of an 8192-position cache at pos 1024), the
# dense fleet's 1024-position slots with tile edges, the last position and
# a finished slot frozen at S, an S that is no multiple of the tile; then
# the split-KV kernel's extremes: one row (66 splits on 132 SMs) whose
# live range ends on a tile edge, and 32 rows (3 splits) on both sides of
# every 64-key tile edge
SLOTS_CASES = [
    ("bench.py fleet leg", 8, 8192, [1024] * 8),
    ("dense fleet", 8, 1024, [0, 17, 63, 64, 500, 1000, 1023, 1024]),
    ("S=1000", 8, 1000, [0, 1, 63, 64, 640, 998, 999, 1000]),
    ("B=1 split edges", 1, 8192, [1087]),
    ("B=32 tile edges", 32, 1024, [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 255, 256,
                                   257, 319, 320, 383, 384, 447, 448, 511, 512, 575, 576,
                                   639, 640, 703, 704, 767, 768, 1022, 1023, 1024]),
]
SLOTS_REPS = 30  # cold-L2 calls of the kernel and of SDPA, in turn
DENSE_FLEET = dict(n_slots=8, chunk_steps=16, chunk_lag=2, slot_max_seq=1024)
WHOLE_PREFILL_WAVE = (0, 3, 5, 7)  # 8, 120, 330 and 700 prompt tokens


def slots_work(B, S_, positions, window, dtype_name):
    """(bytes, FLOPs) of one flash_attend_slots call: q read and o written
    once, pos read once, each row's live K/V rows read once (positions
    <= pos and < S, within the window), 4*Dh FLOPs per head and live key."""
    esize = 4 if dtype_name == "float32" else 2
    keys = 0
    for p in positions:
        lo = max(p - window + 1, 0) if window else 0
        keys += max(min(p + 1, S_) - lo, 0)
    nbytes = 2 * B * H * DH * esize + 4 * B + 2 * KV * DH * esize * keys
    return nbytes, 4 * DH * H * keys


def phase_n(torch, timer, pa):
    """flash_attend_slots driven directly, as bench.py's fleet leg drives
    the JAX kernel (no serving hook selects it), then held to its twin in
    every case: the kernel and SDPA (the slot mask, enable_gqa) timed in
    turn, medians of SLOTS_REPS cold-L2 calls; the twin and attend (the
    einsum over the whole cache with the slot mask: the JAX package's own
    yardstick) as means; and the bound. Then the graph check. Returns
    (rows, the driven run's launches)."""
    import torch.nn.functional as F

    from distributed_llm_inference_tpu_torch.ops.attention import attend, slot_causal_mask

    operands = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for i, (label, B, S_, positions) in enumerate(SLOTS_CASES):
            g = torch.Generator(device=DEVICE).manual_seed(200 + i)
            q = torch.randn(B, 1, H, DH, generator=g, device=DEVICE).to(dt)
            k = torch.randn(B, KV, S_, DH, generator=g, device=DEVICE).to(dt)
            v = torch.randn(B, KV, S_, DH, generator=g, device=DEVICE).to(dt)
            pos = torch.tensor(positions, dtype=torch.int32, device=DEVICE)
            operands[dtype_name, label] = (q, k, v, pos)
    # the driven run: one call per case, bf16, as served (no window)
    pa.flash_attend_slots.launches = 0
    for label, *_ in SLOTS_CASES:
        pa.flash_attend_slots(*operands["bfloat16", label])
    torch.cuda.synchronize()
    driven = pa.flash_attend_slots.launches
    check(driven == len(SLOTS_CASES), f"flash_attend_slots launched {driven} times")
    print(f"(n) flash_attend_slots driven directly at {len(SLOTS_CASES)} shapes: "
          f"{driven} launches; vs plain twin, H={H} KV={KV} Dh={DH}, device ms per "
          f"call, cold L2")
    rows = []
    for (dtype_name, label), (q, k, v, pos) in operands.items():
        B, S_ = q.shape[0], k.shape[2]
        n_split = pa._slots_splits(B, KV, S_, pa._sm_count(q.device))
        for window in (None, 256):
            got = pa.flash_attend_slots(q, k, v, pos, window=window)
            again = pa.flash_attend_slots(q, k, v, pos, block_k=128, window=window)
            torch.cuda.synchronize()
            want = pa.flash_attend_slots_plain(q, k, v, pos, window=window)
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got.float()).all()), "flash_attend_slots: non-finite")
            check(torch.equal(got, again),
                  "flash_attend_slots gave other bits on a repeat (another block_k)")
            mask = slot_causal_mask(pos, 1, S_, window)
            qt, smask = q.transpose(1, 2), mask[:, None]
            ms, library_ms = timer.alternating([
                lambda: pa.flash_attend_slots(q, k, v, pos, window=window),
                lambda: F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=smask, enable_gqa=True),
            ], SLOTS_REPS)
            plain_ms = timer.ms(
                lambda: pa.flash_attend_slots_plain(q, k, v, pos, window=window), 3)
            einsum_ms = timer.ms(lambda: attend(q, k, v, mask), 10)
            nbytes, flops = slots_work(B, S_, pos.tolist(), window, dtype_name)
            bound_ms, bound_by = bound(nbytes, flops, dtype_name)
            r = dict(dtype=dtype_name, case=label, window=window, n_split=n_split,
                     max_abs_err=err, atol=ATOL[dtype_name], ms=ms, plain_ms=plain_ms,
                     einsum_ms=einsum_ms, library_ms=library_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
            rows.append(r)
            print(f"    {dtype_name:8s} {label:18s} B={B:2d} S={S_:4d} n_split={n_split:2d} "
                  f"window={str(window):4s} err={err:.3g} (atol {r['atol']:g}) "
                  f"kernel={ms:.4f} sdpa={library_ms:.4f} (medians of {SLOTS_REPS}, in "
                  f"turn) plain={plain_ms:.4f} einsum={einsum_ms:.4f} "
                  f"bound={bound_ms:.5f} ({bound_by}, {bound_ms / ms:.3f} of it)")
    bad = [r for r in rows if not r["max_abs_err"] <= r["atol"]]
    check(not bad, f"flash_attend_slots disagrees with its twin in {len(bad)} case(s)")
    slots_graph_check(torch, pa, *operands["bfloat16", SLOTS_CASES[0][0]])
    return rows, driven


def slots_graph_check(torch, pa, q, k, v, pos):
    """bench.py's fleet-leg call captured in a CUDA graph (the workspace
    from the graph's pool, the split count fixed on the host): after pos
    changes in place, each replay is bit-equal to an eager call made under
    set_sync_debug_mode("error"), with and without a window."""
    pos = pos.clone()
    S_ = k.shape[2]
    for window in (None, 256):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pa.flash_attend_slots(q, k, v, pos, window=window)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pa.flash_attend_slots(q, k, v, pos, window=window)
        for positions in ([0, 63, 64, 1087, 4095, S_ - 1, S_, 2 * S_], [1024] * 8):
            pos.copy_(torch.tensor(positions, dtype=torch.int32))
            graph.replay()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = pa.flash_attend_slots(q, k, v, pos, window=window)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            check(torch.equal(out, eager),
                  f"flash_attend_slots: graph replay differs from eager at {positions}, "
                  f"window {window}")
    print("(n) flash_attend_slots captured in a CUDA graph: replays after pos changes "
          "in place bit-equal to eager calls under the sync check (window None, 256)")


def slots_line(rows, driven, served):
    """flash_attend_slots' JSON entry: bench.py's fleet-leg case, bf16."""
    r = next(r for r in rows if r["dtype"] == "bfloat16" and r["window"] is None
             and r["case"] == SLOTS_CASES[0][0])
    _, B, S_, positions = SLOTS_CASES[0]
    return {
        "name": "flash_attend_slots",
        "route": "cuda",
        "source": "distributed_llm_inference_tpu_torch/csrc/slots_attention.cu",
        "replaces": "distributed_llm_inference_tpu/ops/paged_attention.py:261",
        "launches": driven,
        "n_split": r["n_split"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],  # median of SLOTS_REPS, in turn with SDPA's
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],  # SDPA with the slot mask, enable_gqa (median)
        "einsum_ms": r["einsum_ms"],  # attend over the whole cache (the JAX yardstick)
        "served_launches": served,
        "shapes": f"bf16 B={B} H={H} KV={KV} Dh={DH} S={S_}, pos {positions[0]} "
                  f"(bench.py's fleet leg); launches: driven directly in (n), one "
                  f"call per case; served_launches: (o) and (p), the reference's "
                  f"decode gate keeps the einsum",
    }


def dense_admission(torch, cfg, params, G, M, first=None):
    """A 300-token prompt admitted into slot 3 of an 8-slot dense fleet
    cache as the fleet does it (two 128-token extend chunks and a
    64-token bucket on a batch-1 scratch, spliced in), then one decode
    step of the fleet. Returns (prefill logits, decode logits of slot 3,
    the first token)."""
    B, S_ = DENSE_FLEET["n_slots"], DENSE_FLEET["slot_max_seq"]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    ids = torch.randint(3, cfg.vocab_size, (1, 300), generator=g, device=DEVICE)
    with torch.no_grad():
        scratch = M.init_kv_cache(cfg, 1, max_seq=S_, device=DEVICE)
        for c in range(2):
            scratch = G.extend(cfg, params, ids[:, 128 * c:128 * (c + 1)], 128 * c, scratch)
        tail = torch.full((1, 64), cfg.pad_token_id, dtype=ids.dtype, device=DEVICE)
        tail[:, :44] = ids[:, 256:]
        sampling = G.default_sampling(greedy=True)
        f, logits, scratch = G.prefill(cfg, params, tail, 44, scratch, g, sampling, pos=256)
        first = f if first is None else first
        cache = M.init_kv_cache(cfg, B, max_seq=S_, device=DEVICE)
        state, sparams = G.init_slots(B, cfg.vocab_size, device=DEVICE)
        none = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=DEVICE)
        cache, state, sparams = G.insert_slot(cfg, cache, scratch, state, sparams, 3,
                                              first, 300, 32, 1.0, 0, 1.0, True, 0.0,
                                              1.0, 0.0, 0.0, none)
        dec, _ = G._forward_step(cfg, params, state.token[:, None], cache, state.pos)
    return torch.cat([logits, dec[3:4]]), first, (cache, state, sparams)


def phase_o(torch, engine, pa, fa, Q, G, M):
    """The dense fleet through the port's HTTP server: (g)'s wave of 8, no
    pool. flash_attend carries every T>1 prefill chunk; decode keeps the
    einsum (the JAX package's gate), so no paged kernel and no
    flash_attend_slots runs. Then the kernel path vs the plain path on a
    dense admission, a decode chunk under the sync check, and a profiled
    decode chunk."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    cfg = engine.cfg
    L = cfg.n_layers
    fleet = ContinuousEngine(engine, **DENSE_FLEET)
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64,
                             continuous=fleet)
    server.start()
    try:
        t0 = time.time()
        w = fleet.warmup()
        check(w["ok"], f"dense fleet warmup: {w}")
        print(f"(o) dense fleet {json.dumps(DENSE_FLEET)} (no pool), prefill buckets "
              f"{PREFILL_BUCKETS}; warmup request {time.time() - t0:.1f} s")
        which = range(len(FLEET_PROMPT_TOKENS))
        bodies = fleet_bodies(which)
        results, wave_s, launches, before, after = serve_wave(server, bodies, pa, fa, Q)
        check_wave("(o)", results, which)
        chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
        prefill = sum(r["prefill_chunks"] for _, r, _ in results)
        print(f"(o) wave: {wave_s:.3f} s; {prefill} T>1 prefill chunks, {chunks} decode "
              f"chunks of {DENSE_FLEET['chunk_steps']} steps; kernel launches "
              f"{json.dumps(launches)}")
        print(f"(o) /stats after the wave: continuous {json.dumps(after)}")
        check_graphs("(o)", after, {"decode_chunk": "decode_chunks"})
        check("paged" not in after and after["launches"]["mixed"] == 0,
              "the dense fleet reported a pool or a mixed launch")
        check(launches["flash_attend"] == L * prefill > 0,
              f"flash_attend launched {launches['flash_attend']} times for {prefill} "
              f"T>1 prefill chunks of {L} layers")
        check(not any(n for k, n in launches.items() if k != "flash_attend"),
              f"the dense fleet launched another kernel: {launches}")
        greedy_repeat("(o)", server, bodies[6], results[6][1])
    finally:
        server.shutdown()
    n_tok = sum(r["tokens_generated"] for _, r, _ in results)
    for i, (_, r, wall) in enumerate(results):
        print(f"(o) dense fleet request {i}: prompt_tokens={r['prompt_tokens']} "
              f"ttft_s={r['ttft_s']} tokens_per_sec={r['tokens_per_sec']}")
    print(f"(o) dense fleet wave: {n_tok} tokens in {wave_s:.3f} s = "
          f"{n_tok / wave_s:.2f} tokens/s aggregate")

    params = engine.backend.params
    k_out, first, _ = dense_admission(torch, cfg, params, G, M)
    p_out, _, fleet_state = dense_admission(torch, cfg.replace(attn_impl="plain"), params,
                                            G, M, first=first)
    err = (k_out - p_out).abs().max().item()
    print(f"(o) dense admission logits kernel vs plain (prefill, then slot 3's decode "
          f"step): max_abs_err={err:.4g} (atol {LOGITS_ATOL})")
    check(bool(torch.isfinite(k_out).all()), "dense admission logits not finite")
    check(err <= LOGITS_ATOL, "dense admission: kernel-path logits disagree with plain")

    cache, state, sparams = fleet_state
    K = DENSE_FLEET["chunk_steps"]
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    G.decode_slots(cfg, params, state, cache, gen, sparams, num_steps=1)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        em, mask, st2, cache = G.decode_slots(cfg, params, state, cache, gen, sparams,
                                              num_steps=K)
        packed = G.pack_chunk(em, mask, st2.active)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev.synchronize()
    print(f"(o) one {K}-step dense decode chunk under set_sync_debug_mode('error'): no "
          f"host sync; slot 3 emitted {int(host.numpy()[K:2 * K, 3].sum())}")
    # every slot armed (the others at positions 100 + 50 b over their
    # cache rows' contents) for a decode chunk at the fleet's serving shape
    none = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=DEVICE)
    for b in range(DENSE_FLEET["n_slots"]):
        if b != 3:
            state, sparams = G.arm_slot(cfg, state, sparams, b, 100 + b, 100 + 50 * b,
                                        2 * K, 1.0, 0, 1.0, True, 0.0, 1.0, 0.0, 0.0,
                                        none)
    res = {}
    wall_us, busy_us, kern = profile_call(torch, lambda: res.setdefault(
        "c", G.decode_slots(cfg, params, state, cache, gen, sparams, num_steps=K)))
    if kern:
        tokens = int(res["c"][1].sum())
        print(f"(o) profiled dense decode chunk ({DENSE_FLEET['n_slots']} rows x {K} "
              f"steps): wall_ms={wall_us / 1e3:.3f} device busy_ms={busy_us / 1e3:.3f} "
              f"idle_share={1 - busy_us / wall_us:.4f} kernels={len(kern)} "
              f"tokens={tokens} kernels_per_token={len(kern) / max(tokens, 1):.1f}")
        for ms, count, kname in top_kernels(kern, 6):
            print(f"    {ms:8.3f} ms {count:5d}x  {kname[:100]}")
    else:
        print("(o) profiled dense decode chunk: device busy share not measured")
    return launches


def phase_p(torch, engine, pa, fa, Q):
    """The paged fleet of (g) with whole-prefill admission, on a 4-request
    wave: chunked_prefill=False (the prompt lands in ragged launches,
    22 ragged_paged_attend launches each) and ragged_prefill=False (a
    bucketed scratch prefill, 22 flash_attend launches per T>1 chunk,
    scattered into the blocks). Decode runs paged_flash_attend; every
    block comes back. Returns the launches of both waves, summed."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    L = engine.cfg.n_layers
    total = {}
    for mode, flags, prefill_kernel in (
            ("ragged whole-prefill", dict(chunked_prefill=False), "ragged_paged_attend"),
            ("bucketed whole-prefill", dict(ragged_prefill=False), "flash_attend")):
        # the same model, weights and kernels; only the admission differs
        eng = create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                            engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **flags))
        fleet = ContinuousEngine(eng, **FLEET)
        server = InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=64,
                                 continuous=fleet)
        server.start()
        try:
            check(fleet.warmup()["ok"], f"{mode} warmup")
            bodies = fleet_bodies(WHOLE_PREFILL_WAVE)
            results, wave_s, launches, before, after = serve_wave(server, bodies, pa, fa, Q)
            check_wave("(p)", results, WHOLE_PREFILL_WAVE)
            chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
            prefill = sum(r["prefill_chunks"] for _, r, _ in results)
            print(f"(p) {mode} ({json.dumps(flags)}): wave {wave_s:.3f} s, {prefill} "
                  f"prefill launches, {chunks} decode chunks; kernel launches "
                  f"{json.dumps(launches)}; free blocks {after['paged']['free_blocks']}")
            check(after["launches"]["mixed"] == 0 and not after["scheduler"]["chunked_prefill"],
                  f"{mode}: the fleet ran a mixed launch")
            check(launches[prefill_kernel] == L * prefill > 0,
                  f"{mode}: {prefill_kernel} launched {launches[prefill_kernel]} times "
                  f"for {prefill} prefill launches of {L} layers")
            check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks > 0,
                  f"{mode}: paged_flash_attend launched {launches['paged_flash_attend']} "
                  f"times for {chunks} decode chunks")
            others = [k for k in launches
                      if k not in (prefill_kernel, "paged_flash_attend")]
            check(not any(launches[k] for k in others),
                  f"{mode}: another kernel ran: {launches}")
            check(after["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
                  f"{mode}: pool blocks leaked")
            check_graphs("(p)", after, {"decode_chunk": "decode_chunks"})
        finally:
            server.shutdown()
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


# -- the fleet's CUDA graphs: phase (q) ------------------------------------------


def clone_tree(torch, tree):
    """A deep copy of a nest of tensors (dicts, tuples, int8 cache leaves)."""
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, KVQuant):
        return KVQuant(tree.q.clone(), tree.s.clone())
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [clone_tree(torch, v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def leaves(torch, tree):
    """Every tensor of a nest, in a fixed order."""
    from distributed_llm_inference_tpu_torch.ops.kv_quant import KVQuant

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, KVQuant):
        yield from (tree.q, tree.s)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(torch, tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from leaves(torch, v)


def graph_kind(torch, graphs, tag, name, lg, run, bufs, gen, tokens_of, want_deltas):
    """One launch kind's graph `lg` over `bufs`: captured on its first
    call if it was not yet; two replays, each bit-equal to the eager body
    on a clone of the buffers with the same generator state (the pool
    outside its trash block, where colliding padding writes land in any
    order), each moving the kernel counters by the capture's deltas; then
    replay vs eager: host wall (5 / 2 runs), one profiled run of each, the
    replay's CUDA-event span. Every run starts from the same state."""
    start = clone_tree(torch, {k: bufs[k] for k in ("state", "sparams", "inputs")
                               if k in bufs})

    def restore():
        for k, v in start.items():
            graphs.commit(bufs[k], v)

    restore()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        captured_now = lg.graph is None
        lg()
        for _ in range(2):
            restore()
            ref = clone_tree(torch, bufs)
            g2 = torch.Generator(device=DEVICE)
            g2.set_state(gen.get_state())
            before = graphs.launch_counts()
            got = lg().clone()
            moved = {k: v - before[k] for k, v in graphs.launch_counts().items()}
            torch.cuda.set_sync_debug_mode("default")
            want = run(ref, g2)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{tag} {name}: a replay's packed result differs "
                                          f"from the eager launch")
            for key in ("state", "sparams"):
                check(all(torch.equal(a, b) for a, b in zip(leaves(torch, bufs[key]),
                                                            leaves(torch, ref[key]))),
                      f"{tag} {name}: a replay's {key} differs from the eager launch")
            trash = 0 if bufs["table"] is None else 1
            check(all(torch.equal(a[:, trash:], b[:, trash:]) for a, b in
                      zip(leaves(torch, bufs["cache"]), leaves(torch, ref["cache"]))),
                  f"{tag} {name}: a replay's KV differs from the eager launch")
            check(moved == lg.deltas, f"{tag} {name}: counters moved {moved} on a replay, "
                                      f"the capture's deltas are {lg.deltas}")
            torch.cuda.set_sync_debug_mode("error")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    nonzero = {k: v for k, v in lg.deltas.items() if v}
    check(nonzero == want_deltas, f"{tag} {name}: launches per replay {nonzero}, "
                                  f"{want_deltas} expected")

    def walls(fn, n):
        out = []
        for _ in range(n):
            restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sum(out) / n

    replay_ms = walls(lg, 5)
    eager_ms = walls(lambda: run(bufs, gen), 2)
    restore()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    packed = lg()
    e1.record()
    e1.synchronize()
    span_ms = e0.elapsed_time(e1)
    tokens = tokens_of(packed)
    row = dict(engine=tag, kind=name, replay_wall_ms=replay_ms, eager_wall_ms=eager_ms,
               replay_span_ms=span_ms, tokens=tokens, launches_per_replay=nonzero)
    for label, fn in (("replay", lg), ("eager", lambda: run(bufs, gen))):
        restore()
        torch.cuda.synchronize()
        wall_us, busy_us, kern = profile_call(torch, fn)
        if kern:
            row[label] = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                              idle_share=1 - busy_us / wall_us, kernels=len(kern),
                              kernels_per_token=len(kern) / max(tokens, 1),
                              q4_ms={name[:80]: ms for ms, _, name
                                     in top_kernels(kern, len(kern)) if "q4" in name},
                              attn_ms={name[:80]: ms for ms, _, name
                                       in top_kernels(kern, len(kern))
                                       if "walk_" in name or "PagedTable" in name},
                              # the ragged kernel: the flash walk's PagedTable instance
                              ragged_ms=sum(ms for ms, _, name in top_kernels(kern, len(kern))
                                            if "PagedTable" in name))
        else:
            row[label] = "not measured (the profiler recorded no device kernels)"
    print(f"{tag} {name}: 2 replays bit-equal to eager (packed, state, KV), launches per "
          f"replay {json.dumps(nonzero)}; host wall per launch replay={replay_ms:.3f} ms "
          f"eager={eager_ms:.3f} ms ({eager_ms / replay_ms:.1f}x), replay CUDA-event span "
          f"{span_ms:.3f} ms, {tokens} tokens{'; captured here' if captured_now else ''}")
    for label in ("replay", "eager"):
        r = row[label]
        if isinstance(r, dict):
            print(f"    profiled {label:6s}: wall_ms={r['wall_ms']:.3f} busy_ms={r['busy_ms']:.3f} "
                  f"idle_share={r['idle_share']:.4f} kernels={r['kernels']} "
                  f"kernels_per_token={r['kernels_per_token']:.1f}")
            if r["q4_ms"]:
                print(f"    profiled {label:6s}: q4 kernels' device ms "
                      f"{sum(r['q4_ms'].values()):.3f}, by name {json.dumps(r['q4_ms'])}")
            if r["attn_ms"]:  # the paged kernels: the decode walk's split and combine
                print(f"    profiled {label:6s}: paged attention kernels' device ms "
                      f"{sum(r['attn_ms'].values()):.3f}, by name {json.dumps(r['attn_ms'])}")
            if r["ragged_ms"]:
                print(f"    profiled {label:6s}: ragged_paged_attend device ms per "
                      f"mixed launch {r['ragged_ms']:.3f}")
        else:
            print(f"    profiled {label:6s}: {r}")
    return row


def phase_q(torch, engine, P, G, M):
    """The fleet's launch kinds as CUDA graphs at its serving shape, on
    (h)'s operands: the mixed launch arming a 56-token prompt beside 7
    decode rows (greedy and sampled), the same graph with the idle arm,
    the paged decode chunk of the 8 rows, and the dense decode chunk over
    an [8, 1024] cache of random K/V."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    cfg, be = engine.cfg, engine.backend
    L, K, B = cfg.n_layers, FLEET["chunk_steps"], FLEET["n_slots"]
    quant = cfg.quant == "int4"
    sfx = "[int8]" if cfg.kv_quant == "int8" else ""
    tag = "(q)" + (" int4+int8" if quant else "")
    ops, n_mixed_tok = fleet_operands(torch, cfg, P, G)
    gen = ops["generator"]
    inputs = graphs.MixedInputs(ops["tokens"], ops["tok_row"], ops["tok_pos"],
                                ops["dec_flag"], ops["meta"], ops["dec_idx"], ops["arm"],
                                ops["dev"])
    bufs = dict(cache=ops["pool"], table=ops["table"], state=ops["state"],
                sparams=ops["sparams"], inputs=inputs)

    def mixed(b, g):
        return graphs.mixed_launch(be, b["inputs"], b["cache"], b["table"], b["state"],
                                   b["sparams"], g)

    def chunk(b, g):
        return graphs.decode_chunk(be, b["state"], b["sparams"], b["cache"], b["table"], g, K)

    rows = []
    q4_mixed = {"q4_matmul_rows": 2} if quant else {}
    pre = clone_tree(torch, (bufs["state"], bufs["sparams"]))
    arming = clone_tree(torch, inputs.arm)
    lg_m = graphs.LaunchGraph(lambda: mixed(bufs, gen), "mixed launch", DEVICE, gen)
    rows.append(graph_kind(torch, graphs, tag, "mixed launch, arming", lg_m, mixed, bufs, gen,
                           lambda p: n_mixed_tok,
                           {"ragged_paged_attend" + sfx: L, **q4_mixed}))
    check(lg_m.captures == 1, f"{tag}: the mixed launch was not captured")
    # the same graph with no admission completing: the 7 decode rows beside
    # a prompt chunk that is still landing
    graphs.commit((bufs["state"], bufs["sparams"]), pre)
    graphs.commit(inputs.arm, P.idle_mixed_arm(B, cfg.vocab_size, device=DEVICE))
    rows.append(graph_kind(torch, graphs, tag, "mixed launch, idle arm", lg_m, mixed, bufs,
                           gen, lambda p: n_mixed_tok,
                           {"ragged_paged_attend" + sfx: L, **q4_mixed}))
    check(lg_m.captures == 1, f"{tag}: one graph must serve both arms")
    # the decode chunk of the 8 rows an arming launch leaves
    graphs.commit((bufs["state"], bufs["sparams"]), pre)
    graphs.commit(inputs.arm, arming)
    mixed(bufs, gen)
    armed = clone_tree(torch, (bufs["state"], bufs["sparams"]))
    q4_chunk = {"q4_matmul_rows": (7 * L + 1) * K} if quant else {}
    lg_c = graphs.LaunchGraph(lambda: chunk(bufs, gen), "decode chunk", DEVICE, gen)
    rows.append(graph_kind(torch, graphs, tag, f"paged decode chunk of {K} steps", lg_c,
                           chunk, bufs, gen, lambda p: int(p[K:2 * K].sum()),
                           {"paged_flash_attend" + sfx: L * K, **q4_chunk}))
    # the dense fleet's chunk: the same slot state over an [8, 1024] cache
    g = torch.Generator(device=DEVICE).manual_seed(9)
    cache = M.init_kv_cache(cfg, B, max_seq=DENSE_FLEET["slot_max_seq"], device=DEVICE)
    for leaf in leaves(torch, cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=DEVICE))
        elif leaf.dim() == 4:  # int8 scales
            leaf.copy_(torch.rand(leaf.shape, generator=g, device=DEVICE) / 64)
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=DEVICE))
    dbufs = dict(cache=cache, table=None, state=armed[0], sparams=armed[1])
    lg_d = graphs.LaunchGraph(lambda: chunk(dbufs, gen), "dense decode chunk", DEVICE, gen)
    rows.append(graph_kind(torch, graphs, tag, f"dense decode chunk of {K} steps", lg_d,
                           chunk, dbufs, gen, lambda p: int(p[K:2 * K].sum()), q4_chunk))
    for lg in (lg_m, lg_c, lg_d):
        lg.close()
    return rows


# -- preemption, the supervisor and the health sweep: phases (s) to (u) -----------

# (s): a pool of 65 blocks of 16 tokens (64 usable: one full 1024-token
# slot, the least the fleet accepts) on a 2-slot fleet. A (600 prompt + 256
# new tokens) holds 54 blocks; B (300 + 64) needs 23 of the 10 left, so B is
# placed only by preempting A, under the default policy ("swap", which
# recomputes with no KV shadow)
PREEMPT_FLEET = dict(n_slots=2, chunk_steps=16, chunk_lag=2, slot_max_seq=1024,
                     kv_pool_blocks=65, kv_block_size=BLOCK)
PREEMPT_A = (600, 256)  # (prompt tokens, new tokens)
PREEMPT_B = (300, 64)
# (t): the 2-slot fleet the faults land in, and its request
SUPER_FLEET = dict(n_slots=2, chunk_steps=16, chunk_lag=2, slot_max_seq=1024,
                   kv_pool_blocks=128, kv_block_size=BLOCK)
SUPER_REQ = (200, 64)
# one transient fault at each point: the launch and fetch faults land
# mid-decode (tokens already fetched), the admission ones before any token
# (three mixed launches carry the 200-token prompt; at chunk_lag 2 the 6th
# launch and the 5th fetch come after the first token and a 16-token chunk
# were fetched)
SUPER_FAULTS = (("admission", 1), ("alloc", 1), ("prefill", 1), ("decode_launch", 6),
                ("fetch", 5))


class FleetSpy:
    """Records what the fleet's preemption and supervisor did, in process,
    without touching the served path: for each request (by prompt) the
    tokens fetched before its first preemption or crash, the time of that
    eviction and of its first token fetched after it, and each crash's time
    and the first launch after it."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.salvaged: dict = {}  # prompt -> tokens fetched before the first eviction
        self.evicted_at: dict = {}  # prompt -> time of the first eviction
        self.resumed_at: dict = {}  # prompt -> first token fetched after it
        self.crashes: list = []  # [time of the crash, time of the next launch]
        self._wrap("_preempt_for", self._after_preempt)
        self._wrap("_supervise", self._after_supervise, before=self._crash)
        self._wrap("_post_admit", None, before=self._admit)
        for name in ("_ragged_ingest", "_launch_chunk", "_launch_mixed"):
            self._wrap(name, None, before=self._launch)

    def _wrap(self, name, after, before=None):
        inner = getattr(self.fleet, name)

        def call(*a, **k):
            if before is not None:
                before(*a)
            out = inner(*a, **k)
            if after is not None:
                after(out)
            return out

        setattr(self.fleet, name, call)

    def _note(self, req):
        if req.prompt not in self.salvaged:
            self.salvaged[req.prompt] = len(req.salvaged)
            self.evicted_at[req.prompt] = time.perf_counter()

    def _after_preempt(self, preempted):
        if preempted:
            self._note(self.fleet._resume[-1])

    def _crash(self, exc):
        self.crashes.append([time.perf_counter(), None])

    def _after_supervise(self, restarted):
        if restarted:
            for req in self.fleet._recovery:
                self._note(req)

    def _admit(self, req):
        if req.prompt in self.evicted_at and req.prompt not in self.resumed_at:
            self.resumed_at[req.prompt] = time.perf_counter()

    def _launch(self, *a):
        if self.crashes and self.crashes[-1][1] is None:
            self.crashes[-1][1] = time.perf_counter()

    def reset(self):
        self.salvaged.clear()
        self.evicted_at.clear()
        self.resumed_at.clear()
        self.crashes.clear()


def parts_at(a: list, b: list):
    """The first index where two token lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def ragged_launches(engine) -> float:
    """Every ragged launch the fleets counted (mixed, extend and prefill)."""
    fam = engine.metrics.get("dli_ragged_launches_total")
    return sum(fam.labels(phase=p).value for p in ("mixed", "extend", "prefill"))


def fleet_server(engine, fleet_kw, **sup):
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    fleet = ContinuousEngine(engine, **fleet_kw, **sup)
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=512,
                             continuous=fleet)
    server.start()
    return fleet, server


def check_kernel_counts(tag, engine, launches, before, after, ragged_delta):
    """The ragged kernel ran n_layers times per ragged launch (mixed, and the
    recovery's whole-prefill extend / prefill launches), the paged decode
    kernel n_layers x chunk_steps times per decode chunk, nothing else."""
    L = engine.cfg.n_layers
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    steps = after["chunk_steps"]
    check(launches["ragged_paged_attend"] == L * ragged_delta > 0,
          f"{tag}: ragged_paged_attend launched {launches['ragged_paged_attend']} times "
          f"for {ragged_delta} ragged launches of {L} layers")
    check(launches["paged_flash_attend"] == L * steps * chunks > 0,
          f"{tag}: paged_flash_attend launched {launches['paged_flash_attend']} times for "
          f"{chunks} decode chunks of {steps} steps x {L} layers")
    others = [k for k in launches if k not in ("ragged_paged_attend", "paged_flash_attend")]
    check(not any(launches[k] for k in others), f"{tag}: another kernel ran: {launches}")
    return dict(ragged_launches=ragged_delta, decode_chunks=chunks)


def check_identity(tag, got: list, want: list, n_hard: int):
    """The tokens fetched before the eviction (n_hard) must equal the
    unpressured run's; print whether the rest is identical and where it
    parts if it is not."""
    check(got[:n_hard] == want[:n_hard],
          f"{tag}: the {n_hard} tokens fetched before the eviction differ from the "
          f"unpressured run at {parts_at(got[:n_hard], want[:n_hard])}")
    at = parts_at(got, want)
    print(f"{tag} bit-identity: the {n_hard} tokens fetched before the eviction equal "
          f"the unpressured run's; all {len(got)} tokens "
          + ("identical" if at is None else
             f"NOT identical: they part at token {at} ({at - n_hard} after the "
             f"eviction point)"))
    return at


def phase_s(torch, engine, pa, fa, Q, smi):
    """KV preemption through the HTTP server: B preempts A on a tight pool;
    both answer in full, A resumed, every block back, graphs captured once
    and replayed after the resume, the kernels' launch counts those of the
    launches the phase ran, and A's tokens fetched before its preemption
    those of its unpressured run on the same fleet."""
    import threading

    fleet, server = fleet_server(engine, PREEMPT_FLEET)
    spy = FleetSpy(fleet)
    try:
        check(fleet.warmup()["ok"], "(s) fleet warmup")
        check(fleet.stats()["preemption"]["policy"] == "swap",
              "(s) the default preempt_policy is not the JAX package's 'swap'")
        body_a = {"prompt": fleet_prompt(20, PREEMPT_A[0]), "max_tokens": PREEMPT_A[1],
                  "greedy": True, "chat": False}
        body_b = {"prompt": fleet_prompt(21, PREEMPT_B[0]), "max_tokens": PREEMPT_B[1],
                  "greedy": True, "chat": False}
        alone = {}
        for name, body in (("A", body_a), ("B", body_b)):
            code, r, wall = post(server.port, body)
            check(code == 200 and r["tokens_generated"] == body["max_tokens"],
                  f"(s) {name} alone: {code} {r}")
            alone[name] = r["token_ids"]
            print(f"(s) {name} alone on the fleet: prompt_tokens={r['prompt_tokens']} "
                  f"tokens={r['tokens_generated']} wall_s={wall:.3f}")
        before = wait_idle(server.port)["continuous"]
        check(before["preemption"]["preempted_total"] == 0, "(s) preempted while alone")
        spy.reset()
        rag0 = ragged_launches(engine)
        out = {}

        def run(name, body):
            out[name] = post(server.port, body)

        reset_counts(pa, fa, Q)
        t0 = time.perf_counter()
        ta = threading.Thread(target=run, args=("A", body_a))
        ta.start()
        # B arrives once A decodes (its first token fetched)
        while not any(r is not None and r.first_id is not None and r.tokens
                      for r in fleet._assignment):
            check(time.perf_counter() - t0 < 120, "(s) A never started decoding")
            time.sleep(0.001)
        tb = threading.Thread(target=run, args=("B", body_b))
        tb.start()
        ta.join()
        tb.join()
        wall = time.perf_counter() - t0
        after = wait_idle(server.port)["continuous"]
        launches = read_counts(pa, fa, Q)
        counts = check_kernel_counts("(s)", engine, launches, before, after,
                                     round(ragged_launches(engine) - rag0))
        (ca, ra, wa), (cb, rb, wb) = out["A"], out["B"]
        for name, code, r in (("A", ca, ra), ("B", cb, rb)):
            print(f"(s) {name}: HTTP {code} prompt_tokens={r.get('prompt_tokens')} "
                  f"tokens={r.get('tokens_generated')} preempted={r.get('preempted')} "
                  f"recovered={r.get('recovered')} ttft_s={r.get('ttft_s')} "
                  f"prefill_chunks={r.get('prefill_chunks')}")
            check(code == 200 and r.get("status") == "success", f"(s) {name}: {r}")
        check(ra.get("preempted", 0) >= 1 and ra.get("recovered") is True,
              f"(s) A was not preempted and resumed: {ra}")
        pre = after["preemption"]
        print(f"(s) /stats preemption {json.dumps(pre)}; supervisor "
              f"{json.dumps(after['supervisor'])}")
        check(pre["preempted_total"] >= 1 and pre["parked"] == 0,
              f"(s) /stats preemption {pre}")
        check(after["paged"]["free_blocks"] == PREEMPT_FLEET["kv_pool_blocks"] - 1,
              f"(s) {after['paged']['free_blocks']} pool blocks free after the pair")
        check_graphs("(s)", after, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
        for g in ("mixed_launch", "decode_chunk"):
            check(after["graphs"][g]["replays"] > before["graphs"][g]["replays"],
                  f"(s) {g} was not replayed after the resume")
        pa_ = spy.salvaged.get(body_a["prompt"])
        check(pa_ is not None and pa_ >= 1,
              f"(s) A had no token fetched before its preemption ({pa_})")
        at_a = check_identity("(s) A", ra["token_ids"], alone["A"], pa_)
        at_b = parts_at(rb["token_ids"], alone["B"])
        print(f"(s) B vs B alone: " + ("identical" if at_b is None
                                        else f"part at token {at_b}"))
        resume_ms = (spy.resumed_at[body_a["prompt"]] - spy.evicted_at[body_a["prompt"]]) * 1e3
        n_tok = ra["tokens_generated"] + rb["tokens_generated"]
        hist = engine.metrics.get("dli_preempted_resume_seconds").labels()
        print(f"(s) pair wall {wall:.3f} s, {n_tok} tokens = {n_tok / wall:.2f} tokens/s; "
              f"A's first preemption to its first resumed token {resume_ms:.1f} ms; "
              f"dli_preempted_resume_seconds count {hist.count} sum {hist.sum:.4f} s; "
              f"kernel launches {json.dumps(launches)} ({smi})")
        return dict(launches=launches, wall_s=wall, tokens_per_s=n_tok / wall,
                    resume_ms=resume_ms, preempted_a=ra["preempted"],
                    preempted_b=rb.get("preempted", 0), salvaged_a=pa_, parts_a=at_a,
                    parts_b=at_b, **counts)
    finally:
        server.shutdown()


def phase_t(torch, engine, pa, fa, Q, faults, smi):
    """The supervisor through the HTTP server: a one-shot transient fault at
    each point in turn (one restart each, the request answered, the pool
    clean, the graphs still captured once, its tokens fetched before the
    crash those of the unfaulted run), a poison request quarantined within
    two strikes while its fleet-mate answers, and, on a fleet of its own,
    a fault on every launch until the budget is spent (503 everywhere,
    /ready scheduler_dead, no block leaked)."""
    import threading

    fleet, server = fleet_server(engine, SUPER_FLEET)
    spy = FleetSpy(fleet)
    body = {"prompt": fleet_prompt(22, SUPER_REQ[0]), "max_tokens": SUPER_REQ[1],
            "greedy": True, "chat": False}
    rows = []
    try:
        check(fleet.warmup()["ok"], "(t) fleet warmup")
        code, ref, _ = post(server.port, body)
        check(code == 200, f"(t) the unfaulted run: {ref}")
        rag0 = ragged_launches(engine)
        before = wait_idle(server.port)["continuous"]
        reset_counts(pa, fa, Q)
        for point, on_call in SUPER_FAULTS:
            st0 = wait_idle(server.port)["continuous"]
            spy.reset()
            faults.arm([faults.FaultRule(point, "transient", on_call=on_call)])
            try:
                code, r, wall = post(server.port, body)
            finally:
                faults.disarm()
            st = wait_idle(server.port)["continuous"]
            restarts = st["supervisor"]["restarts"] - st0["supervisor"]["restarts"]
            n_pre = spy.salvaged.get(body["prompt"], 0)
            crash_to_launch = ((spy.crashes[0][1] - spy.crashes[0][0]) * 1e3
                               if spy.crashes and spy.crashes[0][1] else None)
            print(f"(t) {point} (transient, call {on_call}): HTTP {code} "
                  f"tokens={r.get('tokens_generated')} recovered={r.get('recovered')} "
                  f"restarts +{restarts}; {n_pre} tokens fetched before the crash; "
                  f"restart wall (crash to the next launch) "
                  f"{'n/a' if crash_to_launch is None else f'{crash_to_launch:.1f} ms'}; "
                  f"request wall {wall:.3f} s")
            check(code == 200 and r["tokens_generated"] == SUPER_REQ[1], f"(t) {point}: {r}")
            check(restarts == 1, f"(t) {point}: {restarts} restarts")
            check(st["paged"]["free_blocks"] == SUPER_FLEET["kv_pool_blocks"] - 1,
                  f"(t) {point}: pool blocks leaked")
            check(st["supervisor"]["ready"], f"(t) {point}: not ready after the restart")
            check(all(g["captures"] == 1 for g in st["graphs"].values()),
                  f"(t) {point}: graphs recaptured {st['graphs']}")
            at = check_identity(f"(t) {point}", r["token_ids"], ref["token_ids"], n_pre)
            rows.append(dict(point=point, on_call=on_call, tokens_before_crash=n_pre,
                             restart_ms=crash_to_launch, parts_at=at, wall_s=wall))
        after = wait_idle(server.port)["continuous"]
        launches = read_counts(pa, fa, Q)
        counts = check_kernel_counts("(t)", engine, launches, before, after,
                                     round(ragged_launches(engine) - rag0))
        check_graphs("(t)", after, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
        print(f"(t) the five restarts: kernel launches {json.dumps(launches)} ({smi})")

        # poison: a prompt that crashes its prefill every time, beside a good one
        poison = {"prompt": "POISONPILL " + fleet_prompt(23, 120), "max_tokens": 16,
                  "greedy": True, "chat": False}
        good = dict(body, prompt=fleet_prompt(24, SUPER_REQ[0]))
        st0 = wait_idle(server.port)["continuous"]
        faults.arm([faults.FaultRule("prefill", "fatal", match="POISONPILL", every=1,
                                     times=0)])
        out = {}
        try:
            threads = [threading.Thread(target=lambda n=n, b=b: out.update({n: post(
                server.port, b)})) for n, b in (("good", good), ("poison", poison))]
            for t in threads:
                t.start()
                time.sleep(0.05)
            for t in threads:
                t.join()
        finally:
            faults.disarm()
        st = wait_idle(server.port)["continuous"]
        (cg, rg, _), (cp, rp, _) = out["good"], out["poison"]
        strikes = st["supervisor"]["restarts"] - st0["supervisor"]["restarts"]
        print(f"(t) poison: HTTP {cp} error_type={rp.get('error_type')} after {strikes} "
              f"restarts; its fleet-mate HTTP {cg} tokens={rg.get('tokens_generated')} "
              f"recovered={rg.get('recovered')}; poisoned "
              f"{st['supervisor']['poisoned'] - st0['supervisor']['poisoned']}")
        check(cp == 500 and rp.get("error_type") == "poison", f"(t) poison: {cp} {rp}")
        check(cg == 200 and rg.get("status") == "success", f"(t) fleet-mate: {cg} {rg}")
        check(1 <= strikes <= 2, f"(t) poison took {strikes} restarts")
        check(st["paged"]["free_blocks"] == SUPER_FLEET["kv_pool_blocks"] - 1,
              "(t) poison: pool blocks leaked")
    finally:
        faults.disarm()
        server.shutdown()

    # the budget spent, last, on a fleet of its own (no quarantine: every
    # request rides every crash to the end of the budget)
    fleet, server = fleet_server(engine, SUPER_FLEET, poison_strikes=99)
    try:
        check(fleet.warmup()["ok"], "(t) budget fleet warmup")
        faults.arm([faults.FaultRule("decode_launch", "fatal", every=1, times=0)])
        out = {}
        try:
            threads = [threading.Thread(target=lambda i=i: out.update({i: post(
                server.port, dict(body, prompt=fleet_prompt(25 + i, SUPER_REQ[0])))}))
                for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            late = post(server.port, body)
        finally:
            faults.disarm()
        try:
            ready = get(server.port, "/ready")
        except urllib.error.HTTPError as e:
            ready = (e.code, json.loads(e.read()))
        st = get(server.port, "/stats")[1]["continuous"]
        codes = [(out[i][0], out[i][1].get("error_type")) for i in range(2)]
        print(f"(t) budget spent: requests {codes}, then {late[0]} "
              f"{late[1].get('error_type')}; /ready {ready[0]} {json.dumps(ready[1])}; "
              f"supervisor {json.dumps(st['supervisor'])}; free blocks "
              f"{st['paged']['free_blocks']}")
        check(all(c == (503, "unavailable") for c in codes), f"(t) budget: {codes}")
        check(late[0] == 503, f"(t) a request after the death: {late}")
        check(ready[0] == 503 and ready[1].get("reason") == "scheduler_dead",
              f"(t) /ready after the death: {ready}")
        check(st["supervisor"]["dead"] and st["supervisor"]["restarts"] == 3,
              f"(t) supervisor {st['supervisor']}")
        check(st["paged"]["free_blocks"] == SUPER_FLEET["kv_pool_blocks"] - 1,
              "(t) budget: pool blocks leaked")
    finally:
        faults.disarm()
        server.shutdown()
    return dict(launches=launches, rows=rows, **counts)


def phase_u(torch, engine, smi):
    """The health sweep, the status page, the profiler and the flight
    recorder through the HTTP server."""
    import os
    import threading

    fleet, server = fleet_server(engine, SUPER_FLEET)
    try:
        check(fleet.warmup()["ok"], "(u) fleet warmup")
        w = get(server.port, "/workers")[1]
        print(f"(u) /workers idle: {json.dumps(w)}")
        check(w.get("worker_1") == "online" and w["detail"][0].get("probe_ms") is not None,
              f"(u) /workers: {w}")
        long_body = {"prompt": fleet_prompt(27, 400), "max_tokens": 256, "greedy": True,
                     "chat": False}
        out = {}
        t = threading.Thread(target=lambda: out.update(r=post(server.port, long_body)))
        t.start()
        seen = []
        while t.is_alive() or not seen:
            d = get(server.port, "/workers")[1]
            seen.append((d["worker_1"], d["detail"][0].get("probe_ms")))
            time.sleep(0.05)
        t.join()
        print(f"(u) /workers during a 256-token request, {len(seen)} polls: {seen[:12]}")
        check(out["r"][0] == 200, f"(u) the long request: {out['r']}")
        check(all(s in ("online", "busy") for s, _ in seen), f"(u) /workers: {seen}")
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/", timeout=60) as r:
            page, ctype = r.read().decode(), r.headers.get("Content-Type")
        print(f"(u) GET /: {r.status} {ctype}, {len(page)} bytes")
        check(r.status == 200 and ctype.startswith("text/html") and "<table" in page,
              f"(u) GET /: {r.status} {ctype}")

        def profiler(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        started = profiler("/profiler/start", {"trace_dir": "chip-smoke-u"})
        code, r, wall = post(server.port, {"prompt": fleet_prompt(28, 200),
                                           "max_tokens": 32, "greedy": True, "chat": False})
        stopped = profiler("/profiler/stop", {})
        trace = os.path.join(stopped["trace_dir"], "trace.json")
        size = os.path.getsize(trace)
        text = open(trace).read()
        names = sorted({n for n in ("walk_split", "walk_combine", "PagedTable")
                        if n in text})
        print(f"(u) profiler: {json.dumps(started)} -> {json.dumps(stopped)}; request "
              f"HTTP {code}; trace {size} bytes naming the port's kernels {names}")
        check(code == 200 and size > 0 and names,
              f"(u) the profiler trace names none of the port's kernels ({size} bytes)")
        os.remove(trace)
        flight = get(server.port, "/debug/flight")[1]
        kinds = {}
        for e in flight["events"]:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        print(f"(u) /debug/flight: capacity {flight['capacity']}, recorded "
              f"{flight['recorded_total']}, events by kind {json.dumps(kinds)}")
        for kind in ("preempt", "crash", "restart", "quarantine", "scheduler_dead"):
            check(kinds.get(kind, 0) >= 1, f"(u) /debug/flight holds no {kind} event")
    finally:
        server.shutdown()


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--only", choices=["b", "f", "r", "j", "s"],
                    help="run (a) and then only (b) with the kernels line's two "
                         "flash_attend entries at the solo chunks (b), only (f)'s "
                         "and (j)'s paged_flash_attend cases with the kernels "
                         "line's two entries (f), only their ragged_paged_attend "
                         "cases with a sweep of its plans and the kernels line's "
                         "two entries (r), or only (j)'s q4_matmul_rows cases "
                         "(j), with the kernel's build log: a quick check of a "
                         "flash_attend, paged decode, ragged or q4 change; or "
                         "(s), (t) and (u) on the raw engine (s): a quick check "
                         "of the fleet's preemption, supervisor and health sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from distributed_llm_inference_tpu_torch import kernels
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.engine import paged as P
    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.ops import flash_attention as fa
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant as Q
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.utils import faults

    # the plain twins and the reference path in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # (a) device and build
    smi = nvidia_smi()
    print(f"(a) torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi)
    t0 = time.time()
    built = kernels.build(kernels.sources())
    print(f"(a) built {sorted(built)} in {time.time() - t0:.1f} s")
    timer = Timer(torch)
    if args.only == "f":
        log = built["paged_attention"].with_name(built["paged_attention"].name + ".log")
        print(log.read_text())
        lines = []
        for int8, rows in ((False, phase_f(torch, timer, pa, P, fa, which="decode")),
                           (True, phase_f(torch, timer, pa, P, fa, int8=True,
                                          which="decode"))):
            lines.append(paged_decode_line(rows, None, int8))
        for line in lines:  # launches null: the served path does not run here
            print("(f) " + json.dumps(line))
        return 0
    if args.only == "r":
        log = built["paged_attention"].with_name(built["paged_attention"].name + ".log")
        print(log.read_text())
        rows = phase_f(torch, timer, pa, P, fa, which="ragged")
        int8_rows = phase_f(torch, timer, pa, P, fa, int8=True, which="ragged")
        if hasattr(pa, "ragged_plan"):
            ragged_sweep(torch, timer, pa, P)
        # launches null: the served path does not run here
        print("(f) " + json.dumps(ragged_line(rows, None, False, P)))
        print("(j) " + json.dumps(ragged_line(int8_rows, None, True, P)))
        return 0
    if args.only == "j":
        log = built["q4_matmul"].with_name(built["q4_matmul"].name + ".log")
        print(log.read_text())
        for r in q4_cases(torch, timer, Q):
            print("(j) " + json.dumps(r))
        return 0
    if args.only == "b":
        log = built["flash_attention"].with_name(built["flash_attention"].name + ".log")
        print(log.read_text())
        phase_b(torch, timer, fa)
        if hasattr(fa, "flash_plan"):
            cluster_sweep(torch, timer, fa)
        # (c)'s chunks; launches null: the served path does not run here
        for int8 in (False, True):
            print("(b) " + json.dumps(kernels_line(torch, timer, fa, SOLO_CHUNKS, None,
                                                   int8=int8)))
        return 0

    if args.only != "s":
        # (b) the kernel against its twin
        phase_b(torch, timer, fa)

    # (c) the served path on tinyllama-1.1b
    t0 = time.time()
    engine = create_engine(
        MODEL, dtype="bfloat16", attn_impl="auto", seed=0, device=DEVICE,
        engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS),
    )
    torch.cuda.synchronize()
    if args.only == "s":
        print(f"(s) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_s(torch, engine, pa, fa, Q, smi)
        phase_t(torch, engine, pa, fa, Q, faults, smi)
        phase_u(torch, engine, smi)
        print(f"(u) total {time.time() - t_start:.1f} s")
        return 0
    cfg = engine.cfg
    print(f"(c) {cfg.name}: {cfg.n_layers} layers, dim {cfg.dim}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"attn_impl={cfg.attn_impl}, random weights (seed 0), built in "
          f"{time.time() - t0:.1f} s")
    check(cfg.attn_impl == "kernel", "attn_impl='auto' did not pick the kernel on CUDA")
    results, shapes, launches = phase_c(torch, engine, fa)
    check(sorted(shapes) == sorted(SOLO_CHUNKS),
          f"(c) ran the chunks {shapes}, not SOLO_CHUNKS (update it for `--only b`)")

    # (d) kernel vs plain logits on the same model
    phase_d(torch, engine)

    # (e) report on the solo path
    phase_profile(torch, engine)
    for name in ("greedy", "greedy_again"):
        _, r, wall = results[name]
        print(f"(e) {name}: ttft_s={r['ttft_s']} tokens_per_sec={r['tokens_per_sec']} "
              f"tokens={r['tokens_generated']} wall_s={wall:.3f} ({smi})")
    flash_entry = kernels_line(torch, timer, fa, shapes, launches)

    # (f) the paged kernels against their twins
    paged_rows = phase_f(torch, timer, pa, P, fa)

    # (g) the continuous paged fleet through the HTTP server (the main path)
    wave = phase_g(torch, engine, pa, fa, Q)

    # (h) the fleet's kernel path vs its plain path, and the sync check
    phase_h(torch, engine, P, G, M)

    # (i) report on the fleet
    n_tok = 0
    for i, (_, r, wall) in enumerate(wave["results"]):
        n_tok += r["tokens_generated"]
        print(f"(i) fleet request {i}: prompt_tokens={r['prompt_tokens']} "
              f"ttft_s={r['ttft_s']} tokens_per_sec={r['tokens_per_sec']} "
              f"tokens={r['tokens_generated']} wall_s={wall:.3f}")
    print(f"(i) fleet wave: {n_tok} tokens from {len(wave['results'])} concurrent "
          f"requests in {wave['wave_s']:.3f} s = {n_tok / wave['wave_s']:.2f} tokens/s "
          f"aggregate ({smi})")
    phase_i_profile(torch, engine, P, G)
    print(f"(i) total {time.time() - t_start:.1f} s")

    # (n) flash_attend_slots, driven directly and against its twin
    slots_rows, slots_driven = phase_n(torch, timer, pa)

    # (o) the dense fleet through the HTTP server
    dense_launches = phase_o(torch, engine, pa, fa, Q, G, M)

    # (p) the paged fleet's whole-prefill admissions
    whole_launches = phase_p(torch, engine, pa, fa, Q)
    print(f"(p) total {time.time() - t_start:.1f} s")

    # (q) the fleet's launch kinds as CUDA graphs
    graph_rows = phase_q(torch, engine, P, G, M)
    print(f"(q) total {time.time() - t_start:.1f} s")

    # (s) KV preemption through the HTTP server ("r" names the ragged
    # kernel's --only run)
    preempt = phase_s(torch, engine, pa, fa, Q, smi)
    print(f"(s) total {time.time() - t_start:.1f} s")

    # (t) the supervisor, driven by fault injection
    supervisor = phase_t(torch, engine, pa, fa, Q, faults, smi)
    print(f"(t) total {time.time() - t_start:.1f} s")

    # (u) the health sweep, the status page, the profiler, the flight recorder
    phase_u(torch, engine, smi)
    print(f"(u) total {time.time() - t_start:.1f} s")
    print("(u) " + json.dumps({"recovery_launches": {
        "s": {k: preempt[k] for k in ("ragged_launches", "decode_chunks", "launches")},
        "t": {k: supervisor[k] for k in ("ragged_launches", "decode_chunks", "launches")},
    }}))

    # (j) the int4 / int8 kernels against their twins
    q4_rows = q4_cases(torch, timer, Q)
    phase_b(torch, timer, fa, int8=True)
    int8_rows = phase_f(torch, timer, pa, P, fa, int8=True)

    # (k) the quantized paths through the HTTP server
    del engine
    torch.cuda.empty_cache()
    t0 = time.time()
    qengine = create_engine(
        MODEL, dtype="bfloat16", attn_impl="auto", quant="int4", kv_quant="int8",
        seed=0, device=DEVICE, engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS),
    )
    torch.cuda.synchronize()
    print(f"(k) {MODEL} bf16, quant=int4 (group 64) kv_quant=int8, random weights "
          f"(seed 0), built and quantized in {time.time() - t0:.3f} s")
    qwave = phase_g(torch, qengine, pa, fa, Q, tag="(k)")
    solo_chunks, solo_launches = phase_k_solo(torch, qengine, pa, fa, Q)

    # (l) the quantized fleet's kernel path vs its plain path
    phase_h(torch, qengine, P, G, M, tag="(l)", atol=QUANT_LOGITS_ATOL)

    # (m) report on the quantized paths
    n_tok = 0
    for i, (_, r, wall) in enumerate(qwave["results"]):
        n_tok += r["tokens_generated"]
        print(f"(m) quantized fleet request {i}: prompt_tokens={r['prompt_tokens']} "
              f"ttft_s={r['ttft_s']} tokens_per_sec={r['tokens_per_sec']} "
              f"tokens={r['tokens_generated']} wall_s={wall:.3f}")
    print(f"(m) quantized fleet wave: {n_tok} tokens from {len(qwave['results'])} "
          f"concurrent requests in {qwave['wave_s']:.3f} s = "
          f"{n_tok / qwave['wave_s']:.2f} tokens/s aggregate ({smi})")
    phase_i_profile(torch, qengine, P, G, tag="(m)")
    print(f"(m) total {time.time() - t_start:.1f} s")
    graph_rows += phase_q(torch, qengine, P, G, M)
    print(f"(q) int4+int8 total {time.time() - t_start:.1f} s ({smi})")
    print("(q) " + json.dumps({"graphs": graph_rows}))
    line = {"kernels": [
        flash_entry,
        ragged_line(paged_rows, wave["launches"], False, P),
        paged_decode_line(paged_rows, wave["launches"], False),
        q4_line(q4_rows, qwave["launches"]),
        kernels_line(torch, timer, fa, solo_chunks,
                     solo_launches["flash_attend[int8]"], int8=True),
        ragged_line(int8_rows, qwave["launches"], True, P),
        paged_decode_line(int8_rows, qwave["launches"], True),
        slots_line(slots_rows, slots_driven,
                   dense_launches["flash_attend_slots"]
                   + whole_launches["flash_attend_slots"]),
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
