"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch twin on the card, then serves
tinyllama-1.1b (published widths, 22 layers, bf16, random weights from
seed 0) through the port's own HTTP server and checks that the served
requests went through the kernels. Phases, each of which fails the run:

  (a) the device, `nvidia-smi`'s name and power limit, the kernel build;
  (b) flash_attend vs its plain twin at tinyllama's attention shapes
      (H=32, KV=4, Dh=64, S=2048), bf16 and fp32, with kernel, twin,
      SDPA-yardstick and bound times;
  (c) three /generate requests (greedy, sampled, and a prompt longer than
      the largest prefill bucket so chunked extend runs), the greedy one
      repeated; the kernel's launch count must rise by n_layers per T>1
      chunk;
  (d) the same model's logits with attn_impl="kernel" vs "plain";
  (e) TTFT and tokens/s, the kernels' JSON line, and as the last line
      {"ok": true, "device": {...}}.

It needs a CUDA device and the repository: with no card, or run from a
directory that holds nothing else of the repository, it exits non-zero
and prints no result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import json
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FLOP/s by input type
# (fp32 runs on the CUDA cores, not the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# logprobs pin every emitted token: random weights mostly emit ids past
# the byte tokenizer's 259, which decode to no text
GREEDY = {"prompt": "The history of the printing press begins", "max_tokens": 32,
          "greedy": True, "chat": False, "logprobs": True}
SAMPLED = {"prompt": "Write a short poem about the sea.", "max_tokens": 32,
           "temperature": 0.8, "top_k": 40, "top_p": 0.95, "seed": 7}
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


def flash_work(B, T, pos, valid_start, window, dtype_name):
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
        nbytes += 2 * KV * DH * esize * max(pos + T - lo_min, 0)
    return nbytes, 4 * DH * H * pairs


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_case(torch, timer, fa, *, dtype_name, B, T, pos, valid_start=None,
               window=None, softcap=None, scale=None, seed=0, reps=10):
    """One kernel-vs-twin comparison with its times; returns a dict."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, T, H, DH, generator=g, device=DEVICE).to(dt)
    k = torch.randn(B, KV, S, DH, generator=g, device=DEVICE).to(dt)
    v = torch.randn(B, KV, S, DH, generator=g, device=DEVICE).to(dt)
    vs = (torch.tensor(valid_start, dtype=torch.int32, device=DEVICE)
          if valid_start is not None else None)
    kw = dict(window=window, softcap=softcap, scale=scale)
    got = fa.flash_attend(q, k, v, pos, vs, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attend_plain(q, k, v, pos, vs, **kw)
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), "flash_attend: non-finite output")
    ms = timer.ms(lambda: fa.flash_attend(q, k, v, pos, vs, **kw), reps)
    plain_ms = timer.ms(lambda: fa.flash_attend_plain(q, k, v, pos, vs, **kw),
                        max(2, reps // 4))
    library_ms = None
    if softcap is None:  # SDPA has no softcap: no single call computes it
        q_pos = pos + torch.arange(T, device=DEVICE)
        kv_pos = torch.arange(S, device=DEVICE)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None and window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        mask = mask[None, None].expand(B, 1, T, S)
        if vs is not None:
            mask = mask & (kv_pos[None, None, None, :] >= vs[:, None, None, None])
        mask = mask.contiguous()
        qt = q.transpose(1, 2)
        library_ms = timer.ms(
            lambda: F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask, scale=scale, enable_gqa=True),
            reps,
        )
    nbytes, flops = flash_work(B, T, pos, valid_start, window, dtype_name)
    bound_ms, bound_by = bound(nbytes, flops, dtype_name)
    return dict(dtype=dtype_name, B=B, T=T, pos=pos, valid_start=valid_start,
                window=window, softcap=softcap, scale=scale, max_abs_err=err,
                atol=ATOL[dtype_name], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                nbytes=nbytes, flops=flops)


def phase_b(torch, timer, fa):
    """flash_attend vs its twin at tinyllama's shapes."""
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        for B in (1, 4):
            for T in (64, 512, 2048):
                for pos in (0, 700):
                    if T + pos <= S:
                        cases.append(dict(dtype_name=dtype_name, B=B, T=T, pos=pos))
        cases += [
            dict(dtype_name=dtype_name, B=4, T=512, pos=700,
                 valid_start=[0, 37, 300, 700]),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, window=256),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, softcap=30.0),
            dict(dtype_name=dtype_name, B=1, T=512, pos=700, scale=0.2),
        ]
    rows = []
    print(f"(b) flash_attend vs plain twin, H={H} KV={KV} Dh={DH} S={S}; device "
          f"ms per call, cold L2")
    for i, c in enumerate(cases):
        r = flash_case(torch, timer, fa, seed=i, **c)
        rows.append(r)
        extra = {k: r[k] for k in ("valid_start", "window", "softcap", "scale")
                 if r[k] is not None}
        print(f"    {r['dtype']:8s} B={r['B']} T={r['T']:4d} pos={r['pos']:3d} "
              f"{json.dumps(extra) if extra else '':28s} err={r['max_abs_err']:.3g} "
              f"(atol {r['atol']:g}) kernel={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f')} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [r for r in rows if not r["max_abs_err"] <= r["atol"]]
    check(not bad, f"flash_attend disagrees with its twin in {len(bad)} case(s)")
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
        len(engine.tokenizer.encode(text)), engine._buckets())
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
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
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
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t / 1e3:8.3f} ms {n:5d}x  {name[:100]}")


def kernels_line(torch, timer, fa, shapes, launches):
    """The kernels' JSON entry, timed at the main path's own chunk shapes
    (bf16, B=1, as served) and averaged per launch over them."""
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0, n=0)
    err = 0.0
    for i, ((T, pos), n) in enumerate(sorted(counts.items())):
        r = flash_case(torch, timer, fa, dtype_name="bfloat16", B=1, T=T, pos=pos,
                       seed=100 + i, reps=20)
        check(r["max_abs_err"] <= r["atol"], f"flash_attend at main-path shape {T, pos}")
        err = max(err, r["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "nbytes", "flops"):
            tot[key] += n * r[key]
        tot["n"] += n
    bound_ms, bound_by = bound(tot["nbytes"], tot["flops"], "bfloat16")
    n = tot["n"]
    return {
        "name": "flash_attend",
        "route": "cuda",
        "source": "distributed_llm_inference_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distributed_llm_inference_tpu/ops/flash_attention.py:84",
        "launches": launches,
        "max_abs_err": err,
        "ms": tot["ms"] / n,
        "plain_ms": tot["plain_ms"] / n,
        "bound_ms": bound_ms / n,
        "bound_by": bound_by,
        "library_ms": tot["library_ms"] / n,
        "shapes": f"bf16 B=1 H={H} KV={KV} Dh={DH} S={S}, (T, pos) per chunk: "
                  + ", ".join(f"{s}x{c}" for s, c in sorted(counts.items())),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from distributed_llm_inference_tpu_torch import kernels
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.ops import flash_attention as fa
    from distributed_llm_inference_tpu_torch.runtime import create_engine

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

    # (b) the kernel against its twin
    phase_b(torch, timer, fa)

    # (c) the served path on tinyllama-1.1b
    t0 = time.time()
    engine = create_engine(
        MODEL, dtype="bfloat16", attn_impl="auto", seed=0, device=DEVICE,
        engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS),
    )
    torch.cuda.synchronize()
    cfg = engine.cfg
    print(f"(c) {cfg.name}: {cfg.n_layers} layers, dim {cfg.dim}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"attn_impl={cfg.attn_impl}, random weights (seed 0), built in "
          f"{time.time() - t0:.1f} s")
    check(cfg.attn_impl == "kernel", "attn_impl='auto' did not pick the kernel on CUDA")
    results, shapes, launches = phase_c(torch, engine, fa)

    # (d) kernel vs plain logits on the same model
    phase_d(torch, engine)

    # (e) report
    phase_profile(torch, engine)
    for name in ("greedy", "greedy_again"):
        _, r, wall = results[name]
        print(f"(e) {name}: ttft_s={r['ttft_s']} tokens_per_sec={r['tokens_per_sec']} "
              f"tokens={r['tokens_generated']} wall_s={wall:.3f} ({smi})")
    print(f"(e) total {time.time() - t_start:.1f} s")
    line = {"kernels": [kernels_line(torch, timer, fa, shapes, launches)]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
