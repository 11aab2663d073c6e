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

Run after (u), before (j), on (g)'s fleet with `--prefix-cache 8` (the
block-prefix cache and, by default, the KV shadow), through the HTTP
server:

  (v) (v1) one request registers a 512-token head (32 blocks), then a wave
      of 8 shares it (tails of 16 to 200 tokens, greedy and sampled, 32
      new tokens each) on three fleets: no prefix cache, the prefix cache
      without the shadow, and with it. Hits and saved tokens rise by 8 and
      8 x 512, `dli_kv_pool_shared_blocks` is above 0 mid-wave, the head's
      blocks are bit-unchanged across the wave, the kernels launch n_layers
      times per mixed launch and per decode step and nothing else, each
      graph is captured once, and at idle only the index holds blocks;
      the median TTFT of 5 pinned 612-token greedy requests, hit against
      cold; the greedy tokens of both fleets, identical or where they part
      (with the teacher-forced max |Δlogits| there); the waves' aggregate
      tokens/s; the capture's device ms and bytes (an 8-block gather and
      its copy to pinned memory) and the restore's per 32-block scatter;
      one mixed launch and the capture it triggers under
      set_sync_debug_mode("error"), the landed bytes exact; (v2) a hit of
      the bucketed whole-prefill admission: flash_attend n_layers times per
      tail chunk over the scratch gathered from the pool, its greedy tokens
      against a cold bucketed fleet's; (v3) a decode_launch fault in a wave
      of 4, shadow on and off on the raw pool, then on an int8 pool: every
      request answered after one restart, restored blocks > 0 warm and 0
      cold, fewer tokens recomputed warm than cold, crash to the next
      launch, graphs captured once, the tokens fetched before the crash
      kept; (v4) (s)'s pair with the prefix cache: A's "swap" resume
      restores its shadowed blocks, A's stream against its run alone;
      (v5) a drain writes restore_dir, a fleet started on it restores and
      serves its first request as a hit with the pre-drain hit's tokens; a
      64-block host tier demotes a chain to the disk tier (kv_disk_dir) and
      an admission promotes it back (a `tier_promote` event), the same
      tokens.

Run after (v), before (j), on (v)'s fleet with a second replica:

  (w) the cross-replica KV fabric. The holder is the port's server CLI in
      a subprocess on the same card (`--continuous 8 --kv-pool-blocks 513
      --kv-block-size 16 --continuous-max-seq 1024 --prefix-cache 8`, the
      same model and seed), killed at the end; the pullers are fleets in
      this process, so their launch counters can be read. First a cold
      greedy request gives the same tokens on both (the same weights).
      (w1) five 512-token heads registered on the holder (a handoff's
      phase 1: answered once the shadow copies landed); for each, a
      612-token greedy request with the router's X-KV-Transfer-Peer /
      -Digest hint on the streamed and on the whole-blob puller: 32 blocks
      imported, a hit at 512, fabric fetches / hits / misses +1 / +1 / +0,
      the tokens of a cold fleet and of the holder's own hit, the two
      paged kernels launched n_layers times per mixed launch and per
      decode step and nothing else, each graph captured once; medians of
      5 of the remote hit's TTFT (streamed and whole-blob), a local hit's
      and a cold run's, the pull's prefetch, wire and scatter ms (and the
      page-locking inside the scatter), its bytes and MB/s over loopback;
      (w2) a wave of 8 hinted requests behind one remote head: one fetch,
      one hit, the rest hit the imported chain; then a wave on the local
      head; (w3) the handoff: phase 1 on the holder with X-KV-Prefill-Only
      and X-KV-Push-To the puller, phase 2 on the puller with the hint: the
      pushed chain promoted, no fetch, the cold tokens; (w4) a dead peer, a
      digest the holder lacks and an int8 holder (`--kv-quant int8`, a
      second subprocess) against the raw puller: each a counted miss
      (flight event hit false) inside the fetch deadline with the cold
      tokens; then an int8 puller's remote hit on the int8 holder, the int8
      cold tokens; (w5) a remote hit of the bucketed whole-prefill
      admission from a bucketed peer in this process (whose cold run wrote
      the head): flash_attend n_layers times for its one tail chunk, the
      cold bucketed fleet's tokens.

Run after (w), before (x), on replica processes of their own:

  (R) the router tier. The port's router (serving/router.py, in process)
      in front of a prefill-class and a decode-class replica, each the
      port's server CLI spawned by the router's spawn_replicas with
      tinyllama-1.1b at its published widths, bf16, seed 0, `--continuous
      8 --kv-block-size 16 --prefix-cache 8 --trace-sample-rate 1.0
      --warmup` and `--compile-cache` at the directory (a) built, started
      together with (R4)'s two mixed replicas so that the four start-ups
      overlap (each replica's device memory printed). (R1) a cold greedy
      request straight to the decode
      replica and through the router: the same ids; a wave of 8 greedy
      requests (four behind one shared 512-token head, handed off from the
      prefill replica) straight to one replica and through the router,
      every answer in full, its aggregate tokens/s beside the direct
      wave's, its ids against each prompt alone on the replica (printed).
      (R2) one traced 700-token request through the two-phase handoff with
      the chain pulled over the fabric, a companion prefill on the decode
      replica under its decode: its envelope's replica and fabric blocks;
      GET /debug/traces/{id} on the router assembles one tree holding the
      router's spans, replica.request on both replicas, fabric.pull,
      kv.serve and launch.mixed / launch.chunk spans, its span total within
      the wall; ?format=chrome parses into the three lanes. (R3) the decode
      replica profiled through its /profiler routes during a wave of 8
      through the router: the trace's kernels are ragged_paged_attend
      n_layers times per mixed launch and paged_flash_attend n_layers
      times per decode step, nothing else; the kernels line gains
      launches_R, these counts. (R4) two mixed replicas: kill -9 of one
      with a request held on it (a DLI_FAULTS prefill wedge) fails over
      with the fault-free ids, the dead replica is ejected within the
      probe window and readmitted after a respawn; the dli_router_*
      counters printed.

Run in a third process after (q) (`chip_smoke.py --only P`, its output
in build/chip_smoke_lane_P.log, shown after (S)), beside the main
process's (s)-(S) and the lane, on stage processes of its own:

  (P) the MPMD stage pipeline (serving/stage_runtime.py): tinyllama-1.1b
      at its published widths, bf16, seed 0, cut into 2 stages by
      plan_stages (layers 0-11 and 11-22, the source paper's Worker1 /
      Worker2), each a stage process on the card (`--device cuda
      --block-size 16`, a restore directory under a temporary directory),
      the controller and the frontend in this process; the stages start
      while the in-process reference is built. Each stage holds its half
      of the weights (its device memory printed, nvidia-smi's and its
      own), and no stage process maps a kernel library: the stages run
      the plain path, as the JAX stage worker runs the XLA one. (P1) one
      greedy /generate through the frontend, a 100-token prompt and 32
      new tokens, against an in-process single-device reference built
      from the same seed (M.forward prefill, then T=1 steps): equal, or
      parted at a near-tie (the reference's top-2 gap there under
      LOGITS_ATOL); its tokens/s, each hop's wall ms, the wire bytes per
      crossing. (P2) kill -9 of stage 0, then of stage 1, each after 6
      decode tokens, under warm restore: the request completes, its ids
      follow (P1)'s rule against (P1)'s, last_salvage's secs and
      tokens_recomputed (< 16), every stage's slots free again. (P3) the
      same request with --wire-quant int8: dli_pp_wire_bytes_total
      {path="stage"} against (P1)'s, the ratio, the greedy match rate
      against (P1)'s ids. (P4) POST /admin/rolling-restart under 4
      concurrent requests: none fails, each one's ids equal its run alone.

Run after (w), before (j), on (g)'s fleet (the same weights, other engine
settings):

  (x) speculation on the mixed launch. (x1) a wave of 8 greedy requests
      whose prompts repeat one sentence (200-600 tokens, 64 new tokens),
      X_WAVES times each on the fleet with spec_draft_len 0 and with
      --spec-decode (n-gram drafts, K 4), after a lone request on each:
      aggregate tokens/s (median), the lone stream's tokens/s, the
      `speculative` stats per wave (verify rows, drafted, accepted,
      pipelined) and tokens per verify row, mixed launches against decode
      chunks, the kernels' launches from 0 per wave (ragged n_layers per
      mixed launch, paged n_layers x 16 per decode chunk), graphs captured
      once per kind; each speculating stream equals the plain one or parts
      at a near-tie (the plain run's top-2 logit gap under LOGITS_ATOL at
      the parting, teacher-forced); one wave on an int8 pool. (x2) the
      draft-model fleet with the target's own weights as its draft (the
      acceptance), then with a 2-layer draft at tinyllama's widths (seed
      1): tokens/s, and the propose chain's paged_flash_attend launches,
      draft layers x (K + 1) per chain. (x3) the verify launch (n-gram and
      draft proposals), the draft fill and the propose chain captured at
      the serving shape, 2 replays each bit-equal to eager under the sync
      check; ragged_paged_attend on launches with K = 4 and K = 8 verify
      rows (q_start derived on the device) and paged_flash_attend over the
      draft's pool against their twins. (x4) a decode_launch crash landing
      behind verify rows in flight, and (s)'s preemption pair on the
      --spec-decode engine: answered in full, the tokens fetched before the
      eviction equal to an undisturbed run's.

Run after (y), before (j), on (g)'s fleet (an engine of its own over the
same weights, `--adapter-slots 4 --adapter-rank 8`, five PEFT adapters
written under build/chip_smoke_z/ from seeds: ranks 4 and 8, one rsLoRA,
one BF16 file, every projection):

  (z) runtime LoRA adapters. (z1) (g)'s wave through the HTTP server with
      6 of its 8 requests over the 5 adapters (the fifth joins when every
      page is held: backpressure, then a swap): every envelope echoes its
      adapter, loads / evictions / swaps 5 / 1 / 1, no page referenced and
      every block back after it, ragged n_layers per mixed launch, paged
      n_layers x 16 per decode chunk, each graph captured once; (z2) a
      base request bit-identical to a fleet with no pool, an adapter
      request against merge-at-load (create_engine(lora=...)); (z3)
      scripted launches with rows on pages 0, 1 and 3 through the kernels
      vs the plain path, the page-0 row bit-equal to a launch without
      pages, the adapter rows moved past LOGITS_ATOL; the mixed launch and
      the decode chunk captured on the base pages, adapters loaded in
      place, replays bit-equal to eager under the sync check; (z4) their
      profiled replays with no pool, a pool with base rows and rows on 4
      adapters, pool_bytes and one page load's host ms; (z5) /v1/models,
      an SSE chat on `model: <adapter>` equal to its unstreamed text, an
      unknown model's 400, the server CLI with --lora and --adapter
      serving, --adapter on the --lora directory refused at start; (z6) a
      decode_launch crash with adapters resident (the tokens fetched
      before it kept, no page loaded again), one adapter request under
      --quant int4 --kv-quant int8 with q4_matmul_rows as in (k).

Run after (C), before (j), on engines of (g)'s weights whose tokenizer
spells every id (a response is its token ids):

  (S) the solo engine's features through the port's server. (S1) a
      greedy "speculative": true request (a 300-token repetitive prompt,
      32 new) on a solo server: flash_attend n_layers times per prefill
      chunk and per verify forward (T = 5), the ids of the plain request
      or a parting at a near-tie (the plain path's top-2 gap under
      LOGITS_ATOL), verify forwards, accepted drafts, host reads per
      token, tokens/s against plain; the same request to a dense fleet,
      served by the solo engine. (S2) the target as its own draft, then a
      2-layer draft (create_engine(draft_model=...), seed 1): acceptance,
      tokens/s, flash_attend n_layers per target chunk and verify plus the
      draft's layers per ingest chunk, a greedy repeat identical. (S3)
      num_beams 4, early_stopping both ways: 4 beams sorted by score, a
      repeat identical, beam 0 against an attn_impl="plain" engine's,
      flash_attend for the prefill chunk alone, the cache reorder's device
      ms per step. (S4) /v1/completions echo scoring of 700 tokens: 6
      chunks of n_layers launches, logprobs against the plain engine's
      within LOGITS_ATOL and the same top-1 outside near-ties, the
      echo_score_response shape, a fifth concurrent scorer 429. (S5) a
      solo server with --prefix-cache 4: hits behind a 512-token head
      (TTFT against cold, the tail chunk's n_layers launches and no head
      chunk, ids equal cold, the hits counter, one snapshot's bytes), one
      int8 hit; the dense fleet's wave of 8 behind the head against an
      uncached wave. (S6) --queue 16 --queue-max-batch 8 --queue-wait-ms
      5: 8 concurrent greedy requests coalesced, each against its run
      alone, aggregate tokens/s against one by one.

Run in the lane after (C) ((F2) in the main process after (q) int4+int8,
before the kernels line), on the other families at full width (bf16,
random weights from seed 0, the byte tokenizer):

  (F) (F1) gpt2-medium (MHA, a GQA group of 1; learned positions): (c)'s
      solo requests and (d)'s logits, (g)'s paged wave with its graphs
      and (h)'s kernel-vs-plain logits and sync check, (q)'s graphs of
      the mixed launch and the paged and dense decode chunks, each
      replay bit-equal to its eager launch, (o)'s dense wave; then under
      --quant int4 --kv-quant int8, (g), (h) and (q)'s paged kinds again
      with q4_matmul_rows on every decode projection. (F4) --checkpoint
      through the server's CLI, started in process: gpt2-medium's
      weights written as a BF16 HF directory (the port's safetensors
      writer, HF names, no tokenizer files) and as a checkpoint store,
      each serving a greedy request alone with the in-memory fleet's
      ids; a 2-layer full-width qwen3_moe directory whose converted
      config and every stacked expert bank equal the in-memory model's,
      served with its ids. (F3) qwen3-30b-a3b (128 experts of 768, Dh
      128, max_seq cut to 2048) at 12 of its 48 layers in the full run,
      all 48 under `--only F`: (c), (g), (h)'s sync check and (q)'s paged
      kinds, then its int8 expert banks at 12 layers (24 under `--only
      F`) through the same; (d)'s and (h)'s logits held to the plain
      path in fp32 at 4 layers (a bf16 comparison measures router ties),
      dense and int8.
      (F2) the four kernels at both models' widths against their twins,
      timed in turn with SDPA / matmul(dequantized) and against their
      bounds, one JSON row per kernel and model. The kernels line gains
      launches_F: every kernel's count over (F)'s main-path runs.

Run in six more processes side by side once the main process's (S) and
the second lane are done (`chip_smoke.py --only D`, and M, L, E, N and
H, their output in build/chip_smoke_lane_{D,M,L,E,N,H}.log, shown after
(P)), on rank processes of their own:

  (D) the dp x pp x tp pipeline backend (parallel/pipeline.py),
      tinyllama-1.1b bf16 seed 0. (D1) (g)'s fleet and wave (greedy, the
      unsheddable "batch" class) over pp = 2 (layers 0-11 and 11-22 on
      two ranks; on one card they share it over gloo) through the HTTP
      server, each fleet's second (warm) wave against the single device's
      fleet: ids equal, or parted at a near tie with every later token
      near-top under teacher forcing, each rank's kernel counts
      (n_layers / 2 per ragged launch and per decode step) and its own
      torch.profiler trace of a third wave (its kernels, its device busy
      time, its host seconds inside each collective; the driver's
      programs, pipe bytes and waits), TTFT, aggregate tokens/s, each
      rank's memory. (D2) tp = 2 solo (16 / 2 heads a rank): prefill
      logits against the plain path within LOGITS_ATOL, flash_attend
      n_layers times per rank. (D3) pp = 2 solo: prefill logits against
      the single device's within LOGITS_ATOL, ids held as in (D1); then
      --pp-wire-quant int8 against the raw wire: bytes per path. (D4) a one-rank NCCL mesh through the same
      backend, bit-equal to the single device; with several cards, a pp =
      2 x tp = 2 (or pp = 2) mesh of ranks on cards of their own, NCCL
      across ranks. The kernels line gains launches_D.
  (M) the 1F1B schedule (parallel/schedule.py): (g)'s eight prompts as
      one left-padded batch (a 1024 bucket, 32 new, greedy) through the
      backend's prefill (its logits returned) and decode and through
      `generate_batch`, on the single device, on pp = 2 with microbatches
      1 (the plain ring) and with microbatches 2: prefill logits against
      the plain run's and the single device's within LOGITS_ATOL, ids
      equal the plain run's or parted at a near tie (near-top after it
      under teacher forcing), tokens/s of a timed batch, each rank's
      `flash_attend` count (one T>1 chunk a microbatch and layer), its
      device busy share and host seconds in collectives over a profiled
      batch; then the server's CLI with `--pp 2 --microbatches 2` serving
      a batch of 2 on the 1F1B path. The kernels line gains launches_M.
  (L) context parallelism (parallel/context.py, ring.py): a 1536-token
      prompt with 32 new at sp = 2, ring, Ulysses and the ring under
      the int8 wire, then a 512-token one at sp 2 x pp 2 (four ranks),
      each against the single device: prefill logits within
      LOGITS_ATOL, ids held as in (M), the sp link's bytes, each rank's
      cache bytes against the single device's, no kernel on any rank
      (the ring's attention is plain PyTorch).
  (E) the expert mesh: qwen3-30b-a3b at ep = 2 (64 of 128 experts a
      rank), its logits in fp32 at 4 layers within 1e-3 of the single
      device's (`flash_attend` 4 a rank), then (g)'s wave in bf16 at 12
      of 48 layers through the HTTP server (every rank runs every layer:
      ragged 12 per mixed launch, paged 12 x 16 per chunk), each rank's
      memory and, over a profiled wave, the device ms of its expert
      products (`moe_ffn.experts`). The kernels line gains launches_E.
  (N) part C of the mesh, tinyllama-1.1b bf16 seed 0 over pp = 2 (two
      ranks sharing the card over gloo). (N1) the solo surface on the
      ring against the single device: a score (|dlogprob| under
      LOGITS_ATOL), 3 beams (each equal, or its score within
      LOGITS_ATOL), prompt-lookup and 2-layer draft-model speculation
      (greedy ids equal the single device's speculation's, or parted
      where the single device's top-2 gap is under LOGITS_ATOL; the
      single device's against plain greedy printed beside),
      `flash_attend` on every rank, as many on each, and a profiled
      score request's flash walks in every rank's trace. (N2) (z1)'s
      wave of 8 (greedy; 2 base, 6 over 5 adapters on 4 pages, a swap)
      through the pp = 2 paged fleet against the single device's fleet
      with the same adapters (partings only at near ties of the merged
      weights), ragged and paged launches per rank (n_layers / 2 per
      launch and step), a base request alone under every rank's
      profiler (the ragged and paged walks in each trace), one page
      load's wall, and one z-a2 request at tp = 2. (N3) a store of the
      model served by the server's CLI with `--checkpoint --pp 2` (a
      process of its own): the bytes of the store each rank's shard
      holds against the tree's, and (N2)'s solo request's ids equal.
      The kernels line gains launches_N.
  (H) two server processes (`--num-processes 2 --process-id 0|1
      --coordinator 127.0.0.1:<port> --pp 2`, fp32, one rank each on the
      card): one request through process 0, its tokens (pinned by their
      logprobs) equal the single device's; /workers shows the other
      process's stage "remote"; SIGTERM ends process 0 within the bounded
      shutdown, and process 1 exits after it.

The full run goes in seven processes after (q): (x), (y), (z), (C) and
(F) run in a second one, `chip_smoke.py --lane x,y,z,C,F`, on an engine
of its own (the same model and seed, so the same weights), and (P) in a
third, `chip_smoke.py --only P`, while the main process runs (s)-(w), (R)
and (S), then (D), (M), (L), (E), (N) and (H) in six more once those are
joined;
each lane's output is shown when it ends,
and the --lane one's last line carries its kernel counts. Every phase is bound by the host
(the card idles most of the time) and a process is one thread of Python.
No kernel is timed while the lanes run: (b), (f) and (n) come before
them, (j) and (F2) after them.

`python3 chip_smoke.py --only s` runs (a), then (s), (t) and (u) alone on
the raw engine (about two minutes); `--only v` runs (a), then (v) alone;
`--only w` runs (a), then (w) alone; `--only x` runs (a), then (x) alone;
`--only y` runs (a), then (y) alone; `--only z` runs (a), then (z) alone;
`--only S` runs (a), then (S) alone; `--only R` runs (a), then (R)
alone; `--only P` runs (a), then (P) alone; `--only D` runs (a), then (D)
alone; `--only M`, `--only L`, `--only E`, `--only N` and `--only H` run
(a), then that phase alone; `--only F` runs (a), then (F)
alone with profiled solo requests,
mixed launches and decode chunks of both models (left out of the full run
for time).

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
and prints no result. It imports nothing of the JAX package. Its standard
output is line-buffered, so a run stopped from outside shows how far it
got; a run still going after WATCHDOG_S seconds writes every thread's
stack to standard error, once, and goes on.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

MODEL = "tinyllama-1.1b"
DEVICE = "cuda"
# a whole run is held to 1200 s: past this many seconds it dumps its stacks
WATCHDOG_S = 1100
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
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        kern = [e for e in device_kernels(prof) if "FillFunctor" not in e.name]
        by_name = {}
        for e in kern:
            by_name.setdefault(e.name, []).append(e.elapsed_us())
        if not kern:
            return None
        if all(len(us) % reps == 0 for us in by_name.values()):
            return sum(map(sum, by_name.values())) / reps / 1e3
        if all(len(us) <= reps for us in by_name.values()):
            return sum(sum(us) / len(us) for us in by_name.values()) / 1e3
        return None


def kv_row_bytes(dtype_name, int8, dh=DH):
    """Bytes of one position's K or V row of one KV head: Dh elements, or
    Dh int8 bytes and a 4-byte scale."""
    return dh + 4 if int8 else dh * (4 if dtype_name == "float32" else 2)


def flash_work(B, T, pos, valid_start, window, dtype_name, int8=False, widths=(H, KV, DH)):
    """(bytes, FLOPs) the attention of this call needs: q read and o
    written once, each live K/V row read once, and 4*Dh FLOPs per head for
    each (query, key) pair the mask lets through (the two products).
    widths: (H, KV, Dh), tinyllama's unless given."""
    h, kv, dh = widths
    esize = 4 if dtype_name == "float32" else 2
    nbytes = 2 * B * T * h * dh * esize
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
        nbytes += 2 * kv * kv_row_bytes(dtype_name, int8, dh) * max(pos + T - lo_min, 0)
    return nbytes, 4 * dh * h * pairs


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
               profile=False, widths=(H, KV, DH)):
    """One kernel-vs-twin comparison with its times, over a raw or an int8
    cache; returns a dict. SDPA, the yardstick, runs twice in the same
    loop: over the whole cache (the tables' column) and over the live
    slice k[:, :, :pos + T] (the dead keys' work left out). With
    `profile`, the kernel's and SDPA's own device time per call too.
    widths: (H, KV, Dh), tinyllama's unless given."""
    import torch.nn.functional as F

    h, kv, dh = widths
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, T, h, dh, generator=g, device=DEVICE).to(dt)
    k = torch.randn(B, kv, S, dh, generator=g, device=DEVICE)
    v = torch.randn(B, kv, S, dh, generator=g, device=DEVICE)
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
    nbytes, flops = flash_work(B, T, pos, valid_start, window, dtype_name, int8, widths)
    bound_ms, bound_by = bound(nbytes, flops, dtype_name)
    # the launch plan (an older checkout, timed by `--only b`, has none)
    plan = (fa.flash_plan(B, T, h, kv, S, dh, fa._sm_count(q.device), q.element_size(),
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


def post(port, body, timeout=600, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
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


def phase_c(torch, engine, fa, tag="(c)"):
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
            print(f"{tag} {name}: HTTP {code} tokens={r.get('tokens_generated')} "
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
        print(f"{tag} /stats: {json.dumps(stats)}")
    finally:
        server.shutdown()
    return results, shapes, launches


def phase_d(torch, engine, tag="(d)", atol=LOGITS_ATOL):
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
    print(f"{tag} logits kernel vs plain: max_abs_err={err:.4g} (atol {atol}) "
          f"mean_abs_err={mean_err:.4g} "
          f"logit spread (std)={p.std().item():.3f}; first greedy token "
          f"kernel={tok_k} plain={tok_p} (plain top-2 gap {gap:.4g})")
    check(err <= atol, "kernel-path logits disagree with the plain path")
    # a greedy token can only be pinned where the top-2 gap exceeds the
    # logits' own tolerance
    check(tok_k == tok_p or gap <= 2 * err, "first greedy token differs")
    return err


class DevKernel:
    """One device kernel of a torch.profiler trace: its name and its
    interval in us."""

    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end

    def elapsed_us(self) -> float:
        return self.end - self.start


def device_kernels(prof) -> list:
    """The device kernels of a finished torch.profiler session, read from
    its raw kineto events. prof.events() would first build a FunctionEvent
    tree of every host op, which takes seconds per ten thousand kernels; the
    device events it keeps are these (not hidden, device type CUDA), less
    the device spans of user annotations (record_function ranges, such as
    the MoE FFN's expert range), which are no kernels."""
    from torch.autograd import DeviceType

    return [DevKernel(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and not e.is_hidden_event()
            and not e.is_user_annotation()]


def busy_union_us(kernels) -> float:
    """Device busy time: the union of the kernels' intervals, in us."""
    busy_us, end = 0.0, None
    for a, b in sorted((e.start, e.end) for e in kernels):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return busy_us


def phase_profile(torch, engine, tag="(e)"):
    """Where a warm greedy request's time goes, from one run under
    torch.profiler (which adds host time of its own): the device's busy
    share (the union of kernel intervals over the request's wall time),
    kernels per generated token, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = engine.generate(GREEDY["prompt"], max_tokens=GREEDY["max_tokens"],
                            greedy=True, chat=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(r["status"] == "success", f"profiled request: {r}")
    kern = device_kernels(prof)
    busy_us = busy_union_us(kern)
    n_tok = r["tokens_generated"]
    print(f"{tag} profiled greedy request: wall_ms={wall_us / 1e3:.2f} "
          f"timings={json.dumps(r['timings'])} tokens={n_tok}")
    if not kern:
        print(f"{tag} device busy share: not measured (the profiler recorded no "
              "device kernels)")
        return
    print(f"{tag} device busy_ms={busy_us / 1e3:.2f} busy_share={busy_us / wall_us:.4f} "
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


def paged_pool(torch, dt, rows, seed, int8=False, widths=(H, KV, DH)):
    """A random pool [N, KV, 16, Dh] (raw, or int8 with its scales) and
    `rows` block tables of 64 blocks each, drawn from a shuffled
    permutation of blocks 1..N-1 (0 is the trash block), so the kernels'
    table walk really jumps. widths: (H, KV, Dh), tinyllama's unless
    given."""
    _, kv, dh = widths
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = rows * SLOT_MB + 1
    pool_k = torch.randn(n, kv, BLOCK, dh, generator=g, device=DEVICE)
    pool_v = torch.randn(n, kv, BLOCK, dh, generator=g, device=DEVICE)
    if int8:
        pool_k, pool_v = int8_leaf(torch, pool_k), int8_leaf(torch, pool_v)
    else:
        pool_k, pool_v = pool_k.to(dt), pool_v.to(dt)
    perm = torch.randperm(n - 1, generator=g, device=DEVICE)[: rows * SLOT_MB] + 1
    return g, pool_k, pool_v, perm.reshape(rows, SLOT_MB).to(torch.int32).contiguous()


def paged_work(row_queries, width, dtype_name, window, index_bytes, int8=False,
               widths=(H, KV, DH)):
    """(bytes, FLOPs) of one paged attention launch: q read once for the
    live query rows only (the kernel never reads a padding row), o written
    once for all `width` rows (padding rows get zeros), each table row's
    live keys' K/V rows read once with the table entries that locate them,
    the per-query or per-tile indices (`index_bytes`), and 4*Dh FLOPs per
    head for each (query, key) pair the mask lets through. row_queries:
    {table row: [query positions]}. widths: (H, KV, Dh), tinyllama's
    unless given."""
    h, kv, dh = widths
    esize = 4 if dtype_name == "float32" else 2
    live = sum(len(qs) for qs in row_queries.values())
    nbytes = (live + width) * h * dh * esize + index_bytes
    pairs = 0
    for qs in row_queries.values():
        lows = [max(0, q - window + 1) if window else 0 for q in qs]
        pairs += sum(q + 1 - lo for q, lo in zip(qs, lows))
        lo, hi = min(lows), max(qs)
        nbytes += (2 * kv * kv_row_bytes(dtype_name, int8, dh) * (hi + 1 - lo)
                   + 4 * (hi // BLOCK - lo // BLOCK + 1))
    return nbytes, 4 * dh * h * pairs


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
    pool = pk.q if int8 else pk
    n_split = (pa._paged_splits(q.shape[0], pool.shape[1], table.shape[1], pool.shape[2],
                                pa._sm_count(q.device))
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
        N, KV_, bs, Dh = (pk.q if int8 else pk).shape
        G = meta.shape[0]
        plan = pa.ragged_plan(G, q.shape[0] // G, q.shape[1], KV_, table.shape[1], bs, Dh,
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
    launch, which ran eagerly, and every later launch a replay. Kinds that
    share a counter (the plain and the speculative mixed launch) share its
    launches: each captured once, their replays the rest."""
    graphs = stats["graphs"]
    print(f"{tag} CUDA graphs: {json.dumps(graphs)}")
    check(set(graphs) == set(kinds), f"{tag}: graphs {sorted(graphs)}, not {sorted(kinds)}")
    for counter in set(kinds.values()):
        names = [k for k, c in kinds.items() if c == counter]
        n = stats["launches"][counter]
        replays = sum(graphs[k]["replays"] for k in names)
        check(all(graphs[k]["captures"] == 1 for k in names)
              and replays == n - len(names) > 0,
              f"{tag}: {names} captured {[graphs[k]['captures'] for k in names]} times "
              f"and replayed {replays} times for {n} launches")


def greedy_repeat(tag, server, body, in_wave):
    """A greedy request twice on the idle fleet: the same tokens."""
    again = [post(server.port, body)[1] for _ in range(2)]
    print(f"{tag} a greedy request of the wave again on the idle fleet, twice: tokens "
          f"{again[0]['tokens_generated']}, {again[1]['tokens_generated']}; "
          f"identical={again[0]['token_ids'] == again[1]['token_ids']}; "
          f"same as in the wave={again[0]['token_ids'] == in_wave['token_ids']}")
    check(again[0]["token_ids"] == again[1]["token_ids"],
          "a greedy request repeated on the idle fleet gave other tokens")


def q4_launches(cfg, Q):
    """q4_matmul_rows launches of one int4 decode step (R = 8 rows) and of
    one mixed launch: every projection of a step (7 a layer on llama, 6 on
    gpt2) and an untied head; the two unembeds of a mixed launch under an
    untied head (its 128-row projections take the einsum, as in the JAX
    package)."""
    head = 0 if cfg.tie_embeddings else 1
    return len(Q._QUANT_KEYS[cfg.arch]) * cfg.n_layers + head, 2 * head


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
        per_step, per_mixed = q4_launches(cfg, Q)
        q4_want = ((per_step * FLEET["chunk_steps"] * chunks + per_mixed * mixed)
                   if quant else 0)
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


def scripted_fleet_logits(torch, cfg, params, P, M, pages=None):
    """Logits at every live token of three scripted mixed launches (two
    prompts landing, then their decode rows beside a third prompt's
    chunks) and of one decode step of the three rows, over a fresh pool
    with shuffled tables, and the row of each. pages: the three rows'
    adapter pages ([3] int32 on the card), or None."""
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
    out, rows = [], []
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
                                                  row),
                lora_pages=P._token_pages(pages, row))
            out.append(M.unembed(cfg, params, x)[:, 0][row >= 0])
            rows.append(row[row >= 0])
        pos = torch.tensor([102, 22, 114], dtype=torch.int32, device=DEVICE)
        toks = ids[torch.arange(R, device=DEVICE), pos.long()]
        x = M.embed(cfg, params, toks[:, None], pos)
        x, pool = M.forward_layers(cfg, params["layers"], x, pool, pos,
                                   attn_hook=P.make_paged_hook(table),
                                   attn_seq_len=SLOT_MB * BLOCK, lora_pages=pages)
        out.append(M.unembed(cfg, params, x)[:, 0])
        rows.append(torch.arange(R, device=DEVICE))
    return torch.cat(out), torch.cat(rows)


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


def check_kernel_vs_plain(torch, tag, k, p, atol):
    """The scripted fleet logits through the kernels (k) against the plain
    path's (p): within atol, and every greedy token the top-2 gap pins
    equal. Returns the max abs error."""
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
    return err


def phase_h(torch, engine, P, G, M, tag="(h)", atol=LOGITS_ATOL, logits=True):
    """Kernel path vs plain path over the pool (`logits`), and the sync
    check (on a quantized engine, phase (l): q4_matmul_rows runs on both
    paths)."""
    cfg_k = engine.cfg
    cfg_p = cfg_k.replace(attn_impl="plain")
    params = engine.backend.params
    err = None
    if logits:
        out = {cfg.attn_impl: scripted_fleet_logits(torch, cfg, params, P, M)[0]
               for cfg in (cfg_k, cfg_p)}
        err = check_kernel_vs_plain(torch, tag, out["kernel"], out["plain"], atol)

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
        by_name[e.name] = (t + e.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(t / 1e3, c, name) for name, (t, c) in top]


def profile_call(torch, fn):
    """Wall us, device busy us and the device kernels of one call, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_kernels(prof)
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


def q4_cases(torch, timer, Q, shapes=Q4_SHAPES):
    """q4_matmul_rows vs its twin at the projection shapes (in, out) of
    `shapes`, tinyllama's unless given, with
    torch.matmul against the dequantized weight (in x's dtype: the same
    product over 4x (bf16) or 8x (fp32) the weight bytes of the packed
    int4) as the yardstick; the kernel and the yardstick timed in turn,
    medians of Q4_REPS cold-L2 calls each."""
    print(f"(j) q4_matmul_rows vs plain twin (group 64); device ms per call, cold L2; "
          f"kernel and matmul(dequantized): medians of {Q4_REPS} calls in turn")
    rows = []
    g = torch.Generator(device=DEVICE).manual_seed(11)
    for (d_in, d_out) in shapes:
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


def graph_kind(torch, graphs, tag, name, lg, run, bufs, gen, tokens_of, want_deltas,
               eager=True, timed=True):
    """One launch kind's graph `lg` over `bufs`: captured on its first
    call if it was not yet; two replays, each bit-equal to the eager body
    on a clone of the buffers with the same generator state (the pool
    outside its trash block, where colliding padding writes land in any
    order), each moving the kernel counters by the capture's deltas; then
    (`timed`) replay vs eager: host wall (5 / 2 runs), one profiled run of
    each, the replay's CUDA-event span (eager=False: the replay's only).
    Every run starts from the same state."""
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
    if not timed:
        print(f"{tag} {name}: 2 replays bit-equal to eager (packed, state, KV), launches "
              f"per replay {json.dumps(nonzero)}{'; captured here' if captured_now else ''}")
        return dict(engine=tag, kind=name, launches_per_replay=nonzero)

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
    eager_ms = walls(lambda: run(bufs, gen), 2) if eager else None
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
    for label, fn in (("replay", lg), ("eager", lambda: run(bufs, gen)))[:2 if eager else 1]:
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
          + (f"eager={eager_ms:.3f} ms ({eager_ms / replay_ms:.1f}x), " if eager else "")
          + f"replay CUDA-event span {span_ms:.3f} ms, {tokens} tokens"
          f"{'; captured here' if captured_now else ''}")
    for label in ("replay", "eager")[:2 if eager else 1]:
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


def phase_q(torch, engine, P, G, M, tag=None, idle=True, dense=True, timed=True):
    """The fleet's launch kinds as CUDA graphs at its serving shape, on
    (h)'s operands: the mixed launch arming a 56-token prompt beside 7
    decode rows (greedy and sampled), the same graph with the idle arm
    (`idle`), the paged decode chunk of the 8 rows, and the dense decode
    chunk over an [8, 1024] cache of random K/V (`dense`); every replay
    bit-equal to its eager launch (graph_kind); `timed`: graph_kind's
    timings and profiles too."""
    from distributed_llm_inference_tpu_torch.engine import graphs
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    cfg, be = engine.cfg, engine.backend
    L, K, B = cfg.n_layers, FLEET["chunk_steps"], FLEET["n_slots"]
    quant = cfg.quant == "int4"
    sfx = "[int8]" if cfg.kv_quant == "int8" else ""
    tag = tag or "(q)" + (" int4+int8" if quant else "")
    per_step, per_mixed = q4_launches(cfg, Q) if quant else (0, 0)
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
    q4_mixed = {"q4_matmul_rows": per_mixed} if per_mixed else {}
    pre = clone_tree(torch, (bufs["state"], bufs["sparams"]))
    arming = clone_tree(torch, inputs.arm)
    lg_m = graphs.LaunchGraph(lambda: mixed(bufs, gen), "mixed launch", DEVICE, gen)
    rows.append(graph_kind(torch, graphs, tag, "mixed launch, arming", lg_m, mixed, bufs, gen,
                           lambda p: n_mixed_tok,
                           {"ragged_paged_attend" + sfx: L, **q4_mixed}, timed=timed))
    check(lg_m.captures == 1, f"{tag}: the mixed launch was not captured")
    if idle:
        # the same graph with no admission completing: the 7 decode rows
        # beside a prompt chunk that is still landing
        graphs.commit((bufs["state"], bufs["sparams"]), pre)
        graphs.commit(inputs.arm, P.idle_mixed_arm(B, cfg.vocab_size, device=DEVICE))
        rows.append(graph_kind(torch, graphs, tag, "mixed launch, idle arm", lg_m, mixed,
                               bufs, gen, lambda p: n_mixed_tok,
                               {"ragged_paged_attend" + sfx: L, **q4_mixed},
                               timed=timed))
        check(lg_m.captures == 1, f"{tag}: one graph must serve both arms")
    # the decode chunk of the 8 rows an arming launch leaves
    graphs.commit((bufs["state"], bufs["sparams"]), pre)
    graphs.commit(inputs.arm, arming)
    mixed(bufs, gen)
    armed = clone_tree(torch, (bufs["state"], bufs["sparams"]))
    q4_chunk = {"q4_matmul_rows": per_step * K} if quant else {}
    lg_c = graphs.LaunchGraph(lambda: chunk(bufs, gen), "decode chunk", DEVICE, gen)
    rows.append(graph_kind(torch, graphs, tag, f"paged decode chunk of {K} steps", lg_c,
                           chunk, bufs, gen, lambda p: int(p[K:2 * K].sum()),
                           {"paged_flash_attend" + sfx: L * K, **q4_chunk}, timed=timed))
    if not dense:
        for lg in (lg_m, lg_c):
            lg.close()
        return rows
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
                           chunk, dbufs, gen, lambda p: int(p[K:2 * K].sum()), q4_chunk,
                           timed=timed))
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
        self.tokens: dict = {}  # prompt -> those tokens themselves
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
            self.tokens[req.prompt] = list(req.salvaged)
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
        self.tokens.clear()
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


def phase_s(torch, engine, pa, fa, Q, smi, tag="(s)", kinds=None):
    """KV preemption through the HTTP server: B preempts A on a tight pool;
    both answer in full, A resumed, every block back, graphs captured once
    and replayed after the resume, the kernels' launch counts those of the
    launches the phase ran, and A's tokens fetched before its preemption
    those of its unpressured run on the same fleet. (x4) runs it on a
    speculating engine (`kinds`: its launch kinds, as check_graphs takes
    them)."""
    import threading

    kinds = kinds or {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"}
    fleet, server = fleet_server(engine, PREEMPT_FLEET)
    spy = FleetSpy(fleet)
    try:
        check(fleet.warmup()["ok"], f"{tag} fleet warmup")
        check(fleet.stats()["preemption"]["policy"] == "swap",
              f"{tag} the default preempt_policy is not the JAX package's 'swap'")
        body_a = {"prompt": fleet_prompt(20, PREEMPT_A[0]), "max_tokens": PREEMPT_A[1],
                  "greedy": True, "chat": False}
        body_b = {"prompt": fleet_prompt(21, PREEMPT_B[0]), "max_tokens": PREEMPT_B[1],
                  "greedy": True, "chat": False}
        alone = {}
        for name, body in (("A", body_a), ("B", body_b)):
            code, r, wall = post(server.port, body)
            check(code == 200 and r["tokens_generated"] == body["max_tokens"],
                  f"{tag} {name} alone: {code} {r}")
            alone[name] = r["token_ids"]
            print(f"{tag} {name} alone on the fleet: prompt_tokens={r['prompt_tokens']} "
                  f"tokens={r['tokens_generated']} wall_s={wall:.3f}")
        before = wait_idle(server.port)["continuous"]
        check(before["preemption"]["preempted_total"] == 0, f"{tag} preempted while alone")
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
            check(time.perf_counter() - t0 < 120, f"{tag} A never started decoding")
            time.sleep(0.001)
        tb = threading.Thread(target=run, args=("B", body_b))
        tb.start()
        ta.join()
        tb.join()
        wall = time.perf_counter() - t0
        after = wait_idle(server.port)["continuous"]
        launches = read_counts(pa, fa, Q)
        counts = check_kernel_counts(tag, engine, launches, before, after,
                                     round(ragged_launches(engine) - rag0))
        (ca, ra, wa), (cb, rb, wb) = out["A"], out["B"]
        for name, code, r in (("A", ca, ra), ("B", cb, rb)):
            print(f"{tag} {name}: HTTP {code} prompt_tokens={r.get('prompt_tokens')} "
                  f"tokens={r.get('tokens_generated')} preempted={r.get('preempted')} "
                  f"recovered={r.get('recovered')} ttft_s={r.get('ttft_s')} "
                  f"prefill_chunks={r.get('prefill_chunks')}")
            check(code == 200 and r.get("status") == "success", f"{tag} {name}: {r}")
        check(ra.get("preempted", 0) >= 1 and ra.get("recovered") is True,
              f"{tag} A was not preempted and resumed: {ra}")
        pre = after["preemption"]
        print(f"{tag} /stats preemption {json.dumps(pre)}; supervisor "
              f"{json.dumps(after['supervisor'])}")
        check(pre["preempted_total"] >= 1 and pre["parked"] == 0,
              f"{tag} /stats preemption {pre}")
        check(after["paged"]["free_blocks"] == PREEMPT_FLEET["kv_pool_blocks"] - 1,
              f"{tag} {after['paged']['free_blocks']} pool blocks free after the pair")
        check_graphs(tag, after, kinds)
        for counter in set(kinds.values()):
            names = [k for k, c in kinds.items() if c == counter]
            check(sum(after["graphs"][k]["replays"] for k in names)
                  > sum(before["graphs"].get(k, {"replays": 0})["replays"] for k in names),
                  f"{tag} {names} were not replayed after the resume")
        pa_ = spy.salvaged.get(body_a["prompt"])
        check(pa_ is not None and pa_ >= 1,
              f"{tag} A had no token fetched before its preemption ({pa_})")
        at_a = check_identity(f"{tag} A", ra["token_ids"], alone["A"], pa_)
        at_b = parts_at(rb["token_ids"], alone["B"])
        print(f"{tag} B vs B alone: " + ("identical" if at_b is None
                                        else f"part at token {at_b}"))
        resume_ms = (spy.resumed_at[body_a["prompt"]] - spy.evicted_at[body_a["prompt"]]) * 1e3
        n_tok = ra["tokens_generated"] + rb["tokens_generated"]
        hist = engine.metrics.get("dli_preempted_resume_seconds").labels()
        print(f"{tag} pair wall {wall:.3f} s, {n_tok} tokens = {n_tok / wall:.2f} tokens/s; "
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


# -- the block-prefix cache and the KV shadow: phase (v) -------------------------

V_HEAD = 512  # the shared head's tokens (32 blocks of BLOCK)
V_TAILS = (16, 40, 64, 96, 120, 150, 180, 200)  # the wave's tails behind it
V_PINNED = (5, 100)  # (requests, tail tokens) of the TTFT medians
V_WAVES = 3  # waves per fleet, fresh tails each
V_NEW = 32
V_CRASH_TAILS = (20, 60, 100, 140)
V_SHADOW_BLOCKS = 64  # (v5)'s small host tier: one 34-block chain evicts another
V_DIR = "build/chip_smoke_v"  # restore_dir and the disk tier (gitignored)


def v_head(i: int) -> str:
    """The text of a V_HEAD-token head (BOS + one token per character)."""
    return fleet_prompt(30 + i, V_HEAD)


def v_tail(tag: str, n: int) -> str:
    """n characters (tokens) that differ from every other tag's at once, so
    a hit maps exactly the head's blocks."""
    return (f"[{tag}] " + "a tail behind the shared head of the request; " * 9)[:n]


def v_body(prompt: str, greedy: bool = True) -> dict:
    body = {"prompt": prompt, "max_tokens": V_NEW, "chat": False}
    body.update({"greedy": True} if greedy else SAMPLED_KNOBS)
    return body


def v_engine(engine, **ecfg):
    """The same model, weights and kernels with other engine settings."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    return create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                         engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **ecfg))


def v_counter(engine, name: str) -> float:
    fam = engine.metrics.get(name)
    return 0.0 if fam is None else sum(c.value for _, c in fam._items())


def v_head_digest(torch, P, fleet, ids):
    """The cached head of `ids` (depth, its block ids) and a digest of the
    bytes of those blocks in the fleet's pool (bf16 through its int16
    view)."""
    import hashlib

    p0, blocks, _ = fleet._bpx.lookup(ids)
    h = hashlib.sha256()
    idx = torch.tensor(blocks or [], dtype=torch.long, device=DEVICE)
    for leaf in P.pool_leaves(fleet.cache):
        x = leaf[:, idx]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        h.update(x.cpu().numpy().tobytes())
    return p0, blocks, h.hexdigest()


def v_quiesce(fleet, timeout_s=10.0):
    """Wait until the fleet's worker parks with no launch in flight: the
    decode chunks launched ahead for a request that has since finished
    (chunk_lag) would delay the next request's first launch."""
    t0 = time.time()
    while not fleet._cv._waiters:
        check(time.time() - t0 < timeout_s, "the fleet's worker never parked")
        time.sleep(0.001)


def v_idle_parts(tag, got: dict, want: dict) -> dict:
    """Print, for each request both runs served, whether its tokens are
    identical or the first token where they part."""
    parts = {}
    for k in got:
        parts[k] = parts_at(got[k], want[k])
        print(f"{tag} {k}: " + ("identical" if parts[k] is None
                                else f"part at token {parts[k]}"))
    return parts


def v_teacher_logits(torch, P, G, engine, pool, row_blocks, ids, p0):
    """The next-token logits after `ids`, teacher-forced through the ragged
    prefill launches over `pool` with the table row `row_blocks`, from
    position p0 (the blocks below p0 hold the head's K/V already)."""
    import numpy as np

    W, tile = 64, RAGGED_TILE
    be = engine.backend
    table = torch.zeros((1, SLOT_MB), dtype=torch.int32, device=DEVICE)
    table[0, :len(row_blocks)] = torch.tensor(row_blocks, dtype=torch.int32)

    def args(chunk, start):
        meta, tok_row, tok_pos, _, _ = P.build_ragged_meta(
            [(0, start, len(chunk), P.RAGGED_PREFILL)], width=W, tile=tile)
        toks = np.zeros(W, np.int32)
        toks[:len(chunk)] = chunk
        return [torch.from_numpy(a).to(DEVICE) for a in (toks, tok_row, tok_pos, meta)]

    tail = ids[p0:]
    n_full = max(0, (len(tail) - 1) // W)
    for c in range(n_full):
        be.extend_ragged_paged(*args(tail[c * W:(c + 1) * W], p0 + c * W), pool, table)
    rem = tail[n_full * W:]
    _, logits, _ = be.prefill_ragged_paged(
        *args(rem, p0 + n_full * W), pool, table, len(rem) - 1,
        torch.Generator(device=DEVICE), G.default_sampling(1.0, 0, 1.0, True, 0.0, 1.0,
                                                           0.0, 0.0))
    return logits.float()


def v_delta_logits(torch, P, G, engine, fleet, prompt, tokens, at):
    """max |Δlogits| at the token where a hit's greedy stream parts from the
    cold run's: the prompt and the `at` common tokens teacher-forced once
    over the fleet's cached head (the hit) and once whole (cold), on a copy
    of the idle fleet's pool."""
    ids = engine.tokenizer.encode(prompt) + list(tokens[:at])
    p0, head, _ = fleet._bpx.lookup(ids)
    pool = P.pool_from_leaves(fleet.cache, [t.clone() for t in P.pool_leaves(fleet.cache)])
    taken = set(head or [])
    fresh = [b for b in range(1, fleet._pool_blocks) if b not in taken][:SLOT_MB]
    n = -(-len(ids) // BLOCK)
    head = list(head or [])
    hit = v_teacher_logits(torch, P, G, engine, pool, head + fresh[:n - len(head)], ids, p0)
    cold = v_teacher_logits(torch, P, G, engine, pool, fresh[:n], ids, 0)
    torch.cuda.synchronize()
    return (hit - cold).abs().max().item(), p0


def v_timed(fleet, name: str) -> list:
    """Wrap the fleet's method `name` to add each call's host seconds to
    the returned [seconds, calls] (the worker thread's own time in it)."""
    inner = getattr(fleet, name)
    spent = [0.0, 0]

    def call(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

    setattr(fleet, name, call)
    return spent


def phase_v1(torch, engine, pa, fa, Q, P, G, smi):
    """Hits on the main path: one request registers a 512-token head, then
    V_WAVES waves of 8 share it (fresh tails each wave, greedy and sampled),
    on the fleet with no prefix cache, with the prefix cache and no shadow,
    and with both (the last one kept for the comparisons); pinned greedy
    requests' TTFT and tokens on each."""
    import threading

    L = engine.cfg.n_layers
    peng = v_engine(engine, prefix_cache_entries=8)
    head = v_head(0)
    reg = v_body(head + v_tail("register", 32))
    waves = [[v_body(head + v_tail(f"tail {w}.{i}", n), greedy=i % 2 == 0)
              for i, n in enumerate(V_TAILS)] for w in range(V_WAVES)]
    pinned = [v_body(head + v_tail(f"pinned {k}", V_PINNED[1])) for k in range(V_PINNED[0])]
    head_ids = peng.tokenizer.encode(head + v_tail("probe", 40))
    runs = {}
    for name, eng, kw in (("no prefix cache", engine, {}),
                          ("prefix cache, shadow off", peng, {"kv_shadow": False}),
                          ("prefix cache, shadow on", peng, {})):
        fleet, server = fleet_server(eng, FLEET, **kw)
        prefix = fleet._bpx is not None
        capture = v_timed(fleet, "_shadow_capture") if fleet._shadow is not None else None
        try:
            check(fleet.warmup()["ok"], f"(v1) {name}: warmup")
            code, r, _ = post(server.port, reg)
            check(code == 200, f"(v1) {name}: the registering request {r}")
            wait_idle(server.port)
            if prefix:
                p0, blocks, digest0 = v_head_digest(torch, P, fleet, head_ids)
                check(p0 == V_HEAD, f"(v1) {name}: the head is cached at {p0}, not {V_HEAD}")
            shared = eng.metrics.get("dli_kv_pool_shared_blocks").labels()
            tps, results = [], None
            for w, bodies in enumerate(waves):
                v_quiesce(fleet)
                if capture is not None:
                    capture[:] = [0.0, 0]
                peak, stop = [0.0], threading.Event()

                def poll():
                    while not stop.is_set():
                        peak[0] = max(peak[0], shared.value)
                        time.sleep(0.002)

                poller = threading.Thread(target=poll, daemon=True)
                poller.start()
                try:
                    results, wave_s, launches, before, after = serve_wave(server, bodies,
                                                                          pa, fa, Q)
                finally:
                    stop.set()
                    poller.join()
                mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
                chunks = (after["launches"]["decode_chunks"]
                          - before["launches"]["decode_chunks"])
                n_tok = 0
                for i, (code, r, wall) in enumerate(results):
                    check(code == 200 and r.get("status") == "success",
                          f"(v1) {name} {w}.{i}: {r}")
                    n_tok += r["tokens_generated"]
                tps.append(n_tok / wave_s)
                print(f"(v1) {name}: wave {w} of {len(bodies)} over a {V_HEAD}-token "
                      f"head, {n_tok} tokens in {wave_s:.3f} s = {n_tok / wave_s:.2f} "
                      f"tokens/s aggregate; {mixed} mixed launches, {chunks} decode "
                      f"chunks; depths {[r.get('prefix_cached_tokens') for _, r, _ in results]}; "
                      f"TTFT {[r['ttft_s'] for _, r, _ in results]}; peak shared blocks "
                      f"{peak[0]:g}"
                      + ("" if capture is None else
                         f"; the scheduler thread's capture time {capture[0] * 1e3:.1f} ms "
                         f"in {capture[1]} calls")
                      + f"; kernel launches {json.dumps(launches)} ({smi})")
                check(launches["ragged_paged_attend"] == L * mixed > 0,
                      f"(v1) {name}: ragged_paged_attend {launches['ragged_paged_attend']} "
                      f"for {mixed} mixed launches")
                check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks > 0,
                      f"(v1) {name}: paged_flash_attend {launches['paged_flash_attend']} "
                      f"for {chunks} decode chunks")
                others = [k for k in launches
                          if k not in ("ragged_paged_attend", "paged_flash_attend")]
                check(not any(launches[k] for k in others), f"(v1) {name}: {launches}")
                if prefix:
                    pc0, pc = before["prefix_cache"], after["prefix_cache"]
                    hits = pc["hits"] - pc0["hits"]
                    saved = pc["dedup_saved_tokens"] - pc0["dedup_saved_tokens"]
                    check(hits >= len(bodies) and saved >= len(bodies) * V_HEAD,
                          f"(v1) {name}: hits +{hits}, saved tokens +{saved}")
                    check(peak[0] > 0, f"(v1) {name}: no pool block was shared mid-wave")
            check_graphs(f"(v1) {name}", after,
                         {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
            pg = after["paged"]
            if prefix:
                print(f"(v1) {name}: prefix_cache {json.dumps(after['prefix_cache'])}; "
                      f"shadow {json.dumps(after.get('shadow'))}")
                check(v_head_digest(torch, P, fleet, head_ids) == (p0, blocks, digest0),
                      f"(v1) {name}: the shared head's blocks changed across the waves")
                check(fleet._alloc.outstanding == pg["cached_blocks"],
                      f"(v1) {name}: {fleet._alloc.outstanding} blocks held at idle, "
                      f"{pg['cached_blocks']} cached")
                check(("shadow" in after) == ("kv_shadow" not in kw),
                      f"(v1) {name}: /stats shadow {after.get('shadow')}")
            check(pg["free_blocks"] + pg["cached_blocks"] == FLEET["kv_pool_blocks"] - 1,
                  f"(v1) {name}: pool blocks leaked {pg}")
            # back to back: each waits behind the decode chunks launched
            # ahead (chunk_lag) for the one before it
            b2b = []
            for k in range(V_PINNED[0]):
                code, r, _ = post(server.port, v_body(head + v_tail(f"b2b {k}", V_PINNED[1])))
                check(code == 200, f"(v1) {name}: pinned {k} back to back {r}")
                b2b.append(r["ttft_s"])
            ttft, toks = [], {}
            for k, body in enumerate(pinned):
                v_quiesce(fleet)  # each from an idle fleet, nothing in flight
                code, r, _ = post(server.port, body)
                check(code == 200, f"(v1) {name}: pinned {k} {r}")
                ttft.append(r["ttft_s"])
                toks[f"pinned {k}"] = r["token_ids"]
                if prefix:
                    check(r.get("prefix_cached_tokens") == V_HEAD,
                          f"(v1) {name}: pinned {k} hit at {r.get('prefix_cached_tokens')}")
            for i in range(0, len(results), 2):
                toks[f"wave {i}"] = results[i][1]["token_ids"]
            runs[name] = dict(wave_tps=statistics.median(tps), waves_tps=tps,
                              ttft=statistics.median(ttft), ttfts=ttft, tokens=toks,
                              ttft_b2b=statistics.median(b2b), launches=launches)
            print(f"(v1) {name}: pinned TTFT, each from an idle fleet, median of {len(ttft)} "
                  f"{runs[name]['ttft'] * 1e3:.1f} ms ({[round(t * 1e3, 1) for t in ttft]}); "
                  f"back to back {runs[name]['ttft_b2b'] * 1e3:.1f} ms "
                  f"({[round(t * 1e3, 1) for t in b2b]})")
            if name != "prefix cache, shadow on":
                continue
            # the hit fleet, idle: the comparisons and the movers' times
            hit, cold = runs[name], runs["no prefix cache"]
            print(f"(v1) TTFT of a {V_HEAD}+{V_PINNED[1]}-token greedy request, median "
                  f"of {V_PINNED[0]}: hit {hit['ttft'] * 1e3:.1f} ms, cold "
                  f"{cold['ttft'] * 1e3:.1f} ms ({cold['ttft'] / hit['ttft']:.2f}x); waves' "
                  f"tokens/s, median of {V_WAVES} (each): shadow on {hit['wave_tps']:.2f} "
                  f"({', '.join(f'{x:.2f}' for x in hit['waves_tps'])}), shadow off "
                  f"{runs['prefix cache, shadow off']['wave_tps']:.2f} ("
                  + ", ".join(f"{x:.2f}" for x in runs["prefix cache, shadow off"]["waves_tps"])
                  + f"), no prefix cache {cold['wave_tps']:.2f} ("
                  + ", ".join(f"{x:.2f}" for x in cold["waves_tps"]) + f") ({smi})")
            parts = v_idle_parts("(v1) greedy tokens, hit vs cold:", hit["tokens"],
                                 cold["tokens"])
            v_idle_parts("(v1) greedy tokens, shadow on vs off:", hit["tokens"],
                         runs["prefix cache, shadow off"]["tokens"])
            hit["parts"] = parts
            first = next((k for k, at in parts.items() if at is not None), None)
            if first is not None:
                kind, i = first.split()
                body = (pinned if kind == "pinned" else waves[-1])[int(i)]
                d, p0 = v_delta_logits(torch, P, G, engine, fleet, body["prompt"],
                                       cold["tokens"][first], parts[first])
                hit["delta_logits"] = d
                print(f"(v1) {first} parts at token {parts[first]}: teacher-forced max "
                      f"|Δlogits| there, head from the cache (depth {p0}) vs the whole "
                      f"sequence prefilled: {d:.4g}")
            hit.update(v_capture_and_restore_ms(torch, P, fleet, head_ids, smi))
        finally:
            server.shutdown()
    return runs


def v_capture_and_restore_ms(torch, P, fleet, head_ids, smi):
    """The capture's device ms and bytes per call (an 8-block gather and
    its copy to pinned memory) and the restore's per 32-block scatter, on
    the idle fleet's pool (read only; the restore goes into a pool of its
    own), CUDA events, medians of 5."""
    import numpy as np

    ids = fleet._bpx.lookup(head_ids)[1]
    ids8 = torch.tensor(ids[:8], dtype=torch.int32, device=DEVICE)
    gather, copy = [], []
    for _ in range(6):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        dev = P.gather_shadow_blocks(fleet.cache, ids8)
        e1.record()
        hosts = []
        for leaf in P.pool_leaves(dev):
            hosts.append(torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True))
            hosts[-1].copy_(leaf, non_blocking=True)
        e2.record()
        e2.synchronize()
        gather.append(e0.elapsed_time(e1))
        copy.append(e1.elapsed_time(e2))
    nbytes = sum(h.numel() * h.element_size() for h in hosts)
    check(fleet._shadow.flush(10.0), "(v) flush")
    found = fleet._shadow.entries_for([tuple(head_ids[: (i + 1) * BLOCK])
                                       for i in range(V_HEAD // BLOCK)])
    check(found is not None, "(v) the head's 32 blocks are not in the shadow")
    entries = [(None, e) for e in found]
    pool = P.init_pool(fleet.cfg, 40, BLOCK, device=DEVICE)
    dst = torch.arange(1, 33, dtype=torch.int32, device=DEVICE)
    restore = []
    for _ in range(6):
        t0 = time.perf_counter()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        stacked = []
        for j, like in enumerate(P.pool_leaves(pool)):
            t = torch.from_numpy(np.stack([e.leaves[j] for _, e in entries]))
            if like.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            stacked.append(t.pin_memory().to(DEVICE, non_blocking=True))
        P.restore_shadow_blocks(pool, P.pool_from_leaves(pool, stacked), dst)
        e1.record()
        e1.synchronize()
        restore.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
    for (key, e), b in zip(entries[:2], (1, 2)):
        for j, leaf in enumerate(P.pool_leaves(pool)):
            x = leaf[:, b].cpu()
            if x.dtype == torch.bfloat16:
                x = x.view(torch.int16)
            check(np.array_equal(x.numpy(), e.leaves[j]), "(v) a restored block differs")
    med = statistics.median
    print(f"(v) capture: {nbytes} bytes per 8-block call ({nbytes // 8} a block); gather "
          f"{med(gather[1:]):.4f} ms, its copy to pinned memory {med(copy[1:]):.4f} ms "
          f"(CUDA events, median of 5); restore per 32-block scatter (stack, upload, "
          f"index_copy_): {med([r[0] for r in restore[1:]]):.4f} ms between events, "
          f"{med([r[1] for r in restore[1:]]):.3f} ms host wall ({smi})")
    return dict(capture_bytes=nbytes, gather_ms=med(gather[1:]), copy_ms=med(copy[1:]),
                restore_ms=med([r[0] for r in restore[1:]]))


def phase_v2(torch, engine, fa, pa, Q, smi):
    """A hit of the bucketed whole-prefill admission: the tail's T>1 chunks
    run flash_attend over the scratch gathered from the pool; greedy tokens
    against the same request on a cold bucketed fleet."""
    L = engine.cfg.n_layers
    flags = dict(ragged_prefill=False, chunked_prefill=False)
    head = v_head(1)
    reg = v_body(head + v_tail("register", 32))
    body = v_body(head + v_tail("bucketed hit", 100))
    out = {}
    for name, prefix in (("hit", 8), ("cold", 0)):
        eng = v_engine(engine, prefix_cache_entries=prefix, **flags)
        fleet, server = fleet_server(eng, FLEET)
        try:
            check(fleet.warmup()["ok"], f"(v2) {name} warmup")
            check(post(server.port, reg)[0] == 200, f"(v2) {name}: register")
            before = wait_idle(server.port)["continuous"]
            v_quiesce(fleet)  # the registering request's chunks have landed
            reset_counts(pa, fa, Q)
            code, r, wall = post(server.port, body)
            after = wait_idle(server.port)["continuous"]
            launches = read_counts(pa, fa, Q)
            chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
            print(f"(v2) bucketed {name}: HTTP {code} prefix_cached_tokens="
                  f"{r.get('prefix_cached_tokens')} prefill_chunks={r.get('prefill_chunks')} "
                  f"ttft_s={r.get('ttft_s')} wall_s={wall:.3f}; kernel launches "
                  f"{json.dumps(launches)}")
            check(code == 200, f"(v2) {name}: {r}")
            check(launches["flash_attend"] == L * r["prefill_chunks"] > 0,
                  f"(v2) {name}: flash_attend {launches['flash_attend']} for "
                  f"{r['prefill_chunks']} T>1 chunks")
            check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks,
                  f"(v2) {name}: paged_flash_attend {launches['paged_flash_attend']}")
            if prefix:
                check(r.get("prefix_cached_tokens") == V_HEAD,
                      f"(v2) the bucketed hit at {r.get('prefix_cached_tokens')}")
            out[name] = dict(tokens=r["token_ids"], launches=launches,
                             ttft=r["ttft_s"], chunks=r["prefill_chunks"])
        finally:
            server.shutdown()
    at = parts_at(out["hit"]["tokens"], out["cold"]["tokens"])
    print(f"(v2) bucketed hit vs cold greedy tokens: "
          + ("identical" if at is None else f"part at token {at}")
          + f"; prefill chunks {out['hit']['chunks']} vs {out['cold']['chunks']}, TTFT "
          f"{out['hit']['ttft']} vs {out['cold']['ttft']} s ({smi})")
    return dict(parts_at=at, **{k: v["launches"] for k, v in out.items()})


def phase_v3(torch, engine, smi):
    """Warm against cold crash recovery mid-wave: a decode_launch fault on a
    wave of 4 whose prompts the fleet served once before, shadow on and off
    on the raw pool, then shadow on over an int8 pool."""
    from distributed_llm_inference_tpu_torch.utils import faults

    head = v_head(2)
    bodies = [v_body(head + v_tail(f"crash {i}", n), greedy=i % 2 == 0)
              for i, n in enumerate(V_CRASH_TAILS)]
    rows = {}
    peng = v_engine(engine, prefix_cache_entries=8)
    for name, eng, kw in (("warm raw", peng, {}),
                          ("cold raw", peng, {"kv_shadow": False}),
                          ("warm int8", None, {})):
        if eng is None:
            from distributed_llm_inference_tpu_torch.config import EngineConfig
            from distributed_llm_inference_tpu_torch.runtime import create_engine

            eng = create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                                kv_quant="int8", engine_cfg=EngineConfig(
                                    prefill_buckets=PREFILL_BUCKETS, prefix_cache_entries=8))
        fleet, server = fleet_server(eng, FLEET, **kw)
        spy = FleetSpy(fleet)
        try:
            check(fleet.warmup()["ok"], f"(v3) {name} warmup")
            for _ in range(2):  # the first serve fills the index and the shadow
                ref = [post(server.port, b) for b in bodies]
                check(all(c == 200 for c, _, _ in ref), f"(v3) {name}: {ref}")
            if fleet._shadow is not None:
                check(fleet._shadow.flush(10.0), f"(v3) {name}: flush")
            st0 = wait_idle(server.port)["continuous"]
            rec0 = v_counter(eng, "dli_recovery_tokens_recomputed_total")
            res0 = v_counter(eng, "dli_shadow_restored_blocks_total")
            spy.reset()
            v_quiesce(fleet)
            faults.arm([faults.FaultRule("decode_launch", "transient", on_call=5)])
            import threading

            got = [None] * len(bodies)
            try:
                threads = [threading.Thread(target=lambda i=i: got.__setitem__(
                    i, post(server.port, bodies[i]))) for i in range(len(bodies))]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wave_s = time.perf_counter() - t0
            finally:
                faults.disarm()
            st = wait_idle(server.port)["continuous"]
            restarts = st["supervisor"]["restarts"] - st0["supervisor"]["restarts"]
            recomputed = v_counter(eng, "dli_recovery_tokens_recomputed_total") - rec0
            restored = v_counter(eng, "dli_shadow_restored_blocks_total") - res0
            crash_ms = ((spy.crashes[0][1] - spy.crashes[0][0]) * 1e3
                        if spy.crashes and spy.crashes[0][1] else None)
            for i, (code, r, _) in enumerate(got):
                check(code == 200 and r.get("status") == "success", f"(v3) {name} {i}: {r}")
                pre = spy.tokens.get(bodies[i]["prompt"], [])
                check(r["token_ids"][:len(pre)] == pre,
                      f"(v3) {name} {i}: the {len(pre)} tokens fetched before the crash "
                      f"changed in the envelope")
            parts = [parts_at(got[i][1]["token_ids"], ref[i][1]["token_ids"])
                     for i in range(0, len(bodies), 2)]
            print(f"(v3) {name}: {len(bodies)} requests answered in {wave_s:.3f} s after "
                  f"{restarts} restart; restored blocks {restored:g}, recomputed tokens "
                  f"{recomputed:g}; crash to the next launch "
                  + ("n/a" if crash_ms is None else f"{crash_ms:.1f} ms")
                  + f"; tokens fetched before the crash "
                  f"{[len(spy.tokens.get(b['prompt'], [])) for b in bodies]}, equal; greedy "
                  f"vs the unfaulted serve: {parts}; graphs {json.dumps(st['graphs'])} ({smi})")
            check(restarts == 1, f"(v3) {name}: {restarts} restarts")
            check(all(g["captures"] == 1 for g in st["graphs"].values()),
                  f"(v3) {name}: graphs recaptured {st['graphs']}")
            pg = st["paged"]
            check(pg["free_blocks"] + pg["cached_blocks"] == FLEET["kv_pool_blocks"] - 1,
                  f"(v3) {name}: pool blocks leaked {pg}")
            check((restored > 0) == name.startswith("warm"),
                  f"(v3) {name}: {restored} blocks restored")
            rows[name] = dict(restored=restored, recomputed=recomputed, crash_ms=crash_ms,
                              wave_s=wave_s, parts=parts)
        finally:
            faults.disarm()
            server.shutdown()
    check(rows["warm raw"]["recomputed"] < rows["cold raw"]["recomputed"],
          f"(v3) warm recomputed {rows['warm raw']['recomputed']} tokens, cold "
          f"{rows['cold raw']['recomputed']}")
    return rows


def phase_v4(torch, engine, pa, fa, Q, smi):
    """(s)'s contended pair with the prefix cache and the shadow: B preempts
    A, A's "swap" resume restores its shadowed blocks. A's stream against
    its run alone (a hit too: its head registered by an earlier run)."""
    import threading

    eng = v_engine(engine, prefix_cache_entries=8)
    fleet, server = fleet_server(eng, PREEMPT_FLEET)
    spy = FleetSpy(fleet)
    try:
        check(fleet.warmup()["ok"], "(v4) fleet warmup")
        body_a = {"prompt": fleet_prompt(20, PREEMPT_A[0]), "max_tokens": PREEMPT_A[1],
                  "greedy": True, "chat": False}
        body_b = {"prompt": fleet_prompt(21, PREEMPT_B[0]), "max_tokens": PREEMPT_B[1],
                  "greedy": True, "chat": False}
        alone = {}
        for name, body in (("A", body_a), ("B", body_b)):
            for _ in range(2):  # the second run alone is a hit, as A's in the pair
                code, r, wall = post(server.port, body)
                check(code == 200, f"(v4) {name} alone: {r}")
            alone[name] = r["token_ids"]
            print(f"(v4) {name} alone, a hit at {r.get('prefix_cached_tokens')}: "
                  f"tokens={r['tokens_generated']} wall_s={wall:.3f}")
        wait_idle(server.port)
        restored0 = v_counter(eng, "dli_shadow_restored_blocks_total")
        flights0 = len(eng.flight.dump()["events"])
        spy.reset()
        out = {}

        def run(name, body):
            out[name] = post(server.port, body)

        t0 = time.perf_counter()
        ta = threading.Thread(target=run, args=("A", body_a))
        ta.start()
        while not any(r is not None and r.first_id is not None and r.tokens
                      for r in fleet._assignment):
            check(time.perf_counter() - t0 < 120, "(v4) A never started decoding")
            time.sleep(0.001)
        tb = threading.Thread(target=run, args=("B", body_b))
        tb.start()
        ta.join()
        tb.join()
        wall = time.perf_counter() - t0
        after = wait_idle(server.port)["continuous"]
        restored = v_counter(eng, "dli_shadow_restored_blocks_total") - restored0
        events = eng.flight.dump()["events"][flights0:]
        swaps = [e.get("swap") for e in events if e["kind"] == "preempt"]
        (ca, ra, _), (cb, rb, _) = out["A"], out["B"]
        check(ca == 200 and cb == 200, f"(v4) the pair: {ra} {rb}")
        print(f"(v4) A: preempted={ra.get('preempted')} recovered={ra.get('recovered')} "
              f"prefix_cached_tokens={ra.get('prefix_cached_tokens')}; B: "
              f"preempted={rb.get('preempted')}; preempt events swap={swaps}; restored "
              f"blocks in the pair {restored:g}; pair wall {wall:.3f} s ({smi})")
        check(ra.get("preempted", 0) >= 1, f"(v4) A was not preempted: {ra}")
        check(restored > 0, "(v4) the swap resume restored no block")
        pg = after["paged"]
        check(pg["free_blocks"] + pg["cached_blocks"] == PREEMPT_FLEET["kv_pool_blocks"] - 1,
              f"(v4) pool blocks leaked {pg}")
        n_pre = spy.salvaged.get(body_a["prompt"])
        check(n_pre is not None and n_pre >= 1, f"(v4) A had no token before ({n_pre})")
        at_a = check_identity("(v4) A", ra["token_ids"], alone["A"], n_pre)
        at_b = parts_at(rb["token_ids"], alone["B"])
        print("(v4) B vs B alone: " + ("identical" if at_b is None else f"part at {at_b}"))
        return dict(restored=restored, parts_a=at_a, parts_b=at_b, salvaged_a=n_pre,
                    swaps=swaps, wall_s=wall)
    finally:
        server.shutdown()


def phase_v5(torch, engine, smi):
    """Persistence and tiers: a drain writes restore_dir and a second fleet
    started on it serves its first request as a hit with the pre-drain hit's
    tokens; a small host tier demotes a chain to the disk tier, and an
    admission promotes it back (a tier_promote event)."""
    import os
    import shutil

    shutil.rmtree(V_DIR, ignore_errors=True)
    head = v_head(3)
    body = v_body(head + v_tail("persisted", 32))
    eng = v_engine(engine, prefix_cache_entries=8)
    fleet, server = fleet_server(eng, FLEET, restore_dir=f"{V_DIR}/restore")
    try:
        check(fleet.warmup()["ok"], "(v5) warmup")
        for _ in range(2):  # the second is a hit: the successor's reference
            code, first, _ = post(server.port, body)
            check(code == 200, f"(v5) {first}")
        check(fleet._shadow.flush(10.0), "(v5) flush")
        t0 = time.perf_counter()
        check(fleet.drain(deadline_s=30.0), "(v5) drain")
        drain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
    saved = os.path.getsize(f"{V_DIR}/restore/shadow.npz")
    fleet, server = fleet_server(eng, FLEET, restore_dir=f"{V_DIR}/restore")
    try:
        t0 = time.perf_counter()
        while fleet.shadow_restored_total == 0 and time.perf_counter() - t0 < 30:
            time.sleep(0.005)
        restore_ms = (time.perf_counter() - t0) * 1e3
        code, r, _ = post(server.port, body)
        print(f"(v5) drain {drain_ms:.1f} ms wrote shadow.npz of {saved} bytes; the "
              f"successor restored {fleet.shadow_restored_total} blocks (seen {restore_ms:.1f} "
              f"ms after start) and served its first request at depth "
              f"{r.get('prefix_cached_tokens')}: tokens "
              + ("identical" if r.get("token_ids") == first["token_ids"]
                 else f"part at {parts_at(r.get('token_ids', []), first['token_ids'])}")
              + " to the pre-drain hit")
        check(code == 200 and fleet.shadow_restored_total > 0, f"(v5) successor: {r}")
        check(r.get("prefix_cached_tokens", 0) == first.get("prefix_cached_tokens") > 0,
              f"(v5) the successor's first request hit at {r.get('prefix_cached_tokens')}")
        check(r["token_ids"] == first["token_ids"],
              "(v5) the successor's tokens differ from the pre-drain hit's")
    finally:
        server.shutdown()
    # the disk tier: a 64-block host tier cannot hold two 34-block chains
    deng = v_engine(engine, prefix_cache_entries=8, kv_disk_dir=f"{V_DIR}/kvdisk",
                    kv_shadow_blocks=V_SHADOW_BLOCKS)
    fleet, server = fleet_server(deng, FLEET)
    try:
        check(fleet.warmup()["ok"], "(v5) disk warmup")
        one, two = v_body(v_head(4) + v_tail("one", 32)), v_body(v_head(5) + v_tail("two", 32))
        for _ in range(2):
            code, ref, _ = post(server.port, one)
        check(post(server.port, two)[0] == 200, "(v5) the second chain")
        check(fleet._shadow.flush(10.0), "(v5) flush")
        wait_idle(server.port)
        s = fleet._shadow.stats()
        check(s["demoted"] > 0 and s["disk_blocks"] > 0, f"(v5) nothing demoted: {s}")
        fleet._bpx.evict(10**9)  # the idle pool drops its chains: only the tiers hold them
        flights0 = len(deng.flight.dump()["events"])
        code, r, wall = post(server.port, one)
        events = [e for e in deng.flight.dump()["events"][flights0:]
                  if e["kind"] == "tier_promote"]
        s = fleet._shadow.stats()
        print(f"(v5) disk tier: demoted {s['demoted']}, {s['disk_blocks']} chunk files "
              f"({s['disk_bytes']} bytes); the re-admission promoted "
              f"{r.get('kv_promoted_blocks')} blocks (disk hits {s['disk_hits']}) and hit "
              f"at {r.get('prefix_cached_tokens')}, wall {wall:.3f} s, events {events}; "
              "tokens " + ("identical" if r.get("token_ids") == ref["token_ids"] else
                           f"part at {parts_at(r.get('token_ids', []), ref['token_ids'])}")
              + f" to the hit before the demotion ({smi})")
        check(code == 200 and r.get("kv_promoted_blocks", 0) > 0 and events,
              f"(v5) no promotion from the disk tier: {r}")
        check(s["disk_hits"] > 0, f"(v5) the promotion read no chunk file: {s}")
        check(r["token_ids"] == ref["token_ids"],
              "(v5) the promoted chain's tokens differ from the hit before the demotion")
    finally:
        server.shutdown()
        shutil.rmtree(V_DIR, ignore_errors=True)


def phase_v_sync(torch, engine, P, G):
    """One mixed launch plus the capture it triggers (the gather, the copy to
    pinned memory behind an event) under set_sync_debug_mode("error"); the
    copier thread lands the blocks' bytes."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.engine.shadow import ShadowStore

    ops, _ = fleet_operands(torch, engine.cfg, P, G)
    params = engine.backend.params
    store = ShadowStore(BLOCK, max_blocks=64)
    rows = ops["table"][FLEET["n_slots"] - 1, :4].tolist()  # the landing prompt's blocks
    keys = [tuple(range(BLOCK * (i + 1))) for i in range(3)]
    warm_ids = torch.from_numpy(np.asarray(rows * 2, np.int32)).pin_memory()
    store.put_async([(0,) * BLOCK], P.pool_leaves(P.gather_shadow_blocks(
        ops["pool"], warm_ids.to(DEVICE, non_blocking=True))), 0)
    check(store.flush(10.0), "(v) sync check: warm flush")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, state, sparams, pool = P.mixed_step_ragged(engine.cfg, params, **ops)
        ids = torch.from_numpy(np.asarray(rows[:3] + [rows[2]] * 5, np.int32))
        dev = P.gather_shadow_blocks(pool, ids.pin_memory().to(DEVICE, non_blocking=True))
        ok = store.put_async(keys, P.pool_leaves(dev), 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    try:
        check(ok and store.flush(10.0), "(v) sync check: the capture did not land")
        entries = store.entries_for(keys)
        torch.cuda.synchronize()
        for j, leaf in enumerate(P.pool_leaves(pool)):
            for e, b in zip(entries, rows[:3]):
                x = leaf[:, b].cpu()
                if x.dtype == torch.bfloat16:
                    x = x.view(torch.int16)
                check(np.array_equal(x.numpy(), e.leaves[j]), "(v) a captured block differs")
    finally:
        store.close()
    print("(v) one mixed launch and the capture it triggers (a 3-block gather, its "
          "copy to pinned memory behind an event) under set_sync_debug_mode('error'): "
          "no host sync; the copier landed the blocks' exact bytes")


def phase_v(torch, engine, pa, fa, Q, P, G, smi):
    """The block-prefix cache and the KV shadow on the paged fleet."""
    t0 = time.time()
    v1 = phase_v1(torch, engine, pa, fa, Q, P, G, smi)
    phase_v_sync(torch, engine, P, G)
    v2 = phase_v2(torch, engine, fa, pa, Q, smi)
    v3 = phase_v3(torch, engine, smi)
    v4 = phase_v4(torch, engine, pa, fa, Q, smi)
    phase_v5(torch, engine, smi)
    print(f"(v) took {time.time() - t0:.1f} s")
    print("(v) " + json.dumps({"prefix_and_shadow": {
        "v1": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in v1.items()},
        "v2": v2, "v3": v3, "v4": v4}}))


W_HEADS = 5  # (w1)'s distinct 512-token heads, one remote hit each
W_REGISTER_TAIL = 8  # the registering request's tail: under a block, so its
# deepest digest names the head's 32 blocks
W_TAIL = 100  # the hinted request's tail: 612 tokens in all
# (w2)'s wave: tails under one block, so every request's reusable depth is
# the head's and the seven after the first find the imported chain local (a
# prompt a block or more past the hinted chain fetches again, as in the JAX
# fleet: the peer might hold a deeper chain)
W_WAVE_TAILS = (8, 9, 10, 11, 12, 13, 14, 15)
W_DIR = "build/chip_smoke_w"  # the holders' logs (gitignored)
# the holder: the port's server CLI with (g)'s fleet and the prefix cache, the
# same model and seed as the in-process engine, so the same weights
W_HOLDER = ["--model", MODEL, "--dtype", "bfloat16", "--attn-impl", "auto", "--seed", "0",
            "--continuous", str(FLEET["n_slots"]), "--kv-pool-blocks",
            str(FLEET["kv_pool_blocks"]), "--kv-block-size", str(BLOCK),
            "--continuous-max-seq", str(FLEET["slot_max_seq"]), "--prefix-cache", "8",
            "--max-tokens-cap", "512"]


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Holder:
    """A second replica on the same card: the port's server CLI in a
    subprocess on a port of its own, its output in W_DIR. Fails (and is
    killed) if it does not answer /health; close() stops it."""

    def __init__(self, name: str, extra=(), base=W_HOLDER, log_dir=W_DIR):
        import os

        os.makedirs(log_dir, exist_ok=True)
        self.name = name
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log_path = f"{log_dir}/{name}.log"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
             *base, *extra, "--host", "127.0.0.1", "--port", str(self.port)],
            stdout=self._log, stderr=subprocess.STDOUT)
        t0 = time.time()
        try:
            while True:
                check(self.proc.poll() is None,
                      f"(w) the {name} exited with {self.proc.returncode}: {self.tail()}")
                try:
                    get(self.port, "/health")
                    break
                except OSError:
                    pass
                check(time.time() - t0 < 300, f"(w) the {name} did not start: {self.tail()}")
                time.sleep(0.25)
        except BaseException:
            self.close()
            raise
        self.start_s = time.time() - t0

    def tail(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()[-3000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=15)
        self._log.close()


def w_hint(holder, digest: str) -> dict:
    """A router's fetch hint: the peer holding the chain, and its digest."""
    return {"X-KV-Transfer-Peer": holder.url, "X-KV-Transfer-Digest": digest}


def w_register(engine, holder, head: str, tag: str) -> str:
    """Serve head + a sub-block tail on the holder as a handoff's phase 1
    (X-KV-Prefill-Only: answered once its shadow copies have landed) and
    return its deepest digest, which names the head's 32 blocks."""
    from distributed_llm_inference_tpu_torch.serving import kv_fabric as kvf

    code, r, _ = post(holder.port, v_body(head + v_tail(tag, W_REGISTER_TAIL)),
                      headers={"X-KV-Prefill-Only": "1"})
    check(code == 200 and r.get("prefill_only") is True, f"(w) {holder.name} {tag}: {r}")
    want = kvf.chain_digest(engine.tokenizer.encode(head), BLOCK)
    check(r.get("kv_digests", [None])[-1] == want,
          f"(w) {holder.name} {tag}: digests {r.get('kv_digests')}, the head's {want}")
    w_settle(holder)
    return want


def w_settle(holder):
    """Let a peer on the same card go quiet before a timed request: idle,
    then the decode chunks it launched ahead (chunk_lag, ~60 ms each) out
    of the way."""
    wait_idle(holder.port)
    time.sleep(0.3)


class PullSpy:
    """The puller's worker-thread host time, per request: in the fabric's
    prefetch (the fetch and the import), in the scatters into the pool, and
    in page-locking host memory inside those scatters (pin_memory)."""

    def __init__(self, torch, fleet):
        import threading

        self.prefetch = v_timed(fleet, "_fabric_prefetch")
        self.pin = [0.0, 0]
        inside = threading.local()
        inner = fleet._scatter_shadow
        self.scatter = [0.0, 0]

        def scatter(*a, **k):
            inside.on = True
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                inside.on = False
                self.scatter[0] += time.perf_counter() - t0
                self.scatter[1] += 1

        fleet._scatter_shadow = scatter
        pin = torch.Tensor.pin_memory

        def timed_pin(t, *a, **k):
            t0 = time.perf_counter()
            try:
                return pin(t, *a, **k)
            finally:
                if getattr(inside, "on", False):
                    self.pin[0] += time.perf_counter() - t0
                    self.pin[1] += 1

        self._restore = lambda: setattr(torch.Tensor, "pin_memory", pin)
        torch.Tensor.pin_memory = timed_pin

    def reset(self):
        for x in (self.prefetch, self.scatter, self.pin):
            x[:] = [0.0, 0]

    def ms(self) -> dict:
        return {"prefetch_ms": self.prefetch[0] * 1e3, "scatter_ms": self.scatter[0] * 1e3,
                "pin_ms": self.pin[0] * 1e3}

    def close(self):
        self._restore()


def w_fabric(port) -> dict:
    return get(port, "/stats")[1]["continuous"]["kv_fabric"]


def w_quiesce(*fleets):
    for f in fleets:
        v_quiesce(f)


def phase_w1(torch, engine, pa, fa, Q, holder, cold, pull, whole, smi):
    """The remote hit: W_HEADS heads registered on the holder; for each, the
    612-token request on the cold fleet, on the holder (its own hit), on the
    streamed and the whole-blob pullers with the hint, and a local hit on the
    streamed puller; tokens, imported blocks, launches, the pull's numbers."""
    L = engine.cfg.n_layers
    (cold_f, cold_s), (pull_f, pull_s), (whole_f, whole_s) = cold, pull, whole
    fleets = (cold_f, pull_f, whole_f)
    spies = {"streamed": PullSpy(torch, pull_f), "whole": PullSpy(torch, whole_f)}
    rows = {k: [] for k in ("cold", "local", "streamed", "whole")}
    try:
        for i in range(W_HEADS):
            head = v_head(10 + i)
            digest = w_register(engine, holder, head, f"register {i}")
            body = v_body(head + v_tail(f"remote {i}", W_TAIL))
            code, own, _ = post(holder.port, body)
            check(code == 200 and own.get("prefix_cached_tokens") == V_HEAD,
                  f"(w1) the holder's own hit {i}: {own}")
            w_settle(holder)
            w_quiesce(*fleets)
            code, c, _ = post(cold_s.port, body)
            check(code == 200, f"(w1) cold {i}: {c}")
            rows["cold"].append(dict(ttft=c["ttft_s"]))
            for name, (f, srv) in (("streamed", pull), ("whole", whole)):
                spy = spies[name]
                before = get(srv.port, "/stats")[1]["continuous"]
                w_quiesce(*fleets)
                spy.reset()
                reset_counts(pa, fa, Q)
                code, r, _ = post(srv.port, body, headers=w_hint(holder, digest))
                after = wait_idle(srv.port)["continuous"]
                w_quiesce(*fleets)
                launches = read_counts(pa, fa, Q)
                fab0, fab = before["kv_fabric"], after["kv_fabric"]
                nbytes = fab["bytes"] - fab0["bytes"]
                mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
                chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
                t = spy.ms()
                row = dict(ttft=r.get("ttft_s"), bytes=nbytes, mixed=mixed, chunks=chunks,
                           **t, wire_ms=t["prefetch_ms"] - t["scatter_ms"])
                row["mb_per_s"] = nbytes / 1e6 / (row["wire_ms"] / 1e3)
                rows[name].append(row)
                print(f"(w1) head {i} {name} remote hit: HTTP {code} kv_fabric_blocks="
                      f"{r.get('kv_fabric_blocks')} prefix_cached_tokens="
                      f"{r.get('prefix_cached_tokens')} ttft_s={r.get('ttft_s')}; prefetch "
                      f"{t['prefetch_ms']:.2f} ms (scatter {t['scatter_ms']:.2f}, of it pinning "
                      f"{t['pin_ms']:.2f}; wire, decode and recheck {row['wire_ms']:.2f}), "
                      f"{nbytes} bytes = {row['mb_per_s']:.1f} MB/s; {mixed} mixed launches, "
                      f"{chunks} decode chunks, kernel launches {json.dumps(launches)}; tokens "
                      + ("identical" if r.get("token_ids") == c["token_ids"] else
                         f"part at {parts_at(r.get('token_ids', []), c['token_ids'])}")
                      + " to cold, " + ("identical" if r.get("token_ids") == own["token_ids"]
                                        else "NOT identical")
                      + f" to the holder's own hit ({smi})")
                check(code == 200 and r.get("kv_fabric_blocks") == V_HEAD // BLOCK
                      and r.get("prefix_cached_tokens") == V_HEAD,
                      f"(w1) {name} {i}: not a remote hit of the head: {r}")
                check((fab["fetches"] - fab0["fetches"], fab["hits"] - fab0["hits"],
                       fab["misses"] - fab0["misses"]) == (1, 1, 0),
                      f"(w1) {name} {i}: fabric counts {fab0} -> {fab}")
                check(r["token_ids"] == c["token_ids"] == own["token_ids"],
                      f"(w1) {name} {i}: the remote hit's tokens are not the cold run's "
                      f"and the holder's own hit's")
                check(launches["ragged_paged_attend"] == L * mixed > 0,
                      f"(w1) {name} {i}: ragged_paged_attend {launches['ragged_paged_attend']} "
                      f"for {mixed} mixed launches")
                check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks > 0,
                      f"(w1) {name} {i}: paged_flash_attend {launches['paged_flash_attend']} "
                      f"for {chunks} decode chunks")
                check(not any(v for k, v in launches.items()
                              if k not in ("ragged_paged_attend", "paged_flash_attend")),
                      f"(w1) {name} {i}: another kernel ran: {launches}")
            w_quiesce(*fleets)
            code, loc, _ = post(pull_s.port, v_body(head + v_tail(f"local {i}", W_TAIL)))
            check(code == 200 and loc.get("prefix_cached_tokens") == V_HEAD
                  and "kv_fabric_blocks" not in loc, f"(w1) local hit {i}: {loc}")
            rows["local"].append(dict(ttft=loc["ttft_s"]))
        for name, (_, srv) in (("streamed", pull), ("whole", whole)):
            graphs = get(srv.port, "/stats")[1]["continuous"]["graphs"]
            check(all(g["captures"] == 1 for g in graphs.values()),
                  f"(w1) {name}: a graph was captured again: {graphs}")
    finally:
        for spy in spies.values():
            spy.close()
    med = {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for name, rs in rows.items()}
    print(f"(w1) TTFT of a {V_HEAD}+{W_TAIL}-token greedy request, medians of {W_HEADS}, each "
          f"from an idle fleet: remote hit streamed {med['streamed']['ttft'] * 1e3:.1f} ms, "
          f"whole-blob {med['whole']['ttft'] * 1e3:.1f} ms, local hit "
          f"{med['local']['ttft'] * 1e3:.1f} ms, cold {med['cold']['ttft'] * 1e3:.1f} ms; the "
          f"pull (streamed / whole-blob): prefetch {med['streamed']['prefetch_ms']:.2f} / "
          f"{med['whole']['prefetch_ms']:.2f} ms, wire, decode and recheck "
          f"{med['streamed']['wire_ms']:.2f} / {med['whole']['wire_ms']:.2f} ms, "
          f"{med['streamed']['bytes']:.0f} / {med['whole']['bytes']:.0f} bytes, "
          f"{med['streamed']['mb_per_s']:.1f} / {med['whole']['mb_per_s']:.1f} MB/s over "
          f"loopback, scatter {med['streamed']['scatter_ms']:.2f} / "
          f"{med['whole']['scatter_ms']:.2f} ms (pinning {med['streamed']['pin_ms']:.2f} / "
          f"{med['whole']['pin_ms']:.2f}) ({smi})")
    return dict(medians=med, ttfts={k: [r["ttft"] for r in rs] for k, rs in rows.items()})


def w_wave(port, bodies, headers=None):
    """POST the bodies at once: (results, wave seconds)."""
    import threading

    results = [None] * len(bodies)

    def run(i):
        results[i] = post(port, bodies[i], headers=headers)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def phase_w2(engine, holder, pull, smi):
    """A wave of 8 on the puller behind one remote head, every request
    hinted: one fetch, one hit, the other seven hit the imported chain;
    then a wave of fresh tails on the same head, now local."""
    pull_f, pull_s = pull
    head = v_head(20)
    digest = w_register(engine, holder, head, "register wave")
    out = {}
    for name, hint in (("remote head", w_hint(holder, digest)), ("local head", None)):
        bodies = [v_body(head + v_tail(f"{name} {i}", n), greedy=i % 2 == 0)
                  for i, n in enumerate(W_WAVE_TAILS)]
        v_quiesce(pull_f)
        fab0 = w_fabric(pull_s.port)
        results, wave_s = w_wave(pull_s.port, bodies, hint)
        wait_idle(pull_s.port)
        fab = w_fabric(pull_s.port)
        n_tok = 0
        for i, (code, r, _) in enumerate(results):
            check(code == 200 and r.get("prefix_cached_tokens") == V_HEAD,
                  f"(w2) {name} {i}: {r}")
            n_tok += r["tokens_generated"]
        imported = [r.get("kv_fabric_blocks") for _, r, _ in results]
        delta = (fab["fetches"] - fab0["fetches"], fab["hits"] - fab0["hits"],
                 fab["misses"] - fab0["misses"])
        out[name] = n_tok / wave_s
        print(f"(w2) a wave of {len(bodies)} on a {name}: {n_tok} tokens in {wave_s:.3f} s = "
              f"{out[name]:.2f} tokens/s aggregate; fabric fetches, hits, misses {delta}; "
              f"kv_fabric_blocks {imported} ({smi})")
        want = (1, 1, 0) if hint else (0, 0, 0)
        check(delta == want, f"(w2) {name}: fabric counts {delta}, not {want}")
        want_imported = [V_HEAD // BLOCK] + [0] * 7 if hint else [0] * 8
        check(sorted((x or 0 for x in imported), reverse=True) == want_imported,
              f"(w2) {name}: imported {imported}")
    return out


def phase_w3(engine, holder, cold, pull, smi):
    """The handoff as a router runs it: phase 1 on the holder (prefill
    only, pushing the chain to the puller), phase 2 on the puller with the
    hint: the pushed chain promoted, no fetch, the cold run's tokens."""
    (cold_f, cold_s), (pull_f, pull_s) = cold, pull
    body = v_body(v_head(21) + v_tail("handoff", W_TAIL))
    code, p1, wall1 = post(holder.port, body, headers={
        "X-KV-Prefill-Only": "1", "X-KV-Push-To": f"http://127.0.0.1:{pull_s.port}"})
    check(code == 200 and p1.get("prefill_only") is True and p1.get("kv_pushed", 0) > 0,
          f"(w3) phase 1: {p1}")
    w_settle(holder)
    w_quiesce(cold_f, pull_f)
    code, c, _ = post(cold_s.port, body)
    w_quiesce(cold_f, pull_f)
    fab0 = w_fabric(pull_s.port)
    code, p2, _ = post(pull_s.port, body, headers=w_hint(holder, p1["kv_digests"][-1]))
    fab = w_fabric(pull_s.port)
    print(f"(w3) phase 1 on the holder: {p1['tokens_generated']} token, pushed "
          f"{p1['kv_pushed']} blocks to the puller, wall {wall1:.3f} s; phase 2 on the "
          f"puller: kv_promoted_blocks={p2.get('kv_promoted_blocks')} prefix_cached_tokens="
          f"{p2.get('prefix_cached_tokens')} fetches +{fab['fetches'] - fab0['fetches']} "
          f"ttft_s={p2.get('ttft_s')} (cold {c['ttft_s']}); tokens "
          + ("identical" if p2.get("token_ids") == c["token_ids"] else "NOT identical")
          + f" to cold ({smi})")
    check(code == 200 and p2.get("kv_promoted_blocks", 0) > 0, f"(w3) phase 2: {p2}")
    check(fab["fetches"] == fab0["fetches"], "(w3) phase 2 pulled the pushed chain")
    check(p2["token_ids"] == c["token_ids"], "(w3) phase 2's tokens are not the cold run's")
    return dict(pushed=p1["kv_pushed"], promoted=p2["kv_promoted_blocks"],
                ttft=p2["ttft_s"], cold_ttft=c["ttft_s"])


def phase_w4(torch, engine, holder, cold, pull, smi):
    """The ladder on the card: a dead peer, a digest the holder does not
    have, and an int8 holder's chain against the raw puller each end in a
    counted miss and the cold run's tokens within the fetch deadline; then
    an int8 puller's remote hit on the int8 holder, the int8 cold tokens."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    (cold_f, cold_s), (pull_f, pull_s) = cold, pull
    timeout_s = pull_f._fabric.timeout_s
    spy = PullSpy(torch, pull_f)
    holder8 = Holder("int8 holder", ["--kv-quant", "int8"])
    rows = {}
    try:
        print(f"(w4) the int8 holder up in {holder8.start_s:.1f} s on :{holder8.port}")
        digest8 = w_register(engine, holder8, v_head(24), "register int8")
        cases = (("dead peer", v_head(22), lambda h: {
                     "X-KV-Transfer-Peer": f"http://127.0.0.1:{free_port()}",
                     "X-KV-Transfer-Digest": kv_digest(engine, h)}),
                 ("404 digest", v_head(23), lambda h: w_hint(holder, "0" * 16)),
                 ("int8 holder, raw puller", v_head(24), lambda h: w_hint(holder8, digest8)))
        for name, head, hint in cases:
            body = v_body(head + v_tail(name, W_TAIL))
            w_quiesce(cold_f, pull_f)
            code, c, _ = post(cold_s.port, body)
            w_quiesce(cold_f, pull_f)
            fab0 = w_fabric(pull_s.port)
            spy.reset()
            code, r, wall = post(pull_s.port, body, headers=hint(head))
            fab = w_fabric(pull_s.port)
            delta = (fab["fetches"] - fab0["fetches"], fab["hits"] - fab0["hits"],
                     fab["misses"] - fab0["misses"])
            ev = [e for e in pull_f.engine.flight.dump()["events"]
                  if e["kind"] == "fabric_fetch"][-1]
            prefetch_s = spy.prefetch[0]
            print(f"(w4) {name}: HTTP {code} fabric fetches, hits, misses {delta}; flight "
                  f"event hit={ev['hit']}; prefetch {prefetch_s * 1e3:.1f} ms (deadline "
                  f"{timeout_s:g} s); prefix_cached_tokens={r.get('prefix_cached_tokens')}; "
                  f"ttft_s={r.get('ttft_s')} (cold {c['ttft_s']}); tokens "
                  + ("identical" if r.get("token_ids") == c["token_ids"] else "NOT identical")
                  + f" to cold ({smi})")
            check(code == 200 and "kv_fabric_blocks" not in r, f"(w4) {name}: {r}")
            check(delta == (1, 0, 1) and ev["hit"] is False,
                  f"(w4) {name}: not a counted miss: {delta} {ev}")
            check(prefetch_s < timeout_s, f"(w4) {name}: the fetch took {prefetch_s:.3f} s")
            check(r["token_ids"] == c["token_ids"], f"(w4) {name}: tokens are not cold's")
            rows[name] = dict(prefetch_ms=prefetch_s * 1e3, ttft=r["ttft_s"])
        # int8 to int8: the same weights, an int8 pool in process
        eng8 = create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                             kv_quant="int8", engine_cfg=EngineConfig(
                                 prefill_buckets=PREFILL_BUCKETS, prefix_cache_entries=8))
        body = v_body(v_head(24) + v_tail("int8 to int8", W_TAIL))
        code, own8, _ = post(holder8.port, body)
        check(code == 200 and own8.get("prefix_cached_tokens") == V_HEAD,
              f"(w4) the int8 holder's own hit: {own8}")
        w_settle(holder8)
        tokens = {}
        for name, kw, hint in (("int8 cold", {"kv_shadow": False}, None),
                               ("int8 remote hit", {}, w_hint(holder8, digest8))):
            f, srv = fleet_server(eng8, FLEET, **kw)
            try:
                check(f.warmup()["ok"], f"(w4) {name} warmup")
                code, r, _ = post(srv.port, body, headers=hint)
                check(code == 200, f"(w4) {name}: {r}")
                tokens[name] = r["token_ids"]
                if hint:
                    fab = get(srv.port, "/stats")[1]["continuous"]["kv_fabric"]
                    print(f"(w4) {name}: kv_fabric_blocks={r.get('kv_fabric_blocks')} "
                          f"fetches, hits, misses {(fab['fetches'], fab['hits'], fab['misses'])}"
                          f" {fab['bytes']} bytes ttft_s={r.get('ttft_s')}; tokens "
                          + ("identical" if r["token_ids"] == tokens["int8 cold"]
                             else "NOT identical") + f" to int8 cold ({smi})")
                    check(r.get("kv_fabric_blocks") == V_HEAD // BLOCK
                          and (fab["hits"], fab["misses"]) == (1, 0),
                          f"(w4) {name}: not a remote hit: {r} {fab}")
                    rows[name] = dict(bytes=fab["bytes"], ttft=r["ttft_s"])
            finally:
                srv.shutdown()
        check(tokens["int8 remote hit"] == tokens["int8 cold"] == own8["token_ids"],
              "(w4) int8 to int8: the remote hit's tokens are not the int8 cold run's and "
              "the int8 holder's own hit's")
    finally:
        spy.close()
        holder8.close()
    return rows


def kv_digest(engine, head: str) -> str:
    from distributed_llm_inference_tpu_torch.serving import kv_fabric as kvf

    return kvf.chain_digest(engine.tokenizer.encode(head), BLOCK)


def phase_w5(engine, pa, fa, Q, smi):
    """A remote hit of the bucketed whole-prefill admission ((v2)'s fleet):
    flash_attend n_layers times for its one tail chunk over the scratch
    gathered from the imported blocks; the cold bucketed fleet's tokens.
    The peer is a bucketed fleet in this process, so its cold run wrote the
    head with the cold run's own extend chunks (a ragged holder's bf16 K/V
    rounds otherwise)."""
    import types

    L = engine.cfg.n_layers
    flags = dict(ragged_prefill=False, chunked_prefill=False)
    head = v_head(25)
    body = v_body(head + v_tail("bucketed remote hit", W_TAIL))
    peer_f, peer_s = fleet_server(v_engine(engine, prefix_cache_entries=8, **flags), FLEET)
    out = {}
    try:
        check(peer_f.warmup()["ok"], "(w5) the bucketed peer's warmup")
        peer = types.SimpleNamespace(name="bucketed peer", port=peer_s.port,
                                     url=f"http://127.0.0.1:{peer_s.port}")
        digest = w_register(engine, peer, head, "register bucketed")
        for name, prefix, hint in (("cold", 0, None), ("remote hit", 8, w_hint(peer, digest))):
            fleet, server = fleet_server(v_engine(engine, prefix_cache_entries=prefix,
                                                  **flags), FLEET)
            try:
                check(fleet.warmup()["ok"], f"(w5) {name} warmup")
                before = wait_idle(server.port)["continuous"]
                w_quiesce(fleet, peer_f)
                reset_counts(pa, fa, Q)
                code, r, _ = post(server.port, body, headers=hint)
                after = wait_idle(server.port)["continuous"]
                w_quiesce(fleet, peer_f)
                launches = read_counts(pa, fa, Q)
                chunks = (after["launches"]["decode_chunks"]
                          - before["launches"]["decode_chunks"])
                print(f"(w5) bucketed {name}: HTTP {code} kv_fabric_blocks="
                      f"{r.get('kv_fabric_blocks')} prefix_cached_tokens="
                      f"{r.get('prefix_cached_tokens')} prefill_chunks="
                      f"{r.get('prefill_chunks')} ttft_s={r.get('ttft_s')}; kernel launches "
                      f"{json.dumps(launches)}; graphs {json.dumps(after['graphs'])} ({smi})")
                check(code == 200, f"(w5) {name}: {r}")
                check(launches["flash_attend"] == L * r["prefill_chunks"] > 0,
                      f"(w5) {name}: flash_attend {launches['flash_attend']} for "
                      f"{r['prefill_chunks']} T>1 chunks")
                check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks,
                      f"(w5) {name}: paged_flash_attend {launches['paged_flash_attend']}")
                check(all(g["captures"] == 1 for g in after["graphs"].values()),
                      f"(w5) {name}: graphs {after['graphs']}")
                if hint:
                    check(r.get("kv_fabric_blocks") == V_HEAD // BLOCK
                          and r.get("prefix_cached_tokens") == V_HEAD
                          and r["prefill_chunks"] == 1, f"(w5) not a remote hit: {r}")
                out[name] = dict(tokens=r["token_ids"], launches=launches, ttft=r["ttft_s"])
            finally:
                server.shutdown()
    finally:
        peer_s.shutdown()
    at = parts_at(out["remote hit"]["tokens"], out["cold"]["tokens"])
    print("(w5) bucketed remote hit vs cold greedy tokens: "
          + ("identical" if at is None else f"part at token {at}") + f" ({smi})")
    check(at is None, "(w5) the bucketed remote hit's tokens are not the cold bucketed run's")
    return {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in out.items()}


def phase_w(torch, engine, pa, fa, Q, smi):
    """The cross-replica KV fabric on the paged fleet: a holder replica in a
    subprocess and pullers in process, on the same card and weights."""
    t0 = time.time()
    holder = Holder("holder")
    out = {}
    try:
        print(f"(w) the holder (the port's server CLI, {' '.join(W_HOLDER)}) up in "
              f"{holder.start_s:.1f} s on :{holder.port}")
        cold = fleet_server(engine, FLEET)  # no prefix cache: the cold runs
        pull = fleet_server(v_engine(engine, prefix_cache_entries=8), FLEET)
        whole = fleet_server(v_engine(engine, prefix_cache_entries=8,
                                      kv_fabric_stream=False), FLEET)
        try:
            for name, (f, _) in (("cold", cold), ("puller", pull), ("whole-blob", whole)):
                check(f.warmup()["ok"], f"(w) {name} warmup")
                check(name == "cold" or f.fabric_serving, f"(w) {name}: no fabric")
            # the same weights in both processes, or a remote hit proves nothing
            body = v_body(fleet_prompt(99, W_TAIL))
            code, h, _ = post(holder.port, body)
            w_settle(holder)
            code2, c, _ = post(cold[1].port, body)
            print(f"(w) a cold greedy request on the holder and in process: tokens "
                  + ("identical" if h.get("token_ids") == c.get("token_ids") else
                     "NOT identical") + f" ({smi})")
            check(code == code2 == 200 and h["token_ids"] == c["token_ids"],
                  "(w) the holder and the in-process engine draw different weights")
            out["w1"] = phase_w1(torch, engine, pa, fa, Q, holder, cold, pull, whole, smi)
            out["w2"] = phase_w2(engine, holder, pull, smi)
            out["w3"] = phase_w3(engine, holder, cold, pull, smi)
            out["w4"] = phase_w4(torch, engine, holder, cold, pull, smi)
            for name, (_, srv) in (("puller", pull), ("whole-blob", whole)):
                graphs = get(srv.port, "/stats")[1]["continuous"]["graphs"]
                check(all(g["captures"] == 1 for g in graphs.values()),
                      f"(w) {name}: a graph was captured again: {graphs}")
        finally:
            for _, srv in (cold, pull, whole):
                srv.shutdown()
    finally:
        holder.close()
    out["w5"] = phase_w5(engine, pa, fa, Q, smi)
    print(f"(w) took {time.time() - t0:.1f} s")
    print("(w) " + json.dumps({"kv_fabric": out}))


# -- the router tier over replica processes: phase (R) ------------------------------

R_NEW = 32  # new tokens per (R1) / (R3) request
R_HEAD = 512  # (R1)'s shared head: 32 blocks
R_TAILS = (20, 40, 60, 80)  # the four tails behind it
R_OTHERS = (30, 60, 90, 120)  # the wave's four other prompts (under the handoff gate)
R_LONG = 700  # (R2)'s traced prompt: handed off, its decode traced
R_LONG_NEW = 64
R_COMPANION = 600  # (R2)'s companion prompt on the decode replica, under its decode
R_POOL = 513
R_PROBE_S, R_EJECT, R_PROBE_TIMEOUT_S = 0.25, 3, 2.0
R_SLOW = "SLOWPOKE " + fleet_prompt(90, 200)  # (R4)'s prompt held on the victim
R_FAULTS = "prefill:transient:match=SLOWPOKE,wedge=6,times=1"
R_DIR = "build/chip_smoke_R"  # the replicas' profiler traces (gitignored)


def r_args(build_dir) -> list:
    """A replica's server CLI: tinyllama-1.1b at its published widths, bf16,
    seed 0, (g)'s fleet with the prefix cache, every trace sampled, the
    kernels' libraries from the directory (a) built, warmed before it
    answers /ready (its graphs captured: a cold replica's first launches
    would be timed as the router's)."""
    return ["--model", MODEL, "--dtype", "bfloat16", "--attn-impl", "auto", "--seed", "0",
            "--continuous", str(FLEET["n_slots"]), "--kv-pool-blocks", str(R_POOL),
            "--kv-block-size", str(BLOCK), "--continuous-max-seq", str(FLEET["slot_max_seq"]),
            "--prefix-cache", "8", "--trace-sample-rate", "1.0",
            "--compile-cache", str(build_dir), "--max-tokens-cap", "512", "--warmup"]


def r_env(faults=None) -> dict:
    import os

    env = dict(os.environ)
    env.pop("DLI_FAULTS", None)
    if faults:
        env["DLI_FAULTS"] = faults
    return env


def r_spawn(PR, args, cls, rid, faults=None):
    """One replica through the port's spawn_replicas; if it never gets
    ready, its argv runs once more with its output kept, for the failure."""
    try:
        rep = PR.spawn_replicas(1, args, env=r_env(faults), replica_class=cls)[0]
    except SystemExit as e:
        r = subprocess.run([sys.executable, "-m",
                            "distributed_llm_inference_tpu_torch.serving.server", *args,
                            "--port", str(free_port())],
                           capture_output=True, text=True, timeout=120, env=r_env())
        raise SmokeFailure(f"(R) replica {rid} ({cls}): {e}; its output: "
                           f"{(r.stdout + r.stderr)[-3000:]}") from None
    rep.rid = rid
    return rep


def r_spawn_all(PR, specs) -> list:
    """Spawn replicas (args, class, rid, faults) together; every one or a
    failure."""
    import threading

    reps, errs = [None] * len(specs), []

    def run(i):
        try:
            reps[i] = r_spawn(PR, *specs[i])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        r_stop([r for r in reps if r is not None])
        raise errs[0]
    return reps


def r_stop(reps):
    for rep in reps:
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.terminate()
    for rep in reps:
        if rep.proc is not None:
            try:
                rep.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(timeout=30)


def r_call(url, path, body=None, headers=None, timeout=600):
    """(code, JSON, wall s) of a GET (body None) or POST to url + path."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


def r_body(prompt, n=R_NEW) -> dict:
    return {"prompt": prompt, "max_tokens": n, "greedy": True, "chat": False}


def r_idle(url, timeout_s=60.0) -> dict:
    """A replica's /stats "continuous" once it holds no request."""
    t0 = time.time()
    while True:
        c = r_call(url, "/stats")[1]["continuous"]
        if c["occupied"] == 0 and c["queued"] == 0:
            return c
        check(time.time() - t0 < timeout_s, f"(R) {url} did not go idle: {c}")
        time.sleep(0.05)


def r_wave(url, bodies) -> tuple:
    """POST the bodies at once to url; (results, wave seconds)."""
    import threading

    out = [None] * len(bodies)

    def run(i):
        out[i] = r_call(url, "/generate", bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def r_used(torch) -> int:
    """Bytes of the card in use by every process."""
    free, total = torch.cuda.mem_get_info()
    return total - free


def r_memory(torch, reps, used_before: int, beside_lane=False) -> str:
    """Each replica's device memory, by pid, as nvidia-smi reports it (in a
    container it may list no process), and what the replicas added to the
    card's use since `used_before` (`beside_lane`: the lane's allocations
    of that time are in it too)."""
    added = r_used(torch) - used_before
    try:
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True)
        used = dict(line.split(", ", 1) for line in r.stdout.strip().splitlines() if line)
    except (OSError, subprocess.SubprocessError, ValueError):
        used = {}
    return (", ".join(f"{rep.rid} {used.get(str(rep.proc.pid), 'not measured')}"
                      for rep in reps)
            + f"; the card's use rose by {added / 2**30:.2f} GiB while the {len(reps)} "
            f"replicas started ({added / len(reps) / 2**30:.2f} GiB each on average"
            + ("; the lane's allocations of that time in it too)" if beside_lane else ")"))


def r_trace_counts(path) -> dict:
    """Kernel launches by the kernels line's names, from a torch.profiler
    Chrome trace: the flash walk through the block table (PagedTable) is
    ragged_paged_attend, over a dense chunk flash_attend; the split-KV
    decode walk through the table (PagedRows) is paged_flash_attend, over
    dense rows flash_attend_slots; int8 caches instantiate on signed char."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {k: 0 for k in ("ragged_paged_attend", "paged_flash_attend", "flash_attend")}
    out.update({k + "[int8]": 0 for k in list(out)})
    out.update(q4_matmul_rows=0, flash_attend_slots=0)
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        name = ev.get("name", "")
        int8 = "[int8]" if "signed char" in name else ""
        if "walk<" in name and "PagedTable" in name:
            out["ragged_paged_attend" + int8] += 1
        elif "walk<" in name and "DenseChunk" in name:
            out["flash_attend" + int8] += 1
        elif "walk_split" in name and "PagedRows" in name:
            out["paged_flash_attend" + int8] += 1
        elif "walk_split" in name and "DenseRows" in name:
            out["flash_attend_slots"] += 1
        elif "q4_rows" in name:
            out["q4_matmul_rows"] += 1
    return out


def r_wait(router, rid, state, deadline_s) -> float | None:
    """Seconds until replica rid reached state, or None past the deadline."""
    rep = next(r for r in router.replicas if r.rid == rid)
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        if rep.state == state:
            return time.time() - t0
        time.sleep(0.02)
    return None


def r_counters(router) -> dict:
    """Every dli_router_* counter and gauge series, as exposed."""
    out = {}
    for line in router.metrics.render().splitlines():
        if line.startswith("dli_router_") and not re.match(r"\S+_(bucket|sum|count)\{", line):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def phase_R1(router, base, pre, dec, smi) -> dict:
    """A cold request straight to the decode replica and through the
    router; a wave of 8 straight to one replica and through the router."""
    prompt = fleet_prompt(70, 100)  # under the router's 192-byte handoff gate
    code, direct, _ = r_call(dec.url, "/generate", r_body(prompt))
    r_idle(dec.url)
    code2, routed, _ = r_call(base, "/generate", r_body(prompt))
    print(f"(R1) a cold greedy request straight to {dec.rid} and through the router "
          f"(served by {routed.get('replica')}): tokens "
          + ("identical" if direct.get("token_ids") == routed.get("token_ids")
             else "NOT identical") + f" ({smi})")
    check(code == code2 == 200 and direct["status"] == routed["status"] == "success",
          f"(R1) {direct} / {routed}")
    check(direct["token_ids"] == routed["token_ids"] and len(direct["token_ids"]) == R_NEW,
          "(R1) the router's answer is not the replica's")
    head = fleet_prompt(71, R_HEAD)
    prompts = ([head + fleet_prompt(72 + i, n) for i, n in enumerate(R_TAILS)]
               + [fleet_prompt(80 + i, n) for i, n in enumerate(R_OTHERS)])
    bodies = [r_body(p) for p in prompts]
    # the reference: each prompt alone on the idle decode replica
    want = []
    for b in bodies:
        code, r, _ = r_call(dec.url, "/generate", b)
        check(code == 200 and r["status"] == "success", f"(R1) reference: {r}")
        want.append(r["token_ids"])
    r_idle(dec.url)
    rows = {}
    for label, url in (("straight to " + dec.rid, dec.url), ("through the router", base)):
        results, wave_s = r_wave(url, bodies)
        for rep in (pre, dec):
            r_idle(rep.url)
        n_tok = 0
        for i, (code, r, wall) in enumerate(results):
            check(code == 200 and r.get("status") == "success"
                  and r["tokens_generated"] == R_NEW, f"(R1) {label} request {i}: {r}")
            n_tok += r["tokens_generated"]
        partings = [(i, parts_at(r["token_ids"], want[i]))
                    for i, (_, r, _) in enumerate(results) if r["token_ids"] != want[i]]
        for i, (code, r, wall) in enumerate(results):
            t = r.get("timings", {})
            print(f"(R1) {label} request {i}: wall {wall:.3f} s ttft_s={r.get('ttft_s')} "
                  f"router_s={t.get('router_s')} queue_wait_s={t.get('queue_wait_s')} "
                  f"admission_s={t.get('admission_s')} decode_s={t.get('decode_s')} "
                  f"prefix_cached_tokens={r.get('prefix_cached_tokens')}")
        for rep in (pre, dec):
            c = r_call(rep.url, "/stats")[1]["continuous"]
            print(f"(R1) after the wave {label}, {rep.rid}: kv_fabric "
                  f"{json.dumps(c.get('kv_fabric'))}, shadow {json.dumps(c.get('shadow'))}, "
                  f"launches {json.dumps(c.get('launches'))}")
        rows[label] = dict(wave_s=wave_s, tokens=n_tok, tokens_per_s=n_tok / wave_s,
                           served_by=[r.get("replica", dec.rid) for _, r, _ in results],
                           kv_fabric_blocks=[r.get("kv_fabric_blocks", 0) for _, r, _ in results],
                           kv_promoted_blocks=[r.get("kv_promoted_blocks", 0)
                                               for _, r, _ in results],
                           partings=partings)
        print(f"(R1) wave of 8 {label}: {n_tok} tokens in {wave_s:.3f} s = "
              f"{n_tok / wave_s:.2f} tokens/s aggregate, served by "
              f"{rows[label]['served_by']}; greedy ids equal to each prompt alone on "
              f"{dec.rid} for {8 - len(partings)} of 8"
              + (f" (parting at (request, token) {partings}: a request that shares "
                 f"its launches with others takes other bf16 roundings)" if partings else "")
              + f" ({smi})")
    return rows


def phase_R2(SpanContext, router, base, pre, dec, smi) -> dict:
    """One traced long request through the two-phase handoff, its chain
    pulled over the fabric, a companion prefill on the decode replica under
    its decode; the router assembles one trace tree."""
    import threading

    ctx = SpanContext.new_root()
    r_idle(dec.url)
    comp = {}

    def companion():
        t0 = time.time()
        while r_call(dec.url, "/stats")[1]["continuous"]["occupied"] == 0:
            if time.time() - t0 > 60:
                return
            time.sleep(0.002)
        comp["r"] = r_call(dec.url, "/generate", r_body(fleet_prompt(92, R_COMPANION), 8))

    t = threading.Thread(target=companion)
    t.start()
    router.kv_push = False  # phase 2 pulls the chain: fabric.pull and kv.serve
    try:
        code, env, wall = r_call(base, "/generate",
                                 r_body(fleet_prompt(91, R_LONG), R_LONG_NEW),
                                 headers={"traceparent": ctx.header()})
    finally:
        router.kv_push = True
    t.join()
    check(code == 200 and env["status"] == "success", f"(R2) {env}")
    check("r" in comp and comp["r"][0] == 200, f"(R2) the companion: {comp}")
    print(f"(R2) traced handoff ({R_LONG} prompt tokens, {R_LONG_NEW} new): HTTP {code} "
          f"replica={env.get('replica')} kv_fabric_blocks={env.get('kv_fabric_blocks')} "
          f"kv_promoted_blocks={env.get('kv_promoted_blocks')} ttft_s={env.get('ttft_s')} "
          f"wall {wall:.3f} s, timings {json.dumps(env.get('timings'))} ({smi})")
    check(env.get("replica") == dec.rid and env.get("kv_fabric_blocks", 0) > 0,
          "(R2) the decode replica did not pull the chain")
    code, tree, _ = r_call(base, f"/debug/traces/{ctx.trace_id}")
    check(code == 200, f"(R2) /debug/traces: {code}")
    names = {}
    for s in tree["spans"]:
        names[s["service"] + ":" + s["name"]] = names.get(s["service"] + ":" + s["name"], 0) + 1
    print(f"(R2) the assembled tree: {len(tree['spans'])} spans in {len(tree['tree'])} "
          f"root(s), span total {tree['total_s']:.4f} s of the {wall:.4f} s wall; by "
          f"service and name {json.dumps(dict(sorted(names.items())))}")
    check(len(tree["tree"]) == 1 and tree["tree"][0]["name"] == "router.request",
          "(R2) not one tree under router.request")
    for key in ("router:router.request", "router:router.handoff_prefill",
                "router:router.dispatch", "replica-prefill:replica.request",
                "replica-decode:replica.request", "replica-decode:fabric.pull",
                "replica-prefill:kv.serve", "replica-decode:launch.mixed",
                "replica-decode:launch.chunk"):
        check(names.get(key, 0) >= 1, f"(R2) the tree holds no {key}")
    check(0 < tree["total_s"] <= wall, f"(R2) span total {tree['total_s']} > wall {wall}")
    code, chrome, _ = r_call(base, f"/debug/traces/{ctx.trace_id}?format=chrome")
    lanes = sorted(e["args"]["name"] for e in chrome["traceEvents"]
                   if e["name"] == "process_name")
    print(f"(R2) ?format=chrome: HTTP {code}, {len(chrome['traceEvents'])} events, lanes "
          f"{lanes}")
    check(code == 200 and lanes == ["replica-decode", "replica-prefill", "router"],
          f"(R2) chrome trace lanes {lanes}")
    launches = [s for s in tree["spans"] if s["name"].startswith("launch.")]
    return dict(spans=names, total_s=tree["total_s"], wall_s=wall,
                launch_to_fetch_ms=statistics.median(
                    1e3 * s["attrs"]["launch_to_fetch_s"] for s in launches))


def phase_R3(torch, base, dec, smi) -> dict:
    """The decode replica profiled through its /profiler routes during a
    wave of 8 through the router: its two paged kernels ran n_layers times
    per mixed launch and per decode step, nothing else."""
    import os

    bodies = [r_body(fleet_prompt(100 + i, n)) for i, n in enumerate(FLEET_PROMPT_TOKENS)]
    r_idle(dec.url)
    before = r_call(dec.url, "/stats")[1]["continuous"]
    code, started, _ = r_call(dec.url, "/profiler/start", {"trace_dir": "chip-smoke-R"})
    check(code == 200, f"(R3) /profiler/start: {started}")
    results, wave_s = r_wave(base, bodies)
    r_idle(dec.url)
    time.sleep(0.5)  # launches still in flight land before the trace stops
    after = r_call(dec.url, "/stats")[1]["continuous"]
    code, stopped, _ = r_call(dec.url, "/profiler/stop", {})
    check(code == 200, f"(R3) /profiler/stop: {stopped}")
    for i, (c, r, _) in enumerate(results):
        check(c == 200 and r.get("status") == "success", f"(R3) request {i}: {r}")
    trace = os.path.join(stopped["trace_dir"], "trace.json")
    size = os.path.getsize(trace)
    counts = r_trace_counts(trace)
    os.remove(trace)
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config

    L, steps = get_model_config(MODEL).n_layers, after["chunk_steps"]
    mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    print(f"(R3) {dec.rid} profiled over a wave of 8 through the router ({wave_s:.3f} s): "
          f"trace {size} bytes, {mixed} mixed launches and {chunks} decode chunks of "
          f"{steps} steps on {dec.rid}; kernel launches in the trace {json.dumps(counts)} "
          f"({smi})")
    check(counts["ragged_paged_attend"] == L * mixed > 0,
          f"(R3) ragged_paged_attend ran {counts['ragged_paged_attend']} times for "
          f"{mixed} mixed launches of {L} layers")
    check(counts["paged_flash_attend"] == L * steps * chunks > 0,
          f"(R3) paged_flash_attend ran {counts['paged_flash_attend']} times for {chunks} "
          f"decode chunks of {steps} steps x {L} layers")
    others = {k: v for k, v in counts.items()
              if k not in ("ragged_paged_attend", "paged_flash_attend") and v}
    check(not others, f"(R3) another kernel ran on the decode replica: {others}")
    return counts


def phase_R4(PR, victim, survivor, smi) -> dict:
    """kill -9 of one of two mixed replicas with a request held in flight on
    it: the failover answers with the fault-free ids, the dead replica is
    ejected within the probe window and readmitted after a respawn."""
    import threading

    router = PR.Router([victim, survivor], eject_threshold=R_EJECT,
                       probe_interval_s=R_PROBE_S, probe_timeout_s=R_PROBE_TIMEOUT_S,
                       request_timeout_s=120.0, drain_deadline_s=60.0)
    server = PR.RouterServer(router, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        companion = fleet_prompt(93, 150)
        want = {}
        for p in (R_SLOW, companion):  # fault-free: each alone on the idle survivor
            code, r, _ = r_call(survivor.url, "/generate", r_body(p))
            check(code == 200, f"(R4) reference: {r}")
            want[p] = r["token_ids"]
        r_idle(survivor.url)
        router.record_residency(
            PR.chunk_digests(R_SLOW, router.affinity_chunk, PR.AFFINITY_MAX_CHUNKS), "m0")
        out = {}

        def fire(name, prompt):
            out[name] = r_call(base, "/generate", r_body(prompt), timeout=120)

        t_slow = threading.Thread(target=fire, args=("slow", R_SLOW))
        t_slow.start()
        t0 = time.time()
        while victim.outstanding == 0:
            check(time.time() - t0 < 30, "(R4) the held request was never dispatched")
            time.sleep(0.01)
        fire("companion", companion)  # on the survivor while m0 holds the other
        t_kill = time.time()
        victim.proc.kill()  # SIGKILL inside the 6 s hold: no drain
        t_slow.join(timeout=120)
        code, slow, wall = out["slow"]
        code2, comp, _ = out["companion"]
        print(f"(R4) kill -9 of m0 with a request held on it: HTTP {code} "
              f"replica={slow.get('replica')} router_attempts={slow.get('router_attempts')} "
              f"wall {wall:.3f} s, ids equal to the fault-free run: "
              f"{slow.get('token_ids') == want[R_SLOW]}; the companion on "
              f"{comp.get('replica')}: HTTP {code2}, ids equal: "
              f"{comp.get('token_ids') == want[companion]} ({smi})")
        check(code == 200 and slow["status"] == "success" and slow["replica"] == "m1"
              and slow.get("router_attempts", 1) > 1, f"(R4) the held request: {slow}")
        check(slow["token_ids"] == want[R_SLOW], "(R4) the failover's ids are not the "
              "fault-free run's")
        check(code2 == 200 and comp["token_ids"] == want[companion],
              f"(R4) the companion: {comp}")
        ejected = r_wait(router, "m0", PR.EJECTED, 10.0)
        eject_s = time.time() - t_kill
        window = R_EJECT * R_PROBE_S + R_PROBE_TIMEOUT_S
        print(f"(R4) m0 ejected {eject_s:.3f} s after the kill (probe window "
              f"{window:.2f} s: {R_EJECT} probes {R_PROBE_S} s apart plus a "
              f"{R_PROBE_TIMEOUT_S} s probe timeout)")
        check(ejected is not None and eject_s <= window,
              "(R4) the dead replica was not ejected within the probe window")
        victim.spawn_env = r_env()
        t0 = time.time()
        victim.proc = subprocess.Popen(victim.spawn_argv, env=victim.spawn_env,
                                       stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        back = r_wait(router, "m0", PR.READY, 180.0)
        print(f"(R4) m0 respawned and readmitted in "
              + (f"{back:.1f} s" if back is not None else "never"))
        check(back is not None, "(R4) the respawned replica was never readmitted")
        counters = r_counters(router)
        print(f"(R4) dli_router_* {json.dumps(counters)}")
        check(counters.get('dli_router_failovers_total{replica="m0"}', 0) >= 1
              and counters.get('dli_router_ejections_total{replica="m0"}', 0) >= 1
              and counters.get('dli_router_readmissions_total{replica="m0"}', 0) >= 1,
              "(R4) the router's counters missed the episode")
        return dict(eject_s=eject_s, readmit_s=back, counters=counters)
    finally:
        server.shutdown()
        r_stop([victim, survivor])


def phase_R(torch, kernels, smi, beside_lane=False) -> dict:
    """The port's router (in process) in front of a prefill-class and a
    decode-class replica on the card, then two mixed replicas for the kill
    leg, all four started at once. Returns the decode replica's kernel
    launches in (R3)."""
    from distributed_llm_inference_tpu_torch.serving import router as PR
    from distributed_llm_inference_tpu_torch.utils.tracing import SpanContext

    t0 = time.time()
    args = r_args(kernels.BUILD)
    used = r_used(torch)
    # the kill leg's two mixed replicas start beside the pair, so that the
    # four start-ups overlap
    reps = r_spawn_all(PR, [(args, "prefill", "p0", None), (args, "decode", "d0", None),
                            (args, "mixed", "m0", R_FAULTS), (args, "mixed", "m1", None)])
    pre, dec, victim, survivor = reps
    try:
        print(f"(R) p0 (prefill), d0 (decode) and the kill leg's m0, m1 (mixed): the "
              f"port's server CLI, {' '.join(args)}, all four up in "
              f"{time.time() - t0:.1f} s; device memory by replica: "
              f"{r_memory(torch, reps, used, beside_lane)} ({smi})")
        router = PR.Router([pre, dec], eject_threshold=R_EJECT, probe_interval_s=R_PROBE_S,
                           probe_timeout_s=R_PROBE_TIMEOUT_S, request_timeout_s=120.0)
        server = PR.RouterServer(router, host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            out = {"R1": phase_R1(router, base, pre, dec, smi)}
            out["R2"] = phase_R2(SpanContext, router, base, pre, dec, smi)
            launches = phase_R3(torch, base, dec, smi)
        finally:
            server.shutdown()
            r_stop([pre, dec])
        out["R4"] = phase_R4(PR, victim, survivor, smi)
    finally:
        r_stop(reps)
    print(f"(R) took {time.time() - t0:.1f} s ({smi})")
    print("(R) " + json.dumps({"router": out}))
    return launches


# -- the MPMD stage pipeline over stage processes: phase (P) -------------------------

P_STAGES = 2  # plan_stages(22, 2): layers 0-11 and 11-22
P_BLOCK = 16
P_PROMPT = 100  # (P1)-(P3)'s prompt tokens
P_NEW = 32
P_KILL_AFTER = 6  # (P2)'s decode tokens before each kill -9
P4_PROMPTS = (40, 60, 80, 100)  # (P4)'s four concurrent requests
P4_NEW = 48
P_DIR = "build/chip_smoke_P"  # the stage processes' logs (gitignored)


def p_supervisor(SR, ports, restore_dir):
    """The runtime's supervisor with each stage's output kept in
    P_DIR/stage{s}.log (the runtime drops it), so that a stage that fails
    to start says why."""

    class LoggedSupervisor(SR.StageSupervisor):
        def spawn(self, stage):
            with open(f"{P_DIR}/stage{stage}.log", "ab") as log:
                proc = subprocess.Popen(self.spawn_argv(stage), env=self.env,
                                        stdout=log, stderr=subprocess.STDOUT)
            with self._lock:
                self._procs[stage] = proc
            return proc

    return LoggedSupervisor(MODEL, P_STAGES, ports, seed=0, block_size=P_BLOCK,
                            restore_dir=restore_dir, restart_budget=10, env=r_env(),
                            device=DEVICE)


def p_transport(SR, wire_quant=None):
    """The runtime's HTTP transport, recording each hop's wall by stage and
    each accounted crossing's bytes by link."""

    class TimedTransport(SR.HttpStageTransport):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.walls, self.links = {}, {}

        def _account_link(self, name, nbytes):
            self.links.setdefault(name, []).append(nbytes)
            super()._account_link(name, nbytes)

        def step(self, addr, stage, *a, **kw):
            t0 = time.perf_counter()
            out = super().step(addr, stage, *a, **kw)
            self.walls.setdefault(stage, []).append(time.perf_counter() - t0)
            return out

        def wire_bytes(self) -> float:
            return self.registry.get("dli_pp_wire_bytes_total").labels(path="stage").value

    return TimedTransport(wire_quant=wire_quant)


def p_reference(torch, M, cfg, prompt_ids, n_new):
    """(params, greedy ids, the walls of its T=1 steps) of the
    single-device model on the card from the stages' seed: M.forward over
    the prompt, then T=1 steps (each ends in the host's read of its
    token), stopping at EOS as the pipeline does (the EOS not kept)."""
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    cache = M.init_kv_cache(cfg, 1, len(prompt_ids) + n_new, device=DEVICE)
    walls = []
    with torch.no_grad():
        logits, cache = M.forward(cfg, params, torch.tensor([prompt_ids], device=DEVICE),
                                  cache, 0)
        ids, pos = [int(torch.argmax(logits[0, -1]))], len(prompt_ids)
        while len(ids) < n_new and ids[-1] != cfg.eos_token_id:
            t0 = time.perf_counter()
            logits, cache = M.forward(cfg, params, torch.tensor([[ids[-1]]], device=DEVICE),
                                      cache, pos)
            ids.append(int(torch.argmax(logits[0, -1])))
            walls.append(time.perf_counter() - t0)
            pos += 1
    return params, [t for t in ids if t != cfg.eos_token_id], walls


def p_identity(tag, torch, M, cfg, params, prompt_ids, got, want):
    """got equals want, or parts only at a near-tie: the reference model's
    top-2 logit gap after prompt + want[:at] (one teacher-forced forward)
    under LOGITS_ATOL. Returns None or {at, gap}."""
    at = parts_at(got, want)
    if at is None:
        return None
    ids = list(prompt_ids) + list(want[:at])
    cache = M.init_kv_cache(cfg, 1, len(ids), device=DEVICE)
    with torch.no_grad():
        logits, _ = M.forward(cfg, params, torch.tensor([ids], device=DEVICE), cache, 0)
    top = logits[0, -1].float().topk(2).values
    gap = float(top[0] - top[1])
    check(gap < LOGITS_ATOL, f"{tag}: the ids part at token {at} where the reference's "
                             f"top-2 gap is {gap:.4f}")
    return {"at": at, "gap": round(gap, 4)}


def p_forced(tag, torch, M, cfg, params, prompt_ids, got, at):
    """Every token of `got` from index `at` on is a near-top choice of the
    reference model fed got's own earlier tokens (teacher forcing, one
    forward of prompt + got): its logit within LOGITS_ATOL of that
    position's top logit. Returns the largest shortfall."""
    ids = list(prompt_ids) + list(got)
    cache = M.init_kv_cache(cfg, 1, len(ids), device=DEVICE)
    with torch.no_grad():
        logits, _ = M.forward(cfg, params, torch.tensor([ids], device=DEVICE), cache, 0)
    rows = logits[0, len(prompt_ids) - 1 + at: len(ids) - 1].float()
    picked = rows.gather(1, torch.tensor(got[at:], device=DEVICE)[:, None])[:, 0]
    short = rows.max(dim=1).values - picked
    worst = float(short.max()) if short.numel() else 0.0
    bad = [at + int(i) for i in torch.nonzero(short >= LOGITS_ATOL)[:, 0].tolist()]
    check(not bad, f"{tag}: teacher-forced, the tokens at {bad} are not within "
                   f"{LOGITS_ATOL} of the reference's top logit (worst {worst:.4f})")
    return worst


def p_slots_free(tag, pipe):
    for st in pipe.health()["stages"]:
        slots = st["kv_slots"]
        check(slots["free"] == slots["total"],
              f"{tag}: stage {st['stage']} holds slots after the requests: {slots}")


def p_stage_memory(pipe, sup, kernels) -> list:
    """Per stage: its layers, the device memory nvidia-smi reports for its
    pid (in a container it may list none), torch's allocated / reserved
    bytes in the stage, and whether a kernel library of `kernels.BUILD` is
    mapped into the process."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True)
        smi_used = dict(line.split(", ", 1) for line in r.stdout.strip().splitlines() if line)
    except (OSError, subprocess.SubprocessError, ValueError):
        smi_used = {}
    out = []
    for st in pipe.health()["stages"]:
        pid = sup.proc(st["stage"]).pid
        try:
            with open(f"/proc/{pid}/maps") as f:
                mapped = str(kernels.BUILD) in f.read()
        except OSError:
            mapped = None
        out.append({"stage": st["stage"], "layers": st["layers"], "pid": pid,
                    "nvidia_smi": smi_used.get(str(pid), "not measured"),
                    "allocated_bytes": st["device_memory"]["allocated_bytes"],
                    "reserved_bytes": st["device_memory"]["reserved_bytes"],
                    "kernel_library_mapped": mapped})
    return out


def p_ms(values) -> dict:
    v = [x * 1e3 for x in values]
    return {"median": round(statistics.median(v), 3), "min": round(min(v), 3),
            "max": round(max(v), 3)}


def p_stage_steps(pipe, since) -> dict:
    """Per stage, the wall of its `stage.step` spans (the npz decode and
    the layers, in the stage process) that began after `since`: the
    prefill step's ms and the decode steps' median / min / max."""
    out = {}
    for s in range(P_STAGES):
        traces = pipe.transport.get_json(pipe.sup.addr(s), "/debug/traces")
        spans = [sp for spans in traces.values() for sp in spans
                 if sp["name"] == "stage.step" and sp["t0"] >= since]
        pre = [sp["t1"] - sp["t0"] for sp in spans if sp["attrs"]["pos"] == 0]
        dec = [sp["t1"] - sp["t0"] for sp in spans if sp["attrs"]["pos"] > 0]
        out[f"stage{s}"] = {"prefill_ms": round(pre[0] * 1e3, 3), "decode_ms": p_ms(dec)}
    return out


def p_request(tag, torch, M, cfg, params, ref, prompt, prompt_ids, pipe, tr, base):
    """One greedy /generate through the frontend, its ids held to the
    reference; (row, ids)."""
    tr.walls.clear()
    tr.links.clear()
    bytes0 = tr.wire_bytes()
    since = time.time()
    code, out, wall = r_call(base, "/generate", {"prompt": prompt, "max_new_tokens": P_NEW})
    check(code == 200, f"{tag} /generate answered {code}: {out}")
    ids = out["tokens"]
    part = p_identity(tag, torch, M, cfg, params, prompt_ids, ids, ref)
    act, res = tr.links["stage-activation-dcn"], tr.links["stage-result-dcn"]
    # per chain: stage 0's reply, then the send to stage 1 (activation), and
    # stage 1's reply (result); the first chain is the prefill
    hops = {f"stage{s}": {"prefill_ms": round(w[0] * 1e3, 3), "decode_ms": p_ms(w[1:])}
            for s, w in sorted(tr.walls.items())}
    row = {"tokens": len(ids), "wall_s": round(wall, 4),
           "tokens_per_s": round(len(ids) / wall, 2),
           "decode_tokens_per_s": round((len(ids) - 1) / sum(
               sum(w[1:]) for w in tr.walls.values()), 2),
           "hops": hops, "stage_steps": p_stage_steps(pipe, since),
           "wire_bytes": {"prefill_crossings": act[:2], "decode_crossings": act[2:4],
                          "result": res[1], "request_total": tr.wire_bytes() - bytes0,
                          "decode_per_token": act[2] + act[3] + res[1]},
           "parted": part}
    print(f"{tag} /generate through the frontend: {len(ids)} tokens in {wall:.3f} s = "
          f"{row['tokens_per_s']} tokens/s (decode {row['decode_tokens_per_s']} tokens/s "
          f"from the hops' walls); ids "
          + ("equal the in-process reference" if part is None else
             f"part from the reference at token {part['at']}, top-2 gap {part['gap']} "
             f"< {LOGITS_ATOL}")
          + f"; each hop's wall {json.dumps(hops)}; inside the stage (stage.step spans) "
          f"{json.dumps(row['stage_steps'])}; wire bytes {json.dumps(row['wire_bytes'])}")
    return row, ids


def phase_P1(torch, M, cfg, params, ref, prompt, prompt_ids, pipe, tr, base, smi) -> dict:
    """(P1) one greedy /generate through the frontend on the fresh stages
    (cold: each stage's first step pays cuBLAS and allocator warm-up),
    then the same request warm."""
    cold, ids = p_request("(P1) cold", torch, M, cfg, params, ref, prompt, prompt_ids,
                          pipe, tr, base)
    warm, ids_warm = p_request("(P1) warm", torch, M, cfg, params, ref, prompt, prompt_ids,
                               pipe, tr, base)
    check(ids_warm == ids, f"(P1) the warm repeat parts from the cold run at "
                           f"{parts_at(ids_warm, ids)}")
    lost = [e for e in pipe.flight.events() if e["kind"] == "heartbeat_lost"]
    print(f"(P1) the warm repeat's ids equal the cold run's; heartbeats lost so far "
          f"{len(lost)} ({smi})")
    return {"row": {"cold": cold, "warm": warm, "heartbeat_lost": len(lost)}, "ids": ids,
            "bytes": warm["wire_bytes"]["request_total"]}


def phase_P2(torch, M, cfg, params, prompt, prompt_ids, want, pipe, sup, smi) -> list:
    """(P2) kill -9 of each stage after P_KILL_AFTER decode tokens."""
    rows = []
    for victim in range(P_STAGES):
        t0 = time.perf_counter()
        rid = pipe.start(prompt)
        for _ in range(P_KILL_AFTER):
            check(pipe.step_once(rid) is not None, "(P2) request ended before the kill")
        proc = sup.proc(victim)
        proc.kill()  # SIGKILL: no drain, no flush
        proc.wait(timeout=30)
        n = 1 + P_KILL_AFTER
        while n < P_NEW and pipe.step_once(rid) is not None:
            n += 1
        ids = pipe.finish(rid)["tokens"]
        wall = time.perf_counter() - t0
        salvage = pipe.last_salvage()
        check(salvage.get("stage") == victim, f"(P2) last salvage {salvage}, victim {victim}")
        recomputed = salvage["tokens_recomputed"][rid]
        check(0 < recomputed < P_BLOCK,
              f"(P2) stage {victim}: {recomputed} tokens recomputed, not in (0, {P_BLOCK})")
        part = p_identity(f"(P2) stage {victim}", torch, M, cfg, params, prompt_ids, ids, want)
        p_slots_free(f"(P2) stage {victim}", pipe)
        row = {"victim": victim, "salvage_secs": salvage["secs"],
               "tokens_recomputed": recomputed, "request_wall_s": round(wall, 3),
               "parted": part}
        rows.append(row)
        print(f"(P2) kill -9 of stage {victim} after {P_KILL_AFTER} decode tokens: the request "
              f"completed ({len(ids)} tokens, {wall:.3f} s), salvage {salvage['secs']} s, "
              f"{recomputed} tokens recomputed (< {P_BLOCK}), ids "
              + ("equal the fault-free run's" if part is None else
                 f"part at token {part['at']}, top-2 gap {part['gap']} < {LOGITS_ATOL}")
              + f", every stage's slots free ({smi})")
    return rows


def phase_P3(SR, prompt, want, raw_bytes, sup, smi) -> dict:
    """(P3) the same request over the int8 wire (the stages quantize their
    replies when asked: no respawn)."""
    tr8 = p_transport(SR, "int8")
    pipe8 = SR.MPMDPipeline(sup, transport=tr8)
    t0 = time.perf_counter()
    ids = pipe8.generate(prompt, P_NEW)["tokens"]
    wall = time.perf_counter() - t0
    q_bytes = tr8.wire_bytes()
    check(0 < q_bytes < raw_bytes, f"(P3) int8 wire bytes {q_bytes}, raw {raw_bytes}")
    n = max(len(ids), len(want))
    match = sum(a == b for a, b in zip(ids, want)) / n
    act = tr8.links["stage-activation-dcn"]
    row = {"raw_bytes": raw_bytes, "int8_bytes": q_bytes,
           "ratio": round(raw_bytes / q_bytes, 3),
           "prefill_crossings": act[:2], "decode_crossings": act[2:4],
           "greedy_match_rate": round(match, 4), "first_parting": parts_at(ids, want),
           "wall_s": round(wall, 3)}
    # stage 0's reply answers a token window, which carries no X-Stage-Quant
    # header, so it ships fp32 (as in the JAX transport); the send to stage
    # 1 ships int8
    print(f"(P3) --wire-quant int8: dli_pp_wire_bytes_total{{path=\"stage\"}} {q_bytes:.0f} "
          f"against raw {raw_bytes:.0f} ({row['ratio']}x fewer); crossings (stage 0's "
          f"reply, the send to stage 1): prefill {row['prefill_crossings']}, decode "
          f"{row['decode_crossings']} bytes; greedy match rate against raw "
          f"{row['greedy_match_rate']} (first parting at {row['first_parting']}), "
          f"{wall:.3f} s ({smi})")
    return row


def phase_P4(pipe, base, smi) -> dict:
    """(P4) a rolling restart of both stages under 4 concurrent requests."""
    import threading

    bodies = [{"prompt": fleet_prompt(60 + i, n), "max_new_tokens": P4_NEW}
              for i, n in enumerate(P4_PROMPTS)]
    lone = []
    for body in bodies:
        code, out, _ = r_call(base, "/generate", body)
        check(code == 200, f"(P4) a request alone answered {code}: {out}")
        lone.append(out["tokens"])
    results = [None] * len(bodies)

    def run(i):
        results[i] = r_call(base, "/generate", bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while pipe.health()["active_requests"] < len(bodies):
        check(time.perf_counter() - t0 < 60, "(P4) the 4 requests never ran together")
        time.sleep(0.02)
    t_rr = time.perf_counter()
    code, report, rr_wall = r_call(base, "/admin/rolling-restart", {})
    for t in threads:
        t.join()
    check(code == 200, f"(P4) rolling restart answered {code}: {report}")
    check([r["stage"] for r in report["stages"]] == list(range(P_STAGES)),
          f"(P4) rolling restart report {report}")
    failed = [i for i, r in enumerate(results) if r[0] != 200]
    check(not failed, f"(P4) requests {failed} failed: {[results[i][1] for i in failed]}")
    differ = [i for i, r in enumerate(results) if r[1]["tokens"] != lone[i]]
    check(not differ, f"(P4) requests {differ} differ from their runs alone")
    p_slots_free("(P4)", pipe)
    row = {"rolling_restart_s": round(rr_wall, 3), "stages": report["stages"],
           "started_after_s": round(t_rr - t0, 3),
           "request_walls_s": [round(r[2], 3) for r in results]}
    print(f"(P4) rolling restart under {len(bodies)} concurrent requests (started "
          f"{row['started_after_s']} s after them): {rr_wall:.3f} s, per stage "
          f"{json.dumps(report['stages'])}; no request failed, each one's ids equal its run "
          f"alone; request walls {row['request_walls_s']} s ({smi})")
    return row


class PFleet:
    """(P)'s stage processes, started in a thread of their own (the
    controller's start_fleet: spawn, /ready, the heartbeat monitor) so that
    the reference is built while they start; `stop` reaps them."""

    def __init__(self):
        import os
        import tempfile
        import threading

        from distributed_llm_inference_tpu_torch.serving import stage_runtime as SR

        self.t0 = time.time()
        os.makedirs(P_DIR, exist_ok=True)
        self.restore_dir = tempfile.mkdtemp(prefix="chip_smoke_P_")
        self.sup = p_supervisor(SR, [SR.free_port() for _ in range(P_STAGES)],
                                self.restore_dir)
        self.tr = p_transport(SR)
        self.pipe = SR.MPMDPipeline(self.sup, transport=self.tr, auto_salvage=True)
        self.error, self.ready_s = None, None
        self.thread = threading.Thread(target=self._start, name="p-fleet-start")
        self.thread.start()

    def _start(self):
        try:
            self.pipe.start_fleet(ready_timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self.error = e
        self.ready_s = time.time() - self.t0

    def wait(self):
        self.thread.join()
        if self.error is not None:
            logs = "; ".join(f"stage{s}: " + open(f"{P_DIR}/stage{s}.log", errors="replace")
                             .read()[-1500:] for s in range(P_STAGES))
            raise SmokeFailure(f"(P) the stages did not start: {self.error}; {logs}")

    def stop(self):
        import shutil

        self.thread.join()
        self.pipe.shutdown()
        shutil.rmtree(self.restore_dir, ignore_errors=True)


def phase_P(torch, kernels, smi) -> dict:
    """The 2-stage pipeline of stage processes on the card, its controller
    and frontend in this process, against an in-process reference."""
    import threading

    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config
    from distributed_llm_inference_tpu_torch.serving import stage_runtime as SR
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    t0 = time.time()
    fleet = PFleet()
    sup, tr, pipe = fleet.sup, fleet.tr, fleet.pipe
    cfg = get_model_config(MODEL).replace(dtype=SR.CARD_DTYPE)
    srv = None
    try:
        # the reference is built while the stages start
        prompt = fleet_prompt(42, P_PROMPT)
        prompt_ids = ByteTokenizer().encode(prompt)
        check(len(prompt_ids) == P_PROMPT, f"(P) prompt of {len(prompt_ids)} tokens")
        params, ref, ref_walls = p_reference(torch, M, cfg, prompt_ids, P_NEW)
        check(len(ref) == P_NEW, f"(P) the reference ended at EOS after {len(ref)} tokens")
        full_bytes = sum(t.numel() * t.element_size() for t in
                         [params["embed"], params["final_norm"], params["lm_head"],
                          *params["layers"].values()])
        fleet.wait()
        mem = p_stage_memory(pipe, sup, kernels)
        for m in mem:
            check(m["reserved_bytes"] < 0.6 * full_bytes,
                  f"(P) stage {m['stage']} holds {m['reserved_bytes']} bytes of the card "
                  f"against the model's {full_bytes}: more than its half")
            check(m["kernel_library_mapped"] is not True,
                  f"(P) stage {m['stage']} mapped a kernel library")
        print(f"(P) {P_STAGES} stage processes of {MODEL} ({cfg.dtype}, seed 0, "
              f"--block-size {P_BLOCK}, --device {DEVICE}) ready {fleet.ready_s:.1f} s after "
              f"the spawn; the in-process reference's T=1 step over all "
              f"{cfg.n_layers} layers (warm) {json.dumps(p_ms(ref_walls[2:]))} ms; the "
              f"model's weights "
              f"{full_bytes / 2**30:.3f} GiB; per stage {json.dumps(mem)} ({smi})")
        port = SR.free_port()
        srv = SR.serve_frontend(pipe, port)
        threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        base = f"http://127.0.0.1:{port}"
        out = {"memory": mem}
        p1 = phase_P1(torch, M, cfg, params, ref, prompt, prompt_ids, pipe, tr, base, smi)
        out["P1"] = p1["row"]
        out["P2"] = phase_P2(torch, M, cfg, params, prompt, prompt_ids, p1["ids"], pipe,
                             sup, smi)
        del params
        torch.cuda.empty_cache()
        out["P3"] = phase_P3(SR, prompt, p1["ids"], p1["bytes"], sup, smi)
        out["P4"] = phase_P4(pipe, base, smi)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        fleet.stop()
    print(f"(P) took {time.time() - t0:.1f} s ({smi})")
    print("(P) " + json.dumps({"stage_pipeline": out}))
    return out


# -- the dp x pp x tp pipeline backend: phase (D) -----------------------------------

MESH_LANE_LOG = "build/chip_smoke_lane_{}.log"  # the lane of a mesh phase
D_SOLO_PROMPT = 100  # (D2)-(D4)'s solo prompt, prefilled as one T>1 chunk
D_SOLO_NEW = 16


def d_create(torch, mesh=None, **kw):
    """create_backend at (c)'s model, dtype and seed on the card (a mesh's
    ranks on cuda:0, round-robin over the one card)."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.runtime import create_backend

    kw.setdefault("attn_impl", "auto")
    return create_backend(MODEL, mesh_cfg=mesh or MeshConfig(), dtype="bfloat16",
                          seed=0, device=DEVICE, **kw)


def d_solo(torch, G, backend, prompt_ids, n_new=D_SOLO_NEW):
    """One greedy prefill of the prompt (one T>1 chunk) and n_new - 1
    decode steps: (ids, prefill logits)."""
    samp = G.default_sampling(greedy=True)
    T = len(prompt_ids)
    cache = backend.init_cache(1, T + n_new)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    first, logits, cache = backend.prefill(torch.tensor([prompt_ids], device=DEVICE), T,
                                           cache, gen, samp)
    out, n_gen, _ = backend.decode(first, cache, T, n_new - 1, gen, samp,
                                   max_steps=n_new - 1)
    torch.cuda.synchronize()
    return [int(first[0])] + out[0, : int(n_gen[0])].tolist(), logits.float()


def d_sum(counts: list) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def d_attention_events(prof: dict) -> dict:
    """A rank's profiled device kernels folded by attention kernel: the
    ragged walk (flash_walk.cuh's `walk` over a block table), the paged
    decode's split walk and its combine, the dense flash walk."""
    out = {"ragged_walk": 0, "decode_walk_split": 0, "decode_walk_combine": 0,
           "flash_walk_dense": 0, "other": 0}
    for name, n in prof.items():
        if "walk_split" in name:
            out["decode_walk_split"] += n
        elif "walk_combine" in name:
            out["decode_walk_combine"] += n
        elif "walk<" in name and "PAGED" in name.upper():
            out["ragged_walk"] += n
        elif "walk<" in name:
            out["flash_walk_dense"] += n
        else:
            out["other"] += n
    return out


def d_memory(backend) -> list:
    return [{"rank": r["rank"], "stage": r["stage"], "tp_rank": r["tp_rank"],
             "layers": f"{r['layers'][0]}-{r['layers'][-1] + 1}",
             "allocated_bytes": r.get("memory_allocated_bytes"), "status": r["status"]}
            for line in backend.health() for r in line["ranks"]]


def phase_D1(torch, M, pa, fa, Q, smi) -> dict:
    """The paged fleet of (g) over pp = 2 through the HTTP server, against
    the single-device fleet on the same weights."""
    import gc

    from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    which = range(len(FLEET_PROMPT_TOKENS))
    # greedy, and in the "batch" class, which the fleet never sheds: the
    # eager mesh's TTFT overruns the default class's 2 s target
    bodies = [{"prompt": fleet_prompt(i, FLEET_PROMPT_TOKENS[i]),
               "max_tokens": FLEET_NEW_TOKENS, "chat": False, "greedy": True,
               "slo_class": "batch"} for i in which]
    ecfg = EngineConfig(prefill_buckets=PREFILL_BUCKETS)
    # the single device's fleet: the reference ids; each fleet serves the
    # wave twice and the second, warm, is the one compared
    single = create_engine(MODEL, dtype="bfloat16", attn_impl="auto", seed=0,
                           device=DEVICE, engine_cfg=ecfg)
    cfg = single.cfg
    fleet, server = fleet_server(single, FLEET)
    try:
        serve_wave(server, bodies, pa, fa, Q)
        ref, ref_s, _, _, _ = serve_wave(server, bodies, pa, fa, Q)
    finally:
        server.shutdown()
        fleet.close()
    check_wave("(D1) single device", ref, which)
    del single, fleet, server
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    engine = create_engine(MODEL, dtype="bfloat16", attn_impl="auto", seed=0,
                           device=DEVICE, engine_cfg=ecfg, mesh_cfg=MeshConfig(pp=2))
    be = engine.backend
    print(f"(D1) {MODEL} over pp=2: ranks on {[str(d) for d in be.mesh.devices]}, "
          f"process-group backend {be.mesh.backend} (gloo where the ranks share a "
          f"card: NCCL refuses two ranks on one), built in {time.time() - t0:.1f} s; "
          f"memory per rank {json.dumps(d_memory(be))} ({smi})")
    want = "gloo" if torch.cuda.device_count() == 1 else "nccl"
    check(be.mesh.backend == want, f"(D1) backend {be.mesh.backend} on "
                                   f"{torch.cuda.device_count()} card(s)")
    fleet, server = fleet_server(engine, FLEET)
    try:
        serve_wave(server, bodies, pa, fa, Q)
        before = get(server.port, "/stats")[1]["continuous"]
        rag0 = ragged_launches(engine)
        be.launch_counts(reset=True)
        got, wave_s, _, _, after = serve_wave(server, bodies, pa, fa, Q)
        counts = be.launch_counts()
        rag = ragged_launches(engine) - rag0
        mem = d_memory(be)
        # a third wave under every rank's torch.profiler
        be.profile(True)
        _, prof_wave_s, _, _, _ = serve_wave(server, bodies, pa, fa, Q)
        prof = be.profile(False)
    finally:
        server.shutdown()
        fleet.close()
    check_wave("(D1) pp=2", got, which)
    L = engine.cfg.n_layers
    per_rank = L // 2
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    steps = after["chunk_steps"]
    for r, c in enumerate(counts):
        check(c["ragged_paged_attend"] == per_rank * rag > 0,
              f"(D1) rank {r}: ragged_paged_attend {c['ragged_paged_attend']} for {rag} "
              f"ragged launches of {per_rank} layers")
        check(c["paged_flash_attend"] == per_rank * steps * chunks > 0,
              f"(D1) rank {r}: paged_flash_attend {c['paged_flash_attend']} for {chunks} "
              f"decode chunks of {steps} steps x {per_rank} layers")
    events = [d_attention_events(p["kernels"]) for p in prof["ranks"]]
    for r, e in enumerate(events):
        check(e["ragged_walk"] > 0 and e["decode_walk_split"] > 0,
              f"(D1) rank {r}'s profiler saw no paged attention kernel: {e}")
    print(f"(D1) the profiled wave's device kernels by rank, most launched first: "
          + json.dumps([sorted(p["kernels"].items(), key=lambda kv: -kv[1])[:8]
                        for p in prof["ranks"]]))
    drv = prof["driver"]
    split = {"wave_s": prof_wave_s, "programs": drv.get("programs", 0),
             "input_bytes_per_program": drv.get("input_bytes", 0) / max(1, drv.get("programs", 0)),
             "driver_send_s": drv.get("send_s", 0.0), "driver_shard_s": drv.get("shard_s", 0.0),
             "driver_wait_s": drv.get("wait_s", 0.0),
             "ranks": [{"rank": r, "busy_ms": p["busy_ms"], "wall_ms": p["wall_ms"],
                        "busy_share": p["busy_ms"] / p["wall_ms"], "comm_s": p["comm_s"]}
                       for r, p in enumerate(prof["ranks"])]}
    print(f"(D1) where the profiled wave's time goes: programs and pipe bytes on the "
          f"driver, each rank's device busy time (the union of its kernels) and host "
          f"seconds inside each collective {json.dumps(split)} ({smi})")
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    parted, params = [], None
    for i, ((_, w, _), (_, g, _)) in enumerate(zip(ref, got)):
        if g["token_ids"] != w["token_ids"]:
            if params is None:  # the reference's weights, from the same seed
                params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
            ids = ByteTokenizer().encode(bodies[i]["prompt"])
            p = p_identity(f"(D1) request {i}", torch, M, cfg, params, ids,
                           g["token_ids"], w["token_ids"])
            worst = p_forced(f"(D1) request {i}", torch, M, cfg, params, ids,
                             g["token_ids"], p["at"])
            parted.append({"request": i, **p, "forced_worst": round(worst, 4)})
    del params
    torch.cuda.empty_cache()
    n_tok = sum(r["tokens_generated"] for _, r, _ in got)
    ttft = [r["ttft_s"] for _, r, _ in got]
    print(f"(D1) pp=2 fleet wave: {n_tok} tokens from {len(got)} requests in "
          f"{wave_s:.3f} s = {n_tok / wave_s:.2f} tokens/s aggregate (single device "
          f"{sum(r['tokens_generated'] for _, r, _ in ref) / ref_s:.2f}); ttft_s "
          f"{json.dumps(ttft)}; greedy ids equal the single device's for "
          f"{len(got) - len(parted)} of {len(got)} requests, parted at a near tie, "
          f"every later token near-top under teacher forcing "
          f"{json.dumps(parted)}; ragged launches {rag}, decode chunks {chunks}; per-rank "
          f"launches {json.dumps(counts)}; per-rank profiler attention kernels "
          f"{json.dumps(events)}; wire bytes {json.dumps(dict(be.wire_bytes))}; memory "
          f"per rank {json.dumps(mem)} ({smi})")
    out = {"engine": engine, "launches": counts,
           "row": {"tokens_per_s": n_tok / wave_s, "single_tokens_per_s":
                   sum(r["tokens_generated"] for _, r, _ in ref) / ref_s,
                   "ttft_s": ttft, "parted": parted, "ragged_launches": rag,
                   "decode_chunks": chunks, "memory": mem, "profiler": events,
                   "time_split": split}}
    return out


def phase_D2(torch, G, smi) -> dict:
    """Solo prefill and decode at tp = 2: the kernel logits against the
    single device's plain path, flash_attend n_layers times per rank."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    from distributed_llm_inference_tpu_torch.models import api as M

    ids = ByteTokenizer().encode(fleet_prompt(77, D_SOLO_PROMPT))
    pcfg, plain = d_create(torch, attn_impl="plain")
    want, want_lg = d_solo(torch, G, plain, ids)
    t0 = time.time()
    cfg, be = d_create(torch, MeshConfig(tp=2))
    try:
        print(f"(D2) {MODEL} over tp=2 (local heads {cfg.n_heads // 2}/{cfg.n_kv_heads // 2} "
              f"per rank, group {cfg.n_heads // cfg.n_kv_heads}), attn_impl={cfg.attn_impl}, "
              f"backend {be.mesh.backend}, built in {time.time() - t0:.1f} s")
        be.launch_counts(reset=True)
        got, lg = d_solo(torch, G, be, ids)
        counts = be.launch_counts()
        mem = d_memory(be)
    finally:
        be.close()
    err = float((lg - want_lg).abs().max())
    for r, c in enumerate(counts):
        check(c["flash_attend"] == cfg.n_layers,
              f"(D2) rank {r}: flash_attend {c['flash_attend']} for one T>1 chunk of "
              f"{cfg.n_layers} layers")
    check(err < LOGITS_ATOL, f"(D2) tp=2 kernel logits vs plain: max abs err {err}")
    at = p_identity("(D2) tp=2", torch, M, pcfg, plain.params, ids, got, want)
    del plain
    torch.cuda.empty_cache()
    print(f"(D2) tp=2 solo: prefill logits vs the single device's plain path max abs err "
          f"{err:.4f} (atol {LOGITS_ATOL}); greedy ids "
          + ("equal" if at is None else f"part at a near tie {json.dumps(at)}")
          + f"; per-rank launches {json.dumps(counts)}; memory {json.dumps(mem)} ({smi})")
    return {"launches": counts, "row": {"max_abs_err": err, "parts_at": at}}


def phase_D3(torch, G, raw_backend, smi) -> dict:
    """(D1)'s pp = 2 backend on one solo request against the single device
    on the card (its prefill logits within LOGITS_ATOL, its ids equal or
    parted at a near tie and near-top after it), then --pp-wire-quant int8
    against that raw wire: the bytes each path shipped."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    ids = ByteTokenizer().encode(fleet_prompt(78, D_SOLO_PROMPT))
    scfg, single = d_create(torch)
    want, want_lg = d_solo(torch, G, single, ids)
    raw_backend.wire_bytes.clear()
    raw_ids, raw_lg = d_solo(torch, G, raw_backend, ids)
    raw = dict(raw_backend.wire_bytes)
    err = float((raw_lg - want_lg).abs().max())
    check(err < LOGITS_ATOL, f"(D3) pp=2 prefill logits vs the single device's: max abs "
                             f"err {err}")
    at = p_identity("(D3) pp=2", torch, M, scfg, single.params, ids, raw_ids, want)
    if at is not None:
        at["forced_worst"] = round(p_forced("(D3) pp=2", torch, M, scfg, single.params, ids,
                                            raw_ids, at["at"]), 4)
    del single
    torch.cuda.empty_cache()
    print(f"(D3) pp=2 solo ({D_SOLO_PROMPT}-token prompt): prefill logits vs the single "
          f"device's on the card max abs err {err:.4f} (atol {LOGITS_ATOL}); greedy ids "
          + ("equal" if at is None else f"part at a near tie {json.dumps(at)}")
          + f" ({smi})")
    cfg, be = d_create(torch, MeshConfig(pp=2), wire_quant="int8")
    try:
        q_ids, _ = d_solo(torch, G, be, ids)
        q = dict(be.wire_bytes)
    finally:
        be.close()
    D = cfg.dim
    rows = D_SOLO_PROMPT + len(raw_ids) - 1  # the chunk's rows, then one per step
    check(raw["microstep"] == rows * 2 * D and q["microstep"] == rows * (D + 4),
          f"(D3) microstep bytes raw {raw['microstep']} int8 {q['microstep']} for {rows} rows")
    print(f"(D3) one solo request ({D_SOLO_PROMPT}-token prompt, {len(raw_ids)} tokens) at "
          f"pp=2: wire bytes raw {json.dumps(raw)}, int8 {json.dumps(q)} "
          f"(x{raw['microstep'] / q['microstep']:.3f} fewer on the hand-off); greedy ids "
          + ("equal" if raw_ids == q_ids else f"part at token {parts_at(raw_ids, q_ids)}")
          + f" ({smi})")
    return {"raw": raw, "int8": q, "pp2_vs_single": {"max_abs_err": err, "parts_at": at}}


def phase_D4(torch, G, smi) -> dict:
    """A one-rank NCCL mesh through the same backend: its process group is
    built and its collectives run on the card."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig, resolve_attn_impl
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config
    from distributed_llm_inference_tpu_torch.parallel.mesh import build_mesh
    from distributed_llm_inference_tpu_torch.parallel.pipeline import PipelineBackend
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    ids = ByteTokenizer().encode(fleet_prompt(79, D_SOLO_PROMPT))
    _, single = d_create(torch)
    want, want_lg = d_solo(torch, G, single, ids)
    del single
    cfg = resolve_attn_impl(get_model_config(MODEL).replace(dtype="bfloat16"), "auto",
                            torch.device(DEVICE))
    mesh = build_mesh(MeshConfig(), [torch.device("cuda", 0)])
    be = PipelineBackend(cfg, None, mesh, seed=0)
    try:
        got, lg = d_solo(torch, G, be, ids)
    finally:
        be.close()
    err = float((lg - want_lg).abs().max())
    check(mesh.backend == "nccl", f"(D4) a one-rank mesh on cuda:0 chose {mesh.backend}")
    check(got == want and err < LOGITS_ATOL,
          f"(D4) the one-rank NCCL mesh: ids part at {parts_at(got, want)}, logits err {err}")
    print(f"(D4) a one-rank mesh on cuda:0: process-group backend {mesh.backend}, its "
          f"embed sum, broadcast and logits gather run through NCCL; greedy ids equal the "
          f"single device's, prefill logits max abs err {err:.6f} ({smi})")
    out = {"backend": mesh.backend, "max_abs_err": err}
    cards = torch.cuda.device_count()
    if cards == 1:
        print("(D4) one card: a mesh of ranks on cards of their own (NCCL across "
              "ranks) is not run here")
        return out
    # ranks on cards of their own: pp = 2 x tp = 2 over four cards (pp = 2 on two)
    shape = MeshConfig(pp=2, tp=2) if cards >= 4 else MeshConfig(pp=2)
    mesh = build_mesh(shape, [torch.device("cuda", i) for i in range(shape.n_devices)])
    be = PipelineBackend(cfg, None, mesh, seed=0)
    try:
        got, lg = d_solo(torch, G, be, ids)
        mem = d_memory(be)
    finally:
        be.close()
    err = float((lg - want_lg).abs().max())
    check(mesh.backend == "nccl", f"(D4) ranks on {cards} cards chose {mesh.backend}")
    check(err < LOGITS_ATOL, f"(D4) the {shape} NCCL mesh: logits err {err}")
    print(f"(D4) {shape} over {shape.n_devices} cards, NCCL across ranks: prefill "
          f"logits max abs err {err:.4f}; greedy ids "
          + ("equal" if got == want else f"part at token {parts_at(got, want)}")
          + f"; memory {json.dumps(mem)} ({smi})")
    out["multi_rank"] = {"mesh": str(shape), "max_abs_err": err,
                         "parts_at": parts_at(got, want)}
    return out


def phase_D(torch, kernels, smi) -> dict:
    """(D1)-(D4): the pipeline backend on the card."""
    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.ops import flash_attention as fa
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    t0 = time.time()
    d1 = phase_D1(torch, M, pa, fa, Q, smi)
    engine = d1.pop("engine")
    try:
        d2 = phase_D2(torch, G, smi)
        d3 = phase_D3(torch, G, engine.backend, smi)
    finally:
        engine.backend.close()
    d4 = phase_D4(torch, G, smi)
    launches = d_sum(d1["launches"] + d2["launches"])
    print(f"(D) took {time.time() - t0:.1f} s ({smi})")
    print("(D) " + json.dumps({"pipeline": {"D1": d1["row"], "D2": d2["row"], "D3": d3,
                                            "D4": d4}}))
    return launches


# -- part B of the mesh: the 1F1B schedule (M), the context ring (L), the
# expert mesh (E) -------------------------------------------------------------------

# the mesh phases: the full run starts each in a process of its own
# (`--only X`), side by side
MESH_PHASES = ("D", "M", "L", "E", "N", "H")
# (M)'s batch: (g)'s eight prompts (8 to 700 tokens) left-padded into one
# bucket of 1024, FLEET_NEW_TOKENS new tokens each, greedy
M_BUCKETS = (64, 128, 256, 512, 1024)
M_MICROBATCHES = 2
M_SERVER = ["--model", MODEL, "--dtype", "bfloat16", "--device", DEVICE,
            "--attn-impl", "auto", "--seed", "0", "--pp", "2",
            "--microbatches", str(M_MICROBATCHES)]
# (L)'s long prompt at sp = 2 (768 positions a rank), its shorter request at
# sp = 2 x pp = 2, and the new tokens of both
L_PROMPT = 1536
L_SHORT = 512
L_NEW = 32
# (E): qwen3-30b-a3b at ep = 2; its logits held in fp32 at F_MOE_FP32_LAYERS
# layers, its served wave in bf16 at F_MOE_LANE_LAYERS of 48
E_EP = 2


def mesh_create(torch, model=MODEL, mesh=None, dtype="bfloat16", **kw):
    """create_backend on the card from seed 0 (a mesh's ranks round-robin
    over the cards: on one card they share it over gloo)."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.runtime import create_backend

    kw.setdefault("attn_impl", "auto")
    return create_backend(model, mesh_cfg=mesh or MeshConfig(), dtype=dtype, seed=0,
                          device=DEVICE, **kw)


def m_batch(torch, cfg):
    """(g)'s eight prompts as one left-padded batch: (tokens [8, 1024],
    valid_start [8], the prompts' texts)."""
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    texts = [fleet_prompt(i, n) for i, n in enumerate(FLEET_PROMPT_TOKENS)]
    ids = [ByteTokenizer().encode(t) for t in texts]
    bucket = M_BUCKETS[-1]
    rows = [[cfg.pad_token_id] * (bucket - len(r)) + r for r in ids]
    return (torch.tensor(rows, device=DEVICE),
            torch.tensor([bucket - len(r) for r in ids], dtype=torch.int32, device=DEVICE),
            texts)


def m_ids(torch, G, backend, tokens, valid_start, n_new=FLEET_NEW_TOKENS):
    """The batch's greedy prefill and n_new - 1 decode steps through the
    backend's own methods: (ids per row, prefill logits [8, V] fp32)."""
    samp = G.default_sampling(greedy=True)
    B, T = tokens.shape
    cache = backend.init_cache(B, T + n_new)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    first, logits, cache = backend.prefill(tokens, T, cache, gen, samp, valid_start)
    out, n_gen, _ = backend.decode(first, cache, T, n_new - 1, gen, samp, valid_start,
                                   max_steps=n_new - 1)
    torch.cuda.synchronize()
    first, out, n_gen = first.tolist(), out.tolist(), n_gen.tolist()
    return [[first[b]] + out[b][:n_gen[b]] for b in range(B)], logits.float()


def m_engine(torch, microbatches, mesh):
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    return create_engine(MODEL, dtype="bfloat16", attn_impl="auto", seed=0, device=DEVICE,
                         engine_cfg=EngineConfig(prefill_buckets=M_BUCKETS),
                         mesh_cfg=mesh, microbatches=microbatches)


def m_serve(torch, engine, texts, tag, smi) -> dict:
    """generate_batch of the eight prompts: a warm call, a timed call (the
    kernels' counts from 0 just before it), then a call under every rank's
    profiler. Returns the row of numbers."""
    kw = dict(max_tokens=FLEET_NEW_TOKENS, greedy=True, chat=False)
    r = engine.generate_batch(texts, **kw)
    check(r["status"] == "success", f"{tag} warm batch: {r}")
    be = engine.backend
    mesh = hasattr(be, "launch_counts")
    if mesh:
        be.launch_counts(reset=True)
    t0 = time.perf_counter()
    r = engine.generate_batch(texts, **kw)
    wall = time.perf_counter() - t0
    check(r["status"] == "success" and len(r["results"]) == len(texts), f"{tag} batch: {r}")
    n_tok = r["tokens_generated"]
    row = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall, "ttft_s": r["ttft_s"]}
    if not mesh:
        return row
    row["launches"] = be.launch_counts()
    be.profile(True)
    t0 = time.perf_counter()
    engine.generate_batch(texts, **kw)
    prof_wall = time.perf_counter() - t0
    prof = be.profile(False)
    row["profiled_wall_s"] = prof_wall
    # nccl_ms: the NCCL kernels' union (0 over gloo); under NCCL a rank
    # that awaits its peer does so in such a kernel, counted busy
    row["ranks"] = [{"rank": i, "busy_ms": p["busy_ms"], "nccl_ms": p["nccl_ms"],
                     "wall_ms": p["wall_ms"], "busy_share": p["busy_ms"] / p["wall_ms"],
                     "collective_s": sum(p["comm_s"].values()), "comm_s": p["comm_s"]}
                    for i, p in enumerate(prof["ranks"])]
    row["driver"] = prof["driver"]
    print(f"{tag} generate_batch of {len(texts)} prompts ({min(FLEET_PROMPT_TOKENS)}-"
          f"{max(FLEET_PROMPT_TOKENS)} tokens, {FLEET_NEW_TOKENS} new, greedy): {n_tok} "
          f"tokens in {wall:.3f} s = {n_tok / wall:.2f} tokens/s (ttft {r['ttft_s']} s); "
          f"per-rank launches {json.dumps(row['launches'])}; the profiled batch's ranks "
          f"(device busy share, NCCL kernels' ms, host seconds in collectives) "
          f"{json.dumps(row['ranks'])} "
          f"({smi})")
    return row


def phase_M(torch, G, M, smi) -> dict:
    """(M) the 1F1B schedule at pp = 2 with M = 2 against the plain pp = 2
    pipeline and the single device on (g)'s eight prompts as one batch:
    prefill logits, greedy ids, tokens/s, each rank's busy share and host
    seconds in collectives; then one batch through the server's CLI."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig

    t_phase = time.time()
    single = m_engine(torch, 1, MeshConfig())
    cfg = single.cfg
    tokens, vs, texts = m_batch(torch, cfg)
    want, want_lg = m_ids(torch, G, single.backend, tokens, vs)
    single_row = m_serve(torch, single, texts, "(M) single device", smi)
    params = single.backend.params
    rows, runs = {}, {}
    for name, mb in (("pp2", 1), ("pp2_1f1b", M_MICROBATCHES)):
        t0 = time.time()
        engine = m_engine(torch, mb, MeshConfig(pp=2))
        be = engine.backend
        try:
            tag = f"(M) {name}"
            print(f"{tag}: {MODEL} bf16 over pp=2, microbatches={mb}, backend {be.name}, "
                  f"built in {time.time() - t0:.1f} s")
            if mb > 1:
                check(be.name == "pipeline-1f1b" and be.batch_granularity == mb,
                      f"{tag}: selected {be.name}")
                be.return_prefill_logits = True
            got, lg = m_ids(torch, G, be, tokens, vs)
            if mb > 1:
                be.return_prefill_logits = False
            rows[name] = m_serve(torch, engine, texts, tag, smi)
            runs[name] = (got, lg)
            per_rank = cfg.n_layers // 2
            for r, c in enumerate(rows[name]["launches"]):
                # the batch's one T>1 chunk a microbatch, per layer of the rank
                check(c["flash_attend"] == per_rank * mb,
                      f"{tag} rank {r}: flash_attend {c['flash_attend']} for {mb} "
                      f"microbatch chunks of {per_rank} layers")
            rows[name]["memory"] = d_memory(be)
        finally:
            be.close()
        del engine, be
        f_free(torch)
    (plain_ids, plain_lg), (f1b_ids, f1b_lg) = runs["pp2"], runs["pp2_1f1b"]
    err = float((f1b_lg - plain_lg).abs().max())
    err_single = float((f1b_lg - want_lg).abs().max())
    check(err < LOGITS_ATOL, f"(M) 1F1B prefill logits vs the plain pp=2 run's: {err}")
    check(err_single < LOGITS_ATOL, f"(M) 1F1B prefill logits vs the single device's: "
                                    f"{err_single}")
    parted = []
    for i, (g, w) in enumerate(zip(f1b_ids, plain_ids)):
        if g != w:
            ids = tokens[i, int(vs[i]):].tolist()
            p = p_identity(f"(M) row {i}", torch, M, cfg, params, ids, g, w)
            p["forced_worst"] = round(p_forced(f"(M) row {i}", torch, M, cfg, params, ids,
                                               g, p["at"]), 4)
            parted.append({"row": i, **p})
    same_single = sum(g == w for g, w in zip(f1b_ids, want))
    print(f"(M) 1F1B vs plain pp=2: prefill logits max abs err {err:.4f}, vs the single "
          f"device's {err_single:.4f} (atol {LOGITS_ATOL}); greedy ids equal the plain "
          f"run's for {len(f1b_ids) - len(parted)} of {len(f1b_ids)} rows, parted at a "
          f"near tie, every later token near-top under teacher forcing "
          f"{json.dumps(parted)}; equal the single device's for {same_single} ({smi})")
    # one batch through the server's CLI with --pp 2 --microbatches 2; the
    # CLI closes its backend when serving returns, which is at once here, so
    # the close waits until the batch was served
    from distributed_llm_inference_tpu_torch.serving import server as S

    t0 = time.time()
    close = S._close_backend
    S._close_backend = lambda engine: None
    try:
        server = f_cli_server(M_SERVER)
    finally:
        S._close_backend = close
    try:
        be = server.engine.backend
        check(be.name == "pipeline-1f1b", f"(M) the server's backend is {be.name}")
        be.launch_counts(reset=True)
        code, r, _ = post(server.port, {"prompts": texts[:2], "max_tokens": 8, "greedy": True,
                                     "chat": False})
        counts = be.launch_counts()
    finally:
        server.shutdown()
        close(server.engine)
    check(code == 200 and r.get("status") == "success"
          and r.get("backend") == "pipeline-1f1b" and len(r["results"]) == 2,
          f"(M) the server's batch: HTTP {code} {r}")
    check(all(c["flash_attend"] > 0 for c in counts), f"(M) server launches {counts}")
    print(f"(M) the server's CLI {' '.join(M_SERVER)}: a batch of 2 prompts answered "
          f"HTTP {code}, backend {r['backend']}, {r['tokens_generated']} tokens, per-rank "
          f"launches {json.dumps(counts)}; up and served in {time.time() - t0:.1f} s")
    del single, params
    f_free(torch)
    out = {"single": single_row, **rows, "logits_err": err, "logits_err_single": err_single,
           "parted": parted}
    print(f"(M) took {time.time() - t_phase:.1f} s")
    print("(M) " + json.dumps({"1f1b": out}))
    return {"launches": d_sum(rows["pp2_1f1b"]["launches"]), "row": out}


def l_solo(torch, G, backend, prompt_ids, n_new=L_NEW):
    """One greedy request through the backend: (ids, prefill logits, the
    device memory its cache took on each rank)."""
    samp = G.default_sampling(greedy=True)
    T = len(prompt_ids)
    mesh = hasattr(backend, "mesh")

    def used():
        if mesh:
            return [r.get("memory_allocated_bytes", 0) for ln in backend.health()
                    for r in ln["ranks"]]
        torch.cuda.synchronize()
        return [torch.cuda.memory_allocated()]

    before = used()
    cache = backend.init_cache(1, T + n_new)
    cache_bytes = [a - b for a, b in zip(used(), before)]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    first, logits, cache = backend.prefill(torch.tensor([prompt_ids], device=DEVICE), T,
                                           cache, gen, samp)
    out, n_gen, _ = backend.decode(first, cache, T, n_new - 1, gen, samp,
                                   max_steps=n_new - 1)
    torch.cuda.synchronize()
    return [int(first[0])] + out[0, : int(n_gen[0])].tolist(), logits.float(), cache_bytes


def phase_L(torch, G, M, smi) -> dict:
    """(L) context parallelism: the 1536-token prompt at sp = 2 with the
    ring and with Ulysses (and the ring's int8 wire), then a 512-token
    request at sp = 2 x pp = 2, each against the single device."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.time()
    out = {}
    for T, meshes in ((L_PROMPT, [("ring", MeshConfig(sp=2), "ring", None),
                                  ("ulysses", MeshConfig(sp=2), "ulysses", None),
                                  ("ring_int8_wire", MeshConfig(sp=2), "ring", "int8")]),
                      (L_SHORT, [("sp2_pp2", MeshConfig(sp=2, pp=2), "ring", None)])):
        ids = ByteTokenizer().encode(fleet_prompt(80 + T, T))
        check(len(ids) == T, f"(L) the prompt has {len(ids)} tokens, not {T}")
        cfg, single = mesh_create(torch)
        t0 = time.perf_counter()
        want, want_lg, single_kv = l_solo(torch, G, single, ids)
        single_s = time.perf_counter() - t0
        for name, mesh, strategy, wire in meshes:
            t0 = time.time()
            cfg, be = mesh_create(torch, mesh=mesh, sp_strategy=strategy, wire_quant=wire)
            tag = f"(L) {name}"
            try:
                print(f"{tag}: {MODEL} bf16, {mesh}, sp_strategy={strategy}, "
                      f"pp_wire_quant={wire}, backend {be.name}, built in "
                      f"{time.time() - t0:.1f} s; {be.local_slots(T + L_NEW)} cache slots "
                      f"a rank for {T + L_NEW} positions")
                be.launch_counts(reset=True)
                be.wire_bytes.clear()
                t0 = time.perf_counter()
                got, lg, kv = l_solo(torch, G, be, ids)
                wall = time.perf_counter() - t0
                counts = be.launch_counts()
                wire_bytes = dict(be.wire_bytes)
                mem = d_memory(be)
            finally:
                be.close()
            del be
            f_free(torch)
            err = float((lg - want_lg).abs().max())
            check(err < LOGITS_ATOL, f"{tag}: prefill logits vs the single device's: {err}")
            at = p_identity(tag, torch, M, cfg, single.params, ids, got, want)
            if at is not None:
                at["forced_worst"] = round(p_forced(tag, torch, M, cfg, single.params, ids,
                                                    got, at["at"]), 4)
            # the ring's attention is plain PyTorch: no kernel on any rank
            check(all(sum(c.values()) == 0 for c in counts),
                  f"{tag}: the context path launched kernels {counts}")
            row = {"prompt_tokens": T, "new_tokens": len(got), "wall_s": wall,
                   "tokens_per_s": len(got) / wall, "single_wall_s": single_s,
                   "logits_err": err, "parts_at": at, "wire_bytes": wire_bytes,
                   "cache_bytes_per_rank": kv, "single_cache_bytes": single_kv[0],
                   "memory": mem}
            out[name] = row
            print(f"{tag}: prefill logits vs the single device's max abs err {err:.4f} "
                  f"(atol {LOGITS_ATOL}); greedy ids "
                  + ("equal" if at is None else f"part at a near tie {json.dumps(at)}")
                  + f"; {len(got)} tokens in {wall:.3f} s (single device {single_s:.3f} s); "
                  f"wire bytes {json.dumps(wire_bytes)}; the cache's device bytes per rank "
                  f"{kv} against the single device's {single_kv[0]}; per-rank launches "
                  f"{json.dumps(counts)}; memory per rank {json.dumps(mem)} ({smi})")
        del single
        f_free(torch)
    raw, q = out["ring"]["wire_bytes"]["sp"], out["ring_int8_wire"]["wire_bytes"]["sp"]
    print(f"(L) the sp link at {L_PROMPT} tokens: {raw} bytes raw, {q} int8 "
          f"(x{raw / q:.3f} fewer); Ulysses {out['ulysses']['wire_bytes'].get('sp')}")
    print(f"(L) took {time.time() - t_phase:.1f} s")
    print("(L) " + json.dumps({"context": out}))
    return {"row": out}


def phase_E(torch, G, M, pa, fa, Q, smi) -> dict:
    """(E) qwen3-30b-a3b over ep = 2 (64 of 128 experts a rank): its
    logits in fp32 at F_MOE_FP32_LAYERS layers against the single device's,
    then a served wave in bf16 at F_MOE_LANE_LAYERS layers through the
    HTTP server, each rank's kernel counts, memory and expert ms."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.time()
    base = get_model_config(F_MOE).replace(max_seq_len=F_MOE_MAX_SEQ)
    ids = ByteTokenizer().encode(fleet_prompt(81, D_SOLO_PROMPT))
    cfg32 = base.replace(n_layers=F_MOE_FP32_LAYERS)
    scfg, single = mesh_create(torch, cfg32, dtype="float32")
    want, want_lg = d_solo(torch, G, single, ids)
    t0 = time.time()
    cfg, be = mesh_create(torch, cfg32, MeshConfig(ep=E_EP), dtype="float32")
    try:
        print(f"(E) {F_MOE} fp32 at {cfg.n_layers} layers over ep={E_EP}: "
              f"{cfg.n_experts // E_EP} of {cfg.n_experts} experts a rank, built in "
              f"{time.time() - t0:.1f} s")
        be.launch_counts(reset=True)
        got, lg = d_solo(torch, G, be, ids)
        solo_counts = be.launch_counts()
        mem32 = d_memory(be)
    finally:
        be.close()
    err = float((lg - want_lg).abs().max())
    check(err < F_FP32_LOGITS_ATOL, f"(E) ep=2 fp32 logits vs the single device's: {err}")
    at = p_identity("(E) fp32", torch, M, scfg, single.params, ids, got, want)
    for r, c in enumerate(solo_counts):
        check(c["flash_attend"] == cfg.n_layers,
              f"(E) fp32 rank {r}: flash_attend {c['flash_attend']} for one T>1 chunk")
    # a rank's Stage and its parameter tree refer to each other: the
    # collector, not the last reference, frees the driver's shard
    del single, be
    f_free(torch)
    print(f"(E) ep=2 fp32: prefill logits vs the single device's max abs err {err:.2e} "
          f"(atol {F_FP32_LOGITS_ATOL}); greedy ids "
          + ("equal" if at is None else f"part at a near tie {json.dumps(at)}")
          + f"; per-rank launches {json.dumps(solo_counts)}; memory {json.dumps(mem32)} "
          f"({smi})")
    # the served wave in bf16
    t0 = time.time()
    engine = create_engine(base.replace(n_layers=F_MOE_LANE_LAYERS), dtype="bfloat16",
                           attn_impl="auto", seed=0, device=DEVICE,
                           engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS),
                           mesh_cfg=MeshConfig(ep=E_EP))
    be = engine.backend
    L = engine.cfg.n_layers
    print(f"(E) {F_MOE} bf16 at {L} of 48 layers over ep={E_EP}, built in "
          f"{time.time() - t0:.1f} s; memory per rank {json.dumps(d_memory(be))}")
    which = range(len(FLEET_PROMPT_TOKENS))
    bodies = [{"prompt": fleet_prompt(i, FLEET_PROMPT_TOKENS[i]),
               "max_tokens": FLEET_NEW_TOKENS, "chat": False, "greedy": True,
               "slo_class": "batch"} for i in which]
    fleet, server = fleet_server(engine, FLEET)
    try:
        before = get(server.port, "/stats")[1]["continuous"]
        rag0 = ragged_launches(engine)
        be.launch_counts(reset=True)
        got, wave_s, _, _, after = serve_wave(server, bodies, pa, fa, Q)
        counts = be.launch_counts()
        rag = ragged_launches(engine) - rag0
        mem = d_memory(be)
        be.profile(True)
        _, prof_s, _, _, _ = serve_wave(server, bodies, pa, fa, Q)
        prof = be.profile(False)
    finally:
        server.shutdown()
        fleet.close()
        be.close()
    check_wave("(E) ep=2", got, which)
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    steps = after["chunk_steps"]
    for r, c in enumerate(counts):
        # ep splits the experts, not the layers: every rank runs every layer
        check(c["ragged_paged_attend"] == L * rag > 0,
              f"(E) rank {r}: ragged_paged_attend {c['ragged_paged_attend']} for {rag} "
              f"ragged launches of {L} layers")
        check(c["paged_flash_attend"] == L * steps * chunks > 0,
              f"(E) rank {r}: paged_flash_attend {c['paged_flash_attend']} for {chunks} "
              f"decode chunks of {steps} steps x {L} layers")
    ranks = [{"rank": r, "experts_ms": p["experts_ms"], "busy_ms": p["busy_ms"],
              "wall_ms": p["wall_ms"], "busy_share": p["busy_ms"] / p["wall_ms"],
              "collective_s": sum(p["comm_s"].values())}
             for r, p in enumerate(prof["ranks"])]
    n_tok = sum(r["tokens_generated"] for _, r, _ in got)
    print(f"(E) ep=2 bf16 wave: {n_tok} tokens from {len(got)} requests in {wave_s:.3f} s "
          f"= {n_tok / wave_s:.2f} tokens/s aggregate; ragged launches {rag}, decode "
          f"chunks {chunks}; per-rank launches {json.dumps(counts)}; the profiled wave "
          f"({prof_s:.3f} s) per rank: the expert products' device ms, busy share, host "
          f"seconds in collectives {json.dumps(ranks)}; memory per rank {json.dumps(mem)}; "
          f"wire bytes {json.dumps(dict(be.wire_bytes))} ({smi})")
    del engine
    f_free(torch)
    out = {"fp32": {"layers": F_MOE_FP32_LAYERS, "logits_err": err, "parts_at": at,
                    "memory": mem32},
           "wave": {"layers": L, "tokens_per_s": n_tok / wave_s, "ranks": ranks,
                    "ragged_launches": rag, "decode_chunks": chunks, "memory": mem}}
    print(f"(E) took {time.time() - t_phase:.1f} s")
    print("(E) " + json.dumps({"experts": out}))
    return {"launches": d_sum(solo_counts + counts), "row": out}


# -- part C of the mesh: the solo surface, adapters and the sharded store on
# the pp ring (N), two server processes (H) ------------------------------------------

N_TOKENS = 100  # (N1)'s prompt: one T>1 prefill chunk
N_NEW = 16
N_BEAMS = 3
N_DRAFT_LAYERS = 2  # (N1)'s draft: tinyllama's widths, 2 layers
N_TP_NEW = 8  # (N2)'s tp = 2 adapter request (a tp step is 44 host sums)
N_DIR = "build/chip_smoke_n"  # (N2)'s adapters and (N3)'s store (gitignored)
N_SERVER = ["--attn-impl", "auto", "--continuous", str(FLEET["n_slots"]),
            "--kv-pool-blocks", str(FLEET["kv_pool_blocks"]), "--kv-block-size", str(BLOCK),
            "--continuous-max-seq", str(FLEET["slot_max_seq"]), "--max-tokens-cap", "64"]
H_NEW = 8  # (H)'s request: fp32, its tokens pinned by their logprobs
H_SHUTDOWN_S = 60.0  # process 0's bounded exit after SIGTERM, process 1's after it


def n_tokenizer(cfg):
    """(y)'s tokenizer: its decode spells every id, so a response is its ids."""
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    class SpelledIds(ByteTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    return SpelledIds(cfg.pad_token_id, cfg.bos_token_id, cfg.eos_token_id)


def n_engine(mesh=None, **ecfg):
    """tinyllama-1.1b, bf16, seed 0, the kernels (attn_impl auto), on one
    device or a mesh whose ranks share the card, with the spelled-id
    tokenizer."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig, MeshConfig
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    return create_engine(MODEL, dtype="bfloat16", attn_impl="auto", seed=0, device=DEVICE,
                         mesh_cfg=mesh or MeshConfig(),
                         tokenizer=n_tokenizer(get_model_config(MODEL)),
                         engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **ecfg))


def n_part(tag, torch, cfg, params, prompt_ids, got, want):
    """got equals want, or parts only at a near tie of `params` (the
    reference weights on the single device): the top-2 logit gap after
    prompt + want[:at] under LOGITS_ATOL. Returns None or {at, gap}."""
    from distributed_llm_inference_tpu_torch.models import api as M

    at = parts_at(got, want)
    if at is None:
        return None
    ids = list(prompt_ids) + list(want[:at])
    cache = M.init_kv_cache(cfg, 1, len(ids) + 1, device=DEVICE)
    with torch.no_grad():
        logits, _ = M.forward(cfg, params, torch.tensor([ids], device=DEVICE), cache, 0)
    top = logits[0, -1].float().topk(2).values
    gap = float(top[0] - top[1])
    check(gap < LOGITS_ATOL, f"{tag}: the ids part at token {at} where the reference's "
                             f"top-2 gap is {gap:.4f}")
    return {"at": at, "gap": round(gap, 4)}


def n_ranks_equal(tag, counts, name):
    """Every rank launched `name`, the same number of times (each stage runs
    its share of the layers for every chunk; the draft runs whole on each)."""
    check(all(c[name] > 0 for c in counts) and len({c[name] for c in counts}) == 1,
          f"{tag}: {name} per rank {[c[name] for c in counts]}")


def phase_N1(torch, G, smi) -> dict:
    """Score, beams, prompt-lookup and draft-model speculation on the pp = 2
    ring against the single device, flash_attend on every rank."""
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config

    prompt = x_prompt(3, N_TOKENS)  # repetitive: the prompt lookup finds drafts
    dcfg = get_model_config(MODEL).replace(n_layers=N_DRAFT_LAYERS, dtype="bfloat16")

    def run(eng, walls=None):
        """The four requests (the draft attached before the last); their
        walls into `walls`."""
        out = {}
        for name in ("score", "beams", "prompt_lookup", "draft"):
            if name == "draft":
                eng.set_draft(dcfg)
            t = time.perf_counter()
            if name == "score":
                r = eng.score(prompt)
            elif name == "beams":
                r = eng.generate(prompt, max_tokens=N_NEW, num_beams=N_BEAMS, chat=False)
            else:
                r = eng.generate(prompt, max_tokens=N_NEW, greedy=True, chat=False,
                                 speculative=True)
                check(r.get("spec_path") == "solo" and (name == "draft") == ("draft_model" in r),
                      f"(N1) {name}: {r}")
            if walls is not None:
                walls[name] = time.perf_counter() - t
            check(r["status"] == "success", f"(N1) {name}: {r}")
            out[name] = r
        return out

    single = n_engine()
    plain = single.generate(prompt, max_tokens=N_NEW, greedy=True, chat=False)
    want = [int(x) for x in plain["response"].split()]
    ref = run(single)
    t0 = time.time()
    pp = n_engine(MeshConfig(pp=2))
    be = pp.backend
    print(f"(N1) {MODEL} over pp=2 ({be.name}, backend {be.mesh.backend}) built in "
          f"{time.time() - t0:.1f} s; supports score {be.supports_score}, beams "
          f"{be.supports_beam}, speculation {be.supports_speculative}, draft "
          f"{be.supports_draft}")
    walls = {}
    try:
        # every rank's counts from 0: the driver's process ran the single
        # device's requests above
        be.launch_counts(reset=True)
        got = run(pp, walls)
        counts = be.launch_counts()
        mem = d_memory(be)
        # a score request under every rank's torch.profiler, its counts
        # from 0 too: the trace's flash walks beside the counters'
        be.launch_counts(reset=True)
        be.profile(True)
        check(pp.score(prompt)["status"] == "success", "(N1) profiled score")
        prof = be.profile(False)
        prof_counts = be.launch_counts()
    finally:
        be.close()
    del pp
    n_ranks_equal("(N1)", counts, "flash_attend")
    traced = [d_attention_events(p["kernels"])["flash_walk_dense"] for p in prof["ranks"]]
    check(all(n > 0 for n in traced),
          f"(N1) a rank's profiler saw no flash_attend kernel: {traced}")
    out = {"profiled_score": {"flash_attend_counted": [c["flash_attend"] for c in prof_counts],
                              "flash_walk_traced": traced}}
    err = max(abs(x - y) for x, y in zip(ref["score"]["token_logprobs"][1:],
                                         got["score"]["token_logprobs"][1:]))
    check(err < LOGITS_ATOL, f"(N1) score |dlogprob| {err}")
    out["score_max_abs_err"] = err
    a, b = ref["beams"]["beams"], got["beams"]["beams"]
    check(len(a) == len(b) == N_BEAMS, f"(N1) beams: {got['beams']}")
    same = [x["text"] == y["text"] for x, y in zip(a, b)]
    gaps = [round(abs(x["score"] - y["score"]), 4) for x, y in zip(a, b)]
    for k, (eq, gap) in enumerate(zip(same, gaps)):
        check(eq or gap < LOGITS_ATOL, f"(N1) beam {k} parts, score gap {gap}")
    out["beams"] = {"equal": same, "score_gaps": gaps}
    # each speculation against the single device's own (the same loop on
    # one device): equal, or parted at a near tie of the reference's
    # weights; and the single device's against plain greedy, as before
    ids = single.tokenizer.encode(prompt)
    spec, vs_plain = {}, {}
    for name in ("prompt_lookup", "draft"):
        mine = [int(x) for x in got[name]["response"].split()]
        theirs = [int(x) for x in ref[name]["response"].split()]
        spec[name] = n_part(f"(N1) {name}", torch, single.cfg, single.backend.params, ids,
                            mine, theirs)
        vs_plain[name] = n_part(f"(N1) the single device's {name}", torch, single.cfg,
                                single.backend.params, ids, theirs, want)
    out["speculation_partings"] = spec
    out["single_device_speculation_vs_plain"] = vs_plain
    del single
    torch.cuda.empty_cache()
    print(f"(N1) pp=2 solo surface ({N_TOKENS}-token repetitive prompt, {N_NEW} new): score "
          f"max |dlogprob| vs the single device {out['score_max_abs_err']:.4f} (atol "
          f"{LOGITS_ATOL}); {N_BEAMS} beams equal {out['beams']['equal']}, score gaps "
          f"{out['beams']['score_gaps']}; prompt-lookup and {N_DRAFT_LAYERS}-layer draft "
          f"speculation against the single device's: partings {json.dumps(spec)} (None: "
          f"equal); the single device's against plain greedy: {json.dumps(vs_plain)}; "
          f"walls s {json.dumps({k: round(v, 3) for k, v in walls.items()})}; per-rank "
          f"launches {json.dumps(counts)}; a profiled score request's flash_attend per rank, "
          f"counted {out['profiled_score']['flash_attend_counted']} and traced {traced}; "
          f"memory {json.dumps(mem)} ({smi})")
    return {"launches": counts, "row": {**out, "walls_s": walls}}


def n_bodies():
    """(z1)'s wave: (g)'s eight prompts, greedy, six of them on adapters."""
    bodies = fleet_bodies(range(len(FLEET_PROMPT_TOKENS)))
    for b, (i, ad) in zip(bodies, Z_WAVE):
        for k in SAMPLED_KNOBS:
            b.pop(k, None)
        b.update(greedy=True, slo_class="batch")
        if ad:
            b["adapter"] = ad
    return bodies


def n_wave(fleet, server, bodies):
    """(z1)'s schedule: seven requests hold their slots (and z-a1..z-a4 the
    4 pages) before z-a5's comes, which waits for a page and swaps it in.
    Returns (results, wave seconds)."""
    import threading

    port = server.port
    before = fleet.stats()["completed"]
    out = [None] * len(bodies)

    def run(i):
        out[i] = post(port, bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads[:-1]:
        t.start()
    while True:
        st = fleet.stats()
        if st["occupied"] + st["completed"] - before >= len(bodies) - 1:
            break
        check(time.perf_counter() - t0 < 120, f"(N2) the first 7 were not admitted: {st}")
        time.sleep(0.002)
    threads[-1].start()
    for t in threads:
        t.join()
    wave_s = time.perf_counter() - t0
    for i, res in enumerate(out):
        check(res is not None and res[0] == 200 and res[1].get("status") == "success",
              f"(N2) request {i}: {res}")
    return [r for _, r, _ in out], wave_s


def n_adapter_parting(tag, torch, single, dirs, body, got, want):
    """A fleet row's parting: a near tie of the single device's weights,
    with the row's adapter merged into them."""
    from distributed_llm_inference_tpu_torch.models.lora import merge_lora

    if parts_at(got, want) is None:
        return None
    params = {k: v for k, v in single.backend.params.items() if k != "layers"}
    params["layers"] = {k: v for k, v in single.backend.params["layers"].items()
                        if not k.startswith("lora_")}
    if body.get("adapter"):
        params = merge_lora(single.cfg, params, dirs[body["adapter"]])
    out = n_part(tag, torch, single.cfg, params, single.tokenizer.encode(body["prompt"]),
                 got, want)
    del params
    return out


def phase_N2(torch, smi) -> dict:
    """(z1)'s adapter wave through the pp = 2 paged fleet against the single
    device's fleet with the same adapters; one adapter request at tp = 2;
    one page load's wall; ragged and paged launches per rank."""
    import gc

    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config

    dirs = z_write_adapters(get_model_config(MODEL), N_DIR)
    bodies = n_bodies()
    kw = dict(adapter_slots=Z_SLOTS, adapter_rank=Z_RANK)

    def serve(engine):
        for name in dirs:
            engine.adapters.register(name, dirs[name])
        fleet, server = fleet_server(engine, FLEET)
        return fleet, server

    single = n_engine(**kw)
    fleet, server = serve(single)
    try:
        want, single_s = n_wave(fleet, server, bodies)
    finally:
        server.shutdown()
        fleet.close()
    t0 = time.time()
    engine = n_engine(MeshConfig(pp=2), **kw)
    be = engine.backend
    built_s = time.time() - t0
    fleet, server = serve(engine)
    try:
        before = get(server.port, "/stats")[1]["continuous"]
        rag0 = ragged_launches(engine)
        p0 = engine.adapters.stats()
        be.launch_counts(reset=True)
        got, wave_s = n_wave(fleet, server, bodies)
        after = wait_idle(server.port)["continuous"]
        counts = be.launch_counts()
        rag = ragged_launches(engine) - rag0
        ps = engine.adapters.stats()
        # (N3)'s request alone through this full-load fleet, under every
        # rank's torch.profiler, its counts from 0: the trace's ragged and
        # paged walks beside the counters', and the ids (N3) must equal
        solo_i = min(i for i, b in enumerate(bodies) if not b.get("adapter"))
        be.launch_counts(reset=True)
        be.profile(True)
        code, solo, _ = post(server.port, bodies[solo_i])
        prof = be.profile(False)
        solo_counts = be.launch_counts()
        check(code == 200 and solo.get("status") == "success", f"(N2) solo request: {solo}")
        # one page load: the driver cuts and sends each rank its rows and
        # columns, each writes its page (a resident adapter's own content)
        pool = engine.adapters
        name, page = next(iter(pool._page_of.items()))
        load_ms = []
        for _ in range(3):
            t = time.perf_counter()
            be.write_adapter_page(page, pool._registry[name])
            torch.cuda.synchronize()
            load_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        server.shutdown()
        fleet.close()
        be.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    L, per_rank = single.cfg.n_layers, single.cfg.n_layers // 2
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    steps = after["chunk_steps"]
    for r, c in enumerate(counts):
        check(c["ragged_paged_attend"] == per_rank * rag > 0,
              f"(N2) rank {r}: ragged_paged_attend {c['ragged_paged_attend']} for {rag} "
              f"ragged launches of {per_rank} layers")
        check(c["paged_flash_attend"] == per_rank * steps * chunks > 0,
              f"(N2) rank {r}: paged_flash_attend {c['paged_flash_attend']} for {chunks} "
              f"decode chunks of {steps} steps x {per_rank} layers")
    traced = [d_attention_events(p["kernels"]) for p in prof["ranks"]]
    for r, e in enumerate(traced):
        check(e["ragged_walk"] > 0 and e["decode_walk_split"] > 0,
              f"(N2) rank {r}'s profiler saw no paged attention kernel: {e}")
    moved = {k: ps[k] - p0[k] for k in ("loads", "evictions", "swaps")}
    check(moved["swaps"] >= 1, f"(N2) the wave swapped no page: {moved}")
    parted = {}
    for i, (b, g, w) in enumerate(zip(bodies, got, want)):
        p = n_adapter_parting(f"(N2) request {i}", torch, single, dirs, b, g["token_ids"],
                              w["token_ids"])
        if p is not None:
            parted[i] = p
    # one adapter request at tp = 2, against the single device's
    tp = n_engine(MeshConfig(tp=2), **kw)
    i1 = 1  # (g)'s 24-token prompt on z-a2, N_TP_NEW tokens (a tp step is 44 host sums)
    tp_body = {**bodies[i1], "max_tokens": N_TP_NEW}
    try:
        tp.adapters.register("z-a2", dirs["z-a2"])
        tp.backend.launch_counts(reset=True)
        fleet, server = fleet_server(tp, FLEET)
        try:
            code, r, tp_wall = post(server.port, tp_body)
        finally:
            server.shutdown()
            fleet.close()
        tp_counts = tp.backend.launch_counts()
    finally:
        tp.backend.close()
    check(code == 200 and r.get("adapter") == "z-a2", f"(N2) tp=2 adapter request: {r}")
    tp_part = n_adapter_parting("(N2) tp=2", torch, single, dirs, tp_body, r["token_ids"],
                                want[i1]["token_ids"][:N_TP_NEW])
    n_tok = sum(g["tokens_generated"] for g in got)
    print(f"(N2) pp=2 adapter wave (built in {built_s:.1f} s): 8 requests (2 base, 6 over "
          f"{len(dirs)} adapters on {Z_SLOTS} pages) {n_tok} tokens in {wave_s:.3f} s = "
          f"{n_tok / wave_s:.2f} tokens/s (the single device's fleet "
          f"{sum(w['tokens_generated'] for w in want) / single_s:.2f}); ids equal the single "
          f"device's fleet for {len(got) - len(parted)} of {len(got)}, partings at near "
          f"ties {json.dumps(parted)}; pool loads/evictions/swaps {json.dumps(moved)}; one "
          f"page load (cut, sent, written on both ranks) {json.dumps([round(x, 3) for x in load_ms])} "
          f"ms; ragged launches {rag}, decode chunks {chunks}; per-rank launches "
          f"{json.dumps(counts)}; request {solo_i} alone under the profiler, per rank "
          f"counted {json.dumps([{k: c[k] for k in ('ragged_paged_attend', 'paged_flash_attend')} for c in solo_counts])} "
          f"and traced {json.dumps(traced)}; tp=2 z-a2 request ({FLEET_PROMPT_TOKENS[i1]} "
          f"tokens, {N_TP_NEW} new) "
          + ("equal" if tp_part is None else f"parts {json.dumps(tp_part)}")
          + f" in {tp_wall:.3f} s, per-rank launches {json.dumps(tp_counts)} ({smi})")
    del single
    torch.cuda.empty_cache()
    return {"launches": counts + tp_counts,
            "row": {"tokens_per_s": n_tok / wave_s, "parted": parted, "pool": moved,
                    "page_load_ms": load_ms, "tp2": tp_part,
                    "solo_traced": traced},
            "solo": {"i": solo_i, "body": bodies[solo_i], "token_ids": solo["token_ids"]}}


def phase_N3(torch, n2, smi) -> dict:
    """A checkpoint store of tinyllama-1.1b (seed 0) served by the server's
    CLI with --checkpoint on pp = 2: each rank copies its own rows and
    columns out of the store's memory maps; (N2)'s solo request's ids are
    equal to those of the full-load pp = 2 fleet."""
    import shutil

    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.models import checkpoint as CK
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL).replace(dtype="bfloat16")
    store = f"{N_DIR}/store"
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.time()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    CK.save_params(store, cfg, params)
    whole = sum(t.numel() * t.element_size() for t in
                [params["embed"], params["final_norm"], params["lm_head"],
                 *params["layers"].values()])
    layer_bytes = sum(t.numel() * t.element_size() for t in params["layers"].values())
    del params
    torch.cuda.empty_cache()
    save_s = time.time() - t0
    port = free_port()
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m",
                             "distributed_llm_inference_tpu_torch.serving.server",
                             "--checkpoint", store, "--pp", "2", "--device", DEVICE,
                             "--host", "127.0.0.1", "--port", str(port), *N_SERVER],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=r_env())
    url = f"http://127.0.0.1:{port}"
    solo = n2["solo"]
    try:
        up_s = n_wait_up(proc, url, "(N3)")
        detail = r_call(url, "/workers")[1]["detail"]
        held = [r["store_shard_bytes"] for s in detail for r in s["ranks"]]
        code, r, wall = r_call(url, "/generate", solo["body"])
        check(code == 200 and r.get("status") == "success", f"(N3) request {solo['i']}: {r}")
    finally:
        out = n_stop(proc)
        shutil.rmtree(store, ignore_errors=True)
    check(r["token_ids"] == solo["token_ids"],
          f"(N3) request {solo['i']}'s ids {r['token_ids']} differ from the full-load "
          f"pp=2 fleet's {solo['token_ids']}")
    check(len(held) == 2 and all(b < 0.6 * whole for b in held),
          f"(N3) bytes each rank's shard holds {held} of the tree's {whole}")
    print(f"(N3) {MODEL} store ({whole} bytes, {layer_bytes} of them layers) written in "
          f"{save_s:.1f} s; `--checkpoint --pp 2` server up in {up_s:.1f} s of {time.time() - t0:.1f}; "
          f"bytes of the store each rank's shard holds {held} ({[round(b / whole, 4) for b in held]} "
          f"of the tree; half the layers is {layer_bytes // 2}); request {solo['i']} "
          f"({FLEET_PROMPT_TOKENS[solo['i']]} tokens) alone in {wall:.3f} s, its ids equal to "
          f"the full-load pp=2 fleet's; server exit {out} ({smi})")
    return {"shard_bytes": held, "whole_bytes": whole, "up_s": up_s}


def n_wait_up(proc, url, tag, timeout_s=240.0) -> float:
    """Seconds until the server at url answers /health 200 (its process
    alive meanwhile)."""
    t0 = time.time()
    while True:
        if proc.poll() is not None:
            raise SmokeFailure(f"{tag} the server exited {proc.returncode}: "
                               f"{proc.stdout.read()[-3000:]}")
        try:
            if r_call(url, "/health", timeout=5)[0] == 200:
                return time.time() - t0
        except OSError:
            pass
        check(time.time() - t0 < timeout_s, f"{tag} the server was not up in {timeout_s} s")
        time.sleep(0.5)


def n_stop(proc, timeout_s=H_SHUTDOWN_S):
    """SIGTERM, then the exit code (a kill past the timeout: None)."""
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
        return proc.returncode
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return None


def phase_N(torch, smi) -> dict:
    """(N1)-(N3): part C of the mesh on the card."""
    from distributed_llm_inference_tpu_torch.engine import generate as G

    t0 = time.time()
    n1 = phase_N1(torch, G, smi)
    n2 = phase_N2(torch, smi)
    n3 = phase_N3(torch, n2, smi)
    print(f"(N) took {time.time() - t0:.1f} s ({smi})")
    print("(N) " + json.dumps({"part_c": {"N1": n1["row"], "N2": n2["row"], "N3": n3}}))
    return d_sum(n1["launches"] + n2["launches"])


def phase_H(torch, smi) -> dict:
    """(H) two server processes on the one machine, one pp = 2 mesh whose
    ranks span them (one each, both on the card over gloo): process 0
    serves HTTP and mirrors each request to process 1; one request's
    tokens (pinned by their logprobs) equal the single device's; SIGTERM
    ends process 0 within the bounded shutdown, and process 1 exits."""
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    prompt = fleet_prompt(84, N_TOKENS)
    body = {"prompt": prompt, "max_tokens": H_NEW, "greedy": True, "chat": False,
            "logprobs": True}
    single = create_engine(MODEL, dtype="float32", attn_impl="auto", seed=0, device=DEVICE)
    want = single.generate(**body)
    del single
    torch.cuda.empty_cache()
    coord, port = free_port(), free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         "--model", MODEL, "--dtype", "float32", "--attn-impl", "auto", "--seed", "0",
         "--pp", "2", "--device", DEVICE, "--coordinator", f"127.0.0.1:{coord}",
         "--num-processes", "2", "--process-id", str(i), "--host", "127.0.0.1",
         "--port", str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=r_env()) for i in range(2)]
    url = f"http://127.0.0.1:{port}"
    try:
        up_s = n_wait_up(procs[0], url, "(H)")
        check(procs[1].poll() is None, "(H) process 1 exited")
        code, got, wall = r_call(url, "/generate", body)
        check(code == 200 and got.get("status") == "success", f"(H) request: {got}")
        workers = r_call(url, "/workers")[1]
        t_stop = time.time()
        rc0 = n_stop(procs[0])
        stop0_s = time.time() - t_stop
        rc1 = n_stop(procs[1])
        stop1_s = time.time() - t_stop
    finally:
        for p in procs:
            n_stop(p, 10)
    a, b = want["token_logprobs"], got["token_logprobs"]
    err = max((abs(x - y) for x, y in zip(a, b)), default=0.0)
    check(len(a) == len(b) and err < LOGITS_ATOL and want["response"] == got["response"],
          f"(H) the two-process mesh's tokens differ from the single device's: "
          f"{b} vs {a}")
    statuses = {k: v for k, v in workers.items() if k != "detail"}
    check(statuses == {"worker_1": "online", "worker_2": "remote"}, f"(H) /workers {statuses}")
    check(rc0 is not None and stop0_s < H_SHUTDOWN_S and rc1 is not None,
          f"(H) exits: process 0 {rc0} after {stop0_s:.1f} s, process 1 {rc1}")
    print(f"(H) two server processes (--num-processes 2, --pp 2, fp32, one rank each on "
          f"the card over gloo) up in {up_s:.1f} s; one request of {N_TOKENS} tokens "
          f"through process 0 in {wall:.3f} s: its {len(b)} tokens' logprobs within "
          f"{err:.2e} of the single device's (the same tokens); /workers {statuses}; "
          f"SIGTERM: process 0 exited {rc0} in {stop0_s:.1f} s, process 1 exited {rc1} "
          f"{stop1_s:.1f} s after the signal ({smi})")
    return {}


def phase_mesh(torch, kernels, smi, which=MESH_PHASES) -> dict:
    """Those of (D), (M), (L), (E), (N) and (H) in `which`, in this process, in that
    order: their kernel counts on the last line, `MESH {...}`."""
    from distributed_llm_inference_tpu_torch.engine import generate as G
    from distributed_llm_inference_tpu_torch.models import api as M
    from distributed_llm_inference_tpu_torch.ops import flash_attention as fa
    from distributed_llm_inference_tpu_torch.ops import paged_attention as pa
    from distributed_llm_inference_tpu_torch.ops import quant as Q

    out = {}
    if "D" in which:
        out["D"] = phase_D(torch, kernels, smi)
    if "M" in which:
        out["M"] = phase_M(torch, G, M, smi)["launches"]
    if "L" in which:
        phase_L(torch, G, M, smi)
    if "E" in which:
        out["E"] = phase_E(torch, G, M, pa, fa, Q, smi)["launches"]
    if "N" in which:
        out["N"] = phase_N(torch, smi)
    if "H" in which:
        out["H"] = phase_H(torch, smi)
    print("MESH " + json.dumps(out))
    return out


# -- speculation on the mixed launch: phase (x) --------------------------------------

# (x1)'s wave: 8 greedy requests whose prompts repeat one sentence, 200-600
# tokens, 64 new tokens each, on (g)'s fleet with and without speculation
X_PROMPT_TOKENS = (200, 260, 320, 380, 440, 500, 560, 600)
X_NEW = 64
X_WAVES = 3  # waves per fleet: the aggregate tokens/s is their median
X_K = 4  # spec_draft_len, the JAX default
X_DRAFT_LAYERS = 2  # (x2)'s small draft: tinyllama's widths, 2 layers, seed 1
# (x4)'s crash: a decode_launch fault on a fleet whose draft is the target
# itself (it accepts, so every launch verifies) lands behind verify rows in
# flight
X_CRASH_CALL = 8


def x_prompt(i: int, n: int) -> str:
    """n byte-tokenizer tokens of one sentence repeated (BOS + one per
    character), a different sentence for each i."""
    return (f"Note {i}: the quick brown fox jumps over the lazy dog. " * 40)[: n - 1]


def x_bodies():
    return [{"prompt": x_prompt(i, n), "max_tokens": X_NEW, "greedy": True, "chat": False}
            for i, n in enumerate(X_PROMPT_TOKENS)]


def x_engine(engine, kv_quant=None, **ecfg):
    """The same model and weights with speculation settings (and the pool
    under kv_quant)."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    return create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                         kv_quant=kv_quant,
                         engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **ecfg))


def x_hist(engine, name):
    """(count, sum) of an unlabeled histogram of the engine's registry."""
    fam = engine.metrics.get(name)
    h = fam.labels()
    return h.count, h.sum


def x_check_graphs(tag, stats, draft):
    """check_graphs on a speculating fleet: the plain and the verify
    launches share the mixed count (a fleet whose every request speculated
    to its end ran no decode chunk), the draft fill runs on every mixed
    launch and the propose chain is captured once."""
    g, n = stats["graphs"], stats["launches"]
    kinds = {"mixed_launch": "mixed", "mixed_spec": "mixed"}
    if n["decode_chunks"]:
        kinds["decode_chunk"] = "decode_chunks"
    else:
        check(g["decode_chunk"] == {"captures": 0, "replays": 0},
              f"{tag}: decode_chunk {g['decode_chunk']} with no decode chunk")
    if draft:
        check(g["draft_fill"] == {"captures": 1, "replays": n["mixed"] - 1},
              f"{tag}: draft_fill {g['draft_fill']} for {n['mixed']} mixed launches")
        check(g["draft_propose"]["captures"] == 1, f"{tag}: draft_propose {g['draft_propose']}")
    check_graphs(tag, dict(stats, graphs={k: v for k, v in g.items() if k in kinds}), kinds)


def x_gap(torch, P, G, engine, ids) -> float:
    """The top-2 logit gap of the next token after `ids`, teacher-forced
    through the plain fleet's ragged prefill launches on a fresh pool."""
    pool = P.init_pool(engine.cfg, SLOT_MB + 1, BLOCK, device=DEVICE)
    n = -(-len(ids) // BLOCK)
    logits = v_teacher_logits(torch, P, G, engine, pool, list(range(1, n + 1)), ids, 0)
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def x_identity(tag, torch, P, G, engine, bodies, got, want):
    """Each speculating stream equals the non-speculating one, or parts only
    at a near-tie: where they part, the non-speculating run's top-2 logit
    gap must be under LOGITS_ATOL. Returns the parting positions."""
    parts = []
    for body, g, w in zip(bodies, got, want):
        at = parts_at(g, w)
        if at is None:
            parts.append(None)
            continue
        ids = engine.tokenizer.encode(body["prompt"]) + list(w[:at])
        gap = x_gap(torch, P, G, engine, ids)
        parts.append({"at": at, "gap": gap})
        check(gap < LOGITS_ATOL, f"{tag}: a stream parts at token {at} where the "
                                 f"non-speculating run's top-2 gap is {gap:.4f}")
    n_same = sum(p is None for p in parts)
    print(f"{tag} greedy identity vs the non-speculating fleet: {n_same} of {len(parts)} "
          f"streams identical; partings {json.dumps([p for p in parts if p])} (each at a "
          f"near-tie, top-2 gap < {LOGITS_ATOL})")
    return parts


def x_spec_delta(before, after) -> dict:
    keys = ("launches", "drafted_tokens", "accepted_tokens", "pipelined_launches")
    return {k: after["speculative"][k] - before["speculative"][k] for k in keys}


def x_fleet_run(tag, torch, engine, eng, pa, fa, Q, bodies, waves, smi, draft_layers=0):
    """Serve an untimed wave of `bodies`, a lone request, then `waves` timed
    waves on a fleet of `eng` through the HTTP server; for each timed wave
    the kernel counts from 0 just before it, checked against the launches
    it ran. Returns the rows and the fleet (shut down)."""
    L = engine.cfg.n_layers
    sfx = "[int8]" if eng.cfg.kv_quant == "int8" else ""
    fleet, server = fleet_server(eng, FLEET)
    rows = []
    try:
        check(fleet.warmup()["ok"], f"{tag} warmup")
        # one untimed wave first: every launch kind the waves meet is
        # captured (a capture is an eager launch and more) before a timed run
        serve_wave(server, bodies, pa, fa, Q)
        captured = {k: v["captures"] for k, v in fleet.stats()["graphs"].items()}
        code, lone, wall = post(server.port, bodies[0])
        check(code == 200 and lone["tokens_generated"] == X_NEW, f"{tag} lone: {lone}")
        print(f"{tag} a lone request: prompt_tokens={lone['prompt_tokens']} "
              f"tokens={lone['tokens_generated']} tokens_per_sec={lone['tokens_per_sec']} "
              f"spec_drafted={lone.get('spec_drafted')} "
              f"spec_accepted={lone.get('spec_accepted')} wall_s={wall:.3f} ({smi})")
        for w in range(waves):
            hist0 = x_hist(eng, "dli_spec_tokens_per_launch")
            prop0 = fleet._propose_graph.calls if fleet._propose_graph else 0
            results, wave_s, launches, before, after = serve_wave(server, bodies, pa, fa, Q)
            for i, (code, r, _) in enumerate(results):
                check(code == 200 and r.get("status") == "success"
                      and r["tokens_generated"] == X_NEW, f"{tag} request {i}: {r}")
            mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
            chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
            proposes = (fleet._propose_graph.calls if fleet._propose_graph else 0) - prop0
            n_tok = sum(r["tokens_generated"] for _, r, _ in results)
            row = dict(wave=w, wave_s=wave_s, tokens=n_tok, tokens_per_s=n_tok / wave_s,
                       mixed=mixed, decode_chunks=chunks, launches=launches,
                       ids=[r["token_ids"] for _, r, _ in results])
            if "speculative" in after:
                cnt, tot = x_hist(eng, "dli_spec_tokens_per_launch")
                row["speculative"] = x_spec_delta(before, after)
                row["tokens_per_verify_row"] = ((tot - hist0[1]) / (cnt - hist0[0])
                                                if cnt > hist0[0] else None)
                row["proposes"] = proposes
            ragged, paged = "ragged_paged_attend" + sfx, "paged_flash_attend" + sfx
            want_ragged = (L + draft_layers) * mixed
            want_paged = L * FLEET["chunk_steps"] * chunks + draft_layers * (X_K + 1) * proposes
            check(launches[ragged] == want_ragged > 0,
                  f"{tag} wave {w}: {ragged} {launches[ragged]}, {want_ragged} expected for "
                  f"{mixed} mixed launches ({L} layers + {draft_layers} draft layers)")
            check(launches[paged] == want_paged,
                  f"{tag} wave {w}: {paged} {launches[paged]}, {want_paged} expected for "
                  f"{chunks} decode chunks and {proposes} propose chains")
            others = [k for k in launches if k not in (ragged, paged) and launches[k]]
            check(not others, f"{tag} wave {w}: other kernels ran: {launches}")
            print(f"{tag} wave {w}: {n_tok} tokens in {wave_s:.3f} s = "
                  f"{n_tok / wave_s:.2f} tokens/s aggregate; {mixed} mixed launches, "
                  f"{chunks} decode chunks; speculative {json.dumps(row.get('speculative'))}, "
                  f"tokens per verify row {row.get('tokens_per_verify_row')}, propose "
                  f"chains {row.get('proposes')}; kernel launches "
                  f"{json.dumps({k: v for k, v in launches.items() if v})} ({smi})")
            rows.append(row)
        st = wait_idle(server.port)["continuous"]
        print(f"{tag} graphs captured after the untimed wave {json.dumps(captured)}; "
              f"after the timed runs {json.dumps({k: v['captures'] for k, v in st['graphs'].items()})}")
        check(st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
              f"{tag}: pool blocks leaked")
        print(f"{tag} /stats speculative {json.dumps(st.get('speculative'))}")
        if "speculative" in st and st["speculative"]["launches"]:
            x_check_graphs(tag, st, draft_layers > 0)
        else:
            check_graphs(tag, st, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
    finally:
        server.shutdown()
    return dict(lone=dict(tokens_per_sec=float(lone["tokens_per_sec"]),
                          spec_drafted=lone.get("spec_drafted"),
                          spec_accepted=lone.get("spec_accepted")), waves=rows), fleet


def x_summary(rows) -> dict:
    w = rows["waves"]
    return dict(lone_tokens_per_s=rows["lone"]["tokens_per_sec"],
                median_tokens_per_s=statistics.median(r["tokens_per_s"] for r in w),
                waves_tokens_per_s=[r["tokens_per_s"] for r in w],
                speculative=w[0].get("speculative"),
                tokens_per_verify_row=w[0].get("tokens_per_verify_row"),
                mixed=w[0]["mixed"], decode_chunks=w[0]["decode_chunks"],
                launches={k: v for k, v in w[0]["launches"].items() if v})


def phase_x1(torch, engine, pa, fa, Q, P, G, smi):
    """n-gram speculation: the wave on (g)'s fleet with --spec-decode and
    on the same fleet with spec_draft_len=0, then one wave under
    --kv-quant int8."""
    bodies = x_bodies()
    out = {}
    plain, _ = x_fleet_run("(x1) plain", torch, engine, x_engine(engine, spec_draft_len=0),
                           pa, fa, Q, bodies, X_WAVES, smi)
    spec_eng = x_engine(engine, spec_decode=True, spec_draft_len=X_K)
    spec, _ = x_fleet_run("(x1) spec", torch, engine, spec_eng, pa, fa, Q, bodies,
                          X_WAVES, smi)
    out["plain"], out["spec"] = x_summary(plain), x_summary(spec)
    out["spec"]["partings"] = x_identity("(x1) spec", torch, P, G, engine, bodies,
                                         spec["waves"][0]["ids"], plain["waves"][0]["ids"])
    int8, _ = x_fleet_run("(x1) spec int8", torch, engine,
                          x_engine(engine, kv_quant="int8", spec_decode=True,
                                   spec_draft_len=X_K), pa, fa, Q, bodies, 1, smi)
    out["spec_int8"] = x_summary(int8)
    print(f"(x1) aggregate tokens/s (median of {X_WAVES}): spec "
          f"{out['spec']['median_tokens_per_s']:.2f} vs plain "
          f"{out['plain']['median_tokens_per_s']:.2f}; lone stream "
          f"{out['spec']['lone_tokens_per_s']} vs {out['plain']['lone_tokens_per_s']} "
          f"tokens/s; int8 pool spec {out['spec_int8']['median_tokens_per_s']:.2f} ({smi})")
    return out, plain["waves"][0]["ids"], [spec["waves"][0]["launches"]]


def phase_x2(torch, engine, pa, fa, Q, P, G, smi, plain_ids, plain_tps, launches):
    """Draft-model speculation: the target's own weights as the draft
    (acceptance), then a 2-layer draft at tinyllama's widths (seed 1)."""
    bodies = x_bodies()
    out, fleets = {}, {}
    for name, dcfg, dparams, layers in (
            ("identical draft", engine.cfg, engine.backend.params, engine.cfg.n_layers),
            (f"{X_DRAFT_LAYERS}-layer draft", engine.cfg.replace(n_layers=X_DRAFT_LAYERS),
             None, X_DRAFT_LAYERS)):
        eng = x_engine(engine, spec_decode=True, spec_draft_len=X_K,
                       spec_draft_model=MODEL)
        eng.set_draft(dcfg, dparams, seed=1)
        rows, fleet = x_fleet_run(f"(x2) {name}", torch, engine, eng, pa, fa, Q, bodies, 1,
                                  smi, draft_layers=layers)
        out[name] = x_summary(rows)
        sb = out[name]["speculative"]
        out[name]["acceptance"] = (sb["accepted_tokens"] / sb["drafted_tokens"]
                                   if sb["drafted_tokens"] else None)
        out[name]["proposes"] = rows["waves"][0]["proposes"]
        out[name]["partings"] = x_identity(f"(x2) {name}", torch, P, G, engine, bodies,
                                           rows["waves"][0]["ids"], plain_ids)
        print(f"(x2) {name}: drafted {sb['drafted_tokens']} accepted "
              f"{sb['accepted_tokens']} (acceptance {out[name]['acceptance']}); "
              f"{out[name]['median_tokens_per_s']:.2f} tokens/s against the plain fleet's "
              f"{plain_tps:.2f}; paged_flash_attend per propose chain "
              f"{layers} x {X_K + 1} ({smi})")
        check(sb["drafted_tokens"] > 0, f"(x2) {name}: nothing drafted")
        fleets[name] = fleet
        launches.append(rows["waves"][0]["launches"])
    return out, fleets


def x_spec_operands(torch, cfg, P, G, graphs):
    """(h)'s serving-shape operands with verify rows: slots 0 and 2
    (greedy) carry K = 4 verify rows (n-gram drafts in the tokens, the
    draft buffer random), the other armed slots plain decode rows, slot
    7's 56-token prompt landing and arming."""
    import numpy as np

    ops, _ = fleet_operands(torch, cfg, P, G)
    B, K, W = FLEET["n_slots"], X_K, RAGGED_W
    verify = {0: 4, 2: 4}
    entries = [(b, 0, 1 + verify[b], P.RAGGED_PREFILL) if b in verify
               else (b, 0, 1, P.RAGGED_DECODE) for b in range(B - 1)]
    entries.append((B - 1, 0, 56, P.RAGGED_PREFILL))
    meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(entries, width=W,
                                                             tile=RAGGED_TILE)
    dev = P.build_device_meta(entries, offsets, B - 1, width=W, tile=RAGGED_TILE)
    dec_flag = np.zeros(W, bool)
    dec_idx = np.zeros(B, np.int32)
    spec = graphs.spec_inputs(B, K, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(8)
    for b, off in zip(range(B - 1), offsets):
        dec_flag[off] = True
        if b in verify:
            idxs = off + np.arange(K + 1)
            spec.plan.dec_on[b], spec.plan.on[b], spec.plan.n_draft[b] = False, True, K
            spec.plan.idx[b] = torch.from_numpy(idxs).to(DEVICE)
        else:
            dec_idx[b] = off
    spec.toks.copy_(torch.randint(3, cfg.vocab_size, (B, K), generator=g, device=DEVICE))
    arm = ops["arm"]._replace(idx=ops["arm"].idx.clone())
    arm.idx[B - 1] = offsets[-1] + 55
    d = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    inputs = graphs.MixedInputs(ops["tokens"], d(tok_row), d(tok_pos), d(dec_flag), d(meta),
                                d(dec_idx), arm, P.DeviceMeta(*(d(a) for a in dev)))
    return dict(cache=ops["pool"], table=ops["table"], state=ops["state"],
                sparams=ops["sparams"], inputs=inputs, spec=spec), ops["generator"]


def x_replays(torch, graphs, tag, name, run, bufs, gen, want_deltas):
    """One launch kind captured over `bufs` and replayed twice, each replay
    bit-equal to the eager body on a clone of the buffers with the same
    generator state (every pool outside its trash block), the counters
    moving by the capture's deltas, replays under the sync check."""
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), name, DEVICE, gen)
    start = clone_tree(torch, bufs)

    def restore():
        for k in ("state", "sparams"):
            graphs.commit(bufs[k], start[k])

    lg()
    check(lg.captures == 1, f"{tag} {name}: not captured")
    for _ in range(2):
        restore()
        ref = clone_tree(torch, bufs)
        g2 = torch.Generator(device=DEVICE)
        g2.set_state(gen.get_state())
        before = graphs.launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = lg()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = None if got is None else got.clone()
        moved = {k: v - before[k] for k, v in graphs.launch_counts().items()}
        want = run(ref, g2)
        torch.cuda.synchronize()
        check(got is None or torch.equal(got, want),
              f"{tag} {name}: a replay's result differs from the eager launch")
        for key in ("state", "sparams", "spec"):
            check(all(torch.equal(a, b) for a, b in zip(leaves(torch, bufs[key]),
                                                        leaves(torch, ref[key]))),
                  f"{tag} {name}: a replay's {key} differs from the eager launch")
        for key in ("cache", "dpool"):
            check(all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in
                      zip(leaves(torch, bufs[key]), leaves(torch, ref[key]))),
                  f"{tag} {name}: a replay's {key} differs from the eager launch")
        check(moved == lg.deltas, f"{tag} {name}: counters moved {moved}, deltas {lg.deltas}")
    nonzero = {k: v for k, v in lg.deltas.items() if v}
    check(nonzero == want_deltas, f"{tag} {name}: launches per replay {nonzero}, "
                                  f"{want_deltas} expected")
    print(f"{tag} {name}: captured once, 2 replays bit-equal to eager under the sync "
          f"check, launches per replay {json.dumps(nonzero)}")
    lg.close()
    return nonzero


def phase_x3(torch, engine, pa, P, G, M, dpool_fleet):
    """The speculation launch kinds as CUDA graphs, and the two kernels on
    their new paths against their twins."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    cfg, be = engine.cfg, engine.backend
    L = cfg.n_layers
    bufs, gen = x_spec_operands(torch, cfg, P, G, graphs)
    dcfg = cfg.replace(n_layers=X_DRAFT_LAYERS)
    dparams = M.init_params(dcfg, torch.Generator(device=DEVICE).manual_seed(1))
    bufs["dpool"] = P.init_pool(dcfg, int(bufs["table"].max()) + 1, BLOCK, device=DEVICE)
    kinds = {
        "mixed_spec (n-gram)": (lambda b, g: graphs.mixed_spec_launch(
            be, b["inputs"], b["spec"], b["cache"], b["table"], b["state"], b["sparams"],
            g, draft_toks=False), {"ragged_paged_attend": L}),
        "mixed_spec (draft proposals)": (lambda b, g: graphs.mixed_spec_launch(
            be, b["inputs"], b["spec"], b["cache"], b["table"], b["state"], b["sparams"],
            g, draft_toks=True), {"ragged_paged_attend": L}),
        "draft_fill": (lambda b, g: graphs.draft_fill(
            dcfg, dparams, b["inputs"], b["dpool"], b["table"], b["state"]),
            {"ragged_paged_attend": X_DRAFT_LAYERS}),
        "draft_propose": (lambda b, g: graphs.draft_propose(
            dcfg, dparams, b["state"], b["dpool"], b["table"], b["spec"].toks),
            {"paged_flash_attend": X_DRAFT_LAYERS * (X_K + 1)}),
    }
    out = {"graphs": {}}
    for name, (run, deltas) in kinds.items():
        out["graphs"][name] = x_replays(torch, graphs, "(x3)", name, run, bufs, gen, deltas)
    # ragged_paged_attend on launches with verify rows: K = 4 (one tile) and
    # K = 8 (two tiles, tile_off 8) beside decode rows and a prompt chunk,
    # q_start derived on the device
    rows = []
    for dt in ("bfloat16", "float32"):
        for int8 in ((False, True) if dt == "bfloat16" else (False,)):
            g, pk, pv, table = paged_pool(torch, getattr(torch, dt), 6, 31, int8=int8)
            for k in (4, 8):
                entries = [(0, 0, 1, P.RAGGED_DECODE), (1, 0, 1, P.RAGGED_DECODE),
                           (2, 0, 1 + k, P.RAGGED_PREFILL), (3, 0, 1 + k, P.RAGGED_PREFILL),
                           (4, 300, 56, P.RAGGED_PREFILL)]
                meta, tok_row, tok_pos, offsets, _ = P.build_ragged_meta(
                    entries, width=RAGGED_W, tile=RAGGED_TILE)
                dev = P.build_device_meta(entries, offsets, 4, width=RAGGED_W,
                                          tile=RAGGED_TILE)
                d = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
                pos = torch.tensor([17, 1023, 700, 1015 - k, 0, 0], dtype=torch.int32,
                                   device=DEVICE)
                m, _ = P.apply_device_meta(d(meta), d(tok_row), d(tok_pos),
                                           P.DeviceMeta(*(d(a) for a in dev)), pos)
                q = torch.randn(RAGGED_W, H, DH, generator=g, device=DEVICE).to(
                    getattr(torch, dt))
                got = pa.ragged_paged_attend(q, pk, pv, table, m)
                again = pa.ragged_paged_attend(q, pk, pv, table, m)
                want = pa.ragged_paged_attend_plain(q, pk, pv, table, m)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rows.append(dict(kernel="ragged_paged_attend", dtype=dt, int8=int8, k=k,
                                 max_abs_err=err, atol=ATOL[dt],
                                 repeat_equal=torch.equal(got, again)))
                check(err <= ATOL[dt] and torch.equal(got, again),
                      f"(x3) ragged_paged_attend on verify rows (K={k}, {dt}, int8={int8}): "
                      f"error {err}")
    # paged_flash_attend over the 2-layer draft fleet's pool (its layer 0,
    # the K/V the draft wrote in (x2)) through a shuffled table
    dk, dv = dpool_fleet._dpool["k"][0], dpool_fleet._dpool["v"][0]
    g = torch.Generator(device=DEVICE).manual_seed(33)
    n = dk.shape[0]
    table = (torch.randperm(n - 1, generator=g, device=DEVICE)[: 8 * SLOT_MB] + 1).reshape(
        8, SLOT_MB).to(torch.int32).contiguous()
    pos = torch.tensor(SPECIAL_POS + [3, 511, 900], dtype=torch.int32, device=DEVICE)
    for step in range(X_K + 1):  # one chain: K + 1 steps from each row's frontier
        q = torch.randn(8, 1, H, DH, generator=g, device=DEVICE).to(dk.dtype)
        p = torch.clamp(pos + step, max=SLOT_MB * BLOCK - 1)
        got = pa.paged_flash_attend(q, dk, dv, table, p)
        want = pa.paged_flash_attend_plain(q, dk, dv, table, p)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rows.append(dict(kernel="paged_flash_attend", pool="draft", step=step,
                         max_abs_err=err, atol=ATOL["bfloat16"]))
        check(err <= ATOL["bfloat16"], f"(x3) paged_flash_attend on the draft pool, step "
                                        f"{step}: error {err}")
    out["kernels"] = rows
    print("(x3) kernels on their speculation paths vs their twins: " + json.dumps(rows))
    return out


def phase_x4(torch, engine, pa, fa, Q, faults, smi):
    """Faults mid-speculation: a decode_launch crash on a draft-model fleet
    (verify rows in flight at every launch), then (s)'s preemption pair on
    the --spec-decode engine."""
    eng = x_engine(engine, spec_decode=True, spec_draft_len=X_K, spec_draft_model=MODEL)
    eng.set_draft(engine.cfg, engine.backend.params)  # accepts: it never stops drafting
    fleet, server = fleet_server(eng, SUPER_FLEET)
    spy = FleetSpy(fleet)
    pending = []
    inner = fleet._supervise

    def supervise(exc):
        pending.append(sum(len(v) for v in fleet._spec_pending.values()))
        return inner(exc)

    fleet._supervise = supervise
    body = {"prompt": x_prompt(30, SUPER_REQ[0]), "max_tokens": SUPER_REQ[1],
            "greedy": True, "chat": False}
    try:
        check(fleet.warmup()["ok"], "(x4) warmup")
        code, ref, _ = post(server.port, body)
        check(code == 200, f"(x4) the unfaulted run: {ref}")
        st0 = wait_idle(server.port)["continuous"]
        spy.reset()
        faults.arm([faults.FaultRule("decode_launch", "transient", on_call=X_CRASH_CALL)])
        try:
            code, r, wall = post(server.port, body)
        finally:
            faults.disarm()
        st = wait_idle(server.port)["continuous"]
        restarts = st["supervisor"]["restarts"] - st0["supervisor"]["restarts"]
        n_pre = spy.salvaged.get(body["prompt"], 0)
        print(f"(x4) decode_launch crash (call {X_CRASH_CALL}) on a draft-model fleet: HTTP "
              f"{code} tokens={r.get('tokens_generated')} recovered={r.get('recovered')} "
              f"restarts +{restarts}; verify rows pending at the crash {pending}; {n_pre} "
              f"tokens fetched before it; request wall {wall:.3f} s ({smi})")
        check(code == 200 and r["tokens_generated"] == SUPER_REQ[1], f"(x4) crash: {r}")
        check(restarts == 1 and pending and pending[0] > 0,
              f"(x4) crash: {restarts} restarts, pending verify rows {pending}")
        check(st["paged"]["free_blocks"] == SUPER_FLEET["kv_pool_blocks"] - 1,
              "(x4) crash: pool blocks leaked")
        check(all(g["captures"] <= 1 for g in st["graphs"].values())
              and st["graphs"]["mixed_spec"]["captures"] == 1,
              f"(x4) crash: graphs recaptured {st['graphs']}")
        at = check_identity("(x4) crash", r["token_ids"], ref["token_ids"], n_pre)
    finally:
        faults.disarm()
        server.shutdown()
    spec_eng = x_engine(engine, spec_decode=True, spec_draft_len=X_K)
    pair = phase_s(torch, spec_eng, pa, fa, Q, smi, tag="(x4) preemption",
                   kinds={"mixed_launch": "mixed", "mixed_spec": "mixed",
                          "decode_chunk": "decode_chunks"})
    return dict(crash=dict(pending_at_crash=pending, tokens_before_crash=n_pre,
                           parts_at=at, wall_s=wall),
                preemption={k: v for k, v in pair.items() if k != "launches"})


def phase_x(torch, engine, pa, fa, Q, P, G, M, faults, smi):
    """Speculation on the mixed launch, on (g)'s fleet."""
    t0 = time.time()
    # the kernel counts of this slice's path: the spec wave and the two
    # draft-model waves, each from 0 just before it
    x1, plain_ids, waves = phase_x1(torch, engine, pa, fa, Q, P, G, smi)
    x2, fleets = phase_x2(torch, engine, pa, fa, Q, P, G, smi, plain_ids,
                          x1["plain"]["median_tokens_per_s"], waves)
    x_launches = {k: sum(w[k] for w in waves) for k in waves[0]}
    check(x_launches["ragged_paged_attend"] > 0 and x_launches["paged_flash_attend"] > 0,
          f"(x) a kernel of the speculation path never launched: {x_launches}")
    x3 = phase_x3(torch, engine, pa, P, G, M, fleets[f"{X_DRAFT_LAYERS}-layer draft"])
    del fleets
    torch.cuda.empty_cache()
    x4 = phase_x4(torch, engine, pa, fa, Q, faults, smi)
    print(f"(x) took {time.time() - t0:.1f} s ({smi})")
    print("(x) " + json.dumps({"speculation": dict(x1=x1, x2=x2, x3=x3, x4=x4)}))
    return x_launches


# -- token streaming, cancellation and the OpenAI routes: phase (y) ----------------

Y_DISCONNECT_BUDGET = 900  # (y3)'s max_tokens; the client leaves after two deltas
Y_DIR = "build/chip_smoke_y"  # (y5)'s server log (gitignored)
# (y5): the port's server CLI with (g)'s fleet, warmed before it serves, and a
# tenant weight (both flags the server lacked before)
Y_SERVER = ["--model", MODEL, "--dtype", "bfloat16", "--attn-impl", "auto", "--seed", "0",
            "--continuous", str(FLEET["n_slots"]), "--kv-pool-blocks",
            str(FLEET["kv_pool_blocks"]), "--kv-block-size", str(BLOCK),
            "--continuous-max-seq", str(FLEET["slot_max_seq"]), "--max-tokens-cap", "64",
            "--warmup", "--tenant-weight", "a=3"]


def y_engine(engine, lora=None, cfg=None, **ecfg):
    """(g)'s model and weights (other engine settings; `lora` merged at
    load; `cfg` with other quantization) with a tokenizer whose decode
    spells every id. The byte tokenizer decodes only 256 of tinyllama's
    32000 ids to text, so random weights' output is nearly empty text and a
    stream would carry almost no delta to time; the prompts encode as
    before (the tests hold the byte tokenizer's UTF-8 hold-back on a model
    whose every id is a byte)."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    class SpelledIds(ByteTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    cfg = cfg or engine.cfg
    return create_engine(cfg, params=engine.backend.params, device=DEVICE, lora=lora,
                         tokenizer=SpelledIds(cfg.pad_token_id, cfg.bos_token_id,
                                              cfg.eos_token_id),
                         engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **ecfg))


def y_post(port, path, body):
    """(HTTP code, JSON body) of one POST to any route."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def y_text(ev, sse: bool) -> str:
    """The text an event adds: an NDJSON delta, or an SSE chunk's content."""
    if not sse:
        return ev.get("delta", "") if "done" not in ev else ""
    if not isinstance(ev, dict) or "choices" not in ev:
        return ""
    c = ev["choices"][0]
    return c.get("text") or c.get("delta", {}).get("content") or ""


def y_stream(port, body, path="/generate", sse=False):
    """One streaming POST, read line by line as it arrives: (HTTP code,
    content type, events, seconds to the first text, wall seconds). An
    SSE stream's events are its data objects, its end marker "[DONE]"."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    events, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        code, ctype = r.status, r.headers.get("Content-Type")
        for raw in r:
            line = raw.decode().strip()
            if not line:
                continue
            if sse:
                payload = line[len("data: "):] if line.startswith("data: ") else line
                ev = payload if payload == "[DONE]" else json.loads(payload)
            else:
                ev = json.loads(line)
            if first is None and y_text(ev, sse):
                first = time.perf_counter() - t0
            events.append(ev)
    return code, ctype, events, first, time.perf_counter() - t0


def y_split(tag, events):
    """(deltas, final envelope) of an NDJSON stream, after checking that it
    ended in one final envelope and that its deltas join to the response."""
    check(bool(events) and events[-1].get("done") is True,
          f"{tag}: the stream did not end in a final envelope: {events[-1:]}")
    *deltas, final = events
    check(all("delta" in e for e in deltas), f"{tag}: an event is neither delta nor final")
    text = "".join(e["delta"] for e in deltas)
    check(final.get("status") == "success", f"{tag}: {final}")
    check(text == final["response"], f"{tag}: the joined deltas differ from the response")
    return deltas, final  # the delta events, and the envelope


def y_wave(port, bodies, stream: bool):
    """The bodies at once (NDJSON streams or plain POSTs): per request
    (envelope, seconds to the first delta, wall, deltas), and the wave's
    seconds. Checked after every thread joined."""
    import threading

    out = [None] * len(bodies)

    def run(i):
        try:
            if stream:
                code, ctype, evs, first, wall = y_stream(port, {**bodies[i], "stream": True})
                out[i] = (code, ctype, evs, first, wall)
            else:
                code, r, wall = post(port, bodies[i])
                out[i] = (code, "application/json", [r], None, wall)
        except Exception as e:  # noqa: BLE001 - checked below, on this thread
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wave_s = time.perf_counter() - t0
    rows = []
    for i, res in enumerate(out):
        check(not isinstance(res, Exception), f"(y1) request {i}: {res!r}")
        code, ctype, evs, first, wall = res
        check(code == 200, f"(y1) request {i}: HTTP {code}")
        if stream:
            check(ctype == "application/x-ndjson", f"(y1) request {i}: {ctype}")
            deltas, final = y_split(f"(y1) stream {i}", evs)
        else:
            deltas, final = None, evs[0]
            check(final.get("status") == "success", f"(y1) request {i}: {final}")
        rows.append((final, first, wall, deltas))
    return rows, wave_s


def y_profiled_wave(torch, port, bodies, stream: bool):
    """One wave under torch.profiler (its device kernels read): (rows, wave
    seconds, device busy seconds or None)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rows, wave_s = y_wave(port, bodies, stream)
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    return rows, wave_s, (busy_union_us(kern) / 1e6 if kern else None)


def phase_y1(torch, engine, pa, fa, Q, P, G, fleet, server, smi):
    """8 concurrent NDJSON streams of (g)'s bodies on (g)'s fleet."""
    port = server.port
    L = engine.cfg.n_layers
    bodies = fleet_bodies(range(len(FLEET_PROMPT_TOKENS)))
    greedy = [i for i in range(len(bodies)) if i % 2 == 0]
    # the fresh fleet's first request pays its launch kinds' captures: the
    # cold TTFT (y5)'s warmed server is read against
    code, cold, cold_wall = post(port, bodies[2])
    check(code == 200, f"(y1) the cold first request: {cold}")
    check(fleet.warmup()["ok"], "(y1) fleet warmup")
    # each greedy body alone on the idle fleet, unstreamed then streamed
    lone = {}
    for i in greedy:
        code, r, _ = post(port, bodies[i])
        check(code == 200, f"(y1) body {i} alone: {r}")
        _, _, evs, first, _ = y_stream(port, {**bodies[i], "stream": True})
        _, final = y_split(f"(y1) body {i} streamed alone", evs)
        check(final["token_ids"] == r["token_ids"],
              f"(y1) body {i} streamed alone differs from its unstreamed run alone at "
              f"{parts_at(final['token_ids'], r['token_ids'])}")
        lone[i] = r["token_ids"]
    print(f"(y1) the fresh fleet's cold first request: ttft_s={cold['ttft_s']} "
          f"wall_s={cold_wall:.3f}; each greedy body ({greedy}) streamed alone equals "
          f"its unstreamed run alone ({smi})")
    # the streamed wave: every kernel count from 0 just before it
    before = get(port, "/stats")[1]["continuous"]
    reset_counts(pa, fa, Q)
    rows, wave_s = y_wave(port, bodies, stream=True)
    after = wait_idle(port)["continuous"]
    launches = read_counts(pa, fa, Q)
    mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    n_tok = 0
    for i, (r, first, wall, deltas) in enumerate(rows):
        n_tok += r["tokens_generated"]
        # a delta holds back a partial UTF-8 character: the first one may
        # carry several tokens (tokens_so_far)
        print(f"(y1) stream {i} ({'greedy' if i % 2 == 0 else 'sampled'}): prompt_tokens="
              f"{r['prompt_tokens']} tokens={r['tokens_generated']} deltas={len(deltas)} "
              f"first_delta_s={first:.4f} at tokens_so_far={deltas[0]['tokens_so_far']} "
              f"ttft_s={r['ttft_s']} (first delta - ttft {first - r['ttft_s']:+.4f} s) "
              f"wall_s={wall:.3f}")
        check(r["prompt_tokens"] == FLEET_PROMPT_TOKENS[i] and len(deltas) >= 1,
              f"(y1) stream {i}: {r['prompt_tokens']} prompt tokens, {len(deltas)} deltas")
    parts = []
    for i in greedy:
        got = rows[i][0]["token_ids"]
        at = parts_at(got, lone[i])
        if at is None:
            continue
        ids = engine.tokenizer.encode(bodies[i]["prompt"]) + list(lone[i][:at])
        gap = x_gap(torch, P, G, engine, ids)
        parts.append({"stream": i, "at": at, "gap": gap})
        check(gap < LOGITS_ATOL, f"(y1) stream {i} parts from its run alone at token {at} "
                                 f"where the top-2 gap is {gap:.4f}")
    print(f"(y1) streamed wave: {n_tok} tokens from {len(rows)} streams in {wave_s:.3f} s = "
          f"{n_tok / wave_s:.2f} tokens/s aggregate; greedy streams identical to their "
          f"runs alone: {len(greedy) - len(parts)} of {len(greedy)}, partings "
          f"{json.dumps(parts)} (each at a near-tie, top-2 gap < {LOGITS_ATOL})")
    print(f"(y1) launches: {mixed} mixed, {chunks} decode chunks of {FLEET['chunk_steps']} "
          f"steps; kernel launches {json.dumps(launches)}")
    check(launches["ragged_paged_attend"] == L * mixed > 0,
          f"(y1) ragged_paged_attend launched {launches['ragged_paged_attend']} times for "
          f"{mixed} mixed launches of {L} layers")
    check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks > 0,
          f"(y1) paged_flash_attend launched {launches['paged_flash_attend']} times for "
          f"{chunks} decode chunks")
    others = [k for k in launches if k not in ("ragged_paged_attend", "paged_flash_attend")]
    check(not any(launches[k] for k in others), f"(y1) another kernel ran: {launches}")
    check_graphs("(y1)", after, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
    check(after["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
          "(y1) pool blocks leaked by the streamed wave")
    # aggregate tokens/s in turn (plain, streamed, streamed, plain), then one
    # profiled wave of each: the device's idle share over the wave
    rates = {False: [], True: []}
    for stream in (False, True, True, False):
        wrows, ws = y_wave(port, bodies, stream)
        rates[stream].append(sum(r["tokens_generated"] for r, *_ in wrows) / ws)
        wait_idle(port)
    idle = {}
    for stream in (False, True):
        wrows, ws, busy = y_profiled_wave(torch, port, bodies, stream)
        wait_idle(port)
        idle[stream] = None if busy is None else 1 - busy / ws
        print(f"(y1) profiled {'streamed' if stream else 'unstreamed'} wave: wall_s={ws:.3f} "
              + ("device busy share not measured (the profiler recorded no device kernels)"
                 if busy is None else f"device busy_s={busy:.4f} idle_share={idle[stream]:.4f}"))
    print(f"(y1) aggregate tokens/s in turn: unstreamed {rates[False][0]:.2f}, streamed "
          f"{rates[True][0]:.2f}, streamed {rates[True][1]:.2f}, unstreamed "
          f"{rates[False][1]:.2f} ({smi})")
    return dict(launches=launches, mixed=mixed, chunks=chunks, cold_ttft=cold["ttft_s"],
                rates=rates, idle=idle)


def phase_y2(fleet, server, smi):
    """/v1/models, and both completion routes streamed (SSE) and not."""
    port = server.port
    code, models = get(port, "/v1/models")
    check(code == 200 and models["data"][0]["id"] == MODEL, f"(y2) /v1/models: {models}")
    cases = (("/v1/completions", {"prompt": fleet_prompt(3, 120), "max_tokens": 32,
                                  "temperature": 0}),
             ("/v1/chat/completions", {"messages": [{"role": "user", "content":
                                                     "Tell me about the printing press."}],
                                       "max_tokens": 32, "temperature": 0}))
    for path, body in cases:
        chat = "chat" in path
        code, plain = y_post(port, path, body)
        check(code == 200, f"(y2) {path}: {plain}")
        want = plain["choices"][0]["message"]["content"] if chat else plain["choices"][0]["text"]
        code, ctype, evs, first, wall = y_stream(port, {**body, "stream": True}, path=path,
                                                 sse=True)
        check(code == 200 and ctype.startswith("text/event-stream") and evs[-1] == "[DONE]",
              f"(y2) {path}: HTTP {code} {ctype}, last event {evs[-1:]}")
        chunks = [e for e in evs[:-1] if y_text(e, True)]
        check(first is not None, f"(y2) {path}: no content chunk")
        finals = [e for e in evs[:-1] if e["choices"][0]["finish_reason"]]
        text = "".join(y_text(e, True) for e in evs[:-1])
        check(len(finals) == 1 and finals[0]["usage"] == plain["usage"],
              f"(y2) {path}: final chunks {finals}")
        check(text == want, f"(y2) {path}: the SSE text differs from the unstreamed text")
        print(f"(y2) {path}: unstreamed {plain['usage']['completion_tokens']} tokens, "
              f"finish {plain['choices'][0]['finish_reason']}; SSE {len(chunks)} content "
              f"chunks ending [DONE], first at {first:.4f} s, wall {wall:.3f} s, text "
              f"identical ({smi})")
    wait_idle(port)


def phase_y3(fleet, server, smi):
    """A client gone mid-stream: a 900-token budget, the socket closed after
    two deltas. The slot and every block come back within a scheduler step,
    the cancel is counted, and the next request's tokens are its run alone."""
    import socket

    port = server.port
    nxt = fleet_bodies([4])[0]
    code, alone, _ = post(port, nxt)
    check(code == 200, f"(y3) the next request alone: {alone}")
    metric = fleet.engine.metrics.get("dli_cancelled_total").labels(cause="disconnect")
    cancelled0 = metric.value
    body = json.dumps({"prompt": fleet_prompt(7, 60), "max_tokens": Y_DISCONNECT_BUDGET,
                       "greedy": True, "chat": False, "stream": True})
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall((f"POST /generate HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: "
               f"application/json\r\nContent-Length: {len(body)}\r\n\r\n{body}").encode())
    got = b""
    while got.split(b"\r\n\r\n", 1)[-1].count(b'"delta"') < 2:
        chunk = s.recv(65536)
        check(bool(chunk), "(y3) the stream ended before two deltas")
        got += chunk
    req = next(r for r in fleet._assignment if r is not None)
    s.close()
    t_close = time.perf_counter()
    while not req.cancelled and not req.done.is_set():
        time.sleep(0.0002)
    t_flag = time.perf_counter()
    n_flag = fleet.mixed_launches + fleet.chunk_launches
    while fleet.stats()["occupied"]:
        check(time.perf_counter() - t_flag < 30, "(y3) the cancelled slot never freed")
        time.sleep(0.0002)
    t_free = time.perf_counter()
    steps = fleet.mixed_launches + fleet.chunk_launches - n_flag
    st = fleet.stats()
    print(f"(y3) closed after 2 deltas ({len(req.tokens) + 1} tokens fetched of "
          f"{Y_DISCONNECT_BUDGET}): cancel flagged {t_flag - t_close:.4f} s after the "
          f"close, the slot free {t_free - t_flag:.4f} s later, {steps} launch(es) issued "
          f"between; free blocks {st['paged']['free_blocks']} of "
          f"{FLEET['kv_pool_blocks'] - 1}; dli_cancelled_total{{cause=\"disconnect\"}} "
          f"{metric.value - cancelled0:g} ({smi})")
    check(req.result is not None and req.result.get("error_type") == "cancelled",
          f"(y3) the request was not cancelled: {req.result}")
    check(steps <= 1, f"(y3) {steps} launches before the cancelled slot freed")
    check(st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
          "(y3) blocks not back after the cancel")
    check(metric.value - cancelled0 == 1, "(y3) dli_cancelled_total did not count 1")
    code, after, _ = post(port, nxt)
    check(code == 200 and after["token_ids"] == alone["token_ids"],
          f"(y3) the request admitted after the cancel differs from its run alone at "
          f"{parts_at(after.get('token_ids', []), alone['token_ids'])}")
    graphs = wait_idle(port)["continuous"]["graphs"]
    check(all(g["captures"] == 1 for g in graphs.values()),
          f"(y3) a launch kind was captured again: {graphs}")
    print(f"(y3) the request admitted right after: {after['tokens_generated']} tokens, "
          f"identical to its run alone; graphs {json.dumps(graphs)}")


def phase_y4(torch, engine, P, G, smi):
    """A --spec-decode stream: verify rows land several tokens per fetch."""
    eng = y_engine(engine, spec_decode=True)
    fleet, server = fleet_server(eng, FLEET)
    try:
        check(fleet.warmup()["ok"], "(y4) fleet warmup")
        body = x_bodies()[0]
        code, plain, _ = post(server.port, body)
        check(code == 200, f"(y4) unstreamed: {plain}")
        _, _, evs, first, wall = y_stream(server.port, {**body, "stream": True})
        deltas, final = y_split("(y4) the --spec-decode stream", evs)
        steps = [deltas[0]["tokens_so_far"]] + [
            b["tokens_so_far"] - a["tokens_so_far"] for a, b in zip(deltas, deltas[1:])]
        at = parts_at(final["token_ids"], plain["token_ids"])
        gap = None
        if at is not None:
            ids = engine.tokenizer.encode(body["prompt"]) + list(plain["token_ids"][:at])
            gap = x_gap(torch, P, G, engine, ids)
            check(gap < LOGITS_ATOL, f"(y4) the stream parts from its unstreamed run at "
                                     f"{at}, top-2 gap {gap:.4f}")
        print(f"(y4) --spec-decode stream of {final['tokens_generated']} tokens: "
              f"{len(deltas)} deltas (most tokens in one delta {max(steps)}), "
              f"spec_drafted={final.get('spec_drafted')} "
              f"spec_accepted={final.get('spec_accepted')}, first delta {first:.4f} s, "
              f"ttft_s {final['ttft_s']}; its unstreamed run alone "
              + ("identical" if at is None else f"parts at {at}, top-2 gap {gap:.4f}")
              + f" ({smi})")
        check(final.get("spec_drafted", 0) > 0, f"(y4) no verify row ran: {final}")
    finally:
        server.shutdown()


def phase_y5(y1, smi):
    """The server CLI with --warmup --tenant-weight a=3 in a subprocess: its
    first request's TTFT beside the fresh in-process fleet's cold one; then
    the client CLI against it, streamed."""
    srv = Holder("server", base=Y_SERVER, log_dir=Y_DIR)
    try:
        log = srv.tail()
        check("warm:" in log and "continuous warm in" in log,
              f"(y5) the server did not report its warmups: {log}")
        body = {**fleet_bodies([2])[0], "tenant": "a"}
        code, r, wall = post(srv.port, body)
        check(code == 200 and r.get("tenant") == "a", f"(y5) first request: {r}")
        print(f"(y5) the server CLI ({' '.join(Y_SERVER)}) up in {srv.start_s:.1f} s "
              f"(warmups: {' | '.join(l for l in log.splitlines() if 'warm' in l)}); its "
              f"first request ttft_s={r['ttft_s']} wall_s={wall:.3f} against the cold "
              f"fleet's first ttft_s={y1['cold_ttft']} ({smi})")
        cli = subprocess.run(
            [sys.executable, "-m", "distributed_llm_inference_tpu_torch.client", "--url",
             srv.url, "--prompt", "Hello from the client", "--max-tokens", "16", "--stream"],
            capture_output=True, text=True, timeout=300)
        out = cli.stdout.strip().splitlines()
        print("(y5) the client CLI, streamed: rc " f"{cli.returncode}; "
              + " / ".join(line.strip() for line in out[-2:]))
        check(cli.returncode == 0 and "tok/s" in cli.stdout,
              f"(y5) the client CLI failed: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    finally:
        srv.close()


def phase_y(torch, engine, pa, fa, Q, P, G, smi):
    """Token streaming, cancellation and the OpenAI routes on (g)'s fleet
    through the port's HTTP server (an engine of its own over the same
    weights, so its metrics count from 0)."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    t0 = time.time()
    eng = y_engine(engine)
    fleet = ContinuousEngine(eng, **FLEET)
    server = InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=1024,
                             continuous=fleet)
    server.start()
    try:
        y1 = phase_y1(torch, engine, pa, fa, Q, P, G, fleet, server, smi)
        phase_y2(fleet, server, smi)
        phase_y3(fleet, server, smi)
    finally:
        server.shutdown()
    phase_y4(torch, engine, P, G, smi)
    phase_y5(y1, smi)
    print(f"(y) took {time.time() - t0:.1f} s")
    print("(y) " + json.dumps({"streaming": {
        "launches": y1["launches"], "mixed": y1["mixed"], "decode_chunks": y1["chunks"],
        "tokens_per_s": {"unstreamed": y1["rates"][False], "streamed": y1["rates"][True]},
        "idle_share": {"unstreamed": y1["idle"][False], "streamed": y1["idle"][True]}}}))
    return y1["launches"]


# -- runtime LoRA adapters on the paged fleet: phase (z) ----------------------------

Z_DIR = "build/chip_smoke_z"  # the adapters' PEFT directories and (z5)'s logs (gitignored)
Z_SLOTS, Z_RANK = 4, 8  # --adapter-slots 4 --adapter-rank 8
# (name, rank, lora_alpha, rsLoRA, stored in BF16); each adapts all seven
# projections with random A and B of standard deviation Z_STD from its
# seed: a delta of some 20-40 % of a projection's output, which moves the
# logits well past LOGITS_ATOL and leaves them finite (checked in (z3))
Z_ADAPTERS = (("z-a1", 8, 16, False, False), ("z-a2", 4, 8, False, False),
              ("z-a3", 8, 8, True, False), ("z-a4", 4, 8, False, True),
              ("z-a5", 8, 16, False, False))
Z_STD = 0.03
# (z1)'s wave, (fleet body, adapter): 2 base requests and 6 over the 5
# adapters. z-a5's request is sent once the other 7 hold their slots (and
# z-a1..z-a4 the 4 pages): it waits for a page to free, then swaps it
Z_WAVE = ((0, None), (1, "z-a2"), (2, "z-a3"), (3, None), (4, "z-a4"), (5, "z-a1"),
          (6, "z-a1"), (7, "z-a5"))
Z_CRASH_REQ = (200, 64)  # (z6)'s request under z-a1: (prompt tokens, new tokens)
Z_CRASH_CALL = 6  # its decode_launch fault: the 4th decode chunk, mid-decode
# (z5)'s server CLI: (g)'s fleet
Z_SERVER = ["--model", MODEL, "--dtype", "bfloat16", "--attn-impl", "auto", "--seed", "0",
            "--continuous", str(FLEET["n_slots"]), "--kv-pool-blocks",
            str(FLEET["kv_pool_blocks"]), "--kv-block-size", str(BLOCK),
            "--continuous-max-seq", str(FLEET["slot_max_seq"]), "--max-tokens-cap", "64"]


def z_write_adapters(cfg, root=Z_DIR) -> dict:
    """Z_ADAPTERS as PEFT directories under `root` (numpy only, seeds 1-5):
    {name: directory}."""
    import numpy as np

    from distributed_llm_inference_tpu_torch.models.lora import write_peft_adapter

    D, Dh, H, KV, F = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim
    dims = {"q_proj": (D, H * Dh), "k_proj": (D, KV * Dh), "v_proj": (D, KV * Dh),
            "o_proj": (H * Dh, D), "gate_proj": (D, F), "up_proj": (D, F),
            "down_proj": (F, D)}
    dirs = {}
    for seed, (name, r, alpha, rslora, bf16) in enumerate(Z_ADAPTERS, start=1):
        rng = np.random.default_rng(seed)
        f = {m: (rng.standard_normal((cfg.n_layers, r, i), dtype=np.float32) * Z_STD,
                 rng.standard_normal((cfg.n_layers, o, r), dtype=np.float32) * Z_STD)
             for m, (i, o) in dims.items()}
        dirs[name] = write_peft_adapter(f"{root}/{name}", f, r=r, lora_alpha=alpha,
                                        use_rslora=rslora, bf16=bf16)
    return dirs


def phase_z1(torch, engine, pa, fa, Q, fleet, server, smi):
    """(g)'s wave on the pool fleet, 6 of its 8 requests on adapters."""
    import threading

    port, pool, L = server.port, fleet.engine.adapters, engine.cfg.n_layers
    bodies = fleet_bodies(range(len(FLEET_PROMPT_TOKENS)))
    for i, ad in Z_WAVE:
        if ad:
            bodies[i]["adapter"] = ad
    before = get(port, "/stats")[1]["continuous"]
    p0 = pool.stats()
    out = [None] * len(bodies)

    def run(i):
        try:
            out[i] = post(port, bodies[i])
        except Exception as e:  # noqa: BLE001 - checked below, on this thread
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    reset_counts(pa, fa, Q)  # the main path's run starts here
    t0 = time.perf_counter()
    for t in threads[:-1]:
        t.start()
    while True:  # the 7 hold their slots (and 4 pages) before z-a5 comes
        st = fleet.stats()
        if st["occupied"] + st["completed"] - before["completed"] >= len(bodies) - 1:
            break
        check(time.perf_counter() - t0 < 60, f"(z1) the first 7 were not admitted: {st}")
        time.sleep(0.001)
    held = pool.stats()
    threads[-1].start()
    for t in threads:
        t.join()
    wave_s = time.perf_counter() - t0
    after = wait_idle(port)["continuous"]
    launches = read_counts(pa, fa, Q)
    ps = pool.stats()
    mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
    chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
    for (i, ad), res in zip(Z_WAVE, out):
        check(not isinstance(res, Exception), f"(z1) request {i}: {res!r}")
        code, r, wall = res
        print(f"(z1) request {i} ({'greedy' if i % 2 == 0 else 'sampled'}, "
              f"{ad or 'base'}): HTTP {code} prompt_tokens={r.get('prompt_tokens')} "
              f"tokens={r.get('tokens_generated')} ttft_s={r.get('ttft_s')} "
              f"adapter={r.get('adapter')} wall_s={wall:.3f}")
        check(code == 200 and r.get("status") == "success" and r.get("adapter") == ad,
              f"(z1) request {i}: {r}")
        check(r["prompt_tokens"] == FLEET_PROMPT_TOKENS[i]
              and (r["tokens_generated"] == FLEET_NEW_TOKENS or r["finish_reason"] == "stop"),
              f"(z1) request {i}: {r}")
    moved = {k: ps[k] - p0[k] for k in ("loads", "evictions", "swaps")}
    print(f"(z1) wave of 8 (2 base, 6 over 5 adapters on {Z_SLOTS} pages): {wave_s:.3f} s; "
          f"pool when z-a5 was sent {json.dumps(held)}; loads/evictions/swaps "
          f"{json.dumps(moved)}; pool after {json.dumps(ps)}; launches: {mixed} mixed, "
          f"{chunks} decode chunks; kernel launches {json.dumps(launches)} ({smi})")
    check(moved == {"loads": 5, "evictions": 1, "swaps": 1},
          f"(z1) the schedule forces 5 loads, 1 eviction, 1 swap: {moved}")
    check(ps["referenced"] == 0 and ps["free"] == Z_SLOTS, f"(z1) pages held after: {ps}")
    check(after["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
          "(z1) pool blocks leaked by the wave")
    check(launches["ragged_paged_attend"] == L * mixed > 0,
          f"(z1) ragged_paged_attend launched {launches['ragged_paged_attend']} times for "
          f"{mixed} mixed launches of {L} layers")
    check(launches["paged_flash_attend"] == L * FLEET["chunk_steps"] * chunks > 0,
          f"(z1) paged_flash_attend launched {launches['paged_flash_attend']} times for "
          f"{chunks} decode chunks")
    others = [k for k in launches if k not in ("ragged_paged_attend", "paged_flash_attend")]
    check(not any(launches[k] for k in others), f"(z1) another kernel ran: {launches}")
    check_graphs("(z1)", after, {"mixed_launch": "mixed", "decode_chunk": "decode_chunks"})
    return dict(launches=launches, mixed=mixed, chunks=chunks, wave_s=wave_s, pool=moved)


def phase_z2(torch, engine, P, G, fleet, dirs, smi):
    """Identity: a base request on the pool fleet against a fleet with no
    pool (bit for bit); an adapter request against merge-at-load."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine

    body = fleet_bodies([6])[0]  # 480 prompt tokens, greedy
    prompt, kw = body.pop("prompt"), body
    plain = ContinuousEngine(y_engine(engine), **FLEET)
    merged_eng = y_engine(engine, lora=dirs["z-a1"])
    merged = ContinuousEngine(merged_eng, **FLEET)
    try:
        base = fleet.submit(prompt, **kw)
        want = plain.submit(prompt, **kw)
        print(f"(z2) a base request alone on the pool fleet and on a fleet with no pool: "
              f"{base['tokens_generated']} tokens, identical="
              f"{base['token_ids'] == want['token_ids']}")
        check(base["token_ids"] == want["token_ids"],
              f"(z2) the base request differs from the no-pool fleet's at "
              f"{parts_at(base['token_ids'], want['token_ids'])}")
        got = fleet.submit(prompt, adapter="z-a1", **kw)
        ref = merged.submit(prompt, **kw)
        at = parts_at(got["token_ids"], ref["token_ids"])
        gap = None
        if at is not None:
            ids = merged_eng.tokenizer.encode(prompt) + list(ref["token_ids"][:at])
            gap = x_gap(torch, P, G, merged_eng, ids)
            check(at >= 8 or gap <= 0.05, f"(z2) the adapter request parts from "
                                          f"merge-at-load at token {at}, top-2 gap {gap:.4f}")
        print(f"(z2) z-a1 alone through its pool page and merged at load "
              f"(create_engine(lora=...)): {got['tokens_generated']} tokens, "
              + ("identical" if at is None else
                 f"part at token {at} where the merged model's top-2 gap is {gap:.4f}")
              + f"; the adapter moved the stream from the base's: "
              f"{got['token_ids'] != base['token_ids']} ({smi})")
        check(got["token_ids"] != base["token_ids"], "(z2) z-a1 did not move the stream")
    finally:
        plain.close()
        merged.close()
    return dict(merged_ids=ref["token_ids"], parts_at=at, gap=gap)


def phase_z3(torch, engine, P, G, M, dirs, smi):
    """(z3) the kernels against the plain path with rows on pages 0, 1 and
    3; the fleet's two launch kinds captured on the base pages, adapters
    loaded in place, the replays bit-equal to eager; (z4) their profiled
    replays with no pool, with a pool and base rows, and with rows on 4
    adapters."""
    from distributed_llm_inference_tpu_torch.engine import graphs

    eng = y_engine(engine, adapter_slots=Z_SLOTS, adapter_rank=Z_RANK)
    pool = eng.adapters
    for name, *_ in Z_ADAPTERS[:4]:
        pool.register(name, dirs[name])
    cfg, K, B = eng.cfg, FLEET["chunk_steps"], FLEET["n_slots"]
    L = cfg.n_layers
    want_m, want_c = {"ragged_paged_attend": L}, {"paged_flash_attend": L * K}
    pages = torch.zeros(B, dtype=torch.int32, device=DEVICE)

    def kinds(be, pg):
        ops, n_tok = fleet_operands(torch, cfg, P, G)
        gen = ops["generator"]
        bufs = dict(cache=ops["pool"], table=ops["table"], state=ops["state"],
                    sparams=ops["sparams"],
                    inputs=graphs.MixedInputs(ops["tokens"], ops["tok_row"], ops["tok_pos"],
                                              ops["dec_flag"], ops["meta"], ops["dec_idx"],
                                              ops["arm"], ops["dev"]))
        if pg is not None:
            bufs["pages"] = pg

        def mixed(b, g):
            return graphs.mixed_launch(be, b["inputs"], b["cache"], b["table"], b["state"],
                                       b["sparams"], g, pages=b.get("pages"))

        def chunk(b, g):
            return graphs.decode_chunk(be, b["state"], b["sparams"], b["cache"], b["table"],
                                       g, K, pages=b.get("pages"))

        return dict(bufs=bufs, gen=gen, n_tok=n_tok, mixed=mixed, chunk=chunk,
                    pre=clone_tree(torch, (bufs["state"], bufs["sparams"])),
                    lg_m=graphs.LaunchGraph(lambda: mixed(bufs, gen), "mixed", DEVICE, gen),
                    lg_c=graphs.LaunchGraph(lambda: chunk(bufs, gen), "chunk", DEVICE, gen))

    def measure(k, label):
        b, gen = k["bufs"], k["gen"]
        graphs.commit((b["state"], b["sparams"]), k["pre"])
        m = graph_kind(torch, graphs, "(z4)", f"mixed launch, {label}", k["lg_m"], k["mixed"],
                       b, gen, lambda p: k["n_tok"], want_m, eager=False)
        graphs.commit((b["state"], b["sparams"]), k["pre"])
        k["mixed"](b, gen)  # arms the 8th slot: the chunk decodes 8 rows
        c = graph_kind(torch, graphs, "(z4)", f"decode chunk of {K} steps, {label}",
                       k["lg_c"], k["chunk"], b, gen, lambda p: int(p[K:2 * K].sum()), want_c,
                       eager=False)
        return {"mixed": m, "chunk": c}

    rows = {}
    nopool = kinds(engine.backend, None)
    rows["no pool"] = measure(nopool, "no pool")
    nopool["lg_m"].close()
    nopool["lg_c"].close()
    k = kinds(eng.backend, pages)
    rows["pool, base rows"] = measure(k, "pool, every row on page 0")
    # the adapters load into their pages IN PLACE after the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pool.acquire(Z_ADAPTERS[0][0])
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    land_ms = (time.perf_counter() - t0) * 1e3
    page = {Z_ADAPTERS[0][0]: first}
    for name, *_ in Z_ADAPTERS[1:4]:
        page[name] = pool.acquire(name)
    ids = [page[n] for n, *_ in Z_ADAPTERS[:4]]
    pages.copy_(torch.tensor(ids + ids, dtype=torch.int32))
    rows["pool, 4 adapters"] = measure(k, "pool, rows on 4 adapters (loaded after capture)")
    check(k["lg_m"].captures == 1 and k["lg_c"].captures == 1,
          "(z3) a launch kind was captured again after the pages loaded")
    k["lg_m"].close()
    k["lg_c"].close()
    print(f"(z3) the mixed launch and the decode chunk captured on the base pages, 4 "
          f"adapters then loaded in place: every replay bit-equal to eager under the sync "
          f"check ({smi})")
    print(f"(z4) pool_bytes={pool.pool_bytes} ({Z_SLOTS} pages + the base page, rank "
          f"{Z_RANK}); one page load: host {host_ms:.3f} ms, landed {land_ms:.3f} ms "
          f"({smi})")
    summary = {}
    for state, r in rows.items():
        for kind, row in r.items():
            rep = row["replay"]
            if not isinstance(rep, dict):
                summary[f"{kind}, {state}"] = rep
                continue
            summary[f"{kind}, {state}"] = {x: rep[x] for x in ("busy_ms", "idle_share",
                                                                "kernels", "kernels_per_token")}
            summary[f"{kind}, {state}"]["replay_span_ms"] = row["replay_span_ms"]
    for name, v in summary.items():
        print(f"(z4) {name}: {json.dumps(v)}")
    # (z3) the kernels against the plain path with rows on pages 0, 1 and 3
    pg = torch.tensor([0, page["z-a1"], page["z-a3"]], dtype=torch.int32, device=DEVICE)
    kern, row = scripted_fleet_logits(torch, cfg, eng.backend.params, P, M, pages=pg)
    plain, _ = scripted_fleet_logits(torch, cfg.replace(attn_impl="plain"),
                                     eng.backend.params, P, M, pages=pg)
    check_kernel_vs_plain(torch, "(z3) rows on pages 0, 1 and 3:", kern, plain, LOGITS_ATOL)
    base, _ = scripted_fleet_logits(torch, cfg, eng.backend.params, P, M)
    on = pg[row] > 0
    moved = (kern[on] - base[on]).abs().max().item()
    print(f"(z3) against the same launches with no pages: the page-0 row bit-equal="
          f"{torch.equal(kern[~on], base[~on])}, the adapter rows' logits move by up to "
          f"{moved:.3f} (LOGITS_ATOL {LOGITS_ATOL}), finite={bool(torch.isfinite(kern).all())}")
    check(torch.equal(kern[~on], base[~on]), "(z3) the page-0 row differs from the base")
    check(moved > LOGITS_ATOL and bool(torch.isfinite(kern).all()),
          f"(z3) the adapters move the logits by {moved:.4f}")
    for name in page:
        pool.release(name)
    return dict(rows=summary, pool_bytes=pool.pool_bytes, load_host_ms=host_ms,
                load_landed_ms=land_ms, logits_moved=moved)


def phase_z5(fleet, server, dirs, z2, smi):
    """The OpenAI routes on the pool fleet, then the server CLI: --lora
    serves, --adapter on the --lora directory is refused at start."""
    port = server.port
    code, models = get(port, "/v1/models")
    names = {m["id"]: m.get("root") for m in models["data"]}
    check(code == 200 and all(names.get(n) == MODEL for n, *_ in Z_ADAPTERS),
          f"(z5) /v1/models: {models}")
    body = {"messages": [{"role": "user", "content": "Tell me about the printing press."}],
            "max_tokens": 32, "temperature": 0, "model": "z-a3"}
    code, plain = y_post(port, "/v1/chat/completions", body)
    check(code == 200 and plain["model"] == "z-a3", f"(z5) chat: {plain}")
    want = plain["choices"][0]["message"]["content"]
    code, ctype, evs, first, wall = y_stream(port, {**body, "stream": True},
                                             path="/v1/chat/completions", sse=True)
    text = "".join(y_text(e, True) for e in evs[:-1])
    check(code == 200 and evs[-1] == "[DONE]" and text == want and want,
          f"(z5) the SSE text differs from the unstreamed text: {text!r} {want!r}")
    code, bad = y_post(port, "/v1/completions", {"model": "nope", "prompt": "x",
                                                 "max_tokens": 4})
    check(code == 400 and bad["error"]["param"] == "model", f"(z5) unknown model: {bad}")
    print(f"(z5) /v1/models lists {sorted(names)}; /v1/chat/completions with model z-a3: "
          f"SSE text ({len(evs) - 1} chunks, first at {first:.4f} s) equal to the "
          f"unstreamed text; model 'nope' -> HTTP 400")
    # the CLI: --lora z-a1 with two runtime adapters; --adapter on z-a1 refused
    refused = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_inference_tpu_torch.serving.server",
         *Z_SERVER, "--lora", dirs["z-a1"], "--adapter-slots", "2", "--adapter",
         f"dup={dirs['z-a1']}", "--host", "127.0.0.1", "--port", str(free_port())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    srv = Holder("lora", extra=["--lora", dirs["z-a1"], "--adapter-slots", "2", "--adapter",
                                f"z-a2={dirs['z-a2']}", "--adapter", f"z-a3={dirs['z-a3']}"],
                 base=Z_SERVER, log_dir=Z_DIR)
    try:
        out, _ = refused.communicate(timeout=300)
        check(refused.returncode not in (0, None) and "already merged" in out,
              f"(z5) --adapter on the --lora directory was not refused: "
              f"{refused.returncode} {out[-2000:]}")
        body = fleet_bodies([6])[0]
        code, r, wall = post(srv.port, body)
        check(code == 200 and r.get("status") == "success", f"(z5) --lora request: {r}")
        code, ra, _ = post(srv.port, {**body, "adapter": "z-a2"})
        check(code == 200 and ra.get("adapter") == "z-a2", f"(z5) adapter request: {ra}")
        code, models = get(srv.port, "/v1/models")
        check(sorted(m["id"] for m in models["data"]) == sorted([MODEL, "z-a2", "z-a3"]),
              f"(z5) the CLI's /v1/models: {models}")
        code, bad = y_post(srv.port, "/v1/completions", {"model": "z-a1", "prompt": "x",
                                                         "max_tokens": 4})
        check(code == 400, f"(z5) the merged adapter's name as a model: {bad}")
        print(f"(z5) the server CLI ({' '.join(Z_SERVER)} --lora z-a1 --adapter-slots 2 "
              f"--adapter z-a2=... --adapter z-a3=...) up in {srv.start_s:.1f} s: a request "
              f"{r['tokens_generated']} tokens (the in-process merged fleet's "
              f"{'identical' if r['token_ids'] == z2['merged_ids'] else 'NOT identical'}), "
              f"z-a2 echoed, /v1/models {[m['id'] for m in models['data']]}; "
              f"--adapter dup=<the --lora dir> refused at start (rc {refused.returncode}: "
              f"{[l for l in out.splitlines() if 'already merged' in l][-1][:160]}) ({smi})")
    finally:
        if refused.poll() is None:
            refused.kill()
            refused.wait(timeout=15)
        srv.close()


def phase_z6_crash(torch, engine, faults, fleet, server, smi):
    """A decode_launch crash with adapters resident: the recovered request's
    tokens fetched before the crash are its unfaulted run's, and the crash
    loads no page again."""
    port, pool = server.port, fleet.engine.adapters
    body = {"prompt": fleet_prompt(9, Z_CRASH_REQ[0]), "max_tokens": Z_CRASH_REQ[1],
            "greedy": True, "chat": False, "adapter": "z-a1"}
    code, ref, _ = post(port, body)
    check(code == 200, f"(z6) the unfaulted run: {ref}")
    st0, p0 = wait_idle(port)["continuous"], pool.stats()
    spy = FleetSpy(fleet)
    faults.arm([faults.FaultRule("decode_launch", "transient", on_call=Z_CRASH_CALL)])
    try:
        code, r, wall = post(port, body)
    finally:
        faults.disarm()
    st, ps = wait_idle(port)["continuous"], pool.stats()
    restarts = st["supervisor"]["restarts"] - st0["supervisor"]["restarts"]
    n_pre = spy.salvaged.get(body["prompt"], 0)
    print(f"(z6) decode_launch crash (call {Z_CRASH_CALL}) under z-a1 with {ps['resident']} "
          f"adapters resident: HTTP {code} tokens={r.get('tokens_generated')} "
          f"recovered={r.get('recovered')} restarts +{restarts}; {n_pre} tokens fetched "
          f"before it; loads {p0['loads']} -> {ps['loads']}; wall {wall:.3f} s ({smi})")
    check(code == 200 and r.get("adapter") == "z-a1"
          and r["tokens_generated"] == len(ref["token_ids"]), f"(z6) crash: {r}")
    check(restarts == 1 and n_pre > 0, f"(z6) crash: {restarts} restarts, {n_pre} tokens "
                                       f"fetched before it")
    check(ps["loads"] == p0["loads"] and ps["referenced"] == 0,
          f"(z6) the crash moved the pool: {p0} -> {ps}")
    check(st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1,
          "(z6) crash: pool blocks leaked")
    check(all(g["captures"] == 1 for g in st["graphs"].values()),
          f"(z6) crash: graphs recaptured {st['graphs']}")
    at = check_identity("(z6) crash", r["token_ids"], ref["token_ids"], n_pre)
    return dict(tokens_before_crash=n_pre, parts_at=at)


def phase_z6_quant(torch, engine, pa, fa, Q, dirs, smi):
    """One adapter request under --quant int4 --kv-quant int8
    --adapter-slots 2: q4_matmul_rows as in (k), under the dense delta."""
    L, K = engine.cfg.n_layers, FLEET["chunk_steps"]
    t0 = time.time()
    qeng = y_engine(engine, cfg=engine.cfg.replace(quant="int4", kv_quant="int8"),
                    adapter_slots=2, adapter_rank=Z_RANK)
    qeng.adapters.register("z-a1", dirs["z-a1"])
    fleet, server = fleet_server(qeng, FLEET)
    try:
        check(fleet.warmup()["ok"], "(z6) quantized fleet warmup")
        build_s = time.time() - t0
        before = get(server.port, "/stats")[1]["continuous"]
        reset_counts(pa, fa, Q)
        code, r, wall = post(server.port, {**fleet_bodies([4])[0], "adapter": "z-a1"})
        after = wait_idle(server.port)["continuous"]
        launches = read_counts(pa, fa, Q)
        mixed = after["launches"]["mixed"] - before["launches"]["mixed"]
        chunks = after["launches"]["decode_chunks"] - before["launches"]["decode_chunks"]
        q4_want = (7 * L + 1) * K * chunks + 2 * mixed
        print(f"(z6) --quant int4 --kv-quant int8 --adapter-slots 2 (built, quantized and "
              f"warm in {build_s:.1f} s): z-a1 request HTTP {code} "
              f"tokens={r.get('tokens_generated')} adapter={r.get('adapter')}; {mixed} mixed "
              f"launches, {chunks} decode chunks; kernel launches {json.dumps(launches)} "
              f"({smi})")
        check(code == 200 and r.get("adapter") == "z-a1", f"(z6) quantized: {r}")
        check(launches["q4_matmul_rows"] == q4_want > 0,
              f"(z6) q4_matmul_rows launched {launches['q4_matmul_rows']} times, {q4_want} "
              f"expected")
        check(launches["ragged_paged_attend[int8]"] == L * mixed
              and launches["paged_flash_attend[int8]"] == L * K * chunks,
              f"(z6) the int8 paged kernels: {launches}")
        check(after["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
              and after["adapters"]["referenced"] == 0, f"(z6) quantized: {after}")
    finally:
        server.shutdown()
    return launches


def phase_z(torch, engine, pa, fa, Q, P, G, M, faults, smi):
    """Runtime LoRA adapters on (g)'s fleet: an engine of its own over the
    same weights with a 4-page rank-8 pool and five adapters."""
    import shutil

    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    t0 = time.time()
    shutil.rmtree(Z_DIR, ignore_errors=True)
    dirs = z_write_adapters(engine.cfg)
    eng = y_engine(engine, adapter_slots=Z_SLOTS, adapter_rank=Z_RANK)
    t1 = time.time()
    for name in dirs:
        eng.adapters.register(name, dirs[name])
    print(f"(z) {len(dirs)} PEFT adapters written in {t1 - t0:.1f} s (ranks 4 and 8, one "
          f"rsLoRA, one BF16 file), registered in {time.time() - t1:.1f} s; pool "
          f"{Z_SLOTS} pages of rank {Z_RANK}, {eng.adapters.pool_bytes} bytes")
    fleet = ContinuousEngine(eng, **FLEET)
    server = InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=1024,
                             continuous=fleet)
    server.start()
    secs = {}

    def timed(tag, fn, *a):
        t = time.time()
        out = fn(*a)
        secs[tag] = round(time.time() - t, 1)
        return out

    try:
        check(fleet.warmup()["ok"], "(z1) fleet warmup")
        z1 = timed("z1", phase_z1, torch, engine, pa, fa, Q, fleet, server, smi)
        z2 = timed("z2", phase_z2, torch, engine, P, G, fleet, dirs, smi)
        z3 = timed("z3+z4", phase_z3, torch, engine, P, G, M, dirs, smi)
        timed("z5", phase_z5, fleet, server, dirs, z2, smi)
        z6 = timed("z6 crash", phase_z6_crash, torch, engine, faults, fleet, server, smi)
    finally:
        server.shutdown()
    qlaunches = timed("z6 int4", phase_z6_quant, torch, engine, pa, fa, Q, dirs, smi)
    for name, *_ in Z_ADAPTERS:
        shutil.rmtree(f"{Z_DIR}/{name}", ignore_errors=True)
    print(f"(z) took {time.time() - t0:.1f} s: {json.dumps(secs)}")
    print("(z) " + json.dumps({"adapters": {
        "launches": z1["launches"], "mixed": z1["mixed"], "decode_chunks": z1["chunks"],
        "wave_s": z1["wave_s"], "pool": z1["pool"], "merge_identity": {
            "parts_at": z2["parts_at"], "gap": z2["gap"]},
        "cost": z3["rows"], "pool_bytes": z3["pool_bytes"],
        "page_load_ms": {"host": z3["load_host_ms"], "landed": z3["load_landed_ms"]},
        "crash": z6, "quantized_launches": qlaunches}}))
    return {k: z1["launches"][k] + qlaunches[k] for k in z1["launches"]}


# -- (C) grammar constraints (constrain/) -----------------------------------------

C_SCHEMA = {"type": "object",
            "properties": {"ok": {"type": "boolean"},
                           "color": {"enum": ["red", "green", "blue"]}},
            "required": ["ok", "color"]}
C_PHONE = {"regex": "[0-9]{3}-[0-9]{4}"}
C_CHOICES = {"choices": ["alpha", "beta", "gamma"]}
C_HEX = {"regex": "[0-9a-f]{64}"}  # (C4)'s solo pair: 64 tokens, then the forced stop
C_LONG = {"regex": "[0-9a-f ]{300}"}  # (C4)'s profiled chunk: no stop within a chunk
C_THIRD = {"regex": "[a-f]{2,5}"}  # (C3)'s in-place rewrite inside the bucket
C_FSM_SMALL = 16  # (C2)'s small fleet table: the schema's DFA never fits


def c_ids(text: str) -> list:
    """The ids a SpelledIds response spells."""
    return [int(t) for t in text.split()]


def c_text(ids) -> str:
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    return ByteTokenizer().decode(ids)


def c_walk(art, ids, eos_ids) -> str:
    """How `ids` (a stop token excluded) sit in the DFA of `art`: "complete"
    (every token allowed, and a stop token allowed at the end), "live
    prefix" (every token allowed, not complete yet) or the first
    violation."""
    st = art.start
    for i, t in enumerate(ids):
        if not art.mask[st, t]:
            return f"VIOLATION at token {i} ({t})"
        st = art.advance(st, t)
    return ("complete" if any(art.mask[st, e] for e in eos_ids if e < art.mask.shape[1])
            else "live prefix")


def c_prefill_chunks(engine, text_or_messages, chat: bool) -> int:
    """The solo engine's T>1 chunks for a prompt (chunk_shapes' count)."""
    text = engine.render_chat(text_or_messages) if chat else text_or_messages
    n_full, _rem, _bucket, _chunk = engine._plan_ingest(
        len(engine.tokenizer.encode(text)), 0, engine._buckets())
    return n_full + 1


def phase_C1(torch, ceng, pa, fa, Q, smi):
    """The main path's paged fleet (g) through the HTTP server: constrained
    /generate and /v1/chat/completions requests go to the solo engine,
    whose prefills run flash_attend; an unconstrained request at the same
    time runs the mixed launch. Returns the (C4) solo numbers."""
    import threading

    L = ceng.cfg.n_layers
    eos = ceng.cfg.all_stop_ids
    fleet, server = fleet_server(ceng, FLEET)
    port = server.port
    out = {}
    try:
        check(fleet.warmup()["ok"], "(C1) fleet warmup")
        reset_counts(pa, fa, Q)  # the main path's run starts here
        reqs = [
            ("regex", "/generate", {"prompt": "Call me at", "chat": False, "greedy": True,
                                    "max_tokens": 16, "constraint": C_PHONE}),
            ("choices", "/generate", {"prompt": "Pick one:", "chat": False,
                                      "greedy": True, "max_tokens": 16,
                                      "constraint": C_CHOICES}),
            ("json_schema", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "Describe the sky as JSON."}],
                "max_tokens": 64, "temperature": 0,
                "response_format": {"type": "json_schema",
                                    "json_schema": {"name": "sky", "schema": C_SCHEMA}}}),
            ("json_object", "/generate", {"prompt": "A JSON object:", "chat": False,
                                          "temperature": 1.0, "top_k": 0, "top_p": 1.0,
                                          "seed": 7, "max_tokens": 96,
                                          "constraint": {"json_object": True}}),
        ]
        specs = {"regex": C_PHONE, "choices": C_CHOICES,
                 "json_schema": {"json_schema": C_SCHEMA},
                 "json_object": {"json_object": True}}
        # each spec's host compile at this vocabulary, on an engine with no
        # artifact yet (the first also builds the token vocab and its trie)
        fresh = y_engine(ceng)
        for name, spec in specs.items():
            t0 = time.perf_counter()
            art = fresh._compile_constraint(spec)
            print(f"(C1) constraint_compile {name}: {(time.perf_counter() - t0) * 1e3:.3f} "
                  f"ms host at V={ceng.cfg.vocab_size}, {art.num_states} states"
                  + (" (with the vocab and trie)" if name == "regex" else ""))
        del fresh
        answers = {}
        for name, path, body in reqs:
            admitted = get(port, "/stats")[1]["continuous"]["admitted"]
            solo_before = ceng.request_count
            before = read_counts(pa, fa, Q)
            code, r = y_post(port, path, body)
            moved = {k: v - before[k] for k, v in read_counts(pa, fa, Q).items()}
            check(code == 200, f"(C1) {name}: HTTP {code} {r}")
            chat = path != "/generate"
            chunks = c_prefill_chunks(ceng, body["messages"] if chat else body["prompt"],
                                      chat or body.get("chat", True))
            if chat:
                ids = c_ids(r["choices"][0]["message"]["content"])
                finish = r["choices"][0]["finish_reason"]
                env = {"constrained": True, "backend": "single-device"}
            else:
                ids, finish, env = c_ids(r["response"]), r["finish_reason"], r
            art = ceng._compile_constraint(specs[name])
            walk = c_walk(art, ids, eos)
            text = c_text(ids)
            answers[name] = (ids, r)
            compile_ms = (r.get("timings", {}).get("constraint_compile_s", 0.0) * 1e3
                          if not chat else None)
            print(f"(C1) {name}: HTTP {code} via {path} tokens={len(ids)} finish={finish} "
                  f"text={text!r} DFA walk: {walk}; kernels {json.dumps(moved)} for "
                  f"{chunks} T>1 prefill chunk(s); constraint_compile_ms="
                  f"{compile_ms if compile_ms is None else round(compile_ms, 3)}")
            check(not walk.startswith("VIOLATION"), f"(C1) {name}: {walk}")
            check(env.get("constrained") is True and env.get("backend") == "single-device",
                  f"(C1) {name}: not the solo engine's constrained envelope: {env}")
            check(get(port, "/stats")[1]["continuous"]["admitted"] == admitted
                  and ceng.request_count == solo_before + 1,
                  f"(C1) {name}: not served by the solo engine")
            if name == "regex":
                check(re.fullmatch(r"[0-9]{3}-[0-9]{4}", text) is not None,
                      f"(C1) regex: {text!r}")
            elif name == "choices":
                check(text in ("alpha", "beta", "gamma"), f"(C1) choices: {text!r}")
            elif name == "json_schema":
                obj = json.loads(text)
                check(isinstance(obj["ok"], bool) and obj["color"] in ("red", "green", "blue"),
                      f"(C1) json_schema: {obj}")
            elif walk == "complete":
                check(isinstance(json.loads(text), dict), f"(C1) json_object: {text!r}")
            print(f"(C1) {name}: {'complete' if walk == 'complete' else 'cut at max_tokens'}"
                  f" ({walk})")
            check(moved["flash_attend"] == L * chunks
                  and not any(v for k, v in moved.items() if k != "flash_attend"),
                  f"(C1) {name}: kernels {moved}, {L * chunks} flash_attend only expected")
        # the LRU: a repeat compiles nothing; a greedy repeat is token-identical
        code, again, _ = post(port, reqs[0][2])
        check(c_ids(again["response"]) == answers["regex"][0],
              "(C1) the repeated greedy constrained request gave other tokens")
        print(f"(C1) the regex request again: token-identical; constraint_compile_ms="
              f"{again['timings'].get('constraint_compile_s', 0.0) * 1e3:.3f} (LRU hit) "
              f"at V={ceng.cfg.vocab_size}")
        # an unconstrained request beside a constrained one: the mixed launch
        free_body = {"prompt": fleet_prompt(3, 300), "chat": False, "greedy": True,
                     "max_tokens": 32}
        res = {}
        before = read_counts(pa, fa, Q)
        st0 = get(port, "/stats")[1]["continuous"]["launches"]
        threads = [threading.Thread(target=lambda: res.__setitem__("free", post(port, free_body))),
                   threading.Thread(target=lambda: res.__setitem__("con", post(
                       port, {**reqs[3][2], "seed": 8})))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wait_idle(port)
        moved = {k: v - before[k] for k, v in read_counts(pa, fa, Q).items()}
        st1 = get(port, "/stats")[1]["continuous"]["launches"]
        free, con = res["free"][1], res["con"][1]
        print(f"(C1) concurrent: unconstrained backend={free.get('backend')} "
              f"prefill_chunks={free.get('prefill_chunks')} tokens="
              f"{free.get('tokens_generated')}, constrained backend={con.get('backend')}; "
              f"mixed launches {st1['mixed'] - st0['mixed']}, kernels {json.dumps(moved)}")
        check(free.get("backend") == "continuous" and con.get("backend") == "single-device"
              and con.get("constrained") is True, "(C1) concurrent: wrong routes")
        check(st1["mixed"] > st0["mixed"] and moved["ragged_paged_attend"] > 0,
              "(C1) the unconstrained request beside a constrained one ran no mixed launch")
        # (C4) the solo pair: constrained vs unconstrained, the same prompt
        pair = {}
        for name, extra in (("constrained", {"constraint": C_HEX, "max_tokens": 66}),
                            ("unconstrained", {"max_tokens": 64})):
            body = {"prompt": "The hash is", "chat": False, "greedy": True, "seed": 0,
                    **extra}
            post(port, body)  # warm (the LRU, the decode buckets)
            code, r, wall = post(port, body)
            check(code == 200 and r["backend"] == "single-device", f"(C4) {name}: {r}")
            pair[name] = dict(tokens=r["tokens_generated"], decode_s=r["timings"]["decode_s"],
                              tokens_per_sec=float(r["tokens_per_sec"]), ttft_s=r["ttft_s"],
                              wall_s=wall)
        out["solo"] = pair
        print(f"(C4) solo pair on one prompt: {json.dumps(pair)} ({smi})")
        check(pair["constrained"]["tokens"] == 64, "(C4) the hex constraint did not close at 64")
    finally:
        server.shutdown()
    return out


def phase_C2(torch, engine, ceng, pa, fa, Q, P, G, smi):
    """The dense fleet (no pool): 8 concurrent requests, 4 constrained over
    2 constraints and 4 unconstrained; the constrained chunk's graph per
    bucket, the table's stats mid-wave, the plain chunk after it, the
    unconstrained rows against a fleet with no constrained tenant; then a
    small-table fleet sending a never-fitting spec solo."""
    import threading

    fleet, server = fleet_server(ceng, DENSE_FLEET)
    port = server.port
    which = (0, 2, 4, 6)
    free_bodies = [{"prompt": fleet_prompt(i, FLEET_PROMPT_TOKENS[i]), "chat": False,
                    "greedy": True, "max_tokens": FLEET_NEW_TOKENS} for i in which]
    con_bodies = [{"prompt": f"Phone {i}:", "chat": False, "greedy": True,
                   "max_tokens": 16, "constraint": C_PHONE} for i in range(2)]
    con_bodies += [{"prompt": f"Word {i}:", "chat": False, "greedy": True,
                    "max_tokens": 16, "constraint": C_CHOICES} for i in range(2)]
    try:
        check(fleet.warmup()["ok"], "(C2) dense fleet warmup")
        bodies = [b for pair in zip(free_bodies, con_bodies) for b in pair]
        seen = []
        done = threading.Event()

        def watch():
            while not done.is_set():
                c = get(port, "/stats")[1]["continuous"].get("constraints")
                if c and c["active"]:
                    seen.append(c)
                time.sleep(0.005)

        w = threading.Thread(target=watch)
        w.start()
        results, wave_s, launches, before, after = serve_wave(server, bodies, pa, fa, Q)
        done.set()
        w.join()
        L = engine.cfg.n_layers
        for body, (code, r, wall) in zip(bodies, results):
            ids = c_ids(r.get("response", ""))
            kind = "constrained" if "constraint" in body else "free"
            print(f"(C2) {kind}: HTTP {code} backend={r.get('backend')} tokens="
                  f"{len(ids)} finish={r.get('finish_reason')} ttft_s={r.get('ttft_s')}"
                  + (f" text={c_text(ids)!r}" if kind == "constrained" else ""))
            check(code == 200 and r.get("backend") == "continuous", f"(C2) {kind}: {r}")
            if kind == "constrained":
                text = c_text(ids)
                ok = (re.fullmatch(r"[0-9]{3}-[0-9]{4}", text) if "regex" in body["constraint"]
                      else text in ("alpha", "beta", "gamma"))
                check(bool(ok) and r.get("constrained") is True, f"(C2) {text!r}")
        g, la = after["graphs"], after["launches"]
        cg = g.get("decode_chunk_constrained", {})
        lb = before["launches"]
        n_con = la["constrained_chunks"] - lb["constrained_chunks"]
        n_chunks = la["decode_chunks"] - lb["decode_chunks"]
        print(f"(C2) wave: {wave_s:.3f} s; decode chunks {n_chunks}, of them constrained "
              f"{n_con}; CUDA graphs {json.dumps(g)}; kernels {json.dumps(launches)}")
        check(cg.get("captures") == len(cg.get("buckets", ())) >= 1
              and cg.get("replays") == la["constrained_chunks"] - cg["captures"] >= 1,
              f"(C2) the constrained chunk's graph: {cg}, {la}")
        check(g["decode_chunk"]["captures"] == 1
              and g["decode_chunk"]["replays"]
              == la["decode_chunks"] - la["constrained_chunks"] - 1,
              f"(C2) the plain chunk's graph: {g['decode_chunk']}, {la}")
        prefill = sum(r["prefill_chunks"] for _, r, _ in results)
        check(launches["flash_attend"] == L * prefill
              and not any(v for k, v in launches.items() if k != "flash_attend"),
              f"(C2) kernels {launches} for {prefill} T>1 prefill chunks")
        peak = max(seen, key=lambda c: c["states"]) if seen else None
        print(f"(C2) /stats constraints mid-wave ({len(seen)} reads with an active "
              f"entry): peak {json.dumps(peak)}; after: "
              f"{json.dumps(after.get('constraints'))}")
        check(peak is not None and peak["bucket"] >= peak["states"] > 1,
              "(C2) no mid-wave read saw the table")
        check(after.get("constraints", {}).get("active") == 0,
              "(C2) a constraint entry stayed active after the wave")
        # the unconstrained rows again, on the fleet with no constrained tenant
        plain = [post(port, b) for b in free_bodies]
        st = get(port, "/stats")[1]["continuous"]["launches"]
        check(st["constrained_chunks"] == la["constrained_chunks"]
              and st["decode_chunks"] > la["decode_chunks"],
              "(C2) the next chunk after the wave was not the plain one")
        parts = []
        for body, (_, r, _), (_, p, _) in zip(free_bodies,
                                              [x for x, b in zip(results, bodies)
                                               if "constraint" not in b], plain):
            got, want = c_ids(r["response"]), c_ids(p["response"])
            at = parts_at(got, want)
            if at is None:
                parts.append(None)
                continue
            ids = ceng.tokenizer.encode(body["prompt"]) + want[:at]
            gap = x_gap(torch, P, G, engine, ids)
            parts.append({"at": at, "token": want[at], "gap": gap})
            check(gap < LOGITS_ATOL, f"(C2) an unconstrained row parts at {at} with a "
                                     f"top-2 gap {gap:.4f}")
        print(f"(C2) unconstrained rows vs the same requests on the fleet with no "
              f"constrained tenant: {sum(p is None for p in parts)} of {len(parts)} "
              f"identical; partings {json.dumps([p for p in parts if p])} (each at a "
              f"near-tie, top-2 gap < {LOGITS_ATOL})")
    finally:
        server.shutdown()
    small = y_engine(engine, constraint_fleet_states=C_FSM_SMALL)
    fleet, server = fleet_server(small, DENSE_FLEET)
    try:
        body = {"prompt": "Sky:", "chat": False, "greedy": True, "max_tokens": 64,
                "constraint": {"json_schema": C_SCHEMA}}
        art = small._compile_constraint(body["constraint"])
        code, r, _ = post(server.port, body)
        text = c_text(c_ids(r["response"]))
        print(f"(C2) a fleet with constraint_fleet_states={C_FSM_SMALL}: the schema's "
              f"{art.num_states}-state DFA never fits; HTTP {code} backend="
              f"{r.get('backend')} text={text!r}")
        check(code == 200 and r.get("backend") == "single-device"
              and r.get("constrained") is True and json.loads(text)["color"]
              in ("red", "green", "blue"), f"(C2) the never-fitting spec: {r}")
    finally:
        server.shutdown()


def phase_C3(torch, engine, ceng, G, M, smi):
    """The constrained dense chunk as a CUDA graph over the fleet's static
    buffers at its serving shape (8 slots x 16 steps, 1024-token rows): two
    replays bit-equal to eager, a third constraint written into the same
    bucket in place then a replay under the sync check bit-equal again;
    then (C4) a table upload at the largest bucket, and the profiled
    constrained replay against the plain chunk's replay on the same slots."""
    from distributed_llm_inference_tpu_torch.constrain import FleetConstraintTable
    from distributed_llm_inference_tpu_torch.engine import graphs

    cfg, params, be = engine.cfg, engine.backend.params, engine.backend
    B, K, V = DENSE_FLEET["n_slots"], DENSE_FLEET["chunk_steps"], cfg.vocab_size
    _, _, (cache, state, sparams) = dense_admission(torch, cfg, params, G, M)
    none = torch.zeros(V, dtype=torch.bool, device=DEVICE)
    fsm = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    table = FleetConstraintTable(V, max_states=ceng.engine_cfg.constraint_fleet_states)
    arts = {k: ceng._compile_constraint(s) for k, s in (
        ("phone", C_PHONE), ("choices", C_CHOICES), ("third", C_THIRD), ("long", C_LONG))}
    offs = {k: table.acquire(arts[k]) for k in ("phone", "choices")}

    def arm(rows):
        """Slots armed greedy with a fresh budget at 100 + 50 b; rows: slot ->
        constraint name (None = free)."""
        st, sp = state, sparams
        for b in range(B):
            st, sp = G.arm_slot(cfg, st, sp, b, 100 + b, 100 + 50 * b, 200, 1.0, 0, 1.0,
                                True, 0.0, 1.0, 0.0, 0.0, none)
            k = rows.get(b)
            fsm[b] = 0 if k is None else offs[k] + arts[k].start
        graphs.commit((state, sparams), (st, sp))

    cm, ct = table.device_tables(DEVICE)
    bucket = cm.shape[0]
    ptrs = (cm.data_ptr(), ct.data_ptr())
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    bufs = {"state": state, "sparams": sparams, "cache": cache, "fsm": fsm}

    def body_for(m, t):
        return lambda b, g: graphs.decode_chunk_constrained(
            be, b["state"], b["sparams"], b["cache"], b["fsm"], m, t, g, K)

    run = body_for(cm, ct)
    lg = graphs.LaunchGraph(lambda: run(bufs, gen), "decode_chunk_constrained", DEVICE, gen)
    arm({0: "phone", 1: "phone", 2: "choices", 3: "choices"})
    lg()  # the warm launch, then the capture

    def replay_vs_eager(tag):
        ref = clone_tree(torch, bufs)
        g2 = torch.Generator(device=DEVICE)
        g2.set_state(gen.get_state())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = lg().clone()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = run(ref, g2)
        torch.cuda.synchronize()
        same = (torch.equal(got, want) and torch.equal(bufs["fsm"], ref["fsm"])
                and all(torch.equal(a, b) for a, b in zip(leaves(torch, bufs),
                                                          leaves(torch, ref))))
        emitted = int(got[K:2 * K].sum())
        print(f"(C3) {tag}: replay under set_sync_debug_mode('error') bit-equal to eager "
              f"(packed, state, FSM, KV): {same}; {emitted} tokens emitted; FSM "
              f"{bufs['fsm'].tolist()}")
        check(same, f"(C3) {tag}: the constrained replay differs from its eager run")
        check(emitted > 0, f"(C3) {tag}: no row emitted")

    arm({0: "phone", 1: "phone", 2: "choices", 3: "choices"})
    replay_vs_eager(f"bucket {bucket}, 2 constraints, replay 1")
    replay_vs_eager(f"bucket {bucket}, 2 constraints, replay 2")
    offs["third"] = table.acquire(arts["third"])
    cm2, ct2 = table.device_tables(DEVICE)
    check(cm2.shape[0] == bucket and (cm2.data_ptr(), ct2.data_ptr()) == ptrs,
          "(C3) the third constraint left the bucket or moved the tables")
    check(bool((cm2[offs["third"]:offs["third"] + arts["third"].num_states].cpu().numpy()
                == arts["third"].mask).all()), "(C3) the third constraint's rows")
    arm({0: "phone", 2: "choices", 4: "third", 5: "third"})
    replay_vs_eager(f"bucket {bucket}, a third constraint written in place")
    check((lg.captures, lg.replays) == (1, 3), f"(C3) captures {lg.captures}, replays "
                                               f"{lg.replays}")
    lg.close()

    # (C4) a table upload at the largest bucket this phase reaches
    up0, bytes0 = table.uploads, table.upload_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    offs["long"] = table.acquire(arts["long"])
    cm3, ct3 = table.device_tables(DEVICE)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    big = cm3.shape[0]
    print(f"(C4) one table upload at bucket {big}: {arts['long'].num_states} rows "
          f"({table.upload_bytes - bytes0} bytes, {table.uploads - up0} write) in place in "
          f"{up_ms:.3f} ms wall; the static pair holds {table.device_bytes()} bytes "
          f"({table.max_states} x {V} x 5) ({smi})")
    run_c = body_for(cm3, ct3)
    lg_c = graphs.LaunchGraph(lambda: run_c(bufs, gen), "decode_chunk_constrained",
                              DEVICE, gen)
    lg_p = graphs.LaunchGraph(lambda: graphs.decode_chunk(
        be, bufs["state"], bufs["sparams"], bufs["cache"], None, gen, K),
        "decode_chunk", DEVICE, gen)
    rows = {b: "long" for b in range(4)}
    out = {}
    for name, lgx, r in (("plain", lg_p, {}), ("constrained", lg_c, rows)):
        arm(r)
        lgx()  # capture
        arm(r)
        res = {}
        wall_us, busy_us, kern = profile_call(torch, lambda: res.setdefault("p", lgx()))
        tokens = int(res["p"][K:2 * K].sum())
        arm(r)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        lgx()
        e1.record()
        e1.synchronize()
        span = e0.elapsed_time(e1)
        if kern:
            out[name] = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                             idle_share=1 - busy_us / wall_us, kernels=len(kern),
                             tokens=tokens, kernels_per_token=len(kern) / max(tokens, 1),
                             replay_span_ms=span)
        else:
            out[name] = dict(replay_span_ms=span, tokens=tokens,
                             profile="not measured (no device kernels recorded)")
        print(f"(C4) profiled {name} dense chunk replay ({B} rows x {K} steps, bucket "
              f"{big if name == 'constrained' else '-'}): {json.dumps(out[name])} ({smi})")
        lgx.close()
    check(out["constrained"]["tokens"] > 0 and out["plain"]["tokens"] > 0,
          "(C4) a profiled chunk emitted no token")
    return out


def phase_C(torch, engine, pa, fa, Q, P, G, M, smi):
    """(C) grammar constraints: (C1) the main path's server, (C2) the dense
    fleet, (C3) the constrained chunk's replay against eager, (C4) numbers.
    Every kernel count starts at 0 just before (C1)'s requests and again
    before (C2)'s wave; their sums are the kernels line's launches_C."""
    t0 = time.time()
    ceng = y_engine(engine)
    phase_C1(torch, ceng, pa, fa, Q, smi)  # resets the counts after its warmup
    c1 = read_counts(pa, fa, Q)
    print(f"(C1) done in {time.time() - t0:.1f} s")
    phase_C2(torch, engine, ceng, pa, fa, Q, P, G, smi)  # resets before its wave
    launches = {k: v + c1[k] for k, v in read_counts(pa, fa, Q).items()}
    print(f"(C2) done in {time.time() - t0:.1f} s; the main path's kernel launches in "
          f"(C1)-(C2): {json.dumps(launches)}")
    check(launches["flash_attend"] > 0, "(C) no flash_attend launch for the constrained "
                                        "prefills")
    phase_C3(torch, engine, ceng, G, M, smi)
    print(f"(C) total {time.time() - t0:.1f} s")
    return launches


S_NEW = 32  # new tokens per (S) request
S_SPEC_TOKENS = 300  # (S1)/(S2)'s repetitive prompt, (x)'s kind
S_BEAM_TOKENS = 100  # (S3): inside one prefill bucket
S_SCORE_TOKENS = 700  # (S4): six scoring chunks
S_QUEUE_TOKENS = (20, 35, 50, 65, 80, 95, 110, 125)  # (S6): one bucket each
S_TAIL = 100  # (S5)'s solo tails behind the 512-token head: one tail chunk
S_DENSE_TAILS = (20, 30, 40, 50, 60, 70, 80, 90)  # (S5)'s dense wave behind it
S_DRAFT_LAYERS = 2  # (S2)'s small draft: tinyllama's widths, 2 layers, seed 1


def s_engine(engine, kv_quant=None, draft_model=None, **ecfg):
    """(g)'s model and weights with other engine settings (and an attached
    draft), with (y)'s tokenizer whose decode spells every id, so a
    response is its token ids."""
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    tok = y_engine(engine).tokenizer
    return create_engine(engine.cfg, params=engine.backend.params, device=DEVICE,
                         kv_quant=kv_quant, draft_model=draft_model, tokenizer=tok,
                         engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS, **ecfg))


def s_ids(r) -> list:
    """A response's token ids (the spelled-id tokenizer's text)."""
    return [int(t) for t in r["response"].split()]


def s_gap(torch, G, peng, ids) -> float:
    """The top-2 logit gap of the next token after `ids`, teacher-forced
    through the plain engine (attn_impl "plain") in one prefill."""
    cache = peng.backend.init_cache(1, peng.cfg.max_seq_len)
    _, logits, _ = G.prefill(peng.cfg, peng.backend.params,
                             torch.tensor([ids], device=DEVICE), len(ids), cache,
                             torch.Generator(device=DEVICE).manual_seed(0),
                             G.default_sampling(greedy=True))
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def s_identity(tag, torch, G, peng, prompt, got, want):
    """got equals want, or parts only at a near-tie: the plain path's top-2
    gap at the parting under LOGITS_ATOL. Returns None or {at, gap}."""
    at = parts_at(got, want)
    if at is None:
        return None
    gap = s_gap(torch, G, peng, peng.tokenizer.encode(prompt) + list(want[:at]))
    check(gap < LOGITS_ATOL, f"{tag}: the ids part at token {at} where the plain "
                             f"path's top-2 gap is {gap:.4f}")
    return {"at": at, "gap": round(gap, 4)}


def s_add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def s_only(tag, counts, allowed):
    """No kernel outside `allowed` launched."""
    others = {k: v for k, v in counts.items() if k not in allowed and v}
    check(not others, f"{tag}: another kernel ran: {others}")


def s_server(eng, **kw):
    """The port's server over `eng`, after one short request: a fresh
    engine's first request pays ~1 s of first-use cost on the card, which
    would land on whichever request a phase times first."""
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    server = InferenceServer(eng, host="127.0.0.1", port=0, max_tokens_cap=512, **kw)
    server.start()
    post(server.port, {"prompt": "warm", "max_tokens": 2, "chat": False, "greedy": True})
    return server


def s_drive(server, body, pa, fa, Q, launches):
    """POST one body with every kernel count at 0 just before; the counts
    join `launches` (the kernels line's launches_S). Returns (code,
    envelope, wall, counts)."""
    reset_counts(pa, fa, Q)
    code, r, wall = post(server.port, body)
    counts = read_counts(pa, fa, Q)
    s_add(launches, counts)
    return code, r, wall, counts


def phase_S1(torch, engine, peng, pa, fa, Q, G, smi, launches):
    """(S1) prompt-lookup speculation on a solo server, then on a dense
    fleet (which sends the request to the solo engine)."""
    L = engine.cfg.n_layers
    seng = s_engine(engine)
    body = {"prompt": x_prompt(0, S_SPEC_TOKENS), "max_tokens": S_NEW, "greedy": True,
            "chat": False}
    chunks = len(chunk_shapes(seng, body))
    server = s_server(seng)
    try:
        reads0 = G.spec_loop.host_reads
        code, spec, _, c = s_drive(server, dict(body, speculative=True), pa, fa, Q,
                                   launches)
        reads = G.spec_loop.host_reads - reads0
        check(code == 200 and spec.get("speculative") is True
              and spec.get("spec_path") == "solo", f"(S1) {code} {spec}")
        verifies = reads - 1  # the first token's stop flag, then one per verify
        check(c["flash_attend"] == L * (chunks + verifies),
              f"(S1) flash_attend launched {c['flash_attend']} times for {chunks} "
              f"prefill chunks and {verifies} verify forwards of {L} layers")
        s_only("(S1)", c, ("flash_attend",))
        code, plain, _, c = s_drive(server, body, pa, fa, Q, launches)
        check(code == 200 and "speculative" not in plain, f"(S1) plain {plain}")
        check(c["flash_attend"] == L * chunks, f"(S1) plain request: {c}")
    finally:
        server.shutdown()
    part = s_identity("(S1)", torch, G, peng, body["prompt"], s_ids(spec), s_ids(plain))
    emitted = spec["tokens_generated"] - 1  # the first token is the prefill's
    accepted = emitted - verifies
    print(f"(S1) n-gram speculation, {S_SPEC_TOKENS}-token repetitive prompt, {S_NEW} new: "
          f"{verifies} verify forwards for {emitted} decoded tokens ({accepted} drafted "
          f"tokens accepted, {accepted / max(verifies, 1):.3f} per forward); host reads "
          f"{reads} = {reads / spec['tokens_generated']:.3f} per token; tokens/s "
          f"{spec['tokens_per_sec']} against plain {plain['tokens_per_sec']}; ttft_s "
          f"{spec['ttft_s']} / {plain['ttft_s']}; ids vs plain: "
          f"{'identical' if part is None else json.dumps(part)} ({smi})")
    if accepted == 0:
        print("(S1) random weights accepted no n-gram draft (as in (x))")
    fleet, server = fleet_server(seng, DENSE_FLEET)
    try:
        code, r, _, c = s_drive(server, dict(body, speculative=True), pa, fa, Q, launches)
    finally:
        server.shutdown()
    check(code == 200 and r.get("spec_path") == "solo" and "continuous" not in r,
          f"(S1) the dense fleet's speculative request: {r}")
    check(s_ids(r) == s_ids(spec), "(S1) the dense fleet's solo answer differs")
    s_only("(S1) dense", c, ("flash_attend",))
    print(f"(S1) dense fleet (--continuous 8, no pool): the speculative request served "
          f"by the solo engine (spec_path solo), the same ids")
    return spec


def phase_S2(torch, engine, peng, pa, fa, Q, G, smi, launches):
    """(S2) draft-model speculation: the target as its own draft, then a
    2-layer draft made by create_engine(draft_model=...)."""
    L = engine.cfg.n_layers
    body = {"prompt": x_prompt(1, S_SPEC_TOKENS), "max_tokens": S_NEW, "greedy": True,
            "chat": False}
    dcfg = engine.cfg.replace(n_layers=S_DRAFT_LAYERS, name="tinyllama-2-layer-draft")
    plain = None
    for name in ("the target", f"a {S_DRAFT_LAYERS}-layer draft"):
        if plain is None:
            deng = s_engine(engine)
            deng.set_draft(engine.cfg, engine.backend.params)
        else:
            deng = s_engine(engine, draft_model=dcfg)
        dL = deng._draft[0].n_layers
        chunks = len(chunk_shapes(deng, body))
        server = s_server(deng)
        try:
            if plain is None:
                code, plain, _, c = s_drive(server, body, pa, fa, Q, launches)
                check(code == 200 and "speculative" not in plain, f"(S2) plain {plain}")
            reads0 = G.draft_spec_loop.host_reads
            code, spec, _, c = s_drive(server, dict(body, speculative=True), pa, fa, Q,
                                       launches)
            verifies = G.draft_spec_loop.host_reads - reads0 - 1
            check(code == 200 and spec.get("draft_model") == deng._draft[0].name,
                  f"(S2) {code} {spec}")
            want = L * (chunks + verifies) + dL * chunks
            check(c["flash_attend"] == want,
                  f"(S2) flash_attend launched {c['flash_attend']} times, not {want}: "
                  f"{chunks} target chunks and {chunks} draft-ingest chunks ({dL} "
                  f"layers) and {verifies} verify forwards")
            s_only("(S2)", c, ("flash_attend",))
            code, again, _, _ = s_drive(server, dict(body, speculative=True), pa, fa, Q,
                                        launches)
            check(s_ids(again) == s_ids(spec), f"(S2) {name}: a greedy repeat differs")
        finally:
            server.shutdown()
        part = s_identity("(S2)", torch, G, peng, body["prompt"], s_ids(spec),
                          s_ids(plain))
        emitted = spec["tokens_generated"] - 1
        accepted = emitted - verifies
        acceptance = accepted / max(4 * verifies, 1)
        if plain is not None and dL == L:
            check(acceptance > 0.5, f"(S2) the target as its own draft accepted only "
                                    f"{acceptance:.3f} of its drafts")
        print(f"(S2) {name} as the draft ({dL} layers): {verifies} verify forwards for "
              f"{emitted} decoded tokens, acceptance {acceptance:.3f} ({accepted} of "
              f"{4 * verifies} drafted); tokens/s {spec['tokens_per_sec']} against plain "
              f"{plain['tokens_per_sec']}; flash_attend {c['flash_attend']} = {L} x "
              f"({chunks} + {verifies}) + {dL} x {chunks}; ids vs plain: "
              f"{'identical' if part is None else json.dumps(part)}; a repeat identical "
              f"({smi})")


def phase_S3(torch, engine, peng, pa, fa, Q, G, timer, smi, launches):
    """(S3) beam search: 4 beams, early_stopping both ways, against the
    plain engine; the reorder's device ms per step."""
    L = engine.cfg.n_layers
    seng = s_engine(engine)
    server = s_server(seng)
    prompt = fleet_prompt(1, S_BEAM_TOKENS)
    try:
        for es in (True, False):
            body = {"prompt": prompt, "max_tokens": S_NEW, "chat": False, "num_beams": 4,
                    "length_penalty": 1.0, "early_stopping": es}
            code, r, wall, c = s_drive(server, body, pa, fa, Q, launches)
            check(code == 200 and len(r["beams"]) == 4, f"(S3) {code} {r}")
            scores = [b["score"] for b in r["beams"]]
            check(scores == sorted(scores, reverse=True), f"(S3) beams out of order {scores}")
            check(c["flash_attend"] == L, f"(S3) flash_attend {c['flash_attend']} for the "
                                          f"one prefill chunk of {L} layers")
            s_only("(S3)", c, ("flash_attend",))
            code, again, _, _ = s_drive(server, body, pa, fa, Q, launches)
            check(again["beams"] == r["beams"], "(S3) a repeat gave other beams")
            ref = peng.generate(prompt, **{k: v for k, v in body.items() if k != "prompt"})
            b0, p0 = r["beams"][0], ref["beams"][0]
            same = b0["text"] == p0["text"]
            check(same or abs(b0["score"] - p0["score"]) < LOGITS_ATOL,
                  f"(S3) beam 0 parts from the plain engine's at scores {b0['score']} / "
                  f"{p0['score']}")
            print(f"(S3) early_stopping={es}: 4 beams, scores {scores}, beam 0 "
                  f"{b0['tokens']} tokens, {'equal to' if same else 'parting from'} the "
                  f"plain engine's beam 0 (score {p0['score']}); wall {wall:.3f} s, ttft_s "
                  f"{r['ttft_s']}; flash_attend {c['flash_attend']} (the prefill chunk); "
                  f"a repeat identical ({smi})")
    finally:
        server.shutdown()
    cache = G.tile_cache(seng._cache, 4)
    parents = torch.tensor([1, 0, 0, 3], device=DEVICE)
    ms = timer.ms(lambda: G.reorder_cache(cache, parents), 10)
    nbytes = 2 * sum(t.numel() * t.element_size() for t in cache.values())
    print(f"(S3) the cache reorder per beam step (4 beams x {engine.cfg.max_seq_len} "
          f"slots, bf16): {ms:.4f} ms device, {nbytes} bytes read and written, bound "
          f"{nbytes / HBM_BPS * 1e3:.4f} ms ({smi})")
    del cache


def phase_S4(torch, engine, peng, pa, fa, Q, smi, launches):
    """(S4) teacher-forced scoring over the OpenAI route: six chunks through
    the kernel against the plain engine; a fifth concurrent scorer 429."""
    import threading

    import numpy as np

    from distributed_llm_inference_tpu_torch.serving import openai_api as oai

    L = engine.cfg.n_layers
    seng = s_engine(engine)
    prompt = fleet_prompt(2, S_SCORE_TOKENS)
    body = {"prompt": prompt, "echo": True, "logprobs": 1, "max_tokens": 0}
    ids = seng.tokenizer.encode(prompt)
    n_chunks = -(-(len(ids) - 1) // PREFILL_BUCKETS[-1])
    server = s_server(seng)
    try:
        reset_counts(pa, fa, Q)
        t0 = time.perf_counter()
        code, out = y_post(server.port, "/v1/completions", body)
        wall = time.perf_counter() - t0
        c = read_counts(pa, fa, Q)
        s_add(launches, c)
        check(code == 200, f"(S4) {code} {out}")
        check(c["flash_attend"] == L * n_chunks,
              f"(S4) flash_attend {c['flash_attend']} for {n_chunks} chunks of {L} layers")
        s_only("(S4)", c, ("flash_attend",))
        want = oai.echo_score_response(seng.score(prompt, top_n=1), seng.cfg.name)

        def shape(x):
            return ({k: shape(v) for k, v in x.items() if k not in ("id", "created")}
                    if isinstance(x, dict) else type(x).__name__)

        check(shape(out) == shape(want) and out["choices"][0]["text"] == prompt,
              "(S4) the route's shape is not echo_score_response's")
        ref = peng.score(prompt, top_n=2)
        lp = out["choices"][0]["logprobs"]
        d = np.abs(np.array(lp["token_logprobs"][1:]) - np.array(ref["token_logprobs"][1:]))
        gaps = [list(t.values())[0] - list(t.values())[-1] for t in ref["top_logprobs"][1:]]
        firm = [i for i, g in enumerate(gaps) if g > LOGITS_ATOL]
        top_same = sum(list(lp["top_logprobs"][1 + i])[0] == list(ref["top_logprobs"][1 + i])[0]
                       for i in firm)
        check(float(d.max()) < LOGITS_ATOL, f"(S4) logprobs part by {float(d.max())}")
        check(top_same == len(firm), f"(S4) top-1 differs at {len(firm) - top_same} "
                                     f"positions outside near-ties")
        # a fifth concurrent scorer: the four held inside engine.score
        release, entered = threading.Event(), threading.Semaphore(0)
        real = seng.score

        def held(p, top_n=0):
            entered.release()
            release.wait(60)
            return real(p, top_n=top_n)

        seng.score = held
        codes = []
        short = dict(body, prompt=fleet_prompt(3, 40))
        threads = [threading.Thread(target=lambda: codes.append(
            y_post(server.port, "/v1/completions", short)[0])) for _ in range(4)]
        for t in threads:
            t.start()
        for _ in range(4):
            check(entered.acquire(timeout=60), "(S4) a scorer never entered")
        fifth = y_post(server.port, "/v1/completions", short)
        release.set()
        for t in threads:
            t.join(60)
        del seng.score
        check(fifth[0] == 429 and fifth[1]["error"]["type"] == "overloaded_error"
              and sorted(codes) == [200] * 4, f"(S4) fifth scorer {fifth}, others {codes}")
    finally:
        server.shutdown()
    print(f"(S4) echo scoring of {len(ids)} tokens in {n_chunks} chunks: wall {wall:.3f} s, "
          f"flash_attend {c['flash_attend']}; max |dlogprob| against the plain engine "
          f"{float(d.max()):.5f} (mean {float(d.mean()):.5f}); top-1 equal at {top_same} "
          f"of {len(firm)} positions outside near-ties ({len(gaps) - len(firm)} within "
          f"{LOGITS_ATOL}); a fifth concurrent scorer 429 ({smi})")


def phase_S5(torch, engine, peng, pa, fa, Q, G, smi, launches):
    """(S5) the prefix snapshots: a solo server behind a 512-token head, an
    int8 hit, the dense fleet's wave of 8."""
    import threading

    from distributed_llm_inference_tpu_torch.engine import prefix as PX

    L = engine.cfg.n_layers
    head = v_head(0)
    for kvq in (None, "int8"):
        name = "flash_attend" + ("[int8]" if kvq else "")
        peng_ = s_engine(engine, kv_quant=kvq, prefix_cache_entries=4)
        cold_eng = s_engine(engine, kv_quant=kvq)
        server, cold = s_server(peng_), s_server(cold_eng)
        try:
            bodies = [v_body(head + v_tail(f"S{i}", S_TAIL))
                      for i in range(3 if not kvq else 2)]
            s_drive(server, bodies[0], pa, fa, Q, launches)  # registers the head
            for body in bodies[1:]:
                code, hit, _, c = s_drive(server, body, pa, fa, Q, launches)
                check(code == 200 and hit.get("prefix_cached_tokens") == V_HEAD,
                      f"(S5) not a hit at {V_HEAD}: {hit}")
                check(c[name] == L, f"(S5) the hit's {name} {c[name]}: the tail chunk "
                                    f"alone should run, {L} layers")
                s_only("(S5)", c, (name,))
                code, ref, _, _ = s_drive(cold, body, pa, fa, Q, launches)
                check(s_ids(hit) == s_ids(ref), f"(S5) kv_quant={kvq}: the hit's ids "
                                                f"differ from the cold run's")
                print(f"(S5) solo{' int8' if kvq else ''} hit at {V_HEAD} tokens: ttft_s "
                      f"{hit['ttft_s']} against cold {ref['ttft_s']}; ids equal the cold "
                      f"run's; {name} {c[name]} (the tail chunk only) ({smi})")
            hits = peng_.metrics.get("dli_prefix_cache_hits_total").labels(scope="solo")
            check(hits.value == len(bodies) - 1, f"(S5) solo hits {hits.value}")
            if kvq is None:
                key, entry = next(iter(peng_._prefix._entries.items()))
                nb = PX.snapshot_bytes(entry)
                print(f"(S5) dli_prefix_cache_hits_total{{scope=\"solo\"}} {hits.value}; "
                      f"one snapshot of {len(key)} tokens holds {nb} bytes on the card "
                      f"({nb * V_HEAD // len(key)} per {V_HEAD}-token entry)")
        finally:
            server.shutdown()
            cold.shutdown()
    # the dense fleet's own snapshots: a wave of 8 behind the head
    waves = {}
    for cached in (False, True):
        deng = s_engine(engine, prefix_cache_entries=4 if cached else 0)
        fleet, server = fleet_server(deng, DENSE_FLEET)
        try:
            post(server.port, v_body(head + v_tail("S-dense", S_TAIL)))  # registers
            bodies = [v_body(head + v_tail(f"SD{i}", n)) for i, n in enumerate(S_DENSE_TAILS)]
            results = [None] * 8

            def run(i):
                results[i] = post(server.port, bodies[i])

            threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
            reset_counts(pa, fa, Q)
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wave_s = time.perf_counter() - t0
            c = read_counts(pa, fa, Q)
            s_add(launches, c)
            check(all(code == 200 for code, _, _ in results), f"(S5) dense wave {results}")
            s_only("(S5) dense", c, ("flash_attend",))
            st = fleet.stats().get("prefix_cache")
            waves[cached] = ([r for _, r, _ in results], wave_s, st, c)
        finally:
            server.shutdown()
    (cold_rs, cold_s, _, cold_c), (hit_rs, hit_s, st, hit_c) = waves[False], waves[True]
    check(st is not None and st["hits"] >= 8, f"(S5) dense prefix stats {st}")
    parts = [s_identity("(S5) dense", torch, G, peng, b["prompt"], s_ids(h), s_ids(r))
             for b, h, r in zip(bodies, hit_rs, cold_rs)]
    tt = lambda rs: round(statistics.median(r["ttft_s"] for r in rs), 4)
    print(f"(S5) dense fleet (--continuous 8 --prefix-cache 4): a wave of 8 behind the "
          f"{V_HEAD}-token head: hits {st['hits']} (scope continuous), median ttft_s "
          f"{tt(hit_rs)} against {tt(cold_rs)} uncached; wave {hit_s:.3f} s against "
          f"{cold_s:.3f} s; flash_attend {hit_c['flash_attend']} against "
          f"{cold_c['flash_attend']}; ids vs the uncached wave: "
          f"{sum(p is None for p in parts)} of 8 identical, partings "
          f"{json.dumps([p for p in parts if p])} ({smi})")


def phase_S6(torch, engine, peng, pa, fa, Q, G, smi, launches):
    """(S6) the batching queue: 8 concurrent greedy requests coalesce; each
    answer against the same request alone; aggregate tokens/s against the
    solo engine serving them one by one."""
    import threading

    from distributed_llm_inference_tpu_torch.serving.queue import BatchingQueue

    L = engine.cfg.n_layers
    qeng = s_engine(engine)
    queue = BatchingQueue(qeng, max_queue=16, max_batch=8, max_wait_ms=5)
    server = s_server(qeng, queue=queue)
    bodies = [{"prompt": fleet_prompt(40 + i, n), "max_tokens": S_NEW, "greedy": True,
               "chat": False} for i, n in enumerate(S_QUEUE_TOKENS)]
    try:
        alone, t0 = [], time.perf_counter()
        for body in bodies:
            code, r, _, _ = s_drive(server, body, pa, fa, Q, launches)
            check(code == 200, f"(S6) alone {r}")
            alone.append(r)
        alone_s = time.perf_counter() - t0
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
        c = read_counts(pa, fa, Q)
        s_add(launches, c)
        st = get(server.port, "/stats")[1]["queue"]
    finally:
        server.shutdown()
    check(all(code == 200 for code, _, _ in results), f"(S6) {results}")
    check(st["coalesced_batches"] > 0, f"(S6) no batch coalesced: {st}")
    check(c["flash_attend"] > 0 and c["flash_attend"] % L == 0,
          f"(S6) flash_attend {c['flash_attend']}: not {L} per batch prefill")
    s_only("(S6)", c, ("flash_attend",))
    parts = [s_identity("(S6)", torch, G, peng, b["prompt"], s_ids(r), s_ids(a))
             for b, (_, r, _), a in zip(bodies, results, alone)]
    n_alone = sum(r["tokens_generated"] for r in alone)
    n_wave = sum(r["tokens_generated"] for _, r, _ in results)
    batched = [r.get("batched_with", 1) for _, r, _ in results]
    print(f"(S6) --queue 16 --queue-max-batch 8 --queue-wait-ms 5: 8 concurrent greedy "
          f"requests in {st['coalesced_batches']} coalesced batch(es) (batched_with "
          f"{batched}), {n_wave} tokens in {wave_s:.3f} s = {n_wave / wave_s:.2f} tokens/s "
          f"aggregate against {n_alone / alone_s:.2f} one by one ({n_alone} tokens in "
          f"{alone_s:.3f} s); flash_attend {c['flash_attend']}; ids vs each alone: "
          f"{sum(p is None for p in parts)} of 8 identical, partings "
          f"{json.dumps([p for p in parts if p])} ({smi})")


def phase_S(torch, engine, pa, fa, Q, G, timer, smi):
    """(S) the solo engine's features through the port's server: (S1)
    prompt-lookup speculation, (S2) draft-model speculation, (S3) beams,
    (S4) echo scoring, (S5) the prefix snapshots, (S6) the batching
    queue. Every kernel count starts at 0 just before each main-path
    request or wave; their sums are the kernels line's launches_S."""
    t0 = time.time()
    peng = y_engine(engine, cfg=engine.cfg.replace(attn_impl="plain"))
    launches = {}
    phase_S1(torch, engine, peng, pa, fa, Q, G, smi, launches)
    print(f"(S1) done in {time.time() - t0:.1f} s")
    phase_S2(torch, engine, peng, pa, fa, Q, G, smi, launches)
    print(f"(S2) done in {time.time() - t0:.1f} s")
    phase_S3(torch, engine, peng, pa, fa, Q, G, timer, smi, launches)
    print(f"(S3) done in {time.time() - t0:.1f} s")
    phase_S4(torch, engine, peng, pa, fa, Q, smi, launches)
    print(f"(S4) done in {time.time() - t0:.1f} s")
    phase_S5(torch, engine, peng, pa, fa, Q, G, smi, launches)
    print(f"(S5) done in {time.time() - t0:.1f} s")
    phase_S6(torch, engine, peng, pa, fa, Q, G, smi, launches)
    print(f"(S) total {time.time() - t0:.1f} s; the kernels' launches in (S): "
          f"{json.dumps(launches)}")
    check(launches.get("flash_attend", 0) > 0, "(S) no flash_attend launch")
    return launches


# -- (F) other families and loading: gpt2-medium and qwen3-30b-a3b -------------

F_GPT2 = "gpt2-medium"
F_MOE = "qwen3-30b-a3b"
# the cuts (PERF.md §4): the MoE's solo cache and positions at 2048 of its
# 40960 (no served request comes near), its int8 engine at 24 of 48 layers
# (the bf16 tree and the int8 one it is made from fit on the card together)
F_MOE_MAX_SEQ = 2048
F_MOE_INT8_LAYERS = 24
# the MoE's kernel path is held to its plain path in fp32, at full width and
# this depth: in bf16 one ulp between the two attention paths can move a
# token's router logits across the top-8 edge, and another expert moves the
# logits by O(1) (0.797 at 2 layers on an NVIDIA H100 80GB HBM3 at 700 W),
# so a bf16 comparison measures routing ties, not the kernels. In fp32 the
# paths part by ~1e-6 relative; 1e-3 is tests/test_torch_cuda_families.py's
# FP32_LOGITS_ATOL
F_MOE_FP32_LAYERS = 4
F_FP32_LOGITS_ATOL = 1e-3
F_LOAD_MOE_LAYERS = 2  # the qwen3_moe HF directory: 2 layers at full width
# the attention widths of the two models: MHA (a group of 1) and Dh 128
F_WIDTHS = {F_GPT2: dict(H=16, KV=16, DH=64), F_MOE: dict(H=32, KV=4, DH=128)}
# the projections each model's int4 decode step runs through q4_matmul_rows
# (the MoE's expert banks stay dense under int4): (in, out) -> count
F_Q4_SHAPES = {F_GPT2: {(1024, 1024): 4, (1024, 4096): 1, (4096, 1024): 1},
               F_MOE: {(2048, 4096): 1, (2048, 512): 2, (4096, 2048): 1}}
F_SERVER = ["--device", DEVICE, "--attn-impl", "auto", "--seed", "0",
            "--continuous", "8", "--kv-pool-blocks", "513", "--kv-block-size", "16",
            "--continuous-max-seq", "1024", "--max-tokens-cap", "64"]


def f_add(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def f_free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def f_engine(torch, name, tag, dtype="bfloat16", **kw):
    from distributed_llm_inference_tpu_torch.config import EngineConfig
    from distributed_llm_inference_tpu_torch.models.registry import get_model_config
    from distributed_llm_inference_tpu_torch.runtime import create_engine

    cfg = get_model_config(name)
    if name == F_MOE:
        cfg = cfg.replace(max_seq_len=F_MOE_MAX_SEQ)
    cfg = cfg.replace(**{k: kw.pop(k) for k in ("n_layers",) if k in kw})
    t0 = time.time()
    engine = create_engine(cfg, dtype=dtype, attn_impl="auto", seed=0, device=DEVICE,
                           engine_cfg=EngineConfig(prefill_buckets=PREFILL_BUCKETS), **kw)
    torch.cuda.synchronize()
    c = engine.cfg
    print(f"{tag} {c.name}: {c.n_layers} layers, dim {c.dim}, heads {c.n_heads}/"
          f"{c.n_kv_heads} of {c.head_dim}, ffn {c.ffn_dim}"
          + (f", {c.n_experts} experts top-{c.n_experts_per_tok}" if c.n_experts else "")
          + f", vocab {c.vocab_size}, max_seq {c.max_seq_len}, quant={c.quant} "
          f"kv_quant={c.kv_quant}, attn_impl={c.attn_impl}, random weights (seed 0), "
          f"built in {time.time() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(c.attn_impl == "kernel", f"{tag}: attn_impl='auto' did not pick the kernels")
    return engine


def f_solo(torch, engine, pa, fa, Q, tag, total, profile, logits=True):
    """(c) and (d) on this engine: the solo requests through the HTTP
    server (every T>1 chunk one flash_attend launch a layer), the kernel
    path against the plain path's logits (`logits`); with `profile`, (e)'s
    profiled greedy request."""
    reset_counts(pa, fa, Q)
    results, shapes, _ = phase_c(torch, engine, fa, tag=tag)
    counts = read_counts(pa, fa, Q)
    f_add(total, counts)
    if logits:
        phase_d(torch, engine, tag=tag)
    if profile:
        phase_profile(torch, engine, tag=tag)
    return shapes


def f_dense_wave(torch, engine, pa, fa, Q, tag, total):
    """(o)'s dense fleet on this engine: (g)'s wave, flash_attend on every
    T>1 prefill chunk and no other kernel, one decode-chunk graph."""
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    L = engine.cfg.n_layers
    fleet = ContinuousEngine(engine, **DENSE_FLEET)
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64,
                             continuous=fleet)
    server.start()
    try:
        check(fleet.warmup()["ok"], f"{tag} dense fleet warmup")
        which = range(len(FLEET_PROMPT_TOKENS))
        results, wave_s, launches, before, after = serve_wave(
            server, fleet_bodies(which), pa, fa, Q)
        check_wave(tag, results, which)
        prefill = sum(r["prefill_chunks"] for _, r, _ in results)
        print(f"{tag} dense wave: {wave_s:.3f} s; {prefill} T>1 prefill chunks; kernel "
              f"launches {json.dumps(launches)}")
        check_graphs(tag, after, {"decode_chunk": "decode_chunks"})
        check(launches["flash_attend"] == L * prefill > 0,
              f"{tag}: flash_attend launched {launches['flash_attend']} times for "
              f"{prefill} T>1 prefill chunks of {L} layers")
        check(not any(n for k, n in launches.items() if k != "flash_attend"),
              f"{tag}: the dense fleet launched another kernel: {launches}")
        f_add(total, launches)
    finally:
        server.shutdown()


def f_kernels(torch, timer, pa, fa, Q, P, name, solo_shapes):
    """The four kernels at this model's attention widths against their
    twins, timed in turn with the library call where one exists: (b)'s
    flash_attend at the solo chunks the model ran (SDPA), (f)'s paged
    decode at B=8 over a shuffled table and the ragged kernel on (f)'s
    first two launches, each against its bound, and q4_matmul_rows at the
    model's int4 decode projections (torch.matmul on the dequantized
    weight). Returns one summary row per kernel."""
    w = F_WIDTHS[name]
    wd = h, kv, dh = w["H"], w["KV"], w["DH"]
    out = []
    print(f"(F2) {name}: the kernels at H={h} KV={kv} (group {h // kv}) Dh={dh}")
    rows = [flash_case(torch, timer, fa, dtype_name="bfloat16", B=1, T=T, pos=pos,
                       seed=300 + i, widths=wd)
            for i, (T, pos) in enumerate(sorted(set(solo_shapes)))]
    rows.append(flash_case(torch, timer, fa, dtype_name="float32", B=1, T=128, pos=256,
                           seed=399, widths=wd))
    for r in rows:
        print(f"    flash_attend {r['dtype']} T={r['T']} pos={r['pos']} "
              f"err={r['max_abs_err']:.3g} (atol {r['atol']:g}) kernel={r['ms']:.4f} "
              f"sdpa={fmt_ms(r['library_ms'])} plain={r['plain_ms']:.4f} "
              f"bound={r['bound_ms']:.5f} ({r['bound_by']})")
    check(all(r["max_abs_err"] <= r["atol"] for r in rows),
          f"(F2) flash_attend disagrees with its twin at {name}'s widths")
    out.append(f_summary("flash_attend", name, rows[:-1]))
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        g, pk, pv, table = paged_pool(torch, dt, 8, seed=8, widths=wd)
        pos_list = SPECIAL_POS + [64, 333, 517]
        pos = torch.tensor(pos_list, dtype=torch.int32, device=DEVICE)
        q = torch.randn(8, 1, h, dh, generator=g, device=DEVICE).to(dt)
        r = paged_decode_case(torch, timer, pa, (q, pk, pv, table, pos), {}, None,
                              False, False)
        nbytes, flops = paged_work({b: [p] for b, p in enumerate(pos_list)}, 8,
                                   dtype_name, None, 32, widths=wd)
        r.update(dtype=dtype_name, atol=ATOL[dtype_name], library_ms=None,
                 **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops, dtype_name))))
        print(f"    paged_flash_attend {dtype_name} B=8 err={r['max_abs_err']:.3g} "
              f"kernel={r['ms']:.4f} n_split={r['n_split']} "
              f"slots={fmt_ms(r['slots_ms'])} plain={r['plain_ms']:.4f} "
              f"bound={r['bound_ms']:.5f} ({r['bound_by']})")
        check(r["max_abs_err"] <= r["atol"] and r["slots_err"] <= r["atol"],
              f"(F2) paged_flash_attend disagrees at {name}'s widths")
        if dtype_name == "bfloat16":
            out.append(f_summary("paged_flash_attend", name, [r]))
        rag = []
        for i, (label, entries) in enumerate(list(ragged_plans(P).items())[:2]):
            g, pk, pv, table = paged_pool(torch, dt, 9, seed=120 + i, widths=wd)
            meta_np, tok_row, _, offsets, _ = P.build_ragged_meta(
                entries, width=RAGGED_W, tile=RAGGED_TILE)
            meta = torch.from_numpy(meta_np).to(DEVICE)
            q = torch.randn(RAGGED_W, h, dh, generator=g, device=DEVICE).to(dt)
            dense = ((entries[0][0], entries[0][1], entries[0][2], int(offsets[0]))
                     if len(entries) == 1 else None)
            r = ragged_case(torch, timer, pa, fa, (q, pk, pv, table, meta), {}, None,
                            False, dense, False)
            got = r.pop("out")
            check(got[torch.from_numpy(tok_row < 0).to(DEVICE)].abs().sum().item() == 0,
                  f"(F2) ragged_paged_attend wrote non-zeros to padding ({label})")
            row_queries = {}
            for row, start, n, _ in entries:
                row_queries.setdefault(row, []).extend(range(start, start + n))
            nbytes, flops = paged_work(row_queries, RAGGED_W, dtype_name, None,
                                       16 * meta.shape[0], widths=wd)
            r.update(dtype=dtype_name, atol=ATOL[dtype_name], library_ms=None,
                     case=label, **dict(zip(("bound_ms", "bound_by"),
                                            bound(nbytes, flops, dtype_name))))
            print(f"    ragged_paged_attend {dtype_name} {label}: "
                  f"err={r['max_abs_err']:.3g} kernel={r['ms']:.4f} "
                  f"plan={json.dumps(r['plan'])} dense={fmt_ms(r['dense_ms'])} "
                  f"plain={r['plain_ms']:.4f} bound={r['bound_ms']:.5f} "
                  f"({r['bound_by']})")
            check(r["max_abs_err"] <= r["atol"]
                  and (r["dense_err"] is None or r["dense_err"] <= r["atol"]),
                  f"(F2) ragged_paged_attend disagrees at {name}'s widths ({label})")
            rag.append(r)
        if dtype_name == "bfloat16":
            out.append(f_summary("ragged_paged_attend", name, rag))
    print(f"(F2) {name}: q4_matmul_rows at the int4 decode projections "
          f"{sorted(F_Q4_SHAPES[name])} (the (j) lines below)")
    q4 = q4_cases(torch, timer, Q, F_Q4_SHAPES[name])
    out.append(f_summary("q4_matmul_rows", name, [
        r for r in q4 if r["dtype"] == "bfloat16" and r["R"] == FLEET["n_slots"]]))
    return out


def f_summary(kernel, name, rows):
    """One kernel's rows at one model's widths, averaged per call."""
    n = len(rows)

    def mean(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals) / n

    w = F_WIDTHS[name]
    return {"name": kernel, "model": name, "widths": w, "group": w["H"] // w["KV"],
            "calls": n, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": rows[0]["bound_by"], "library_ms": mean("library_ms")}


def f_bf16(torch, t):
    """A tensor as the safetensors writer's BF16 carrier."""
    from distributed_llm_inference_tpu_torch.models import convert as C

    return (t.detach().to(torch.bfloat16).contiguous().view(torch.int16).cpu().numpy()
            .view("uint16").view(C.BF16))


def f_hf_gpt2(torch, cfg, params):
    """(config.json, tensors) of an HF GPT2LMHeadModel directory holding
    these weights: Conv1D weights [in, out] as they are, c_attn fused."""
    lay = params["layers"]
    t = {"transformer.wte.weight": params["embed"], "transformer.wpe.weight":
         params["pos_embed"], "transformer.ln_f.weight": params["final_norm_w"],
         "transformer.ln_f.bias": params["final_norm_b"]}
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        t.update({
            p + "ln_1.weight": lay["ln1_w"][i], p + "ln_1.bias": lay["ln1_b"][i],
            p + "ln_2.weight": lay["ln2_w"][i], p + "ln_2.bias": lay["ln2_b"][i],
            p + "attn.c_attn.weight": torch.cat([lay[k][i] for k in ("wq", "wk", "wv")], 1),
            p + "attn.c_attn.bias": torch.cat([lay[k][i] for k in ("bq", "bk", "bv")]),
            p + "attn.c_proj.weight": lay["wo"][i], p + "attn.c_proj.bias": lay["bo"][i],
            p + "mlp.c_fc.weight": lay["w_fc"][i], p + "mlp.c_fc.bias": lay["b_fc"][i],
            p + "mlp.c_proj.weight": lay["w_proj"][i], p + "mlp.c_proj.bias": lay["b_proj"][i],
        })
    conf = {"model_type": "gpt2", "vocab_size": cfg.vocab_size, "n_embd": cfg.dim,
            "n_layer": cfg.n_layers, "n_head": cfg.n_heads, "n_positions": cfg.max_seq_len,
            "n_inner": cfg.ffn_dim, "layer_norm_epsilon": cfg.norm_eps,
            "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id}
    return conf, t


def f_hf_qwen3_moe(torch, cfg, params):
    """(config.json, tensors) of an HF Qwen3MoeForCausalLM directory holding
    these weights: Linear weights [out, in], one tensor per expert."""
    lay = params["layers"]
    t = {"model.embed_tokens.weight": params["embed"], "model.norm.weight":
         params["final_norm"], "lm_head.weight": params["lm_head"].T}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": lay["attn_norm"][i],
            p + "post_attention_layernorm.weight": lay["mlp_norm"][i],
            p + "self_attn.q_norm.weight": lay["q_norm"][i],
            p + "self_attn.k_norm.weight": lay["k_norm"][i],
            p + "mlp.gate.weight": lay["w_router"][i].T,
        })
        for proj, leaf in (("q", "wq"), ("k", "wk"), ("v", "wv"), ("o", "wo")):
            t[p + f"self_attn.{proj}_proj.weight"] = lay[leaf][i].T
        for e in range(cfg.n_experts):
            for role in ("gate", "up", "down"):
                t[p + f"mlp.experts.{e}.{role}_proj.weight"] = lay[f"w_{role}"][i, e].T
    conf = {"model_type": "qwen3_moe", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.dim, "intermediate_size": 6144,
            "moe_intermediate_size": cfg.ffn_dim, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "num_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.n_experts_per_tok,
            "norm_topk_prob": cfg.moe_renormalize,
            "max_position_embeddings": cfg.max_seq_len, "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": False,
            "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id,
            "pad_token_id": cfg.pad_token_id}
    return conf, t


def f_write_hf(torch, path, conf, tensors):
    """An HF directory: config.json and one BF16 model.safetensors (the
    port's own writer); no tokenizer files. Returns its bytes."""
    import os

    from distributed_llm_inference_tpu_torch.models import convert as C

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    C.save_safetensors_file(os.path.join(path, "model.safetensors"),
                            {k: f_bf16(torch, v) for k, v in tensors.items()})
    return os.path.getsize(os.path.join(path, "model.safetensors"))


def f_alone(server, body, pa, fa, Q, total):
    """One request served alone on an idle fleet server: its token ids;
    the kernels' counts from 0 just before, added to (F)'s."""
    reset_counts(pa, fa, Q)
    code, r, wall = post(server.port, body)
    wait_idle(server.port)
    f_add(total, read_counts(pa, fa, Q))
    check(code == 200 and r.get("status") == "success" and r.get("backend") == "continuous",
          f"(F4) request: {r}")
    return r["token_ids"], wall


def f_cli_server(argv):
    """The port server's CLI (`main`) started in process on a free port:
    returns the running InferenceServer (the caller shuts it down)."""
    from distributed_llm_inference_tpu_torch.serving import server as S

    built = {}
    base = S.InferenceServer

    class Started(base):
        def __init__(self, engine, host, port, *a, **kw):
            super().__init__(engine, "127.0.0.1", 0, *a, **kw)
            built["server"] = self

        def serve_forever(self):
            self.start()

    S.InferenceServer = Started
    try:
        S.main(argv)
    finally:
        S.InferenceServer = base
    return built["server"]


def f_memory_server(engine):
    from distributed_llm_inference_tpu_torch.engine.continuous import ContinuousEngine
    from distributed_llm_inference_tpu_torch.serving.server import InferenceServer

    fleet = ContinuousEngine(engine, **FLEET)
    server = InferenceServer(engine, host="127.0.0.1", port=0, max_tokens_cap=64,
                             continuous=fleet)
    server.start()
    return server


def f_moe_fp32(torch, P, G, M, tag, quant=None):
    """qwen3-30b-a3b in fp32 at full width and F_MOE_FP32_LAYERS layers:
    (d)'s solo chunks and (h)'s scripted mixed launches and decode step,
    the kernel path against the plain path within F_FP32_LOGITS_ATOL, and
    (h)'s sync check."""
    engine = f_engine(torch, F_MOE, tag, dtype="float32", n_layers=F_MOE_FP32_LAYERS,
                      quant=quant)
    phase_d(torch, engine, tag=tag, atol=F_FP32_LOGITS_ATOL)
    phase_h(torch, engine, P, G, M, tag=tag, atol=F_FP32_LOGITS_ATOL)
    del engine
    f_free(torch)


def f_loading(torch, engine, pa, fa, Q, smi, total):
    """(F4) --checkpoint on the card, with no transformers: gpt2-medium's
    random weights (the engine's) written as a synthetic HF directory
    (BF16, HF tensor names) and as a checkpoint store, each served by the
    server's CLI with --checkpoint on (g)'s fleet: a greedy request's ids
    equal the in-memory engine's fleet's. Then a 2-layer full-width
    qwen3_moe directory: the converter's config and every stacked expert
    bank equal the in-memory model's, and it serves the same ids."""
    import tempfile

    from distributed_llm_inference_tpu_torch.models import checkpoint as CK
    from distributed_llm_inference_tpu_torch.models import convert as C

    body = {**fleet_bodies([4])[0]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_F_") as tmp:
        server = f_memory_server(engine)
        try:
            want, _ = f_alone(server, body, pa, fa, Q, total)
        finally:
            server.shutdown()
        t0 = time.time()
        conf, tensors = f_hf_gpt2(torch, engine.cfg, engine.backend.params)
        nbytes = f_write_hf(torch, f"{tmp}/gpt2_hf", conf, tensors)
        write_s = time.time() - t0
        t0 = time.time()
        CK.save_params(f"{tmp}/gpt2_store", engine.cfg, engine.backend.params)
        store_s = time.time() - t0
        got = {}
        for kind, path in (("hf", f"{tmp}/gpt2_hf"), ("store", f"{tmp}/gpt2_store")):
            t0 = time.time()
            server = f_cli_server(["--checkpoint", path] + F_SERVER)
            start_s = time.time() - t0
            try:
                c = server.engine.cfg
                check(c.arch == "gpt2" and c.dtype == "bfloat16"
                      and (c.dim, c.n_layers, c.vocab_size) == (1024, 24, 50257),
                      f"(F4) {kind}: the checkpoint's config {c}")
                got[kind], wall = f_alone(server, body, pa, fa, Q, total)
            finally:
                server.shutdown()
            print(f"(F4) gpt2-medium --checkpoint {kind} ({nbytes / 1e9:.3f} GB "
                  f"safetensors written in {write_s:.1f} s; store in {store_s:.1f} s): "
                  f"server up in {start_s:.1f} s, a greedy request of "
                  f"{FLEET_PROMPT_TOKENS[4]} tokens alone: {len(got[kind])} tokens in "
                  f"{wall:.3f} s, ids equal the in-memory engine's: {got[kind] == want}")
            check(got[kind] == want, f"(F4) --checkpoint {kind} served other ids")
        del tensors
        f_free(torch)

        moe = f_engine(torch, F_MOE, "(F4) in memory", n_layers=F_LOAD_MOE_LAYERS)
        server = f_memory_server(moe)
        try:
            want, _ = f_alone(server, body, pa, fa, Q, total)
        finally:
            server.shutdown()
        t0 = time.time()
        conf, tensors = f_hf_qwen3_moe(torch, moe.cfg, moe.backend.params)
        nbytes = f_write_hf(torch, f"{tmp}/moe_hf", conf, tensors)
        write_s = time.time() - t0
        del tensors
        t0 = time.time()
        cfg, params = C.load_hf_checkpoint(f"{tmp}/moe_hf", dtype="bfloat16")
        load_s = time.time() - t0
        same_cfg = cfg.replace(name=moe.cfg.name, attn_impl=moe.cfg.attn_impl) == moe.cfg
        mem = moe.backend.params
        leaves = [(k, params["layers"][k], mem["layers"][k]) for k in mem["layers"]]
        leaves += [(k, params[k], mem[k]) for k in mem if k != "layers"]
        bad = [k for k, a, b in leaves if not torch.equal(a, b.cpu())]
        print(f"(F4) qwen3_moe HF directory, {F_LOAD_MOE_LAYERS} layers at full width "
              f"({nbytes / 1e9:.3f} GB written in {write_s:.1f} s, read and stacked in "
              f"{load_s:.1f} s): config equal {same_cfg}; leaves {len(leaves)}, unequal "
              f"{bad}; banks {tuple(params['layers']['w_gate'].shape)}")
        check(same_cfg and not bad, "(F4) the converter's qwen3_moe params differ")
        del params
        f_free(torch)
        server = f_cli_server(["--checkpoint", f"{tmp}/moe_hf"] + F_SERVER)
        try:
            got_moe, wall = f_alone(server, body, pa, fa, Q, total)
        finally:
            server.shutdown()
        print(f"(F4) qwen3_moe --checkpoint hf: {len(got_moe)} tokens in {wall:.3f} s, "
              f"ids equal the in-memory engine's: {got_moe == want} ({smi})")
        check(got_moe == want, "(F4) the qwen3_moe checkpoint served other ids")
        del moe, server
        f_free(torch)


def phase_F(torch, pa, fa, Q, P, G, M, smi, profile=False, moe_layers=None):
    """(F) the other families and loading at full width: gpt2-medium (MHA,
    learned positions) on the solo path, the paged fleet (the main path),
    the dense fleet and the int4+int8 fleet; --checkpoint on an HF
    directory and a store; qwen3-30b-a3b (128 experts, Dh 128) on the solo
    path and the paged fleet, at full depth or `moe_layers`, and its int8
    expert banks at a cut depth, its logits held to the plain path in fp32
    at F_MOE_FP32_LAYERS; each engine's mixed-launch and decode-chunk
    graphs replayed bit-equal to their eager launches (phase_q). Every
    kernel count starts at 0 just before each main-path run; their sums
    are the kernels line's launches_F. `profile` (`--only F`; ~2 minutes
    of profiler time, left out of the full run): the profiled solo
    request, mixed launch and decode chunk of both models. Returns
    (launches, each model's solo chunk shapes) for phase_F2."""
    t0 = time.time()
    total = {}
    engine = f_engine(torch, F_GPT2, "(F1)")
    gpt2_shapes = f_solo(torch, engine, pa, fa, Q, "(F1) gpt2 solo", total, profile)
    wave = phase_g(torch, engine, pa, fa, Q, tag="(F1) gpt2 paged")
    f_add(total, wave["launches"])
    phase_h(torch, engine, P, G, M, tag="(F1) gpt2")
    phase_q(torch, engine, P, G, M, tag="(F1) gpt2 graphs", idle=False, timed=False)
    if profile:
        phase_i_profile(torch, engine, P, G, tag="(F1) gpt2")
    f_dense_wave(torch, engine, pa, fa, Q, "(F1) gpt2 dense", total)
    print(f"(F1) gpt2-medium bf16 done in {time.time() - t0:.1f} s ({smi})")
    f_loading(torch, engine, pa, fa, Q, smi, total)
    print(f"(F4) done in {time.time() - t0:.1f} s")
    del engine
    f_free(torch)
    qengine = f_engine(torch, F_GPT2, "(F1) int4+int8", quant="int4", kv_quant="int8")
    qwave = phase_g(torch, qengine, pa, fa, Q, tag="(F1) gpt2 int4+int8")
    f_add(total, qwave["launches"])
    phase_h(torch, qengine, P, G, M, tag="(F1) gpt2 int4+int8", atol=QUANT_LOGITS_ATOL)
    phase_q(torch, qengine, P, G, M, tag="(F1) gpt2 int4+int8 graphs", idle=False,
            dense=False, timed=False)
    del qengine
    f_free(torch)
    print(f"(F1) done in {time.time() - t0:.1f} s")

    depth = {} if moe_layers is None else {"n_layers": moe_layers}
    engine = f_engine(torch, F_MOE, "(F3)", **depth)
    moe_shapes = f_solo(torch, engine, pa, fa, Q, "(F3) qwen3-moe solo", total, profile,
                        logits=False)
    wave = phase_g(torch, engine, pa, fa, Q, tag="(F3) qwen3-moe paged")
    f_add(total, wave["launches"])
    f_free(torch)
    phase_h(torch, engine, P, G, M, tag="(F3) qwen3-moe", logits=False)
    phase_q(torch, engine, P, G, M, tag="(F3) qwen3-moe graphs", idle=False, dense=False,
            timed=False)
    if profile:
        phase_i_profile(torch, engine, P, G, tag="(F3) qwen3-moe")
    n_tok = sum(r["tokens_generated"] for _, r, _ in wave["results"])
    print(f"(F3) qwen3-30b-a3b paged wave: {n_tok} tokens in {wave['wave_s']:.3f} s = "
          f"{n_tok / wave['wave_s']:.2f} tokens/s aggregate; device memory peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del engine
    f_free(torch)
    qengine = f_engine(torch, F_MOE, "(F3) int8", quant="int8",
                       n_layers=min(F_MOE_INT8_LAYERS, moe_layers or F_MOE_INT8_LAYERS))
    check(type(qengine.backend.params["layers"]["w_gate"]).__name__ == "QTensor",
          "(F3) the int8 engine's expert banks are not int8")
    qwave = phase_g(torch, qengine, pa, fa, Q, tag="(F3) qwen3-moe int8")
    f_add(total, qwave["launches"])
    phase_h(torch, qengine, P, G, M, tag="(F3) qwen3-moe int8", logits=False)
    phase_q(torch, qengine, P, G, M, tag="(F3) qwen3-moe int8 graphs", idle=False,
            dense=False, timed=False)
    del qengine
    f_free(torch)
    f_moe_fp32(torch, P, G, M, "(F3) qwen3-moe fp32")
    f_moe_fp32(torch, P, G, M, "(F3) qwen3-moe int8 fp32", quant="int8")
    print(f"(F3) done in {time.time() - t0:.1f} s")
    print(f"(F) total {time.time() - t0:.1f} s; the kernels' launches in (F): "
          f"{json.dumps(total)}")
    for name in ("ragged_paged_attend", "paged_flash_attend", "flash_attend",
                 "q4_matmul_rows"):
        check(total.get(name, 0) > 0, f"(F) no {name} launch on (F)'s main paths")
    return total, {F_GPT2: gpt2_shapes, F_MOE: moe_shapes}


def phase_F2(torch, timer, pa, fa, Q, P, shapes) -> list:
    """(F2) the four kernels at both models' widths against their twins,
    flash_attend at each model's solo chunk shapes (`shapes`, from
    phase_F); one JSON row per kernel and model."""
    rows = []
    for name in (F_GPT2, F_MOE):
        rows += f_kernels(torch, timer, pa, fa, Q, P, name,
                          [tuple(s) for s in shapes[name]])
    for r in rows:
        print("(F2) " + json.dumps(r))
    return rows


# -- the second lane of the full run ---------------------------------------------

# these later phases run in a process of their own (`--lane`), on an engine
# of their own (the same model and seed, so the same weights), while the
# main process runs (s)-(w), (R) and (S): the host is the bound of every
# phase (the card idles most of the time), and one process is one thread of
# Python. No kernel is timed while the lane runs: (b), (f) and (n) come
# before it, (j) and (F2) after it. Its kernel counts come back on its last
# line.
LANE_PHASES = ("x", "y", "z", "C", "F")
LANE_LOG = "build/chip_smoke_lane.log"  # the lane's output, shown when it ends
P_LANE_LOG = "build/chip_smoke_lane_P.log"  # (P)'s lane
# (F3)'s MoE depth in the lane: 12 of 48 layers (--only F keeps all 48),
# so that its engines and the main process's replicas fit on the card at once
F_MOE_LANE_LAYERS = 12


def start_lane(phases, log_path=LANE_LOG) -> subprocess.Popen:
    """`chip_smoke.py --lane` on `phases` (`--only X` for one of (P) and
    the mesh phases), its output to log_path."""
    import os

    args = (["--only", phases[0]] if len(phases) == 1 and phases[0] in ("P", *MESH_PHASES)
            else ["--lane", ",".join(phases)])
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                                stdout=log, stderr=subprocess.STDOUT)
    print(f"(lane) {', '.join(phases)} started in a process of their own (pid "
          f"{proc.pid}); their output follows when they end")
    return proc


def lane_tail(log_path=LANE_LOG) -> str:
    with open(log_path) as f:
        return f.read()[-6000:]


def join_lane(proc, log_path=LANE_LOG, last_prefix="LANE "):
    """Wait for a lane, show its output, and return its last line that
    starts with last_prefix (the LANE line's JSON for the --lane one)."""
    rc = proc.wait()
    with open(log_path) as f:
        text = f.read()
    sys.stdout.write(text if text.endswith("\n") or not text else text + "\n")
    last = [line for line in text.splitlines() if line.startswith(last_prefix)]
    if rc != 0 or not last:
        print(f"the lane exited with {rc}; the end of its output:\n{text[-6000:]}",
              file=sys.stderr)
    check(rc == 0 and bool(last), f"the lane ({log_path}) exited with {rc}")
    return json.loads(last[-1][len(last_prefix):]) if last_prefix == "LANE " else last[-1]


def stop_lane(proc, log_path=LANE_LOG):
    """Stop a lane if it still runs (the main process failed first): its
    SIGTERM handler runs its finally blocks, which stop its servers (a
    `--only P` lane has none; its stage processes leave once they see
    their parent gone)."""
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
    print(f"the lane was stopped; the end of its output:\n{lane_tail(log_path)}",
          file=sys.stderr)


def main_lane(torch, engine, kernels, pa, fa, Q, P, G, timer, faults, smi, t_start):
    """The main process's phases while the lane runs: (launches_R,
    launches_S)."""
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

    # (v) the block-prefix cache and the KV shadow on the paged fleet
    phase_v(torch, engine, pa, fa, Q, P, G, smi)
    print(f"(v) total {time.time() - t_start:.1f} s")

    # (w) the cross-replica KV fabric: a holder replica and in-process pullers
    phase_w(torch, engine, pa, fa, Q, smi)
    print(f"(w) total {time.time() - t_start:.1f} s")

    # (R) the router tier: the port's router in front of replica processes
    r_launches = phase_R(torch, kernels, smi, beside_lane=True)
    print(f"(R) total {time.time() - t_start:.1f} s")

    # (S) the solo engine's features: speculation (n-gram and a draft
    # model), beams, echo scoring, the prefix snapshots, the queue
    s_launches = phase_S(torch, engine, pa, fa, Q, G, timer, smi)
    print(f"(S) total {time.time() - t_start:.1f} s")
    return r_launches, s_launches


def run_lane(phases, torch, engine, pa, fa, Q, P, G, M, faults, smi, t0, t_start) -> int:
    """`--lane`: the named phases of LANE_PHASES, in its order, on this
    process's engine; the last line `LANE {...}` holds each one's kernel
    counts and (F)'s solo chunk shapes. A SIGTERM, or the main process's
    exit, ends it through its finally blocks."""
    import os
    import signal
    import threading

    bad = [p for p in phases if p not in LANE_PHASES]
    check(not bad, f"--lane: {bad} is not among {LANE_PHASES}")
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=watch, name="lane-parent-watch", daemon=True).start()
    print(f"(lane) {MODEL} bf16, random weights (seed 0), built in "
          f"{time.time() - t0:.1f} s; phases {', '.join(phases)}")
    out = {}
    for p in (p for p in LANE_PHASES if p in phases):
        if p == "x":
            out[p] = phase_x(torch, engine, pa, fa, Q, P, G, M, faults, smi)
        elif p == "y":
            out[p] = phase_y(torch, engine, pa, fa, Q, P, G, smi)
        elif p == "z":
            out[p] = phase_z(torch, engine, pa, fa, Q, P, G, M, faults, smi)
        elif p == "C":
            out[p] = phase_C(torch, engine, pa, fa, Q, P, G, M, smi)
        else:
            f_free(torch)
            out["F"], out["F_shapes"] = phase_F(torch, pa, fa, Q, P, G, M, smi,
                                                moe_layers=F_MOE_LANE_LAYERS)
        print(f"({p}) total {time.time() - t_start:.1f} s in the lane")
    print("LANE " + json.dumps(out))
    return 0


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--only", choices=["b", "f", "r", "j", "s", "v", "w", "x", "y", "z",
                                       "C", "S", "F", "R", "P", "D", "M", "L", "E", "N",
                                       "H"],
                    help="run (a) and then only (b) with the kernels line's two "
                         "flash_attend entries at the solo chunks (b), only (f)'s "
                         "and (j)'s paged_flash_attend cases with the kernels "
                         "line's two entries (f), only their ragged_paged_attend "
                         "cases with a sweep of its plans and the kernels line's "
                         "two entries (r), or only (j)'s q4_matmul_rows cases "
                         "(j), with the kernel's build log: a quick check of a "
                         "flash_attend, paged decode, ragged or q4 change; or "
                         "(s), (t) and (u) on the raw engine (s): a quick check "
                         "of the fleet's preemption, supervisor and health sweep; "
                         "or (v) on the raw engine (v): the block-prefix cache "
                         "and the KV shadow; or (w) on the raw engine (w): the "
                         "cross-replica KV fabric; or (x) on the raw engine (x): "
                         "speculation on the mixed launch; or (y) on the raw engine "
                         "(y): token streaming, cancellation and the OpenAI routes; or "
                         "(z) on the raw engine (z): runtime LoRA adapters; or (C) "
                         "on the raw engine (C): grammar constraints; or (S) on the "
                         "raw engine (S): the solo engine's features; or (F) alone "
                         "(F): gpt2-medium and qwen3-30b-a3b at full width, the "
                         "kernels at their widths, and --checkpoint; or (R) alone "
                         "(R): the port's router in front of replica processes, "
                         "the fleet's traces, failover; or (P) alone (P): the MPMD "
                         "stage pipeline of stage processes over HTTP; or (D) alone "
                         "(D): the pp / tp pipeline backend's rank processes; or "
                         "(M), (L) or (E) alone: the 1F1B schedule, the context "
                         "ring (sp), the expert mesh (ep); or (N) alone: the solo "
                         "surface, adapters and the sharded store on the pp ring; or "
                         "(H) alone: two server processes over one mesh")
    ap.add_argument("--lane", help="run (a) and then these later phases of the full run "
                                   "(a comma-separated subset of "
                                   + ",".join(LANE_PHASES) + ") on an engine of their "
                                   "own, and print their kernel counts as the last line; "
                                   "the full run starts this beside its own phases")
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

    if args.only == "R":
        launches = phase_R(torch, kernels, smi)
        print(f"(R) total {time.time() - t_start:.1f} s")
        print("(R) " + json.dumps({"launches_R": launches}))
        return 0
    if args.only == "P":
        phase_P(torch, kernels, smi)
        print(f"(P) total {time.time() - t_start:.1f} s")
        return 0
    if args.only in MESH_PHASES:
        phase_mesh(torch, kernels, smi, (args.only,))
        print(f"({args.only}) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "F":
        launches, shapes = phase_F(torch, pa, fa, Q, P, G, M, smi, profile=True)
        phase_F2(torch, timer, pa, fa, Q, P, shapes)
        print(f"(F) total {time.time() - t_start:.1f} s")
        print("(F) " + json.dumps({"launches_F": launches}))
        return 0
    if args.only not in ("s", "v", "w", "x", "y", "z", "C", "S") and not args.lane:
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
    if args.only == "v":
        print(f"(v) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_v(torch, engine, pa, fa, Q, P, G, smi)
        print(f"(v) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "w":
        print(f"(w) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_w(torch, engine, pa, fa, Q, smi)
        print(f"(w) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "x":
        print(f"(x) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_x(torch, engine, pa, fa, Q, P, G, M, faults, smi)
        print(f"(x) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "y":
        print(f"(y) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_y(torch, engine, pa, fa, Q, P, G, smi)
        print(f"(y) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "z":
        print(f"(z) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_z(torch, engine, pa, fa, Q, P, G, M, faults, smi)
        print(f"(z) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "C":
        print(f"(C) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_C(torch, engine, pa, fa, Q, P, G, M, smi)
        print(f"(C) total {time.time() - t_start:.1f} s")
        return 0
    if args.only == "S":
        print(f"(S) {MODEL} bf16, random weights (seed 0), built in "
              f"{time.time() - t0:.1f} s")
        phase_S(torch, engine, pa, fa, Q, G, timer, smi)
        print(f"(S) total {time.time() - t_start:.1f} s")
        return 0
    if args.lane:
        return run_lane(args.lane.split(","), torch, engine, pa, fa, Q, P, G, M, faults, smi,
                        t0, t_start)
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

    # the second lane: LANE_PHASES in a process of their own from here on,
    # beside (s)-(S) below; no kernel is timed in either until it has ended
    torch.cuda.empty_cache()
    lane = start_lane(LANE_PHASES)
    # (P) the MPMD stage pipeline, a third process: its controller and
    # frontend, and its two stage processes (it loads no kernel)
    p_lane = start_lane(["P"], P_LANE_LOG)
    mesh_lanes = []
    try:
        r_launches, s_launches = main_lane(
            torch, engine, kernels, pa, fa, Q, P, G, timer, faults, smi, t_start)
        lane_out = join_lane(lane)
        # (D), (M), (L), (E), (N) and (H): the mesh backends' rank processes, a
        # process each once the main process's own phases and the lane are
        # done: their ranks are host-bound Python, and beside those the
        # host's cores would be oversubscribed (the lane's waves have TTFT
        # targets); the four share the card and the cores, and their own
        # waves ride the unsheddable "batch" class
        mesh_lanes = [(start_lane([p], MESH_LANE_LOG.format(p)), MESH_LANE_LOG.format(p))
                      for p in MESH_PHASES]
        join_lane(p_lane, P_LANE_LOG, last_prefix="(P) total")
        mesh_out = {}
        for proc, log in mesh_lanes:
            mesh_out.update(json.loads(join_lane(proc, log, last_prefix="MESH ")
                                       [len("MESH "):]))
    finally:
        stop_lane(lane)
        stop_lane(p_lane, P_LANE_LOG)
        for proc, log in mesh_lanes:
            stop_lane(proc, log)
    x_launches, y_launches, z_launches, c_launches, f_launches = (
        lane_out[k] for k in ("x", "y", "z", "C", "F"))
    print(f"(lane) joined; total {time.time() - t_start:.1f} s")

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

    # (F2) the kernels at (F)'s widths (its serving ran in the lane)
    del qengine
    f_free(torch)
    phase_F2(torch, timer, pa, fa, Q, P, lane_out["F_shapes"])
    print(f"(F2) total {time.time() - t_start:.1f} s")
    ragged_entry = ragged_line(paged_rows, wave["launches"], False, P)
    paged_entry = paged_decode_line(paged_rows, wave["launches"], False)
    # the speculation path's own counts ((x1)'s verify wave, (x2)'s draft
    # waves) and the streamed wave's ((y1)), beside (g)'s
    for entry in (ragged_entry, paged_entry):
        entry["launches_x"] = x_launches[entry["name"]]
        entry["launches_y"] = y_launches[entry["name"]]
    line = {"kernels": [
        flash_entry,
        ragged_entry,
        paged_entry,
        q4_line(q4_rows, qwave["launches"]),
        kernels_line(torch, timer, fa, solo_chunks,
                     solo_launches["flash_attend[int8]"], int8=True),
        ragged_line(int8_rows, qwave["launches"], True, P),
        paged_decode_line(int8_rows, qwave["launches"], True),
        slots_line(slots_rows, slots_driven,
                   dense_launches["flash_attend_slots"]
                   + whole_launches["flash_attend_slots"]),
    ]}
    # the adapter path's own counts: (z1)'s wave and (z6)'s quantized request
    # (C)'s: (C1)'s constrained requests beside the fleet and (C2)'s dense waves
    # (S)'s: the solo engine's features, request by request
    for entry in line["kernels"]:
        entry["launches_z"] = z_launches[entry["name"]]
        entry["launches_C"] = c_launches[entry["name"]]
        entry["launches_S"] = s_launches[entry["name"]]
        entry["launches_F"] = f_launches.get(entry["name"], 0)
        entry["launches_R"] = r_launches.get(entry["name"], 0)
        entry["launches_D"] = mesh_out["D"].get(entry["name"], 0)
        entry["launches_M"] = mesh_out["M"].get(entry["name"], 0)
        entry["launches_E"] = mesh_out["E"].get(entry["name"], 0)
        entry["launches_N"] = mesh_out["N"].get(entry["name"], 0)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import faulthandler

    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    sys.exit(main(sys.argv[1:]))
