// T=1 decode attention over the dense slot cache, as a split-KV
// (flash-decoding) kernel for Hopper.
//
// Replaces: the Pallas TPU kernel `_slots_kernel` of the JAX package
// (distributed_llm_inference_tpu/ops/paged_attention.py:261), launched by
// `flash_attend_slots` through pl.pallas_call at :436. Same function:
// q [B, 1, H, Dh] over the dense fleet cache [B, KV, S, Dh]; row b's
// query sits at pos[b] and attends its own cache row's keys at positions
// <= pos[b] and < S (a finished slot frozen at pos >= S attends all S),
// with a window only those > pos[b] - window; a row with no live key
// (pos < 0) gives zeros. Scale Dh ** -0.5 (passed in), no softcap; the
// running max, sum and accumulator are fp32; output in q's dtype (fp32,
// bf16 or fp16); Dh <= 256; a raw cache only (the JAX kernel has no int8
// variant).
//
// What bounds it, and what the design does about it: the split-KV walk of
// csrc/decode_walk.cuh (its note), with the `DenseRows` policy: row b's
// keys are rows 0 .. S - 1 of cache[b, kvh]. bench.py's fleet leg (B = 8,
// KV = 4, pos 1024, Dh 64, bf16) moves 8.4 MB, 2.5 us at 3.35 TB/s, and
// one block per (row, KV head) would put 32 blocks on 132 SMs: the walk
// shares each row's live range among `_slots_splits` blocks
// (ops/paged_attention.py), merged in a fixed order by a second kernel.

#include "decode_walk.cuh"

// T=1 decode over the dense slot cache: q / out [B, 1, H, Dh] and
// cache_k / cache_v [B, KV, S, Dh] of one dtype (0 = float32, 1 =
// bfloat16, 2 = float16), pos [B] int32, win <= 0 full causal, scale
// Dh ** -0.5 (the caller's), no softcap. ws: fp32 workspace of
// B * KV * n_split * (H / KV) * (Dh + 2) floats, written before it is
// read. Launches the split kernel and the combine on `stream`; returns
// the CUDA error code of the launches (0 = launched).
extern "C" int dli_flash_attend_slots(const void* q, const void* k, const void* v, void* out,
                                      float* ws, int dtype, int B, int H, int KV, int S, int Dh,
                                      const int* pos, int win, float scale, int n_split,
                                      void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int vec = (Dh * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  WalkArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.ws = ws;
  a.pos = pos;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Dh = Dh;
  a.n_split = n_split;
  a.S = S;
  a.bs = 1;  // DenseRows: no pool blocks
  a.win_static = win;
  a.vec = vec;
  a.scale = scale;
  a.softcap = 0.f;
  if (walk_args_bad(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_walk_by_dim<float, float, DenseRows>(a, st);
    case 1: return (int)launch_walk_by_dim<__nv_bfloat16, __nv_bfloat16, DenseRows>(a, st);
    case 2: return (int)launch_walk_by_dim<__half, __half, DenseRows>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
