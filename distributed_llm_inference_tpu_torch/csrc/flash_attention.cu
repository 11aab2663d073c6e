// Causal GQA flash attention of a query chunk over the dense KV cache, as a
// one-launch tensor-core flash-attention kernel for Hopper.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` in the JAX package's
// distributed_llm_inference_tpu/ops/flash_attention.py:84 (launched by its
// `flash_attend` through `pl.pallas_call` at :303). Same function: queries
// q [B, T, H, Dh] at absolute positions pos..pos+T-1 attend the keys of
// the cache [B, KV, S, Dh] at positions <= their own, >= the row's
// valid_start, and, with a sliding window win > 0, > q_pos - win. Scores
// are scaled, soft-capped (cap * tanh(s / cap)) before the mask, and the
// softmax with its running max and sum, and the output accumulator, are
// fp32. A row with no live key outputs zeros. The output is in the input
// dtype (fp32, bf16 or fp16), Dh <= 256. An int8 cache holds int8 K/V
// with one fp32 scale per (row, KV head, position), scales [B, KV, S].
//
// What bounds it on an H100: per live (query, key) pair the work is
// 4 * Dh FLOPs for each of the H query heads, against one read of each
// live K/V row per KV head. At the solo engine's chunks (B = 1, T <= 128,
// H / KV = 32 / 4, Dh 64, bf16) a call moves at most ~0.8 MB and does
// ~0.2 GFLOP: its bound is BYTES, ~0.3 us, and in practice the launch and
// the first DRAM round trip (a few us) set its time. At a full prefill
// chunk (T = S = 2048) it is ~900 FLOPs per byte, far above the ~295 at
// which the bf16 tensor cores stop being memory-bound: OPERATIONS.
//
// What the design does about it: the tensor-core flash walk of
// csrc/flash_walk.cuh (its note), with the `DenseChunk` row policy. One
// launch, no workspace, nothing read back to the host: a block owns 64
// folded query rows of one (batch row, KV head); when those blocks would
// not fill the card (the solo chunks give 32 or 64 of them on 132 SMs)
// and the chunk's live range is long enough, the host's plan
// (ops/flash_attention.py `flash_plan`, which knows the chunk's position)
// makes each a thread-block cluster of 2, 4 or 8 ranks that split the
// live key range in even shares of two or more tiles each: a shorter
// share measured slower than no split, the cluster's merge costing more
// than it saves. Only live tiles are walked: [first_live, needed) from
// the causal frontier, the window start and valid_start, as the TPU
// kernel's grid skips them.

#include "flash_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out). Caches
// [B, KV, S, Dh] of that dtype, or int8 with k_scale / v_scale fp32
// [B, KV, S] (both null for a raw cache). valid_start: [B] int32 on
// the device, or null for none. win_dyn: one int32 on the device that
// overrides win_static, or null; a width <= 0 means full causal.
// softcap <= 0 means off. bn, stages, cluster: the host's plan
// (ops/flash_attention.py `flash_plan`): keys per tile and ring depth,
// which must equal this build's for the shapes, and the cluster size (1,
// 2, 4 or 8) that splits each query tile's live keys. Launches on
// `stream` and returns the CUDA error code of the launch (0 = launched).
extern "C" int dli_flash_attend(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                void* out, int dtype, int B, int T_len, int H,
                                int KV, int S, int Dh, int pos,
                                const int* valid_start, int win_static,
                                const int* win_dyn, float scale, float softcap,
                                int bn, int stages, int cluster, void* stream) {
  if (pos < 0 || pos + T_len > S) return (int)cudaErrorInvalidValue;
  fw::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = out;
  a.valid_start = valid_start;
  a.win_dyn = win_dyn;
  a.B = B;
  a.T = T_len;
  a.H = H;
  a.KV = KV;
  a.Dh = Dh;
  a.S = S;
  a.pos = pos;
  a.win_static = win_static;
  a.cluster = cluster;
  a.min_share = 0;  // the plan knows the chunk's live range: every rank walks
  a.scale = scale;
  a.softcap = softcap;
  return fw::run<fw::DenseChunk>(a, dtype, bn, stages, stream);
}
