// Causal GQA flash attention of a query chunk over the dense KV cache.
//
// Replaces: the Pallas TPU kernel `_flash_kernel` in the JAX package's
// distributed_llm_inference_tpu/ops/flash_attention.py (launched by its
// `flash_attend` through `pl.pallas_call`). Same function: queries
// q [B, T, H, Dh] at absolute positions pos..pos+T-1 attend the keys of
// the cache [B, KV, S, Dh] at positions <= their own, >= the row's
// valid_start, and, with a sliding window win > 0, > q_pos - win. Scores
// are scaled, soft-capped (cap * tanh(s / cap)) before the mask, and the
// softmax with its running max and sum, and the output accumulator, are
// fp32. A row with no live key outputs zeros. The output is in the input
// dtype (fp32, bf16 or fp16), Dh <= 256.
//   * int8 cache: the cache holds int8 K/V with one fp32 scale per (row,
//     KV head, position), scales [B, KV, S] (the JAX kernel's KVQuant
//     operands). The tile prologue loads each int8 element and its scale
//     and stages q8 * s in fp32, then the dot runs as for a raw cache: the
//     order of the JAX kernel's `k.astype(f32) * scale` prologue. An int8
//     cache halves the K/V bytes of every live tile.
//
// What bounds it on an H100: per live (query, key) pair the work is
// 4 * Dh FLOPs for each of the H query heads, against one read of each
// live K/V row per KV head. At a full prefill chunk (T = S = 2048,
// H/KV = 8) that is ~900 FLOPs per byte, far above the ~295 at which the
// bf16 tensor cores stop being memory-bound: the bound is OPERATIONS. At
// short chunks (T = 64) it is ~30 FLOPs per byte: the bound is BYTES.
//
// What the design does about it:
//   * One block owns one (batch row, KV head, query tile). The GQA group's
//     `group` heads fold into the tile's query rows (row = t * group + g,
//     as the TPU kernel folds them), so each K/V tile is read from device
//     memory once for all the heads that share it.
//   * The TPU kernel's sequential KV-tile grid axis (scratch carried from
//     one grid step to the next) becomes a loop inside the block; the
//     running max, sum and accumulator live in registers.
//   * The loop walks only KV tiles [first_live, needed): tiles past the
//     causal frontier, before the sliding window or wholly inside a row's
//     left padding are never read, so dead tiles cost no traffic.
//   * K/V tiles are staged through shared memory as fp32; scores and
//     probabilities never leave the SM.
// It is a first, simple kernel: the products run on the CUDA cores with
// fp32 FMAs (67 TFLOP/s peak), not on the tensor cores, and loads are not
// overlapped with compute. wgmma tiles fed by TMA are the way to the
// operations bound; that is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 128;  // threads per block: 8 row groups x 16 column lanes
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -0.7f * FLT_MAX;  // mask fill (the TPU kernel's _NEG)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// DHP: head dim padded to a power of two (>= Dh); RM: query rows per
// thread (tile BM = 8 * RM rows); CN: score columns per thread (tile
// BN = 16 * CN keys). Thread (ty = tid / 16, tx = tid % 16) owns rows
// ty*RM .. ty*RM+RM-1, score columns tx + 16*c and output columns
// tx + 16*d; a row's 16 threads sit in one half-warp, so row max and sum
// reduce with four xor shuffles. KT: the cache's storage type, T or int8_t
// (then with the scales k_scale / v_scale [B, KV, S]).
template <typename T, typename KT, int DHP, int RM, int CN>
__global__ void __launch_bounds__(NT) flash_fwd(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    T* __restrict__ out, int T_len, int H, int KV, int S, int Dh, int pos,
    const int* __restrict__ valid_start, int win_static,
    const int* __restrict__ win_dyn, float scale, float softcap) {
  constexpr int BM = 8 * RM;
  constexpr int BN = 16 * CN;
  constexpr int DC = DHP / 16;
  constexpr int QS = DHP + 1;  // padded strides: column walks avoid bank conflicts
  constexpr int KS = DHP + 1;
  constexpr int PS = BN + 1;

  extern __shared__ float smem[];
  float* Qs = smem;          // [BM][QS]  scaled queries
  float* Ks = Qs + BM * QS;  // [BN][KS]  key tile
  float* Vs = Ks + BN * KS;  // [BN][DHP] value tile
  float* Ps = Vs + BN * DHP; // [BM][PS]  probabilities of the tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int rows_total = T_len * group;
  const int row0 = blockIdx.x * BM;
  const int win = win_dyn != nullptr ? *win_dyn : win_static;
  const int vfrom = valid_start != nullptr ? valid_start[b] : 0;

  // query tile, fp32, pre-scaled (the TPU kernel scales q before the dot)
  for (int i = tid; i < BM * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int rf = row0 + r;
    float val = 0.f;
    if (rf < rows_total && d < Dh) {
      const int t = rf / group, g = rf % group;
      val = to_f32(q[(((size_t)b * T_len + t) * H + (size_t)kvh * group + g) * Dh + d]) * scale;
    }
    Qs[r * QS + d] = val;
  }

  int qpos[RM];
  bool rok[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rf = row0 + ty * RM + i;
    rok[i] = rf < rows_total;
    qpos[i] = pos + (rok[i] ? rf / group : 0);
  }

  // live KV tiles of this query tile: keys up to its last query's
  // position; with a window, from its first query's window start; never
  // wholly inside the row's left padding
  const int t_lo = row0 / group;
  const int t_hi = min((row0 + BM - 1) / group, T_len - 1);
  const int needed = min((pos + t_hi + 1 + BN - 1) / BN, (S + BN - 1) / BN);
  int first = 0;
  if (win > 0) first = max(pos + t_lo - win + 1, 0) / BN;
  first = max(first, vfrom / BN);

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const size_t srow = ((size_t)b * KV + kvh) * (size_t)S;  // scale row of (b, kvh)
  const size_t slab = srow * Dh;
  for (int j = first; j < needed; ++j) {
    const int kv0 = j * BN;
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done
    for (int i = tid; i < BN * DHP; i += NT) {
      const int n = i / DHP, d = i % DHP;
      float kk = 0.f, vv = 0.f;
      if (kv0 + n < S && d < Dh) {
        const size_t off = slab + (size_t)(kv0 + n) * Dh + d;
        if constexpr (std::is_same<KT, int8_t>::value) {  // dequant prologue
          kk = (float)k[off] * k_scale[srow + kv0 + n];
          vv = (float)v[off] * v_scale[srow + kv0 + n];
        } else {
          kk = to_f32(k[off]);
          vv = to_f32(v[off]);
        }
      }
      Ks[n * KS + d] = kk;
      Vs[n * DHP + d] = vv;
    }
    __syncthreads();

    // scores s = (q * scale) . k
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      float qv[RM], kc[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * QS + d];
#pragma unroll
      for (int c = 0; c < CN; ++c) kc[c] = Ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(qv[i], kc[c], s[i][c]);
    }

    // softcap, mask, online softmax
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kp = kv0 + tx + 16 * c;
        float x = s[i][c];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = rok[i] && kp <= qpos[i] && kp < S && kp >= vfrom &&
                        (win <= 0 || kp > qpos[i] - win);
        s[i][c] = ok ? x : NEG;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = s[i][c] == NEG ? 0.f : expf(s[i][c] - m_new);
        Ps[(ty * RM + i) * PS + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * PS + n];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[n * DHP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!rok[i]) continue;
    const int rf = row0 + ty * RM + i;
    const int t = rf / group, g = rf % group;
    const float denom = l[i] == 0.f ? 1.f : l[i];  // no live key: zeros
    T* o = out + (((size_t)b * T_len + t) * H + (size_t)kvh * group + g) * Dh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dh) o[d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, typename KT, int DHP, int RM, int CN>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, void* out, int B,
                   int T_len, int H, int KV, int S, int Dh, int pos,
                   const int* valid_start, int win_static, const int* win_dyn,
                   float scale, float softcap, cudaStream_t stream) {
  constexpr int BM = 8 * RM, BN = 16 * CN;
  const size_t smem =
      sizeof(float) * (BM * (DHP + 1) + BN * (DHP + 1) + BN * DHP + BM * (BN + 1));
  auto kernel = flash_fwd<T, KT, DHP, RM, CN>;
  // the shared-memory opt-in, once per device for this instance
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev].store(true, std::memory_order_release);
  }
  const int group = H / KV;
  const dim3 grid((T_len * group + BM - 1) / BM, KV, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      k_scale, v_scale, static_cast<T*>(out), T_len, H, KV, S, Dh, pos, valid_start,
      win_static, win_dyn, scale, softcap);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* k_scale,
                     const float* v_scale, void* out, int B,
                     int T_len, int H, int KV, int S, int Dh, int pos,
                     const int* valid_start, int win_static, const int* win_dyn,
                     float scale, float softcap, cudaStream_t stream) {
#define DLI_LAUNCH(DHP, RM, CN)                                                  \
  return launch<T, KT, DHP, RM, CN>(q, k, v, k_scale, v_scale, out, B, T_len, H, \
                                    KV, S, Dh, pos, valid_start, win_static,     \
                                    win_dyn, scale, softcap, stream)
  if (Dh <= 32) DLI_LAUNCH(32, 8, 4);
  if (Dh <= 64) DLI_LAUNCH(64, 8, 4);
  if (Dh <= 128) DLI_LAUNCH(128, 8, 4);
  DLI_LAUNCH(256, 4, 2);
#undef DLI_LAUNCH
}

// the cache is the query's dtype, or int8 with both scale arrays
template <typename T>
cudaError_t by_cache(const void* q, const void* k, const void* v, const float* k_scale,
                     const float* v_scale, void* out, int B, int T_len, int H, int KV,
                     int S, int Dh, int pos, const int* valid_start, int win_static,
                     const int* win_dyn, float scale, float softcap, cudaStream_t stream) {
  if (k_scale != nullptr)
    return dispatch<T, int8_t>(q, k, v, k_scale, v_scale, out, B, T_len, H, KV, S, Dh,
                               pos, valid_start, win_static, win_dyn, scale, softcap,
                               stream);
  return dispatch<T, T>(q, k, v, nullptr, nullptr, out, B, T_len, H, KV, S, Dh, pos,
                        valid_start, win_static, win_dyn, scale, softcap, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out). Caches
// [B, KV, S, Dh] of that dtype, or int8 with k_scale / v_scale fp32
// [B, KV, S] (both null for a raw cache). valid_start: [B] int32 on
// the device, or null for none. win_dyn: one int32 on the device that
// overrides win_static, or null; a width <= 0 means full causal.
// softcap <= 0 means off. Launches on `stream` and returns the CUDA error
// code of the launch (0 = launched).
extern "C" int dli_flash_attend(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                void* out, int dtype, int B, int T_len, int H,
                                int KV, int S, int Dh, int pos,
                                const int* valid_start, int win_static,
                                const int* win_dyn, float scale, float softcap,
                                void* stream) {
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0 || Dh <= 0 || Dh > 256 ||
      pos < 0 || pos + T_len > S || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)by_cache<float>(q, k, v, k_scale, v_scale, out, B, T_len, H, KV, S, Dh,
                                  pos, valid_start, win_static, win_dyn, scale, softcap, st);
    case 1:
      return (int)by_cache<__nv_bfloat16>(q, k, v, k_scale, v_scale, out, B, T_len, H, KV,
                                          S, Dh, pos, valid_start, win_static, win_dyn,
                                          scale, softcap, st);
    case 2:
      return (int)by_cache<__half>(q, k, v, k_scale, v_scale, out, B, T_len, H, KV, S, Dh,
                                   pos, valid_start, win_static, win_dyn, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
