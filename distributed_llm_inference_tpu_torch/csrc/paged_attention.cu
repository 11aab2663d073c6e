// GQA attention over the block-paged KV pool: the mixed prefill + decode
// launch (`ragged`) and T=1 decode (`paged`): one device function with two
// entry points. (T=1 decode over the dense slot cache is
// csrc/slots_attention.cu.)
//
// Replaces: the Pallas TPU kernels `_ragged_kernel` (launched by
// `ragged_paged_attend`) and `_paged_kernel` (launched by
// `paged_flash_attend`) in the JAX package's
// distributed_llm_inference_tpu/ops/paged_attention.py. Same function:
//   * ragged: q [W, H, Dh] is a flat query axis cut into G tiles of
//     tq = W / G queries; tile g carries meta[g] = (row, q_start, q_len,
//     kind). Query t of the tile (t < q_len) sits at absolute position
//     q_start + t of fleet row `row` and attends that row's keys at
//     positions <= its own (and, with a sliding window win > 0, > q_pos -
//     win). Key position p lives in pool block table[row, p / bs] at slot
//     p % bs of the pool [N, KV, bs, Dh]. A tile with q_len == 0 (launch
//     padding) and rows with t >= q_len output zeros.
//   * paged: q [B, 1, H, Dh], one query per table row b at position
//     pos[b]: the same walk with tq = 1, q_start = pos[b], q_len = 1.
// Scores are scaled, soft-capped (cap * tanh(s / cap)) before the mask;
// the running max, sum and accumulator are fp32. Output in the input dtype
// (fp32, bf16 or fp16), Dh <= 256.
//   * int8 pool: the pool holds int8 K/V with one fp32 scale per (block,
//     KV head, slot), scales [N, KV, bs] (the JAX kernels' KVQuant
//     operands). The tile prologue loads each int8 element and its scale
//     and stages q8 * s in fp32, then the dot runs as for a raw pool: the
//     order of the JAX kernel's `k.astype(f32) * scale` prologue.
//
// What bounds it on an H100: every live pool block's K/V rows are read once
// per KV head; a decode row does 4 * Dh FLOPs per head per live key
// against 2 * Dh * esize bytes per key and KV head, i.e. ~2 * group = 16
// FLOPs per byte for tinyllama (H/KV = 8): far below the ~295 at which the
// bf16 tensor cores stop being memory-bound, so decode and mixed launches
// are bound by BYTES. Only a long prefill chunk (q_len = tq queries over a
// long prefix) reaches ~8x that, still bytes-bound at tq = 8.
//
// What the design does about it:
//   * One block owns one (query tile g or row b, KV head). The GQA group's
//     heads fold into the block's query rows (row r = t * group + head), as
//     the TPU kernel folds them, so each pool block of K/V is read from
//     device memory once for all the heads that share it.
//   * The block reads meta[g] and table[row, j] from device memory itself
//     (the TPU's scalar prefetch): the mixed step rewrites meta on the card
//     (engine/paged.apply_device_meta), and the host never reads it.
//   * The TPU kernel's sequential KV grid axis becomes a loop inside the
//     block over the tile's live key range [first * bs, needed * bs) of
//     `_ragged_live_range`: padding tiles, blocks past the causal frontier
//     and blocks before the window are never read.
//   * Keys are staged through shared memory in tiles of BN = 64 positions
//     (four 16-token pool blocks), gathered block by block through the
//     table; scores and probabilities never leave the SM.
// An int8 pool halves the K/V bytes of every live block (Dh int8 bytes
// plus one 4-byte scale per position and KV head, against 2 * Dh at bf16).
// It is a first, simple kernel: fp32 FMAs on the CUDA cores, no tensor
// cores, no copy/compute overlap, one block per (tile, KV head) — few
// blocks in flight at decode sizes (B = 8: 32 blocks on 132 SMs). The
// split-KV walk of csrc/slots_attention.cu (cp.async tiles, tensor-core
// products) is the design this kernel can take over with a block table.

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* table;  // [R, MB]
  const int* meta;   // [G, 4] (ragged) or null
  const int* pos;    // [B] (paged) or null
  const int* win_dyn;
  const float* k_scale;  // [N, KV, bs] for an int8 pool, else null
  const float* v_scale;
  int win_static;
  int tq, H, KV, N, bs, MB, R, Dh;
  float scale, softcap;
};

// DHP: head dim padded to a power of two (>= Dh); RM: query rows per
// thread (row tile BM = 8 * RM rows); BN = 64 key positions per KV tile
// (CN = 4 score columns per thread). Thread (ty = tid / 16, tx = tid % 16)
// owns rows ty*RM .. ty*RM+RM-1, score columns tx + 16*c and output
// columns tx + 16*d; a row's 16 threads sit in one half-warp, so row max
// and sum reduce with four xor shuffles.
// KT: the pool's storage type, T or int8_t (then with scales).
template <typename T, typename KT, int DHP, int RM>
__global__ void __launch_bounds__(NT) paged_fwd(Args a) {
  constexpr int CN = 4;
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

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KT* __restrict__ k = static_cast<const KT*>(a.k);
  const KT* __restrict__ v = static_cast<const KT*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int kvh = blockIdx.y;
  const int g = blockIdx.z;  // query tile (ragged) or table row (paged)
  const int group = a.H / a.KV;
  const int rows_total = a.tq * group;
  const int row0 = blockIdx.x * BM;
  const int Dh = a.Dh;

  // this tile's placement, read on the device (the TPU's scalar prefetch)
  int row, q_start, q_len;
  if (a.pos != nullptr) {
    row = g;
    q_start = a.pos[g];
    q_len = 1;
  } else {
    row = a.meta[4 * g + 0];
    q_start = a.meta[4 * g + 1];
    q_len = a.meta[4 * g + 2];
  }
  row = min(max(row, 0), a.R - 1);
  const int win = a.win_dyn != nullptr ? *a.win_dyn : a.win_static;

  // query tile, fp32, pre-scaled (the TPU kernel scales q before the dot)
  for (int i = tid; i < BM * DHP; i += NT) {
    const int r = i / DHP, d = i % DHP;
    const int rf = row0 + r;
    float val = 0.f;
    if (rf < rows_total && d < Dh && rf / group < q_len) {
      const int t = rf / group, hh = rf % group;
      const size_t w = (size_t)g * a.tq + t;
      val = to_f32(q[(w * a.H + (size_t)kvh * group + hh) * Dh + d]) * a.scale;
    }
    Qs[r * QS + d] = val;
  }

  int qpos[RM];
  bool rok[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rf = row0 + ty * RM + i;
    const int t = rf / group;
    rok[i] = rf < rows_total && t < q_len;
    qpos[i] = q_start + (rok[i] ? t : 0);
  }

  // live key range of this row tile (`_ragged_live_range`, in positions):
  // up to its last live query; with a window, from its first query's
  // window start; never past the table's MB blocks
  const int t_lo = row0 / group;
  const int t_hi = min(min((row0 + BM - 1) / group, a.tq - 1), q_len - 1);
  int lo = 0, hi = 0;
  if (q_len > 0 && t_lo <= t_hi) {
    const int last = q_start + t_hi;
    const int needed = min(max((last + 1 + a.bs - 1) / a.bs, 1), a.MB);
    int first = 0;
    if (win > 0) first = min(max(q_start + t_lo - win + 1, 0) / a.bs, needed - 1);
    lo = first * a.bs;
    hi = needed * a.bs;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int* trow = a.table + (size_t)row * a.MB;
  for (int kv0 = lo; kv0 < hi; kv0 += BN) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done
    for (int i = tid; i < BN * DHP; i += NT) {
      const int n = i / DHP, d = i % DHP;
      const int p = kv0 + n;
      float kk = 0.f, vv = 0.f;
      if (p < hi && d < Dh) {
        int blk = trow[p / a.bs];
        blk = (blk >= 0 && blk < a.N) ? blk : 0;  // a bad id reads the trash block
        const size_t row = ((size_t)blk * a.KV + kvh) * a.bs + p % a.bs;
        const size_t off = row * Dh + d;
        if constexpr (std::is_same<KT, int8_t>::value) {  // dequant prologue
          kk = (float)k[off] * a.k_scale[row];
          vv = (float)v[off] * a.v_scale[row];
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
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool ok = rok[i] && kp < hi && kp <= qpos[i] &&
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

  // every row of the tile is written: a dead row (padding tile, t >= q_len)
  // has acc = 0 and l = 0, so it writes zeros as the TPU kernel does
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rf = row0 + ty * RM + i;
    if (rf >= rows_total) continue;
    const int t = rf / group, hh = rf % group;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    const size_t w = (size_t)g * a.tq + t;
    T* o = out + (w * a.H + (size_t)kvh * group + hh) * Dh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dh) o[d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, typename KT, int DHP, int RM>
cudaError_t launch(const Args& a, int n_tiles, cudaStream_t stream) {
  constexpr int BM = 8 * RM, BN = 64;
  const size_t smem =
      sizeof(float) * (BM * (DHP + 1) + BN * (DHP + 1) + BN * DHP + BM * (BN + 1));
  auto kernel = paged_fwd<T, KT, DHP, RM>;
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
  const int rows = a.tq * (a.H / a.KV);
  const dim3 grid((rows + BM - 1) / BM, a.KV, n_tiles);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows per tile <= 8 (decode: the GQA group alone) take one row per
// thread; larger tiles (a ragged tile of tq queries x group heads) take
// up to 64 (32 at Dh 256) per block and split across blocks beyond that
template <typename T, typename KT>
cudaError_t dispatch(const Args& a, int n_tiles, cudaStream_t stream) {
  const bool small = a.tq * (a.H / a.KV) <= 8;
  if (a.Dh <= 64) return small ? launch<T, KT, 64, 1>(a, n_tiles, stream)
                               : launch<T, KT, 64, 8>(a, n_tiles, stream);
  if (a.Dh <= 128) return small ? launch<T, KT, 128, 1>(a, n_tiles, stream)
                                : launch<T, KT, 128, 8>(a, n_tiles, stream);
  return small ? launch<T, KT, 256, 1>(a, n_tiles, stream)
               : launch<T, KT, 256, 4>(a, n_tiles, stream);
}

// a pool is the query's dtype, or int8 with both scale arrays
template <typename T>
cudaError_t by_layout(const Args& a, int n_tiles, cudaStream_t stream) {
  if (a.k_scale != nullptr) return dispatch<T, int8_t>(a, n_tiles, stream);
  return dispatch<T, T>(a, n_tiles, stream);
}

int run(const Args& a, int dtype, int n_tiles, void* stream) {
  if (n_tiles <= 0 || a.tq <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.Dh <= 0 ||
      a.Dh > 256 || a.bs <= 0 || a.MB <= 0 || a.R <= 0 || a.N <= 0 ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)by_layout<float>(a, n_tiles, st);
    case 1: return (int)by_layout<__nv_bfloat16>(a, n_tiles, st);
    case 2: return (int)by_layout<__half>(a, n_tiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out). Pools
// [N, KV, bs, Dh] of that dtype, or int8 with k_scale / v_scale fp32
// [N, KV, bs] (both null for a raw pool);
// tables [R, MB] int32; win_dyn: one int32 on the device that overrides
// win_static, or null; a width <= 0 means full causal. softcap <= 0 means
// off. Each launches on `stream` and returns the CUDA error code of the
// launch (0 = launched).

// Mixed prefill + decode: q / out [G * tq, H, Dh], meta [G, 4] int32.
extern "C" int dli_ragged_paged_attend(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, int dtype, int G, int tq, int H, int KV,
    int N, int bs, int R, int MB, int Dh, const int* table, const int* meta,
    int win_static, const int* win_dyn, float scale, float softcap, void* stream) {
  Args a{q, k, v, out, table, meta, nullptr, win_dyn, k_scale, v_scale, win_static,
         tq, H, KV, N, bs, MB, R, Dh, scale, softcap};
  return run(a, dtype, G, stream);
}

// T=1 decode: q / out [B, 1, H, Dh], table [B, MB], pos [B] int32.
extern "C" int dli_paged_flash_attend(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, int dtype, int B, int H, int KV, int N,
    int bs, int MB, int Dh, const int* table, const int* pos, int win_static,
    const int* win_dyn, float scale, float softcap, void* stream) {
  Args a{q, k, v, out, table, nullptr, pos, win_dyn, k_scale, v_scale, win_static,
         1, H, KV, N, bs, MB, B, Dh, scale, softcap};
  return run(a, dtype, B, stream);
}
