// GQA attention over the block-paged KV pool: T=1 decode
// (`paged_flash_attend`) and the mixed prefill + decode launch
// (`ragged_paged_attend`), one entry point each.
//
// Replaces: the Pallas TPU kernels `_paged_kernel` (launched by
// `paged_flash_attend` through pl.pallas_call at :252) and
// `_ragged_kernel` (launched by `ragged_paged_attend`) in the JAX
// package's distributed_llm_inference_tpu/ops/paged_attention.py. Same
// function:
//   * paged: q [B, 1, H, Dh], one query per table row b at position
//     pos[b]. Key position p lives in pool block table[b, p / bs] at slot
//     p % bs of the pool [N, KV, bs, Dh]; an id outside [0, N) reads block
//     0, the trash block. Row b attends its keys at positions <= pos[b]
//     and < MB * bs (a row at pos >= MB * bs attends all MB * bs, as
//     `_live_range` clips), with a sliding window win > 0 only those >
//     pos[b] - win.
//   * ragged: q [W, H, Dh] is a flat query axis cut into G tiles of
//     tq = W / G queries; tile g carries meta[g] = (row, q_start, q_len,
//     kind). Query t of the tile (t < q_len) sits at absolute position
//     q_start + t of fleet row `row` and attends that row's keys at
//     positions <= its own (and, with a window, > q_pos - win). A tile
//     with q_len == 0 (launch padding) and rows with t >= q_len output
//     zeros.
// Scores are scaled, soft-capped (cap * tanh(s / cap)) before the mask;
// the running max, sum and accumulator are fp32. Output in the input dtype
// (fp32, bf16 or fp16), Dh <= 256. The window is static, or one int32 on
// the device (`win_dyn`, a per-layer width).
//   * int8 pool: the pool holds int8 K/V with one fp32 scale per (block,
//     KV head, slot), scales [N, KV, bs] (the JAX kernels' KVQuant
//     operands), dequantized on the SM: q8 * s in fp32.
//
// What bounds them on an H100: every live pool block's K/V rows are read
// once per KV head; a decode row does 4 * Dh FLOPs per head per live key
// against 2 * Dh * esize bytes per key and KV head, i.e. ~2 * group = 16
// FLOPs per byte for tinyllama (H/KV = 8): far below the ~295 at which the
// bf16 tensor cores stop being memory-bound, so decode and mixed launches
// are bound by BYTES. Only a long prefill chunk (q_len = tq queries over a
// long prefix) reaches ~8x that, still bytes-bound at tq = 8. At the
// fleet's decode step (B = 8 rows of up to 1024 keys, KV = 4) one block
// per (row, KV head) would put 32 blocks on 132 SMs, each walking its
// row's keys one tile after another.
//
// What the designs do about it:
//   * paged: the split-KV walk of csrc/decode_walk.cuh (its note) with
//     the `PagedRows` policy. `_paged_splits` (ops/paged_attention.py)
//     fixes n_split on the host so that B * KV * n_split fills every SM
//     twice (9 at the fleet's B = 8); each block reads pos[b], the window
//     and its tiles' block ids on the device, and walks its share of the
//     row's live range through a cp.async ring with tensor-core products
//     (bf16 / fp16); an int8 pool's rows and scales ride the ring at half
//     the bytes and each warp dequantizes its own keys. A second kernel
//     merges the splits in a fixed order, so repeats are bit-equal and
//     nothing is read back to the host: the fleet's decode chunk captures
//     the call in its CUDA graph.
//   * ragged (`paged_fwd`, a first, simple kernel): one block owns one
//     (query tile g, KV head). The GQA group's heads fold into the block's
//     query rows (row r = t * group + head), as the TPU kernel folds them,
//     so each pool block of K/V is read from device memory once for all
//     the heads that share it. The block reads meta[g] and table[row, j]
//     itself (the TPU's scalar prefetch): the mixed step rewrites meta on
//     the card (engine/paged.apply_device_meta), and the host never reads
//     it. The TPU kernel's sequential KV grid axis becomes a loop inside
//     the block over the tile's live key range [first * bs, needed * bs)
//     of `_ragged_live_range`, staged through shared memory in tiles of
//     BN = 64 positions in fp32; fp32 FMAs on the CUDA cores, no copy /
//     compute overlap. The int8 prologue stages q8 * s in fp32, the order
//     of the JAX kernel's `k.astype(f32) * scale`.

#include "decode_walk.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* table;  // [R, MB]
  const int* meta;   // [G, 4]
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

  extern __shared__ float fwd_smem[];
  float* Qs = fwd_smem;       // [BM][QS]  scaled queries
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
  const int g = blockIdx.z;  // query tile
  const int group = a.H / a.KV;
  const int rows_total = a.tq * group;
  const int row0 = blockIdx.x * BM;
  const int Dh = a.Dh;

  // this tile's placement, read on the device (the TPU's scalar prefetch)
  const int row = min(max(a.meta[4 * g + 0], 0), a.R - 1);
  const int q_start = a.meta[4 * g + 1];
  const int q_len = a.meta[4 * g + 2];
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
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = a.tq * (a.H / a.KV);
  const dim3 grid((rows + BM - 1) / BM, a.KV, n_tiles);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// a tile of tq queries x group heads takes up to 64 rows (32 at Dh 256)
// per block and splits across blocks beyond that
template <typename T, typename KT>
cudaError_t dispatch(const Args& a, int n_tiles, cudaStream_t stream) {
  if (a.Dh <= 64) return launch<T, KT, 64, 8>(a, n_tiles, stream);
  if (a.Dh <= 128) return launch<T, KT, 128, 8>(a, n_tiles, stream);
  return launch<T, KT, 256, 4>(a, n_tiles, stream);
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
// [N, KV, bs] (both null for a raw pool); win_dyn: one int32 on the
// device that overrides win_static, or null; a width <= 0 means full
// causal. softcap <= 0 means off. Each launches on `stream` and returns
// the CUDA error code of the launch (0 = launched).

// Mixed prefill + decode: q / out [G * tq, H, Dh], tables [R, MB] int32,
// meta [G, 4] int32.
extern "C" int dli_ragged_paged_attend(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, int dtype, int G, int tq, int H, int KV,
    int N, int bs, int R, int MB, int Dh, const int* table, const int* meta,
    int win_static, const int* win_dyn, float scale, float softcap, void* stream) {
  Args a{q, k, v, out, table, meta, win_dyn, k_scale, v_scale, win_static,
         tq, H, KV, N, bs, MB, R, Dh, scale, softcap};
  return run(a, dtype, G, stream);
}

// T=1 decode: q / out [B, 1, H, Dh], table [B, MB], pos [B] int32. ws: fp32
// workspace of B * KV * n_split * (H / KV) * (Dh + 2) floats, written
// before it is read; n_split blocks share each (row, KV head)'s live keys.
// Launches the split kernel and the combine.
extern "C" int dli_paged_flash_attend(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, float* ws, int dtype, int B, int H, int KV,
    int N, int bs, int MB, int Dh, const int* table, const int* pos, int win_static,
    const int* win_dyn, float scale, float softcap, int n_split, void* stream) {
  if (N <= 0 || bs <= 0 || MB <= 0 || table == nullptr || (long long)MB * bs > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const bool int8 = k_scale != nullptr;
  const int esize = int8 ? 1 : dtype == 0 ? 4 : 2;
  const int vec = (Dh * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  WalkArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = out;
  a.ws = ws;
  a.pos = pos;
  a.table = table;
  a.win_dyn = win_dyn;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Dh = Dh;
  a.n_split = n_split;
  a.S = MB * bs;
  a.N = N;
  a.bs = bs;
  a.MB = MB;
  a.win_static = win_static;
  a.vec = vec;
  a.scale = scale;
  a.softcap = softcap;
  if (walk_args_bad(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (int8 ? 1 : 0)) {
    case 0: return (int)launch_walk_by_dim<float, float, PagedRows>(a, st);
    case 1: return (int)launch_walk_by_dim<float, int8_t, PagedRows>(a, st);
    case 2: return (int)launch_walk_by_dim<__nv_bfloat16, __nv_bfloat16, PagedRows>(a, st);
    case 3: return (int)launch_walk_by_dim<__nv_bfloat16, int8_t, PagedRows>(a, st);
    case 4: return (int)launch_walk_by_dim<__half, __half, PagedRows>(a, st);
    case 5: return (int)launch_walk_by_dim<__half, int8_t, PagedRows>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
