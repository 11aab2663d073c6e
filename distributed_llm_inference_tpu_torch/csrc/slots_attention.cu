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
// What bounds it on an H100: each live K/V row is read once per KV head,
// 2 * Dh * esize bytes per key, against 4 * Dh FLOPs per query head and
// key: ~2 * group = 16 FLOPs per byte for tinyllama (H / KV = 8), far
// below the ~295 at which the bf16 tensor cores stop being memory-bound.
// The kernel is bound by BYTES: bench.py's fleet leg (B = 8, KV = 4,
// pos 1024, Dh 64, bf16) moves 8.4 MB, 2.5 us at 3.35 TB/s, and one
// block per (row, KV head) would put 32 blocks on 132 SMs.
//
// What the design does about it:
//   * A split-KV grid (n_split, KV * head tiles, B). n_split is fixed on
//     the host from B, KV, S and the SM count (ops/paged_attention.py
//     `_slots_splits`); each block reads pos[b] on the device, computes
//     the row's live range [lo, hi) and takes its own even share of it
//     in BN-key tiles. The split is of the LIVE range, so an 8192-slot
//     cache at pos 1024 spends no block on dead positions; a block with
//     an empty share writes a neutral partial (m = NEG, l = 0). Nothing is
//     read back to the host: the call is capturable in a CUDA graph.
//   * Tiles of BN keys x Dh, K and V, stay in the cache's dtype and go
//     through a ring of STAGES shared-memory buffers by 16-byte
//     cp.async.cg copies, neighbouring threads on neighbouring addresses;
//     the next tiles' copies are in flight while the block computes on
//     this one (one __syncthreads per tile). Rows are padded by 16 bytes
//     so that ldmatrix's eight row addresses hit eight bank groups.
//   * bf16 / fp16: tensor-core products with the operands swapped for a
//     decode row's few query heads. Each warp owns 16 keys of the tile:
//     scores S^T = K Q^T by mma.sync.m16n8k16 with the keys as M (A from
//     shared memory by ldmatrix) and the block's 8 query heads as N (Q^T
//     held in registers for the whole walk); the probabilities go to the
//     B layout by movmatrix.trans (bf16 / fp16, as FlashAttention rounds
//     P); the output O^T = V^T P^T with V^T from shared memory by
//     ldmatrix.trans. Both products accumulate in fp32; the online softmax
//     is fp32. A group of fewer than 8 heads pads N with zero queries; a
//     larger one takes several head tiles along grid.y.
//   * fp32: the same tiles, ring and warp layout on CUDA-core FMAs (TF32
//     would not hold fp32's tolerance), each lane computing the four
//     scores and the output elements the mma's accumulator layout gives
//     it, so the softmax and the merges are one code.
//   * Each warp keeps its own (m, l, acc); at the end the block merges its
//     four warps in order and writes one fp32 partial (m, l, acc[group
//     heads, Dh]) per (row, KV head, split) to a workspace the wrapper
//     allocates. A second small kernel, one block per (row, query head),
//     merges the splits in index order 0 .. n_split - 1 with the
//     log-sum-exp rescale (each thread issues eight splits' loads at once:
//     one L2 read at a time cost ~0.3 us per split on an H100) and writes
//     the output. No atomics, so two calls give the same bits.
//   * The addressing of a key row is one small policy (`DenseRows`:
//     cache[b, kvh, p]); the paged pool's kernel can take the same walk
//     with a block-table policy.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int HT = 8;   // query heads per block: the mma's N
constexpr int KW = 16;  // keys per warp and tile: the mma's M
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SPLITS = 8192;  // the combine keeps one weight per split in shared memory
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

// two 16-bit values in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack2(__half lo, __half hi) {
  return (uint32_t)__half_as_ushort(lo) | ((uint32_t)__half_as_ushort(hi) << 16);
}

template <typename T> __device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack2(from_f32<T>(lo), from_f32<T>(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// the transpose of an 8x8 matrix of 16-bit values held one register per lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), d 16x8 fp32
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws;  // partials: acc [B, KV, n_split, group, Dh], then (m, l) [.., group, 2]
  const int* pos;
  int B, H, KV, S, Dh, win, n_split;
  int vec;  // 16-byte rows and operands: the copies go by cp.async
  float scale;
};

// The shared-memory plan of one instance. DHP: head dim padded to a
// power of two (>= Dh); RS: a staged row's stride, DHP plus 16 bytes; BN:
// keys per tile (32 only for fp32 at Dh 256, whose 64-key tiles would not
// fit twice); STAGES: tiles in the ring.
template <typename T, int DHP> struct Plan {
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr int ESZ = sizeof(T);
  static constexpr int RS = DHP + 16 / ESZ;
  static constexpr int BN = ESZ * DHP > 512 ? 32 : 64;
  static constexpr int STAGE = 2 * BN * RS;  // K then V, elements
  static constexpr int STAGES = 3 * STAGE * ESZ <= 110 * 1024 ? 3 : 2;
  static constexpr size_t RING = (size_t)STAGES * STAGE * ESZ;
  // fp32 only: the block's queries [HT][RS] and each warp's probabilities
  static constexpr size_t EXTRA = MMA ? 0 : sizeof(float) * (HT * RS + NW * KW * HT);
  static constexpr size_t SMEM = RING + EXTRA;
  static_assert(BN % KW == 0 && BN / KW <= NW, "a tile is at most one 16-key slice per warp");
  static_assert(sizeof(float) * NW * HT * (DHP + 2) <= RING, "the merge reuses the ring");
};

// The addressing policy of a key row: row b's keys are cache[b, kvh].
template <typename T> struct DenseRows {
  const T* base;  // cache + (b * KV + kvh) * S * Dh
  int Dh;
  __device__ __forceinline__ const T* at(int p) const { return base + (size_t)p * Dh; }
};

// Rows p0 .. p0 + n - 1 of K and V into a stage's rows 0 .. n - 1; rows
// n .. BN - 1 (past the live range) are zeros, so no stale value meets a
// zero probability. Columns [Dh, DHP) were zeroed once at the start.
template <typename T, int DHP, typename Rows>
__device__ __forceinline__ void stage_tile(T* ks, T* vs, const Rows& kr, const Rows& vr,
                                           int p0, int n, int Dh, bool vec, int tid) {
  using L = Plan<T, DHP>;
  if (vec) {
    constexpr int PER = 16 / sizeof(T);  // elements per 16-byte chunk
    const int cpr = Dh / PER;
    for (int c = tid; c < L::BN * cpr; c += NT) {
      const int r = c / cpr, j = (c - r * cpr) * PER;
      T* dk = ks + r * L::RS + j;
      T* dv = vs + r * L::RS + j;
      if (r < n) {
        cp_async16(dk, kr.at(p0 + r) + j);
        cp_async16(dv, vr.at(p0 + r) + j);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {  // a row that is no multiple of 16 bytes: plain element copies
    const T zero = from_f32<T>(0.f);
    for (int i = tid; i < L::BN * Dh; i += NT) {
      const int r = i / Dh, d = i - r * Dh;
      ks[r * L::RS + d] = r < n ? kr.at(p0 + r)[d] : zero;
      vs[r * L::RS + d] = r < n ? vr.at(p0 + r)[d] : zero;
    }
  }
}

// One block: (split, KV head x head tile, row). Lane (gq = lane / 4,
// tg = lane % 4) of warp w holds the accumulator layout of m16n8k16:
// scores s[0..3] of keys (w*16 + gq, w*16 + gq + 8) x heads (2tg, 2tg + 1)
// in the order (gq, 2tg), (gq, 2tg+1), (gq+8, 2tg), (gq+8, 2tg+1), and
// output acc[mt][0..3] of dims (16mt + gq, 16mt + gq + 8) x the same heads.
template <typename T, int DHP>
__global__ void __launch_bounds__(NT) slots_split(Args a) {
  using L = Plan<T, DHP>;
  constexpr int BN = L::BN, RS = L::RS, ST = L::STAGES, MT = DHP / 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int group = a.H / a.KV;
  const int n_ht = (group + HT - 1) / HT;
  const int kvh = blockIdx.y / n_ht;
  const int h0 = (blockIdx.y - kvh * n_ht) * HT;  // first head of the tile in the group
  const int nh = min(HT, group - h0);
  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int Dh = a.Dh;

  // the row's live range, and this split's even share of it in tiles
  const int pos = a.pos[b];
  const int hi = pos >= a.S ? a.S : pos + 1;  // no overflow at a frozen slot
  const int lo = a.win > 0 ? max(pos - a.win + 1, 0) : 0;
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const int t0 = (int)((long long)split * n_tiles / a.n_split);
  const int t1 = (int)((long long)(split + 1) * n_tiles / a.n_split);

  const size_t part = ((size_t)b * a.KV + kvh) * a.n_split + split;
  float* ws_acc = a.ws + part * group * Dh;
  float* ws_ml = a.ws + (size_t)a.B * a.KV * a.n_split * group * Dh + part * group * 2;

  if (t0 >= t1) {  // an empty share: the neutral partial
    for (int i = tid; i < nh * Dh; i += NT) ws_acc[(size_t)h0 * Dh + i] = 0.f;
    if (tid < nh) {
      ws_ml[2 * (h0 + tid)] = NEG;
      ws_ml[2 * (h0 + tid) + 1] = 0.f;
    }
    return;
  }

  const size_t kv_off = ((size_t)b * a.KV + kvh) * a.S * Dh;
  const DenseRows<T> krows{static_cast<const T*>(a.k) + kv_off, Dh};
  const DenseRows<T> vrows{static_cast<const T*>(a.v) + kv_off, Dh};
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kvh * group + h0) * Dh;

  // the padding columns [Dh, DHP) of every staged row are zeros, once
  if (Dh < DHP) {
    const int pad = DHP - Dh;
    for (int i = tid; i < ST * 2 * BN * pad; i += NT) {
      const int r = i / pad;
      ring[r * RS + Dh + (i - r * pad)] = from_f32<T>(0.f);
    }
  }

  const int nt = t1 - t0;
  auto issue = [&](int t) {  // tile t of the share into its stage, then commit
    if (t < nt) {
      T* ks = ring + (t % ST) * L::STAGE;
      const int p0 = lo + (t0 + t) * BN;
      stage_tile<T, DHP>(ks, ks + BN * RS, krows, vrows, p0, min(BN, hi - p0), Dh,
                         a.vec != 0, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);

  // the block's queries, loaded while the first tiles' copies fly: Q^T
  // fragments in registers (tensor cores), or [HT][RS] fp32 in shared
  // memory; heads past the group are zeros
  uint32_t qf[L::MMA ? MT : 1][2];
  float* qs = reinterpret_cast<float*>(smem_raw + L::RING);
  float* pw = qs + HT * RS + w * KW * HT;  // this warp's probabilities [KW][HT]
  if constexpr (L::MMA) {
    const bool hq = gq < nh;
    auto qv = [&](int d) { return hq && d < Dh ? qb[(size_t)gq * Dh + d] : from_f32<T>(0.f); };
#pragma unroll
    for (int kt = 0; kt < MT; ++kt) {
      const int d = 16 * kt + 2 * tg;
      qf[kt][0] = pack2(qv(d), qv(d + 1));
      qf[kt][1] = pack2(qv(d + 8), qv(d + 9));
    }
  } else {
    for (int i = tid; i < HT * DHP; i += NT) {
      const int h = i / DHP, d = i - h * DHP;
      qs[h * RS + d] = h < nh && d < Dh ? to_f32(qb[(size_t)h * Dh + d]) : 0.f;
    }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  const int kr0 = w * KW;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's have, and tile t - 1 is consumed
    issue(t + ST - 1);        // into the stage tile t - 1 used
    const T* ks = ring + (t % ST) * L::STAGE;
    const T* vs = ks + BN * RS;
    const int n = min(BN, hi - (lo + (t0 + t) * BN));  // live keys of the tile
    if (kr0 >= n) continue;  // warp-uniform: no live key in this warp's slice

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (L::MMA) {
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        uint32_t ka[4];
        ldsm_x4(ka, ks + (kr0 + (lane & 15)) * RS + 16 * kt + (lane >> 4) * 8);
        mma16816<T>(s, ka, qf[kt]);
      }
    } else {
      const float* k0 = reinterpret_cast<const float*>(ks) + (kr0 + gq) * RS;
      const float* k1 = k0 + 8 * RS;
      const float* qa = qs + 2 * tg * RS;
      const float* qc = qa + RS;
#pragma unroll 4
      for (int c = 0; c < DHP; c += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(k0 + c);
        const float4 x1 = *reinterpret_cast<const float4*>(k1 + c);
        const float4 y0 = *reinterpret_cast<const float4*>(qa + c);
        const float4 y1 = *reinterpret_cast<const float4*>(qc + c);
        s[0] = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z, fmaf(x0.w, y0.w, s[0]))));
        s[1] = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z, fmaf(x0.w, y1.w, s[1]))));
        s[2] = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z, fmaf(x1.w, y0.w, s[2]))));
        s[3] = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z, fmaf(x1.w, y1.w, s[3]))));
      }
    }

    // scale, mask the keys past the live range, online softmax (fp32)
    const bool v0 = kr0 + gq < n, v1 = kr0 + gq + 8 < n;
    const float x0 = v0 ? s[0] * a.scale : NEG, x1 = v0 ? s[1] * a.scale : NEG;
    const float x2 = v1 ? s[2] * a.scale : NEG, x3 = v1 ? s[3] * a.scale : NEG;
    float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over the 8 key lanes of a head
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = expf(m[0] - mn0), al1 = expf(m[1] - mn1);
    const float p0 = v0 ? expf(x0 - mn0) : 0.f, p1 = v0 ? expf(x1 - mn1) : 0.f;
    const float p2 = v1 ? expf(x2 - mn0) : 0.f, p3 = v1 ? expf(x3 - mn1) : 0.f;
    l[0] = l[0] * al0 + (p0 + p2);  // this lane's keys; summed over lanes at the end
    l[1] = l[1] * al1 + (p1 + p3);
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
    }

    // acc += V^T P^T
    if constexpr (L::MMA) {
      // [key][head] 8x8 blocks of P, transposed into the B layout [head][key]
      const uint32_t pb[2] = {movmatrix_trans(pack_f32<T>(p0, p1)),
                              movmatrix_trans(pack_f32<T>(p2, p3))};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t va[4];
        ldsm_x4_trans(va, vs + (kr0 + (lane & 7) + ((lane >> 4) << 3)) * RS + 16 * mt +
                              ((lane >> 3) & 1) * 8);
        mma16816<T>(acc[mt], va, pb);
      }
    } else {
      pw[gq * HT + 2 * tg] = p0;
      pw[gq * HT + 2 * tg + 1] = p1;
      pw[(gq + 8) * HT + 2 * tg] = p2;
      pw[(gq + 8) * HT + 2 * tg + 1] = p3;
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs) + kr0 * RS;
#pragma unroll 4
      for (int r = 0; r < KW; ++r) {
        const float2 pp = *reinterpret_cast<const float2*>(pw + r * HT + 2 * tg);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float va = vf[r * RS + 16 * mt + gq];
          const float vb = vf[r * RS + 16 * mt + gq + 8];
          acc[mt][0] = fmaf(pp.x, va, acc[mt][0]);
          acc[mt][1] = fmaf(pp.y, va, acc[mt][1]);
          acc[mt][2] = fmaf(pp.x, vb, acc[mt][2]);
          acc[mt][3] = fmaf(pp.y, vb, acc[mt][3]);
        }
      }
      __syncwarp();  // the next tile's probabilities overwrite pw
    }
  }

  // the block's partial: the four warps merged in order through the ring
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  __syncthreads();  // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(smem_raw);  // [NW][HT]
  float* wl = wm + NW * HT;                        // [NW][HT]
  float* wa = wl + NW * HT;                        // [NW][HT][DHP]
  if (gq == 0) {
    wm[w * HT + 2 * tg] = m[0];
    wm[w * HT + 2 * tg + 1] = m[1];
    wl[w * HT + 2 * tg] = l[0];
    wl[w * HT + 2 * tg + 1] = l[1];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float* o = wa + (w * HT + 2 * tg) * DHP + 16 * mt + gq;
    o[0] = acc[mt][0];
    o[DHP] = acc[mt][1];
    o[8] = acc[mt][2];
    o[DHP + 8] = acc[mt][3];
  }
  __syncthreads();
  for (int i = tid; i < nh * Dh; i += NT) {
    const int h = i / Dh, d = i - h * Dh;
    float mx = NEG;
#pragma unroll
    for (int v = 0; v < NW; ++v) mx = fmaxf(mx, wm[v * HT + h]);
    float sum = 0.f, lsum = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float e = expf(wm[v * HT + h] - mx);
      sum += wa[(v * HT + h) * DHP + d] * e;
      lsum += wl[v * HT + h] * e;
    }
    ws_acc[(size_t)(h0 + h) * Dh + d] = sum;
    if (d == 0) {
      ws_ml[2 * (h0 + h)] = mx;
      ws_ml[2 * (h0 + h) + 1] = lsum;
    }
  }
}

// A fixed-order reduction over the block: xor shuffles in each warp, then
// the warps' results in index order; every thread returns the same value.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int v = 1; v < NW; ++v) r = MAX ? fmaxf(r, red[v]) : r + red[v];
  __syncthreads();  // red is reused
  return r;
}

constexpr int CB = 8;  // splits whose loads one combine thread issues together

// The splits merged with the log-sum-exp rescale, one block per (row, KV
// head, query head): the splits' max M and sum L = sum_s l_s e_s, e_s =
// exp(m_s - M), by fixed-order reductions; then out[d] = sum_s acc_s[d]
// e_s / L, one thread per element summing the splits in index order
// 0 .. n_split - 1, CB loads issued together. A row with no live key
// (every l = 0) writes zeros. Shared memory: e [n_split], then NW floats.
template <typename T>
__global__ void __launch_bounds__(NT) slots_combine(Args a) {
  extern __shared__ float csm[];
  const int group = a.H / a.KV;
  const int n = a.n_split, Dh = a.Dh, tid = threadIdx.x;
  const int bk = blockIdx.x / group, h = blockIdx.x - bk * group;  // bk = b * KV + kvh
  float* e = csm;
  float* red = csm + n;
  const size_t first = (size_t)bk * n * group + h;  // split 0's partial of this head
  const float* ml = a.ws + (size_t)a.B * a.KV * n * group * Dh + 2 * first;
  const float* acc = a.ws + first * Dh;
  const size_t ml_step = 2 * (size_t)group, acc_step = (size_t)group * Dh;

  float mx = NEG;
  for (int s = tid; s < n; s += NT) mx = fmaxf(mx, ml[s * ml_step]);
  mx = block_reduce<true>(mx, red);
  float lsum = 0.f;
  for (int s = tid; s < n; s += NT) {
    const float w = expf(ml[s * ml_step] - mx);
    e[s] = w;
    lsum += ml[s * ml_step + 1] * w;
  }
  lsum = block_reduce<false>(lsum, red);  // its barriers publish e

  T* out = static_cast<T*>(a.out) + ((size_t)bk * group + h) * Dh;
  for (int d = tid; d < Dh; d += NT) {
    float sum = 0.f;
    for (int s0 = 0; s0 < n; s0 += CB) {
      float x[CB];
#pragma unroll
      for (int u = 0; u < CB; ++u) x[u] = s0 + u < n ? acc[(s0 + u) * acc_step + d] : 0.f;
#pragma unroll
      for (int u = 0; u < CB; ++u)
        if (s0 + u < n) sum = fmaf(x[u], e[s0 + u], sum);
    }
    out[d] = from_f32<T>(lsum == 0.f ? 0.f : sum / lsum);
  }
}

template <typename T, int DHP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Plan<T, DHP>;
  auto kernel = slots_split<T, DHP>;
  // the shared-memory opt-in, once per device for this instance
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev].store(true, std::memory_order_release);
  }
  const int n_ht = (a.H / a.KV + HT - 1) / HT;
  const dim3 grid(a.n_split, a.KV * n_ht, a.B);
  kernel<<<grid, NT, L::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slots_combine<T><<<a.B * a.H, NT, sizeof(float) * (a.n_split + NW), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(const Args& a, cudaStream_t stream) {
  if (a.Dh <= 64) return launch<T, 64>(a, stream);
  if (a.Dh <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

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
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || Dh <= 0 || Dh > 256 ||
      n_split <= 0 || n_split > MAX_SPLITS || ws == nullptr || pos == nullptr)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  const int vec = (Dh * esize) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const Args a{q, k, v, out, ws, pos, B, H, KV, S, Dh, win, n_split, vec, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)by_dim<float>(a, st);
    case 1: return (int)by_dim<__nv_bfloat16>(a, st);
    case 2: return (int)by_dim<__half>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
