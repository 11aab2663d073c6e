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
// What the design does about it:
//   * One launch, no workspace, nothing read back to the host. A block
//     owns 64 folded query rows (row = t * group + g, as the TPU kernel
//     folds the GQA group, so each K/V tile serves every head that shares
//     it) of one (batch row, KV head): four warps of 16 rows each. When
//     those blocks would not fill the card (the solo chunks give 32 or 64
//     of them on 132 SMs) and the chunk's live range is long enough, the
//     host's plan (ops/flash_attention.py `flash_plan`) makes each a
//     thread-block cluster of `cluster` ranks (2, 4 or 8) that split the
//     live key range in even shares of tiles, two or more each: a
//     shorter share measured slower than no split, the merge below
//     costing more than it saves.
//     Each rank pushes its fp32 partial (m, l, acc) of every row to the
//     row's owner rank (row % cluster) by st.async onto that rank's
//     mbarrier, behind one relaxed cluster barrier after the walk; the
//     owner merges the ranks in order 0, 1, ... with the log-sum-exp
//     rescale and writes the output. A cluster of one (enough blocks
//     without a split, as at T = S = 2048) writes from its registers. No
//     atomics: repeats are bit-equal, and a call can be captured in a CUDA
//     graph.
//   * Only live tiles are walked: [first_live, needed) from the causal
//     frontier, the window start and valid_start, as the TPU kernel's
//     grid skips them; the per-element mask runs on a warp's edge tiles
//     only, and a warp skips a tile none of its rows can see.
//   * K/V tiles of BN keys stay in the cache's dtype and go through a ring
//     of 2 or 3 shared-memory stages by 16-byte cp.async.cg copies,
//     neighbouring threads on neighbouring addresses (element copies
//     where a row is no multiple of 16 bytes); rows are padded by 16
//     bytes so that ldmatrix is free of bank conflicts. The next tiles'
//     copies fly while the block computes on this one.
//   * bf16 / fp16: FlashAttention-2 on the tensor cores. S = Q K^T by
//     mma.sync.m16n8k16 with the warp's 16 rows as M: Q's fragments are
//     held in registers for the whole walk (from shared memory at Dh 256,
//     where registers run out), K's come from shared memory by ldmatrix.
//     The scores are scaled in fp32 after the product (more exact than
//     the TPU kernel's pre-scaled q, and equal to it for a power-of-two
//     scale). The softmax runs in base 2 (scores times log2 e, then
//     exp2f, one MUFU instruction), the mask compares each key with its
//     row's live range [lo, hi], and the soft cap sits out of line: the
//     unrolled tile loop stays short, which measured faster than expf and
//     an inline tanhf. The fp32 accumulator of S becomes P's A fragment
//     in registers, rounded to bf16 / fp16 as FlashAttention rounds P
//     (the sum l takes the fp32 values); O += P V with V by
//     ldmatrix.trans.
//   * fp32: the same tiles, ring and lane layout on CUDA-core FMAs (TF32
//     would not hold fp32's tolerance); P goes through a per-warp
//     shared-memory buffer for the P V product.
//   * int8 cache: the ring carries the int8 rows and their fp32 scales
//     (cp.async, half the bytes of a bf16 tile); a shared-memory pass
//     dequantizes q8 * s in fp32 and rounds it to the product's type.
//     For bf16 / fp16 q that rounding point differs from the JAX
//     prologue, which keeps the fp32 tile: each K/V element then carries
//     a relative error <= 2^-9 (bf16) or 2^-12 (fp16), which moves a
//     score by <= 2^-9 of |q||k| and the output by far less than the
//     2e-2 tolerance that bf16 outputs are held to. fp32 q keeps the fp32
//     tile: the same products as the JAX kernel.
//   * The key-row addressing is one small policy (`DenseCache`:
//     cache[b, kvh, p]); the paged pool's ragged kernel can take the same
//     walk with a block-table policy.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block: four warps
constexpr int NW = NT / 32;
constexpr int BM = 16 * NW;  // folded query rows per block: 16 per warp
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -0.7f * FLT_MAX;  // mask fill (the TPU kernel's _NEG)
constexpr float LOG2E = 1.4426950408889634f;  // the softmax runs in base 2: exp2f

// cap * tanh(x / cap), out of line: its code stays off the unrolled score loop
__device__ __noinline__ float soft_cap(float x, float cap) { return cap * tanhf(x / cap); }

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
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

// d += a . b on the tensor cores: a 16x16 (row), b 16x8 (col), d 16x8 fp32
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 cache: [B, KV, S]; else null
  const float* v_scale;
  void* out;
  const int* valid_start;  // [B] or null
  const int* win_dyn;      // one int32 or null
  int B, T, H, KV, S, Dh, pos, win_static, cluster;
  int vec_q;   // q rows are 16-byte multiples on 16-byte addresses
  int vec_kv;  // so are the cache rows
  float scale, softcap;
};

// The shared-memory plan of one instance (ops/flash_attention.py
// `flash_plan` mirrors BN and STAGES; the entry point checks that they
// agree). T: q's type; KT: the cache's (T, or int8_t); DHP: the head dim
// padded to 64, 128 or 256. RS / KRS: a staged row's stride in elements
// of T / KT, DHP plus 16 bytes. BN: keys per tile, 32 where a 64-key
// tile's row would pass 512 bytes (so the fp32 and Dh 256 tiles fit
// twice); STAGES: tiles in the ring.
template <typename T, typename KT, int DHP> struct Plan {
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  static constexpr bool QREG = MMA && DHP <= 128;  // Q's fragments in registers
  static constexpr int ESZ = sizeof(T);
  static constexpr int RS = DHP + 16 / ESZ;
  static constexpr int KRS = DHP + 16 / (int)sizeof(KT);
  static constexpr int BN = ESZ * DHP >= 512 ? 32 : 64;
  static constexpr int PS = BN + 4;  // fp32: a warp's probabilities, row stride
  static constexpr size_t ROWS = (size_t)BN * KRS * sizeof(KT);  // K or V of a stage
  static constexpr size_t STAGE = 2 * ROWS + (INT8 ? 2 * BN * sizeof(float) : 0);
  static constexpr int STAGES = 3 * STAGE <= 64 * 1024 ? 3 : 2;
  static constexpr size_t RING = STAGES * STAGE;
  static constexpr size_t QS = (size_t)BM * RS * ESZ;             // the block's queries
  static constexpr size_t DEQ = INT8 ? 2 * (size_t)BN * RS * ESZ : 0;  // a dequantized tile
  static constexpr size_t PW = MMA ? 0 : sizeof(float) * NW * 16 * PS;
  static constexpr size_t WALK = RING + QS + DEQ + PW;
  static constexpr int DP = DHP + 4;  // a received row: acc [DHP], m, l, 2 pad
  static constexpr size_t RECV = sizeof(float) * BM * DP;  // aliases the walk's buffers
  static constexpr size_t BAR = ((WALK > RECV ? WALK : RECV) + 15) / 16 * 16;
  static constexpr size_t SMEM = BAR + 16;
  static_assert(STAGE % 16 == 0 && QS % 16 == 0 && DEQ % 16 == 0, "16-byte regions");
  static_assert(SMEM <= 227 * 1024, "fits one SM's shared memory");
};

// The addressing policy of a key row: row b's keys are cache[b, kvh], its
// scales scale[b, kvh] (int8 only).
template <typename KT> struct DenseCache {
  const KT* base;      // cache + (b * KV + kvh) * S * Dh
  const float* scale;  // scales + (b * KV + kvh) * S, or null
  int Dh;
  __device__ __forceinline__ const KT* at(int p) const { return base + (size_t)p * Dh; }
  __device__ __forceinline__ const float* scale_at(int p) const { return scale + p; }
};

// Keys p0 .. p0 + n - 1 of K and V (and their scales) into a stage's rows
// 0 .. n - 1; rows n .. BN - 1 (past S) are zeros, so no stale value meets
// a zero probability. Columns [Dh, DHP) were zeroed once at the start.
template <typename T, typename KT, int DHP, typename Rows>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Rows& kr, const Rows& vr,
                                           int p0, int n, int Dh, bool vec, int tid) {
  using L = Plan<T, KT, DHP>;
  KT* ks = reinterpret_cast<KT*>(st);
  KT* vs = reinterpret_cast<KT*>(st + L::ROWS);
  if (vec) {
    constexpr int PER = 16 / sizeof(KT);  // elements per 16-byte chunk
    const int cpr = Dh / PER;
    for (int c = tid; c < L::BN * cpr; c += NT) {
      const int r = c / cpr, j = (c - r * cpr) * PER;
      KT* dk = ks + r * L::KRS + j;
      KT* dv = vs + r * L::KRS + j;
      if (r < n) {
        cp_async16(dk, kr.at(p0 + r) + j);
        cp_async16(dv, vr.at(p0 + r) + j);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {  // a row that is no multiple of 16 bytes: plain element copies
    for (int i = tid; i < L::BN * Dh; i += NT) {
      const int r = i / Dh, d = i - r * Dh;
      ks[r * L::KRS + d] = r < n ? kr.at(p0 + r)[d] : KT{};
      vs[r * L::KRS + d] = r < n ? vr.at(p0 + r)[d] : KT{};
    }
  }
  if constexpr (L::INT8) {
    float* sc = reinterpret_cast<float*>(st + 2 * L::ROWS);  // K's scales, then V's
    for (int i = tid; i < 2 * L::BN; i += NT) {
      const int r = i % L::BN;
      const Rows& rows = i < L::BN ? kr : vr;
      if (r < n)
        cp_async4(sc + i, rows.scale_at(p0 + r));
      else
        sc[i] = 0.f;
    }
  }
}

// One block: rank `rank` of the cluster of (query tile blockIdx.x / cluster,
// KV head blockIdx.y, row blockIdx.z). Lane (gq = lane / 4, tg = lane % 4)
// of warp w holds the accumulator layout of m16n8k16 for the warp's rows
// r0 = 16w + gq and r1 = r0 + 8: scores s[j][0..3] of (r0, key 8j + 2tg),
// (r0, 8j + 2tg + 1), (r1, 8j + 2tg), (r1, 8j + 2tg + 1), and the output
// acc[j][0..3] of the same rows at dims 8j + 2tg, 8j + 2tg + 1.
template <typename T, typename KT, int DHP>
__global__ void __launch_bounds__(NT) flash_fwd(Args a) {
  using L = Plan<T, KT, DHP>;
  constexpr int BN = L::BN, RS = L::RS, KRS = L::KRS, ST = L::STAGES;
  constexpr int NJ = BN / 8, NO = DHP / 8, KD = DHP / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  T* qs = reinterpret_cast<T*>(smem + L::RING);
  T* deq = reinterpret_cast<T*>(smem + L::RING + L::QS);  // int8: K then V, [BN][RS] each
  float* pw = reinterpret_cast<float*>(smem + L::RING + L::QS + L::DEQ);  // fp32: [NW][16][PS]
  float* recv = reinterpret_cast<float*>(smem);  // after the walk: [cluster][BM / cluster][DP]
  const uint32_t mbar = smem_addr(smem + L::BAR);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int cs = a.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KV;
  const int rows_total = a.T * group;
  const int row0 = (blockIdx.x / cs) * BM;
  const int Dh = a.Dh, S = a.S, pos = a.pos;
  const int win = a.win_dyn != nullptr ? *a.win_dyn : a.win_static;
  const int vfrom = a.valid_start != nullptr ? a.valid_start[b] : 0;

  // the merge's mbarrier expects every rank's partial of this rank's rows
  // (BM / cs rows from each of cs ranks: BM rows of DHP floats and (m, l))
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
            mbar),
        "r"((int)(BM * (DHP * sizeof(float) + 8)))
        : "memory");
  }

  // the live tiles of this query tile: keys up to its last query's
  // position; with a window, from its first query's window start; never
  // wholly inside the row's left padding. This rank's even share of them.
  const int t_lo = row0 / group;
  const int t_hi = min((row0 + BM - 1) / group, a.T - 1);
  const int needed = min((pos + t_hi + 1 + BN - 1) / BN, (S + BN - 1) / BN);
  int first = win > 0 ? max(pos + t_lo - win + 1, 0) / BN : 0;
  first = max(first, vfrom / BN);
  const int n_live = max(needed - first, 0);
  const int t0 = first + rank * n_live / cs;
  const int nt = first + (rank + 1) * n_live / cs - t0;

  const size_t kv_row = (size_t)b * a.KV + kvh;
  const DenseCache<KT> krows{static_cast<const KT*>(a.k) + kv_row * S * Dh,
                             a.k_scale != nullptr ? a.k_scale + kv_row * S : nullptr, Dh};
  const DenseCache<KT> vrows{static_cast<const KT*>(a.v) + kv_row * S * Dh,
                             a.v_scale != nullptr ? a.v_scale + kv_row * S : nullptr, Dh};

  // the padding columns [Dh, DHP) of every staged row are zeros, once
  if (Dh < DHP) {
    const int pad = DHP - Dh;
    for (int i = tid; i < ST * 2 * BN * pad; i += NT) {
      const int r = i / pad, s = r / (2 * BN), rr = r - s * 2 * BN;
      KT* row = reinterpret_cast<KT*>(ring + s * L::STAGE) + rr * KRS;  // K rows, then V rows
      row[Dh + (i - r * pad)] = KT{};
    }
  }

  // the block's query rows (row r = t * group + g), zeros past the chunk
  {
    const T* qb = static_cast<const T*>(a.q) + ((size_t)b * a.T * a.H + (size_t)kvh * group) * Dh;
    auto qrow = [&](int r) {  // folded row r's Dh elements in q
      const int t = r / group;
      return qb + ((size_t)t * a.H + (r - t * group)) * Dh;
    };
    if (a.vec_q) {
      constexpr int PER = 16 / sizeof(T);
      const int cpr = Dh / PER;
      for (int c = tid; c < BM * cpr; c += NT) {
        const int r = c / cpr, j = (c - r * cpr) * PER;
        T* dst = qs + r * RS + j;
        if (row0 + r < rows_total)
          cp_async16(dst, qrow(row0 + r) + j);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int i = tid; i < BM * Dh; i += NT) {
        const int r = i / Dh, d = i - r * Dh;
        qs[r * RS + d] = row0 + r < rows_total ? qrow(row0 + r)[d] : from_f32<T>(0.f);
      }
    }
    for (int i = tid; i < BM * (DHP - Dh); i += NT) {
      const int r = i / (DHP - Dh);
      qs[r * RS + Dh + (i - r * (DHP - Dh))] = from_f32<T>(0.f);
    }
    cp_async_commit();
  }

  auto issue = [&](int t) {  // tile t of the share into its stage, then commit
    if (t < nt) {
      const int p0 = (t0 + t) * BN;
      stage_tile<T, KT, DHP>(ring + (t % ST) * L::STAGE, krows, vrows, p0, min(BN, S - p0),
                             Dh, a.vec_kv != 0, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);

  // this warp's rows and what they can see
  const int wr0 = row0 + 16 * w;
  const bool wvalid = wr0 < rows_total;
  const bool wrows_full = wr0 + 15 < rows_total;
  const int wt_lo = wr0 / group;
  const int wt_hi = min((wr0 + 15) / group, a.T - 1);
  // the live keys [lo, hi] of this lane's rows r0 = wr0 + gq and r1 = r0 + 8
  // (empty past the chunk): causal, valid_start and the window
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h, qp = pos + r / group;
    hi[h] = r < rows_total ? qp : -1;
    lo[h] = max(vfrom, win > 0 ? qp - win + 1 : 0);
  }

  cp_async_wait<ST - 1>();  // the queries have landed
  __syncthreads();
  uint32_t qf[L::QREG ? KD : 1][4];
  if constexpr (L::QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm_x4(qf[kd], qs + (16 * w + (lane & 15)) * RS + 16 * kd + (lane >> 4) * 8);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's have, and tile t - 1 is consumed
    issue(t + ST - 1);        // into the stage tile t - 1 used
    const unsigned char* stg = ring + (t % ST) * L::STAGE;
    const T* ks;
    const T* vs;
    if constexpr (L::INT8) {  // dequantize: q8 * s in fp32, rounded to T
      const int8_t* k8 = reinterpret_cast<const int8_t*>(stg);
      const int8_t* v8 = reinterpret_cast<const int8_t*>(stg + L::ROWS);
      const float* sc = reinterpret_cast<const float*>(stg + 2 * L::ROWS);
      constexpr int C4 = DHP / 4;
      for (int i = tid; i < 2 * BN * C4; i += NT) {
        const int r = i / C4, c = (i - r * C4) * 4;  // r < BN: K, else V
        const int8_t* src = (r < BN ? k8 + r * KRS : v8 + (r - BN) * KRS) + c;
        const char4 x = *reinterpret_cast<const char4*>(src);
        const float s = sc[r];
        T* dst = deq + r * RS + c;
        dst[0] = from_f32<T>((float)x.x * s);
        dst[1] = from_f32<T>((float)x.y * s);
        dst[2] = from_f32<T>((float)x.z * s);
        dst[3] = from_f32<T>((float)x.w * s);
      }
      __syncthreads();
      ks = deq;
      vs = deq + BN * RS;
    } else {
      ks = reinterpret_cast<const T*>(stg);
      vs = reinterpret_cast<const T*>(stg + L::ROWS);
    }

    const int kv0 = (t0 + t) * BN;
    // warp-uniform: no row of this warp sees a key of the tile
    if (!wvalid || kv0 > pos + wt_hi || (win > 0 && kv0 + BN - 1 <= pos + wt_lo - win))
      continue;
    // every key of the tile live for every row of this warp: no mask
    const bool full = wrows_full && kv0 + BN - 1 <= pos + wt_lo && kv0 >= vfrom &&
                      kv0 + BN <= S && (win <= 0 || kv0 > pos + wt_hi - win);

    // s = q . k
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (L::MMA) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4];
        if constexpr (L::QREG) {
          qa[0] = qf[kd][0];
          qa[1] = qf[kd][1];
          qa[2] = qf[kd][2];
          qa[3] = qf[kd][3];
        } else {
          ldsm_x4(qa, qs + (16 * w + (lane & 15)) * RS + 16 * kd + (lane >> 4) * 8);
        }
#pragma unroll
        for (int p = 0; p < NJ / 2; ++p) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * RS + 16 * kd +
                          ((lane >> 3) & 1) * 8);
          mma16816<T>(s[2 * p], qa, kb[0], kb[1]);
          mma16816<T>(s[2 * p + 1], qa, kb[2], kb[3]);
        }
      }
    } else {
      const float* qa0 = reinterpret_cast<const float*>(qs) + (16 * w + gq) * RS;
      const float* qa1 = qa0 + 8 * RS;
      const float* kf = reinterpret_cast<const float*>(ks) + 2 * tg * RS;
#pragma unroll 2
      for (int c = 0; c < DHP; c += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(qa0 + c);
        const float4 x1 = *reinterpret_cast<const float4*>(qa1 + c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 y0 = *reinterpret_cast<const float4*>(kf + 8 * j * RS + c);
          const float4 y1 = *reinterpret_cast<const float4*>(kf + (8 * j + 1) * RS + c);
          s[j][0] = fmaf(x0.x, y0.x, fmaf(x0.y, y0.y, fmaf(x0.z, y0.z, fmaf(x0.w, y0.w, s[j][0]))));
          s[j][1] = fmaf(x0.x, y1.x, fmaf(x0.y, y1.y, fmaf(x0.z, y1.z, fmaf(x0.w, y1.w, s[j][1]))));
          s[j][2] = fmaf(x1.x, y0.x, fmaf(x1.y, y0.y, fmaf(x1.z, y0.z, fmaf(x1.w, y0.w, s[j][2]))));
          s[j][3] = fmaf(x1.x, y1.x, fmaf(x1.y, y1.y, fmaf(x1.z, y1.z, fmaf(x1.w, y1.w, s[j][3]))));
        }
      }
    }

    // scale, softcap, mask (edge tiles), online softmax in fp32, in base 2
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (a.softcap > 0.f) x = soft_cap(x, a.softcap);
        x *= LOG2E;
        if (!full) {
          const int kp = kv0 + 8 * j + 2 * tg + (e & 1);
          x = kp >= lo[e >> 1] && kp <= hi[e >> 1] ? x : NEG;
        }
        s[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // over the quad that shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = exp2f(m[0] - mn0), al1 = exp2f(m[1] - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = s[j][0] == NEG ? 0.f : exp2f(s[j][0] - mn0);
      s[j][1] = s[j][1] == NEG ? 0.f : exp2f(s[j][1] - mn0);
      s[j][2] = s[j][2] == NEG ? 0.f : exp2f(s[j][2] - mn1);
      s[j][3] = s[j][3] == NEG ? 0.f : exp2f(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l[0] = l[0] * al0 + ls0;  // this lane's keys; summed over the quad at the end
    l[1] = l[1] * al1 + ls1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // acc += p . v
    if constexpr (L::MMA) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // the S accumulator of keys 16kk .. 16kk + 15 is P's A fragment
        const uint32_t pa[4] = {pack_f32<T>(s[2 * kk][0], s[2 * kk][1]),
                                pack_f32<T>(s[2 * kk][2], s[2 * kk][3]),
                                pack_f32<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_f32<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                                16 * n2 + (lane >> 4) * 8);
          mma16816<T>(acc[2 * n2], pa, vb[0], vb[1]);
          mma16816<T>(acc[2 * n2 + 1], pa, vb[2], vb[3]);
        }
      }
    } else {
      float* pr = pw + w * 16 * L::PS;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<float2*>(pr + gq * L::PS + 8 * j + 2 * tg) = make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(pr + (gq + 8) * L::PS + 8 * j + 2 * tg) =
            make_float2(s[j][2], s[j][3]);
      }
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs) + 2 * tg;
#pragma unroll 4
      for (int kk = 0; kk < BN; ++kk) {
        const float p0 = pr[gq * L::PS + kk], p1 = pr[(gq + 8) * L::PS + kk];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const float2 vv = *reinterpret_cast<const float2*>(vf + kk * RS + 8 * j);
          acc[j][0] = fmaf(p0, vv.x, acc[j][0]);
          acc[j][1] = fmaf(p0, vv.y, acc[j][1]);
          acc[j][2] = fmaf(p1, vv.x, acc[j][2]);
          acc[j][3] = fmaf(p1, vv.y, acc[j][3]);
        }
      }
      __syncwarp();  // the next tile's probabilities overwrite pr
    }
  }

  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.T * a.H + (size_t)kvh * group) * Dh;
  auto out_row = [&](int rg) {  // folded row rg's Dh elements in out
    const int tq = rg / group;
    return ob + ((size_t)tq * a.H + (rg - tq * group)) * Dh;
  };

  if (cs == 1) {  // one rank: each lane writes its rows; no live key -> zeros
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rg = wr0 + gq + 8 * h;
      if (rg >= rows_total) continue;
      T* o = out_row(rg);
      const float den = l[h] == 0.f ? 1.f : l[h];  // no live key: acc is 0
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int d = 8 * j + 2 * tg;
        if (d < Dh) o[d] = from_f32<T>(acc[j][2 * h] / den);
        if (d + 1 < Dh) o[d + 1] = from_f32<T>(acc[j][2 * h + 1] / den);
      }
    }
    return;
  }

  // The cluster's merge. Every rank's buffers are free once it arrives
  // (its copies have landed and its reads have returned), and its
  // mbarrier was initialised before: after the cluster wait each lane
  // pushes its rows' partial to the row's owner rank, at [this rank][row /
  // cs] there.
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  const int rpo = BM / cs;  // rows each rank owns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rb = 16 * w + gq + 8 * h;  // the row in the block
    const uint32_t dst = (uint32_t)(rb % cs);
    uint32_t raddr, rbar;
    const uint32_t laddr = smem_addr(recv + (size_t)(rank * rpo + rb / cs) * L::DP);
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(raddr) : "r"(laddr), "r"(dst));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(mbar), "r"(dst));
#pragma unroll
    for (int j = 0; j < NO; ++j)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
              raddr + (uint32_t)(sizeof(float) * (8 * j + 2 * tg))),
          "f"(acc[j][2 * h]), "f"(acc[j][2 * h + 1]), "r"(rbar)
          : "memory");
    if (tg == 0)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
              raddr + (uint32_t)(sizeof(float) * DHP)),
          "f"(m[h]), "f"(l[h]), "r"(rbar)
          : "memory");
  }
  {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(mbar)
          : "memory");
  }

  // This rank's rows: the ranks' partials merged in order 0, 1, ... with
  // the log-sum-exp rescale. A thread per row first puts each rank's
  // weight e_k = 2^(m_k - max m) beside its partial and the row's sum
  // L = sum_k l_k e_k in rank 0's slot; then out = sum_k acc_k e_k / L,
  // zeros for a row with no live key (L = 0).
  if (tid < rpo) {
    float mx = NEG;
    for (int k = 0; k < cs; ++k) mx = fmaxf(mx, recv[(k * rpo + tid) * L::DP + DHP]);
    float lsum = 0.f;
    for (int k = 0; k < cs; ++k) {
      float* part = recv + (k * rpo + tid) * L::DP;
      const float e = exp2f(part[DHP] - mx);
      part[DHP + 2] = e;
      lsum += part[DHP + 1] * e;
    }
    recv[tid * L::DP + DHP + 3] = lsum;
  }
  __syncthreads();
  for (int i = tid; i < rpo * DHP; i += NT) {
    const int li = i / DHP, d = i % DHP;
    const int rg = row0 + li * cs + rank;
    if (d >= Dh || rg >= rows_total) continue;
    float sum = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* part = recv + (k * rpo + li) * L::DP;
      sum += part[d] * part[DHP + 2];
    }
    const float lsum = recv[li * L::DP + DHP + 3];
    out_row(rg)[d] = from_f32<T>(lsum == 0.f ? 0.f : sum / lsum);
  }
}

template <typename T, typename KT, int DHP>
cudaError_t launch(const Args& a, int bn, int stages, cudaStream_t stream) {
  using L = Plan<T, KT, DHP>;
  if (bn != L::BN || stages != L::STAGES) return cudaErrorInvalidValue;  // the host's plan
  auto kernel = flash_fwd<T, KT, DHP>;
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
  const int rows = a.T * (a.H / a.KV);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + BM - 1) / BM * a.cluster, a.KV, a.B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t by_dim(const Args& a, int bn, int stages, cudaStream_t stream) {
  if (a.Dh <= 64) return launch<T, KT, 64>(a, bn, stages, stream);
  if (a.Dh <= 128) return launch<T, KT, 128>(a, bn, stages, stream);
  return launch<T, KT, 256>(a, bn, stages, stream);
}

// the cache is the query's dtype, or int8 with both scale arrays
template <typename T>
cudaError_t by_cache(const Args& a, int bn, int stages, cudaStream_t stream) {
  if (a.k_scale != nullptr) return by_dim<T, int8_t>(a, bn, stages, stream);
  return by_dim<T, T>(a, bn, stages, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

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
  if (B <= 0 || T_len <= 0 || KV <= 0 || H % KV != 0 || Dh <= 0 || Dh > 256 ||
      pos < 0 || pos + T_len > S || (k_scale == nullptr) != (v_scale == nullptr) ||
      cluster <= 0 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  const int kv_esize = k_scale != nullptr ? 1 : esize;
  Args a{q, k, v, k_scale, v_scale, out, valid_start, win_dyn, B, T_len, H, KV, S, Dh,
         pos, win_static, cluster, 0, 0, scale, softcap};
  a.vec_q = (Dh * esize) % 16 == 0 && aligned16(q);
  a.vec_kv = (Dh * kv_esize) % 16 == 0 && aligned16(k) && aligned16(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)by_cache<float>(a, bn, stages, st);
    case 1: return (int)by_cache<__nv_bfloat16>(a, bn, stages, st);
    case 2: return (int)by_cache<__half>(a, bn, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
