// The tensor-core flash walk of a block of folded query rows over their
// live keys, split over a thread-block cluster, for Hopper. Two sources of
// rows share it:
//   * `DenseChunk` (csrc/flash_attention.cu, `flash_attend`): batch row b's
//     chunk of T queries at positions pos .. pos + T - 1 over the dense
//     cache [B, KV, S, Dh], keys at positions >= valid_start[b];
//   * `PagedTable` (csrc/paged_attention.cu, `ragged_paged_attend`): query
//     tile g of tq queries, placed by meta[g] = (row, q_start, q_len, kind)
//     read on the device, over the block-paged pool [N, KV, bs, Dh]: key p
//     of table row `row` is slot p % bs of pool block table[row, p / bs]
//     (an id outside [0, N) reads block 0, the trash block); the S = MB *
//     bs keys a table row holds. Queries t >= q_len are dead and write
//     zeros; a tile with q_len = 0 (launch padding) reads no K/V.
// Query t sits at position pos + t and attends keys p <= its own and < S
// (a query at or past S attends all S), with a sliding window win > 0
// (static, or one int32 on the device) only p > pos + t - win. Scores are
// scaled after the product, soft-capped (cap * tanh(s / cap)) before the
// mask; the softmax and the accumulator are fp32; a row with no live key
// gives zeros. Output in q's dtype (fp32, bf16 or fp16), Dh <= 256. K/V
// are q's dtype, or int8 with one fp32 scale per key row.
//
// What bounds it on an H100: each live K/V row is read once per KV head
// (2 * Dh * esize bytes per key, Dh + 4 for an int8 row and its scale)
// against 4 * Dh FLOPs per query head and key. A decode query gives ~2 *
// group = 16 FLOPs per byte for tinyllama (H / KV = 8), a full tile of 8
// prompt queries ~8x that: both far below the ~295 at which the bf16
// tensor cores stop being memory-bound, so the mixed launch is bound by
// BYTES (~0.7 us at the fleet's width 128). What keeps it from that bound
// is latency: one block per (query tile, KV head) puts 64 blocks on 132
// SMs, each walking up to 16 key tiles in series. Only a long dense
// prefill chunk (T = S = 2048, ~900 FLOPs per byte) is bound by OPERATIONS.
//
// What the design does about it:
//   * A block owns BM = 64 folded query rows (row = t * group + h, as the
//     TPU kernels fold the GQA group, so each K/V tile serves every head
//     that shares it): four warps of 16. The host's plan (`flash_plan`,
//     `ragged_plan`, from the shapes alone) makes each block a cluster of
//     1, 2, 4 or 8 ranks that split the block's live key tiles [first,
//     needed) into even shares. The tiles lie on the BN-key grid from key
//     0; the edge tiles are masked key by key. A ragged tile's live range
//     is known only on the device: there `min_share` > 0 lets every rank
//     of the cluster agree, from the same meta[g], to use only as many
//     ranks as keep `min_share` tiles each (one rank: no merge at all);
//     the ranks left out only meet the cluster barrier.
//   * Each rank pushes its fp32 partial (m, l, acc) of every row to the
//     row's owner rank by st.async onto that rank's mbarrier, behind one
//     relaxed cluster barrier after the walk; the owner merges the ranks in
//     order 0, 1, ... with the log-sum-exp rescale and writes the output.
//     No atomics, no workspace, nothing read back to the host: repeats are
//     bit-equal and a call can be captured in a CUDA graph.
//   * K/V tiles of BN keys stay in the storage type and go through a ring
//     of 2 or 3 shared-memory stages by 16-byte cp.async.cg copies,
//     neighbouring threads on neighbouring addresses (element copies
//     where a row is no multiple of 16 bytes); rows are padded by 16
//     bytes so that ldmatrix is free of bank conflicts. The next tiles'
//     copies fly while the block computes on this one. Keys past the
//     block's last live key are not read.
//   * The row policy addresses a key: `DenseChunk` cache[b, kvh, p];
//     `PagedTable` through the table. A paged tile's pool block ids are
//     loaded once per pool block, one thread each, into a shared slot per
//     ring stage, a tile ahead of the copies that use them (the load flies
//     while the block computes), so a copy finds its key's row with no
//     global read; any block size works, rows that straddle a pool block
//     addressed row by row.
//   * bf16 / fp16: FlashAttention-2 on the tensor cores. S = Q K^T by
//     mma.sync.m16n8k16 with the warp's 16 rows as M: Q's fragments are
//     held in registers for the whole walk (from shared memory at Dh 256,
//     where registers run out), K's come from shared memory by ldmatrix.
//     The scores are scaled in fp32 after the product; the softmax runs in
//     base 2 (exp2f, one MUFU instruction); each lane's rows carry a live
//     range [lo, hi] that the mask compares on a warp's edge tiles only;
//     the soft cap sits out of line; a warp skips a tile none of its rows
//     can see, and a warp whose rows are all dead skips them all. The fp32
//     accumulator of S becomes P's A fragment in registers, rounded to bf16
//     / fp16 as FlashAttention rounds P (l takes the fp32 values); O += P V
//     with V by ldmatrix.trans.
//   * fp32: the same tiles, ring and lane layout on CUDA-core FMAs (TF32
//     would not hold fp32's tolerance); P goes through a per-warp
//     shared-memory buffer for the P V product.
//   * int8 rows: the ring carries the int8 rows and their fp32 scales
//     (cp.async, half the bytes of a bf16 tile); a shared-memory pass
//     dequantizes q8 * s in fp32 and rounds it to the product's type. For
//     bf16 / fp16 q that rounding point differs from the JAX prologue,
//     which keeps the fp32 tile: each K/V element then carries a relative
//     error <= 2^-9 (bf16) or 2^-12 (fp16), which moves a score by <=
//     2^-9 of |q||k| and the output by far less than the 2e-2 tolerance
//     that bf16 outputs are held to. fp32 q keeps the fp32 tile: the same
//     products as the JAX kernels.

#pragma once

#include <cooperative_groups.h>

#include "tile_ops.cuh"

namespace {
namespace fw {

namespace cg = cooperative_groups;

constexpr int BM = 16 * NW;     // folded query rows per block: 16 per warp
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

struct Args {
  const void* q;  // [B, T, H, Dh]: batch rows (dense) or query tiles (paged)
  const void* k;
  const void* v;
  const float* k_scale;  // int8 rows: one scale per key row; else null
  const float* v_scale;
  void* out;
  const int* valid_start;  // DenseChunk: [B] or null
  const int* table;        // PagedTable: [R, MB]
  const int* meta;         // PagedTable: [B, 4]
  const int* win_dyn;      // one int32 on the device overriding win_static, or null
  int B, T, H, KV, Dh;
  int S;             // keys a row holds: the cache's length, or MB * bs
  int pos;           // DenseChunk: the chunk's first position
  int N, bs, MB, R;  // PagedTable: pool blocks, keys per block, table shape
  int win_static;    // <= 0: full causal
  int cluster;       // ranks per block: 1, 2, 4 or 8
  int min_share;     // > 0: use only the ranks that keep this many live tiles each
  int vec_q;         // q rows are 16-byte multiples on 16-byte addresses
  int vec_kv;        // so are the K/V rows
  float scale, softcap;  // softcap <= 0: off
};

// The shared-memory plan of one instance (ops/flash_attention.py
// `flash_plan` and ops/paged_attention.py `ragged_plan` mirror BN and
// STAGES; the entry points check that they agree). T: q's type; KT: the
// rows' (T, or int8_t); DHP: the head dim padded to 64, 128 or 256. RS /
// KRS: a staged row's stride in elements of T / KT, DHP plus 16 bytes.
// BN: keys per tile, 32 where a 64-key tile's row would pass 512 bytes (so
// the fp32 and Dh 256 tiles fit twice); STAGES: tiles in the ring; PAGED:
// each stage's pool block ids after the walk's buffers.
template <typename T, typename KT, int DHP, bool PAGED> struct Plan {
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
  static constexpr size_t IDS = PAGED ? sizeof(int) * STAGES * BN : 0;
  static constexpr size_t WALK = RING + QS + DEQ + PW + IDS;
  static constexpr int DP = DHP + 4;  // a received row: acc [DHP], m, l, 2 pad
  static constexpr size_t RECV = sizeof(float) * BM * DP;  // aliases the walk's buffers
  static constexpr size_t BAR = ((WALK > RECV ? WALK : RECV) + 15) / 16 * 16;
  static constexpr size_t SMEM = BAR + 16;
  static_assert(STAGE % 16 == 0 && QS % 16 == 0 && DEQ % 16 == 0 && PW % 16 == 0,
                "16-byte regions");
  static_assert(SMEM <= 227 * 1024, "fits one SM's shared memory");
};

// The dense cache's rows: batch row b's chunk at a.pos, its keys
// cache[b, kvh, p] (scales scale[b, kvh, p]) from valid_start[b] on.
struct DenseChunk {
  static constexpr bool PAGED = false;
  int pos, t_live, vfrom;
  size_t first;  // the row of key 0: (b * KV + kvh) * S
  __device__ DenseChunk(const Args& a, int b, int kvh)
      : pos(a.pos), t_live(a.T), vfrom(a.valid_start != nullptr ? a.valid_start[b] : 0),
        first(((size_t)b * a.KV + kvh) * a.S) {}
  __device__ size_t row(int p, const int*, int) const { return first + p; }
};

// The block table's rows: query tile g at meta[g] = (row, q_start, q_len,
// kind), the row clamped to [0, R) and q_len to [0, T]; key p is slot p %
// bs of pool block table[row, p / bs] of KV head kvh (an id outside [0, N)
// reads block 0). `ids[j]` holds the id of the tile's pool block fb + j.
struct PagedTable {
  static constexpr bool PAGED = true;
  int pos, t_live, vfrom;
  const int* trow;
  int N, KV, kvh, bs;
  __device__ PagedTable(const Args& a, int g, int kvh_)
      : vfrom(0), N(a.N), KV(a.KV), kvh(kvh_), bs(a.bs) {
    const int* m = a.meta + 4 * (size_t)g;
    trow = a.table + (size_t)min(max(m[0], 0), a.R - 1) * a.MB;
    pos = m[1];
    t_live = min(max(m[2], 0), a.T);
  }
  __device__ int load_id(int fb, int j) const {
    const int id = trow[fb + j];
    return id >= 0 && id < N ? id : 0;
  }
  __device__ size_t row(int p, const int* ids, int fb) const {
    const int blk = p / bs;
    return ((size_t)ids[blk - fb] * KV + kvh) * bs + (p - blk * bs);
  }
};

// Keys p0 .. p0 + n - 1 of K and V (and their scales) into a stage's rows
// 0 .. n - 1; rows n .. BN - 1 are zeros, so no stale value meets a zero
// probability. Columns [Dh, DHP) were zeroed once at the start.
template <typename T, typename KT, int DHP, typename Rows>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Rows& rows, const int* ids,
                                           int p0, int n, const Args& a, int tid) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  const KT* kb = static_cast<const KT*>(a.k);
  const KT* vb = static_cast<const KT*>(a.v);
  const int Dh = a.Dh;
  const int fb = Rows::PAGED ? p0 / a.bs : 0;  // the tile's first pool block
  KT* ks = reinterpret_cast<KT*>(st);
  KT* vs = reinterpret_cast<KT*>(st + L::ROWS);
  if (a.vec_kv) {
    constexpr int PER = 16 / sizeof(KT);  // elements per 16-byte chunk
    const int cpr = Dh / PER;
    for (int c = tid; c < L::BN * cpr; c += NT) {
      const int r = c / cpr, j = (c - r * cpr) * PER;
      KT* dk = ks + r * L::KRS + j;
      KT* dv = vs + r * L::KRS + j;
      if (r < n) {
        const size_t off = rows.row(p0 + r, ids, fb) * Dh + j;
        cp_async16(dk, kb + off);
        cp_async16(dv, vb + off);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {  // a row that is no multiple of 16 bytes: plain element copies
    for (int i = tid; i < L::BN * Dh; i += NT) {
      const int r = i / Dh, d = i - r * Dh;
      const size_t off = r < n ? rows.row(p0 + r, ids, fb) * Dh + d : 0;
      ks[r * L::KRS + d] = r < n ? kb[off] : KT{};
      vs[r * L::KRS + d] = r < n ? vb[off] : KT{};
    }
  }
  if constexpr (L::INT8) {
    float* sc = reinterpret_cast<float*>(st + 2 * L::ROWS);  // K's scales, then V's
    for (int i = tid; i < 2 * L::BN; i += NT) {
      const int r = i % L::BN;
      if (r < n)
        cp_async4(sc + i, (i < L::BN ? a.k_scale : a.v_scale) + rows.row(p0 + r, ids, fb));
      else
        sc[i] = 0.f;
    }
  }
}

// The pool blocks that keys p0 .. p0 + n - 1 span: the first and the count.
__device__ __forceinline__ int tile_blocks(int p0, int n, int bs, int* fb) {
  *fb = p0 / bs;
  return (p0 + n - 1) / bs - *fb + 1;
}

// One block: rank `rank` of the cluster of (query row tile blockIdx.x /
// cluster, KV head blockIdx.y, batch row or query tile blockIdx.z). Lane
// (gq = lane / 4, tg = lane % 4) of warp w holds the accumulator layout of
// m16n8k16 for the warp's rows r0 = 16w + gq and r1 = r0 + 8: scores
// s[j][0..3] of (r0, key 8j + 2tg), (r0, 8j + 2tg + 1), (r1, 8j + 2tg),
// (r1, 8j + 2tg + 1), and the output acc[j][0..3] of the same rows at dims
// 8j + 2tg, 8j + 2tg + 1.
template <typename T, typename KT, int DHP, typename Rows>
__global__ void __launch_bounds__(NT) walk(Args a) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  constexpr int BN = L::BN, RS = L::RS, KRS = L::KRS, ST = L::STAGES;
  constexpr int NJ = BN / 8, NO = DHP / 8, KD = DHP / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  T* qs = reinterpret_cast<T*>(smem + L::RING);
  T* deq = reinterpret_cast<T*>(smem + L::RING + L::QS);  // int8: K then V, [BN][RS] each
  float* pw = reinterpret_cast<float*>(smem + L::RING + L::QS + L::DEQ);  // fp32: [NW][16][PS]
  int* ids = reinterpret_cast<int*>(smem + L::RING + L::QS + L::DEQ + L::PW);  // [ST][BN]
  float* recv = reinterpret_cast<float*>(smem);  // after the walk: [ranks][BM / ranks][DP]
  const uint32_t mbar = smem_addr(smem + L::BAR);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int cs = a.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KV;
  const int rows_total = a.T * group;
  const int row0 = (blockIdx.x / cs) * BM;
  const int Dh = a.Dh, S = a.S;
  const int win = a.win_dyn != nullptr ? *a.win_dyn : a.win_static;
  const Rows rows(a, b, kvh);
  const int pos = rows.pos, vfrom = rows.vfrom;
  const int rows_live = rows.t_live * group;  // rows past it are dead: zeros

  // the live tiles of this row tile: keys up to its last live query's
  // position (kend: one past the last live key); with a window, from its
  // first query's window start; never wholly inside the row's left
  // padding. The ranks that take a share, and this rank's even share.
  const int t_lo = row0 / group;
  const int t_hi = min((row0 + BM - 1) / group, rows.t_live - 1);
  int first = 0, needed = 0, kend = 0;
  if (t_hi >= t_lo) {
    kend = min(pos + t_hi + 1, S);
    needed = kend > 0 ? (kend + BN - 1) / BN : 0;
    first = win > 0 ? max(pos + t_lo - win + 1, 0) / BN : 0;
    first = max(first, vfrom / BN);
  }
  const int n_live = max(needed - first, 0);
  int ranks = cs;
  if (a.min_share > 0)
    while (ranks > 1 && ranks * a.min_share > n_live) ranks >>= 1;
  if (rank >= ranks) {  // no share: meet the cluster barrier if there is a merge
    if (ranks > 1) {
      asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
      asm volatile("barrier.cluster.wait;\n" ::: "memory");
    }
    return;
  }
  const int t0 = first + rank * n_live / ranks;
  const int nt = first + (rank + 1) * n_live / ranks - t0;

  // the merge's mbarrier expects every rank's partial of this rank's rows
  // (BM / ranks rows from each of the ranks: BM rows of DHP floats and (m, l))
  if (tid == 0 && ranks > 1) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
            mbar),
        "r"((int)(BM * (DHP * sizeof(float) + 8)))
        : "memory");
  }

  // the padding columns [Dh, DHP) of every staged row are zeros, once
  if (Dh < DHP) {
    const int pad = DHP - Dh;
    for (int i = tid; i < ST * 2 * BN * pad; i += NT) {
      const int r = i / pad, s = r / (2 * BN), rr = r - s * 2 * BN;
      KT* row = reinterpret_cast<KT*>(ring + s * L::STAGE) + rr * KRS;  // K rows, then V rows
      row[Dh + (i - r * pad)] = KT{};
    }
  }

  // tile t of the share: keys p0 .. p0 + n - 1, none past the last live key
  auto tile_p0 = [&](int t) { return (t0 + t) * BN; };
  auto tile_n = [&](int t) { return min(BN, kend - tile_p0(t)); };
  // the first stages' pool block ids
  if constexpr (Rows::PAGED) {
    for (int t = 0; t < ST && t < nt; ++t) {
      int fb;
      if (tid < tile_blocks(tile_p0(t), tile_n(t), a.bs, &fb))
        ids[t * BN + tid] = rows.load_id(fb, tid);
    }
    __syncthreads();
  }

  // the block's query rows (row r = t * group + h), zeros past the live rows
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
        if (row0 + r < rows_live)
          cp_async16(dst, qrow(row0 + r) + j);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int i = tid; i < BM * Dh; i += NT) {
        const int r = i / Dh, d = i - r * Dh;
        qs[r * RS + d] = row0 + r < rows_live ? qrow(row0 + r)[d] : from_f32<T>(0.f);
      }
    }
    for (int i = tid; i < BM * (DHP - Dh); i += NT) {
      const int r = i / (DHP - Dh);
      qs[r * RS + Dh + (i - r * (DHP - Dh))] = from_f32<T>(0.f);
    }
    cp_async_commit();
  }

  auto issue = [&](int t) {  // tile t of the share into its stage, then commit
    if (t < nt)
      stage_tile<T, KT, DHP>(ring + (t % ST) * L::STAGE, rows, ids + (t % ST) * BN,
                             tile_p0(t), tile_n(t), a, tid);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);

  // this warp's rows and what they can see
  const int wr0 = row0 + 16 * w;
  const bool wvalid = wr0 < rows_live;
  const bool wrows_full = wr0 + 15 < rows_live;
  const int wt_lo = wr0 / group;
  const int wt_hi = min((wr0 + 15) / group, rows.t_live - 1);
  // the live keys [lo, hi] of this lane's rows r0 = wr0 + gq and r1 = r0 + 8
  // (empty for a dead row): causal, below S, valid_start and the window
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + gq + 8 * h, qp = pos + r / group;
    hi[h] = r < rows_live ? min(qp, S - 1) : -1;
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
    // the ids of tile t + ST, loaded now and stored after this tile's
    // compute, into the slot tile t's ids used (published by the next
    // iteration's barrier, before issue(t + ST) reads them)
    int next_id = -1;
    if constexpr (Rows::PAGED) {
      if (t + ST < nt) {
        int fb;
        if (tid < tile_blocks(tile_p0(t + ST), tile_n(t + ST), a.bs, &fb))
          next_id = rows.load_id(fb, tid);
      }
    }
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

    const int kv0 = tile_p0(t);
    // warp-uniform: a row of this warp sees a key of the tile
    if (wvalid && kv0 <= pos + wt_hi && !(win > 0 && kv0 + BN - 1 <= pos + wt_lo - win)) {
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
            const uint32_t kb0[2] = {kb[0], kb[1]}, kb1[2] = {kb[2], kb[3]};
            mma16816<T>(s[2 * p], qa, kb0);
            mma16816<T>(s[2 * p + 1], qa, kb1);
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
            const uint32_t vb0[2] = {vb[0], vb[1]}, vb1[2] = {vb[2], vb[3]};
            mma16816<T>(acc[2 * n2], pa, vb0);
            mma16816<T>(acc[2 * n2 + 1], pa, vb1);
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
    if constexpr (Rows::PAGED) {
      if (next_id >= 0) ids[(t % ST) * BN + tid] = next_id;
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

  if (ranks == 1) {  // one rank: each lane writes its rows; no live key -> zeros
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
  // ranks] there.
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  const int rpo = BM / ranks;  // rows each rank owns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rb = 16 * w + gq + 8 * h;  // the row in the block
    const uint32_t dst = (uint32_t)(rb % ranks);
    uint32_t raddr, rbar;
    const uint32_t laddr = smem_addr(recv + (size_t)(rank * rpo + rb / ranks) * L::DP);
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
    for (int k = 0; k < ranks; ++k) mx = fmaxf(mx, recv[(k * rpo + tid) * L::DP + DHP]);
    float lsum = 0.f;
    for (int k = 0; k < ranks; ++k) {
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
    const int rg = row0 + li * ranks + rank;
    if (d >= Dh || rg >= rows_total) continue;
    float sum = 0.f;
    for (int k = 0; k < ranks; ++k) {
      const float* part = recv + (k * rpo + li) * L::DP;
      sum += part[d] * part[DHP + 2];
    }
    const float lsum = recv[li * L::DP + DHP + 3];
    out_row(rg)[d] = from_f32<T>(lsum == 0.f ? 0.f : sum / lsum);
  }
}

template <typename T, typename KT, int DHP, typename Rows>
cudaError_t launch(const Args& a, int bn, int stages, cudaStream_t stream) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  if (bn != L::BN || stages != L::STAGES) return cudaErrorInvalidValue;  // the host's plan
  auto kernel = walk<T, KT, DHP, Rows>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  cudaError_t err = opt_in_smem(kernel, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
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

template <typename T, typename KT, typename Rows>
cudaError_t by_dim(const Args& a, int bn, int stages, cudaStream_t stream) {
  if (a.Dh <= 64) return launch<T, KT, 64, Rows>(a, bn, stages, stream);
  if (a.Dh <= 128) return launch<T, KT, 128, Rows>(a, bn, stages, stream);
  return launch<T, KT, 256, Rows>(a, bn, stages, stream);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out); the rows are
// that dtype, or int8 with both scale arrays. Fills in vec_q / vec_kv and
// checks what every instance needs; returns the CUDA error code.
template <typename Rows>
int run(Args a, int dtype, int bn, int stages, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.Dh <= 0 || a.Dh > 256 ||
      a.S <= 0 || (a.k_scale == nullptr) != (a.v_scale == nullptr) || a.cluster <= 0 ||
      a.cluster > MAX_CLUSTER || (a.cluster & (a.cluster - 1)) != 0 || a.min_share < 0)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  const int kv_esize = a.k_scale != nullptr ? 1 : esize;
  a.vec_q = (a.Dh * esize) % 16 == 0 && aligned16(a.q);
  a.vec_kv = (a.Dh * kv_esize) % 16 == 0 && aligned16(a.k) && aligned16(a.v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8 = a.k_scale != nullptr;
  switch (dtype * 2 + (int8 ? 1 : 0)) {
    case 0: return (int)by_dim<float, float, Rows>(a, bn, stages, st);
    case 1: return (int)by_dim<float, int8_t, Rows>(a, bn, stages, st);
    case 2: return (int)by_dim<__nv_bfloat16, __nv_bfloat16, Rows>(a, bn, stages, st);
    case 3: return (int)by_dim<__nv_bfloat16, int8_t, Rows>(a, bn, stages, st);
    case 4: return (int)by_dim<__half, __half, Rows>(a, bn, stages, st);
    case 5: return (int)by_dim<__half, int8_t, Rows>(a, bn, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fw
}  // namespace
