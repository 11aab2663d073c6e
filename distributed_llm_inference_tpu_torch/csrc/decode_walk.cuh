// The split-KV walk of T=1 decode attention for Hopper, shared by the
// dense slot cache's kernel (csrc/slots_attention.cu, `DenseRows`) and
// the block-paged pool's (csrc/paged_attention.cu, `PagedRows`).
//
// The function: q [B, 1, H, Dh]; row b's query sits at pos[b] and
// attends its own keys at positions p in [lo, hi): hi = min(pos[b] + 1,
// S), where S is the most keys a row holds (the dense cache's length, or
// the table's MB * bs), so a row at pos >= S attends all S; lo = pos[b]
// - win + 1 (>= 0) with a sliding window win > 0 (static, or one int32
// on the device), else 0. Scores are scaled after the product, then
// soft-capped (cap * tanh(s / cap), off where cap <= 0), then masked; a
// row with no live key gives zeros. The softmax and the output
// accumulator are fp32; the output is q's dtype (fp32, bf16 or fp16);
// Dh <= 256. K/V rows are q's dtype, or int8 with one fp32 scale per
// key row (the JAX package's KVQuant leaves).
//
// What bounds it on an H100: each live K/V row is read once per KV head,
// 2 * Dh * esize bytes per key (Dh + 4 for an int8 row and its scale),
// against 4 * Dh FLOPs per query head and key: ~2 * group = 16 FLOPs per
// byte for tinyllama (H / KV = 8), far below the ~295 at which the bf16
// tensor cores stop being memory-bound. It is bound by BYTES, and at a
// fleet's decode sizes (B = 8 rows of ~1k keys, ~4 MB, ~1.3 us at 3.35
// TB/s) by how many SMs the walk keeps reading: one block per (row, KV
// head) puts 32 blocks on 132 SMs, each walking its row's keys alone.
//
// What the design does about it:
//   * A split-KV grid (n_split, KV * head tiles, B). n_split is fixed on
//     the host from the shapes alone (ops/paged_attention.py
//     `_slots_splits`, `_paged_splits`) so that B * KV * n_split fills
//     every SM twice; each block reads pos[b] and the window on the
//     device, computes the row's live range [lo, hi) and takes its even
//     share of the range's BN-key tiles, which lie on the BN grid from
//     key 0 (the edge tiles masked key by key). A block with an empty
//     share writes a neutral partial (m = NEG, l = 0). Nothing is read
//     back to the host: a call can be captured in a CUDA graph.
//   * The key-row addressing is a small policy. `DenseRows`: key p is
//     row p of cache[b, kvh]. `PagedRows`: key p is slot p % bs of pool
//     block table[b, p / bs] (an id outside [0, N) reads block 0, the
//     trash block). The block table's ids of a tile are loaded once per
//     pool block, by one thread each, into shared memory, one tile ahead
//     of the copies that use them (the load flies while the block
//     computes); a copy then finds its key's row with no global read. At
//     16-key blocks a warp's 16 keys are exactly one pool block; any
//     block size works, rows that straddle a block edge addressed row by
//     row.
//   * Tiles of BN keys, K and V, stay in the storage type and go through
//     a ring of 2 or 3 shared-memory stages by 16-byte cp.async.cg
//     copies, neighbouring threads on neighbouring addresses (element
//     copies where a row is no multiple of 16 bytes); rows are padded by
//     16 bytes so that ldmatrix's eight row addresses hit eight bank
//     groups. The next tiles' copies are in flight while the block
//     computes on this one (one __syncthreads per tile).
//   * bf16 / fp16: tensor-core products with the operands swapped for a
//     decode row's few query heads. Each warp owns 16 keys of the tile:
//     scores S^T = K Q^T by mma.sync.m16n8k16 with the keys as M (A from
//     shared memory by ldmatrix) and the block's 8 query heads as N (Q^T
//     held in registers for the whole walk); the probabilities go to the
//     B layout by movmatrix.trans (rounded to bf16 / fp16, as
//     FlashAttention rounds P); the output O^T = V^T P^T with V^T by
//     ldmatrix.trans. Both products accumulate in fp32. A group of fewer
//     than 8 heads pads N with zero queries; a larger one takes several
//     head tiles along grid.y.
//   * fp32: the same tiles, ring and warp layout on CUDA-core FMAs (TF32
//     would not hold fp32's tolerance), each lane computing the four
//     scores and the output elements the mma's accumulator layout gives
//     it, so the softmax and the merges are one code.
//   * The softmax runs in base 2 (scores times log2 e, then exp2f, one
//     MUFU instruction), and the soft cap sits out of line (no served
//     llama uses it): the per-element code of the tile stays short.
//   * int8 rows: the ring carries the int8 rows (16-byte copies) and
//     their fp32 scales (4-byte copies), half the bytes of a bf16 tile;
//     each warp dequantizes its own 16 keys, q8 * s in fp32 rounded to
//     the product's type, into a buffer of its own (no block barrier).
//     For bf16 / fp16 q that rounding differs from the JAX prologue,
//     which keeps the fp32 tile: each K/V element carries a relative
//     error <= 2^-9 (bf16) or 2^-12 (fp16), which moves a score by <=
//     2^-9 of |q||k| (on quantized unit-normal K/V, as the card's tests
//     hold it, well inside the 2e-2 that bf16 outputs are held to); fp32
//     q keeps the fp32 tile, the JAX kernel's products.
//   * Each warp keeps its own (m, l, acc); at the end the block merges its
//     four warps in order and writes one fp32 partial (m, l, acc[group
//     heads, Dh]) per (row, KV head, split) to a workspace the wrapper
//     allocates. A second small kernel, one block per (row, query head),
//     merges the splits in index order 0 .. n_split - 1 with the
//     log-sum-exp rescale (each thread issues eight splits' loads at once:
//     one L2 read at a time cost ~0.3 us per split on an H100) and writes
//     the output. No atomics, so two calls give the same bits.

#pragma once

#include "tile_ops.cuh"

namespace {

constexpr int HT = 8;   // query heads per block: the mma's N
constexpr int KW = 16;  // keys per warp and tile: the mma's M
constexpr int MAX_SPLITS = 8192;  // the combine keeps one weight per split in shared memory

struct WalkArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 rows: one scale per key row; else null
  const float* v_scale;
  void* out;
  float* ws;  // partials: acc [B, KV, n_split, group, Dh], then (m, l) [.., group, 2]
  const int* pos;      // [B]
  const int* table;    // PagedRows: [B, MB]; DenseRows: null
  const int* win_dyn;  // one int32 on the device overriding win_static, or null
  int B, H, KV, Dh, n_split;
  int S;          // the most keys a row holds: the cache's length, or MB * bs
  int N, bs, MB;  // PagedRows: pool blocks, keys per block, table width
  int win_static;  // <= 0: full causal
  int vec;         // 16-byte rows on 16-byte addresses: the copies go by cp.async
  float scale, softcap;  // softcap <= 0: off
};

// The shared-memory plan of one instance. T: q's type; KT: the rows' (T,
// or int8_t); DHP: the head dim padded to 64, 128 or 256. RS / KRS: a
// row's stride in elements of T / KT, DHP plus 16 bytes. BN: keys per
// tile (32 where a row of T passes 512 bytes, so fp32 at Dh 256 fits
// twice); STAGES: tiles in the ring. Then, int8 only, each warp's
// dequantized K and V rows; fp32 only, the block's queries and each
// warp's probabilities; PAGED only, the pool block ids of each stage.
template <typename T, typename KT, int DHP, bool PAGED> struct Plan {
  static constexpr bool MMA = !std::is_same<T, float>::value;
  static constexpr bool INT8 = std::is_same<KT, int8_t>::value;
  static constexpr int ESZ = sizeof(T);
  static constexpr int RS = DHP + 16 / ESZ;
  static constexpr int KRS = DHP + 16 / (int)sizeof(KT);
  static constexpr int BN = ESZ * DHP > 512 ? 32 : 64;
  static constexpr size_t ROWS = (size_t)BN * KRS * sizeof(KT);  // K or V of a stage
  static constexpr size_t STAGE = 2 * ROWS + (INT8 ? 2 * BN * sizeof(float) : 0);
  static constexpr int STAGES = 3 * STAGE <= 110 * 1024 ? 3 : 2;
  static constexpr size_t RING = STAGES * STAGE;
  static constexpr size_t DEQ = INT8 ? (size_t)NW * 2 * KW * RS * ESZ : 0;
  static constexpr size_t EXTRA = MMA ? 0 : sizeof(float) * (HT * RS + NW * KW * HT);
  static constexpr size_t IDS = PAGED ? sizeof(int) * STAGES * BN : 0;
  static constexpr size_t SMEM = RING + DEQ + EXTRA + IDS;
  static_assert(BN % KW == 0 && BN / KW <= NW, "a tile is at most one 16-key slice per warp");
  static_assert(STAGE % 16 == 0 && RING % 16 == 0 && DEQ % 16 == 0 && EXTRA % 16 == 0,
                "16-byte regions");
  static_assert(sizeof(float) * NW * HT * (DHP + 2) <= SMEM, "the merge reuses the walk's buffers");
  static_assert(SMEM <= 227 * 1024, "fits one SM's shared memory");
};

// The addressing policy of a key row: row b's keys are rows 0 .. S - 1 of
// cache[b, kvh] (and of its scales).
struct DenseRows {
  static constexpr bool PAGED = false;
  size_t first;  // (b * KV + kvh) * S: the row of key 0
  __device__ DenseRows(const WalkArgs& a, int b, int kvh)
      : first(((size_t)b * a.KV + kvh) * a.S) {}
  __device__ size_t row(int p, const int*, int) const { return first + p; }
};

// The block table's policy: key p of row b is slot p % bs of pool block
// table[b, p / bs] of KV head kvh, the pool [N, KV, bs, Dh] (scales [N, KV,
// bs]); an id outside [0, N) reads block 0, the trash block. `ids[j]`
// holds the id of the tile's pool block fb + j.
struct PagedRows {
  static constexpr bool PAGED = true;
  const int* trow;
  int N, KV, kvh, bs;
  __device__ PagedRows(const WalkArgs& a, int b, int kvh_)
      : trow(a.table + (size_t)b * a.MB), N(a.N), KV(a.KV), kvh(kvh_), bs(a.bs) {}
  __device__ int load_id(int fb, int j) const {
    const int id = trow[fb + j];
    return id >= 0 && id < N ? id : 0;
  }
  __device__ size_t row(int p, const int* ids, int fb) const {
    const int blk = p / bs;
    return ((size_t)ids[blk - fb] * KV + kvh) * bs + (p - blk * bs);
  }
};

// The live keys of tile t of a share: keys p0 + rlo .. p0 + rhi - 1, in
// pool blocks fb .. fb + nblk - 1 (PagedRows).
struct TileKeys {
  int p0, rlo, rhi, fb, nblk;
  __device__ TileKeys(int p0_, int lo, int hi, int BN, int bs) : p0(p0_) {
    rlo = max(lo - p0, 0);
    rhi = min(hi - p0, BN);
    fb = (p0 + rlo) / bs;
    nblk = (p0 + rhi - 1) / bs - fb + 1;
  }
};

// The tile's live keys of K and V (and their scales) into a stage's rows
// rlo .. rhi - 1; the other rows are zeros, so no stale value meets a zero
// probability. Columns [Dh, DHP) were zeroed once at the start.
template <typename T, typename KT, int DHP, typename Rows>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Rows& rows, const int* ids,
                                           const TileKeys& tk, const KT* kb, const KT* vb,
                                           const float* ksb, const float* vsb, int Dh,
                                           bool vec, int tid) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  KT* ks = reinterpret_cast<KT*>(st);
  KT* vs = reinterpret_cast<KT*>(st + L::ROWS);
  if (vec) {
    constexpr int PER = 16 / sizeof(KT);  // elements per 16-byte chunk
    const int cpr = Dh / PER;
    for (int c = tid; c < L::BN * cpr; c += NT) {
      const int r = c / cpr, j = (c - r * cpr) * PER;
      KT* dk = ks + r * L::KRS + j;
      KT* dv = vs + r * L::KRS + j;
      if (r >= tk.rlo && r < tk.rhi) {
        const size_t off = rows.row(tk.p0 + r, ids, tk.fb) * Dh + j;
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
      const bool live = r >= tk.rlo && r < tk.rhi;
      const size_t off = live ? rows.row(tk.p0 + r, ids, tk.fb) * Dh + d : 0;
      ks[r * L::KRS + d] = live ? kb[off] : KT{};
      vs[r * L::KRS + d] = live ? vb[off] : KT{};
    }
  }
  if constexpr (L::INT8) {
    float* sc = reinterpret_cast<float*>(st + 2 * L::ROWS);  // K's scales, then V's
    for (int i = tid; i < 2 * L::BN; i += NT) {
      const int r = i % L::BN;
      if (r >= tk.rlo && r < tk.rhi)
        cp_async4(sc + i, (i < L::BN ? ksb : vsb) + rows.row(tk.p0 + r, ids, tk.fb));
      else
        sc[i] = 0.f;
    }
  }
}

// One block: (split, KV head x head tile, row). Lane (gq = lane / 4,
// tg = lane % 4) of warp w holds the accumulator layout of m16n8k16:
// scores s[0..3] of keys (w*16 + gq, w*16 + gq + 8) x heads (2tg, 2tg + 1)
// in the order (gq, 2tg), (gq, 2tg+1), (gq+8, 2tg), (gq+8, 2tg+1), and
// output acc[mt][0..3] of dims (16mt + gq, 16mt + gq + 8) x the same heads.
template <typename T, typename KT, int DHP, typename Rows>
__global__ void __launch_bounds__(NT) walk_split(WalkArgs a) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  constexpr int BN = L::BN, RS = L::RS, KRS = L::KRS, ST = L::STAGES, MT = DHP / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + L::RING + L::DEQ);  // fp32: [HT][RS]
  int* ids = reinterpret_cast<int*>(smem + L::RING + L::DEQ + L::EXTRA);  // [ST][BN]

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

  // the row's live keys [lo, hi), its BN-key tiles from `base` on the BN
  // grid, and this split's even share of them
  const int pos = a.pos[b];
  const int win = a.win_dyn != nullptr ? *a.win_dyn : a.win_static;
  const int hi = pos >= a.S ? a.S : pos + 1;  // no overflow at a frozen slot
  const int lo = win > 0 ? max(pos - win + 1, 0) : 0;
  const int base = lo - lo % BN;
  const int n_tiles = hi > lo ? (hi - 1 - base) / BN + 1 : 0;
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

  const Rows rows(a, b, kvh);
  const KT* kb = static_cast<const KT*>(a.k);
  const KT* vb = static_cast<const KT*>(a.v);
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kvh * group + h0) * Dh;
  const int nt = t1 - t0;
  auto tile = [&](int t) { return TileKeys(base + (t0 + t) * BN, lo, hi, BN, a.bs); };

  // the padding columns [Dh, DHP) of every staged row are zeros, once
  if (Dh < DHP) {
    const int pad = DHP - Dh;
    for (int i = tid; i < ST * 2 * BN * pad; i += NT) {
      const int r = i / pad, s = r / (2 * BN), rr = r - s * 2 * BN;
      KT* row = reinterpret_cast<KT*>(ring + s * L::STAGE) + rr * KRS;  // K rows, then V rows
      row[Dh + (i - r * pad)] = KT{};
    }
  }
  // the first stages' pool block ids
  if constexpr (Rows::PAGED) {
    for (int t = 0; t < ST && t < nt; ++t) {
      const TileKeys tk = tile(t);
      if (tid < tk.nblk) ids[t * BN + tid] = rows.load_id(tk.fb, tid);
    }
    __syncthreads();
  }

  auto issue = [&](int t) {  // tile t of the share into its stage, then commit
    if (t < nt)
      stage_tile<T, KT, DHP>(ring + (t % ST) * L::STAGE, rows, ids + (t % ST) * BN, tile(t),
                             kb, vb, a.k_scale, a.v_scale, Dh, a.vec != 0, tid);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);

  // the block's queries, loaded while the first tiles' copies fly: Q^T
  // fragments in registers (tensor cores), or [HT][RS] fp32 in shared
  // memory; heads past the group are zeros
  uint32_t qf[L::MMA ? MT : 1][2];
  float* pw = qs + HT * RS + w * KW * HT;  // fp32: this warp's probabilities [KW][HT]
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
    // the ids of tile t + ST, loaded now and stored after this tile's
    // compute, into the slot tile t's ids used (published by the next
    // iteration's barrier, before issue(t + ST) reads them)
    int next_id = -1;
    if constexpr (Rows::PAGED) {
      if (t + ST < nt) {
        const TileKeys tk = tile(t + ST);
        if (tid < tk.nblk) next_id = rows.load_id(tk.fb, tid);
      }
    }
    cp_async_wait<ST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();          // everyone's have, and tile t - 1 is consumed
    issue(t + ST - 1);        // into the stage tile t - 1 used
    const unsigned char* stg = ring + (t % ST) * L::STAGE;
    const TileKeys tk = tile(t);

    // warp-uniform: this warp's 16 keys hold a live one
    if (kr0 < tk.rhi && kr0 + KW > tk.rlo) {
      const T* kw;
      const T* vw;
      if constexpr (L::INT8) {  // dequantize this warp's keys: q8 * s in fp32, rounded to T
        T* dw = reinterpret_cast<T*>(smem + L::RING) + (size_t)w * 2 * KW * RS;
        const int8_t* k8 = reinterpret_cast<const int8_t*>(stg) + kr0 * KRS;
        const int8_t* v8 = reinterpret_cast<const int8_t*>(stg + L::ROWS) + kr0 * KRS;
        const float* sc = reinterpret_cast<const float*>(stg + 2 * L::ROWS) + kr0;
        constexpr int C4 = DHP / 4;
        for (int i = lane; i < 2 * KW * C4; i += 32) {
          const int r = i / C4, c = (i - r * C4) * 4;  // r < KW: K, else V
          const char4 x = *reinterpret_cast<const char4*>(
              (r < KW ? k8 + r * KRS : v8 + (r - KW) * KRS) + c);
          const float s = r < KW ? sc[r] : sc[BN + r - KW];
          T* dst = dw + r * RS + c;
          if constexpr (L::MMA) {
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(pack_f32<T>((float)x.x * s, (float)x.y * s),
                           pack_f32<T>((float)x.z * s, (float)x.w * s));
          } else {
            *reinterpret_cast<float4*>(dst) =
                make_float4((float)x.x * s, (float)x.y * s, (float)x.z * s, (float)x.w * s);
          }
        }
        __syncwarp();
        kw = dw;
        vw = dw + KW * RS;
      } else {
        kw = reinterpret_cast<const T*>(stg) + kr0 * RS;
        vw = reinterpret_cast<const T*>(stg + L::ROWS) + kr0 * RS;
      }

      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (L::MMA) {
#pragma unroll
        for (int kt = 0; kt < MT; ++kt) {
          uint32_t ka[4];
          ldsm_x4(ka, kw + (lane & 15) * RS + 16 * kt + (lane >> 4) * 8);
          mma16816<T>(s, ka, qf[kt]);
        }
      } else {
        const float* k0 = reinterpret_cast<const float*>(kw) + gq * RS;
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

      // scale, softcap, mask the keys outside the live range, online
      // softmax in fp32, in base 2
      const int r0 = kr0 + gq, r1 = r0 + 8;
      const bool v0 = r0 >= tk.rlo && r0 < tk.rhi, v1 = r1 >= tk.rlo && r1 < tk.rhi;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[e] * a.scale;
        if (a.softcap > 0.f) x = soft_cap(x, a.softcap);
        s[e] = (e < 2 ? v0 : v1) ? x * LOG2E : NEG;
      }
      float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 key lanes of a head
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
      const float al0 = exp2f(m[0] - mn0), al1 = exp2f(m[1] - mn1);
      const float p0 = v0 ? exp2f(s[0] - mn0) : 0.f, p1 = v0 ? exp2f(s[1] - mn1) : 0.f;
      const float p2 = v1 ? exp2f(s[2] - mn0) : 0.f, p3 = v1 ? exp2f(s[3] - mn1) : 0.f;
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
          ldsm_x4_trans(va, vw + ((lane & 7) + ((lane >> 4) << 3)) * RS + 16 * mt +
                                ((lane >> 3) & 1) * 8);
          mma16816<T>(acc[mt], va, pb);
        }
      } else {
        pw[gq * HT + 2 * tg] = p0;
        pw[gq * HT + 2 * tg + 1] = p1;
        pw[(gq + 8) * HT + 2 * tg] = p2;
        pw[(gq + 8) * HT + 2 * tg + 1] = p3;
        __syncwarp();
        const float* vf = reinterpret_cast<const float*>(vw);
#pragma unroll 4
        for (int r = 0; r < KW; ++r) {
          const float2 pp = *reinterpret_cast<const float2*>(pw + r * HT + 2 * tg);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float va = vf[r * RS + 16 * mt + gq];
            const float vb2 = vf[r * RS + 16 * mt + gq + 8];
            acc[mt][0] = fmaf(pp.x, va, acc[mt][0]);
            acc[mt][1] = fmaf(pp.y, va, acc[mt][1]);
            acc[mt][2] = fmaf(pp.x, vb2, acc[mt][2]);
            acc[mt][3] = fmaf(pp.y, vb2, acc[mt][3]);
          }
        }
        __syncwarp();  // the next tile's probabilities overwrite pw
      }
    }
    if constexpr (Rows::PAGED) {
      if (next_id >= 0) ids[(t % ST) * BN + tid] = next_id;
    }
  }

  // the block's partial: the four warps merged in order over the walk's buffers
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  __syncthreads();  // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(smem);  // [NW][HT]
  float* wl = wm + NW * HT;                    // [NW][HT]
  float* wa = wl + NW * HT;                    // [NW][HT][DHP]
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
      const float e = exp2f(wm[v * HT + h] - mx);
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

// The splits merged with the log-sum-exp rescale (base 2), one block per
// (row, KV head, query head): the splits' max M and sum L = sum_s l_s e_s,
// e_s = 2^(m_s - M), by fixed-order reductions; then out[d] = sum_s
// acc_s[d] e_s / L, one thread per element summing the splits in index
// order 0 .. n_split - 1, CB loads issued together. A row with no live key
// (every l = 0) writes zeros. Shared memory: e [n_split], then NW floats.
template <typename T>
__global__ void __launch_bounds__(NT) walk_combine(WalkArgs a) {
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
    const float w = exp2f(ml[s * ml_step] - mx);
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

// The split kernel, then the combine, on `stream`.
template <typename T, typename KT, int DHP, typename Rows>
cudaError_t launch_walk(const WalkArgs& a, cudaStream_t stream) {
  using L = Plan<T, KT, DHP, Rows::PAGED>;
  auto kernel = walk_split<T, KT, DHP, Rows>;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  cudaError_t err = opt_in_smem(kernel, L::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int n_ht = (a.H / a.KV + HT - 1) / HT;
  const dim3 grid(a.n_split, a.KV * n_ht, a.B);
  kernel<<<grid, NT, L::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  walk_combine<T><<<a.B * a.H, NT, sizeof(float) * (a.n_split + NW), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT, typename Rows>
cudaError_t launch_walk_by_dim(const WalkArgs& a, cudaStream_t stream) {
  if (a.Dh <= 64) return launch_walk<T, KT, 64, Rows>(a, stream);
  if (a.Dh <= 128) return launch_walk<T, KT, 128, Rows>(a, stream);
  return launch_walk<T, KT, 256, Rows>(a, stream);
}

// The shape checks both entry points share; 0 where the walk takes them.
inline bool walk_args_bad(const WalkArgs& a) {
  return a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.S <= 0 || a.Dh <= 0 ||
         a.Dh > 256 || a.n_split <= 0 || a.n_split > MAX_SPLITS || a.ws == nullptr ||
         a.pos == nullptr || (a.k_scale == nullptr) != (a.v_scale == nullptr);
}

}  // namespace
