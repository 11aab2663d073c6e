// y = x @ dequant(w) for a few rows of x against a packed int4 weight, on
// Hopper's tensor cores, in one launch.
//
// Replaces: the Pallas TPU kernel `_q4_rows_kernel` in the JAX package's
// distributed_llm_inference_tpu/ops/quant.py (launched by its
// `q4_matmul_rows` through `pl.pallas_call`). Same function: x [R, in]
// (R <= 32) in fp32, bf16 or fp16; w.q [G, g/2, out] int8, where the LOW
// nibble of packed row i of group G_i holds contraction row G_i * g + i and
// the HIGH nibble row G_i * g + g/2 + i (halves, not interleaved), both
// sign-extended; w.s [G, out] fp32. Each group's partial product is
// accumulated in fp32 and scaled by its scales, the groups are summed in
// fp32, and y [R, out] is written once in x's dtype (the JAX function
// returns fp32 and its caller casts: the same rounding).
//
// What bounds it on an H100: the packed weight is read once, in / 2 bytes
// per output column plus 4 * G bytes of scales, against 2 * R FLOPs per
// weight: at R <= 32 that is at most ~128 FLOPs per byte, below the ~295
// at which the tensor cores stop being memory-bound, and at decode (R = 1
// to 8) far below. The bound is BYTES: tinyllama's projections need 0.10
// (2048 -> 256) to 11.2 us (the LM head, 2048 -> 32000) at 3.35 TB/s. To
// stream at that rate an SM must take in ~15 bytes a clock, so the
// instructions spent per weight byte, and the bytes in flight, decide how
// close a kernel comes; the small projections are bound by one launch and
// a DRAM round trip or two, whatever the kernel does.
//
// What the design does about it:
//   * Tensor-core products for bf16 and fp16 x: mma.sync.m16n8k16 with the
//     output COLUMNS as M and x's rows as N (R <= 8 fills N = 8 exactly;
//     R <= 32 takes up to four N tiles). The k-pair of a fragment register
//     is (i, i + g/2): the low and the high nibble of one packed byte, so one
//     byte becomes one register in three instructions (prmt, lop3, one
//     packed subtract: `nibbles`), and x's fragment takes the same pairing.
//     Nibbles in -7..7 are exact in bf16 and fp16 and every product is exact
//     in the fp32 accumulator: only the order of the sums differs from the
//     twin's.
//   * A thread's 4-byte word of a packed row is four output columns, which
//     the fragment layout gives to two M tiles: a warp covers 32 columns
//     with one 4-byte shared-memory load per packed row and thread, and the
//     accumulator leaves each thread four adjacent columns of two rows.
//   * fp32 x keeps CUDA-core FMAs (TF32 would not hold fp32's tolerance) in
//     the same block, stage and accumulator layout; its nibbles become fp32
//     numbers by the same bias trick (`nibble_f32`).
//   * Per group, a fresh fp32 accumulator, scaled by s[G_i, col] and added
//     to the block's running sum in group order: the twin's algebra.
//   * One launch and no workspace: a block owns TN = 128 output columns and
//     a contiguous run of `gps` groups; the n_split blocks that share a
//     column tile form one thread-block cluster (n_split <= 8, the portable
//     size) and sum their partials through distributed shared memory. Rank
//     k owns the float4s f of the tile with f % n_split == k: every rank
//     pushes its partial of them into rank k's receive buffer by st.async,
//     whose bytes complete rank k's mbarrier, and rank k sums them over the
//     ranks in order 0, 1, ... A relaxed cluster barrier (arrive at the
//     start, wait before the first push) is the only cluster-wide wait: no
//     fence over device memory and no block waits for another to finish
//     reading. No atomics: a repeat gives the same bits. The grid (n_split,
//     gps, stages) is fixed on the host from the shapes alone (ops/quant.py
//     `q4_plan`), so a call reads nothing back and is captured in a CUDA
//     graph.
//   * Cheap copies: each thread's offsets into a stage are computed once,
//     so a stage costs a thread four or five cp.async and a few adds (with
//     one warp per scheduler, issue latency, not bandwidth, bounds a
//     block's first microseconds).
//   * Bytes in flight: each stage of a shared-memory ring holds one k-block
//     (KB = 32 packed rows x TN columns of weight, the group's TN scales, and
//     x's 2 x KB columns of the R rows), copied by 16-byte cp.async.cg; the
//     ring has up to 8 stages, so a block's whole share of a 2048-input
//     projection (4 k-blocks at n_split 8) is requested at once, and a
//     longer share keeps up to 8 in flight while the block computes.
//     Staged weight rows are padded by 32 bytes so that a warp's fragment
//     loads hit 32 distinct banks.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;          // threads per block: 4 warps of 32 columns
constexpr int TN = 128;          // output columns per block
constexpr int KB = 32;           // packed rows per stage (64 contraction rows)
constexpr int WS = TN + 32;      // a staged weight row's stride in bytes
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLIT = 8;     // the portable cluster size
constexpr int MAX_ROWS = 32;
constexpr int MAX_DEVICES = 64;

// lop3's truth table for b ? (a ^ c) : c (a = 0xF0, b = 0xCC, c = 0xAA):
// under the nibble mask b, a nibble of a XOR 8 (from c); elsewhere c
constexpr uint32_t NIB_LUT = 0x6A;
constexpr uint32_t NIB_MASK = 0x000F000Fu;
// per 16-bit half: the exponent of 128 (bf16) or 1024 (fp16) and the
// 8 that biases a signed nibble n to n ^ 8 = n + 8 in 0..15. The half then
// reads 136 + n (bf16) or 1032 + n (fp16), exactly; subtracting the same
// constant as a number leaves n.
constexpr uint32_t NIB_BF16 = 0x43084308u;
constexpr uint32_t NIB_FP16 = 0x64086408u;
// the same for one fp32 number: 2^23 + 8 + n, exactly
constexpr uint32_t NIB_FP32 = 0x4B000008u;
constexpr uint32_t ONE_BF16 = 0x3F803F80u;
constexpr uint32_t ONE_FP16 = 0x3C003C00u;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
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
// wait until at most n of this thread's copy groups are pending (n < 8)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Byte K of w as one fragment register: the low nibble in the low half,
// the high nibble in the high half, each a bf16 / fp16 number. ws = w >> 4
// holds the high nibble of each byte at the low nibble's place, so prmt
// puts the two nibbles 16 bits apart, lop3 masks them and biases them
// into a float's mantissa, and one packed subtract removes the bias.
template <typename T, int K>
__device__ __forceinline__ uint32_t nibbles(uint32_t w, uint32_t ws) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const uint32_t bias = BF ? NIB_BF16 : NIB_FP16;
  uint32_t p, r, out;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(p) : "r"(w), "r"(ws), "r"(K | ((K + 4) << 8)));
  asm("lop3.b32 %0, %1, %2, %3, %4;\n"
      : "=r"(r)
      : "r"(p), "r"(NIB_MASK), "r"(bias), "n"(NIB_LUT));
  if (BF)
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(out)
        : "r"(r), "r"(ONE_BF16), "r"(bias | 0x80008000u));
  else
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
        : "=r"(out)
        : "r"(r), "r"(ONE_FP16), "r"(bias | 0x80008000u));
  return out;
}

// The low nibble of v as an fp32 number: lop3 biases it into the mantissa
// of 2^23 + 8, one subtract removes the bias (full-rate operations, no
// int-to-float conversion).
__device__ __forceinline__ float nibble_f32(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(r) : "r"(v), "r"(0xFu), "r"(NIB_FP32), "n"(NIB_LUT));
  return __int_as_float(r) - __int_as_float(NIB_FP32);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack2(__half lo, __half hi) {
  return (uint32_t)__half_as_ushort(lo) | ((uint32_t)__half_as_ushort(hi) << 16);
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
  const void* x;
  const int8_t* q;
  const float* s;
  void* y;
  int R, d_in, G, half, d_out, n_split, gps, stages;
};

// The shared-memory plan of one instance: NTR tiles of 8 rows of x. A
// stage is W (KB rows of WS bytes), S (TN floats), X (8 * NTR rows of XS
// bytes: the k-block's KB low-nibble columns of x, then its KB high-nibble
// columns, then 16 bytes of padding). After the ring: the receive buffer
// of the cluster's sum (each rank's share of this block's slice of the
// tile, `recv_cap` float4s per rank) and its mbarrier.
template <typename T, int NTR> struct Plan {
  static constexpr int ESZ = sizeof(T);
  static constexpr int NR = 8 * NTR;
  static constexpr int XS = 2 * KB * ESZ + 16;
  static constexpr int S_OFF = KB * WS;
  static constexpr int X_OFF = S_OFF + TN * 4;
  static constexpr int STAGE = X_OFF + NR * XS;
  // the most 16-byte chunks of x a thread copies into a stage
  static constexpr int XCH = (MAX_ROWS * 2 * KB * ESZ / 16 + NT - 1) / NT;
  static_assert(STAGE % 16 == 0 && XS % 16 == 0, "16-byte copies into the stage");
  static_assert(KB * TN / 16 == 2 * NT, "two weight chunks per thread and stage");
};

// float4s of the tile's [R, TN] partial that one rank receives from each
// rank: rank k owns the float4s f with f % n_split == k
__host__ __device__ inline int recv_cap(int R, int n_split) {
  return (R * TN / 4 + n_split - 1) / n_split;
}
__host__ __device__ inline size_t smem_bytes(int stage, int stages, int R, int n_split) {
  return (size_t)stages * stage + (size_t)n_split * recv_cap(R, n_split) * 16 + 16;
}

// One k-block on the tensor cores. Lane (gq = lane / 4, tg = lane % 4) of
// warp w reads the words of packed rows 8t + tg and 8t + tg + 4 at columns
// 32w + 4gq .. + 3: byte k is column 4gq + k, which is M tile k / 2, slot
// gq + 8 (k % 2). So acc[mt][nt] holds, in the m16n8k16 accumulator
// layout, columns 32w + 4gq + 2mt (entries 0, 1) and + 2mt + 1 (entries
// 2, 3) of rows 8nt + 2tg (entries 0, 2) and 8nt + 2tg + 1 (entries 1, 3).
template <typename T, int NTR>
__device__ __forceinline__ void kblock_mma(const unsigned char* st, float (&acc)[2][NTR][4],
                                           int warp, int gq, int tg) {
  using L = Plan<T, NTR>;
  const unsigned char* W = st + 32 * warp + 4 * gq;
  const unsigned char* X = st + L::X_OFF;
#pragma unroll
  for (int t = 0; t < KB / 8; ++t) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(W + (8 * t + tg) * WS);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(W + (8 * t + tg + 4) * WS);
    const uint32_t s0 = w0 >> 4, s1 = w1 >> 4;
    const uint32_t a0[4] = {nibbles<T, 0>(w0, s0), nibbles<T, 1>(w0, s0),
                            nibbles<T, 0>(w1, s1), nibbles<T, 1>(w1, s1)};
    const uint32_t a1[4] = {nibbles<T, 2>(w0, s0), nibbles<T, 3>(w0, s0),
                            nibbles<T, 2>(w1, s1), nibbles<T, 3>(w1, s1)};
#pragma unroll
    for (int nt = 0; nt < NTR; ++nt) {
      const T* xr = reinterpret_cast<const T*>(X + (8 * nt + gq) * L::XS);
      const int i = 8 * t + tg;
      const uint32_t b[2] = {pack2(xr[i], xr[KB + i]), pack2(xr[i + 4], xr[KB + i + 4])};
      mma16816<T>(acc[0][nt], a0, b);
      mma16816<T>(acc[1][nt], a1, b);
    }
  }
}

// One k-block on the CUDA cores (fp32 x), into the same accumulator layout:
// the lane's four columns are the four bytes of its word of each packed row.
// With few rows (R <= 2, `few`) the four lanes of a quad, which differ only
// in their rows, split the packed rows instead: each sums rows 0 and 1 over
// every fourth packed row, and `quad_sum` adds the four at the group's end.
template <int NTR>
__device__ __forceinline__ void kblock_fp32(const unsigned char* st, float (&acc)[2][NTR][4],
                                            int warp, int gq, int tg, bool few) {
  using L = Plan<float, NTR>;
  const unsigned char* W = st + 32 * warp + 4 * gq;
  const float* X = reinterpret_cast<const float*>(st + L::X_OFF);
  constexpr int XF = L::XS / 4;
  if (few) {
#pragma unroll 2
    for (int p = tg; p < KB; p += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(W + p * WS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xl = X[h * XF + p], xh = X[h * XF + KB + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& d = acc[c >> 1][0][2 * (c & 1) + h];
          d = fmaf(xh, nibble_f32(w >> (8 * c + 4)), fmaf(xl, nibble_f32(w >> (8 * c)), d));
        }
      }
    }
    return;
  }
#pragma unroll 4
  for (int p = 0; p < KB; ++p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(W + p * WS);
    float lo[4], hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = nibble_f32(w >> (8 * c));
      hi[c] = nibble_f32(w >> (8 * c + 4));
    }
#pragma unroll
    for (int nt = 0; nt < NTR; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* xr = X + (8 * nt + 2 * tg + h) * XF;
        const float xl = xr[p], xh = xr[KB + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& d = acc[c >> 1][nt][2 * (c & 1) + h];
          d = fmaf(xh, hi[c], fmaf(xl, lo[c], d));
        }
      }
  }
}

// The four lanes of each quad add their partial sums, the same bits in each
// lane (a + b == b + a): ((lane 0 + 1) + (lane 2 + 3)).
template <int NTR>
__device__ __forceinline__ void quad_sum(float (&acc)[2][NTR][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[m][n][e];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        acc[m][n][e] = v;
      }
}

// One block: rank `rank` of the cluster of column tile blockIdx.y.
template <typename T, int NTR>
__global__ void __launch_bounds__(NT) q4_rows_mma(Args a) {
  using L = Plan<T, NTR>;
  constexpr int ESZ = L::ESZ;
  constexpr int CPH = KB * ESZ / 16;  // 16-byte chunks per half row of staged x
  extern __shared__ __align__(128) unsigned char smem[];

  const int rank = (int)cg::this_cluster().block_rank();
  const int n_rank = a.n_split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tg = lane & 3;
  const int c0 = blockIdx.y * TN;
  const int g_lo = rank * a.gps;
  const int kpg = a.half / KB;  // k-blocks per group
  const int nb = max(min(a.G, g_lo + a.gps) - g_lo, 0) * kpg;
  const int S = a.stages;
  const T* x = static_cast<const T*>(a.x);
  const bool few = std::is_same<T, float>::value && NTR == 1 && a.R <= 2;

  // the cluster's sum: this block's mbarrier expects every rank's share of
  // its slice; a relaxed cluster arrive publishes the initialised barrier
  float4* recv = reinterpret_cast<float4*>(smem + (size_t)S * L::STAGE);
  const int cap = recv_cap(a.R, n_rank);
  const uint32_t mbar = smem_addr(recv + n_rank * cap);
  if (tid == 0) {
    const int mine = (a.R * TN / 4 - rank + n_rank - 1) / n_rank;  // float4s f % n == rank
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
            mbar),
        "r"(n_rank * mine * 16)
        : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  // rows of x past R: zeros in every stage (they feed only output rows
  // that are never written, but no stale bits meet the products)
  for (int i = tid; i < S * (L::NR - a.R) * (L::XS / 16); i += NT) {
    const int per = (L::NR - a.R) * (L::XS / 16);
    const int st = i / per, r = a.R + (i % per) / (L::XS / 16), c = i % (L::XS / 16);
    *reinterpret_cast<uint4*>(smem + (size_t)st * L::STAGE + L::X_OFF + r * L::XS + 16 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // this thread's copies of every stage, fixed for the walk: two 16-byte
  // chunks of weight (rows tid / 8 and tid / 8 + 16), one of scales (the
  // first TN / 4 threads), up to XCH of x; offsets from the k-block's base
  int w_src[2], w_dst[2], x_src[L::XCH], x_dst[L::XCH];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = tid + u * NT, r = c / (TN / 16), k = c % (TN / 16);
    w_src[u] = r * a.d_out + 16 * k;
    w_dst[u] = r * WS + 16 * k;
  }
  const int n_x = a.R * 2 * CPH;
#pragma unroll
  for (int u = 0; u < L::XCH; ++u) {
    const int c = tid + u * NT, r = c / (2 * CPH), h = (c / CPH) & 1, k = c % CPH;
    x_src[u] = r * a.d_in + h * a.half + k * (16 / ESZ);
    x_dst[u] = L::X_OFF + r * L::XS + h * KB * ESZ + 16 * k;
  }
  // the next k-block to copy: group gi_c, packed rows p0_c.., ring slot st_c
  int gi_c = g_lo, p0_c = 0, st_c = 0;
  auto issue = [&]() {
    unsigned char* st = smem + (size_t)st_c * L::STAGE;
    const int8_t* qs = a.q + ((size_t)gi_c * a.half + p0_c) * a.d_out + c0;
#pragma unroll
    for (int u = 0; u < 2; ++u) cp_async16(st + w_dst[u], qs + w_src[u]);
    if (tid < TN / 4)
      cp_async16(st + L::S_OFF + 16 * tid, a.s + (size_t)gi_c * a.d_out + c0 + 4 * tid);
    const T* xs = x + (size_t)gi_c * 2 * a.half + p0_c;
#pragma unroll
    for (int u = 0; u < L::XCH; ++u)
      if (tid + u * NT < n_x) cp_async16(st + x_dst[u], xs + x_src[u]);
    cp_async_commit();
    p0_c += KB;
    if (p0_c == a.half) p0_c = 0, ++gi_c;
    if (++st_c == S) st_c = 0;
  };

  int issued = min(S, nb);
  for (int j = 0; j < issued; ++j) issue();

  float tot[2][NTR][4], acc[2][NTR][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[m][n][e] = acc[m][n][e] = 0.f;

  int slot = 0, sub = 0;  // the k-block's ring slot and its place in its group
  for (int j = 0; j < nb; ++j) {
    cp_async_wait(issued - j - 1);
    __syncthreads();  // every thread's copies of k-block j have landed
    const unsigned char* st = smem + (size_t)slot * L::STAGE;
    if constexpr (std::is_same<T, float>::value)
      kblock_fp32<NTR>(st, acc, warp, gq, tg, few);
    else
      kblock_mma<T, NTR>(st, acc, warp, gq, tg);
    if (++sub == kpg) {  // the group's last k-block: scale, add, start afresh
      sub = 0;
      if (few) quad_sum(acc);
      const float4 sc =
          *reinterpret_cast<const float4*>(st + L::S_OFF + 4 * (32 * warp + 4 * gq));
      const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NTR; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float scaled = __fmul_rn(acc[m][n][e], sv[2 * m + (e >> 1)]);
            tot[m][n][e] = __fadd_rn(tot[m][n][e], scaled);
            acc[m][n][e] = 0.f;
          }
    }
    if (issued < nb) {
      __syncthreads();  // every warp is done with this slot: refill it
      issue();
      ++issued;
    }
    if (++slot == S) slot = 0;
  }

  // Send: float4 f of the tile's partial (row r, columns 4 (f % 32) ..)
  // goes to rank f % n, at its receive slot [this rank][f / n], by st.async,
  // which counts its bytes on the receiver's mbarrier. Every rank's barrier
  // was initialised before its cluster arrive.
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
#pragma unroll
  for (int n = 0; n < NTR; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * n + 2 * tg + h;
      if (r >= a.R) continue;
      const int f = (r * TN + 32 * warp + 4 * gq) / 4;
      const int dst = f % n_rank;
      uint32_t raddr, rbar;
      const uint32_t laddr = smem_addr(recv + rank * cap + f / n_rank);
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(raddr) : "r"(laddr), "r"(dst));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(mbar), "r"(dst));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
          "[%5];\n" ::"r"(raddr),
          "f"(tot[0][n][h]), "f"(tot[0][n][2 + h]), "f"(tot[1][n][h]), "f"(tot[1][n][2 + h]),
          "r"(rbar)
          : "memory");
    }

  // Receive: once every rank's share has landed, sum this rank's float4s
  // over the ranks 0, 1, ... in order and write them.
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
  const int n4 = a.R * TN / 4;
  for (int i = tid; i * n_rank + rank < n4; i += NT) {
    float4 v = recv[i];
    for (int k = 1; k < n_rank; ++k) {
      const float4 u = recv[k * cap + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int f = i * n_rank + rank, r = f / (TN / 4), col = 4 * (f % (TN / 4));
    T* yp = static_cast<T*>(a.y) + (size_t)r * a.d_out + c0 + col;
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float4*>(yp) = v;
    else
      *reinterpret_cast<uint2*>(yp) =
          make_uint2(pack2(from_f32<T>(v.x), from_f32<T>(v.y)),
                     pack2(from_f32<T>(v.z), from_f32<T>(v.w)));
  }
}

template <typename T, int NTR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Plan<T, NTR>;
  auto kernel = q4_rows_mma<T, NTR>;
  // the shared-memory opt-in, once per device for this instance
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev].load(std::memory_order_acquire)) {
    const size_t most = (size_t)MAX_STAGES * L::STAGE + (MAX_ROWS * TN / 4 + MAX_SPLIT) * 16 + 16;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.d_out / TN, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(L::STAGE, a.stages, a.R, a.n_split);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// tiles of 8 rows of x: 1, 2 or 4
template <typename T>
cudaError_t by_rows(const Args& a, cudaStream_t stream) {
  if (a.R <= 8) return launch<T, 1>(a, stream);
  if (a.R <= 16) return launch<T, 2>(a, stream);
  return launch<T, 4>(a, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y). x [R, d_in]
// with R <= 32; q [G, half, d_out] int8; s [G, d_out] fp32; y [R, d_out];
// all four 16-byte aligned. half % 32 == 0 and d_out % 128 == 0. The
// group axis is cut into n_split <= 8 runs of gps groups, one block of
// each column tile's cluster each; `stages` (1 to 8) is the depth of each
// block's copy ring. Launches on `stream` and returns the CUDA error code
// of the launch (0 = launched).
extern "C" int dli_q4_matmul_rows(const void* x, const void* q, const void* s, void* y,
                                  int dtype, int R, int d_in, int G, int half, int d_out,
                                  int n_split, int gps, int stages, void* stream) {
  if (R <= 0 || R > MAX_ROWS || G <= 0 || half <= 0 || half % KB != 0 || d_out <= 0 ||
      d_out % TN != 0 || d_in != 2 * half * G || n_split <= 0 || n_split > MAX_SPLIT ||
      gps <= 0 || (n_split - 1) * gps >= G || n_split * gps < G || stages <= 0 ||
      stages > MAX_STAGES || !aligned16(x) || !aligned16(q) || !aligned16(s) ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const int8_t*>(q), static_cast<const float*>(s), y,
               R, d_in, G, half, d_out, n_split, gps, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)by_rows<float>(a, st);
    case 1: return (int)by_rows<__nv_bfloat16>(a, st);
    case 2: return (int)by_rows<__half>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
