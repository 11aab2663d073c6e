// y = x @ dequant(w) for a few rows of x against a packed int4 weight.
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
// to 8) far below. The bound is BYTES.
//
// What the design does about it:
//   * Only int4 bytes cross device memory: the nibbles are unpacked in
//     registers, never written back (the TPU kernel unpacks in VMEM).
//   * `out` is the contiguous axis of w.q: a warp covers 128 output columns
//     with one 4-byte load per thread and packed row, 128 bytes coalesced.
//   * Each thread issues the loads of PF = 8 packed rows before it uses
//     any, so eight 4-byte loads per thread are in flight at once: the
//     weight stream is latency-bound otherwise (one dependent load per
//     packed row).
//   * One block owns 128 output columns and a contiguous run of groups.
//     Tinyllama's projections have 2 to 250 column tiles, too few blocks for
//     132 SMs, so the group axis is split across blocks until the grid has
//     ~1056 blocks (8 per SM). The split reduces in a FIXED order (a partial buffer
//     [n_split, R, out] and a second pass summing split 0, 1, ...), never
//     with atomics, so a run gives the same bits every time.
//   * Inside a block the four warps split the packed rows of each group
//     (R <= 8), or the rows of x (R up to 32), and reduce in shared memory
//     in warp order.
// It is a first, simple kernel: fp32 FMAs on the CUDA cores, no shared
// memory staging and no copy/compute overlap beyond the batched loads. x is
// read straight from device memory (it is tiny and every lane of a warp
// reads the same element: one broadcast transaction).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block: 4 warps
constexpr int TILE = 128;    // output columns per block: 32 lanes x 4
constexpr int MAX_RPT = 8;   // rows of x per thread
constexpr int PF = 8;        // packed rows whose loads are issued together

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

// RPT: rows of x per thread; WR: warps splitting the rows (4 / WR warps
// split each group's packed rows). Warp w = wk * WR + wr owns rows
// wr + WR * j (j < RPT) and packed rows [wk * half / WK, (wk + 1) * half / WK)
// of every group of this block's split.
template <typename T, int RPT, int WR>
__global__ void __launch_bounds__(NT) q4_rows(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, T* __restrict__ y, float* __restrict__ part,
    int R, int d_in, int G, int half, int d_out, int gps) {
  constexpr int WK = 4 / WR;
  __shared__ float red[4][RPT][TILE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp % WR, wk = warp / WR;
  const int col = blockIdx.x * TILE + lane * 4;
  const int split = blockIdx.y;
  const int g_lo = split * gps, g_hi = min(G, g_lo + gps);
  const int g = 2 * half;
  const int kq = half / WK;  // packed rows per warp and group
  const int i_lo = wk * kq;

  float tot[RPT][4];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[j][c] = 0.f;

  for (int gi = g_lo; gi < g_hi; ++gi) {
    float acc[RPT][4];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    const int8_t* qg = q + (size_t)gi * half * d_out + col;
    const T* xg = x + (size_t)gi * g;
    for (int i0 = i_lo; i0 < i_lo + kq; i0 += PF) {  // kq is a multiple of PF
      int word[PF];
#pragma unroll
      for (int u = 0; u < PF; ++u)
        word[u] = __ldg(reinterpret_cast<const int*>(qg + (size_t)(i0 + u) * d_out));
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int i = i0 + u;
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (int)(int8_t)((word[u] >> (8 * c)) & 0xFF);  // sign-extended byte
          lo[c] = (float)(((b & 15) ^ 8) - 8);
          hi[c] = (float)(b >> 4);
        }
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = wr + WR * j;
          if (r < R) {
            const float xl = to_f32(xg[(size_t)r * d_in + i]);
            const float xh = to_f32(xg[(size_t)r * d_in + half + i]);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] = fmaf(xh, hi[c], fmaf(xl, lo[c], acc[j][c]));
          }
        }
      }
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(s + (size_t)gi * d_out + col));
    const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[j][c] += acc[j][c] * sv[c];
  }

  if (WK > 1) {  // the warps of one row set reduce in warp order
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][j][lane * 4 + c] = tot[j][c];
    __syncthreads();
    if (wk != 0) return;
    for (int k = 1; k < WK; ++k)
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[j][c] += red[k * WR + wr][j][lane * 4 + c];
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = wr + WR * j;
    if (r >= R) continue;
    if (part != nullptr) {
      float* p = part + ((size_t)split * R + r) * d_out + col;
      *reinterpret_cast<float4*>(p) = make_float4(tot[j][0], tot[j][1], tot[j][2], tot[j][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) y[(size_t)r * d_out + col + c] = from_f32<T>(tot[j][c]);
    }
  }
}

// second pass of a split launch: y = sum over splits 0, 1, ... in order
template <typename T>
__global__ void q4_reduce(const float* __restrict__ part, T* __restrict__ y,
                          int n_split, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int k = 0; k < n_split; ++k) acc += part[(size_t)k * n + idx];
  y[idx] = from_f32<T>(acc);
}

template <typename T, int RPT, int WR>
cudaError_t launch_rows(const void* x, const void* q, const void* s, void* y, float* part,
                        int R, int d_in, int G, int half, int d_out, int n_split, int gps,
                        cudaStream_t stream) {
  const dim3 grid(d_out / TILE, n_split);
  q4_rows<T, RPT, WR><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(y), part, R, d_in, G, half, d_out, gps);
  return cudaGetLastError();
}

// rows per thread, rounded up to a power of two
template <typename T, int WR>
cudaError_t by_rows(const void* x, const void* q, const void* s, void* y, float* part,
                    int R, int d_in, int G, int half, int d_out, int n_split, int gps,
                    cudaStream_t stream) {
  const int rpt = (R + WR - 1) / WR;
#define DLI_ROWS(N)                                                                 \
  return launch_rows<T, N, WR>(x, q, s, y, part, R, d_in, G, half, d_out, n_split, \
                               gps, stream)
  if (rpt <= 1) DLI_ROWS(1);
  if (rpt <= 2) DLI_ROWS(2);
  if (rpt <= 4) DLI_ROWS(4);
  DLI_ROWS(8);
#undef DLI_ROWS
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* s, void* y, float* part,
                     int R, int d_in, int G, int half, int d_out, int n_split, int gps,
                     cudaStream_t stream) {
  cudaError_t err;
  float* p = n_split > 1 ? part : nullptr;
  if (R <= MAX_RPT)
    err = by_rows<T, 1>(x, q, s, y, p, R, d_in, G, half, d_out, n_split, gps, stream);
  else if (R <= 2 * MAX_RPT)
    err = by_rows<T, 2>(x, q, s, y, p, R, d_in, G, half, d_out, n_split, gps, stream);
  else
    err = by_rows<T, 4>(x, q, s, y, p, R, d_in, G, half, d_out, n_split, gps, stream);
  if (err != cudaSuccess || n_split == 1) return err;
  const int n = R * d_out;
  q4_reduce<T><<<(n + 255) / 256, 256, 0, stream>>>(part, static_cast<T*>(y), n_split, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and y). x [R, d_in]
// with R <= 32; q [G, half, d_out] int8 (4-byte aligned); s [G, d_out]
// fp32 (16-byte aligned); y [R, d_out]. The group axis is cut into
// n_split runs of gps groups, one grid row each; with n_split > 1, `part`
// is fp32 scratch of [n_split, R, d_out]. half % 32 == 0 and
// d_out % 128 == 0. Launches on `stream` and returns the CUDA error code
// of the launch (0 = launched).
extern "C" int dli_q4_matmul_rows(const void* x, const void* q, const void* s, void* y,
                                  void* part, int dtype, int R, int d_in, int G, int half,
                                  int d_out, int n_split, int gps, void* stream) {
  if (R <= 0 || R > 4 * MAX_RPT || G <= 0 || half <= 0 || half % 32 != 0 ||
      d_out <= 0 || d_out % TILE != 0 || d_in != 2 * half * G || n_split <= 0 ||
      gps <= 0 || (n_split - 1) * gps >= G || n_split * gps < G ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0: return (int)dispatch<float>(x, q, s, y, p, R, d_in, G, half, d_out, n_split, gps, st);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, q, s, y, p, R, d_in, G, half, d_out, n_split,
                                          gps, st);
    case 2: return (int)dispatch<__half>(x, q, s, y, p, R, d_in, G, half, d_out, n_split, gps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
