// GQA attention over the block-paged KV pool: T=1 decode
// (`paged_flash_attend`) and the mixed prefill + decode launch
// (`ragged_paged_attend`), one entry point each.
//
// Replaces: the Pallas TPU kernels `_paged_kernel` (launched by
// `paged_flash_attend` through pl.pallas_call at :252) and
// `_ragged_kernel` (:482, launched by `ragged_paged_attend` through
// pl.pallas_call at :684, live range `_ragged_live_range` :465) in the JAX
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
//     kind), the row clamped to [0, R). Query t of the tile (t < q_len)
//     sits at absolute position q_start + t of fleet row `row` and attends
//     that row's keys at positions <= its own and < MB * bs (and, with a
//     window, > q_pos - win). A tile with q_len == 0 (launch padding) and
//     rows with t >= q_len output zeros.
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
// FLOPs per byte for tinyllama (H/KV = 8), and a full tile of tq = 8
// prompt queries ~8x that: far below the ~295 at which the bf16 tensor
// cores stop being memory-bound, so decode and mixed launches are bound by
// BYTES (~0.7 us at the mixed launch's width 128). At the fleet's sizes
// what holds them back is how many SMs read at once: one block per (row
// or query tile, KV head) puts 32 (decode, B = 8) or 64 (mixed, 16 tiles)
// blocks on 132 SMs, each walking up to 16 key tiles one after another.
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
//   * ragged: the tensor-core flash walk of csrc/flash_walk.cuh (its
//     note), the one `flash_attend` runs, with the `PagedTable` policy: a
//     block owns the tile's tq x group folded query rows (64 at tinyllama's
//     8 x 8) of one KV head, reads meta[g], the window and the table row on
//     the device (the mixed step rewrites meta on the card,
//     engine/paged.apply_device_meta, and the host never reads it), and is
//     one rank of a thread-block cluster that splits the tile's live key
//     tiles on the 64-key grid. `ragged_plan` (ops/paged_attention.py)
//     fixes the cluster on the host from the shapes alone so that G * KV *
//     cluster covers the SMs (4 at the fleet's G = 16, KV = 4); the ranks
//     of a tile with fewer than `min_share` live tiles each agree on the
//     device to walk with fewer ranks (a one- or two-tile tile with one
//     rank, no merge), since they all read the same meta[g]. The tile's
//     pool block ids are loaded once per pool block into a shared slot per
//     ring stage, a tile ahead; K/V tiles ride a 2-3 stage cp.async ring;
//     bf16 / fp16 products on the tensor cores (mma.sync.m16n8k16, Q in
//     registers, K by ldmatrix, V by ldmatrix.trans), fp32 on CUDA-core
//     FMAs; an int8 pool's rows and scales ride the ring at half the bytes
//     and are dequantized as q8 * s in fp32, then rounded to the product's
//     type: the rounding point of `flash_attend`'s int8 cache, whose error
//     bound the header's note gives. A dead tile (q_len = 0) reads no K/V
//     and writes zeros; a warp whose rows are all dead skips the walk. One
//     launch, no workspace, the ranks merged in a fixed order: repeats are
//     bit-equal and the fleet's mixed launch captures the call in its CUDA
//     graph.

#include "decode_walk.cuh"
#include "flash_walk.cuh"

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out). Pools
// [N, KV, bs, Dh] of that dtype, or int8 with k_scale / v_scale fp32
// [N, KV, bs] (both null for a raw pool); win_dyn: one int32 on the
// device that overrides win_static, or null; a width <= 0 means full
// causal. softcap <= 0 means off. Each launches on `stream` and returns
// the CUDA error code of the launch (0 = launched).

// Mixed prefill + decode: q / out [G * tq, H, Dh], tables [R, MB] int32,
// meta [G, 4] int32. bn, stages, cluster, min_share: the host's plan
// (ops/paged_attention.py `ragged_plan`): keys per tile and ring depth,
// which must equal this build's for the shapes, the cluster size (1, 2, 4
// or 8) that splits each query tile's live keys, and the live tiles each
// rank keeps at least (0: every rank walks its share).
extern "C" int dli_ragged_paged_attend(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, int dtype, int G, int tq, int H, int KV,
    int N, int bs, int R, int MB, int Dh, const int* table, const int* meta,
    int win_static, const int* win_dyn, float scale, float softcap, int bn,
    int stages, int cluster, int min_share, void* stream) {
  if (N <= 0 || bs <= 0 || MB <= 0 || R <= 0 || table == nullptr || meta == nullptr ||
      (long long)MB * bs > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  fw::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = out;
  a.table = table;
  a.meta = meta;
  a.win_dyn = win_dyn;
  a.B = G;
  a.T = tq;
  a.H = H;
  a.KV = KV;
  a.Dh = Dh;
  a.S = MB * bs;
  a.N = N;
  a.bs = bs;
  a.MB = MB;
  a.R = R;
  a.win_static = win_static;
  a.cluster = cluster;
  a.min_share = min_share;
  a.scale = scale;
  a.softcap = softcap;
  return fw::run<fw::PagedTable>(a, dtype, bn, stages, stream);
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
