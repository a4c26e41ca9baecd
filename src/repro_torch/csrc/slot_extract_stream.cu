// Round extraction from the round's per-worker slab (streaming residency),
// for NVIDIA Hopper (sm_90a).  One tile body, two entry points:
//
//   slot_extract_stream replaces
//     repro/kernels/slot_extract.py::slot_extract_stream_pallas:
//     raw slab (W, R, 16*C) u8, worker w's chunk rows at slab[w];
//   slot_eval_decoded replaces
//     repro/kernels/slot_extract.py::slot_eval_decoded_pallas:
//     decoded slab (W, R, C) f32 from the parse-once cache, no parse.
//
// Both (kernel body _slot_extract_stream_kernel):
//   idx (W, B) i32 window rows, b_eff (W,) i32, m_before (W,) i32 scan
//   positions, coeffs/lo/hi (S, C) f32, is_count/gate/weights (S,) f32
//   ->  stats (W, S, 4) f32 = (m, Σx, Σx², Σp)
//   [+ cache rows (W, cap, C) f32: row m_before[w] + k holds window position
//      k for 0 <= m_before[w] + k < cap and k < min(B, b_eff[w]); every
//      other row is +0.0]
//
// The TPU kernel grids over row tiles of the slab and picks each tile's
// window rows with a 0/1 membership matmul, because a TPU core cannot
// gather rows.  Window rows are distinct, so a direct gather gives the same
// sums.
//
// What bounds it on the H100.  Not bytes: at W=4, B=4096, C=16, S=8,
// cap=128 the raw kernel reads 4 MiB of window rows and writes 32 KiB of
// cache rows, about 1.3 µs at 3.35 TB/s, the decoded one reads 1 MiB,
// about 0.35 µs; at the stream deployment's B = 8 they read 8 KiB and
// 2 KiB.  What is left is latency: the launch, the two dependent trips to
// device memory (window indices, then random rows) and the slot reductions
// of one short window.  The first port ran a (ceil(B/256), W) grid of
// 256-thread blocks whatever B was, one window row per thread read field
// after field (uncoalesced), one warp evaluating all S slots after
// another, a second launch for the block-order fold, and a fill kernel for
// the cache rows in the wrapper: 13.43 µs (decoded) and 16.72 µs (raw) at
// B = 8 in 2.68-3 device kernels per call (H100 80GB HBM3 at 700 W,
// chip_smoke.py).
//
// Design (slot_tile.cuh, the packed kernels' tile body with the slab as its
// row source).  One launch for every B: a block is one tile of 256 window
// positions of one worker, its slots shared over up to 16 warps.  A raw
// slab is a packed store whose chunk ids are the identity: its rows are
// staged with coalesced 16-byte cp.async and parsed as slot_extract.cu
// parses them.  A decoded row's C floats are copied with 4-byte cp.async
// (neighbouring threads on neighbouring floats) straight into the row
// buffer, whatever C is.  Sums follow slot_common.cuh's order, so a
// streamed raw round gives the bits of a packed round over the same rows,
// and a decoded round fed by extract_parse.cu (the same parse_field) the
// same bits again.  The cache rows are written by the block that holds the
// window position and, for every other row, by the worker's tile 0: no
// fill, no float atomics.  Widths C = 4 and 16 are compiled with the row in
// registers; any other C reads it from shared memory.  chip_smoke.py times
// both beside their bounds.

#include <limits.h>

#include "slot_tile.cuh"

using namespace slot;

namespace {

template <int CT, tile::Src kSrc>
__global__ void __launch_bounds__(32 * tile::kMaxWarps) slab_tiles(const tile::Args a) {
  tile::body<CT, false, kSrc>(a);
}

template <tile::Src kSrc>
int launch(const void* src, long long rows, int num_cols, const int* idx,
           const int* b_eff, const int* m_before, const float* coeffs,
           const float* lo, const float* hi, const float* is_count,
           const float* gate, const float* weights, int W, int B, int S,
           float* stats, float* cache, int cap, float* scratch, int* counters,
           void* stream) {
  static int smem_set[3];
  if (cap < 0 || (cap > 0) != (cache != nullptr) ||
      (long long)cap * num_cols > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (tile::tiles(B) > 1 && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  tile::Args a{};
  if constexpr (kSrc == tile::Src::kDecoded)
    a.dec = static_cast<const float*>(src);
  else
    a.packed = static_cast<const uint8_t*>(src);
  a.n_chunks = W;
  a.m_max = rows;
  a.C = num_cols;
  a.W = W;
  a.B = B;
  a.S = S;
  a.idx = idx;
  a.b_eff = b_eff;
  a.coeffs = coeffs;
  a.lo = lo;
  a.hi = hi;
  a.is_count = is_count;
  a.gate = gate;
  a.weights = weights;
  a.m_before = m_before;
  a.cache = cache;
  a.cap = cap;
  a.stats = stats;
  a.scratch = scratch;
  a.counters = counters;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_cols == 16)
    return tile::launch(slab_tiles<16, kSrc>, a, false, &smem_set[0], st, kSrc);
  if (num_cols == 4)
    return tile::launch(slab_tiles<4, kSrc>, a, false, &smem_set[1], st, kSrc);
  return tile::launch(slab_tiles<0, kSrc>, a, false, &smem_set[2], st, kSrc);
}

}  // namespace

extern "C" int slot_extract_stream_launch(
    const uint8_t* slab, long long rows, int num_cols, const int* idx,
    const int* b_eff, const int* m_before, const float* coeffs,
    const float* lo, const float* hi, const float* is_count,
    const float* gate, const float* weights, int W, int B, int S,
    float* stats, float* cache, int cap, float* scratch, int* counters,
    void* stream) {
  return launch<tile::Src::kSlab>(slab, rows, num_cols, idx, b_eff, m_before,
                                  coeffs, lo, hi, is_count, gate, weights, W,
                                  B, S, stats, cache, cap, scratch, counters,
                                  stream);
}

extern "C" int slot_eval_decoded_launch(
    const float* dec, long long rows, int num_cols, const int* idx,
    const int* b_eff, const int* m_before, const float* coeffs,
    const float* lo, const float* hi, const float* is_count,
    const float* gate, const float* weights, int W, int B, int S,
    float* stats, float* cache, int cap, float* scratch, int* counters,
    void* stream) {
  return launch<tile::Src::kDecoded>(dec, rows, num_cols, idx, b_eff,
                                     m_before, coeffs, lo, hi, is_count, gate,
                                     weights, W, B, S, stats, cache, cap,
                                     scratch, counters, stream);
}

extern "C" int slot_extract_stream_tile_rows() { return tile::kTileRows; }
