// Fused round extraction for one engine round: gather + ASCII parse + slot
// evaluation + per-(worker, slot) sufficient statistics, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/slot_extract.py::slot_extract_pallas
// (kernel body _slot_extract_kernel).  Same contract:
//   packed (N, M_max, 16*C) u8, jw (W,) i32 chunk ids, idx (W, B) i32 window
//   rows, b_eff (W,) i32, coeffs/lo/hi (S, C) f32, is_count/gate/weights (S,)
//   f32  ->  stats (W, S, 4) f32 = (m, Σx, Σx², Σp)  [+ cols (W, B, C) f32]
// Slot s counts window position k iff k < min(ceil(f32(w_s)·f32(b_eff)),
// b_eff); the gate multiplies x and p (not the m lane).
//
// What bounds it on the H100.  Not bytes: at W=4, B=4096, C=16 the kernel
// reads 4 MiB of rows and writes 1 MiB of cols, 1.6 µs at 3.35 TB/s; at the
// deployments' B = 8 it reads 8 KiB.  What is left is latency: the launch,
// the two dependent trips to device memory (window indices, then random
// rows), the parse and the slot reductions of one short window, and, past
// one tile, the fold across tiles.  The first port ran two launches (blocks,
// then a block-order pass over their partials), a 256-thread block whatever
// B was, one warp evaluating all S slots after another, and had each thread
// read its own 256-byte row field after field: 17.0-17.4 µs at B = 8
// (H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// Design (slot_tile.cuh).  One launch for every B.  A block is one tile of
// 256 window positions of one worker: a warp per 32 of its positions,
// repeated so that the slots are shared over up to 16 warps (B = 8: eight
// warps, one slot each).  It reads the window indices, then puts every
// 16-byte field of every live row in flight at once with cp.async
// (coalesced: neighbouring threads copy neighbouring words of a row) and
// loads the plan meanwhile; each thread parses the words it copied.  The
// range predicate is taken without branches.  Sums follow slot_common.cuh's
// order (warp shuffles, warps in order, tiles in order): a one-tile window
// is written directly, a longer one is folded by the worker's last block
// through an integer counter.  No float atomics: the bits repeat from run
// to run and equal slot_extract_stream.cu's on the same rows.  The decoded
// window (cols) is written coalesced from shared memory.  Widths C = 4 and
// 16 are compiled with the row in registers; any other C reads it from
// shared memory.  chip_smoke.py times it beside its bound.

#include "slot_tile.cuh"

using namespace slot;

namespace {

template <int CT>
__global__ void __launch_bounds__(32 * tile::kMaxWarps) slot_extract_tiles(const tile::Args a) {
  tile::body<CT, false>(a);
}

int smem_set[3];

}  // namespace

extern "C" int slot_extract_launch(
    const uint8_t* packed, long long n_chunks, long long m_max, int num_cols,
    const int* jw, const int* idx, const int* b_eff, const float* coeffs,
    const float* lo, const float* hi, const float* is_count, const float* gate,
    const float* weights, int W, int B, int S, float* stats, float* cols,
    float* scratch, int* counters, void* stream) {
  tile::Args a{};
  a.packed = packed;
  a.n_chunks = n_chunks;
  a.m_max = m_max;
  a.C = num_cols;
  a.W = W;
  a.B = B;
  a.S = S;
  a.jw = jw;
  a.idx = idx;
  a.b_eff = b_eff;
  a.coeffs = coeffs;
  a.lo = lo;
  a.hi = hi;
  a.is_count = is_count;
  a.gate = gate;
  a.weights = weights;
  a.stats = stats;
  a.cols = cols;
  a.scratch = scratch;
  a.counters = counters;
  if (tile::tiles(B) > 1 && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_cols == 16) return tile::launch(slot_extract_tiles<16>, a, false, &smem_set[0], st);
  if (num_cols == 4) return tile::launch(slot_extract_tiles<4>, a, false, &smem_set[1], st);
  return tile::launch(slot_extract_tiles<0>, a, false, &smem_set[2], st);
}

extern "C" int slot_extract_tile_rows() { return tile::kTileRows; }
