// Budget-masked statistics of a pre-gathered round slab for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/round_stats.py::round_stats_pallas
// (kernel body _round_stats_kernel).  Same contract:
//   slab (W, B, 16*C) u8 (each worker's window rows, already gathered in
//   permutation order), b_eff (W,) i32, coeffs/lo/hi (Q, C) f32
//   -> out (W, Q, 4) f32 = (m, Σx, Σx², Σp) over rows < b_eff[w]; the count
//      lane is the same for every plan.
//
// The TPU kernel runs one grid step per worker; with W = 4 that would leave
// most of the 132 SMs idle.  The body is chunk_agg.cu's (rows_tile.cuh):
// one launch, grid (P, W), each worker's rows split over P blocks of one
// step or a few (P = 32 at B = 4096), the worker's last block folding the
// partials in order.  Bound on the card: at W = 4, B = 4096, C = 16 the
// kernel reads 4 MiB of rows, about 1.25 µs at 3.35 TB/s; the launch and
// the two dependent trips (rows, then the fold's partials) bound it.

#include "rows_tile.cuh"

using namespace slot;

namespace {

template <int CT>
__global__ void __launch_bounds__(rows::kThreads, rows::kMinBlocks)
    round_stats_rows(const rows::Args a) {
  rows::body<CT>(a);
}

rows::Kernels kernels{{round_stats_rows<16>, round_stats_rows<4>, round_stats_rows<0>}, {0, 0, 0}};

}  // namespace

extern "C" int round_stats_launch(const uint8_t* slab, int W, long long B, int num_cols,
                                  const int* b_eff, const float* coeffs, const float* lo,
                                  const float* hi, int Q, int blocks, long long block_rows,
                                  int step_rows, float* out, float* scratch, int* counters,
                                  void* stream) {
  const rows::Args a{slab, b_eff, coeffs, lo, hi, out, scratch, counters,
                     B, block_rows, num_cols, Q, step_rows};
  return rows::launch(kernels, a, W, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int round_stats_blocks_per_sm(int num_cols, int Q, int step_rows) {
  return rows::blocks_per_sm(kernels, num_cols, Q, step_rows);
}

extern "C" int round_stats_threads_per_block() { return rows::kThreads; }
