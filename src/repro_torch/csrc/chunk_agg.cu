// Full-chunk pass for NVIDIA Hopper (sm_90a): parse every record of every
// chunk, evaluate Q linear plans, and sum per (chunk, plan).
//
// Replaces the TPU kernel repro/kernels/chunk_agg.py::chunk_agg_pallas
// (kernel body _chunk_agg_kernel).  Same contract:
//   raw (N, M, 16*C) u8, sizes (N,) i32, coeffs/lo/hi (Q, C) f32
//   -> out (N, Q, 4) f32 = (rows valid, Σx, Σx², Σp) over the first
//      sizes[j] rows of chunk j; the count lane is the same for every plan.
//
// The TPU grid walks each chunk's row tiles in order and accumulates into
// the chunk's output block.  Here the body is rows_tile.cuh's (one launch,
// grid (P, N): each chunk split over P blocks that stage contiguous rows
// through a ring and keep their sums in registers, the chunk's last block
// folding the P partials in order).  Bound on the card: the whole store is
// read once, 2 GiB for the 8.4M-row, 16-column deployment, 0.64 ms at
// 3.35 TB/s.

#include "rows_tile.cuh"

using namespace slot;

namespace {

template <int CT>
__global__ void __launch_bounds__(rows::kThreads, rows::kMinBlocks)
    chunk_agg_rows(const rows::Args a) {
  rows::body<CT>(a);
}

rows::Kernels kernels{{chunk_agg_rows<16>, chunk_agg_rows<4>, chunk_agg_rows<0>}, {0, 0, 0}};

}  // namespace

extern "C" int chunk_agg_launch(const uint8_t* raw, int N, long long m_rows, int num_cols,
                                const int* sizes, const float* coeffs, const float* lo,
                                const float* hi, int Q, int blocks, long long block_rows,
                                int step_rows, float* out, float* scratch, int* counters,
                                void* stream) {
  const rows::Args a{raw, sizes, coeffs, lo, hi, out, scratch, counters,
                     m_rows, block_rows, num_cols, Q, step_rows};
  return rows::launch(kernels, a, N, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int chunk_agg_blocks_per_sm(int num_cols, int Q, int step_rows) {
  return rows::blocks_per_sm(kernels, num_cols, Q, step_rows);
}

extern "C" int chunk_agg_threads_per_block() { return rows::kThreads; }
