// Full-chunk pass for NVIDIA Hopper (sm_90a): parse every record of every
// chunk, evaluate Q linear plans, and sum per (chunk, plan).
//
// Replaces the TPU kernel repro/kernels/chunk_agg.py::chunk_agg_pallas
// (kernel body _chunk_agg_kernel).  Same contract:
//   raw (N, M, 16*C) u8, sizes (N,) i32, coeffs/lo/hi (Q, C) f32
//   -> out (N, Q, 4) f32 = (rows valid, Σx, Σx², Σp) over the first
//      sizes[j] rows of chunk j; the count lane is the same for every plan.
//
// Design.  The TPU grid walks each chunk's row tiles in order and
// accumulates into the chunk's output block.  Here blocks run in parallel:
// the grid is (ceil(M / 256), N), one record per thread, parsed and
// evaluated with slot_common.cuh's functions (the round kernels'
// arithmetic), each block reducing its rows with warp shuffles and a
// fixed-order pass over warps into a (N, nblk, Q, 4) scratch, and a second
// kernel summing the partials in block order.  No float atomics.
//
// Bound on the card: the whole store is read once, 2 GiB for the 8.4M-row,
// 16-column deployment: 0.64 ms at 3.35 TB/s.  A thread reads its own
// 256-byte record (uncoalesced); staging rows through shared memory with
// coalesced loads is left for a later change.

#include "slot_common.cuh"

using namespace slot;

namespace {

__global__ void chunk_agg_blocks(const uint8_t* __restrict__ raw, long long m_rows,
                                 int num_cols, const int* __restrict__ sizes,
                                 const float* __restrict__ coeffs,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ hi, int Q,
                                 float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int j = blockIdx.y;
  const uint8_t* chunk = raw + (long long)j * m_rows * (num_cols * kFieldBytes);
  rows_block(smem, chunk, m_rows, sizes[j], num_cols, coeffs, lo, hi, Q,
             partials + ((long long)j * gridDim.x + blockIdx.x) * Q * 4);
}

}  // namespace

extern "C" int chunk_agg_launch(const uint8_t* raw, int N, long long m_rows,
                                int num_cols, const int* sizes, const float* coeffs,
                                const float* lo, const float* hi, int Q,
                                float* partials, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblk = (m_rows + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(num_cols, Q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_agg_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chunk_agg_blocks<<<dim3((unsigned int)nblk, N), kThreads, smem, st>>>(
      raw, m_rows, num_cols, sizes, coeffs, lo, hi, Q, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<N, reduce_threads(Q), 0, st>>>(partials, (int)nblk, Q, out);
  return (int)cudaGetLastError();
}

extern "C" int chunk_agg_threads_per_block() { return kThreads; }
