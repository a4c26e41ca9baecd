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
// Design.  The TPU kernel runs one grid step per worker; with W = 4 that
// would leave most of the 132 SMs idle.  The grid is (ceil(B / 256), W), one
// row per thread, with the body chunk_agg.cu runs (slot_common.cuh's
// rows_block: the round kernels' parse and evaluation, warp shuffles, a
// fixed-order pass over warps) and a second kernel summing the per-block
// partials in block order.  No float atomics.
//
// Bound on the card: at W=4, B=4096, C=16 the kernel reads 4 MiB of rows,
// about 1.25 µs at 3.35 TB/s; in practice the two launches' latency bounds
// it.

#include "slot_common.cuh"

using namespace slot;

namespace {

__global__ void round_stats_blocks(const uint8_t* __restrict__ slab, long long B,
                                   int num_cols, const int* __restrict__ b_eff,
                                   const float* __restrict__ coeffs,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ hi, int Q,
                                   float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int w = blockIdx.y;
  const uint8_t* rows = slab + (long long)w * B * (num_cols * kFieldBytes);
  rows_block(smem, rows, B, b_eff[w], num_cols, coeffs, lo, hi, Q,
             partials + ((long long)w * gridDim.x + blockIdx.x) * Q * 4);
}

}  // namespace

extern "C" int round_stats_launch(const uint8_t* slab, int W, long long B,
                                  int num_cols, const int* b_eff,
                                  const float* coeffs, const float* lo,
                                  const float* hi, int Q, float* partials,
                                  float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblk = (B + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(num_cols, Q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        round_stats_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  round_stats_blocks<<<dim3((unsigned int)nblk, W), kThreads, smem, st>>>(
      slab, B, num_cols, b_eff, coeffs, lo, hi, Q, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<W, reduce_threads(Q), 0, st>>>(partials, (int)nblk, Q, out);
  return (int)cudaGetLastError();
}

extern "C" int round_stats_threads_per_block() { return kThreads; }
