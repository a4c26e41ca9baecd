// Round extraction from the round's per-worker slab (streaming residency),
// for NVIDIA Hopper (sm_90a).  One kernel template, two entry points:
//
//   slot_extract_stream (kDecoded = false) replaces
//     repro/kernels/slot_extract.py::slot_extract_stream_pallas:
//     raw slab (W, R, 16*C) u8, worker w's chunk rows at slab[w];
//   slot_eval_decoded (kDecoded = true) replaces
//     repro/kernels/slot_extract.py::slot_eval_decoded_pallas:
//     decoded slab (W, R, C) f32 from the parse-once cache, no parse.
//
// Both (kernel body _slot_extract_stream_kernel):
//   idx (W, B) i32 window rows, b_eff (W,) i32, m_before (W,) i32 scan
//   positions, coeffs/lo/hi (S, C) f32, is_count/gate/weights (S,) f32
//   ->  stats (W, S, 4) f32 = (m, Σx, Σx², Σp)
//   [+ cache rows (W, cap, C) f32: row m_before[w] + k holds window position
//      k for 0 <= m_before[w] + k < cap and k < b_eff[w]; every other row
//      stays as the caller zeroed it]
//
// Design.  The TPU kernel grids over row tiles of the slab and picks each
// tile's window rows with a 0/1 membership matmul, because a TPU core
// cannot gather rows.  Window rows are distinct, so a direct gather gives
// the same sums: here the grid is (ceil(B/TB), W) with one window row per
// thread, and the parse, slot evaluation, warp and block reduction and the
// block-order second pass are slot_common.cuh's, whose order slot_extract.cu
// keeps too.  A streamed raw round therefore gives the same float
// bits as a packed round over the same rows, and a decoded round fed by
// extract_parse.cu (the same parse_field) the same bits again.  The cache
// rows are written by the thread that holds the window position; no float
// atomics anywhere.
//
// Bound on the card at W=4, B=4096, C=16, S=8, cap=128: the raw kernel
// reads 4 MiB of window rows and writes 32 KiB of cache rows, about 1.3 µs
// at 3.35 TB/s; the decoded kernel reads 1 MiB of decoded rows, about
// 0.35 µs.  At the deployment's B = 8 the two launches' latency is the
// bound.  Row loads are uncoalesced (one thread, one record);
// slot_tile.cuh stages rows coalesced with cp.async.

#include "slot_common.cuh"

using namespace slot;

namespace {

template <bool kDecoded>
__global__ void stream_blocks(
    const void* __restrict__ slab, long long rows, int num_cols,
    const int* __restrict__ idx, const int* __restrict__ b_eff,
    const int* __restrict__ m_before, const float* __restrict__ coeffs,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ is_count, const float* __restrict__ gate,
    const float* __restrict__ weights, int B, int S,
    float* __restrict__ partials, float* __restrict__ cache, int cap) {
  extern __shared__ float smem[];
  const int C = num_cols;
  const Smem m = carve(smem, C, S);
  const int w = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int beff = b_eff[w];
  load_plan(m, coeffs, lo, hi, is_count, gate, weights, beff, C, S);

  // gather (+ parse) this thread's window row from the worker's slab
  const int k = blk * kThreads + tid;
  float* v = m.vals + tid * m.cs;
  bool have = false;
  if (k < B) {
    const int row = idx[(long long)w * B + k];
    if (row >= 0 && row < rows) {
      have = true;
      const long long r = (long long)w * rows + row;
      if constexpr (kDecoded) {
        const float* src = static_cast<const float*>(slab) + r * C;
        for (int c = 0; c < C; ++c) v[c] = src[c];
      } else {
        parse_record(static_cast<const uint8_t*>(slab) + r * (long long)(C * kFieldBytes),
                     C, v);
      }
    }
  }
  if (!have)
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  if (cache != nullptr && k < B && k < beff) {
    const int crow = m_before[w] + k;
    if (crow >= 0 && crow < cap) {
      float* out = cache + ((long long)w * cap + crow) * C;
      for (int c = 0; c < C; ++c) out[c] = v[c];
    }
  }
  eval_reduce(m, v, k, B, C, S, partials + ((long long)w * gridDim.x + blk) * S * 4);
}

template <bool kDecoded>
int launch(const void* slab, long long rows, int num_cols, const int* idx,
           const int* b_eff, const int* m_before, const float* coeffs,
           const float* lo, const float* hi, const float* is_count,
           const float* gate, const float* weights, int W, int B, int S,
           float* partials, float* stats, float* cache, int cap,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (B + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(num_cols, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stream_blocks<kDecoded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stream_blocks<kDecoded><<<dim3(nblk, W), kThreads, smem, st>>>(
      slab, rows, num_cols, idx, b_eff, m_before, coeffs, lo, hi, is_count,
      gate, weights, B, S, partials, cache, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<W, reduce_threads(S), 0, st>>>(partials, nblk, S, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slot_extract_stream_launch(
    const uint8_t* slab, long long rows, int num_cols, const int* idx,
    const int* b_eff, const int* m_before, const float* coeffs,
    const float* lo, const float* hi, const float* is_count,
    const float* gate, const float* weights, int W, int B, int S,
    float* partials, float* stats, float* cache, int cap, void* stream) {
  return launch<false>(slab, rows, num_cols, idx, b_eff, m_before, coeffs, lo,
                       hi, is_count, gate, weights, W, B, S, partials, stats,
                       cache, cap, stream);
}

extern "C" int slot_eval_decoded_launch(
    const float* dec, long long rows, int num_cols, const int* idx,
    const int* b_eff, const int* m_before, const float* coeffs,
    const float* lo, const float* hi, const float* is_count,
    const float* gate, const float* weights, int W, int B, int S,
    float* partials, float* stats, float* cache, int cap, void* stream) {
  return launch<true>(dec, rows, num_cols, idx, b_eff, m_before, coeffs, lo,
                      hi, is_count, gate, weights, W, B, S, partials, stats,
                      cache, cap, stream);
}

extern "C" int slot_extract_stream_threads_per_block() { return kThreads; }
