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
// Design.  The TPU kernel runs one grid step per worker and pulls the whole
// chunk into VMEM; with W = 4 that would leave 128 of the 132 SMs idle.
// Here the grid is (ceil(B/TB), W): each thread owns one window row, parses
// its 16-byte fields with one 16-byte load each (slot_common.cuh:
// parse_field, the TPU kernel's arithmetic), evaluates every slot (the
// linear expression in the plain version's summation order), and the block
// reduces its rows with warp shuffles and a fixed-order pass over warps.  A
// second kernel sums the per-block partials in block order.  There are no
// float atomics, so the result is the same from run to run, and the same
// bits as slot_extract_stream.cu gives for the same rows.
//
// Bound on the card: at W=4, B=4096, C=16 the kernel reads 4 MiB of rows and
// writes 1 MiB of cols, about 1.6 µs at 3.35 TB/s; in practice the two
// launches' latency is the bound.  A thread reads its own 256-byte row, so
// neighbouring threads do not load neighbouring addresses (uncoalesced);
// staging rows through shared memory with coalesced loads is left for a
// later change.

#include "slot_common.cuh"

using namespace slot;

namespace {

__global__ void slot_extract_blocks(
    const uint8_t* __restrict__ packed, long long n_chunks, long long m_max,
    int num_cols, const int* __restrict__ jw, const int* __restrict__ idx,
    const int* __restrict__ b_eff, const float* __restrict__ coeffs,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ is_count, const float* __restrict__ gate,
    const float* __restrict__ weights, int B, int S,
    float* __restrict__ partials, float* __restrict__ cols) {
  extern __shared__ float smem[];
  const int C = num_cols;
  const Smem m = carve(smem, C, S);
  const int w = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  load_plan(m, coeffs, lo, hi, is_count, gate, weights, b_eff[w], C, S);

  // gather + parse this thread's window row
  const int k = blk * kThreads + tid;
  float* v = m.vals + tid * m.cs;
  const int j = jw[w];
  bool have = false;
  if (k < B && j >= 0 && j < n_chunks) {
    const int row = idx[(long long)w * B + k];
    if (row >= 0 && row < m_max) {
      have = true;
      parse_record(packed + ((long long)j * m_max + row) * (long long)(C * kFieldBytes),
                   C, v);
    }
  }
  if (!have)
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  if (cols != nullptr && k < B) {
    float* out = cols + ((long long)w * B + k) * C;
    for (int c = 0; c < C; ++c) out[c] = v[c];
  }
  eval_reduce(m, v, k, B, C, S, partials + ((long long)w * gridDim.x + blk) * S * 4);
}

}  // namespace

extern "C" size_t slot_extract_smem_bytes(int num_cols, int S) {
  return smem_bytes(num_cols, S);
}

extern "C" int slot_extract_launch(
    const uint8_t* packed, long long n_chunks, long long m_max, int num_cols,
    const int* jw, const int* idx, const int* b_eff, const float* coeffs,
    const float* lo, const float* hi, const float* is_count, const float* gate,
    const float* weights, int W, int B, int S, float* partials, float* stats,
    float* cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (B + kThreads - 1) / kThreads;
  const size_t smem = smem_bytes(num_cols, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        slot_extract_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  slot_extract_blocks<<<dim3(nblk, W), kThreads, smem, st>>>(
      packed, n_chunks, m_max, num_cols, jw, idx, b_eff, coeffs, lo, hi,
      is_count, gate, weights, B, S, partials, cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials<<<W, reduce_threads(S), 0, st>>>(partials, nblk, S, stats);
  return (int)cudaGetLastError();
}

extern "C" int slot_extract_threads_per_block() { return kThreads; }
