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
// its 16-byte fields with one 16-byte load each (int32 Horner over the 8
// integer and 6 fraction digits, then sign·(f32(ival) + f32(fval)·1e-6f),
// exactly the TPU kernel's arithmetic, with no FMA contraction), evaluates
// every slot (the linear expression in the plain version's summation
// order), and the block reduces its rows with warp shuffles and a
// fixed-order pass over warps.  A second kernel sums the per-block partials
// in block order.  There are no float atomics, so the result is the same
// from run to run.
//
// Bound on the card: at W=4, B=4096, C=16 the kernel reads 4 MiB of rows and
// writes 1 MiB of cols, about 1.6 µs at 3.35 TB/s; in practice the two
// launches' latency is the bound.  A thread reads its own 256-byte row, so
// neighbouring threads do not load neighbouring addresses (uncoalesced);
// staging rows through shared memory with coalesced loads is left for a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFieldBytes = 16;
constexpr int kIntDigits = 8;
constexpr int kFracDigits = 6;
constexpr int kThreads = 256;      // window rows per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int byte_at(const uint32_t w[4], int i) {
  return (w[i >> 2] >> ((i & 3) * 8)) & 0xff;
}

__device__ __forceinline__ float parse_field(uint4 q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  int ival = 0;
#pragma unroll
  for (int d = 0; d < kIntDigits; ++d) ival = ival * 10 + (byte_at(w, 1 + d) - '0');
  int fval = 0;
#pragma unroll
  for (int d = 0; d < kFracDigits; ++d)
    fval = fval * 10 + (byte_at(w, 2 + kIntDigits + d) - '0');
  const float sign = byte_at(w, 0) == '-' ? -1.0f : 1.0f;
  return __fmul_rn(sign, __fadd_rn((float)ival, __fmul_rn((float)fval, 1e-6f)));
}

// Σ_c v[c]·cf[c] in the plain version's order (kernels/ref.py, _lin in
// core/queries.py): four fused multiply-add chains, column c feeding chain
// c mod 4, combined pairwise.
__device__ __forceinline__ float linear(const float* v, const float* cf, int C) {
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  if (C > 0) c0 = __fmul_rn(v[0], cf[0]);
  if (C > 1) c1 = __fmul_rn(v[1], cf[1]);
  if (C > 2) c2 = __fmul_rn(v[2], cf[2]);
  if (C > 3) c3 = __fmul_rn(v[3], cf[3]);
  for (int c = 4; c < C; c += 4) {
    c0 = __fmaf_rn(v[c], cf[c], c0);
    if (c + 1 < C) c1 = __fmaf_rn(v[c + 1], cf[c + 1], c1);
    if (c + 2 < C) c2 = __fmaf_rn(v[c + 2], cf[c + 2], c2);
    if (c + 3 < C) c3 = __fmaf_rn(v[c + 3], cf[c + 3], c3);
  }
  const float a01 = C > 1 ? __fadd_rn(c0, c1) : c0;
  const float a23 = C > 3 ? __fadd_rn(c2, c3) : c2;
  return C > 2 ? __fadd_rn(a01, a23) : a01;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory layout (floats): coeffs, lo, hi (S*C each), is_count, gate
// (S each), per-thread parsed values (kThreads * cs), warp partials
// (kWarps * S * 4); then the per-slot budgets (S ints).
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
  const int cs = C | 1;  // odd stride: conflict-free per-thread rows
  float* s_coeffs = smem;
  float* s_lo = s_coeffs + S * C;
  float* s_hi = s_lo + S * C;
  float* s_isc = s_hi + S * C;
  float* s_gate = s_isc + S;
  float* s_vals = s_gate + S;
  float* s_red = s_vals + kThreads * cs;
  int* s_bs = reinterpret_cast<int*>(s_red + kWarps * S * 4);

  const int w = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int beff = b_eff[w];
  for (int i = tid; i < S * C; i += kThreads) {
    s_coeffs[i] = coeffs[i];
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  for (int s = tid; s < S; s += kThreads) {
    s_isc[s] = is_count[s];
    s_gate[s] = gate[s];
    const int cap = (int)ceilf(__fmul_rn(weights[s], (float)beff));
    s_bs[s] = cap < beff ? cap : beff;
  }

  // gather + parse this thread's window row
  const int k = blk * kThreads + tid;
  float* v = s_vals + tid * cs;
  const int j = jw[w];
  bool have = false;
  if (k < B && j >= 0 && j < n_chunks) {
    const int row = idx[(long long)w * B + k];
    if (row >= 0 && row < m_max) {
      have = true;
      const uint4* rec = reinterpret_cast<const uint4*>(
          packed + ((long long)j * m_max + row) * (long long)(C * kFieldBytes));
      for (int c = 0; c < C; ++c) v[c] = parse_field(rec[c]);
    }
  }
  if (!have)
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  if (cols != nullptr && k < B) {
    float* out = cols + ((long long)w * B + k) * C;
    for (int c = 0; c < C; ++c) out[c] = v[c];
  }
  __syncthreads();  // plan and budgets are in shared memory

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int s = 0; s < S; ++s) {
    const float* cf = s_coeffs + s * C;
    const float* l = s_lo + s * C;
    const float* h = s_hi + s * C;
    bool pred = true;
    for (int c = 0; c < C; ++c) pred = pred && (v[c] >= l[c]) && (v[c] < h[c]);
    const float expr = linear(v, cf, C);
    const float p = pred ? 1.0f : 0.0f;
    float x = s_isc[s] > 0.0f ? p : __fmul_rn(expr, p);
    const float ok = (k < B && k < s_bs[s]) ? 1.0f : 0.0f;
    const float mask = __fmul_rn(ok, s_gate[s]);
    x = __fmul_rn(x, mask);
    const float pm = __fmul_rn(p, mask);
    const float r0 = warp_sum(ok);
    const float r1 = warp_sum(x);
    const float r2 = warp_sum(__fmul_rn(x, x));
    const float r3 = warp_sum(pm);
    if (lane == 0) {
      float* dst = s_red + (warp * S + s) * 4;
      dst[0] = r0;
      dst[1] = r1;
      dst[2] = r2;
      dst[3] = r3;
    }
  }
  __syncthreads();
  const int nblk = gridDim.x;
  for (int t = tid; t < S * 4; t += kThreads) {
    float acc = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) acc += s_red[wp * S * 4 + t];
    partials[((long long)w * nblk + blk) * S * 4 + t] = acc;
  }
}

// stats[w, s, l] = Σ_blk partials[w, blk, s, l], summed in block order.
__global__ void slot_extract_reduce(const float* __restrict__ partials,
                                    int nblk, int S,
                                    float* __restrict__ stats) {
  const int w = blockIdx.x;
  for (int t = threadIdx.x; t < S * 4; t += blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < nblk; ++b)
      acc += partials[((long long)w * nblk + b) * S * 4 + t];
    stats[(long long)w * S * 4 + t] = acc;
  }
}

}  // namespace

extern "C" size_t slot_extract_smem_bytes(int num_cols, int S) {
  const int cs = num_cols | 1;
  return sizeof(float) * (3 * (size_t)S * num_cols + 2 * (size_t)S +
                          (size_t)kThreads * cs + (size_t)kWarps * S * 4) +
         sizeof(int) * (size_t)S;
}

extern "C" int slot_extract_launch(
    const uint8_t* packed, long long n_chunks, long long m_max, int num_cols,
    const int* jw, const int* idx, const int* b_eff, const float* coeffs,
    const float* lo, const float* hi, const float* is_count, const float* gate,
    const float* weights, int W, int B, int S, float* partials, float* stats,
    float* cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (B + kThreads - 1) / kThreads;
  const size_t smem = slot_extract_smem_bytes(num_cols, S);
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
  const int threads = S * 4 < 1024 ? ((S * 4 + 31) / 32) * 32 : 1024;
  slot_extract_reduce<<<W, threads, 0, st>>>(partials, nblk, S, stats);
  return (int)cudaGetLastError();
}

extern "C" int slot_extract_threads_per_block() { return kThreads; }
