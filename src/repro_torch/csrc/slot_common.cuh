// Device functions shared by the round-extraction kernels (slot_extract.cu,
// slot_extract_stream.cu, slot_extract_grouped.cu), the parse kernel
// (extract_parse.cu) and the rows kernels (chunk_agg.cu, round_stats.cu), so
// that every kernel parses a field, evaluates a slot and reduces a window
// with the same instructions in the same order.  A packed round, a streamed
// raw round and a decoded round over the same rows therefore give the same
// float bits, and a grouped round's tracked cells the bits of the fan-out
// slots that carry the group conjunct.
//
// Record layout: fixed-width ASCII, 16 bytes a field (sign, 8 integer
// digits, '.', 6 fraction digits); one 16-byte load per field.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slot {

constexpr int kFieldBytes = 16;
constexpr int kIntDigits = 8;
constexpr int kFracDigits = 6;
constexpr int kThreads = 256;      // window rows per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int byte_at(const uint32_t w[4], int i) {
  return (w[i >> 2] >> ((i & 3) * 8)) & 0xff;
}

// The TPU kernel's arithmetic: int32 Horner over the 8 integer and 6
// fraction digits, then sign·(f32(ival) + f32(fval)·1e-6f), each operation
// rounded once (no FMA contraction).
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

// Parse one record of C fields into v[0..C).
__device__ __forceinline__ void parse_record(const uint8_t* rec, int C, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(rec);
  for (int c = 0; c < C; ++c) v[c] = parse_field(q[c]);
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

// Shared memory of one block (floats): coeffs, lo, hi (S*C each), is_count,
// gate (S each), per-thread parsed values (kThreads * cs), warp partials
// (kWarps * S * 4); then the per-slot budgets (S ints).
struct Smem {
  float* coeffs;
  float* lo;
  float* hi;
  float* isc;
  float* gate;
  float* vals;
  float* red;
  int* bs;
  int cs;  // odd row stride of vals: conflict-free per-thread rows
};

inline size_t smem_bytes(int C, int S) {
  const int cs = C | 1;
  return sizeof(float) * (3 * (size_t)S * C + 2 * (size_t)S + (size_t)kThreads * cs +
                          (size_t)kWarps * S * 4) +
         sizeof(int) * (size_t)S;
}

__device__ __forceinline__ Smem carve(float* smem, int C, int S) {
  Smem m;
  m.cs = C | 1;
  m.coeffs = smem;
  m.lo = m.coeffs + S * C;
  m.hi = m.lo + S * C;
  m.isc = m.hi + S * C;
  m.gate = m.isc + S;
  m.vals = m.gate + S;
  m.red = m.vals + kThreads * m.cs;
  m.bs = reinterpret_cast<int*>(m.red + kWarps * S * 4);
  return m;
}

// The slot plan and this worker's per-slot counted budgets
// min(ceil(f32(w_s)·f32(b_eff)), b_eff) into shared memory.
__device__ __forceinline__ void load_plan(const Smem& m, const float* __restrict__ coeffs,
                                          const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          const float* __restrict__ is_count,
                                          const float* __restrict__ gate,
                                          const float* __restrict__ weights, int beff,
                                          int C, int S) {
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    m.coeffs[i] = coeffs[i];
    m.lo[i] = lo[i];
    m.hi[i] = hi[i];
  }
  for (int s = threadIdx.x; s < S; s += kThreads) {
    m.isc[s] = is_count[s];
    m.gate[s] = gate[s];
    const int cap = (int)ceilf(__fmul_rn(weights[s], (float)beff));
    m.bs[s] = cap < beff ? cap : beff;
  }
}

// Slot s on this thread's row v (window position k): the counted flag ok
// (k inside the slot's budget), the mask ok·gate, and the masked value x
// and indicator pm that the four sums add up.
struct SlotTerms {
  float ok, mask, x, pm;
};

__device__ __forceinline__ SlotTerms slot_terms(const Smem& m, const float* v, int k,
                                                int B, int C, int s) {
  const float* cf = m.coeffs + s * C;
  const float* l = m.lo + s * C;
  const float* h = m.hi + s * C;
  bool pred = true;
  for (int c = 0; c < C; ++c) pred = pred && (v[c] >= l[c]) && (v[c] < h[c]);
  const float expr = linear(v, cf, C);
  const float p = pred ? 1.0f : 0.0f;
  SlotTerms t;
  float x = m.isc[s] > 0.0f ? p : __fmul_rn(expr, p);
  t.ok = (k < B && k < m.bs[s]) ? 1.0f : 0.0f;
  t.mask = __fmul_rn(t.ok, m.gate[s]);
  t.x = __fmul_rn(x, t.mask);
  t.pm = __fmul_rn(p, t.mask);
  return t;
}

// Evaluate every slot on this thread's row v (window position k) and write
// the block's (S, 4) partial sums (m, Σx, Σx², Σp) to out: warp shuffles,
// then a fixed-order pass over the warps.  Call after load_plan, with the
// whole block: it synchronises.
__device__ __forceinline__ void eval_reduce(const Smem& m, const float* v, int k, int B,
                                            int C, int S, float* __restrict__ out) {
  __syncthreads();  // plan and budgets are in shared memory
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int s = 0; s < S; ++s) {
    const SlotTerms t = slot_terms(m, v, k, B, C, s);
    const float r0 = warp_sum(t.ok);
    const float r1 = warp_sum(t.x);
    const float r2 = warp_sum(__fmul_rn(t.x, t.x));
    const float r3 = warp_sum(t.pm);
    if (lane == 0) {
      float* dst = m.red + (warp * S + s) * 4;
      dst[0] = r0;
      dst[1] = r1;
      dst[2] = r2;
      dst[3] = r3;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S * 4; t += kThreads) {
    float acc = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) acc += m.red[wp * S * 4 + t];
    out[t] = acc;
  }
}

// The plan of a rows pass (chunk_agg.cu, round_stats.cu): Q linear plans,
// none a COUNT slot, all gated on, each counting the first `valid` rows.
__device__ __forceinline__ void load_plan_rows(const Smem& m,
                                               const float* __restrict__ coeffs,
                                               const float* __restrict__ lo,
                                               const float* __restrict__ hi,
                                               int valid, int C, int S) {
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    m.coeffs[i] = coeffs[i];
    m.lo[i] = lo[i];
    m.hi[i] = hi[i];
  }
  for (int s = threadIdx.x; s < S; s += kThreads) {
    m.isc[s] = 0.0f;
    m.gate[s] = 1.0f;
    m.bs[s] = valid;
  }
}

// One block of a rows pass over `rows` consecutive records at `src`: thread
// t parses record blockIdx.x·kThreads + t when it is among the first
// `valid`, every plan is evaluated on it, and the block writes its (S, 4)
// partial sums (rows counted, Σx, Σx², Σp) to out.
__device__ __forceinline__ void rows_block(float* smem, const uint8_t* __restrict__ src,
                                           long long rows, int valid, int C,
                                           const float* __restrict__ coeffs,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi, int S,
                                           float* __restrict__ out) {
  const Smem m = carve(smem, C, S);
  if (valid < 0) valid = 0;
  if ((long long)valid > rows) valid = (int)rows;
  load_plan_rows(m, coeffs, lo, hi, valid, C, S);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  float* v = m.vals + threadIdx.x * m.cs;
  if (k < valid)
    parse_record(src + (long long)k * (C * kFieldBytes), C, v);
  else
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  eval_reduce(m, v, k, valid, C, S, out);
}

// stats[w, s, l] = Σ_blk partials[w, blk, s, l], summed in block order.
__global__ void reduce_partials(const float* __restrict__ partials, int nblk, int S,
                                float* __restrict__ stats) {
  const int w = blockIdx.x;
  for (int t = threadIdx.x; t < S * 4; t += blockDim.x) {
    float acc = 0.0f;
    for (int b = 0; b < nblk; ++b) acc += partials[((long long)w * nblk + b) * S * 4 + t];
    stats[(long long)w * S * 4 + t] = acc;
  }
}

inline int reduce_threads(int S) { return S * 4 < 1024 ? ((S * 4 + 31) / 32) * 32 : 1024; }

}  // namespace slot
