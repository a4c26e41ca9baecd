// Device functions shared by the round-extraction kernels (slot_extract.cu,
// slot_extract_stream.cu, slot_extract_grouped.cu, through slot_tile.cuh),
// the parse kernel (extract_parse.cu) and the rows kernels (chunk_agg.cu,
// round_stats.cu, through rows_tile.cuh), so that every kernel parses a
// field, evaluates a slot and reduces a window with the same instructions
// in the same order.  A packed
// round, a streamed raw round and a decoded round over the same rows
// therefore give the same float bits, and a grouped round's tracked cells
// the bits of the fan-out slots that carry the group conjunct.
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

// Shared-memory views of a tile block (slot_tile.cuh): the plan (coeffs,
// lo, hi: S*C each; is_count, gate: S each), the parsed rows (cs floats a
// row), the warps' partial sums and the per-slot budgets (S ints).
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

// Slot s on a row (window position k): the counted flag ok (k inside the
// slot's budget), the mask ok·gate, and the masked value x and indicator pm
// that the four sums add up.
struct SlotTerms {
  float ok, mask, x, pm;
};

}  // namespace slot
