// The one-launch rows body of the full-scan kernels, for NVIDIA Hopper
// (sm_90a): chunk_agg.cu (every chunk of a packed store) and round_stats.cu
// (each worker's gathered window rows of a round).  Both compute, for row
// block l of rows (L, R, 16·C) u8, valid counts (L,) and a plan coeffs/lo/hi
// (Q, C) f32,
//   out[l, q] = (n, Σx, Σx², Σp) over the first n = clamp(valid[l], 0, R)
//   rows, with p = [lo[q] <= v < hi[q]] and x = linear(v, coeffs[q])·p;
// the count lane is n for every plan.  A row's terms are slot_common.cuh's
// (parse_field, linear, the predicate as the round kernels take it), so
// they have the bits every other kernel of the port gives that row; only
// the order in which rows are summed is this body's.
//
// What bounds it on the H100: bytes.  chunk_agg reads the whole 2 GiB
// store once (0.64 ms at 3.35 TB/s); per 256-byte row it runs ~1,000
// integer and float instructions (16 parses, 8 plans of 32 compares and
// 16 multiply-adds), so the instruction rate comes close behind.  The first
// port ran one thread per record (neighbouring threads 256 bytes apart,
// one 16-byte load in flight), a full block reduction every 256 rows, the
// plan read from shared memory once per use, and a second launch over
// 4 MiB of per-block partials: 1.51 ms.
//
// Design.
//   1. One launch, grid (P, L): block (p, l) owns rows [p·rpb, (p+1)·rpb)
//      of row block l, cut at n; the host picks P from the shapes and the
//      SM count (kernels/chunk_agg.py::rows_split mirrors it), so the bits
//      repeat from launch to launch.  With P > 1 every block writes its
//      (Q, 4) partial to a scratch row and the last block of row block l to
//      finish (an integer counter, reset by that block; slot_tile.cuh's
//      scheme) folds them in block order.  No float atomics.
//   2. A block walks its rows in steps of TR rows (128 at C <= 24:
//      kernels/chunk_agg.py::step_rows), a
//      contiguous byte range each, through a ring of kStages stages:
//      16-byte cp.async by every thread, neighbouring threads on
//      neighbouring words (coalesced), the next step's copy in flight while
//      this one is parsed and evaluated.  Rows at or past n are never read.
//      Each thread parses the words it copied (no barrier between copy and
//      parse) into a row buffer of odd stride C | 1, so a thread then reads
//      its own row without bank conflicts.
//   3. Thread t evaluates row t of each step and keeps its sums (Σx, Σx²,
//      Σp per plan) in registers across every step; the warp shuffles and
//      the pass over warps in order run once per block.  A sum's rounding
//      chain is steps + 5 shuffle levels + 4 warps + P additions.
//   4. The plan sits in shared memory, each (plan, column group of four)
//      read with one 16-byte broadcast load for the compiled widths.
//   5. At C = 16 a block takes 74.4 KiB of dynamic shared memory, so three
//      fit an SM (12 warps) with 1.9 KB to spare.  The kernel keeps no
//      static shared memory: 16 bytes of it made chunk_agg 763 µs against
//      708 on an H100 (scripts/rows_phase_times.py), as if the third block
//      no longer fit.
// C = 16 and C = 4 with Q <= 8 are compiled with the row and the plan in
// registers; any other (C, Q) runs the same body with C read at run time,
// eight plans a pass over the block's rows.

#pragma once

#include "slot_tile.cuh"

namespace slot {
namespace rows {

constexpr int kThreads = 128;           // threads a block: rows a step
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;              // steps of rows in flight or in use
constexpr int kPlans = 8;               // plans a pass sums in registers
constexpr int kMinBlocks = 3;           // blocks an SM should hold (register cap)
constexpr int kMaxSmem = 227 * 1024;    // shared memory a block may have

struct Args {
  const uint8_t* rows;  // (L, R, 16·C)
  const int* valid;     // (L,)
  const float* coeffs;  // (Q, C)
  const float* lo;
  const float* hi;
  float* out;           // (L, Q, 4)
  float* scratch;       // (L, P, Q, 4) when P > 1
  int* counters;        // (>= L,) zero on entry, left zero
  long long R;          // rows a row block holds
  long long block_rows; // rows a block owns: a whole number of steps
  int C, Q;
  int step_rows;        // TR
};

__host__ __device__ inline int pad4(int c) { return (c + 3) & ~3; }

// Shared memory, in bytes from the start of the dynamic buffer: the stages,
// the parsed rows of one step, the plan of a pass (coeffs, lo, hi, each
// (kPlans, pad4(C))) and the warps' sums.
struct Layout {
  size_t stage, vals, plan, red, total;
};

__host__ __device__ inline Layout layout(int C, int TR) {
  Layout L;
  size_t at = 0;
  L.stage = tile::take(at, (size_t)kStages * TR * C * kFieldBytes);
  L.vals = tile::take(at, sizeof(float) * TR * (C | 1));
  L.plan = tile::take(at, sizeof(float) * 3 * kPlans * pad4(C));
  L.red = tile::take(at, sizeof(float) * kWarps * kPlans * 3);
  L.total = at;
  return L;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Plan q's range predicate and four terms on row v, in slot_tile.cuh's
// order with the slot's budget, gate and COUNT flag at their rows-pass
// values (counted, 1, 0): mask 1, so x = linear(v)·p and pm = p.
template <int CT>
__device__ __forceinline__ void add_plan(const float* v, const float* cf, const float* lo,
                                         const float* hi, int C, float& sx, float& sxx,
                                         float& sp) {
  bool pred = true;
#pragma unroll
  for (int c = 0; c < (CT > 0 ? CT : C); ++c) pred = pred & (v[c] >= lo[c]) & (v[c] < hi[c]);
  const float p = pred ? 1.0f : 0.0f;
  const float x = __fmul_rn(linear(v, cf, CT > 0 ? CT : C), p);
  sx += x;
  sxx += __fmul_rn(x, x);
  sp += p;
}

template <int CT>
__device__ __forceinline__ void body(const Args& a) {
  static_assert(CT % 4 == 0, "compiled widths load the plan four columns at a time");
  constexpr bool kFixed = CT > 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = kFixed ? CT : a.C;
  const int TR = kFixed ? kThreads : a.step_rows;
  const int cs = C | 1;
  const int cp = pad4(C);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x;
  const int P = gridDim.x;
  const int l = blockIdx.y;
  const Layout Ly = layout(C, TR);
  unsigned char* stage = smem_raw + Ly.stage;
  float* vals = reinterpret_cast<float*>(smem_raw + Ly.vals);
  float* plan = reinterpret_cast<float*>(smem_raw + Ly.plan);
  float* red = reinterpret_cast<float*>(smem_raw + Ly.red);

  const long long rec = (long long)C * kFieldBytes;
  const int vl = a.valid[l];
  const long long n = vl < 0 ? 0 : (vl > a.R ? a.R : vl);  // rows counted
  const long long r0 = (long long)p * a.block_rows;
  const long long nb = max(0LL, min(a.block_rows, n - r0));  // this block's rows
  const int nsteps = (int)((nb + TR - 1) / TR);
  const uint8_t* src = a.rows + ((long long)l * a.R + r0) * rec;
  const size_t stage_bytes = (size_t)TR * rec;

  // step s's rows into stage s % kStages, one commit group per step (an
  // empty one past the last), each thread the words q ≡ tid (mod kThreads)
  auto fetch = [&](int s) {
    if (s < nsteps) {
      const int words = (int)min((long long)TR, nb - (long long)s * TR) * C;
      const uint8_t* from = src + (long long)s * stage_bytes;
      unsigned char* to = stage + (size_t)(s % kStages) * stage_bytes;
      for (int q = tid; q < words; q += kThreads)
        tile::cp_async16(to + (size_t)q * kFieldBytes, from + (size_t)q * kFieldBytes);
    }
    commit();
  };

  const int passes = kFixed ? 1 : (a.Q + kPlans - 1) / kPlans;
  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = pass * kPlans;
    const int nq = min(kPlans, a.Q - q0);
    // the first steps' copies in flight while the plan is loaded
#pragma unroll
    for (int s = 0; s < kStages; ++s) fetch(s);
    for (int i = tid; i < kPlans * cp; i += kThreads) {
      const int q = i / cp, c = i - q * cp;
      float cf = 0.0f, lo = 0.0f, hi = 0.0f;
      if (q < nq && c < C) {
        const int g = (q0 + q) * C + c;
        cf = a.coeffs[g];
        lo = a.lo[g];
        hi = a.hi[g];
      }
      plan[i] = cf;
      plan[kPlans * cp + i] = lo;
      plan[2 * kPlans * cp + i] = hi;
    }
    float sx[kPlans], sxx[kPlans], sp[kPlans];
#pragma unroll
    for (int q = 0; q < kPlans; ++q) sx[q] = sxx[q] = sp[q] = 0.0f;

    for (int s = 0; s < nsteps; ++s) {
      const int nr = (int)min((long long)TR, nb - (long long)s * TR);
      const unsigned char* st = stage + (size_t)(s % kStages) * stage_bytes;
      wait_group<kStages - 1>();  // this thread's words of step s landed
      if (kFixed && nr == TR) {
        constexpr int CW = kFixed ? CT : 1;
#pragma unroll
        for (int k = 0; k < CW; ++k) {  // TR·CT words, CT a thread
          const int q = tid + k * kThreads;
          vals[(q / CW) * cs + q % CW] =
              parse_field(*reinterpret_cast<const uint4*>(st + (size_t)q * kFieldBytes));
        }
      } else {
        for (int q = tid; q < nr * C; q += kThreads) {
          const int r = q / C;
          vals[r * cs + (q - r * C)] =
              parse_field(*reinterpret_cast<const uint4*>(st + (size_t)q * kFieldBytes));
        }
      }
      __syncthreads();  // the step's rows parsed (at s = 0: the plan loaded)
      fetch(s + kStages);  // into the stage every thread has parsed
      if (tid < nr) {
        const float* row = vals + tid * cs;
        if constexpr (kFixed) {
          float v[CT];
#pragma unroll
          for (int c = 0; c < CT; ++c) v[c] = row[c];
#pragma unroll
          for (int q = 0; q < kPlans; ++q) {
            if (q < nq) {
              float cf[CT], lo[CT], hi[CT];
              const float4* pc = reinterpret_cast<const float4*>(plan + q * CT);
              const float4* pl = reinterpret_cast<const float4*>(plan + (kPlans + q) * CT);
              const float4* ph = reinterpret_cast<const float4*>(plan + (2 * kPlans + q) * CT);
#pragma unroll
              for (int c = 0; c < CT; c += 4) {
                const float4 x = pc[c / 4], y = pl[c / 4], z = ph[c / 4];
                cf[c] = x.x, cf[c + 1] = x.y, cf[c + 2] = x.z, cf[c + 3] = x.w;
                lo[c] = y.x, lo[c + 1] = y.y, lo[c + 2] = y.z, lo[c + 3] = y.w;
                hi[c] = z.x, hi[c + 1] = z.y, hi[c + 2] = z.z, hi[c + 3] = z.w;
              }
              add_plan<CT>(v, cf, lo, hi, CT, sx[q], sxx[q], sp[q]);
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < kPlans; ++q)
            if (q < nq)
              add_plan<0>(row, plan + q * cp, plan + (kPlans + q) * cp,
                          plan + (2 * kPlans + q) * cp, C, sx[q], sxx[q], sp[q]);
        }
      }
      __syncthreads();  // the row buffer read: free for the next step
    }

    // the block's sums: warp shuffles, then the warps in order
#pragma unroll
    for (int q = 0; q < kPlans; ++q) {
      if (q < nq) {
        const float r1 = warp_sum(sx[q]);
        const float r2 = warp_sum(sxx[q]);
        const float r3 = warp_sum(sp[q]);
        if (lane == 0) {
          float* d = red + (warp * kPlans + q) * 3;
          d[0] = r1;
          d[1] = r2;
          d[2] = r3;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * 4; i += kThreads) {
      const int q = i >> 2, k = i & 3;
      float acc = 0.0f;
      if (k > 0)
        for (int wp = 0; wp < kWarps; ++wp) acc += red[(wp * kPlans + q) * 3 + k - 1];
      const long long o = (long long)(q0 + q) * 4 + k;
      if (P == 1)
        a.out[(long long)l * a.Q * 4 + o] = k == 0 ? (float)n : acc;
      else
        a.scratch[((long long)l * P + p) * a.Q * 4 + o] = acc;
    }
    __syncthreads();  // the warps' sums and the plan read: free for the next pass
  }
  if (P == 1) return;

  // the row block's last block folds the partials in block order.  An
  // integer counter finds it; thread 0's fences, after and before the
  // block's barriers, order every thread's scratch writes before the count
  // and the other blocks' rows before the fold.  The flag takes the warps'
  // sums' place, read by now: the kernel keeps no static shared memory
  int& last_block = *reinterpret_cast<int*>(red);
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(a.counters + l, 1) == P - 1;
    if (last_block) __threadfence();
  }
  __syncthreads();
  if (!last_block) return;
  const long long lanes = (long long)a.Q * 4;
  const float* part = a.scratch + (long long)l * P * lanes;
  for (int i = tid; i < lanes; i += kThreads) {
    float acc = 0.0f;
    if ((i & 3) != 0) {
      for (int b0 = 0; b0 < P; b0 += 32) {
        // 32 blocks' loads in flight, then added in block order
        float x[32];
#pragma unroll
        for (int u = 0; u < 32; ++u) x[u] = b0 + u < P ? __ldcg(part + (b0 + u) * lanes + i) : 0.0f;
#pragma unroll
        for (int u = 0; u < 32; ++u)
          if (b0 + u < P) acc += x[u];
      }
    }
    a.out[(long long)l * lanes + i] = (i & 3) == 0 ? (float)n : acc;
  }
  if (tid == 0) a.counters[l] = 0;
}

// Host side.  The three instances of one kernel (C = 16 and C = 4 with
// Q <= kPlans, and the general one) and the dynamic shared memory each was
// last allowed, so the attribute is set once.
struct Kernels {
  void (*k[3])(Args);
  int smem_set[3];
};

// The instance that runs (C, Q): its index in Kernels.
inline int pick(int C, int Q) {
  if (Q <= kPlans && C == 16) return 0;
  if (Q <= kPlans && C == 4) return 1;
  return 2;
}

// Allow instance i `smem` bytes of dynamic shared memory.
inline int allow(Kernels& ks, int i, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && (long long)smem > (long long)ks.smem_set[i]) {
    cudaError_t e =
        cudaFuncSetAttribute(ks.k[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ks.k[i], cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ks.smem_set[i] = (int)smem;
  }
  return 0;
}

// Blocks of the instance for (C, Q) that one SM holds at once, at TR rows
// a step (the wrapper sizes the grid with it); negative: a CUDA error.
inline int blocks_per_sm(Kernels& ks, int C, int Q, int TR) {
  const int i = pick(C, Q);
  const size_t smem = layout(C, TR).total;
  int e = allow(ks, i, smem);
  if (e != 0) return -e;
  int nb = 0;
  cudaError_t ce =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, ks.k[i], kThreads, smem);
  return ce == cudaSuccess ? nb : -(int)ce;
}

inline int launch(Kernels& ks, Args a, int L, int P, cudaStream_t st) {
  if (L < 1 || L > 65535 || P < 1 || a.C < 1 || a.Q < 1 || a.R < 1 || a.step_rows < 1 ||
      a.step_rows > kThreads || a.block_rows < 1 || a.block_rows % a.step_rows != 0 ||
      (long long)P * a.block_rows < a.R || (P > 1 && (a.scratch == nullptr || a.counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int i = pick(a.C, a.Q);
  if (i < 2 && a.step_rows != kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(a.C, a.step_rows).total;
  const int e = allow(ks, i, smem);
  if (e != 0) return e;
  ks.k[i]<<<dim3(P, L), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rows
}  // namespace slot
