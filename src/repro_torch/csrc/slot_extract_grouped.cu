// Grouped fused round extraction for NVIDIA Hopper (sm_90a): slot_extract.cu's
// outputs plus per-(worker, slot, group cell) sufficient statistics and the
// salted group-discovery tallies.
//
// Replaces the TPU kernel repro/kernels/slot_extract.py::
// slot_extract_grouped_pallas (kernel body _slot_extract_grouped_kernel).
// Same contract:
//   slot_extract.cu's inputs + gcol (S,) i32 group column (-1 = ungrouped),
//   gval/gact (S, G) f32 tracked values / live cells (cell G-1 = __other__),
//   salt (1,) i32 round number on the device
//   -> stats (W, S, 4), [cols (W, B, C)], gstats (W, S, G, 4) =
//      (rows in the cell, Σx, Σx², Σp), tal (W, S, 3, H) = (Σp, Σp·v, Σp·v²)
//      per hash bucket of the group value v, only where gact[s, G-1] is set.
// A row is in tracked cell g when col[gcol_s] == gval[s, g] and the cell is
// live; the __other__ indicator is (1 - Σ tracked)·gact[s, G-1].  The hash
// is ref.tally_hash: ((bits(v) ^ salt·2654435761)·2246822519) >> (32 - log2 H)
// in uint32.
//
// Design.  The grid, the row-per-thread parse and the scalar stats are
// slot_extract.cu's, through slot_common.cuh, so the (W, S, 4) output is that
// kernel's bit for bit.  The TPU kernel selects the group column with a
// one-hot matmul; that contraction is exact, so here the thread reads
// v[gcol_s] directly.  Each cell's four lanes go through the same warp
// shuffles, fixed-order pass over warps and block-order second pass as the
// scalar lanes: every mask factor is an exact 0/1 float, so a tracked
// cell's sums are, bit for bit, those kernel 1 gives a fan-out slot whose
// predicate carries the group conjunct (chip_smoke.py checks it).  The TPU
// tallies are a (3, B) x (B, H) one-hot matmul per slot; here the block
// stages each row's (hash, moments) in shared memory and thread h of the
// block sums, in row order, the rows whose hash is h.  Per-block partials
// are summed in block order by the second kernel.  No float atomics: the
// tallies, and so the host's promotions, are the same from run to run.
//
// Bound on the card: at W=4, B=4096, C=4 (64-byte records) the kernel reads
// 1 MiB of rows and writes under 0.2 MiB, about 0.4 µs at 3.35 TB/s; the
// two launches' latency and the S·G·4 warp reductions per row bound it in
// practice.  Making it fast is later work.

#include "slot_common.cuh"

using namespace slot;

namespace {

constexpr uint32_t kSaltMul = 2654435761u;
constexpr uint32_t kMixMul = 2246822519u;

// Shared memory past slot_common's Smem: gval, gact (S*G each), the clipped
// group columns (S ints), the cells' warp partials (kWarps*S*G*4), and the
// tally staging of one slot (kThreads hashes, kThreads*3 moments).
inline size_t grouped_smem_bytes(int C, int S, int G) {
  return smem_bytes(C, S) +
         sizeof(float) * (2 * (size_t)S * G + (size_t)kWarps * S * G * 4 +
                          3 * (size_t)kThreads) +
         sizeof(int) * ((size_t)S + kThreads);
}

__global__ void grouped_blocks(
    const uint8_t* __restrict__ packed, long long n_chunks, long long m_max,
    int num_cols, const int* __restrict__ jw, const int* __restrict__ idx,
    const int* __restrict__ b_eff, const float* __restrict__ coeffs,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ is_count, const float* __restrict__ gate,
    const float* __restrict__ weights, const int* __restrict__ gcol,
    const float* __restrict__ gval, const float* __restrict__ gact,
    const int* __restrict__ salt, int B, int S, int G, int H, int hshift,
    float* __restrict__ partials, float* __restrict__ gpartials,
    float* __restrict__ tpartials, float* __restrict__ cols) {
  extern __shared__ float smem[];
  const int C = num_cols;
  const Smem m = carve(smem, C, S);
  float* sgval = reinterpret_cast<float*>(m.bs + S);
  float* sgact = sgval + S * G;
  float* gred = sgact + S * G;
  float* tmom = gred + kWarps * S * G * 4;
  int* sgcol = reinterpret_cast<int*>(tmom + 3 * kThreads);
  int* thash = sgcol + S;

  const int w = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  load_plan(m, coeffs, lo, hi, is_count, gate, weights, b_eff[w], C, S);
  for (int i = tid; i < S * G; i += kThreads) {
    sgval[i] = gval[i];
    sgact[i] = gact[i];
  }
  for (int s = tid; s < S; s += kThreads) {
    const int g = gcol[s];
    sgcol[s] = g < 0 ? 0 : (g > C - 1 ? C - 1 : g);
  }

  // gather + parse this thread's window row (as slot_extract.cu)
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
  // the scalar stats: kernel 1's code (synchronises before and after)
  eval_reduce(m, v, k, B, C, S, partials + ((long long)w * nblk + blk) * S * 4);

  // per-cell lanes, reduced as the scalar lanes are
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int s = 0; s < S; ++s) {
    const SlotTerms t = slot_terms(m, v, k, B, C, s);
    const float colv = v[sgcol[s]];
    float tracked = 0.0f;
    for (int g = 0; g < G; ++g) {
      float ind;
      if (g < G - 1) {
        ind = __fmul_rn(colv == sgval[s * G + g] ? 1.0f : 0.0f, sgact[s * G + g]);
        tracked = __fadd_rn(tracked, ind);
      } else {
        ind = __fmul_rn(__fsub_rn(1.0f, tracked), sgact[s * G + g]);
      }
      const float gx = __fmul_rn(ind, t.x);
      const float r0 = warp_sum(__fmul_rn(ind, t.mask));
      const float r1 = warp_sum(gx);
      const float r2 = warp_sum(__fmul_rn(gx, gx));
      const float r3 = warp_sum(__fmul_rn(ind, t.pm));
      if (lane == 0) {
        float* dst = gred + ((warp * S + s) * G + g) * 4;
        dst[0] = r0;
        dst[1] = r1;
        dst[2] = r2;
        dst[3] = r3;
      }
    }
  }
  __syncthreads();
  float* gout = gpartials + ((long long)w * nblk + blk) * S * G * 4;
  for (int i = tid; i < S * G * 4; i += kThreads) {
    float acc = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) acc += gred[wp * S * G * 4 + i];
    gout[i] = acc;
  }

  // tallies, one slot at a time: stage (hash, moments) per row, then thread
  // h sums its bucket's rows in row order
  const uint32_t saltmul = (uint32_t)salt[0] * kSaltMul;
  float* tout = tpartials + ((long long)w * nblk + blk) * S * 3 * H;
  for (int s = 0; s < S; ++s) {
    const float live = sgact[s * G + G - 1];
    float* dst = tout + s * 3 * H;
    if (live == 0.0f) {  // not discovering: zeros (no sync, uniform branch)
      for (int i = tid; i < 3 * H; i += kThreads) dst[i] = 0.0f;
      continue;
    }
    const SlotTerms t = slot_terms(m, v, k, B, C, s);
    const float colv = v[sgcol[s]];
    const float pt = __fmul_rn(t.pm, live);
    const float m1 = __fmul_rn(pt, colv);
    __syncthreads();  // the previous slot's staging has been read
    thash[tid] = (int)(((__float_as_uint(colv) ^ saltmul) * kMixMul) >> hshift);
    tmom[tid * 3 + 0] = pt;
    tmom[tid * 3 + 1] = m1;
    tmom[tid * 3 + 2] = __fmul_rn(m1, colv);
    __syncthreads();
    for (int h = tid; h < H; h += kThreads) {
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      for (int r = 0; r < kThreads; ++r) {
        if (thash[r] == h) {
          c0 += tmom[r * 3 + 0];
          c1 += tmom[r * 3 + 1];
          c2 += tmom[r * 3 + 2];
        }
      }
      dst[h] = c0;
      dst[H + h] = c1;
      dst[2 * H + h] = c2;
    }
  }
}

// Second pass, one block per worker: each output lane summed over the
// blocks in block order (stats, then cells, then tallies).
__global__ void grouped_reduce(const float* __restrict__ partials,
                               const float* __restrict__ gpartials,
                               const float* __restrict__ tpartials, int nblk,
                               int l0, int l1, int l2, float* __restrict__ stats,
                               float* __restrict__ gstats, float* __restrict__ tal) {
  const int w = blockIdx.x;
  for (int t = threadIdx.x; t < l0 + l1 + l2; t += blockDim.x) {
    const float* src;
    float* dst;
    int lanes, i;
    if (t < l0) {
      src = partials, dst = stats, lanes = l0, i = t;
    } else if (t < l0 + l1) {
      src = gpartials, dst = gstats, lanes = l1, i = t - l0;
    } else {
      src = tpartials, dst = tal, lanes = l2, i = t - l0 - l1;
    }
    float acc = 0.0f;
    for (int b = 0; b < nblk; ++b) acc += src[((long long)w * nblk + b) * lanes + i];
    dst[(long long)w * lanes + i] = acc;
  }
}

}  // namespace

extern "C" int slot_extract_grouped_launch(
    const uint8_t* packed, long long n_chunks, long long m_max, int num_cols,
    const int* jw, const int* idx, const int* b_eff, const float* coeffs,
    const float* lo, const float* hi, const float* is_count, const float* gate,
    const float* weights, const int* gcol, const float* gval, const float* gact,
    const int* salt, int W, int B, int S, int G, int H, float* partials,
    float* gpartials, float* tpartials, float* stats, float* gstats, float* tal,
    float* cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 2 || H > kThreads || (H & (H - 1)) != 0 || G < 1) return (int)cudaErrorInvalidValue;
  int lg = 0;
  while ((1 << lg) < H) ++lg;
  const int nblk = (B + kThreads - 1) / kThreads;
  const size_t smem = grouped_smem_bytes(num_cols, S, G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  grouped_blocks<<<dim3(nblk, W), kThreads, smem, st>>>(
      packed, n_chunks, m_max, num_cols, jw, idx, b_eff, coeffs, lo, hi, is_count,
      gate, weights, gcol, gval, gact, salt, B, S, G, H, 32 - lg, partials,
      gpartials, tpartials, cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grouped_reduce<<<W, 1024, 0, st>>>(partials, gpartials, tpartials, nblk, S * 4,
                                     S * G * 4, S * 3 * H, stats, gstats, tal);
  return (int)cudaGetLastError();
}

extern "C" int slot_extract_grouped_threads_per_block() { return kThreads; }
