// The one-launch tile body of the packed round-extraction kernels
// (slot_extract.cu, and slot_extract_grouped.cu with kGrouped), for NVIDIA
// Hopper (sm_90a).
//
// The grid is (tiles, W): block (t, w) owns window positions
// [256·t, 256·t + 256) of worker w.  Its row warps hold 32 positions each
// (B = 8: one row warp); each row warp is repeated P times, up to 16 warps
// a block, and repeat sg takes slots sg, sg + SG, ... and, grouped, every
// P-th live cell, so a short window's slots and cells run on parallel
// warps rather than one after another.  A block
//   1. reads the chunk id, the budget and its window rows' indices (one
//      trip to device memory);
//   2. issues every 16-byte field of every live row at once with cp.async
//      (neighbouring threads on neighbouring words of a row: coalesced),
//      loads the plan into shared memory while the rows are in flight, and
//      parses each word it copied;
//   3. evaluates the slots on the row warps that hold live rows, reduces
//      each slot (and, grouped, each live cell) with slot_common.cuh's warp
//      shuffles, and, grouped, tallies each discovering slot's rows by hash
//      bucket (a match mask per row warp and bucket, then one thread per
//      bucket sums its rows in row order, eight loads at a time);
//   4. sums the row warps in order and writes the result straight to the
//      outputs when the window is one tile; a longer window's tiles write
//      scratch rows, and the last block of the worker to finish (an integer
//      counter, reset by that block) folds them in tile order, sixteen
//      tiles' loads in flight.  No second launch, no float atomics.
//
// Live rows are window positions k < B, and, unless the decoded window is
// asked for, k < b_eff[w]: every slot's budget is at most b_eff, so a row
// past it adds exact zeros to every sum.  Every float operation that
// reaches an output runs in slot_common.cuh's order (parse_field, linear,
// the slot terms, warp_sum over 32 consecutive positions, warps in order
// from 0.0f, tiles in order from 0.0f; tallies in row order).  What is left
// out (dead rows, dead warps, dead cells, warps whose cell terms are all
// zero) would add only ±0 to a sum that starts at +0.0f, and such a sum
// never becomes -0.0f: the bits are those of the two-pass kernels, and so
// those of slot_extract_stream.cu on the same rows.

#pragma once

#include "slot_common.cuh"

namespace slot {
namespace tile {

constexpr int kTileRows = kThreads;  // window positions per block
constexpr int kMaxWarps = 16;        // warps per block
constexpr int kStageCap = 4096;      // 16-byte words staged at once (64 KiB)
constexpr uint32_t kSaltMul = 2654435761u;
constexpr uint32_t kMixMul = 2246822519u;

struct Args {
  const uint8_t* packed;
  long long n_chunks, m_max;
  int C, W, B, S;
  const int* jw;
  const int* idx;
  const int* b_eff;
  const float* coeffs;
  const float* lo;
  const float* hi;
  const float* is_count;
  const float* gate;
  const float* weights;
  // grouped only
  const int* gcol;
  const float* gval;
  const float* gact;
  const int* salt;
  int G, H, hshift;
  // outputs: stats (W, S, 4), gstats (W, S, G, 4), tal (W, S, 3, H),
  // cols (W, B, C) or null
  float* stats;
  float* gstats;
  float* tal;
  float* cols;
  // more than one tile: scratch (W, tiles, scratch_row(lanes)) and
  // counters (W,), zero on entry and left zero
  float* scratch;
  int* counters;
  int stage_words;
};

// Geometry, the same on the host and in the kernel (the wrappers in
// kernels/ mirror it in Python).
__host__ __device__ inline int tiles(int B) { return (B + kTileRows - 1) / kTileRows; }

__host__ __device__ inline int row_warps(int B) {
  const int r = B < kTileRows ? B : kTileRows;
  return (r + 31) / 32;
}

// Warps per row warp: as many as keep the block within kMaxWarps; without
// group cells to share out, no more than there are slots.
__host__ __device__ inline int warps_per_row_warp(int B, int S, bool grouped) {
  const int g = kMaxWarps / row_warps(B);
  return grouped || g < S ? g : S;
}

__host__ __device__ inline int threads(int B, int S, bool grouped) {
  return 32 * row_warps(B) * warps_per_row_warp(B, S, grouped);
}

// Words staged per batch: the whole tile when it fits, else a multiple of
// the block size, so a thread owns the same staging slots in every batch.
__host__ __device__ inline int stage_words(int B, int C, int T) {
  const long long words = (long long)(B < kTileRows ? B : kTileRows) * C;
  return words <= kStageCap ? (int)words : (kStageCap / T) * T;
}

__host__ __device__ inline int lanes(int S, int G, int H, bool grouped) {
  return S * 4 + (grouped ? S * G * 4 + S * 3 * H : 0);
}

// Floats of a tile's scratch row: the lanes padded to whole 16-byte words,
// so the fold reads four lanes per load.
__host__ __device__ inline int scratch_row(int nl) { return (nl + 3) & ~3; }

// Shared memory, in bytes from the start of the dynamic buffer.
struct Layout {
  size_t stage, off, vals, coeffs, lo, hi, isc, gate, bs, red;
  size_t gval, gact, gcol, gred, tmom, bm, total;
};

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) & ~(size_t)15;
  return here;
}

// T threads, `rows` window positions (32 per row warp), sw staged words.
__host__ __device__ inline Layout layout(int C, int S, int G, int H, int T, int rows,
                                         int sw, bool grouped) {
  const int nw = rows / 32;
  const size_t f = sizeof(float);
  Layout L;
  size_t at = 0;
  L.stage = take(at, (size_t)sw * kFieldBytes);
  L.off = take(at, sizeof(long long) * rows);
  L.vals = take(at, f * rows * (C | 1));
  L.coeffs = take(at, f * S * C);
  L.lo = take(at, f * S * C);
  L.hi = take(at, f * S * C);
  L.isc = take(at, f * S);
  L.gate = take(at, f * S);
  L.bs = take(at, sizeof(int) * S);
  L.red = take(at, f * nw * S * 4);
  L.gval = L.gact = L.gcol = L.gred = L.tmom = L.bm = at;
  if (grouped) {
    L.gval = take(at, f * S * G);
    L.gact = take(at, f * S * G);
    L.gcol = take(at, sizeof(int) * S);
    L.gred = take(at, f * nw * S * G * 4);
    L.tmom = take(at, f * 2 * T * 3);
    L.bm = take(at, sizeof(uint32_t) * 2 * (T / 32) * H);
  }
  L.total = at;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Output lane i of worker w: stats, then cells, then tallies.
__device__ __forceinline__ float* lane_ptr(const Args& a, int w, int i) {
  const int l0 = a.S * 4;
  if (i < l0) return a.stats + (long long)w * l0 + i;
  const int l1 = a.S * a.G * 4;
  if (i < l0 + l1) return a.gstats + (long long)w * l1 + (i - l0);
  return a.tal + (long long)w * a.S * 3 * a.H + (i - l0 - l1);
}

// This tile's value of lane i: the output itself for a one-tile window,
// else the tile's scratch row.
__device__ __forceinline__ void put(const Args& a, int w, int row, int i, float v) {
  if (gridDim.x == 1)
    *lane_ptr(a, w, i) = v;
  else
    a.scratch[((long long)w * gridDim.x + blockIdx.x) * row + i] = v;
}

// Slot s on a row v at window position k, as slot_common.cuh::slot_terms
// (the same float operations in the same order), with the range predicate
// taken without branches: a lane-divergent branch per column costs more
// than the compares.
__device__ __forceinline__ SlotTerms terms(const Smem& m, const float* v, int k, int B,
                                           int C, int s) {
  const float* cf = m.coeffs + s * C;
  const float* l = m.lo + s * C;
  const float* h = m.hi + s * C;
  bool pred = true;
#pragma unroll
  for (int c = 0; c < C; ++c) pred = pred & (v[c] >= l[c]) & (v[c] < h[c]);
  const float expr = linear(v, cf, C);
  const float p = pred ? 1.0f : 0.0f;
  SlotTerms t;
  const float x = m.isc[s] > 0.0f ? p : __fmul_rn(expr, p);
  t.ok = (k < B && k < m.bs[s]) ? 1.0f : 0.0f;
  t.mask = __fmul_rn(t.ok, m.gate[s]);
  t.x = __fmul_rn(x, t.mask);
  t.pm = __fmul_rn(p, t.mask);
  return t;
}

template <int CT, bool kGrouped>
__device__ __forceinline__ void body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  const int C = CT > 0 ? CT : a.C;
  const int S = a.S;
  const int G = kGrouped ? a.G : 0;
  const int H = kGrouped ? a.H : 0;
  const int T = blockDim.x;
  const int RW = row_warps(a.B);  // row warps: 32 window positions each
  const int P = T / (32 * RW);    // warps per row warp
  const int SG = P < S ? P : S;   // slot groups: warp sg takes every SG-th slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rw = warp % RW;
  const int sg = warp / RW;
  const int w = blockIdx.y;
  const int k0 = blockIdx.x * kTileRows;
  const int nl = lanes(S, G, H, kGrouped);
  const int row = scratch_row(nl);
  const Layout L = layout(C, S, G, H, T, RW * 32, a.stage_words, kGrouped);
  unsigned char* stage = smem_raw + L.stage;
  long long* off = reinterpret_cast<long long*>(smem_raw + L.off);
  Smem m;
  m.cs = C | 1;
  m.vals = reinterpret_cast<float*>(smem_raw + L.vals);
  m.coeffs = reinterpret_cast<float*>(smem_raw + L.coeffs);
  m.lo = reinterpret_cast<float*>(smem_raw + L.lo);
  m.hi = reinterpret_cast<float*>(smem_raw + L.hi);
  m.isc = reinterpret_cast<float*>(smem_raw + L.isc);
  m.gate = reinterpret_cast<float*>(smem_raw + L.gate);
  m.bs = reinterpret_cast<int*>(smem_raw + L.bs);
  m.red = reinterpret_cast<float*>(smem_raw + L.red);
  float* sgval = reinterpret_cast<float*>(smem_raw + L.gval);
  float* sgact = reinterpret_cast<float*>(smem_raw + L.gact);
  int* sgcol = reinterpret_cast<int*>(smem_raw + L.gcol);
  float* gred = reinterpret_cast<float*>(smem_raw + L.gred);
  float* tmom = reinterpret_cast<float*>(smem_raw + L.tmom);
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem_raw + L.bm);

  // 1. chunk, budget and this tile's window rows, loaded together
  const int in_tile = min(a.B - k0, kTileRows);
  int ir = -1;
  if (tid < in_tile) ir = a.idx[(long long)w * a.B + k0 + tid];
  const int j = a.jw[w];
  const int beff = a.b_eff[w];
  const int lim = a.cols != nullptr ? a.B : min(a.B, max(beff, 0));
  const int R = max(0, min(lim - k0, kTileRows));  // live rows of the tile
  const int nlw = (R + 31) >> 5;                   // row warps holding them
  const long long rec = (long long)C * kFieldBytes;
  if (tid < R)
    off[tid] = (j >= 0 && j < a.n_chunks && ir >= 0 && ir < a.m_max)
                   ? ((long long)j * a.m_max + ir) * rec
                   : -1;
  __syncthreads();

  // 2. every field of every live row in flight at once, the plan loaded
  // meanwhile (one trip), then each thread parses the words it copied
  const int words = R * C;
  const int sw = a.stage_words;
  for (int q = tid; q < min(words, sw); q += T) {
    const long long o = off[q / C];
    if (o >= 0) cp_async16(stage + (size_t)q * kFieldBytes, a.packed + o + (q % C) * kFieldBytes);
  }
  const int np = max(max(S * C, S), S * G);
  for (int i = tid; i < np; i += T) {
    const bool pc = i < S * C, ps = i < S, pg = i < S * G;
    float cf = 0.0f, lo = 0.0f, hi = 0.0f, isc = 0.0f, gt = 0.0f, wt = 0.0f;
    float gv = 0.0f, ga = 0.0f;
    int gc = 0;
    if (pc) {
      cf = a.coeffs[i];
      lo = a.lo[i];
      hi = a.hi[i];
    }
    if (ps) {
      isc = a.is_count[i];
      gt = a.gate[i];
      wt = a.weights[i];
      if constexpr (kGrouped) gc = a.gcol[i];
    }
    if (kGrouped && pg) {
      gv = a.gval[i];
      ga = a.gact[i];
    }
    if (pc) {
      m.coeffs[i] = cf;
      m.lo[i] = lo;
      m.hi[i] = hi;
    }
    if (ps) {
      m.isc[i] = isc;
      m.gate[i] = gt;
      const int cap = (int)ceilf(__fmul_rn(wt, (float)beff));
      m.bs[i] = cap < beff ? cap : beff;
      if constexpr (kGrouped) sgcol[i] = gc < 0 ? 0 : (gc > C - 1 ? C - 1 : gc);
    }
    if (kGrouped && pg) {
      sgval[i] = gv;
      sgact[i] = ga;
    }
  }
  uint32_t saltmul = 0;
  if constexpr (kGrouped) {
    for (int i = tid; i < 2 * (T >> 5) * H; i += T) bm[i] = 0u;
    saltmul = (uint32_t)a.salt[0] * kSaltMul;
  }
  // rows past the live ones in a live row warp hold zeros
  for (int i = tid; i < (nlw * 32 - R) * C; i += T) m.vals[(R + i / C) * m.cs + i % C] = 0.0f;
  for (int base = 0;;) {
    cp_async_wait_all();
    for (int q = base + tid; q < min(words, base + sw); q += T) {
      const int r = q / C, f = q % C;
      m.vals[r * m.cs + f] =
          off[r] >= 0 ? parse_field(*reinterpret_cast<const uint4*>(
                            stage + (size_t)(q - base) * kFieldBytes))
                      : 0.0f;
    }
    base += sw;
    if (base >= words) break;
    for (int q = base + tid; q < min(words, base + sw); q += T) {
      const long long o = off[q / C];
      if (o >= 0)
        cp_async16(stage + (size_t)(q - base) * kFieldBytes, a.packed + o + (q % C) * kFieldBytes);
    }
  }
  __syncthreads();  // rows parsed, plan in shared memory

  // 3. the slots: row warp rw of slot group sg < SG takes slots sg,
  // sg + SG, ... on its 32 rows, if any of them is live
  const bool live_warp = rw < nlw;
  const int r = rw * 32 + lane;
  const int k = k0 + r;
  float vreg[CT > 0 ? CT : 1];  // the row in registers for a compiled width
  if constexpr (CT > 0) {
    if (live_warp) {
#pragma unroll
      for (int c = 0; c < CT; ++c) vreg[c] = m.vals[r * m.cs + c];
    }
  }
  int buf = 0;
  for (int s0 = 0; s0 < S; s0 += SG) {
    const int s = s0 + sg;
    const bool mine = live_warp && sg < SG && s < S;
    SlotTerms t{0.0f, 0.0f, 0.0f, 0.0f};
    float colv = 0.0f;
    if (mine) {
      if constexpr (CT > 0)
        t = terms(m, vreg, k, a.B, C, s);
      else
        t = terms(m, m.vals + r * m.cs, k, a.B, C, s);
      const float r0 = warp_sum(t.ok);
      const float r1 = warp_sum(t.x);
      const float r2 = warp_sum(__fmul_rn(t.x, t.x));
      const float r3 = warp_sum(t.pm);
      if (lane == 0) {
        float* dst = m.red + (rw * S + s) * 4;
        dst[0] = r0;
        dst[1] = r1;
        dst[2] = r2;
        dst[3] = r3;
      }
      if constexpr (kGrouped) colv = m.vals[r * m.cs + sgcol[s]];
    }
    if constexpr (kGrouped) {
      // tallies of this round's discovering slots: each live row's (hash,
      // moments) staged per slot group, the rows of each bucket found per
      // row warp with a match mask; then (slot, bucket) items, one thread
      // each, sum a bucket's rows in row order
      const int rows = RW * 32;
      if (mine && sgact[s * G + G - 1] != 0.0f) {
        const float live = sgact[s * G + G - 1];
        float* mom = tmom + (size_t)(buf * SG + sg) * rows * 3;
        uint32_t* bmask = bm + (size_t)(buf * SG + sg) * RW * H;
        const float pt = __fmul_rn(t.pm, live);
        const float m1 = __fmul_rn(pt, colv);
        const int key =
            r < R ? (int)(((__float_as_uint(colv) ^ saltmul) * kMixMul) >> a.hshift) : -1;
        if (r < R) {
          mom[r * 3 + 0] = pt;
          mom[r * 3 + 1] = m1;
          mom[r * 3 + 2] = __fmul_rn(m1, colv);
        }
        const uint32_t peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u) bmask[rw * H + key] = peers;
      }
      __syncthreads();
      const int lgh = 32 - a.hshift;  // H = 2^lgh
      for (int i = tid; i < SG * H; i += T) {
        const int s2 = s0 + (i >> lgh), h = i & (H - 1);
        if (s2 >= S) break;
        const int tb = S * 4 + S * G * 4 + s2 * 3 * H + h;
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
        if (sgact[s2 * G + G - 1] != 0.0f) {
          const float* mom = tmom + (size_t)(buf * SG + (i >> lgh)) * rows * 3;
          uint32_t* bmask = bm + (size_t)(buf * SG + (i >> lgh)) * RW * H;
          for (int wp = 0; wp < nlw; ++wp) {
            uint32_t bits = bmask[wp * H + h];
            if (bits == 0u) continue;
            bmask[wp * H + h] = 0u;  // clean for the round after next
            while (bits != 0u) {
              // up to eight rows: their loads issued together, then added
              // in row order
              int rr[8];
              int n = 0;
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                rr[u] = wp * 32;
                if (bits != 0u) {
                  rr[u] += __ffs(bits) - 1;
                  bits &= bits - 1u;
                  n = u + 1;
                }
              }
              float x0[8], x1[8], x2[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                x0[u] = mom[rr[u] * 3 + 0];
                x1[u] = mom[rr[u] * 3 + 1];
                x2[u] = mom[rr[u] * 3 + 2];
              }
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                if (u < n) {
                  c0 += x0[u];
                  c1 += x1[u];
                  c2 += x2[u];
                }
              }
            }
          }
        }
        put(a, w, row, tb, c0);
        put(a, w, row, tb + H, c1);
        put(a, w, row, tb + 2 * H, c2);
      }
      buf ^= 1;  // the next round stages into the other buffers
    }
  }
  if constexpr (kGrouped) {
    // the live cells, dealt out over the row warp's P warps: warp sg takes
    // cells sg, sg + P, ... (in (slot, cell) order) and recomputes their
    // slot terms
    if (live_warp) {
      for (int c = sg; c < S * G; c += P) {
        const int s = c / G, g = c - s * G;
        const float act = sgact[c];
        if (act == 0.0f) continue;  // dead cell: zeros, written by the fold
        SlotTerms t;
        if constexpr (CT > 0)
          t = terms(m, vreg, k, a.B, C, s);
        else
          t = terms(m, m.vals + r * m.cs, k, a.B, C, s);
        const float colv = m.vals[r * m.cs + sgcol[s]];
        float ind;
        if (g < G - 1) {
          ind = __fmul_rn(colv == sgval[c] ? 1.0f : 0.0f, act);
        } else {
          // the tracked cells' indicators, summed in cell order (a dead
          // cell's would add ±0)
          float tracked = 0.0f;
          for (int g2 = 0; g2 < G - 1; ++g2) {
            const float a2 = sgact[s * G + g2];
            if (a2 != 0.0f)
              tracked = __fadd_rn(tracked,
                                  __fmul_rn(colv == sgval[s * G + g2] ? 1.0f : 0.0f, a2));
          }
          ind = __fmul_rn(__fsub_rn(1.0f, tracked), act);
        }
        const float e0 = __fmul_rn(ind, t.mask);
        const float gx = __fmul_rn(ind, t.x);
        const float e3 = __fmul_rn(ind, t.pm);
        float* dst = gred + ((rw * S + s) * G + g) * 4;
        // a warp whose cell terms are all ±0 sums to ±0: write +0 instead
        // (NaN compares unequal to 0, so it is reduced)
        if (__any_sync(0xffffffffu, e0 != 0.0f || gx != 0.0f || e3 != 0.0f)) {
          const float c0 = warp_sum(e0);
          const float c1 = warp_sum(gx);
          const float c2 = warp_sum(__fmul_rn(gx, gx));
          const float c3 = warp_sum(e3);
          if (lane == 0) {
            dst[0] = c0;
            dst[1] = c1;
            dst[2] = c2;
            dst[3] = c3;
          }
        } else if (lane == 0) {
          dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
        }
      }
    }
  }
  __syncthreads();  // warp partials in shared memory

  // 4. the tile's sums, row warps in order
  for (int i = tid; i < S * 4; i += T) {
    float acc = 0.0f;
    for (int wp = 0; wp < nlw; ++wp) acc += m.red[wp * S * 4 + i];
    put(a, w, row, i, acc);
  }
  if constexpr (kGrouped) {
    for (int i = tid; i < S * G * 4; i += T) {
      float acc = 0.0f;
      if (sgact[i >> 2] != 0.0f)
        for (int wp = 0; wp < nlw; ++wp) acc += gred[wp * S * G * 4 + i];
      put(a, w, row, S * 4 + i, acc);
    }
  }
  // more than one tile: the worker's last block folds the tiles in order.
  // An integer counter finds it; thread 0's fences, after and before the
  // block's barriers, order every thread's scratch writes before the count
  // and the other tiles' rows before the fold (as cooperative groups' grid
  // barrier does)
  if (gridDim.x > 1) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last_block = atomicAdd(a.counters + w, 1) == (int)gridDim.x - 1;
      if (last_block) __threadfence();
    }
    __syncthreads();
  }
  if (a.cols != nullptr) {  // the decoded window, coalesced, past the fence
    float* dst = a.cols + ((long long)w * a.B + k0) * C;
    for (int i = tid; i < R * C; i += T) dst[i] = m.vals[(i / C) * m.cs + i % C];
  }
  if (gridDim.x == 1 || !last_block) return;
  const int nt = gridDim.x;
  const float4* src = reinterpret_cast<const float4*>(a.scratch + (long long)w * nt * row);
  for (int q = tid; q < row / 4; q += T) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t0 = 0; t0 < nt; t0 += 16) {
      // sixteen tiles' loads in flight, then added in tile order
      float4 x[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        x[u] = t0 + u < nt ? __ldcg(src + (long long)(t0 + u) * (row / 4) + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (t0 + u < nt) {
          acc[0] += x[u].x;
          acc[1] += x[u].y;
          acc[2] += x[u].z;
          acc[3] += x[u].w;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < nl) *lane_ptr(a, w, 4 * q + c) = acc[c];
  }
  if (tid == 0) a.counters[w] = 0;
}

// Host side: launch `kernel` (an instantiation of a kernel that runs body)
// over the (tiles, W) grid.  `smem_set` remembers the dynamic shared memory
// this instantiation was last allowed, so the attribute is set once.
inline int launch(void (*kernel)(Args), Args a, bool grouped, int* smem_set,
                  cudaStream_t st) {
  if (a.W < 1 || a.W > 65535 || a.B < 1 || a.S < 1 || a.C < 1)
    return (int)cudaErrorInvalidValue;
  const int T = threads(a.B, a.S, grouped);
  a.stage_words = stage_words(a.B, a.C, T);
  const size_t smem =
      layout(a.C, a.S, a.G, a.H, T, 32 * row_warps(a.B), a.stage_words, grouped).total;
  if (smem > 48 * 1024 && (long long)smem > (long long)*smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *smem_set = (int)smem;
  }
  kernel<<<dim3(tiles(a.B), a.W), T, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tile
}  // namespace slot
