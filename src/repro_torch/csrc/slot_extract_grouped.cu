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
// What bounds it on the H100.  Not bytes: at W=4, B=4096, C=4 (64-byte
// records) it reads 1 MiB of rows and writes under 0.2 MiB, 0.4 µs at 3.35
// TB/s; at the deployment's B = 8, nanoseconds.  What is left is latency
// and serial work inside a block.  The first port ran two launches, 256
// threads per block whatever B was, one warp per slot reducing every cell
// (S·G·4 warp reductions, live cell or not), and a tally pass in which a
// thread scanned all 256 staged rows of the block for each discovering
// slot: 47.5-48.0 µs at B = 8 (H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// Design (slot_tile.cuh, shared with slot_extract.cu, so the (W, S, 4)
// output is that kernel's bit for bit).  One launch for every B; rows
// issued together with cp.async and parsed by the thread that copied them;
// only row warps with live rows work, each repeated up to 16 warps a block.
// The TPU kernel selects the group column with a one-hot matmul; that
// contraction is exact, so here the thread reads the column directly.  The
// live cells are dealt out over a row warp's repeats (B = 8: one or two a
// warp); a cell whose gact is 0 is written as zeros without reducing, and
// a warp whose terms for a live cell are all zero skips its four shuffle
// trees.  Every other cell goes through the scalar lanes' warp shuffles and
// warp order, and every mask factor is an exact 0/1 float, so a tracked
// cell's sums are, bit for bit, those kernel 1 gives a fan-out slot whose
// predicate carries the group conjunct (chip_smoke.py checks it).  The TPU
// tallies are a (3, B) x (B, H) one-hot matmul per slot; here each warp
// finds the rows of each bucket with __match_any_sync and leaves a 32-bit
// row mask per (row warp, bucket) in shared memory, and one thread per
// (slot, bucket) walks the masks in warp order and sums only its bucket's
// rows, in row order, eight loads at a time (serial length: the bucket's
// rows, not 256).  One block barrier per round of slots (the staging is
// double-buffered).  No float atomics: the tallies, and so the host's
// promotions, are the same from run to run.  chip_smoke.py times it beside
// its bound.

#include "slot_tile.cuh"

using namespace slot;

namespace {

template <int CT>
__global__ void __launch_bounds__(32 * tile::kMaxWarps) grouped_tiles(const tile::Args a) {
  tile::body<CT, true>(a);
}

int smem_set[3];

}  // namespace

extern "C" int slot_extract_grouped_launch(
    const uint8_t* packed, long long n_chunks, long long m_max, int num_cols,
    const int* jw, const int* idx, const int* b_eff, const float* coeffs,
    const float* lo, const float* hi, const float* is_count, const float* gate,
    const float* weights, const int* gcol, const float* gval, const float* gact,
    const int* salt, int W, int B, int S, int G, int H, float* stats,
    float* gstats, float* tal, float* cols, float* scratch, int* counters,
    void* stream) {
  if (H < 2 || (H & (H - 1)) != 0 || G < 1) return (int)cudaErrorInvalidValue;
  int lg = 0;
  while ((1 << lg) < H) ++lg;
  tile::Args a{};
  a.packed = packed;
  a.n_chunks = n_chunks;
  a.m_max = m_max;
  a.C = num_cols;
  a.W = W;
  a.B = B;
  a.S = S;
  a.jw = jw;
  a.idx = idx;
  a.b_eff = b_eff;
  a.coeffs = coeffs;
  a.lo = lo;
  a.hi = hi;
  a.is_count = is_count;
  a.gate = gate;
  a.weights = weights;
  a.gcol = gcol;
  a.gval = gval;
  a.gact = gact;
  a.salt = salt;
  a.G = G;
  a.H = H;
  a.hshift = 32 - lg;
  a.stats = stats;
  a.gstats = gstats;
  a.tal = tal;
  a.cols = cols;
  a.scratch = scratch;
  a.counters = counters;
  if (tile::tiles(B) > 1 && (scratch == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_cols == 16) return tile::launch(grouped_tiles<16>, a, true, &smem_set[0], st);
  if (num_cols == 4) return tile::launch(grouped_tiles<4>, a, true, &smem_set[1], st);
  return tile::launch(grouped_tiles<0>, a, true, &smem_set[2], st);
}

extern "C" int slot_extract_grouped_tile_rows() { return tile::kTileRows; }
