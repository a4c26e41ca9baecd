// EXTRACT: fixed-width ASCII records -> float32 columns, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/extract_parse.py::
// extract_parse_pallas (kernel body _extract_kernel):
//   raw (T, 16*C) u8  ->  out (T, C) f32
//
// Design.  One record per thread, grid ceil(T / 256): the thread loads its
// record's fields with one 16-byte load each and parses them with
// slot_common.cuh's parse_field, the same function the round kernels
// (slot_extract.cu, slot_extract_stream.cu) parse with.  That is the point
// of this kernel in the port: it fills the parse-once decoded-chunk cache
// on the card, so a chunk's decoded rounds see exactly the floats its raw
// and packed rounds see.
//
// Bound on the card: one 65,536-record chunk at C = 16 reads 16 MiB and
// writes 4 MiB, about 6.3 µs at 3.35 TB/s.  Loads are uncoalesced (one
// thread, one 256-byte record); staging through shared memory is left for
// a later change.

#include "slot_common.cuh"

using namespace slot;

namespace {

constexpr int kParseThreads = 256;

__global__ void parse_rows(const uint8_t* __restrict__ raw, long long T,
                           int num_cols, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kParseThreads + threadIdx.x;
  if (t >= T) return;
  parse_record(raw + t * (long long)(num_cols * kFieldBytes), num_cols,
               out + t * num_cols);
}

}  // namespace

extern "C" int extract_parse_launch(const uint8_t* raw, long long T,
                                    int num_cols, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblk = (T + kParseThreads - 1) / kParseThreads;
  parse_rows<<<(unsigned int)nblk, kParseThreads, 0, st>>>(raw, T, num_cols, out);
  return (int)cudaGetLastError();
}
