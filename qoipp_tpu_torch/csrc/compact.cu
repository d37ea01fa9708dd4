// K3: stable stream compaction of the encoder's chunk rows.
//
// Replaces qoipp_tpu/ops/compact_kernel.py: compact_rows (the Pallas body
// _compact_kernel).
//
// out[p][b, gidx[b, r]] = plane[p][b, r] for every kept row r, where gidx
// is the exclusive running count of kept rows (computed by torch.cumsum in
// the wrapper, as the JAX package computes it outside its kernel).  Rows at
// or past a lane's count are left unwritten (unspecified, as in the JAX
// package); a row whose gidx reaches cap is dropped, so an overflowing lane
// never writes out of bounds (the encoder flags it through `ok`).
//
// What bounds it on the card: memory traffic — keep + gidx + P planes read
// once, the kept rows written once.  The TPU needed one-hot MXU products
// because its scatter was serial; Hopper scatters natively.
// What the design does: one thread per row; reads are coalesced, and since
// gidx is monotone with steps of at most one, the writes of a warp land in
// one contiguous run as well.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 4;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ keep,
               const int32_t* __restrict__ gidx, Planes planes, int nplanes,
               long long N, long long cap) {
  const int b = blockIdx.y;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= N) return;
  const long long i = (long long)b * N + r;
  if (!keep[i]) return;
  const long long g = gidx[i];
  if (g >= cap) return;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p)
    if (p < nplanes) planes.out[p][(long long)b * cap + g] = planes.in[p][i];
}

}  // namespace

// keep (B, N) bool, gidx (B, N) int32, in_p (B, N) -> out_p (B, cap), for
// p < nplanes <= 4 (unused plane pointers may be null).
QK_API int qk_compact(const void* keep, const void* gidx, int nplanes,
                      const void* in0, const void* in1, const void* in2,
                      const void* in3, void* out0, void* out1, void* out2,
                      void* out3, int B, long long N, long long cap,
                      void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes planes{{static_cast<const uint32_t*>(in0),
                 static_cast<const uint32_t*>(in1),
                 static_cast<const uint32_t*>(in2),
                 static_cast<const uint32_t*>(in3)},
                {static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
                 static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3)}};
  const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads), B);
  compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep), static_cast<const int32_t*>(gidx),
      planes, nplanes, N, cap);
  return qk::launch_status();
}
