// K4: encoder byte emission.
//
// Replaces qoipp_tpu/ops/emit_kernel.py: emit_bytes (the Pallas body
// _emit_kernel).
//
// Row r of the compacted chunk stream writes min(off[r+1] - off[r], 6)
// bytes of its 6-byte template (tlo bytes 0-3, thn bytes 4-5) at off[r];
// the last row takes off[C] = out_cap + 8192, as the JAX wrapper's pad
// does.  Bytes at or past out_cap are dropped.  Every other byte keeps the
// zero the wrapper allocated; the caller writes the header and zeroes
// everything past the stream end.
//
// What bounds it on the card: memory traffic — 12 bytes read per row and
// each stream byte written once (plus the wrapper's zero fill of the
// output).  The TPU needed one-hot MXU placement and log-shift fills
// because its scatter was serial; Hopper stores bytes natively.
// What the design does: one thread per row; the off/tlo/thn reads are
// coalesced, and a warp's byte stores fall in one contiguous span of at
// most 6 * 32 bytes.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kPastEnd = 8192;  // off[C] = out_cap + kPastEnd

__global__ void __launch_bounds__(kThreads)
emit_kernel(const int32_t* __restrict__ off, const uint32_t* __restrict__ tlo,
            const uint32_t* __restrict__ thn, uint8_t* __restrict__ out,
            long long C, long long out_cap) {
  const int b = blockIdx.y;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= C) return;
  const long long i = (long long)b * C + r;
  const long long o = off[i];
  const long long nxt = r + 1 < C ? (long long)off[i + 1] : out_cap + kPastEnd;
  const long long n = min(nxt - o, 6LL);
  if (n <= 0) return;
  const uint32_t lo = tlo[i], hn = thn[i];
  uint8_t* dst = out + (long long)b * out_cap;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const long long pos = o + k;
    if (k < n && pos >= 0 && pos < out_cap)
      dst[pos] = static_cast<uint8_t>(k < 4 ? lo >> (8 * k) : hn >> (8 * (k - 4)));
  }
}

}  // namespace

// off (B, C) int32, tlo/thn (B, C) uint32 -> out (B, out_cap) uint8, which
// the caller zero-fills.
QK_API int qk_emit(const void* off, const void* tlo, const void* thn,
                   void* out, int B, long long C, long long out_cap,
                   void* stream) {
  const dim3 grid(static_cast<unsigned>((C + kThreads - 1) / kThreads), B);
  emit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(off), static_cast<const uint32_t*>(tlo),
      static_cast<const uint32_t*>(thn), static_cast<uint8_t*>(out), C,
      out_cap);
  return qk::launch_status();
}
