// K6: log-fill, the gap fill of the one-shot decoder's pixel expansion.
//
// Replaces qoipp_tpu/ops/replay_kernel.py: logfill_batch (the Pallas body
// _logfill_kernel).
//
// Along each row of (B, n) words, out[w] is the nearest word in [w - 63, w]
// with bit 31 set (a slot the expansion wrote); where there is none it is
// words[w - 63] (0 before the row start).  That is exactly what the six
// doubling passes of the TPU kernel and of the plain version compute, for
// any input; on the decoder's input the unflagged words are 0, so a word
// with no flagged word in reach reads 0.
//
// What bounds it on the card: bytes.  Each word is read once from HBM and
// written once, 8 bytes per word at 3.35 TB/s.
// What the design does: each warp walks a segment of kSeg words of one
// row, 32 words a step, kUnroll steps loaded at once; it keeps the last
// two steps' words and their __ballot_sync flag masks in registers, so the
// 64 words before a step are always at hand.  For word w (lane l of the
// step) the flags of [w - 63, w] are the step's mask up to bit l and the
// two earlier masks above bit l; the highest set bit (__clz, __clzll)
// names the source word, fetched by __shfl_sync from the register that
// holds it, and the fallback words[w - 63] is fetched the same way.  A
// warp starts with the two steps before its segment (two extra coalesced
// loads); no shared memory, no search.  The TPU kernel's 128-word halo
// input and its block-divisibility rule were Mosaic layout constraints and
// are gone: the ragged row end is masked.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;         // 32-word steps a warp
constexpr int kSeg = 32 * kSteps;  // words a warp
constexpr int kUnroll = 8;         // steps loaded at once
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t load(const uint32_t* row, long long w,
                                         long long n) {
  return w >= 0 && w < n ? row[w] : 0u;
}

__global__ void __launch_bounds__(kThreads)
logfill_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
               long long n) {
  const int lane = threadIdx.x & 31;
  const long long seg0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kSeg;
  if (seg0 >= n) return;  // the whole warp
  const uint32_t* row = words + static_cast<long long>(blockIdx.y) * n;
  uint32_t* orow = out + static_cast<long long>(blockIdx.y) * n;
  // the two steps before the current one: words and flag masks
  uint32_t p2 = load(row, seg0 - 64 + lane, n);
  uint32_t p1 = load(row, seg0 - 32 + lane, n);
  uint32_t f2 = __ballot_sync(kFull, p2 >> 31);
  uint32_t f1 = __ballot_sync(kFull, p1 >> 31);
  const uint32_t upto = kFull >> (31 - lane);          // bits 0..lane
  const unsigned long long above = ~0ull << (lane + 1);  // bits lane+1..63
  for (int s = 0; s < kSteps; s += kUnroll) {
    const long long w0 = seg0 + 32 * s + lane;
    uint32_t v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = load(row, w0 + 32 * k, n);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const uint32_t f0 = __ballot_sync(kFull, v[k] >> 31);
      const uint32_t here = f0 & upto;  // flags in [step start, w]
      // flags in [w - 63, step start): bit j is word step start - 64 + j
      const unsigned long long back =
          ((static_cast<unsigned long long>(f1) << 32) | f2) & above;
      const int near = 31 - __clz(here);
      // the nearest flag before the step, else words[w - 63] (bit lane + 1)
      const int pos = back ? 63 - __clzll(back) : lane + 1;
      const uint32_t a = __shfl_sync(kFull, v[k], near & 31);
      const uint32_t b1 = __shfl_sync(kFull, p1, (pos - 32) & 31);
      const uint32_t b2 = __shfl_sync(kFull, p2, pos & 31);
      const long long w = w0 + 32 * k;
      if (w < n) orow[w] = here ? a : (pos >= 32 ? b1 : b2);
      p2 = p1, f2 = f1;
      p1 = v[k], f1 = f0;
    }
  }
}

}  // namespace

// words/out (B, n) row-major uint32 (int32 on the Python side).
QK_API int qk_logfill(const void* words, void* out, int B, long long n,
                      void* stream) {
  const long long per_block = static_cast<long long>(kWarps) * kSeg;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), B);
  logfill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n);
  return qk::launch_status();
}
