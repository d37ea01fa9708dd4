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
// written once, 8 bytes per word at 3.35 TB/s; the search is at most 64
// shared-memory reads per word and usually a few (RUN gaps are <= 61).
// What the design does: one block per tile of kTile words of one row
// stages the tile and the 63 words before it in shared memory (coalesced
// loads), then each thread resolves its words from there.  The TPU
// kernel's 128-word halo input and its block-divisibility rule were
// Mosaic layout constraints and are gone: the halo is read in place and
// the ragged row end is masked.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // words per block
constexpr int kReach = 63;   // words looked back

__global__ void __launch_bounds__(kThreads)
logfill_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
               long long n) {
  __shared__ uint32_t buf[kReach + kTile];  // buf[kReach + j] = word t0 + j
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long row = (long long)blockIdx.y * n;
  for (int j = threadIdx.x; j < kReach + kTile; j += kThreads) {
    const long long w = t0 - kReach + j;
    buf[j] = (w >= 0 && w < n) ? words[row + w] : 0u;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kTile && t0 + j < n; j += kThreads) {
    uint32_t v = buf[j];  // words[w - 63]: the result when none is flagged
    for (int k = kReach + j; k >= j; --k) {
      if (buf[k] >> 31) {
        v = buf[k];
        break;
      }
    }
    out[row + t0 + j] = v;
  }
}

}  // namespace

// words/out (B, n) row-major uint32 (int32 on the Python side).
QK_API int qk_logfill(const void* words, void* out, int B, long long n,
                      void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile), B);
  logfill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n);
  return qk::launch_status();
}
