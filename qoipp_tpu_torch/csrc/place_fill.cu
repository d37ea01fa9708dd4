// K2: decode pixel placement + run fill.
//
// Replaces qoipp_tpu/ops/place_kernel.py: place_fill (the Pallas body
// _place_fill_kernel).
//
// pb (B, Q) int32 is each row's pixel offset (exclusive prefix sum of the
// pixels its chunk produces), nondecreasing; row r starts a chunk iff
// pb[r+1] > pb[r] and writes emits[r] over [pb[r], pb[r+1]).  Output-driven
// form: pixel p takes emits[r*] where r* is the LAST row with pb[r*] <= p.
// That row is the chunk start covering p (pb[r*+1] > p >= pb[r*]); rows
// with pb >= n_cap are never chosen for p < n_cap; past the last chunk the
// last row repeats the running value; a pixel before pb[0] reads 0 (the
// TPU kernel's initial fill carry).
//
// What bounds it on the card: memory traffic — n_cap words written and the
// pb / emits rows read per image; a pixel's search is log2(Q) dependent
// loads.  What the design does: each block first narrows the search to the
// rows that can cover its own 1024 pixels (two searches by one thread), so
// every thread searches a range of a few thousand rows that stays in L1/L2
// and neighbouring threads walk the same path; writes are fully coalesced
// and no pixel is written twice, so no zero fill or second pass is needed.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 1024;  // pixels per block

// first index in [lo, hi) with row[i] > p (hi if none)
__device__ __forceinline__ long long upper_bound(const int32_t* row,
                                                 long long lo, long long hi,
                                                 long long p) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row[mid] <= p)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
place_fill_kernel(const int32_t* __restrict__ pb,
                  const uint32_t* __restrict__ emits,
                  uint32_t* __restrict__ out, long long Q, long long n_cap) {
  __shared__ long long range[2];
  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long p = p0 + threadIdx.x;
  const int32_t* row = pb + (long long)b * Q;
  if (threadIdx.x == 0) {
    const long long p_last = min(p0 + kThreads, n_cap) - 1;
    range[0] = upper_bound(row, 0, Q, p0);
    range[1] = upper_bound(row, range[0], Q, p_last);
  }
  __syncthreads();
  if (p >= n_cap) return;
  const long long r = upper_bound(row, range[0], range[1], p);
  out[(long long)b * n_cap + p] = r == 0 ? 0u : emits[(long long)b * Q + r - 1];
}

}  // namespace

// pb (B, Q) int32, emits (B, Q) uint32 -> out (B, n_cap) uint32.
QK_API int qk_place_fill(const void* pb, const void* emits, void* out, int B,
                         long long Q, long long n_cap, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_cap + kThreads - 1) / kThreads), B);
  place_fill_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<uint32_t*>(out), Q, n_cap);
  return qk::launch_status();
}
