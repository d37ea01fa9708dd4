// Shared definitions of the qoipp_tpu_torch CUDA kernels (sm_90a).
//
// Pixel words are uint32 r | g<<8 | b<<16 | a<<24; on the Python side they
// travel as int32 tensors with the same bits.  Every C entry point takes its
// tensors as raw device pointers plus the CUDA stream, launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the ctypes
// wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define QK_API extern "C" __attribute__((visibility("default")))

namespace qk {

constexpr uint32_t kStartPixel = 0xFF000000u;  // (0, 0, 0, 255)
constexpr int kStartHash = (11 * 255) % 64;     // hash of the start pixel: 53

__device__ __forceinline__ uint32_t hash6(uint32_t v) {
  return ((v & 0xFFu) * 3u + ((v >> 8) & 0xFFu) * 5u +
          ((v >> 16) & 0xFFu) * 7u + (v >> 24) * 11u) & 63u;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// The decoupled look-back of the windowed placements (K2, E2-E6), which
// carries each window's (or unit's) last output into the next.  A launch
// owns `units` 64-bit status words, zeroed before it, one per unit in
// (image, unit) order, and then the ticket counter.  A block takes its unit
// from the ticket, so it only ever waits on units with lower tickets, which
// are already running.  A status word is 0 until published, then kInherit
// (the unit's last pixel takes its carry) or kValue | the unit's last
// output.
constexpr unsigned long long kInherit = 1ull << 32;
constexpr unsigned long long kValue = 2ull << 32;

// The unit this block works on (thread 0 alone).
__device__ __forceinline__ long long take_ticket(unsigned long long* status,
                                                 long long units) {
  return static_cast<long long>(atomicAdd(status + units, 1ull));
}

// Publish unit `me`'s last output `last` if the unit owns it, else
// "inherit".
__device__ __forceinline__ void publish(unsigned long long* status,
                                        long long me, bool own,
                                        uint32_t last) {
  atomicExch(status + me, own ? (kValue | last) : kInherit);
}

// The carry into unit `me` (thread 0 alone): the last output of the
// nearest earlier unit of its image (status index >= first) whose value is
// known, 0 if none.  An inheriting unit then publishes what this returns.
__device__ inline uint32_t walk_back(unsigned long long* status,
                                     long long me, long long first) {
  for (long long v = me - 1; v >= first; --v) {
    unsigned long long st;
    while ((st = *reinterpret_cast<volatile unsigned long long*>(
                status + v)) == 0)
      __nanosleep(32);
    if (st >= kValue) return static_cast<uint32_t>(st);
  }
  return 0u;
}

// The bit-mask fill of E3 and E4: pixel p of a block's region is written
// iff bit p % 32 of mask word p / 32 is set.  For the quad x .. x + 3
// (x % 4 == 0, one mask word), src[i] is pixel x + i's nearest written
// pixel at or before it, at most 63 away and not before the region part
// that starts at mask word `first`, or -1.  It is searched in the quad's
// own word and the kWords - 1 words before it: kWords = 3 reaches 63;
// kWords = 2 reaches at least 32, enough wherever every written pixel's
// next written pixel is at most 8 after it.
template <int kWords>
__device__ __forceinline__ void quad_nearest(const uint32_t* mask, int x,
                                             int first, int src[4]) {
  static_assert(kWords == 2 || kWords == 3, "one or two words back");
  const int k = x >> 5;
  const uint32_t m0 = mask[k];
  const uint32_t m1 = k - 1 >= first ? mask[k - 1] : 0u;
  const uint32_t m2 = kWords == 3 && k - 2 >= first ? mask[k - 2] : 0u;
  const int back = m1   ? ((k - 1) << 5) + 31 - __clz(m1)
                   : m2 ? ((k - 2) << 5) + 31 - __clz(m2)
                        : -1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = x + i;
    const uint32_t mine = m0 & (0xFFFFFFFFu >> (31 - (p & 31)));
    const int s = mine ? (k << 5) + 31 - __clz(mine) : back;
    src[i] = s >= 0 && p - s <= 63 ? s : -1;
  }
}

}  // namespace qk
