// E5: the windowed placement, narrow groups placed output-driven.
//
// Replaces benchmarks/expt_place_narrow.py: place_fill_narrow
// (make_narrow_kernel).  The function is K2's (csrc/place_fill.cu,
// ops/place_window.py): row r of an image writes emits[r] at pixel pb[r]
// iff pb[r+1] > pb[r] (pb[Q] := n_cap) and pb[r] < n_cap; inside each
// window of 8,192 pixels a pixel takes the word of the nearest writer at
// or to its left in the window, at most 63 away, and any other pixel the
// carry, the previous window's last output (0 in an image's first window).
// The plain version is ops/place_kernel.place_fill_reference.
//
// What the experiment asks, and keeps here: a group is 128 consecutive
// candidate rows, aligned to the window's first slab.  A group whose
// writers in the window span at most ns stripes of 128 pixels is placed
// output-driven: the warp walks the ns stripes from its first writer's
// stripe (clamped to the window's last ns), passes over a stripe outside
// its writers' with one test, and builds each 32-pixel mask word of the
// others with one warp reduction (__reduce_or_sync) of its lanes'
// writers' bits, so no writer takes a shared atomic; a word
// strictly between the words of the group's first and last writer holds
// no other group's writer (pb is nondecreasing), so it is stored whole,
// and only those two take an atomicOr.  The writers store their words.
// A wider group is placed row-driven (qk::win::place_rows), an atomicOr a
// mask word a lane touches.  ns is a runtime argument, 1 <= ns <= 64; at
// 64 every group is narrow.
//
// What bounds it on the card: bytes, 8 per candidate row read and 4 per
// pixel written; at the experiment's sizes a launch is ~250 blocks in one
// partial wave, so a block's latency over its rows is the time.  The rest
// of the design is E6's (csrc/place_variant.cu, qk::win in
// qoipp_kernels.cuh): one window a block in ticket order, one group a warp
// with more in flight in registers, four consecutive rows a lane, the span
// from __reduce_min_sync / __reduce_max_sync (no shared atomic, no block
// sync a group), a 1 KB mask and quad_nearest for the fill, the decoupled
// look-back and 16-byte stores.
#include "qoipp_kernels.cuh"

namespace {

using namespace qk::win;

// Place one group of a warp.  ns: the narrow span in stripes.
__device__ __forceinline__ void place_group(Window& s, const Rows& t, int w0,
                                            int ns) {
  const int lane = threadIdx.x & 31;
  const Lane r = lane_rows(t);
  int wx[4];  // the lane's writers' pixels in the window, -1 for other rows
  int xmin = kWin, xmax = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = r.p[k] - w0;
    const bool w = static_cast<unsigned>(x) < static_cast<unsigned>(kWin) &&
                   r.n[k] > r.p[k];
    wx[k] = w ? x : -1;
    if (w) {
      xmin = min(xmin, x);
      xmax = max(xmax, x);
    }
  }
  xmin = __reduce_min_sync(kFull, xmin);
  xmax = __reduce_max_sync(kFull, xmax);
  if (xmax < 0) return;  // no writer in the window
  if ((xmax >> 7) - (xmin >> 7) >= ns) {
    place_rows(s, r, w0);
    return;
  }
  // output-driven over the ns stripes from the first writer's (clamped to
  // the window's last ns): the warp builds each 32-pixel mask word of the
  // span's stripes that hold a writer with one reduction over its lanes'
  // writers, a stripe's four at once
  int at[4];       // the mask word of each of the lane's writers
  uint32_t bit[4];  // its bit there, 0 for the other rows
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (wx[k] >= 0) s.word[wx[k]] = r.e[k];
    at[k] = wx[k] >> 5;
    bit[k] = wx[k] >= 0 ? 1u << (wx[k] & 31) : 0u;
  }
  const int m0 = min(xmin >> 7, kStripes - ns) * 4;  // the span's first word
  for (int m = m0; m < m0 + 4 * ns; m += 4) {
    // a stripe outside the writers' holds no bit: passed over at once
    if (m < (xmin >> 7) * 4 || m > (xmax >> 7) * 4) continue;
    uint32_t bits[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bits[j] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (at[k] == m + j) bits[j] |= bit[k];
      bits[j] = __reduce_or_sync(kFull, bits[j]);
    }
    // lane j stores word m + j; a word strictly between the first and the
    // last writer's holds no other group's writer: stored whole, the two
    // ends OR-ed
    const uint32_t mine = lane == 0   ? bits[0]
                          : lane == 1 ? bits[1]
                          : lane == 2 ? bits[2]
                                      : bits[3];
    const int mj = m + lane;
    if (lane < 4 && mine) {
      if (mj == xmin >> 5 || mj == xmax >> 5) atomicOr(&s.mask[mj], mine);
      else s.mask[mj] = mine;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
place_narrow_kernel(const int32_t* __restrict__ pb,
                    const uint32_t* __restrict__ em,
                    const int32_t* __restrict__ base,
                    uint32_t* __restrict__ out, unsigned long long* status,
                    long long Q, int n_cap, bool vec, int ns) {
  __shared__ Window s;
  const Span sp = begin(s, status, base, pb, em, Q, n_cap, true);
  for_each_group(sp, n_cap, vec, [&](const Rows& t) {
    place_group(s, t, sp.w0, ns);
  });
  finish<63>(s, sp, status, out, n_cap);
}

}  // namespace

// Resident blocks an SM (or a negative CUDA error); threads a block in
// *threads.
QK_API int qk_place_narrow_occupancy(int* threads) {
  return qk::win::occupancy(place_narrow_kernel, threads);
}

// pb (B, Q) int32 nondecreasing, emits (B, Q) uint32, base (B, n_cap / 8192
// + 1) int32 (window_base_rows), out (B, n_cap) uint32, status (B * n_cap
// / 8192 + 1) zeroed 64-bit words (one per window, then the ticket); n_cap
// a multiple of 8192 below 2^31; 1 <= ns <= 64.
QK_API int qk_place_narrow(const void* pb, const void* emits, const void* base,
                           void* out, void* status, int B, long long Q,
                           long long n_cap, int ns, void* stream) {
  if (!qk::win::shape_ok(B, Q, n_cap) || ns < 1 || ns > kStripes)
    return static_cast<int>(cudaErrorInvalidValue);
  place_narrow_kernel<<<static_cast<unsigned>(B * (n_cap / kWin)), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, static_cast<int>(n_cap),
      qk::win::rows_vec(pb, emits, Q), ns);
  return qk::launch_status();
}
