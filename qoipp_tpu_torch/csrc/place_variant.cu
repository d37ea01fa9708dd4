// E6: the windowed placement with its stages knocked out at compile time.
//
// Replaces benchmarks/expt_place_fixed.py: place_variant (make_kernel),
// which located the TPU K2's per-window fixed cost by ablation.  The full
// variant computes K2's function (csrc/place_fill.cu, ops/place_window.py):
// row r of an image writes emits[r] at pixel pb[r] iff pb[r+1] > pb[r]
// (pb[Q] := n_cap) and pb[r] < n_cap; inside each window of 8,192 pixels a
// pixel takes the word of the nearest writer at or to its left in the
// window, at most 2^kFill - 1 away, and any other pixel the carry, the
// previous window's last output (0 in an image's first window).  The plain
// version is ops/place_kernel.place_fill_reference at (n_fill, place).
//
// What the experiment asks, and keeps here: the knobs are template
// parameters, one instantiation each,
//   kDma = false: no candidate row is read (nor base_step);
//   kSlabs = false: nothing is placed, so every pixel reads 0;
//   kFill: the fill's reach, 2^kFill - 1 (kFill = 0: a pixel has a word
//          only where it was written itself; every other pixel takes the
//          carry).
// Their differences give each stage's device time: the row reads
// (dma-only - bare), the fill (no-slabs - dma-only), the placement (full -
// no-slabs); bare is the fixed cost of ticket, look-back and stores.
//
// What bounds it on the card: bytes, 8 per candidate row read and 4 per
// pixel written; at the experiment's sizes (8 images of ~254 K pixels,
// ~17 K candidate rows a window) a launch is ~250 blocks in one partial
// wave, so a block's latency over its rows is the time.  The design, one
// window a block (qk::win, qoipp_kernels.cuh): a ticket, 128-row groups a
// warp with kStages - 1 more groups of loads in flight in registers, a
// writer's word into a 32 KB shared array and its bit into a 1 KB mask,
// qk::quad_nearest at the reach for the fill, the decoupled look-back and
// 16-byte stores.
//
// With kDma and not kSlabs no row that is read is used, and the compiler
// would delete the loads: every word read is folded into one value that is
// stored only if `observe` is set.  The entry passes 0, but the kernel
// cannot know that, so the loads stay.
#include "qoipp_kernels.cuh"

namespace {

using namespace qk::win;

template <bool kDma, bool kSlabs, int kFill>
__global__ void __launch_bounds__(kThreads, 2)
place_variant_kernel(const int32_t* __restrict__ pb,
                     const uint32_t* __restrict__ em,
                     const int32_t* __restrict__ base,
                     uint32_t* __restrict__ out, unsigned long long* status,
                     long long Q, int n_cap, bool vec, int observe) {
  static_assert(kDma || !kSlabs, "placing rows needs them read");
  __shared__ Window s;
  const Span sp = begin(s, status, base, pb, em, Q, n_cap, kDma);
  if (kDma) {
    uint32_t fold = 0u;  // not kSlabs: every word read, xor-folded
    for_each_group(sp, n_cap, vec, [&](const Rows& t) {
      if (kSlabs) {
        place_rows(s, lane_rows(t), sp.w0);
      } else {
        fold ^= t.p.x ^ t.p.y ^ t.p.z ^ t.p.w ^ t.e.x ^ t.e.y ^ t.e.z ^
                t.e.w ^ static_cast<uint32_t>(t.after);
        // the fold waits for this group's loads, as the placement would,
        // before the next group's loads are issued
        asm volatile("" : "+r"(fold) : : "memory");
      }
    });
    if (!kSlabs && observe) out[sp.b * n_cap + sp.w0 + threadIdx.x] = fold;
  }
  finish<(1 << kFill) - 1>(s, sp, status, out, n_cap);
}

template <bool kDma, bool kSlabs, int kFill>
int launch(int B, cudaStream_t stream, const void* pb, const void* emits,
           const void* base, void* out, void* status, long long Q,
           long long n_cap) {
  place_variant_kernel<kDma, kSlabs, kFill>
      <<<static_cast<unsigned>(B * (n_cap / kWin)), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, static_cast<int>(n_cap),
      qk::win::rows_vec(pb, emits, Q), 0);
  return qk::launch_status();
}

template <bool kDma, bool kSlabs>
int launch_fill(int n_fill, int B, cudaStream_t stream, const void* pb,
                const void* emits, const void* base, void* out, void* status,
                long long Q, long long n_cap) {
#define QK_VARIANT(F)                                                      \
  case F:                                                                 \
    return launch<kDma, kSlabs, F>(B, stream, pb, emits, base, out, status, \
                                   Q, n_cap);
  switch (n_fill) {
    QK_VARIANT(0) QK_VARIANT(1) QK_VARIANT(2) QK_VARIANT(3)
    QK_VARIANT(4) QK_VARIANT(5) QK_VARIANT(6)
  }
#undef QK_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Resident blocks an SM of the full variant (or a negative CUDA error);
// its threads a block in *threads.
QK_API int qk_place_variant_occupancy(int* threads) {
  return qk::win::occupancy(place_variant_kernel<true, true, 6>, threads);
}

// pb (B, Q) int32 nondecreasing, emits (B, Q) uint32, base (B, n_cap / 8192
// + 1) int32 (window_base_rows), out (B, n_cap) uint32, status (B * n_cap
// / 8192 + 1) zeroed 64-bit words (one per window, then the ticket); n_cap
// a multiple of 8192 below 2^31; do_slabs needs do_dma; 0 <= n_fill <= 6.
QK_API int qk_place_variant(const void* pb, const void* emits,
                            const void* base, void* out, void* status, int B,
                            long long Q, long long n_cap, int do_dma,
                            int do_slabs, int n_fill, void* stream) {
  if (!qk::win::shape_ok(B, Q, n_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (do_dma && do_slabs)
    return launch_fill<true, true>(n_fill, B, st, pb, emits, base, out,
                                   status, Q, n_cap);
  if (do_dma)
    return launch_fill<true, false>(n_fill, B, st, pb, emits, base, out,
                                    status, Q, n_cap);
  if (!do_slabs)
    return launch_fill<false, false>(n_fill, B, st, pb, emits, base, out,
                                     status, Q, n_cap);
  return static_cast<int>(cudaErrorInvalidValue);
}
