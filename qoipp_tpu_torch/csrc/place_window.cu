// E2: the windowed placement experiment of K2 over wide candidate slabs.
//
// Replaces the Pallas kernel of a TPU layout experiment:
//   E2 benchmarks/expt_place_wide.py:   place_wide (make_wide_kernel)
// E3 (expt_place2.py) has its own source, csrc/place_fill2.cu, and so have
// E4 (expt_place.py), csrc/place_grouped.cu, E5 (expt_place_narrow.py),
// csrc/place_narrow.cu, and E6 (expt_place_fixed.py), csrc/place_variant.cu.
//
// It computes the windowed placement (ops/place_window.py): row r of an
// image writes emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (pb[Q] :=
// n_cap) and pb[r] < n_cap; pixels are cut into windows of 8,192; inside a
// window a pixel takes the word of the nearest writer at or to its left in
// the window, at most 63 away, and any other pixel the carry, the previous
// window's last output (0 in the first).  The plain version is
// ops/place_kernel.place_fill_reference.
//
// What bounds it on the card: bytes, 8 per candidate row read and 4 per
// pixel written; at the experiment's sizes (8 images of ~254 K pixels,
// ~17 K candidate rows a window) a launch is ~250 blocks in one partial
// wave, so a block's latency over its rows is the time.  The design is
// E6's full variant (qk::win, qoipp_kernels.cuh): one window a block in
// ticket order, a warp a group of rows with more groups in flight in
// registers and no block sync while placing, a writer's word into a
// shared array and its bit into a mask, qk::quad_nearest at reach 63 for
// the fill, the decoupled look-back and 16-byte stores.
//
// What the kernel keeps of its experiment's question, the candidate rows
// staged a step (kLanes = 128, 256 or 512, one instantiation each): base
// counts kLanes-row slabs (window_base_rows_w), so kLanes is the slab of
// qk::win::begin.  The rows themselves are read as E6 reads them, a
// 128-row group a warp, four a lane, three groups in flight, at every
// kLanes: wider steps a warp (kLanes / 32 rows a lane) measured no faster.
#include "qoipp_kernels.cuh"

namespace {

using namespace qk::win;

template <int kLanes>
__global__ void __launch_bounds__(kThreads, 2)
place_wide_kernel(const int32_t* __restrict__ pb,
                  const uint32_t* __restrict__ em,
                  const int32_t* __restrict__ base, uint32_t* __restrict__ out,
                  unsigned long long* status, long long Q, int n_cap,
                  bool vec) {
  __shared__ Window s;
  const Span sp = begin<kLanes>(s, status, base, pb, em, Q, n_cap, true);
  for_each_group(sp, n_cap, vec, [&](const Rows& t) {
    place_rows(s, lane_rows(t), sp.w0);
  });
  finish<63>(s, sp, status, out, n_cap);
}

template <int kLanes>
int launch(int B, cudaStream_t stream, const void* pb, const void* emits,
           const void* base, void* out, void* status, long long Q,
           long long n_cap) {
  place_wide_kernel<kLanes>
      <<<static_cast<unsigned>(B * (n_cap / kWin)), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, static_cast<int>(n_cap),
      qk::win::rows_vec(pb, emits, Q));
  return qk::launch_status();
}

}  // namespace

// Resident blocks an SM of the `lanes` instantiation (or a negative CUDA
// error); its threads a block in *threads.
QK_API int qk_place_wide_occupancy(int lanes, int* threads) {
  switch (lanes) {
    case 128: return qk::win::occupancy(place_wide_kernel<128>, threads);
    case 256: return qk::win::occupancy(place_wide_kernel<256>, threads);
    case 512: return qk::win::occupancy(place_wide_kernel<512>, threads);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// pb (B, Q) int32 nondecreasing, emits (B, Q) uint32, base (B, n_cap / 8192
// + 1) int32 (window_base_rows_w at lanes), out (B, n_cap) uint32, status
// (B * n_cap / 8192 + 1) zeroed 64-bit words (one per window, then the
// ticket); n_cap a multiple of 8192 below 2^31; lanes 128, 256 or 512.
QK_API int qk_place_wide(const void* pb, const void* emits, const void* base,
                         void* out, void* status, int B, long long Q,
                         long long n_cap, int lanes, void* stream) {
  if (!qk::win::shape_ok(B, Q, n_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 128:
      return launch<128>(B, st, pb, emits, base, out, status, Q, n_cap);
    case 256:
      return launch<256>(B, st, pb, emits, base, out, status, Q, n_cap);
    case 512:
      return launch<512>(B, st, pb, emits, base, out, status, Q, n_cap);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
