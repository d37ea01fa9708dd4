// E7: byte emission over lanes-wide candidate slabs, one block per window.
//
// Replaces the Pallas kernel of the TPU layout experiment
// benchmarks/expt_emit_wide.py: emit_wide (make_wide_kernel), which asked
// whether visiting two or four 128-row slabs at once cut K4's per-visit
// cost.  It computes K4's function (ops/emit_kernel.py): row r of the
// compacted chunk stream writes min(off[r+1] - off[r], 6) bytes of its
// template (tlo bytes 0-3, thn bytes 4-5) at off[r] (off[C] := out_cap +
// 8192), bytes at or past out_cap are dropped, and every other byte is 0.
// The output is one int32 per byte, as the TPU kernel's.  The plain
// version is ops/emit_window.emit_wide_reference.
//
// One block per 8192-byte window w of an image.  Its candidate rows are the
// kLanes-row slabs base[w] .. base[w + 1], both included (base from
// window_base_rows_w), rows [lo, hi).  The carry (h0, h1, h2, d), a
// grid-ordered scalar on the TPU, needs no look-back here: a row writes at
// most 6 bytes, so bytes from before the window come from the row before
// lo, which has the largest off of the rows before it; if it does not
// cover (its next off is equal) a candidate row with the same off does.
//
// What bounds it on the card: bytes, 12 read per row the function needs
// and 4 written per output byte.  Only the last row of a run of equal offs
// writes, and a window's candidate rows end in such a run: one row long in
// most windows, but in the one holding the encoder's padding offset
// (expt_emit_wide.gen_inputs: the last ~25% of an image's rows) the run
// holds tens of thousands of rows.  So the rows the function needs are
// those before each image's trailing run and the run's last row.  The
// design:
//   - warp 0 finds where the range's trailing run starts (run_start): a
//     ballot over 32 probes a round, the first round on the 32 rows
//     before hi - 1, so a run of n rows costs 1 + log32(n) dependent
//     loads; the block reads only the rows before the run and the run's
//     last row, and a window's time no longer follows the run's length.
//     A long run inside the range is read row by row: right, not fast;
//   - rows are read as qk::win reads them: a warp a 128-row group, four
//     consecutive rows a lane (16-byte loads of off, tlo and thn where C %
//     4 == 0 and the planes are 16-byte aligned, else scalar), the next
//     row's off by shuffle, kRing groups a warp in registers, the first
//     kRing issued before the search's answer is known.  The reader is
//     E7's own, not qk::win's: it loads three planes, not two, pads past
//     hi with the past-the-end offset, not n_cap, and stops at the run's
//     start, not at hi; a plane count in qk::win's reader would change the
//     code E5 and E6 compile to;
//   - a writing row stores its <= 6 bytes straight into the shared byte
//     window: writing rows hold disjoint bytes, so no atomics, no block
//     sync while placing; one barrier, then each thread widens four
//     bytes into one 16-byte store, coalesced.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;            // bytes per window
constexpr long long kPastEnd = 8192;  // off[C] = out_cap + kPastEnd
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;  // rows a warp places at once, four a lane
constexpr int kRing = 2;     // groups a warp holds in registers
constexpr uint32_t kFull = 0xFFFFFFFFu;
static_assert(kWin == 16 * kThreads, "a thread zeroes 16 bytes");

// One image's rows and the block's window.
struct Image {
  const int32_t* off;
  const uint32_t* tlo;
  const uint32_t* thn;
  long long C, w0, out_cap;
  int32_t pad;  // off[C]
};

// Write row (o, nxt, lo, hn)'s bytes that fall in the window and below
// out_cap.
__device__ __forceinline__ void put_row(uint8_t* win, const Image& im,
                                        long long o, long long nxt,
                                        uint32_t lo, uint32_t hn) {
  const long long n = min(nxt - o, 6LL);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const long long pos = o + k;
    if (k < n && pos >= im.w0 && pos < im.w0 + kWin && pos < im.out_cap)
      win[pos - im.w0] = static_cast<uint8_t>(k < 4 ? lo >> (8 * k)
                                                    : hn >> (8 * (k - 4)));
  }
}

// The first row of [lo, hi) (lo < hi) whose off equals off[hi - 1]: off is
// nondecreasing, so the probes below it are a prefix.  One warp; each
// round narrows [a, b] to one gap between 32 probes.
__device__ long long run_start(const int32_t* __restrict__ off, long long lo,
                               long long hi) {
  const int lane = threadIdx.x & 31;
  const int32_t v = __ldg(off + hi - 1);
  long long a = lo, b = hi - 1;  // the answer lies in [a, b]
  long long at = max(a, b - 32), step = 1;  // first: the rows before hi - 1
  while (a < b) {
    const long long p = at + lane * step;
    const bool below = p < b && __ldg(off + p) < v;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c) a = at + (c - 1) * step + 1;
    b = min(b, at + c * step);
    at = a;
    step = (b - a + 31) / 32;
  }
  return a;
}

// A lane's four consecutive rows of a group; `after` (lane 31 only) is the
// off of the row after the group, the other lanes shuffle theirs.
struct Rows {
  uint4 o, lo, hn;
  int32_t after;
};

// Load the lane's rows r .. r + 3 (r % 4 == 0).  Rows at or past hi read
// as off = pad: no row that writes reads them (it lies before the trailing
// run, which ends at hi - 1).  `vec`: C % 4 == 0 and the planes 16-byte
// aligned, so r < hi puts r + 3 below hi too.
__device__ __forceinline__ void load_rows(Rows& t, const Image& im,
                                          long long r, long long hi,
                                          bool vec) {
  const unsigned pad = static_cast<unsigned>(im.pad);
  if (vec) {
    if (r < hi) {
      t.o = __ldg(reinterpret_cast<const uint4*>(im.off + r));
      t.lo = __ldg(reinterpret_cast<const uint4*>(im.tlo + r));
      t.hn = __ldg(reinterpret_cast<const uint4*>(im.thn + r));
    } else {
      t.o = make_uint4(pad, pad, pad, pad);
      t.lo = t.hn = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    auto o = [&](long long i) {
      return i < hi ? static_cast<unsigned>(__ldg(im.off + i)) : pad;
    };
    auto lo = [&](long long i) { return i < hi ? __ldg(im.tlo + i) : 0u; };
    auto hn = [&](long long i) { return i < hi ? __ldg(im.thn + i) : 0u; };
    t.o = make_uint4(o(r), o(r + 1), o(r + 2), o(r + 3));
    t.lo = make_uint4(lo(r), lo(r + 1), lo(r + 2), lo(r + 3));
    t.hn = make_uint4(hn(r), hn(r + 1), hn(r + 2), hn(r + 3));
  }
  t.after = (threadIdx.x & 31) == 31 && r + 4 < hi ? __ldg(im.off + r + 4)
                                                   : im.pad;
}

// Write the bytes of the lane's rows r .. r + 3 that lie before `end`
// (the trailing run's first row).  Warp-uniform: the next off is a
// shuffle.
__device__ __forceinline__ void place(uint8_t* win, const Image& im,
                                      const Rows& t, long long r,
                                      long long end) {
  const int32_t down = __shfl_down_sync(kFull, static_cast<int32_t>(t.o.x), 1);
  const int32_t o[5] = {static_cast<int32_t>(t.o.x),
                        static_cast<int32_t>(t.o.y),
                        static_cast<int32_t>(t.o.z),
                        static_cast<int32_t>(t.o.w),
                        (threadIdx.x & 31) == 31 ? t.after : down};
  const uint32_t lo[4] = {t.lo.x, t.lo.y, t.lo.z, t.lo.w};
  const uint32_t hn[4] = {t.hn.x, t.hn.y, t.hn.z, t.hn.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (r + k < end) put_row(win, im, o[k], o[k + 1], lo[k], hn[k]);
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads, 2)
emit_window_kernel(const int32_t* __restrict__ off,
                   const uint32_t* __restrict__ tlo,
                   const uint32_t* __restrict__ thn,
                   const int32_t* __restrict__ base, int32_t* __restrict__ out,
                   long long C, long long out_cap, bool vec) {
  __shared__ __align__(16) uint8_t win[kWin];
  __shared__ long long run_at;
  const int t = threadIdx.x;
  const long long w = blockIdx.x, b = blockIdx.y;
  const long long nwin = out_cap / kWin;
  const Image im{off + b * C, tlo + b * C, thn + b * C, C, w * kWin, out_cap,
                 static_cast<int32_t>(out_cap + kPastEnd)};
  const int32_t* brow = base + b * (nwin + 1);
  const long long lo = static_cast<long long>(brow[w]) * kLanes;
  const long long hi = min((static_cast<long long>(brow[w + 1]) + 1) * kLanes,
                           C);
  reinterpret_cast<uint4*>(win)[t] = make_uint4(0u, 0u, 0u, 0u);
  // the last thread writes the two rows outside the warps' groups: the row
  // before lo (bytes from before the window) and the trailing run's last
  // row; loaded now, written after the barrier
  const bool edge = t == kThreads - 1;
  const bool before = edge && lo >= 1, last = edge && lo < hi;
  int32_t bo = 0, bn = 0, lo_o = 0, lo_n = 0;
  uint32_t bl = 0u, bh = 0u, ll = 0u, lh = 0u;
  if (before) {
    bo = __ldg(im.off + lo - 1);
    bn = lo < C ? __ldg(im.off + lo) : im.pad;
    bl = __ldg(im.tlo + lo - 1);
    bh = __ldg(im.thn + lo - 1);
  }
  if (last) {
    lo_o = __ldg(im.off + hi - 1);
    lo_n = hi < C ? __ldg(im.off + hi) : im.pad;
    ll = __ldg(im.tlo + hi - 1);
    lh = __ldg(im.thn + hi - 1);
  }
  if (t < 32 && lo < hi) {
    const long long s = run_start(im.off, lo, hi);
    if (t == 0) run_at = s;
  }
  constexpr long long kStride = static_cast<long long>(kWarps) * kGroup;
  const long long first = lo + (t >> 5) * kGroup;
  const int lane4 = 4 * (t & 31);
  Rows ring[kRing];
#pragma unroll
  for (int i = 0; i < kRing; ++i)
    load_rows(ring[i], im, first + i * kStride + lane4, hi, vec);
  __syncthreads();
  const long long end = lo < hi ? run_at : lo;
  if (before) put_row(win, im, bo, bn, bl, bh);
  if (last) put_row(win, im, lo_o, lo_n, ll, lh);
  for (long long g = first; g < end; g += kRing * kStride) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const long long gi = g + i * kStride;
      if (gi >= end) break;
      place(win, im, ring[i], gi + lane4, end);
      load_rows(ring[i], im, gi + kRing * kStride + lane4, hi, vec);
    }
  }
  __syncthreads();
  int4* dst = reinterpret_cast<int4*>(out + b * out_cap + im.w0);
  const uchar4* src = reinterpret_cast<const uchar4*>(win);
#pragma unroll
  for (int j = 0; j < kWin / 4 / kThreads; ++j) {
    const uchar4 c = src[t + j * kThreads];
    dst[t + j * kThreads] = make_int4(c.x, c.y, c.z, c.w);
  }
}

template <int kLanes>
int run(int B, long long C, long long out_cap, cudaStream_t stream,
        const void* off, const void* tlo, const void* thn, const void* base,
        void* out) {
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(off) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(tlo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(thn) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(out_cap / kWin), B);
  emit_window_kernel<kLanes><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(off), static_cast<const uint32_t*>(tlo),
      static_cast<const uint32_t*>(thn), static_cast<const int32_t*>(base),
      static_cast<int32_t*>(out), C, out_cap, vec);
  return qk::launch_status();
}

}  // namespace

// Resident blocks an SM of the `lanes` instantiation (or a negative CUDA
// error); its threads a block in *threads.
QK_API int qk_emit_window_occupancy(int lanes, int* threads) {
  static_assert(kThreads == qk::win::kThreads, "qk::win::occupancy's block");
  switch (lanes) {
    case 128: return qk::win::occupancy(emit_window_kernel<128>, threads);
    case 256: return qk::win::occupancy(emit_window_kernel<256>, threads);
    case 512: return qk::win::occupancy(emit_window_kernel<512>, threads);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// off (B, C) int32 nondecreasing, tlo/thn (B, C) uint32, base (B,
// out_cap/8192 + 1) int32 from window_base_rows_w(off, out_cap, lanes) ->
// out (B, out_cap) int32 bytes; out_cap % 8192 == 0, out_cap + 8192 <
// 2^31, lanes 128/256/512.
QK_API int qk_emit_window(const void* off, const void* tlo, const void* thn,
                          const void* base, void* out, int B, long long C,
                          long long out_cap, int lanes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_cap % kWin || out_cap + kPastEnd >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 128:
      return run<128>(B, C, out_cap, st, off, tlo, thn, base, out);
    case 256:
      return run<256>(B, C, out_cap, st, off, tlo, thn, base, out);
    case 512:
      return run<512>(B, C, out_cap, st, off, tlo, thn, base, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
