// E2-E6: the windowed placement experiments of K2.
//
// Replaces the Pallas kernels of five TPU layout experiments:
//   E2 benchmarks/expt_place_wide.py:   place_wide (make_wide_kernel)
//   E3 benchmarks/expt_place2.py:       place_fill2 (_kernel2)
//   E4 benchmarks/expt_place.py:        make_variant(...).run (kernel)
//   E5 benchmarks/expt_place_narrow.py: place_fill_narrow (make_narrow_kernel)
//   E6 benchmarks/expt_place_fixed.py:  place_variant (make_kernel)
//
// E4 computes another function, the grouped summed placement; its section
// below says how it differs.  The rest of this note is E2, E3, E5 and E6.
//
// All four compute the windowed placement (ops/place_window.py): row r of
// an image writes emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (pb[Q] :=
// n_cap) and pb[r] < n_cap; pixels are cut into windows of kWin; inside a
// window a pixel takes the word of the nearest writer at or to its left in
// the window, at most 2^n_fill - 1 away (n_fill = 6 but in E6), and any
// other pixel the carry, the previous window's last output (0 in the
// first).  pb is nondecreasing, so writers hold distinct pixels.
//
// One block per unit of windows (one window; two in E3).  The block clears
// a flag per pixel in shared memory, stages the candidate rows that
// base_step names (slabs base[w] .. base[w + units], both included) into
// shared memory and places their writers, runs the log-shift fill passes
// over the window in shared memory, and writes the window once.  The
// carry, a grid-ordered scalar on the TPU, is a decoupled look-back here:
// blocks take units in order from a ticket counter; each publishes its
// unit's last output as soon as it owns it ("value") or "inherit", and
// resolves its own carry from the nearest earlier unit of its image whose
// value is known, then publishes that.  A block only waits on units with
// lower tickets, which are already running, so the look-back cannot hang.
//
// What bounds it on the card: bytes — 8 per candidate row read and 4 per
// pixel written; at the experiments' photo-like sizes (8 images of
// ~254 K pixels) the launch is one wave of ~250 blocks and latency-bound.
// E4 is bound the same way: 8 bytes per row, 4 per pixel; at its script's
// size (128 images of 2,088,960 pixels, 32,640 blocks) that is 0.41 ms.
// What each kernel keeps of its experiment's question:
//   E2: kLanes (128/256/512) candidate rows staged per step, coalesced;
//   E3: two windows per block from one staged range; the fill passes of
//       reach 8, 16, 32 run only in a window whose longest in-window chunk
//       (pb[r+1] - pb[r], a block max) exceeds 8;
//   E5: each staged group of 128 rows whose writers span at most ns
//       stripes of 128 pixels is placed output-driven (threads over the
//       span search the group's rows), wider groups row-driven;
//   E6: kDma, kSlabs and kFill knock out the row reads, the placement and
//       fill passes (reach 2^kFill - 1) at compile time;
//   E4: the TPU's lr_mode (how a window finds its first candidate slab and
//       how many it visits) as a template parameter; rows are read straight
//       from global memory (the sum rule needs no look-ahead row) and the
//       fill is three flag ballots per warp in place of six passes.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;    // pixels per window
constexpr int kSlab = 128;    // rows per base_step unit (and per E5 group)
constexpr int kStripes = kWin / 128;
constexpr int kThreads = 512;
constexpr int kStage = 512;   // rows staged per step (E3, E5, E6)

template <int NW, int ROWS>
struct Smem {
  uint32_t word[NW * kWin];  // at offset 0, flag at a multiple of 16
  uint8_t flag[NW * kWin];
  int32_t pb[ROWS + 1];  // staged rows and the look-ahead row
  uint32_t em[ROWS];
  uint32_t carry[NW];     // the carry into each window of the unit
  int gmax[NW];           // E3: longest in-window chunk
  int smin[kStage / kSlab], smax[kStage / kSlab];  // E5: group stripe span
  unsigned long long ticket;
};

struct Unit {
  int b;            // image
  long long u;      // unit within the image
  long long first;  // status index of the image's first unit
};

// Take a ticket, clear the flags.  Ends on a barrier.
template <class S>
__device__ Unit begin(S& s, unsigned long long* status, long long units,
                      long long total) {
  if (threadIdx.x == 0) s.ticket = qk::take_ticket(status, total);
  uint4* f = reinterpret_cast<uint4*>(s.flag);
  for (int i = threadIdx.x; i < int(sizeof(s.flag) / 16); i += kThreads)
    f[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long t = static_cast<long long>(s.ticket);
  return Unit{static_cast<int>(t / units), t % units, t - t % units};
}

// Stage rows r0 .. r0 + n (n <= ROWS) and the look-ahead row r0 + n by
// threads 0 .. n - 1 (thread 0 also the look-ahead).  Rows past Q read as
// pb = n_cap.  Ends on a barrier.
template <class S>
__device__ void stage(S& s, const int32_t* pb, const uint32_t* em,
                      long long r0, int n, long long Q, int n_cap) {
  const int i = threadIdx.x;
  if (i < n) {
    const long long r = r0 + i;
    s.pb[i] = r < Q ? pb[r] : n_cap;
    s.em[i] = r < Q ? em[r] : 0u;
  }
  if (i == 0) s.pb[n] = r0 + n < Q ? pb[r0 + n] : n_cap;
  __syncthreads();
}

// Staged row i's in-unit pixel if it writes inside the unit's span, else -1.
template <class S>
__device__ __forceinline__ int target(const S& s, int i, int w0, int span) {
  const int p = s.pb[i];
  return (s.pb[i + 1] > p && p >= w0 && p - w0 < span) ? p - w0 : -1;
}

template <class S>
__device__ __forceinline__ void put(S& s, int t, uint32_t v) {
  s.word[t] = v;
  s.flag[t] = 1;
}

// One log-shift fill pass of reach k over the unit's windows: an unwritten
// pixel takes the word of the pixel k to its left in its window if that
// one is written.  With `only` >= 0, the pass runs in window `only` alone.
// Starts and ends on a barrier.
template <int NW, class S>
__device__ void fill_pass(S& s, int k, int only) {
  constexpr int kPer = NW * kWin / kThreads;
  uint32_t w[kPer];
  uint8_t f[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = threadIdx.x + j * kThreads;
    f[j] = s.flag[p];
    w[j] = s.word[p];
    const bool on = only < 0 || p / kWin == only;
    if (!f[j] && on && p % kWin >= k && s.flag[p - k]) {
      f[j] = 1;
      w[j] = s.word[p - k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = threadIdx.x + j * kThreads;
    s.flag[p] = f[j];
    s.word[p] = w[j];
  }
  __syncthreads();
}

// The decoupled look-back of unit `me` (thread 0 alone), qoipp_kernels.cuh:
// publish the unit's last output `last` if the unit owns it, else
// "inherit"; walk back; if inheriting, publish the carry found.  Returns
// the carry into the unit (0 for the image's first).
__device__ uint32_t look_back(unsigned long long* status, long long me,
                              long long first, bool own, uint32_t last) {
  qk::publish(status, me, own, last);
  const uint32_t carry = qk::walk_back(status, me, first);
  if (!own) qk::publish(status, me, true, carry);
  return carry;
}

// The look-back: publish the unit's last output (or "inherit"), resolve
// the carry into its first window, publish the resolved last output, and
// write the unit's windows.  Thread 0 walks; all threads write.
template <int NW, class S>
__device__ void finish(S& s, unsigned long long* status, const Unit& at,
                       uint32_t* out, long long n_cap) {
  if (threadIdx.x == 0) {
    int own = -1;  // the last window of the unit whose last pixel is written
    for (int h = NW - 1; h >= 0 && own < 0; --h)
      if (s.flag[h * kWin + kWin - 1]) own = h;
    uint32_t carry = look_back(
        status, at.first + at.u, at.first, own >= 0,
        own >= 0 ? s.word[own * kWin + kWin - 1] : 0u);
    for (int h = 0; h < NW; ++h) {
      s.carry[h] = carry;
      const int last = h * kWin + kWin - 1;
      if (s.flag[last]) carry = s.word[last];
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + at.b * n_cap + at.u * NW * kWin);
  const uint4* wv = reinterpret_cast<const uint4*>(s.word);
  const uchar4* fv = reinterpret_cast<const uchar4*>(s.flag);
  for (int i = threadIdx.x; i < NW * kWin / 4; i += kThreads) {
    const uint32_t c = s.carry[(4 * i) / kWin];
    const uint4 w = wv[i];
    const uchar4 f = fv[i];
    dst[i] = make_uint4(f.x ? w.x : c, f.y ? w.y : c, f.z ? w.z : c,
                        f.w ? w.w : c);
  }
}

// The unit's candidate rows [lo, hi): slabs base[w] .. base[w + NW] of
// `slab` rows, cut at Q.
struct Rows {
  long long lo, hi;
};

__device__ __forceinline__ Rows rows_of(const int32_t* base, const Unit& at,
                                        int NW, long long nsteps, int slab,
                                        long long Q) {
  const int32_t* bb = base + at.b * (nsteps + 1) + at.u * NW;
  const long long lo = static_cast<long long>(bb[0]) * slab;
  const long long hi = min((static_cast<long long>(bb[NW]) + 1) * slab, Q);
  return Rows{lo, hi};
}

// ---- E2: kLanes candidate rows per staging step --------------------------

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
place_wide_kernel(const int32_t* __restrict__ pb,
                  const uint32_t* __restrict__ em,
                  const int32_t* __restrict__ base, uint32_t* __restrict__ out,
                  unsigned long long* status, long long Q, long long n_cap,
                  long long total) {
  extern __shared__ __align__(16) unsigned char raw[];
  auto& s = *reinterpret_cast<Smem<1, kLanes>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  const Rows r = rows_of(base, at, 1, nsteps, kLanes, Q);
  const int32_t* prow = pb + at.b * Q;
  const uint32_t* erow = em + at.b * Q;
  const int w0 = static_cast<int>(at.u * kWin);
  for (long long r0 = r.lo; r0 < r.hi; r0 += kLanes) {
    stage(s, prow, erow, r0, kLanes, Q, static_cast<int>(n_cap));
    if (threadIdx.x < kLanes) {
      const int t = target(s, threadIdx.x, w0, kWin);
      if (t >= 0) put(s, t, s.em[threadIdx.x]);
    }
    __syncthreads();
  }
  for (int k = 1; k < 64; k <<= 1) fill_pass<1>(s, k, -1);
  finish<1>(s, status, at, out, n_cap);
}

// ---- E3: two windows per block, predicated long fill passes -------------

__global__ void __launch_bounds__(kThreads)
place_fill2_kernel(const int32_t* __restrict__ pb,
                   const uint32_t* __restrict__ em,
                   const int32_t* __restrict__ base,
                   uint32_t* __restrict__ out, unsigned long long* status,
                   long long Q, long long n_cap, long long total) {
  extern __shared__ __align__(16) unsigned char raw[];
  auto& s = *reinterpret_cast<Smem<2, kStage>*>(raw);
  if (threadIdx.x < 2) s.gmax[threadIdx.x] = 0;
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps / 2, total);
  const Rows r = rows_of(base, at, 2, nsteps, kSlab, Q);
  const int32_t* prow = pb + at.b * Q;
  const uint32_t* erow = em + at.b * Q;
  const int w0 = static_cast<int>(at.u * 2 * kWin);
  for (long long r0 = r.lo; r0 < r.hi; r0 += kStage) {
    stage(s, prow, erow, r0, kStage, Q, static_cast<int>(n_cap));
    const int t = target(s, threadIdx.x, w0, 2 * kWin);
    if (t >= 0) {
      put(s, t, s.em[threadIdx.x]);
      atomicMax(&s.gmax[t / kWin],
                s.pb[threadIdx.x + 1] - s.pb[threadIdx.x]);
    }
    __syncthreads();
  }
  for (int k = 1; k < 8; k <<= 1) fill_pass<2>(s, k, -1);
  const bool long0 = s.gmax[0] > 8, long1 = s.gmax[1] > 8;
  if (long0 || long1)
    for (int k = 8; k < 64; k <<= 1)
      fill_pass<2>(s, k, long0 && long1 ? -1 : long0 ? 0 : 1);
  finish<2>(s, status, at, out, n_cap);
}

// ---- E5: narrow groups output-driven, wide groups row-driven ------------

__global__ void __launch_bounds__(kThreads)
place_narrow_kernel(const int32_t* __restrict__ pb,
                    const uint32_t* __restrict__ em,
                    const int32_t* __restrict__ base,
                    uint32_t* __restrict__ out, unsigned long long* status,
                    long long Q, long long n_cap, long long total, int ns) {
  extern __shared__ __align__(16) unsigned char raw[];
  auto& s = *reinterpret_cast<Smem<1, kStage>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  const Rows r = rows_of(base, at, 1, nsteps, kSlab, Q);
  const int32_t* prow = pb + at.b * Q;
  const uint32_t* erow = em + at.b * Q;
  const int w0 = static_cast<int>(at.u * kWin);
  const int g = threadIdx.x / kSlab, lane = threadIdx.x % kSlab;
  const int g0 = g * kSlab;  // the group's first staged row
  for (long long r0 = r.lo; r0 < r.hi; r0 += kStage) {
    if (lane == 0) {
      s.smin[g] = kStripes;
      s.smax[g] = -1;
    }
    stage(s, prow, erow, r0, kStage, Q, static_cast<int>(n_cap));
    const int t = target(s, threadIdx.x, w0, kWin);
    if (t >= 0) {
      atomicMin(&s.smin[g], t >> 7);
      atomicMax(&s.smax[g], t >> 7);
    }
    __syncthreads();
    const int lo = s.smin[g], hi = s.smax[g];
    if (hi >= 0 && hi - lo < ns) {
      // output-driven: each pixel of the span finds the group's last row
      // with pb <= pixel, which writes it iff its pb is the pixel and the
      // row after it moves on
      const int p0 = w0 + min(lo, kStripes - ns) * 128;
      for (int x = lane; x < ns * 128; x += kSlab) {
        const int p = p0 + x;
        int a = g0, b = g0 + kSlab;  // first row in [a, b) with pb > p
        while (a < b) {
          const int m = (a + b) >> 1;
          if (s.pb[m] <= p) a = m + 1;
          else b = m;
        }
        if (a > g0 && s.pb[a - 1] == p && s.pb[a] > p)
          put(s, p - w0, s.em[a - 1]);
      }
    } else if (t >= 0) {
      put(s, t, s.em[threadIdx.x]);
    }
    __syncthreads();
  }
  for (int k = 1; k < 64; k <<= 1) fill_pass<1>(s, k, -1);
  finish<1>(s, status, at, out, n_cap);
}

// ---- E6: stage ablations --------------------------------------------------

template <bool kDma, bool kSlabs, int kFill>
__global__ void __launch_bounds__(kThreads)
place_variant_kernel(const int32_t* __restrict__ pb,
                     const uint32_t* __restrict__ em,
                     const int32_t* __restrict__ base,
                     uint32_t* __restrict__ out, unsigned long long* status,
                     long long Q, long long n_cap, long long total) {
  static_assert(kDma || !kSlabs, "placing rows needs them read");
  extern __shared__ __align__(16) unsigned char raw[];
  auto& s = *reinterpret_cast<Smem<1, kStage>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  if (kDma) {
    const Rows r = rows_of(base, at, 1, nsteps, kSlab, Q);
    const int32_t* prow = pb + at.b * Q;
    const uint32_t* erow = em + at.b * Q;
    const int w0 = static_cast<int>(at.u * kWin);
    for (long long r0 = r.lo; r0 < r.hi; r0 += kStage) {
      stage(s, prow, erow, r0, kStage, Q, static_cast<int>(n_cap));
      if (kSlabs) {
        const int t = target(s, threadIdx.x, w0, kWin);
        if (t >= 0) put(s, t, s.em[threadIdx.x]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kFill; ++i) fill_pass<1>(s, 1 << i, -1);
  finish<1>(s, status, at, out, n_cap);
}

// ---- E4: grouped summed placement ----------------------------------------
//
// One block per step of g windows of `win` pixels (a multiple of 128, g *
// win <= kMaxStep).  Every row with pb in a window of the step adds its low
// and high 16-bit halves into two 32-bit sums of its pixel (shared atomics,
// so rows that share a pixel add, as the TPU's one-hot dots did) and marks
// the pixel placed.  A pixel's word is lo | hi << 16 of its sums; a pixel
// takes the word of the nearest placed pixel at or to its left in the
// step, at most 63 away, else the carry: the previous step's last output
// by the look-back, 0 at the start of each image.
//
// The candidate rows of window w0 .. w0 + win, in 128-row slabs: the block
// of the step starts at slab blk = base[first] / 8 * 8 (slab 0 with
// static_in, where the block holds only LENR = g * win / 128 + 16 slabs);
//   kCnt:    from the first slab of the block whose last pb >= w0 (counted
//            here), win / 128 + 2 slabs, then on while rows still fall in
//            the window (the TPU stopped at those slabs);
//   kDyn:    from the same slab, only while rows fall in the window;
//   kSmem:   like kCnt from slab base[w] (base holds one entry per window);
//   kStatic: win / 128 + 2 slabs from the block's first, whatever the
//            window (timing only: it places the wrong rows on purpose).
enum LrMode { kCnt = 0, kDyn = 1, kSmem = 2, kStatic = 3 };
constexpr int kMaxStep = 16384;  // pixels per block: 144 KB of shared memory

__device__ __forceinline__ int32_t row_pb(const int32_t* prow, long long r,
                                          long long Q, int32_t n_cap) {
  return r < Q ? prow[r] : n_cap;
}

// Warp-wide: the word of the nearest placed pixel at or left of step pixel
// p (the 32 lanes on one aligned 32-pixel chunk), at most 63 away, from
// the placed-flag ballots of the chunk and the two before it.
__device__ __forceinline__ bool nearest(const uint8_t* flag,
                                        const uint32_t* word, int p,
                                        uint32_t& v) {
  const int lane = threadIdx.x & 31;
  const int c = p - lane;
  const unsigned m0 = __ballot_sync(~0u, flag[p] != 0);
  const unsigned m1 = __ballot_sync(~0u, c >= 32 && flag[p - 32] != 0);
  const unsigned m2 = __ballot_sync(~0u, c >= 64 && flag[p - 64] != 0);
  const unsigned mine = m0 & (0xFFFFFFFFu >> (31 - lane));
  const int src = mine ? c + 31 - __clz(mine)
                  : m1 ? c - 1 - __clz(m1)
                  : m2 ? c - 33 - __clz(m2) : -1;
  if (src < 0 || p - src > 63) return false;
  v = word[src];
  return true;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
place_grouped_kernel(const int32_t* __restrict__ pb,
                     const uint32_t* __restrict__ em,
                     const int32_t* __restrict__ base,
                     uint32_t* __restrict__ out, unsigned long long* status,
                     long long Q, long long n_cap, long long total, int nbase,
                     int win, int g, int static_in) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ unsigned long long ticket;
  __shared__ uint32_t carry_in;
  const int step = win * g;
  uint32_t* lo = reinterpret_cast<uint32_t*>(raw);  // then the word
  uint32_t* hi = lo + step;
  uint8_t* flag = reinterpret_cast<uint8_t*>(hi + step);
  if (threadIdx.x == 0) ticket = qk::take_ticket(status, total);
  uint4* z = reinterpret_cast<uint4*>(raw);
  for (int i = threadIdx.x; i < 9 * step / 16; i += kThreads)
    z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long nsteps = n_cap / step;
  const long long t = static_cast<long long>(ticket);
  const long long b = t / nsteps, j = t % nsteps;
  const int32_t* prow = pb + b * Q;
  const uint32_t* erow = em + b * Q;
  const int32_t* brow = base + b * nbase;
  const int32_t ncap = static_cast<int32_t>(n_cap);
  const long long blk = brow[kMode == kSmem ? j * g : j] / 8 * 8;
  const long long at = static_in ? 0 : blk;  // the slab the block is read at
  const long long nslab = (Q + kSlab - 1) / kSlab;
  const long long lim = static_in ? min(nslab, at + g * (win / kSlab) + 16)
                                  : nslab;
  const long long rlim = min(lim * kSlab, Q);
  for (int gi = 0; gi < g; ++gi) {
    const int w0 = static_cast<int>(j * step) + gi * win;
    long long s0 = at;
    if (kMode == kCnt || kMode == kDyn) {
      for (;;) {  // count the slabs whose last pb is below w0
        const long long k = s0 + threadIdx.x;
        const int n = __syncthreads_count(
            k < lim && row_pb(prow, k * kSlab + kSlab - 1, Q, ncap) < w0);
        s0 += n;
        if (n < kThreads) break;
      }
    } else if (kMode == kSmem) {
      s0 = at + brow[j * g + gi] - blk;
    }
    long long r = s0 * kSlab;
    const long long rfix =
        kMode == kDyn ? r : min((s0 + win / kSlab + 2) * kSlab, rlim);
    for (; r < rlim; r += kThreads) {
      if (r >= rfix && (kMode == kStatic || prow[r] >= w0 + win)) break;
      const long long i = r + threadIdx.x;
      if (i < rlim) {
        const int32_t p = prow[i];
        if (p >= w0 && p < w0 + win) {
          const int x = p - w0 + gi * win;
          const uint32_t e = erow[i];
          atomicAdd(lo + x, e & 0xFFFFu);
          atomicAdd(hi + x, e >> 16);
          flag[x] = 1;
        }
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < step; x += kThreads) lo[x] |= hi[x] << 16;
  __syncthreads();
  if (threadIdx.x < 32) {  // the step's last output, then the look-back
    uint32_t v = 0;
    const bool own = nearest(flag, lo, step - 32 + threadIdx.x, v);
    const bool own31 = __shfl_sync(~0u, static_cast<int>(own), 31) != 0;
    const uint32_t v31 = __shfl_sync(~0u, v, 31);
    if (threadIdx.x == 0)
      carry_in = look_back(status, t, t - j, own31, v31);
  }
  __syncthreads();
  uint32_t* dst = out + b * n_cap + j * step;
  for (int x = threadIdx.x; x < step; x += kThreads) {
    uint32_t v = 0;
    dst[x] = nearest(flag, lo, x, v) ? v : carry_in;
  }
}

// ---- launch helpers --------------------------------------------------------

template <class K, class... Extra>
int run(K kernel, size_t smem, int B, long long units, cudaStream_t stream,
        const void* pb, const void* emits, const void* base, void* out,
        void* status, long long Q, long long n_cap, Extra... extra) {
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long total = B * units;
  kernel<<<static_cast<unsigned>(total), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, n_cap, total, extra...);
  return qk::launch_status();
}

template <bool kDma, bool kSlabs>
int run_variant(int n_fill, int B, cudaStream_t stream, const void* pb,
                const void* emits, const void* base, void* out, void* status,
                long long Q, long long n_cap) {
  constexpr size_t smem = sizeof(Smem<1, kStage>);
  const long long units = n_cap / kWin;
#define QK_VARIANT(F)                                                       \
  case F:                                                                  \
    return run(place_variant_kernel<kDma, kSlabs, F>, smem, B, units,      \
               stream, pb, emits, base, out, status, Q, n_cap);
  switch (n_fill) {
    QK_VARIANT(0) QK_VARIANT(1) QK_VARIANT(2) QK_VARIANT(3)
    QK_VARIANT(4) QK_VARIANT(5) QK_VARIANT(6)
  }
#undef QK_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry: pb (B, Q) int32, emits (B, Q) uint32, base (B, n_cap/8192
// + 1) int32, out (B, n_cap) uint32, status (B * units + 1) zeroed int64
// (the look-back words and the ticket counter), n_cap % 8192 == 0.

QK_API int qk_place_wide(const void* pb, const void* emits, const void* base,
                         void* out, void* status, int B, long long Q,
                         long long n_cap, int lanes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const long long units = n_cap / kWin;
  switch (lanes) {
    case 128:
      return run(place_wide_kernel<128>, sizeof(Smem<1, 128>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
    case 256:
      return run(place_wide_kernel<256>, sizeof(Smem<1, 256>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
    case 512:
      return run(place_wide_kernel<512>, sizeof(Smem<1, 512>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// n_cap % 16384 == 0: one block per pair of windows
QK_API int qk_place_fill2(const void* pb, const void* emits, const void* base,
                          void* out, void* status, int B, long long Q,
                          long long n_cap, void* stream) {
  return run(place_fill2_kernel, sizeof(Smem<2, kStage>), B,
             n_cap / (2 * kWin), static_cast<cudaStream_t>(stream), pb, emits,
             base, out, status, Q, n_cap);
}

// 1 <= ns <= 64
QK_API int qk_place_narrow(const void* pb, const void* emits, const void* base,
                           void* out, void* status, int B, long long Q,
                           long long n_cap, int ns, void* stream) {
  if (ns < 1 || ns > kStripes) return static_cast<int>(cudaErrorInvalidValue);
  return run(place_narrow_kernel, sizeof(Smem<1, kStage>), B, n_cap / kWin,
             static_cast<cudaStream_t>(stream), pb, emits, base, out, status,
             Q, n_cap, ns);
}

// do_slabs needs do_dma; 0 <= n_fill <= 6
QK_API int qk_place_variant(const void* pb, const void* emits,
                            const void* base, void* out, void* status, int B,
                            long long Q, long long n_cap, int do_dma,
                            int do_slabs, int n_fill, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (do_dma && do_slabs)
    return run_variant<true, true>(n_fill, B, st, pb, emits, base, out,
                                   status, Q, n_cap);
  if (do_dma)
    return run_variant<true, false>(n_fill, B, st, pb, emits, base, out,
                                    status, Q, n_cap);
  if (!do_slabs)
    return run_variant<false, false>(n_fill, B, st, pb, emits, base, out,
                                     status, Q, n_cap);
  return static_cast<int>(cudaErrorInvalidValue);
}

// E4: base (B, nbase) int32 holds a slab per step (a slab per window in
// smem mode), status (B * n_cap / (win * g) + 1); win % 128 == 0,
// win * g <= 16384 and divides n_cap; mode 0 cnt, 1 dyn, 2 smem, 3 static.
QK_API int qk_place_grouped(const void* pb, const void* emits,
                            const void* base, void* out, void* status, int B,
                            long long Q, long long n_cap, int nbase, int win,
                            int g, int mode, int static_in, void* stream) {
  const long long step = static_cast<long long>(win) * g;
  if (win <= 0 || win % kSlab || g < 1 || step > kMaxStep || n_cap % step)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = 9 * static_cast<size_t>(step);
  const long long units = n_cap / step;
#define QK_GROUPED(M)                                                        \
  case M:                                                                   \
    return run(place_grouped_kernel<M>, smem, B, units, st, pb, emits, base, \
               out, status, Q, n_cap, nbase, win, g, static_in);
  switch (mode) {
    QK_GROUPED(kCnt) QK_GROUPED(kDyn) QK_GROUPED(kSmem) QK_GROUPED(kStatic)
  }
#undef QK_GROUPED
  return static_cast<int>(cudaErrorInvalidValue);
}
