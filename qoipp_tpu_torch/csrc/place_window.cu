// E2, E5, E6: the windowed placement experiments of K2.
//
// Replaces the Pallas kernels of three TPU layout experiments:
//   E2 benchmarks/expt_place_wide.py:   place_wide (make_wide_kernel)
//   E5 benchmarks/expt_place_narrow.py: place_fill_narrow (make_narrow_kernel)
//   E6 benchmarks/expt_place_fixed.py:  place_variant (make_kernel)
// E3 (expt_place2.py) has its own source, csrc/place_fill2.cu, and so has
// E4 (expt_place.py), csrc/place_grouped.cu.
//
// All three compute the windowed placement (ops/place_window.py): row r of
// an image writes emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (pb[Q] :=
// n_cap) and pb[r] < n_cap; pixels are cut into windows of kWin; inside a
// window a pixel takes the word of the nearest writer at or to its left in
// the window, at most 2^n_fill - 1 away (n_fill = 6 but in E6), and any
// other pixel the carry, the previous window's last output (0 in the
// first).  pb is nondecreasing, so writers hold distinct pixels.
//
// One block per window.  The block clears a flag per pixel in shared
// memory, stages the candidate rows that base_step names (slabs base[w]
// .. base[w + 1], both included) into shared memory and places their
// writers, runs the log-shift fill passes over the window in shared
// memory, and writes the window once.  The carry, a grid-ordered scalar on
// the TPU, is a decoupled look-back here: blocks take windows in order
// from a ticket counter; each publishes its window's last output as soon
// as it owns it ("value") or "inherit", and resolves its own carry from
// the nearest earlier window of its image whose value is known, then
// publishes that.  A block only waits on windows with lower tickets,
// which are already running, so the look-back cannot hang.
//
// What bounds it on the card: bytes -- 8 per candidate row read and 4 per
// pixel written; at the experiments' photo-like sizes (8 images of ~254 K
// pixels) the launch is one wave of ~250 blocks and latency-bound.
// What each kernel keeps of its experiment's question:
//   E2: kLanes (128/256/512) candidate rows staged per step, coalesced;
//   E5: each staged group of 128 rows whose writers span at most ns
//       stripes of 128 pixels is placed output-driven (threads over the
//       span search the group's rows), wider groups row-driven;
//   E6: kDma, kSlabs and kFill knock out the row reads, the placement and
//       fill passes (reach 2^kFill - 1) at compile time.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;    // pixels per window
constexpr int kSlab = 128;    // rows per base_step unit (and per E5 group)
constexpr int kStripes = kWin / 128;
constexpr int kThreads = 512;
constexpr int kStage = 512;   // rows staged per step (E5, E6)

template <int ROWS>
struct Smem {
  uint32_t word[kWin];  // at offset 0, flag at a multiple of 16
  uint8_t flag[kWin];
  int32_t pb[ROWS + 1];  // staged rows and the look-ahead row
  uint32_t em[ROWS];
  uint32_t carry;        // the carry into the window
  int smin[kStage / kSlab], smax[kStage / kSlab];  // E5: group stripe span
  unsigned long long ticket;
};

struct Unit {
  int b;            // image
  long long u;      // window within the image
  long long first;  // status index of the image's first window
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

// Staged row i's in-window pixel if it writes inside the window, else -1.
template <class S>
__device__ __forceinline__ int target(const S& s, int i, int w0) {
  const int p = s.pb[i];
  return (s.pb[i + 1] > p && p >= w0 && p - w0 < kWin) ? p - w0 : -1;
}

template <class S>
__device__ __forceinline__ void put(S& s, int t, uint32_t v) {
  s.word[t] = v;
  s.flag[t] = 1;
}

// One log-shift fill pass of reach k over the window: an unwritten pixel
// takes the word of the pixel k to its left if that one is written.
// Starts and ends on a barrier.
template <class S>
__device__ void fill_pass(S& s, int k) {
  constexpr int kPer = kWin / kThreads;
  uint32_t w[kPer];
  uint8_t f[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = threadIdx.x + j * kThreads;
    f[j] = s.flag[p];
    w[j] = s.word[p];
    if (!f[j] && p >= k && s.flag[p - k]) {
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

// The look-back (thread 0 walks; qoipp_kernels.cuh): publish the window's
// last output if it owns it, else "inherit"; resolve the carry into the
// window; if inheriting, publish the carry found.  Then all threads write
// the window.
template <class S>
__device__ void finish(S& s, unsigned long long* status, const Unit& at,
                       uint32_t* out, long long n_cap) {
  if (threadIdx.x == 0) {
    const long long me = at.first + at.u;
    const bool own = s.flag[kWin - 1] != 0;
    qk::publish(status, me, own, s.word[kWin - 1]);
    s.carry = qk::walk_back(status, me, at.first);
    if (!own) qk::publish(status, me, true, s.carry);
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + at.b * n_cap + at.u * kWin);
  const uint4* wv = reinterpret_cast<const uint4*>(s.word);
  const uchar4* fv = reinterpret_cast<const uchar4*>(s.flag);
  const uint32_t c = s.carry;
  for (int i = threadIdx.x; i < kWin / 4; i += kThreads) {
    const uint4 w = wv[i];
    const uchar4 f = fv[i];
    dst[i] = make_uint4(f.x ? w.x : c, f.y ? w.y : c, f.z ? w.z : c,
                        f.w ? w.w : c);
  }
}

// The window's candidate rows [lo, hi): slabs base[w] .. base[w + 1] of
// `slab` rows, cut at Q.
struct Rows {
  long long lo, hi;
};

__device__ __forceinline__ Rows rows_of(const int32_t* base, const Unit& at,
                                        long long nsteps, int slab,
                                        long long Q) {
  const int32_t* bb = base + at.b * (nsteps + 1) + at.u;
  const long long lo = static_cast<long long>(bb[0]) * slab;
  const long long hi = min((static_cast<long long>(bb[1]) + 1) * slab, Q);
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
  auto& s = *reinterpret_cast<Smem<kLanes>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  const Rows r = rows_of(base, at, nsteps, kLanes, Q);
  const int32_t* prow = pb + at.b * Q;
  const uint32_t* erow = em + at.b * Q;
  const int w0 = static_cast<int>(at.u * kWin);
  for (long long r0 = r.lo; r0 < r.hi; r0 += kLanes) {
    stage(s, prow, erow, r0, kLanes, Q, static_cast<int>(n_cap));
    if (threadIdx.x < kLanes) {
      const int t = target(s, threadIdx.x, w0);
      if (t >= 0) put(s, t, s.em[threadIdx.x]);
    }
    __syncthreads();
  }
  for (int k = 1; k < 64; k <<= 1) fill_pass(s, k);
  finish(s, status, at, out, n_cap);
}

// ---- E5: narrow groups output-driven, wide groups row-driven ------------

__global__ void __launch_bounds__(kThreads)
place_narrow_kernel(const int32_t* __restrict__ pb,
                    const uint32_t* __restrict__ em,
                    const int32_t* __restrict__ base,
                    uint32_t* __restrict__ out, unsigned long long* status,
                    long long Q, long long n_cap, long long total, int ns) {
  extern __shared__ __align__(16) unsigned char raw[];
  auto& s = *reinterpret_cast<Smem<kStage>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  const Rows r = rows_of(base, at, nsteps, kSlab, Q);
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
    const int t = target(s, threadIdx.x, w0);
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
  for (int k = 1; k < 64; k <<= 1) fill_pass(s, k);
  finish(s, status, at, out, n_cap);
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
  auto& s = *reinterpret_cast<Smem<kStage>*>(raw);
  const long long nsteps = n_cap / kWin;
  const Unit at = begin(s, status, nsteps, total);
  if (kDma) {
    const Rows r = rows_of(base, at, nsteps, kSlab, Q);
    const int32_t* prow = pb + at.b * Q;
    const uint32_t* erow = em + at.b * Q;
    const int w0 = static_cast<int>(at.u * kWin);
    for (long long r0 = r.lo; r0 < r.hi; r0 += kStage) {
      stage(s, prow, erow, r0, kStage, Q, static_cast<int>(n_cap));
      if (kSlabs) {
        const int t = target(s, threadIdx.x, w0);
        if (t >= 0) put(s, t, s.em[threadIdx.x]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kFill; ++i) fill_pass(s, 1 << i);
  finish(s, status, at, out, n_cap);
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
  constexpr size_t smem = sizeof(Smem<kStage>);
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
      return run(place_wide_kernel<128>, sizeof(Smem<128>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
    case 256:
      return run(place_wide_kernel<256>, sizeof(Smem<256>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
    case 512:
      return run(place_wide_kernel<512>, sizeof(Smem<512>), B, units, st,
                 pb, emits, base, out, status, Q, n_cap);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 <= ns <= 64
QK_API int qk_place_narrow(const void* pb, const void* emits, const void* base,
                           void* out, void* status, int B, long long Q,
                           long long n_cap, int ns, void* stream) {
  if (ns < 1 || ns > kStripes) return static_cast<int>(cudaErrorInvalidValue);
  return run(place_narrow_kernel, sizeof(Smem<kStage>), B, n_cap / kWin,
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
