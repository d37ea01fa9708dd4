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

// The bit-mask fill of K2 and E3-E6: pixel p of a block's region is
// written iff bit p % 32 of mask word p / 32 is set.  For the quad x .. x +
// 3 (x % 4 == 0, one mask word), src[i] is pixel x + i's nearest written
// pixel at or before it, at most kReach away and not before the region
// part that starts at mask word `first`, or -1.  It is searched in the
// quad's own word and the kWords - 1 words before it: one word reaches 0,
// two reach at least 31, three 63; two also suffice for a reach of 63
// wherever every written pixel's next written pixel is at most 8 after it.
template <int kWords, int kReach = 63>
__device__ __forceinline__ void quad_nearest(const uint32_t* mask, int x,
                                             int first, int src[4]) {
  static_assert(kWords >= 1 && kWords <= 3, "at most two words back");
  static_assert(kReach >= 0 && kReach <= 63, "at most 63 back");
  const int k = x >> 5;
  const uint32_t m0 = mask[k];
  const uint32_t m1 = kWords >= 2 && k - 1 >= first ? mask[k - 1] : 0u;
  const uint32_t m2 = kWords == 3 && k - 2 >= first ? mask[k - 2] : 0u;
  const int back = m1   ? ((k - 1) << 5) + 31 - __clz(m1)
                   : m2 ? ((k - 2) << 5) + 31 - __clz(m2)
                        : -1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = x + i;
    const uint32_t mine = m0 & (0xFFFFFFFFu >> (31 - (p & 31)));
    const int s = mine ? (k << 5) + 31 - __clz(mine) : back;
    src[i] = s >= 0 && p - s <= kReach ? s : -1;
  }
}

// ---- K2, E5 and E6: one window a block (place_fill.cu, place_narrow.cu,
// place_variant.cu) ----
//
// A block takes its window from the ticket (begin), reads the window's
// candidate rows (E5, E6: base_step's slabs base[w] .. base[w + 1], both
// included, cut at Q) a 128-row group a warp at a time, four consecutive
// rows a lane (16-byte loads where Q % 4 == 0 and the rows are 16-byte
// aligned), with the next kStages - 1 groups of the warp in flight in
// registers while one is placed (for_each_group; K2 searches and reads
// its own).  Writers store their word into a shared word array and set
// their bit in a shared mask; only the mask is zeroed.  After one block
// sync (finish) the fill is quad_nearest over the mask, the carry a
// decoupled look-back, the stores 16 bytes a thread.  No block sync while
// E5 and E6 place rows: a warp streams its own groups.
namespace win {

constexpr int kWin = 8192;  // pixels per window
constexpr int kMaskWords = kWin / 32;
constexpr int kStripes = kWin / 128;  // 128-pixel stripes (E5's span unit)
constexpr int kSlab = 128;            // rows per base_step slab
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;  // rows a warp places at once, four a lane
constexpr int kStages = 3;   // groups a warp holds in registers
constexpr int kQuads = kWin / 4 / kThreads;  // 16-byte stores a thread
constexpr uint32_t kFull = 0xFFFFFFFFu;
static_assert(kMaskWords <= kThreads, "one thread zeroes a mask word");

struct Window {
  uint32_t word[kWin];        // a written pixel's word
  uint32_t mask[kMaskWords];  // bit p % 32 of word p / 32: pixel p written
  unsigned long long ticket;
  uint32_t carry;  // the carry into the window
};

// The block's window and its candidate rows [lo, hi) of image b.
struct Span {
  long long b;
  long long me, first;  // status index of the window, of the image's first
  int w0;               // the window's first pixel
  long long lo, hi;
  const int32_t* prow;
  const uint32_t* erow;
};

// Take a ticket, zero the mask, and (with `rows`) read the window's
// candidate row range from base.  Ends on a barrier.
__device__ __forceinline__ Span begin(Window& s, unsigned long long* status,
                                      const int32_t* base, const int32_t* pb,
                                      const uint32_t* em, long long Q,
                                      long long n_cap, bool rows) {
  if (threadIdx.x == 0) s.ticket = take_ticket(status, gridDim.x);
  if (threadIdx.x < kMaskWords) s.mask[threadIdx.x] = 0u;
  __syncthreads();
  const long long me = static_cast<long long>(s.ticket);
  const long long units = n_cap / kWin;
  const long long b = me / units, u = me % units;
  Span sp{b, me, me - u, static_cast<int>(u * kWin), 0, 0, pb + b * Q,
          em + b * Q};
  if (rows) {
    const int32_t* bb = base + b * (units + 1) + u;
    sp.lo = static_cast<long long>(bb[0]) * kSlab;
    sp.hi = min((static_cast<long long>(bb[1]) + 1) * kSlab, Q);
  }
  return sp;
}

// A lane's four consecutive rows of a group; `after` (lane 31 only) is the
// pb of the row after the group, the other lanes shuffle theirs.
struct Rows {
  uint4 p, e;
  int32_t after;
};

// Load the lane's rows r .. r + 3 (r % 4 == 0).  Rows at or past hi read
// as pb = n_cap, e = 0: the row before hi never writes in the window
// (slab base[w + 1] ends with a pb at or past the window's end, or hi =
// Q), so cutting the look-ahead there changes no writer.  `vec`: Q % 4 ==
// 0 and both planes 16-byte aligned.
__device__ __forceinline__ void load_rows(Rows& t, const Span& sp,
                                          long long r, int n_cap, bool vec) {
  const unsigned cap = static_cast<unsigned>(n_cap);
  if (vec) {
    if (r < sp.hi) {
      t.p = __ldg(reinterpret_cast<const uint4*>(sp.prow + r));
      t.e = __ldg(reinterpret_cast<const uint4*>(sp.erow + r));
    } else {
      t.p = make_uint4(cap, cap, cap, cap);
      t.e = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    auto pb = [&](long long i) {
      return i < sp.hi ? static_cast<unsigned>(__ldg(sp.prow + i)) : cap;
    };
    auto em = [&](long long i) { return i < sp.hi ? __ldg(sp.erow + i) : 0u; };
    t.p = make_uint4(pb(r), pb(r + 1), pb(r + 2), pb(r + 3));
    t.e = make_uint4(em(r), em(r + 1), em(r + 2), em(r + 3));
  }
  t.after = (threadIdx.x & 31) == 31 && r + 4 < sp.hi ? __ldg(sp.prow + r + 4)
                                                      : n_cap;
}

// Call place(rows) for every group of the window's candidate rows; warp w
// takes groups w, w + kWarps, ... and keeps kStages of them in registers,
// so the next ones' loads are in flight while one is placed.
// Warp-uniform: place may use warp collectives.
template <class Place>
__device__ __forceinline__ void for_each_group(const Span& sp, int n_cap,
                                               bool vec, Place&& place) {
  constexpr long long kStride = static_cast<long long>(kWarps) * kGroup;
  const long long first = sp.lo + (threadIdx.x >> 5) * kGroup;
  const int off = 4 * (threadIdx.x & 31);
  Rows ring[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    load_rows(ring[i], sp, first + i * kStride + off, n_cap, vec);
  for (long long g = first; g < sp.hi; g += kStages * kStride) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      const long long gi = g + i * kStride;
      if (gi >= sp.hi) break;
      place(ring[i]);
      load_rows(ring[i], sp, gi + kStages * kStride + off, n_cap, vec);
    }
  }
}

// The lane's rows as arrays: pb, the next row's pb, emits.
struct Lane {
  int32_t p[4], n[4];
  uint32_t e[4];
};

__device__ __forceinline__ Lane lane_rows(const Rows& t) {
  const int32_t down = __shfl_down_sync(kFull, static_cast<int32_t>(t.p.x), 1);
  const int32_t p[4] = {static_cast<int32_t>(t.p.x),
                        static_cast<int32_t>(t.p.y),
                        static_cast<int32_t>(t.p.z),
                        static_cast<int32_t>(t.p.w)};
  return Lane{{p[0], p[1], p[2], p[3]},
              {p[1], p[2], p[3], (threadIdx.x & 31) == 31 ? t.after : down},
              {t.e.x, t.e.y, t.e.z, t.e.w}};
}

// Row-driven placement of a lane's rows: each writer in the window stores
// its word and sets its bit, one shared atomicOr a mask word the lane
// touches.
__device__ __forceinline__ void place_rows(Window& s, const Lane& r, int w0) {
  int at = -1;
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = r.p[k] - w0;
    if (static_cast<unsigned>(x) < static_cast<unsigned>(kWin) &&
        r.n[k] > r.p[k]) {
      s.word[x] = r.e[k];
      if (x >> 5 != at) {
        if (bits) atomicOr(&s.mask[at], bits);
        at = x >> 5;
        bits = 0u;
      }
      bits |= 1u << (x & 31);
    }
  }
  if (bits) atomicOr(&s.mask[at], bits);
}

// After the placement: the fill at reach kReach over the mask, the
// look-back (publish the window's last output if it owns it, else
// "inherit"; walk back only if a pixel takes the carry, and an inheriting
// window then publishes what it found), and the window's 16-byte stores.
template <int kReach>
__device__ __forceinline__ void finish(Window& s, const Span& sp,
                                       unsigned long long* status,
                                       uint32_t* out, long long n_cap) {
  constexpr int kW = kReach == 0 ? 1 : kReach <= 31 ? 2 : 3;
  const int t = threadIdx.x;
  __syncthreads();
  bool own = false;
  if (t == 0) {
    int src[4];
    quad_nearest<kW, kReach>(s.mask, kWin - 4, 0, src);
    own = src[3] >= 0;
    publish(status, sp.me, own, own ? s.word[src[3]] : 0u);
  }
  uint4 q[kQuads];
  int left = 0;  // this thread's pixels left to the carry, as bits
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    int src[4];
    quad_nearest<kW, kReach>(s.mask, 4 * (t + j * kThreads), 0, src);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = src[i] >= 0 ? s.word[src[i]] : 0u;
      if (src[i] < 0) left |= 1 << (4 * j + i);
    }
    q[j] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (__syncthreads_or(left)) {
    if (t == 0) {
      s.carry = walk_back(status, sp.me, sp.first);
      if (!own) publish(status, sp.me, true, s.carry);
    }
    __syncthreads();
    const uint32_t c = s.carry;
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      if (left >> (4 * j) & 1) q[j].x = c;
      if (left >> (4 * j + 1) & 1) q[j].y = c;
      if (left >> (4 * j + 2) & 1) q[j].z = c;
      if (left >> (4 * j + 3) & 1) q[j].w = c;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + sp.b * n_cap + sp.w0);
#pragma unroll
  for (int j = 0; j < kQuads; ++j) dst[t + j * kThreads] = q[j];
}

// The checks every K2/E5/E6 entry makes: B >= 1, Q >= 0, n_cap a positive
// multiple of kWin below 2^31.
inline bool shape_ok(int B, long long Q, long long n_cap) {
  return B >= 1 && Q >= 0 && n_cap >= kWin && n_cap % kWin == 0 &&
         n_cap < (1ll << 31);
}

// Q % 4 == 0 and both planes 16-byte aligned: the 16-byte row loads.
inline bool rows_vec(const void* pb, const void* emits, long long Q) {
  return Q % 4 == 0 && reinterpret_cast<uintptr_t>(pb) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(emits) % 16 == 0;
}

// Resident blocks an SM of `kernel` (or a negative CUDA error); kThreads
// a block in *threads.
template <class K>
int occupancy(K kernel, int* threads) {
  *threads = kThreads;
  int n = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

}  // namespace win

}  // namespace qk
