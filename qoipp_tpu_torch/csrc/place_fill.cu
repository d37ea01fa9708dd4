// K2: decode pixel placement + run fill, the windowed placement.
//
// Replaces qoipp_tpu/ops/place_kernel.py: place_fill (the Pallas body
// _place_fill_kernel), and gives its whole (B, n_cap) output.
//
// pb (B, Q) int32 is each row's pixel offset (exclusive prefix sum of the
// pixels its chunk produces), nondecreasing along a row.  Row r writes
// emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (pb[Q] := n_cap) and
// 0 <= pb[r] < n_cap.  Pixels are cut into windows of kWin; inside a window
// a pixel takes the word of the nearest written pixel at or before it, at
// most kReach away (a chunk produces at most 62 pixels); any other pixel
// takes the carry, the previous window's last output (0 in an image's
// first window).  The plain version is
// ops/place_kernel.place_fill_reference.
//
// What bounds it on the card: bytes -- 8 per row read, 4 per pixel
// written -- once the latency of finding a window's rows is hidden: a
// search per pixel would be log2(Q) dependent loads.
// What the design does:
//   - one block of kThreads per window, in the order of an atomic ticket,
//     so that a block only ever waits on windows that are already running;
//   - the block finds the window's first row itself, all threads probing
//     pb at kProbes evenly spaced rows a round, counted by
//     __syncthreads_count (two rounds up to a million rows);
//   - it reads the rows in tiles of kTile, each thread kRowsPer coalesced
//     rows of pb and emits at once (the writer test's next pb is a shuffle
//     away, lane 31 loads it), until the next tile's first row lies past
//     the window; a row is used only by the thread that read it, so rows
//     go straight from registers to the window;
//   - each writer stores its word into a 32 KB shared window and sets its
//     bit in a 1 KB mask of 32-pixel words; a pixel's nearest writer at
//     most 63 back lies in its own mask word or the two before it, so the
//     fill is three shared loads and a count of leading zeros, no passes;
//   - the carry by decoupled look-back: right after placing, a window
//     whose last pixel is owned publishes that word, any other "inherit";
//     a window that needs its carry walks back to the nearest published
//     word, and an inheriting one then publishes what it found.  Only
//     windows with pixels left to the carry wait;
//   - the window is stored with 16-byte stores.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;         // pixels per window
constexpr int kMaskWords = kWin / 32;
constexpr int kReach = 63;
constexpr int kThreads = 512;
constexpr int kProbesPer = 2;      // search probes per thread a round
constexpr int kProbes = kThreads * kProbesPer;
constexpr int kRowsPer = 4;        // rows per thread a tile
constexpr int kTile = kThreads * kRowsPer;
constexpr int kQuadsPer = kWin / 4 / kThreads;  // 16-byte stores a thread
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct Shared {
  uint32_t word[kWin];
  uint32_t mask[kMaskWords];  // bit p % 32 of word p / 32: pixel p written
  unsigned long long ticket;
  uint32_t carry;
};

// The first row of `row` (Q rows, nondecreasing) with pb >= target, Q if
// none.  All threads; every round narrows [lo, hi] to one gap between
// kProbes evenly spaced probes.
__device__ long long first_at_least(const int32_t* __restrict__ row,
                                    long long Q, int target) {
  long long lo = 0, hi = Q;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + kProbes - 1) / kProbes;
    const long long i0 = lo + threadIdx.x * kProbesPer * step;
    const long long i1 = i0 + step;
    const bool b0 = i0 < hi && row[i0] < target;
    const bool b1 = i1 < hi && row[i1] < target;
    // pb is nondecreasing: the probes below target are a prefix
    const long long below = __syncthreads_count(b0) + __syncthreads_count(b1);
    const long long nlo = below ? lo + (below - 1) * step + 1 : lo;
    hi = min(lo + below * step, hi);
    lo = nlo;
  }
  return lo;
}

// Pixel p's nearest written pixel in the window at or before it, at most
// kReach away, or -1.
__device__ __forceinline__ int nearest(const uint32_t* mask, int p) {
  const int k = p >> 5;
  const uint32_t m0 = mask[k] & (kFull >> (31 - (p & 31)));
  if (m0) return (k << 5) + 31 - __clz(m0);
  const uint32_t m1 = k >= 1 ? mask[k - 1] : 0u;
  if (m1) return ((k - 1) << 5) + 31 - __clz(m1);
  const uint32_t m2 = k >= 2 ? mask[k - 2] : 0u;
  const int src = m2 ? ((k - 2) << 5) + 31 - __clz(m2) : -1;
  return src >= 0 && p - src <= kReach ? src : -1;
}

__global__ void __launch_bounds__(kThreads)
place_fill_kernel(const int32_t* __restrict__ pb,
                  const uint32_t* __restrict__ emits,
                  uint32_t* __restrict__ out, unsigned long long* status,
                  long long Q, int n_cap, long long nwin) {
  __shared__ Shared s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) s.ticket = qk::take_ticket(status, gridDim.x);
  for (int i = t; i < kMaskWords; i += kThreads) s.mask[i] = 0u;
  __syncthreads();
  const long long ticket = static_cast<long long>(s.ticket);
  const long long b = ticket / nwin;
  const int w0 = static_cast<int>(ticket % nwin) * kWin;
  const int w_end = w0 + kWin;
  const int32_t* prow = pb + b * Q;
  const uint32_t* erow = emits + b * Q;

  // place the writers of the window's rows
  for (long long r0 = first_at_least(prow, Q, w0);; r0 += kTile) {
    int32_t p[kRowsPer], nxt[kRowsPer];
    uint32_t e[kRowsPer];
#pragma unroll
    for (int k = 0; k < kRowsPer; ++k) {
      const long long r = r0 + k * kThreads + t;
      p[k] = r < Q ? prow[r] : n_cap;
      e[k] = r < Q ? erow[r] : 0u;
      nxt[k] = lane == 31 ? (r + 1 < Q ? prow[r + 1] : n_cap) : 0;
    }
#pragma unroll
    for (int k = 0; k < kRowsPer; ++k) {
      const int32_t down = __shfl_down_sync(kFull, p[k], 1);
      if (lane != 31) nxt[k] = down;
      if (p[k] >= w0 && p[k] < w_end && nxt[k] > p[k]) {
        const int x = p[k] - w0;
        s.word[x] = e[k];
        atomicOr(&s.mask[x >> 5], 1u << (x & 31));
      }
    }
    // the next tile's first row is the last thread's look-ahead row
    if (!__syncthreads_or(t == kThreads - 1 && nxt[kRowsPer - 1] < w_end))
      break;
  }

  const long long me = b * nwin + w0 / kWin;
  const bool own = (s.mask[kMaskWords - 1] | s.mask[kMaskWords - 2]) != 0;
  if (t == 0)
    qk::publish(status, me, own,
                own ? s.word[nearest(s.mask, kWin - 1)] : 0u);

  uint4 q[kQuadsPer];
  int left = 0;  // pixels of this thread left to the carry, as bits
#pragma unroll
  for (int j = 0; j < kQuadsPer; ++j) {
    const int x = 4 * (t + j * kThreads);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int src = nearest(s.mask, x + i);
      v[i] = src >= 0 ? s.word[src] : 0u;
      if (src < 0) left |= 1 << (4 * j + i);
    }
    q[j] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (__syncthreads_or(left)) {
    if (t == 0) {
      s.carry = qk::walk_back(status, me, b * nwin);
      if (!own) qk::publish(status, me, true, s.carry);
    }
    __syncthreads();
    const uint32_t c = s.carry;
#pragma unroll
    for (int j = 0; j < kQuadsPer; ++j) {
      if (left >> (4 * j) & 1) q[j].x = c;
      if (left >> (4 * j + 1) & 1) q[j].y = c;
      if (left >> (4 * j + 2) & 1) q[j].z = c;
      if (left >> (4 * j + 3) & 1) q[j].w = c;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * n_cap + w0);
#pragma unroll
  for (int j = 0; j < kQuadsPer; ++j) dst[t + j * kThreads] = q[j];
}

}  // namespace

// pb (B, Q) int32, emits (B, Q) uint32 -> out (B, n_cap) uint32, n_cap a
// multiple of 8192 below 2^31; status: B * n_cap / 8192 + 1 zeroed
// 64-bit words (one per window, then the ticket counter).
QK_API int qk_place_fill(const void* pb, const void* emits, void* out,
                         void* status, int B, long long Q, long long n_cap,
                         void* stream) {
  if (B < 1 || Q < 0 || n_cap < kWin || n_cap % kWin || n_cap >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nwin = n_cap / kWin;
  place_fill_kernel<<<static_cast<unsigned>(B * nwin), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<uint32_t*>(out), static_cast<unsigned long long*>(status),
      Q, static_cast<int>(n_cap), nwin);
  return qk::launch_status();
}
