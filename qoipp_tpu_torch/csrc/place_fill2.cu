// E3: the windowed placement, two windows a block, reach past 7 searched
// only where a chunk is longer than 8.
//
// Replaces benchmarks/expt_place2.py: place_fill2 (_kernel2).  The function
// is K2's (csrc/place_fill.cu, ops/place_window.py): row r of an image
// writes emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (pb[Q] := n_cap) and
// pb[r] < n_cap; inside each window of kWin pixels a pixel takes the word
// of the nearest writer at or to its left in the window, at most 63 away,
// and any other pixel the carry, the previous window's last output (0 in
// an image's first window).  Its plain version is
// ops/place_kernel.place_fill_reference.
//
// What the experiment asks, and keeps here: one block covers a unit of two
// windows from one row range, the slabs of 128 rows base[2u] .. base[2u +
// 2] (both included, cut at Q) that base_step names; and the fill searches
// past 7 pixels back only in a window whose longest in-window chunk
// (pb[r+1] - pb[r] of its writers) exceeds 8.  That is exact: when every
// writer's chunk is at most 8 long, the next writer after one lies at most
// 8 pixels on, so every pixel after the window's first writer is at most 7
// from its nearest writer, and the pixels before the first writer take the
// carry whatever the reach.
//
// What bounds it on the card: bytes, 8 per row read and 4 per pixel
// written.  The design, after K2's:
//   - blocks take units in the order of an atomic ticket;
//   - the unit's rows are read in tiles of kTile, kRowsPer coalesced rows
//     a thread straight into registers; a writer's next pb is a shuffle
//     away (lane 31 loads its own); the next tile's loads are issued
//     before the current tile is placed; the range ends at the base_step
//     slab past the unit, or earlier where the next tile's first row (a
//     load every thread makes with its tile, so no block sync) lies past
//     the unit;
//   - a writer stores its word into a 64 KB shared word array and sets its
//     bit in a 2 KB mask (atomicOr); only the mask is zeroed;
//   - each window's longest chunk: a maximum a thread, a warp reduction,
//     one shared atomicMax a warp and window;
//   - the fill is a nearest-writer search over the mask a 4-pixel quad at
//     a time (qk::quad_nearest): the quad's mask word and the one before
//     it in a window of short chunks, and one more in the others;
//   - the carry by decoupled look-back (qoipp_kernels.cuh): right after
//     placing, thread 0 publishes the unit's last output if window 1's or
//     window 0's last pixel is owned, else "inherit".  Window 1's carry is
//     window 0's last output, so only pixels of window 0, or of window 1
//     when window 0's last pixel is not owned, need the walk back, and the
//     block walks back only if one does.  Quads with no carry pixel are
//     stored (16-byte stores) before the walk; the others after it.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;             // pixels per window
constexpr int kUnit = 2 * kWin;        // pixels per block
constexpr int kWinWords = kWin / 32;   // mask words per window
constexpr int kSlab = 128;             // rows per base_step slab
constexpr int kThreads = 512;
constexpr int kRowsPer = 4;            // rows a thread a tile
constexpr int kTile = kThreads * kRowsPer;
constexpr int kQuads = kUnit / 4 / kThreads;  // quads a thread: 4 a window
constexpr int kShort = 8;  // longest chunk for which two mask words suffice
constexpr uint32_t kFull = 0xFFFFFFFFu;
static_assert(kUnit / 32 == kThreads, "one mask word a thread");

struct Shared {
  uint32_t word[kUnit];
  uint32_t mask[kUnit / 32];
  unsigned long long ticket;
  int longest[2];   // each window's longest chunk
  int need[2];      // a pixel of the window takes the carry
  int own[2];       // the window's last pixel is written or filled
  uint32_t last[2]; // its word if so
  uint32_t carry;   // the carry into the unit
};

struct Tile {
  int32_t p[kRowsPer], nxt[kRowsPer];  // nxt: lane 31's next pb
  uint32_t e[kRowsPer];
  int32_t ahead;  // pb of the next tile's first row
};

__device__ __forceinline__ void load(Tile& t, const int32_t* prow,
                                     const uint32_t* erow, long long r0,
                                     long long Q, int n_cap) {
  const bool last_lane = (threadIdx.x & 31) == 31;
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const long long r = r0 + k * kThreads + threadIdx.x;
    t.p[k] = r < Q ? prow[r] : n_cap;
    t.e[k] = r < Q ? erow[r] : 0u;
    t.nxt[k] = last_lane ? (r + 1 < Q ? prow[r + 1] : n_cap) : 0;
  }
  t.ahead = r0 + kTile < Q ? prow[r0 + kTile] : n_cap;
}

__global__ void __launch_bounds__(kThreads, 3)
place_fill2_kernel(const int32_t* __restrict__ pb,
                   const uint32_t* __restrict__ em,
                   const int32_t* __restrict__ base,
                   uint32_t* __restrict__ out, unsigned long long* status,
                   long long Q, int n_cap, long long units) {
  extern __shared__ __align__(16) unsigned char raw[];
  Shared& s = *reinterpret_cast<Shared*>(raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  if (t == 0) s.ticket = qk::take_ticket(status, gridDim.x);
  if (t < 2) s.longest[t] = s.need[t] = 0;
  s.mask[t] = 0u;
  __syncthreads();
  const long long me = static_cast<long long>(s.ticket);
  const long long b = me / units;
  const int u0 = static_cast<int>(me % units) * kUnit;
  const int u_end = u0 + kUnit;
  const int32_t* prow = pb + b * Q;
  const uint32_t* erow = em + b * Q;
  const int32_t* bb = base + b * (2 * units + 1) + 2 * (me % units);
  const long long lo = static_cast<long long>(bb[0]) * kSlab;
  const long long hi = min((static_cast<long long>(bb[2]) + 1) * kSlab, Q);

  // place the writers, keeping each window's longest chunk
  int len0 = 0, len1 = 0;
  if (lo < hi) {
    Tile cur;
    load(cur, prow, erow, lo, Q, n_cap);
    for (long long r0 = lo;; r0 += kTile) {
      const bool more = r0 + kTile < hi && cur.ahead < u_end;
      Tile nxt;
      if (more) load(nxt, prow, erow, r0 + kTile, Q, n_cap);
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const int32_t down = __shfl_down_sync(kFull, cur.p[k], 1);
        const int32_t n = lane == 31 ? cur.nxt[k] : down;
        const int x = cur.p[k] - u0;
        if (x >= 0 && x < kUnit && n > cur.p[k]) {
          s.word[x] = cur.e[k];
          atomicOr(&s.mask[x >> 5], 1u << (x & 31));
          if (x < kWin) len0 = max(len0, n - cur.p[k]);
          else len1 = max(len1, n - cur.p[k]);
        }
      }
      if (!more) break;
      cur = nxt;
    }
  }
  len0 = __reduce_max_sync(kFull, len0);
  len1 = __reduce_max_sync(kFull, len1);
  if (lane == 0 && len0 > 0) atomicMax(&s.longest[0], len0);
  if (lane == 0 && len1 > 0) atomicMax(&s.longest[1], len1);
  __syncthreads();

  if (t == 0) {  // each window's last output, then publish the unit's
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int src[4];
      qk::quad_nearest<3>(s.mask, h * kWin + kWin - 4, h * kWinWords, src);
      s.own[h] = src[3] >= 0;
      s.last[h] = src[3] >= 0 ? s.word[src[3]] : 0u;
    }
    qk::publish(status, me, s.own[0] || s.own[1],
                s.own[1] ? s.last[1] : s.last[0]);
  }

  const bool lng[2] = {s.longest[0] > kShort, s.longest[1] > kShort};
  uint4* dst = reinterpret_cast<uint4*>(out + b * n_cap + u0);
  int left = 0;  // this thread's quads with a pixel left to the carry
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int q = t + j * kThreads;
    const int h = j / (kQuads / 2);  // the quad's window
    int src[4];
    if (lng[h])
      qk::quad_nearest<3>(s.mask, 4 * q, h * kWinWords, src);
    else
      qk::quad_nearest<2>(s.mask, 4 * q, h * kWinWords, src);
    if ((src[0] | src[1] | src[2] | src[3]) < 0) {
      left |= 1 << j;
      s.need[h] = 1;
    } else {
      dst[q] = make_uint4(s.word[src[0]], s.word[src[1]], s.word[src[2]],
                          s.word[src[3]]);
    }
  }
  __syncthreads();
  if (!s.need[0] && !s.need[1]) return;  // uniform: no pixel takes a carry

  // window 1's carry is window 0's last output: walk back only if a pixel
  // of window 0 takes the carry, or one of window 1 and window 0's last
  // pixel is not owned (so also whenever the unit inherits)
  if (s.need[0] || !s.own[0]) {
    if (t == 0) {
      s.carry = qk::walk_back(status, me, b * units);
      if (!s.own[0] && !s.own[1]) qk::publish(status, me, true, s.carry);
    }
    __syncthreads();
  }
  const uint32_t c[2] = {s.carry, s.own[0] ? s.last[0] : s.carry};
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    if (!(left >> j & 1)) continue;
    const int q = t + j * kThreads;
    const int h = j / (kQuads / 2);
    int src[4];
    if (lng[h])
      qk::quad_nearest<3>(s.mask, 4 * q, h * kWinWords, src);
    else
      qk::quad_nearest<2>(s.mask, 4 * q, h * kWinWords, src);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = src[i] >= 0 ? s.word[src[i]] : c[h];
    dst[q] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// Resident blocks an SM at the kernel's shared memory and registers (or a
// negative CUDA error); its threads a block in *threads.
QK_API int qk_place_fill2_occupancy(int* threads) {
  *threads = kThreads;
  int n = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      place_fill2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Shared)));
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, place_fill2_kernel, kThreads, sizeof(Shared));
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// pb (B, Q) int32 nondecreasing, emits (B, Q) uint32, base (B, n_cap / 8192
// + 1) int32 (window_base_rows), out (B, n_cap) uint32, status (B * n_cap
// / 16384 + 1) zeroed 64-bit words (one per unit, then the ticket);
// n_cap a multiple of 16384 below 2^31.
QK_API int qk_place_fill2(const void* pb, const void* emits, const void* base,
                          void* out, void* status, int B, long long Q,
                          long long n_cap, void* stream) {
  if (B < 1 || Q < 0 || n_cap < kUnit || n_cap % kUnit ||
      n_cap >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      place_fill2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Shared)));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long units = n_cap / kUnit;
  place_fill2_kernel<<<static_cast<unsigned>(B * units), kThreads,
                       sizeof(Shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, static_cast<int>(n_cap),
      units);
  return qk::launch_status();
}
