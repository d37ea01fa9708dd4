// E4: the grouped summed placement.
//
// Replaces benchmarks/expt_place.py: make_variant(...).run (kernel).  Its
// function (ops/place_window.summed_place_reference) differs from K2's:
// a row places at pb iff 0 <= pb < n_cap (no next-row test); the rows that
// share a pixel add their low 16-bit halves and their high halves, and the
// pixel's word is (sum lo) | (sum hi << 16) mod 2^32, exact in two 32-bit
// sums for any number of rows; pixels are cut into steps of g windows of
// `win` pixels, and inside a step a pixel takes the word of the nearest
// placed pixel at or to its left, at most 63 away, else the carry, the
// previous step's last output (0 at the start of each image).
//
// The candidate rows of window w0 .. w0 + win, in 128-row slabs (the TPU's
// lr_mode): blk = base[j] / 8 * 8 is the step's block (base[j * g] in smem
// mode; slab 0 with static_in, where the block holds only LENR = g * win /
// 128 + 16 slabs).  The kernel counts, over the block, the window's slabs
// [s0, e): s0 the first whose last pb >= w0, e the first whose first pb
// >= w_end, so the slabs that intersect the window;
//   kCnt:    win / 128 + 2 slabs from s0, and on to e;
//   kDyn:    the slabs s0 .. e;
//   kSmem:   like kCnt from slab base[w] (base holds one entry per window);
//   kStatic: win / 128 + 2 slabs from the block's first, whatever the
//            window (timing only: it places the wrong rows on purpose).
//
// What bounds it on the card: bytes, 8 per row read and 4 per pixel
// written.  The design, after K2's (csrc/place_fill.cu):
//   - one block a step in the order of an atomic ticket;
//   - the window's slabs counted by two __syncthreads_count over kProbe
//     slabs a step (the first window's tests loaded while the shared
//     state is zeroed), so the rows to read are known before the first is
//     loaded and no tile waits on a stop test (a probe of 512 slabs a
//     step, mostly far past the window, took the E4 driver's input from
//     0.650 to 0.887 ms on an H100);
//   - rows in tiles of kTile, kRowsPer coalesced rows a thread straight
//     into registers, the next tile's loads issued before the current
//     tile is added;
//   - two 32-bit shared sums a pixel (atomicAdd) and a bit mask (atomicOr),
//     zeroed first, 66 KB a block at the default step of 8,192 pixels;
//   - the fill is a nearest search over the mask a 4-pixel quad at a time
//     (qk::quad_nearest, three words), the halves combined as each quad is
//     written with a 16-byte store;
//   - the carry by decoupled look-back (qoipp_kernels.cuh): thread 0
//     publishes the step's last output right after placing if it owns it,
//     and the block walks back only if one of its pixels takes the carry.
#include "qoipp_kernels.cuh"

namespace {

enum LrMode { kCnt = 0, kDyn = 1, kSmem = 2, kStatic = 3 };
constexpr int kSlab = 128;
constexpr int kThreads = 512;
constexpr int kRowsPer = 4;
constexpr int kTile = kThreads * kRowsPer;
constexpr int kMaxStep = 16384;  // pixels a block: 130 KB of shared memory
constexpr int kMaxQuads = kMaxStep / 4 / kThreads;  // quads a thread
constexpr int kProbe = 32;  // slabs a count step tests: one warp's loads

struct Tile {
  int32_t p[kRowsPer];
  uint32_t e[kRowsPer];
};

// Rows r0 .. r0 + kTile, those at or past `limit` reading as pb = n_cap.
__device__ __forceinline__ void load(Tile& t, const int32_t* prow,
                                     const uint32_t* erow, long long r0,
                                     long long limit, int32_t n_cap) {
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const long long r = r0 + k * kThreads + threadIdx.x;
    t.p[k] = r < limit ? prow[r] : n_cap;
    t.e[k] = r < limit ? erow[r] : 0u;
  }
}

// Slab s + threadIdx.x, in the first kProbe threads and below lim:
// whether its last pb lies below w0, and whether its first pb lies below
// w_end.
__device__ __forceinline__ void slab_tests(const int32_t* prow, long long s,
                                           long long lim, long long Q,
                                           int32_t n_cap, int w0, int w_end,
                                           bool& below, bool& starts) {
  const long long k = s + threadIdx.x;
  const long long r = k * kSlab;
  const bool in = threadIdx.x < kProbe && k < lim;  // then r < Q
  below = in && (r + kSlab - 1 < Q ? prow[r + kSlab - 1] : n_cap) < w0;
  starts = in && prow[r] < w_end;
}

// A step pixel's word from its two sums.
__device__ __forceinline__ uint32_t word(const uint32_t* lo,
                                         const uint32_t* hi, int x) {
  return lo[x] | hi[x] << 16;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 3)
place_grouped_kernel(const int32_t* __restrict__ pb,
                     const uint32_t* __restrict__ em,
                     const int32_t* __restrict__ base,
                     uint32_t* __restrict__ out, unsigned long long* status,
                     long long Q, long long n_cap, int nbase, int win, int g,
                     int static_in) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ unsigned long long ticket;
  __shared__ int own, need;
  __shared__ uint32_t last_out, carry;
  const int t = threadIdx.x;
  const int step = win * g;
  uint32_t* lo = reinterpret_cast<uint32_t*>(raw);
  uint32_t* hi = lo + step;
  uint32_t* mask = hi + step;  // step / 32 words
  if (t == 0) {
    ticket = qk::take_ticket(status, gridDim.x);
    need = 0;
  }
  __syncthreads();
  const long long nsteps = n_cap / step;
  const long long tk = static_cast<long long>(ticket);
  const long long b = tk / nsteps, j = tk % nsteps;
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
  const long long cbr = win / kSlab + 2;  // the TPU's fixed slabs a window

  // Both tests hold on a prefix of the slabs from `at` on (pb is
  // nondecreasing, and `below` implies `starts`), and on a longer one for
  // each later window, so each window counts from the one before's s0.
  constexpr bool kCount = kMode != kStatic;
  bool below = false, starts = false, loaded = kCount;
  if (kCount)
    slab_tests(prow, at, lim, Q, ncap, static_cast<int>(j * step),
               static_cast<int>(j * step) + win, below, starts);
  uint4* z = reinterpret_cast<uint4*>(raw);
  for (int i = t; i < (2 * step + step / 32) / 4; i += kThreads)
    z[i] = make_uint4(0, 0, 0, 0);
  if (!kCount) __syncthreads();  // else the first count's syncs are this

  long long s0 = at;
  for (int gi = 0; gi < g; ++gi) {
    const int w0 = static_cast<int>(j * step) + gi * win;
    const int w_end = w0 + win;
    long long rs = at, limit = at + cbr;  // in slabs
    if (kCount) {
      long long first = -1, e = 0;
      for (long long s = s0;; s += kProbe) {
        if (!loaded)
          slab_tests(prow, s, lim, Q, ncap, w0, w_end, below, starts);
        loaded = false;
        const int nb = __syncthreads_count(below);
        const int ns = __syncthreads_count(starts);
        if (first < 0 && nb < kProbe) first = s + nb;
        if (ns < kProbe) {
          e = s + ns;
          break;
        }
      }
      s0 = first;
      rs = kMode == kSmem ? at + brow[j * g + gi] - blk : s0;
      limit = kMode == kDyn ? e : max(rs + cbr, e);
    }
    rs *= kSlab;
    limit = min(limit * kSlab, rlim);
    if (rs >= limit) continue;
    Tile cur;
    load(cur, prow, erow, rs, limit, ncap);
    for (long long r0 = rs;; r0 += kTile) {
      const bool more = r0 + kTile < limit;
      Tile nxt;
      if (more) load(nxt, prow, erow, r0 + kTile, limit, ncap);
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const int32_t p = cur.p[k];
        if (p >= w0 && p < w_end) {
          const int x = p - w0 + gi * win;
          atomicAdd(lo + x, cur.e[k] & 0xFFFFu);
          atomicAdd(hi + x, cur.e[k] >> 16);
          atomicOr(mask + (x >> 5), 1u << (x & 31));
        }
      }
      if (!more) break;
      cur = nxt;
    }
  }
  __syncthreads();

  if (t == 0) {  // the step's last output, published at once if owned
    int src[4];
    qk::quad_nearest<3>(mask, step - 4, 0, src);
    own = src[3] >= 0;
    last_out = src[3] >= 0 ? word(lo, hi, src[3]) : 0u;
    qk::publish(status, tk, own, last_out);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * n_cap + j * step);
  const int quads = step / 4;
  int left = 0;  // this thread's quads with a pixel left to the carry
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int q = t + i * kThreads;
    if (q >= quads) break;
    int src[4];
    qk::quad_nearest<3>(mask, 4 * q, 0, src);
    if ((src[0] | src[1] | src[2] | src[3]) < 0)
      left |= 1 << i;
    else
      dst[q] = make_uint4(word(lo, hi, src[0]), word(lo, hi, src[1]),
                          word(lo, hi, src[2]), word(lo, hi, src[3]));
  }
  if (left) need = 1;
  __syncthreads();
  if (!need) return;  // uniform: no pixel takes the carry
  if (t == 0) {
    carry = qk::walk_back(status, tk, tk - j);
    if (!own) qk::publish(status, tk, true, carry);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    if (!(left >> i & 1)) continue;
    const int q = t + i * kThreads;
    int src[4];
    qk::quad_nearest<3>(mask, 4 * q, 0, src);
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = src[k] >= 0 ? word(lo, hi, src[k]) : carry;
    dst[q] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

size_t shared_bytes(int step) {
  return (2 * static_cast<size_t>(step) + step / 32) * sizeof(uint32_t);
}

template <int kMode>
int run(int B, cudaStream_t stream, const void* pb, const void* emits,
        const void* base, void* out, void* status, long long Q,
        long long n_cap, int nbase, int win, int g, int static_in) {
  const size_t smem = shared_bytes(win * g);
  const cudaError_t rc = cudaFuncSetAttribute(
      place_grouped_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long total = B * (n_cap / (static_cast<long long>(win) * g));
  place_grouped_kernel<kMode><<<static_cast<unsigned>(total), kThreads, smem,
                                stream>>>(
      static_cast<const int32_t*>(pb), static_cast<const uint32_t*>(emits),
      static_cast<const int32_t*>(base), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(status), Q, n_cap, nbase, win, g,
      static_in);
  return qk::launch_status();
}

bool bad_step(long long win, long long g, long long n_cap) {
  const long long step = win * g;
  return win <= 0 || win % kSlab || g < 1 || step > kMaxStep ||
         n_cap % step || n_cap >= (1ll << 31);
}

}  // namespace

// Resident blocks an SM of the dyn kernel at a step of win * g pixels
// (or a negative CUDA error); its threads a block in *threads.
QK_API int qk_place_grouped_occupancy(int win, int g, int* threads) {
  *threads = kThreads;
  if (bad_step(win, g, static_cast<long long>(win) * g))
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(win * g);
  int n = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      place_grouped_kernel<kDyn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, place_grouped_kernel<kDyn>, kThreads, smem);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// pb (B, Q) int32 nondecreasing, emits (B, Q) uint32, base (B, nbase) int32
// holds a slab per step (a slab per window in smem mode), out (B, n_cap)
// uint32, status (B * n_cap / (win * g) + 1) zeroed 64-bit words (one per
// step, then the ticket); win % 128 == 0, win * g <= 16384 and divides
// n_cap < 2^31; mode 0 cnt, 1 dyn, 2 smem, 3 static.
QK_API int qk_place_grouped(const void* pb, const void* emits,
                            const void* base, void* out, void* status, int B,
                            long long Q, long long n_cap, int nbase, int win,
                            int g, int mode, int static_in, void* stream) {
  if (B < 1 || Q < 0 || bad_step(win, g, n_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCnt:
      return run<kCnt>(B, st, pb, emits, base, out, status, Q, n_cap, nbase,
                       win, g, static_in);
    case kDyn:
      return run<kDyn>(B, st, pb, emits, base, out, status, Q, n_cap, nbase,
                       win, g, static_in);
    case kSmem:
      return run<kSmem>(B, st, pb, emits, base, out, status, Q, n_cap,
                        nbase, win, g, static_in);
    case kStatic:
      return run<kStatic>(B, st, pb, emits, base, out, status, Q, n_cap,
                          nbase, win, g, static_in);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
