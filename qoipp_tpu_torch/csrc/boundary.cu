// The chunk-start scan of the decoders' boundary pass, in one pass.
//
// Replaces no Pallas kernel: the JAX package's scan is plain JAX
// (qoipp_tpu/ops/boundary.py: chunk_starts_batch, a lax.scan over each
// block's bytes and a lax.associative_scan across blocks).  Added because
// its plain PyTorch version (ops/boundary.chunk_starts_batch_plain) is two
// 128-step Python loops of elementwise launches around a log-doubling
// gather, ~925 launches a call whatever the shape: every decode path of
// the port ran them, and the host issued them slower than the card ran
// them.
//
// is_start[b, p] says whether byte p of row b starts a chunk.  Byte 0
// does; a chunk's length follows from its tag byte alone (RGB 4, RGBA 5,
// LUMA 2, else 1).  With the phase phi(p) = (next chunk start >= p) - p
// in {0..4}, phi(0) = 0 and
//
//     phi(p + 1) = phi(p) - 1        if phi(p) > 0
//                = len(p) - 1        if phi(p) == 0   (p starts a chunk)
//
// so a span of bytes is a map of {0..4} onto itself, and maps compose
// associatively: a scan.
//
// What bounds it on the card: bytes -- each region byte read once and
// each flag byte written once, 2 bytes a byte at 3.35 TB/s.
// What the design does:
//   - one block of kThreads per tile of kTile bytes of one row, in the
//     order of an atomic ticket, so a block only ever waits on tiles that
//     are already running;
//   - each thread loads its kBytes bytes at once (16-, 8-, 4- or 1-byte
//     loads, as the row's address allows: the callers pass views of wider
//     planes, whose rows may be only 8-byte aligned) and steps all five
//     entry phases through them: its span's map, 3 bits an entry;
//   - a warp scan (__shfl_up_sync) and a scan of the warps' maps give
//     each thread the composition of the tile's maps before it;
//   - the tile publishes its map at once; its entry phase comes from a
//     decoupled look-back over the row's earlier tiles, 32 status words a
//     step (warp 0), a published entry read as a constant map; a row's
//     first tile enters at phase 0 and needs none;
//   - each thread replays its bytes from its entry phase and writes its
//     kBytes flags with one 16-byte store.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 16;                // region bytes a thread
constexpr int kTile = kThreads * kBytes;  // bytes a block
constexpr uint32_t kFull = 0xFFFFFFFFu;
// A phase map {0..4} -> {0..4}: entry j's image in bits 3j .. 3j + 2.
constexpr uint32_t kIdentity = 0u | 1u << 3 | 2u << 6 | 3u << 9 | 4u << 12;
// A tile's status word: 0 until published, then kAggregate | the tile's
// map, then kPrefix | the phase after the tile.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ uint32_t image(uint32_t map, uint32_t j) {
  return (map >> (3 * j)) & 7u;
}

// a, then b.
__device__ __forceinline__ uint32_t compose(uint32_t a, uint32_t b) {
  uint32_t c = 0u;
#pragma unroll
  for (int j = 0; j < 5; ++j) c |= image(b, image(a, j)) << (3 * j);
  return c;
}

// The map that sends every entry to phase p.
__device__ __forceinline__ uint32_t constant(uint32_t p) {
  return p * (1u | 1u << 3 | 1u << 6 | 1u << 9 | 1u << 12);
}

// The phase after a byte whose phase is 0: its chunk's length - 1.
__device__ __forceinline__ uint32_t step_of(uint32_t tag) {
  return tag == 0xFEu ? 3u : tag == 0xFFu ? 4u : (tag & 0xC0u) == 0x80u ? 1u
                                                                         : 0u;
}

__device__ __forceinline__ uint32_t next_phase(uint32_t phi, uint32_t step) {
  return phi ? phi - 1u : step;
}

// The kBytes bytes at p as four little-endian words, by the widest load
// p's alignment allows.
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t w[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else if ((a & 7) == 0) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 8));
    w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(p + 4 * i));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[i] |= static_cast<uint32_t>(__ldg(p + 4 * i + k)) << (8 * k);
    }
  }
}

// Warp 0: the phase entering tile `me` (status index; the row's first
// tile has index `first` < me), from the maps and phases of the tiles
// before it, nearest first.  Every lane returns it.
__device__ uint32_t look_back(unsigned long long* status, long long me,
                              long long first) {
  const int lane = threadIdx.x & 31;
  uint32_t later = kIdentity;  // the tiles between the step's and me
  for (long long v = me - 1;; v -= 32) {
    const long long idx = v - lane;  // lane 0 the nearest earlier tile
    unsigned long long st = kPrefix;  // before the row: phase 0
    if (idx >= first) {
      while ((st = *reinterpret_cast<volatile unsigned long long*>(
                  status + idx)) == 0)
        __nanosleep(32);
    }
    const uint32_t done = __ballot_sync(kFull, st >= kPrefix);
    const int stop = done ? __ffs(done) - 1 : 31;  // the nearest phase
    uint32_t m = lane > stop       ? kIdentity
                 : st >= kPrefix   ? constant(static_cast<uint32_t>(st) & 7u)
                                   : static_cast<uint32_t>(st) & 0x7FFFu;
    // lane 0 <- lanes 0 .. 31, the higher lane's (earlier) tile first
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t earlier = __shfl_down_sync(kFull, m, d);
      if ((lane & (2 * d - 1)) == 0) m = compose(earlier, m);
    }
    later = compose(__shfl_sync(kFull, m, 0), later);
    if (done) return image(later, 0);  // a constant map
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_starts_kernel(const uint8_t* __restrict__ regions, long long row_stride,
                    uint8_t* __restrict__ out, unsigned long long* status,
                    long long Qb, long long ntiles) {
  __shared__ uint32_t warp_maps[kWarps];  // then each warp's entry phase
  __shared__ unsigned long long ticket;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) ticket = qk::take_ticket(status, gridDim.x);
  __syncthreads();
  const long long me = static_cast<long long>(ticket);
  const long long b = me / ntiles;
  const long long tile = me % ntiles;
  // this thread's bytes: x0 .. x0 + 15, all inside the row or none
  // (Qb % kBytes == 0)
  const long long x0 = tile * kTile + static_cast<long long>(t) * kBytes;
  const bool live = x0 < Qb;

  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (live) load_bytes(regions + b * row_stride + x0, w);
  uint32_t steps[kBytes];
#pragma unroll
  for (int k = 0; k < kBytes; ++k)
    steps[k] = step_of((w[k >> 2] >> (8 * (k & 3))) & 0xFFu);

  // the span's map: every entry phase stepped through the bytes
  uint32_t map = 0u;
#pragma unroll
  for (uint32_t e = 0; e < 5; ++e) {
    uint32_t phi = e;
#pragma unroll
    for (int k = 0; k < kBytes; ++k) phi = next_phase(phi, steps[k]);
    map |= phi << (3 * e);
  }
  if (!live) map = kIdentity;

  // inclusive scan of the warp's maps, then of the warps'
  uint32_t inc = map;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = compose(y, inc);
  }
  if (lane == 31) warp_maps[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t wi = lane < kWarps ? warp_maps[lane] : kIdentity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi = compose(y, wi);
    }
    const uint32_t agg = __shfl_sync(kFull, wi, kWarps - 1);  // the tile's
    const uint32_t before = __shfl_up_sync(kFull, wi, 1);  // warps before
    uint32_t entry = 0u;  // a row enters its first tile at phase 0
    if (tile > 0) {
      if (lane == 0) atomicExch(status + me, kAggregate | agg);
      entry = look_back(status, me, me - tile);
    }
    if (lane == 0) atomicExch(status + me, kPrefix | image(agg, entry));
    if (lane < kWarps) warp_maps[lane] = lane ? image(before, entry) : entry;
  }
  __syncthreads();

  // replay the bytes from the thread's entry phase (a warp may end inside
  // the row: every lane shuffles before the dead ones leave)
  const uint32_t warp_entry = warp_maps[warp];
  const uint32_t mine = __shfl_up_sync(kFull, inc, 1);  // lanes before
  if (!live) return;
  uint32_t phi = lane ? image(mine, warp_entry) : warp_entry;
  uint32_t f[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    f[k >> 2] |= static_cast<uint32_t>(phi == 0u) << (8 * (k & 3));
    phi = next_phase(phi, steps[k]);
  }
  *reinterpret_cast<uint4*>(out + b * Qb + x0) =
      make_uint4(f[0], f[1], f[2], f[3]);
}

}  // namespace

// Bytes a block.  The wrapper sizes the status words from the tile, so
// the tile has this one owner.
QK_API int qk_chunk_starts_tile() { return kTile; }

// regions (B, Qb) uint8, rows row_stride bytes apart, unit column stride
// -> out (B, Qb) 0/1 bytes, contiguous and 16-byte aligned; status:
// nstatus zeroed 64-bit words, at least B * ceil(Qb / qk_chunk_starts_tile())
// + 1 (one per tile, then the ticket counter).  Qb % 16 == 0.
QK_API int qk_chunk_starts(const void* regions, long long row_stride,
                           void* out, void* status, long long nstatus, int B,
                           long long Qb, void* stream) {
  if (B < 1 || Qb < 1 || Qb % kBytes ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (Qb + kTile - 1) / kTile;
  if (nstatus < B * ntiles + 1 || B * ntiles >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  chunk_starts_kernel<<<static_cast<unsigned>(B * ntiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(regions), row_stride,
      static_cast<uint8_t*>(out), static_cast<unsigned long long*>(status), Qb,
      ntiles);
  return qk::launch_status();
}
