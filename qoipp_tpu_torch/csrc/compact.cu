// K3: stable stream compaction of the encoder's chunk rows, in one pass
// that counts its own kept rows.
//
// Replaces qoipp_tpu/ops/compact_kernel.py: compact_rows (the Pallas body
// _compact_kernel and the running count the JAX package takes around it).
//
// out[p][b, g] = plane[p][b, r] for every kept row r, where g is the number
// of kept rows before r in lane b; counts[b] is the lane's number of kept
// rows, also where it exceeds cap.  A row whose g reaches cap is dropped,
// so an overflowing lane never writes out of bounds (the encoder flags it
// through `ok`).  Rows at or past a lane's count are left unwritten
// (unspecified, as in the JAX package).
//
// What bounds it on the card: bytes -- keep read once (one byte a row),
// each kept row's plane values read and written once (8 bytes a plane),
// counts written.  The TPU needed one-hot MXU products because its scatter
// was serial, and took the running count from a separate scan; Hopper
// scatters natively and a decoupled look-back gives the count in the
// same pass.
// What the design does:
//   - one block of kThreads per tile of kTile rows of one lane, in the
//     order of an atomic ticket, so a block only ever waits on tiles that
//     are already running;
//   - each thread takes kRowsPer consecutive keep bytes (one 16-byte load
//     where the row is aligned), counts them with __popc, and a warp and a
//     block exclusive scan give each kept row its place in the tile;
//   - the tile's count is published at once; its place in the lane comes
//     from a decoupled look-back over the lane's earlier tiles, 32 status
//     words a step (warp 0), while the other warps already gather;
//   - each warp gathers the kept values of its 512 rows, a plane at a
//     time, into shared memory in their compacted order with coalesced
//     16-byte loads, skipping every 16-byte group without a kept row; the
//     block then writes the tile's range [prefix, prefix + count) with
//     coalesced stores;
//   - the lane's last tile writes counts[b].
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPer = 16;                // keep bytes a thread
constexpr int kTile = kThreads * kRowsPer;  // rows a block
constexpr int kMaxPlanes = 4;
constexpr uint32_t kFull = 0xFFFFFFFFu;
// A tile's status word: 0 until published, then kAggregate | the tile's
// kept rows, then kPrefix | the lane's kept rows up to the tile's end.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

struct Shared {
  uint32_t val[kTile];  // one plane's kept values of the tile, compacted
  int warp_base[kWarps];
  unsigned long long ticket;
  int count;          // the tile's kept rows
  long long prefix;   // the lane's kept rows before the tile
};

// Bits of the 16 keep bytes of rows [r, r + 16) of a lane of N rows.
__device__ __forceinline__ uint32_t keep_bits(const uint8_t* k, long long r,
                                              long long N) {
  uint32_t m = 0;
  if (r + kRowsPer <= N && (reinterpret_cast<uintptr_t>(k) & 15) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(k);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j)
      if ((w[j >> 2] >> (8 * (j & 3))) & 0xFFu) m |= 1u << j;
  } else {
    for (int j = 0; j < kRowsPer && r + j < N; ++j)
      if (k[j]) m |= 1u << j;
  }
  return m;
}

// Warp 0: the lane's kept rows before tile `me` (status index; the lane's
// first tile has index `first`), after publishing the tile's own count.
// Publishes the tile's inclusive prefix and returns the exclusive one.
__device__ long long look_back(unsigned long long* status, long long me,
                               long long first, int count) {
  const int lane = threadIdx.x & 31;
  if (me == first) {
    if (lane == 0) atomicExch(status + me, kPrefix | uint32_t(count));
    return 0;
  }
  if (lane == 0) atomicExch(status + me, kAggregate | uint32_t(count));
  long long prefix = 0;
  for (long long v = me - 1;; v -= 32) {
    const long long idx = v - lane;  // lane 0 the nearest earlier tile
    unsigned long long st = kPrefix;  // before the lane's first tile: 0
    if (idx >= first) {
      while ((st = *reinterpret_cast<volatile unsigned long long*>(
                  status + idx)) == 0)
        __nanosleep(32);
    }
    const uint32_t done = __ballot_sync(kFull, st >= kPrefix);
    const int stop = done ? __ffs(done) - 1 : 31;  // the nearest prefix
    uint32_t x = lane <= stop ? static_cast<uint32_t>(st) : 0u;
#pragma unroll
    for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
    prefix += x;
    if (done) break;
  }
  if (lane == 0)
    atomicExch(status + me, kPrefix | uint32_t(prefix + count));
  return prefix;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ keep, unsigned long long* status,
               Planes planes, int nplanes, int32_t* __restrict__ counts,
               long long N, long long cap, long long ntiles) {
  __shared__ Shared s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s.ticket = qk::take_ticket(status, gridDim.x);
  __syncthreads();
  const long long me = static_cast<long long>(s.ticket);
  const long long b = me / ntiles;
  const long long tile0 = (me % ntiles) * kTile;  // the tile's first row
  const long long lane0 = b * N;                  // the lane's first index

  // the tile's scan: this thread's rows tile0 + 16 t .. + 15
  const long long r = tile0 + static_cast<long long>(t) * kRowsPer;
  const uint32_t mask = r < N ? keep_bits(keep + lane0 + r, r, N) : 0u;
  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s.warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int ws = lane < kWarps ? s.warp_base[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < kWarps) s.warp_base[lane] = wi - ws;
    if (lane == kWarps - 1) s.count = wi;
  }
  __syncthreads();
  const int local = s.warp_base[warp] + incl - cnt;  // row r's place
  const int count = s.count;

  if (warp == 0) {
    const long long prefix = look_back(status, me, b * ntiles, count);
    if (lane == 0) {
      s.prefix = prefix;
      if (me % ntiles == ntiles - 1)
        counts[b] = static_cast<int32_t>(prefix + count);
    }
  }

  // the warp's rows are its own threads' rows: 128 a step, 4 a thread
  const long long wrow = tile0 + static_cast<long long>(warp) * 32 * kRowsPer;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {  // unrolled: no dynamic index
    if (p >= nplanes) break;
    const uint32_t* in = planes.in[p] + lane0 + wrow;
    const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = 8 * q + (lane >> 2);  // the thread that scanned them
      const uint32_t m = __shfl_sync(kFull, mask, src);
      const int base = __shfl_sync(kFull, local, src);
      const int sub = 4 * (lane & 3);
      const uint32_t m4 = (m >> sub) & 0xFu;
      if (!m4) continue;
      int k = base + __popc(m & ((1u << sub) - 1));
      const int j0 = 128 * q + 4 * lane;  // the rows' offset in the warp
      uint32_t v[4];
      if (vec && wrow + j0 + 4 <= N) {
        const uint4 x = *reinterpret_cast<const uint4*>(in + j0);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (m4 >> i) & 1 ? in[j0 + i] : 0u;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((m4 >> i) & 1) s.val[k++] = v[i];
    }
    __syncthreads();
    const long long prefix = s.prefix;
    const long long n_out = min(static_cast<long long>(count), cap - prefix);
    uint32_t* out = planes.out[p] + b * cap + prefix;
    for (int i = t; i < n_out; i += kThreads) out[i] = s.val[i];
    if (n_out <= 0) break;  // every later plane drops the tile too
    __syncthreads();
  }
}

}  // namespace

// Rows and threads a block.  The wrapper sizes the status words from the
// tile, so the tile has this one owner.
QK_API int qk_compact_tile() { return kTile; }
QK_API int qk_compact_threads() { return kThreads; }

// keep (B, N) bool, in_p (B, N) -> out_p (B, cap), for p < nplanes <= 4
// (unused plane pointers may be null), counts (B,) int32; status: nstatus
// zeroed 64-bit words, at least B * ceil(N / qk_compact_tile()) + 1 (one
// per tile, then the ticket counter).  N < 2^31.
QK_API int qk_compact(const void* keep, void* status, long long nstatus,
                      int nplanes, const void* in0, const void* in1,
                      const void* in2, const void* in3, void* out0,
                      void* out1, void* out2, void* out3, void* counts, int B,
                      long long N, long long cap, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || B < 1 || N < 1 ||
      N >= (1ll << 31) || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ntiles = (N + kTile - 1) / kTile;
  if (nstatus < B * ntiles + 1)  // the ticket would land past the words
    return static_cast<int>(cudaErrorInvalidValue);
  Planes planes{{static_cast<const uint32_t*>(in0),
                 static_cast<const uint32_t*>(in1),
                 static_cast<const uint32_t*>(in2),
                 static_cast<const uint32_t*>(in3)},
                {static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
                 static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3)}};
  compact_kernel<<<static_cast<unsigned>(B * ntiles), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep),
      static_cast<unsigned long long*>(status), planes, nplanes,
      static_cast<int32_t*>(counts), N, cap, ntiles);
  return qk::launch_status();
}
