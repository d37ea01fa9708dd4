// E1: the encoder's per-pixel field pass, with the encoder state carried
// into each row.
//
// Replaces benchmarks/fields_kernel.py: encode_fields_planes (the Pallas
// body _fields_kernel), which computes ops/encode._encode_fields of the JAX
// package on 2048-pixel blocks: run streaks with the RUN-62 flush, the
// same-hash table lookup, op selection and the 6-byte templates, packed as
// tlo = bytes 0-3 and thn = bytes 4-5 | byte count << 16, plus the run
// counter after each 2048-pixel block.  Here each row also takes its own
// pixel count and carried state (prev, run 0..61, 64-slot table) and gives
// back the table after its last valid pixel: a streaming window's state.
//
// What bounds it on the card: memory traffic in principle (4 bytes read
// and 8 written per pixel), but a row is one dependency chain through its
// state, and a block walking a row's tiles in order spends each tile on
// the latency of its three barriers, so a row must spread over many SMs
// (the stream encoder's windows are one row each).
// What the design does: each row is cut into segments of whole tiles, so
// that the grid holds about two blocks per SM (fields_kernel.segments);
// the state entering a segment has a closed form:
//   - prev pixel and whether it repeated its own predecessor: the input
//     pixels just before the segment (prev_in, run_in at the row start);
//   - the last differing position: the largest over earlier segments, or
//     -(run_in + 1) if there is none;
//   - the table: per slot, the pixel at the last differing position of
//     that hash in earlier segments, else seen_in.
// Pixels at or past n_px are not differing, so they touch no state.
// Two launches, deterministic, no block waits on another:
//   1. fields_summary_kernel: each segment but a row's last writes its
//      last differing position and its 64 slots' last writers (position
//      + 1, 0 for none);
//   2. fields_kernel: each block folds the summaries of the segments
//      before its own (a max over them, 16 threads a slot), reads the
//      pixels those positions name, and walks its segment in tiles of one
//      pixel per thread, carrying (prev pixel, last differing position,
//      repeat flag, table) between tiles in shared memory.  Inside a tile:
//   - run streaks: a warp max-scan (__shfl_up_sync) of the last differing
//     position, combined across the 32 warps by one warp's scan;
//   - the same-hash predecessor: __match_any_sync(hash) AND the ballot of
//     differing pixels AND the lanes below, highest set bit, one shuffle;
//   - the table entering each warp: every warp's 64-slot last-writer
//     summary, combined by an exclusive overwrite walk of 64 threads (one
//     per slot) over the warps, which also carries the table on;
//   - op selection and templates per pixel, coalesced stores.
// The next tile's pixels are loaded while the current tile is coded.  A
// row's last segment holds its last pixel and writes the table out.
#include <climits>

#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 1024;  // pixels per tile, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRunBlock = 2048;  // pixels per run_out entry
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kSumCols = 65;  // per segment: 64 slots' last writers, then
                              // the last differing position, each + 1
constexpr int kStripes = kThreads / 64;  // fold threads a slot
constexpr int kSumThreads = 256;

static_assert(kThreads % kSumThreads == 0, "segments are whole tiles");

static_assert(kWarps == 32, "the cross-warp scan runs in one warp");

__device__ __forceinline__ int chan(uint32_t p, int c) {
  return static_cast<int>((p >> (8 * c)) & 0xFFu);
}

// the low byte as a signed value (the reference's i8 narrowing)
__device__ __forceinline__ int i8(int x) { return ((x & 0xFF) ^ 0x80) - 0x80; }

struct Shared {
  uint32_t px[kThreads];
  // per warp: the word of the warp's last writer of each slot; after the
  // walk, the table entering the warp
  uint32_t slot_val[kWarps][64];
  uint8_t slot_set[kWarps][64];
  uint32_t table[64];        // the table entering the tile
  int warp_max[kWarps];      // last differing position in each warp
  int warp_enter[kWarps];    // last differing position before each warp
  int fold[kStripes][64];    // the fold's partial maxima
  uint32_t prev;             // the pixel before the tile
  int last_diff;             // last differing position before the tile
  int eq_last;               // the pixel before the tile repeated its own
};

// Segment blockIdx.y of row blockIdx.x, seg_px pixels from s0: the last
// differing valid position and each slot's last differing valid pixel,
// + 1 (0 for none), into summary[(row * (nseg - 1) + segment) * kSumCols].
__global__ void __launch_bounds__(kSumThreads)
fields_summary_kernel(const uint32_t* __restrict__ packed,
                      const int32_t* __restrict__ n_px,
                      const uint32_t* __restrict__ prev_in,
                      int32_t* __restrict__ summary, int Nb, int seg_px) {
  __shared__ int last[kSumCols];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long row = static_cast<long long>(b) * Nb;
  const int npx = min(max(n_px[b], 0), Nb);
  const int s0 = blockIdx.y * seg_px;
  if (t < kSumCols) last[t] = 0;
  __syncthreads();
  int diff = 0;
  // seg_px is a multiple of the block: every lane runs every step
  for (int p = s0 + t; p < s0 + seg_px; p += kSumThreads) {
    const uint32_t px = packed[row + p];
    const uint32_t prev = p ? packed[row + p - 1] : prev_in[b];
    const bool noneq = p < npx && px != prev;
    const uint32_t h = qk::hash6(px);
    const uint32_t writers = __match_any_sync(kFull, h) &
                             __ballot_sync(kFull, noneq);
    if (noneq && (writers >> lane) == 1u) atomicMax(&last[h], p + 1);
    if (noneq) diff = p + 1;
  }
  diff = __reduce_max_sync(kFull, diff);
  if (lane == 0 && diff) atomicMax(&last[64], diff);
  __syncthreads();
  if (t < kSumCols)
    summary[(static_cast<long long>(b) * (gridDim.y) + blockIdx.y) *
            kSumCols + t] = last[t];
}

__global__ void __launch_bounds__(kThreads)
fields_kernel(const uint32_t* __restrict__ packed,
              const int32_t* __restrict__ n_px,
              const uint32_t* __restrict__ prev_in,
              const int32_t* __restrict__ run_in,
              const uint32_t* __restrict__ seen_in, uint32_t* __restrict__ tlo,
              uint32_t* __restrict__ thn, int32_t* __restrict__ run_out,
              uint32_t* __restrict__ seen_out,
              const int32_t* __restrict__ summary, int B, int Nb,
              int channels, int seg_px) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const int seg = blockIdx.y;
  const int s0 = seg * seg_px;
  const int s1 = min(Nb, s0 + seg_px);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = static_cast<long long>(b) * Nb;
  const int npx = min(max(n_px[b], 0), Nb);
  const int nblk = (Nb + kRunBlock - 1) / kRunBlock;

  // the state entering the segment
  const int run0 = run_in[b];
  if (seg == 0) {
    if (t < 64) sh.table[t] = seen_in[static_cast<long long>(t) * B + b];
    if (t == 0) {
      // the carried run is a streak of run0 equal pixels before position 0
      sh.prev = prev_in[b];
      sh.last_diff = -(run0 + 1);
      sh.eq_last = run0 > 0;
    }
  } else {
    // the summaries of segments 0 .. seg - 1: per column, the largest
    const int32_t* sum =
        summary + static_cast<long long>(b) * (gridDim.y - 1) * kSumCols;
    int m = 0;
    for (int j = warp >> 1; j < seg; j += kStripes)
      m = max(m, sum[j * kSumCols + (t & 63)]);
    sh.fold[warp >> 1][t & 63] = m;
    if (warp == 0) {
      int d = 0;
      for (int j = lane; j < seg; j += 32) d = max(d, sum[j * kSumCols + 64]);
      d = __reduce_max_sync(kFull, d);
      if (lane == 0) {
        sh.last_diff = d ? d - 1 : -(run0 + 1);
        sh.prev = packed[row + s0 - 1];
        // a segment starts at a multiple of the tile, so s0 >= 2
        sh.eq_last = packed[row + s0 - 1] == packed[row + s0 - 2];
      }
    }
    __syncthreads();
    if (t < 64) {
      int w = 0;
      for (int i = 0; i < kStripes; ++i) w = max(w, sh.fold[i][t]);
      sh.table[t] = w ? packed[row + w - 1]
                      : seen_in[static_cast<long long>(t) * B + b];
    }
  }
  if (t < 64)
    for (int w = 0; w < kWarps; ++w) sh.slot_set[w][t] = 0;
  uint32_t next = s0 + t < s1 ? packed[row + s0 + t] : 0u;

  for (int base = s0; base < s1; base += kThreads) {
    const int p = base + t;
    const bool in_row = p < s1;
    const uint32_t px = next;
    if (p + kThreads < s1) next = packed[row + p + kThreads];
    sh.px[t] = px;
    __syncthreads();  // (1) the tile's pixels and the carry are in place

    const uint32_t prev = t ? sh.px[t - 1] : sh.prev;
    const bool eq = px == prev;
    const bool valid = p < npx;
    const bool noneq = valid && !eq;
    const bool eq_prev = t >= 2   ? sh.px[t - 1] == sh.px[t - 2]
                         : t == 1 ? sh.px[0] == sh.prev
                                  : sh.eq_last != 0;

    // last differing position at or before p, inside the warp
    int m = noneq ? p : INT_MIN;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, m, d);
      if (lane >= d) m = max(m, o);
    }
    int m_before = __shfl_up_sync(kFull, m, 1);
    if (lane == 0) m_before = INT_MIN;
    if (lane == 31) sh.warp_max[warp] = m;

    // the same-hash predecessor inside the warp, and the warp's last writer
    // of each slot
    const uint32_t h = qk::hash6(px);
    const uint32_t writers = __match_any_sync(kFull, h) &
                             __ballot_sync(kFull, noneq);
    const uint32_t below = writers & ((1u << lane) - 1u);
    const uint32_t local = __shfl_sync(kFull, px, below ? 31 - __clz(below)
                                                        : lane);
    if (noneq && (writers >> lane) == 1u) {
      sh.slot_val[warp][h] = px;
      sh.slot_set[warp][h] = 1;
    }
    __syncthreads();  // (2) warp summaries written

    if (t < 64) {
      // exclusive overwrite walk of slot t over the warps
      uint32_t cur = sh.table[t];
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t v = sh.slot_val[w][t];
        const bool set = sh.slot_set[w][t] != 0;
        sh.slot_val[w][t] = cur;
        sh.slot_set[w][t] = 0;
        if (set) cur = v;
      }
      sh.table[t] = cur;
    } else if (warp == 2) {
      const int carried = sh.last_diff;
      int wm = sh.warp_max[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, wm, d);
        if (lane >= d) wm = max(wm, o);
      }
      int ex = __shfl_up_sync(kFull, wm, 1);
      if (lane == 0) ex = INT_MIN;
      sh.warp_enter[lane] = max(ex, carried);
      __syncwarp();
      if (lane == 31) sh.last_diff = max(wm, carried);
    }
    __syncthreads();  // (3) tables entering each warp, scan carries

    const int enter = sh.warp_enter[warp];
    const int cnt = p - max(m, enter);  // the run counter after p
    const int cnt_prev = p - 1 - max(m_before, enter);
    const bool hit62 = eq && valid && cnt % 62 == 0;
    const int pend = eq_prev ? cnt_prev % 62 : 0;  // pending run before p
    const bool flush = noneq && pend > 0;
    const uint32_t table_val = below ? local : sh.slot_val[warp][h];

    const bool is_index = noneq && table_val == px;
    const bool is_rgba =
        channels == 4 && noneq && !is_index && chan(px, 3) != chan(prev, 3);
    const int dr = i8(chan(px, 0) - chan(prev, 0));
    const int dg = i8(chan(px, 1) - chan(prev, 1));
    const int db = i8(chan(px, 2) - chan(prev, 2));
    const int dr_dg = i8(dr - dg);
    const int db_dg = i8(db - dg);
    const bool in_diff = dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 &&
                         db >= -2 && db <= 1;
    const bool in_luma = dg >= -32 && dg <= 31 && dr_dg >= -8 && dr_dg <= 7 &&
                         db_dg >= -8 && db_dg <= 7;
    const bool rest = noneq && !is_index && !is_rgba;
    uint32_t o[5] = {0u, 0u, 0u, 0u, 0u};
    int own = 0;
    if (is_index) {
      o[0] = h;
      own = 1;
    } else if (is_rgba || (rest && !in_diff && !in_luma)) {
      o[0] = is_rgba ? 0xFFu : 0xFEu;
      o[1] = chan(px, 0);
      o[2] = chan(px, 1);
      o[3] = chan(px, 2);
      o[4] = is_rgba ? chan(px, 3) : 0u;
      own = is_rgba ? 5 : 4;
    } else if (rest && in_diff) {
      o[0] = 0x40u | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2);
      own = 1;
    } else if (rest) {
      o[0] = 0x80u | (dg + 32);
      o[1] = ((dr_dg + 8) << 4) | (db_dg + 8);
      own = 2;
    }
    const bool has_run = hit62 || flush;
    const uint32_t run_byte = hit62 ? 0xC0u | 61u : 0xC0u | ((pend - 1) & 0x3F);
    uint32_t lo, hi;
    if (has_run) {
      lo = run_byte | (o[0] << 8) | (o[1] << 16) | (o[2] << 24);
      hi = o[3] | (o[4] << 8);
    } else {
      lo = o[0] | (o[1] << 8) | (o[2] << 16) | (o[3] << 24);
      hi = o[4];
    }
    const uint32_t nbytes = static_cast<uint32_t>(own + (has_run ? 1 : 0));
    if (in_row) {
      tlo[row + p] = lo;
      thn[row + p] = hi | (nbytes << 16);
      // the run counter after each 2048-pixel block's last valid pixel
      const int k = p / kRunBlock;
      const int last = min(npx, (k + 1) * kRunBlock) - 1;
      if (p == last)
        run_out[static_cast<long long>(b) * nblk + k] = eq ? cnt % 62 : 0;
      else if (last < k * kRunBlock && p == k * kRunBlock)
        run_out[static_cast<long long>(b) * nblk + k] = 0;
    }
    if (t == kThreads - 1) {  // read only after the next tile's barrier (1)
      sh.prev = px;
      sh.eq_last = eq;
    }
  }
  if (t < 64 && seg == static_cast<int>(gridDim.y) - 1)
    seen_out[static_cast<long long>(t) * B + b] = sh.table[t];
}

}  // namespace

// packed (B, Nb), n_px (B,), prev_in (B,), run_in (B,), seen_in (64, B)
// -> tlo, thn (B, Nb), run_out (B, ceil(Nb / 2048)), seen_out (64, B);
// all 32-bit.  Rows are cut into segments of seg_tiles tiles of 1024
// pixels; summary is scratch of B * (segments - 1) * 65 words.
QK_API int qk_fields(const void* packed, const void* n_px, const void* prev_in,
                     const void* run_in, const void* seen_in, void* tlo,
                     void* thn, void* run_out, void* seen_out, void* summary,
                     int B, long long Nb, int channels, int seg_tiles,
                     void* stream) {
  if (B < 1 || Nb < 1 || Nb > INT_MAX - 2 * kThreads || seg_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long seg_px = static_cast<long long>(seg_tiles) * kThreads;
  const long long nseg = (Nb + seg_px - 1) / seg_px;
  if (seg_px > Nb + kThreads || nseg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nseg > 1) {
    fields_summary_kernel<<<dim3(B, nseg - 1), kSumThreads, 0, st>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const int32_t*>(n_px),
        static_cast<const uint32_t*>(prev_in), static_cast<int32_t*>(summary),
        static_cast<int>(Nb), static_cast<int>(seg_px));
    const int rc = qk::launch_status();
    if (rc) return rc;
  }
  fields_kernel<<<dim3(B, nseg), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(n_px),
      static_cast<const uint32_t*>(prev_in),
      static_cast<const int32_t*>(run_in),
      static_cast<const uint32_t*>(seen_in), static_cast<uint32_t*>(tlo),
      static_cast<uint32_t*>(thn), static_cast<int32_t*>(run_out),
      static_cast<uint32_t*>(seen_out), static_cast<const int32_t*>(summary),
      B, static_cast<int>(Nb), channels, static_cast<int>(seg_px));
  return qk::launch_status();
}
