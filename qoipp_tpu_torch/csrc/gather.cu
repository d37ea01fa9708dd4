// G1, the pixel gather: a decode's pixel-word planes -> each stream's raw
// channel bytes, back to back in one flat buffer.
//
// Replaces no Pallas kernel: the JAX package fetches its packed and split
// engines' whole (L, n_cap) word planes and cuts and unpacks each stream
// on the host (qoipp_tpu/models/packed.py: _unpack_pixels_np).  Added
// because that fetch moves every padded slot and empty lane, about 12.7
// bytes a delivered pixel on the committed serving corpus, and the host's
// shifts and masks ran on one thread after it.  Here the card writes
// exactly the bytes the caller gets, so the host fetches them in one copy
// and only slices.
//
// A segment is a run of n pixel words at src[s, s + n) that lands at
// out[dst, dst + n * c): each word r | g<<8 | b<<16 | a<<24 gives its low c
// bytes (c = 4 for RGBA, 3 for RGB).  A packed stream is one segment; a
// split stream is one segment a lane.  Segments start at any word and any
// byte: streams pack back to back in a lane, and a split segment lands at
// its first pixel's place in its stream.
//
// What bounds it on the card: bytes -- each word read once and each output
// byte written once, (4 + c) bytes a pixel at 3.35 TB/s.
// What the design does:
//   - the segment table holds each segment's first tile; a block takes one
//     tile of tile_groups groups (the wrapper's TILE_PX / 4) and finds its
//     segment by a binary search over the table's first tiles (a few
//     hundred rows at most);
//   - a group is 4 words from a multiple of 4, so every thread makes one
//     16-byte load, neighbouring threads on neighbouring addresses; the
//     first group of a segment may start before it, and the last may end
//     after it;
//   - a group's 4c output bytes are packed in registers (RGB: 4 words into
//     3) and stored 16 bytes at once where the address allows, else as
//     4-byte words (after 1-3 head bytes, funnel-shifted into place) and
//     tail bytes; the first and last groups of a segment store byte by
//     byte only the bytes inside it.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 5;  // int64 columns of a segment row

// Bytes [kb, ke) of the little-endian byte stream v (nbytes = 12 or 16
// bytes long) at out + base + k.
__device__ __forceinline__ void store_group(uint8_t* __restrict__ out,
                                            long long base,
                                            const uint32_t v[4], int kb,
                                            int ke, int nbytes) {
  if (kb == 0 && ke == nbytes) {
    uint8_t* d = out + base;
    const uint32_t a = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(d));
    const int words = nbytes >> 2;  // 3 or 4
    if (nbytes == 16 && (a & 15u) == 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
      return;
    }
    if ((a & 3u) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < words) reinterpret_cast<uint32_t*>(d)[j] = v[j];
      return;
    }
    // h head bytes up to a 4-byte boundary, words - 1 whole words, then
    // the last word's bytes h .. 3
    const int h = 4 - static_cast<int>(a & 3u);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k < h) d[k] = static_cast<uint8_t>(v[0] >> (8 * k));
    uint32_t* dw = reinterpret_cast<uint32_t*>(d + h);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < words - 1) dw[j] = __funnelshift_r(v[j], v[j + 1], 8 * h);
    const uint32_t last = words == 4 ? v[3] : v[2];
    uint8_t* dt = d + nbytes - 4;
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if (k >= h) dt[k] = static_cast<uint8_t>(last >> (8 * k));
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k >= kb && k < ke)
      out[base + k] = static_cast<uint8_t>(v[k >> 2] >> (8 * (k & 3)));
}

__global__ void __launch_bounds__(kThreads)
gather_pixels_kernel(const uint32_t* __restrict__ src, long long n_words,
                     const long long* __restrict__ table, int nseg,
                     int tile_groups, uint8_t* __restrict__ out,
                     long long out_bytes) {
  const long long tile = blockIdx.x;
  // the segment: the last row whose first tile is at or before this one
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + kCols * mid + 4) <= tile) lo = mid;
    else hi = mid - 1;
  }
  const long long* row = table + kCols * lo;
  const long long s = __ldg(row), n = __ldg(row + 1), dst = __ldg(row + 2);
  const int c = static_cast<int>(__ldg(row + 3));
  const long long first = __ldg(row + 4);
  // a row the wrapper would refuse writes nothing
  if ((c != 3 && c != 4) || s < 0 || n < 1 || s + n > n_words || dst < 0 ||
      dst + n * c > out_bytes)
    return;
  const long long a0 = s & ~3ll;  // the first group's first word
  const long long groups = (s - a0 + n + 3) >> 2;
  const long long g0 = (tile - first) * tile_groups;
  const long long g1 = min(groups, g0 + tile_groups);
  const int nbytes = 4 * c;
  for (long long g = g0 + threadIdx.x; g < g1; g += kThreads) {
    const long long w0 = a0 + 4 * g;
    uint32_t w[4];
    if (w0 + 4 <= n_words) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + w0));
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = w0 + j < n_words ? __ldg(src + w0 + j) : 0u;
    }
    const long long p = w0 - s;  // w[0]'s pixel in the segment (< 0: before)
    const int kb = p < 0 ? static_cast<int>(-p) * c : 0;
    const int ke = static_cast<int>(min(4ll, n - p)) * c;
    uint32_t v[4];
    if (c == 4) {
      v[0] = w[0], v[1] = w[1], v[2] = w[2], v[3] = w[3];
    } else {  // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
      v[0] = (w[0] & 0xFFFFFFu) | (w[1] << 24);
      v[1] = ((w[1] >> 8) & 0xFFFFu) | (w[2] << 16);
      v[2] = ((w[2] >> 16) & 0xFFu) | (w[3] << 8);
      v[3] = 0u;
    }
    store_group(out, dst + p * c, v, kb, ke, nbytes);
  }
}

}  // namespace

// src: n_words pixel words, 16-byte aligned; table: nseg rows of kCols
// int64 (first source word, pixels, first output byte, channels, first
// tile), the first tiles rising from 0 and each segment's tiles
// ceil((s % 4 + n) / (4 * tile_groups)); ntiles: the segments' tiles in
// all.  Writes each segment's bytes into out (out_bytes bytes) and no
// other byte.
QK_API int qk_gather_pixels(const void* src, long long n_words,
                            const void* table, int nseg, int tile_groups,
                            long long ntiles, void* out, long long out_bytes,
                            void* stream) {
  if (nseg < 1 || tile_groups < 1 || ntiles < 1 || ntiles >= (1ll << 31) ||
      n_words < 1 || out_bytes < 1 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(table) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_pixels_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), n_words,
      static_cast<const long long*>(table), nseg, tile_groups,
      static_cast<uint8_t*>(out), out_bytes);
  return qk::launch_status();
}
