// E7: byte emission over lanes-wide candidate slabs, one block per window.
//
// Replaces the Pallas kernel of the TPU layout experiment
// benchmarks/expt_emit_wide.py: emit_wide (make_wide_kernel), which asked
// whether visiting two or four 128-row slabs at once cut K4's per-visit
// cost.  It computes K4's function (ops/emit_kernel.py): row r of the
// compacted chunk stream writes min(off[r+1] - off[r], 6) bytes of its
// template (tlo bytes 0-3, thn bytes 4-5) at off[r] (off[C] := out_cap +
// 8192), bytes at or past out_cap are dropped, and every other byte is 0.
// The output is one int32 per byte, as the TPU kernel's.
//
// One block per 8192-byte window w of an image.  Its candidate rows are the
// kLanes-row slabs base[w] .. base[w + 1], both included (base from
// window_base_rows_w); the kernel stages kLanes of them per step into
// shared memory with their look-ahead off, writes their bytes into the
// window in shared memory, and stores the window once, coalesced.  It
// visits every candidate slab: the TPU kernel stopped after lenr of them,
// which drops the covering row of a long run of equal offs.
//
// The carry (h0, h1, h2, d), a grid-ordered scalar on the TPU, needs no
// look-back here: a row writes at most 6 bytes, so bytes from before the
// window come from the one row before the first staged row.  That row has
// the largest off of the rows before it; if it does not cover (its next
// off is equal) a staged row with the same off does.
//
// What bounds it on the card: bytes — 12 read per row, 4 written per
// output byte; at its script's size (8 images of 2^17 rows, 344,064
// bytes each) that is 24 MB, 7 us, and the launch is one wave of 344
// blocks.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kWin = 8192;            // bytes per window
constexpr long long kPastEnd = 8192;  // off[C] = out_cap + kPastEnd
constexpr int kThreads = 512;

// Write row (o, nxt, lo, hn)'s bytes that fall in window w0 .. w0 + kWin
// and below out_cap.
__device__ __forceinline__ void put_row(uint8_t* win, long long w0,
                                        long long out_cap, long long o,
                                        long long nxt, uint32_t lo,
                                        uint32_t hn) {
  const long long n = min(nxt - o, 6LL);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const long long pos = o + k;
    if (k < n && pos >= w0 && pos < w0 + kWin && pos < out_cap)
      win[pos - w0] = static_cast<uint8_t>(k < 4 ? lo >> (8 * k)
                                                 : hn >> (8 * (k - 4)));
  }
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
emit_window_kernel(const int32_t* __restrict__ off,
                   const uint32_t* __restrict__ tlo,
                   const uint32_t* __restrict__ thn,
                   const int32_t* __restrict__ base, int32_t* __restrict__ out,
                   long long C, long long out_cap) {
  __shared__ __align__(16) uint8_t win[kWin];
  __shared__ int32_t soff[kLanes + 1];
  __shared__ uint32_t slo[kLanes], shn[kLanes];
  const long long w = blockIdx.x, b = blockIdx.y;
  const long long nwin = out_cap / kWin;
  const long long w0 = w * kWin;
  const long long pad = out_cap + kPastEnd;
  const int32_t* orow = off + b * C;
  const uint32_t* lrow = tlo + b * C;
  const uint32_t* hrow = thn + b * C;
  const int32_t* brow = base + b * (nwin + 1);
  for (int i = threadIdx.x; i < kWin / 16; i += kThreads)
    reinterpret_cast<uint4*>(win)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const long long lo = static_cast<long long>(brow[w]) * kLanes;
  const long long hi = min((static_cast<long long>(brow[w + 1]) + 1) * kLanes,
                           C);
  if (threadIdx.x == 0 && lo >= 1 && lo <= C)  // the row before the first
    put_row(win, w0, out_cap, orow[lo - 1], lo < C ? orow[lo] : pad,
            lrow[lo - 1], hrow[lo - 1]);
  for (long long r0 = lo; r0 < hi; r0 += kLanes) {
    const int i = threadIdx.x;
    if (i < kLanes) {
      const long long r = r0 + i;
      soff[i] = r < C ? orow[r] : static_cast<int32_t>(pad);
      slo[i] = r < C ? lrow[r] : 0u;
      shn[i] = r < C ? hrow[r] : 0u;
    }
    if (i == 0)
      soff[kLanes] = r0 + kLanes < C ? orow[r0 + kLanes]
                                     : static_cast<int32_t>(pad);
    __syncthreads();
    if (i < kLanes && r0 + i < hi)
      put_row(win, w0, out_cap, soff[i], soff[i + 1], slo[i], shn[i]);
    __syncthreads();
  }
  __syncthreads();  // the row before, where no row was staged
  int4* dst = reinterpret_cast<int4*>(out + b * out_cap + w0);
  const uchar4* src = reinterpret_cast<const uchar4*>(win);
  for (int i = threadIdx.x; i < kWin / 4; i += kThreads) {
    const uchar4 c = src[i];
    dst[i] = make_int4(c.x, c.y, c.z, c.w);
  }
}

template <int kLanes>
int run(int B, long long C, long long out_cap, cudaStream_t stream,
        const void* off, const void* tlo, const void* thn, const void* base,
        void* out) {
  const dim3 grid(static_cast<unsigned>(out_cap / kWin), B);
  emit_window_kernel<kLanes><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(off), static_cast<const uint32_t*>(tlo),
      static_cast<const uint32_t*>(thn), static_cast<const int32_t*>(base),
      static_cast<int32_t*>(out), C, out_cap);
  return qk::launch_status();
}

}  // namespace

// off (B, C) int32 nondecreasing, tlo/thn (B, C) uint32, base (B,
// out_cap/8192 + 1) int32 from window_base_rows_w(off, out_cap, lanes) ->
// out (B, out_cap) int32 bytes; out_cap % 8192 == 0, lanes 128/256/512.
QK_API int qk_emit_window(const void* off, const void* tlo, const void* thn,
                          const void* base, void* out, int B, long long C,
                          long long out_cap, int lanes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_cap % kWin) return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 128:
      return run<128>(B, C, out_cap, st, off, tlo, thn, base, out);
    case 256:
      return run<256>(B, C, out_cap, st, off, tlo, thn, base, out);
    case 512:
      return run<512>(B, C, out_cap, st, off, tlo, thn, base, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
