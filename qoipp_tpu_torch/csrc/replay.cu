// K1: exact batched QOI chunk replay, and K5: the same replay with transfer
// summaries.
//
// Replaces qoipp_tpu/ops/replay_kernel.py: replay_batch_carry (K1) and
// replay_batch_summary (K5), the Pallas body _make_replay_kernel(
// with_summary=False / True).
//
// Each lane (image) walks its C chunk rows strictly in order, carrying the
// previous pixel and the 64-entry running index:
//   rst (meta bit 9): prev = start pixel, table = 0 except slot 53 = prev;
//   SETA v = val; SETC v = (prev & 0xFF000000) | val; ADD v = per-byte
//   prev + val; IDX v = table[arg]; RUN/NOP v = prev;
//   after SETA/SETC/ADD/IDX: prev = v, table[hash(v)] = v (the INDEX
//   write-back applied literally, so adversarial streams stay exact).
// K5 also reports which state components the lane overwrote: pupd (1, B),
// prev written; swr (64, B), slot written; a reset writes all 65.  A
// lane's out-state equals its in-state exactly where the bit is 0, which
// is what the split engine's seam fixpoint propagates.
//
// What bounds it on the card: the dependency chain of one step (table read
// -> select -> hash -> table write) times C, because a lane is sequential
// and there are only B lanes (B = 16 fills half of one warp).  Memory
// traffic (8 bytes read + 4 written per row and lane) is small.
// What the design does: one thread per lane, its table in shared memory
// laid out [slot][thread] so the threads of a warp never share a bank; the
// (C, B) chunk-major rows make each step's loads one coalesced segment per
// warp; rows are loaded a group ahead in registers so the loads stay off
// the chain; the class select is branch-free so lanes of different chunk
// kinds do not diverge.  K5's summary lives in registers (a bool and a
// 64-bit mask as two words), off the chain, and is written once at the
// end.  Parallelism across rows within one stream is the split engine's
// job: it cuts a stream into segments and supplies them as K5's lanes.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kLanes = 32;  // threads (lanes) per block
constexpr int kGroup = 8;   // rows loaded ahead of the dependency chain

// K5's transfer summary, held in registers
struct Summary {
  bool pupd = false;
  uint32_t lo = 0, hi = 0;  // swr slots 0-31 and 32-63
};

template <bool kSummary>
__device__ __forceinline__ uint32_t step(uint32_t m, uint32_t x,
                                         uint32_t& prev, uint32_t* tab,
                                         Summary& sum) {
  if ((m >> 9) & 1u) {  // stream-start reset
    prev = qk::kStartPixel;
    for (int s = 0; s < 64; ++s)
      tab[s * kLanes] = s == qk::kStartHash ? qk::kStartPixel : 0u;
    if constexpr (kSummary) {
      sum.pupd = true;
      sum.lo = sum.hi = 0xFFFFFFFFu;
    }
  }
  const uint32_t cls = m & 7u;
  const uint32_t arg = (m >> 3) & 63u;
  const uint32_t setv = cls == 2u ? ((prev & 0xFF000000u) | x) : x;
  const uint32_t addv = qk::swar_add(prev, x);
  const uint32_t idxv = tab[arg * kLanes];
  const uint32_t v = (cls == 1u || cls == 2u) ? setv
                     : cls == 3u              ? addv
                     : cls == 4u              ? idxv
                                              : prev;
  if (cls - 1u < 4u) {  // SETA, SETC, ADD, IDX update the state
    prev = v;
    const uint32_t h = qk::hash6(v);
    tab[h * kLanes] = v;
    if constexpr (kSummary) {
      sum.pupd = true;
      if (h < 32u) sum.lo |= 1u << h;
      else sum.hi |= 1u << (h - 32u);
    }
  }
  return v;
}

template <bool kSummary>
__global__ void __launch_bounds__(kLanes)
replay_kernel(const uint32_t* __restrict__ meta,
              const uint32_t* __restrict__ val,
              const uint32_t* __restrict__ prev_in,
              const uint32_t* __restrict__ seen_in,
              uint32_t* __restrict__ emits, uint32_t* __restrict__ prev_out,
              uint32_t* __restrict__ seen_out, int32_t* __restrict__ pupd_out,
              int32_t* __restrict__ swr_out, long long C, int B) {
  __shared__ uint32_t table[64 * kLanes];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= B) return;  // no block-wide barrier below
  uint32_t* tab = table + threadIdx.x;  // slot s at tab[s * kLanes]
  for (int s = 0; s < 64; ++s) tab[s * kLanes] = seen_in[(long long)s * B + lane];
  uint32_t prev = prev_in[lane];
  Summary sum;

  long long r = 0;
  for (; r + kGroup <= C; r += kGroup) {
    uint32_t m[kGroup], x[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      m[k] = meta[(r + k) * B + lane];
      x[k] = val[(r + k) * B + lane];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      emits[(r + k) * B + lane] = step<kSummary>(m[k], x[k], prev, tab, sum);
  }
  for (; r < C; ++r)
    emits[r * B + lane] =
        step<kSummary>(meta[r * B + lane], val[r * B + lane], prev, tab, sum);

  prev_out[lane] = prev;
  for (int s = 0; s < 64; ++s) seen_out[(long long)s * B + lane] = tab[s * kLanes];
  if constexpr (kSummary) {
    pupd_out[lane] = sum.pupd ? 1 : 0;
    for (int s = 0; s < 64; ++s)
      swr_out[(long long)s * B + lane] =
          ((s < 32 ? sum.lo >> s : sum.hi >> (s - 32)) & 1u) ? 1 : 0;
  }
}

template <bool kSummary>
int launch_replay(const void* meta, const void* val, const void* prev_in,
                  const void* seen_in, void* emits, void* prev_out,
                  void* seen_out, void* pupd, void* swr, long long C, int B,
                  void* stream) {
  const int blocks = (B + kLanes - 1) / kLanes;
  replay_kernel<kSummary>
      <<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(meta),
          static_cast<const uint32_t*>(val),
          static_cast<const uint32_t*>(prev_in),
          static_cast<const uint32_t*>(seen_in), static_cast<uint32_t*>(emits),
          static_cast<uint32_t*>(prev_out), static_cast<uint32_t*>(seen_out),
          static_cast<int32_t*>(pupd), static_cast<int32_t*>(swr), C, B);
  return qk::launch_status();
}

}  // namespace

// meta/val/emits (C, B) row-major; prev_in/prev_out (1, B); seen_in/seen_out
// (64, B).  All uint32 (int32 on the Python side).
QK_API int qk_replay(const void* meta, const void* val, const void* prev_in,
                     const void* seen_in, void* emits, void* prev_out,
                     void* seen_out, long long C, int B, void* stream) {
  return launch_replay<false>(meta, val, prev_in, seen_in, emits, prev_out,
                              seen_out, nullptr, nullptr, C, B, stream);
}

// qk_replay's arguments plus pupd (1, B) and swr (64, B) int32 0/1 outputs.
QK_API int qk_replay_summary(const void* meta, const void* val,
                             const void* prev_in, const void* seen_in,
                             void* emits, void* prev_out, void* seen_out,
                             void* pupd, void* swr, long long C, int B,
                             void* stream) {
  return launch_replay<true>(meta, val, prev_in, seen_in, emits, prev_out,
                             seen_out, pupd, swr, C, B, stream);
}

QK_API const char* qk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
