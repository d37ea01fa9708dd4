// K1: exact batched QOI chunk replay.
//
// Replaces qoipp_tpu/ops/replay_kernel.py: replay_batch_carry (the Pallas
// body _make_replay_kernel(with_summary=False)).
//
// Each lane (image) walks its C chunk rows strictly in order, carrying the
// previous pixel and the 64-entry running index:
//   rst (meta bit 9): prev = start pixel, table = 0 except slot 53 = prev;
//   SETA v = val; SETC v = (prev & 0xFF000000) | val; ADD v = per-byte
//   prev + val; IDX v = table[arg]; RUN/NOP v = prev;
//   after SETA/SETC/ADD/IDX: prev = v, table[hash(v)] = v (the INDEX
//   write-back applied literally, so adversarial streams stay exact).
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
// kinds do not diverge.  Parallelism across rows within a lane is the
// split-replay engine's job (a later kernel), not this one's.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kLanes = 32;  // threads (lanes) per block
constexpr int kGroup = 8;   // rows loaded ahead of the dependency chain

__device__ __forceinline__ uint32_t step(uint32_t m, uint32_t x,
                                         uint32_t& prev, uint32_t* tab) {
  if ((m >> 9) & 1u) {  // stream-start reset
    prev = qk::kStartPixel;
    for (int s = 0; s < 64; ++s)
      tab[s * kLanes] = s == qk::kStartHash ? qk::kStartPixel : 0u;
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
    tab[qk::hash6(v) * kLanes] = v;
  }
  return v;
}

__global__ void __launch_bounds__(kLanes)
replay_kernel(const uint32_t* __restrict__ meta,
              const uint32_t* __restrict__ val,
              const uint32_t* __restrict__ prev_in,
              const uint32_t* __restrict__ seen_in,
              uint32_t* __restrict__ emits, uint32_t* __restrict__ prev_out,
              uint32_t* __restrict__ seen_out, long long C, int B) {
  __shared__ uint32_t table[64 * kLanes];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= B) return;  // no block-wide barrier below
  uint32_t* tab = table + threadIdx.x;  // slot s at tab[s * kLanes]
  for (int s = 0; s < 64; ++s) tab[s * kLanes] = seen_in[(long long)s * B + lane];
  uint32_t prev = prev_in[lane];

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
      emits[(r + k) * B + lane] = step(m[k], x[k], prev, tab);
  }
  for (; r < C; ++r)
    emits[r * B + lane] = step(meta[r * B + lane], val[r * B + lane], prev, tab);

  prev_out[lane] = prev;
  for (int s = 0; s < 64; ++s) seen_out[(long long)s * B + lane] = tab[s * kLanes];
}

}  // namespace

// meta/val/emits (C, B) row-major; prev_in/prev_out (1, B); seen_in/seen_out
// (64, B).  All uint32 (int32 on the Python side).
QK_API int qk_replay(const void* meta, const void* val, const void* prev_in,
                     const void* seen_in, void* emits, void* prev_out,
                     void* seen_out, long long C, int B, void* stream) {
  const int blocks = (B + kLanes - 1) / kLanes;
  replay_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(meta), static_cast<const uint32_t*>(val),
      static_cast<const uint32_t*>(prev_in),
      static_cast<const uint32_t*>(seen_in), static_cast<uint32_t*>(emits),
      static_cast<uint32_t*>(prev_out), static_cast<uint32_t*>(seen_out), C, B);
  return qk::launch_status();
}

QK_API const char* qk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
