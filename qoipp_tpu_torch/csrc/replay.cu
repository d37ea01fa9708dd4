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
//   prev + val; IDX v = table[arg]; RUN/NOP (and classes 6, 7) v = prev;
//   after SETA/SETC/ADD/IDX: prev = v, table[hash(v)] = v (the INDEX
//   write-back applied literally, so adversarial streams stay exact).
// K5 also reports which state components the lane overwrote: pupd (1, B),
// prev written; swr (64, B), slot written; a reset writes all 65.  A
// lane's out-state equals its in-state exactly where the bit is 0, which
// is what the split engine's seam fixpoint propagates.
//
// What bounds it on the card: one thread's walk over the state rows of
// the longest lane, each a dependent step (its value from prev or the
// table, and the hash that says which slot the next IDX row reads), at
// the rate one warp issues that step's instructions.  Bytes (8 read and 4
// written a row) are small beside it.  Only the state rows (classes 1-4,
// and resets) change the state; every other row emits the value of the
// last state row at or before it in the lane (prev_in before the first),
// and the main path's byte-domain rows are 70-76% such rows.
//
// What the design does:
//   - one lane per block, so no row waits for another image's class and
//     B lanes run on B SMs;
//   - 128 helper threads (warps 1-4) stage each tile of kTile rows into
//     shared memory with cp.async a tile ahead, compact its state rows
//     into a list of 16-byte entries (warp ballots and a prefix over the
//     tile) decoded so that every class is one formula, and, two tiles
//     behind the chain, fill the tile's emits from the list by the rule
//     above and store them;
//   - one chain thread (warp 0, lane 0) walks only the list, with the
//     table in shared memory.  It loads each entry four entries early
//     (one 16-byte load) and issues each table read two entries early;
//     the writes of the two entries before it are forwarded from
//     registers.  The chain from prev to the next value is then a masked
//     add and two logic operations, or the hash (one dp4a), a compare
//     and a select;
//   - resets leave the per-row path: a tile that holds one walks a copy
//     of the loop that re-seeds the table on a branch;
//   - K5's summary is a shared flag per slot, set beside each table
//     write, and whether the lane walked any entry; both are written once.
// Rows are read and emits written at (row, lane) strides, so the (C, B)
// chunk-major rows, the transposes of (B, C) lane-major planes and their
// slices are taken as they are.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kHelpers = 128;                 // stage, compact, fill
constexpr int kThreads = 32 + kHelpers;       // warp 0: the chain thread
constexpr int kTile = 1024;                   // rows a tile
constexpr int kSlices = kTile / kHelpers;     // rows a helper thread a tile
constexpr int kHelperWarps = kHelpers / 32;
constexpr int kStages = 3;                    // compact, walk, fill
constexpr uint32_t kRst = 1u << 9;            // meta's reset bit
// An entry's x word: the byte offset in the table of the slot an IDX row
// reads, or of kZeroSlot (a word that stays 0) for the other classes;
// kReset marks a reset row.  The chain keeps the byte offset of each
// write, which equals an entry's x exactly where that entry is an IDX
// row of the written slot; kNoWrite, "no write", equals no x.
constexpr uint32_t kZeroSlot = 64u * 4u, kReset = 1u << 9;
constexpr uint32_t kOffset = 0x1FCu;  // x's byte offset bits
constexpr uint32_t kNoWrite = 1u << 10;
constexpr int kAhead = 4;  // entries the chain loads ahead of its own

struct Shared {
  uint32_t raw_m[2][kTile], raw_x[2][kTile];  // staged rows, two tiles
  // A tile's state rows in order, as the chain reads them (kAhead spare
  // entries past the last), each a value (lo + z) ^ hi ^ w ^ slot with
  // lo = prev & y & 0x7F7F7F7F, hi = prev & y & 0x80808080 and slot the
  // table word at x: x above, y the mask of prev kept, z the low 7 bits
  // of each byte of an ADD row's val, w that val's top bits or the val a
  // SETA or SETC row sets.  The chain overwrites each entry's w with the
  // row's emit.
  uint4 ent[kStages][kTile + kAhead];
  uint16_t upto[kStages][kTile];  // per row: the tile's state rows <= it
  uint32_t start_prev[kStages];   // prev entering the tile
  int count[kStages];             // state rows in the tile
  int resets[kStages][kHelperWarps];  // a reset among a warp's rows
  uint32_t slice_base[kSlices * kHelperWarps];
  alignas(16) uint32_t table[65];  // the 64 slots, then kZeroSlot's 0
  alignas(16) uint32_t written[64];  // K5: the slots the lane wrote
  uint32_t final_prev, pupd;
};

// 4 * (r*3 + g*5 + b*7 + a*11): & 0xFC gives the byte offset of the
// value's slot
__device__ __forceinline__ uint32_t hash_offset(uint32_t v) {
  return __dp4a(v, 0x2C1C140Cu, 0u) & 0xFCu;
}

__device__ __forceinline__ uint32_t& word_at(uint32_t* tab, uint32_t at) {
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(tab) + at);
}

__device__ __forceinline__ bool is_state(uint32_t m) {
  return (m & 7u) - 1u < 4u || (m & kRst) != 0u;
}

__device__ __forceinline__ void cp_async4(void* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kHelpers));
}

__device__ __forceinline__ void fill64(uint32_t* w, uint32_t v) {
  for (int s = 0; s < 64; s += 4)
    *reinterpret_cast<uint4*>(w + s) = make_uint4(v, v, v, v);
}

// The chain: walk a tile's n state rows in order from prev, writing each
// row's emit over its w.  Returns the new prev.  Every class is the one
// formula of Shared::ent: SETA keeps nothing and sets val; SETC keeps the
// bits of prev's alpha that val's alpha lacks and sets val (so its xor is
// the or); ADD keeps prev and adds val byte by byte; IDX keeps and adds
// nothing and takes its slot; a reset row of another class keeps prev
// (its write of the start pixel to slot 53 changes nothing).  Entries are
// loaded kAhead early (one 16-byte load each) and each table read is
// issued two entries early, before the writes of the two entries ahead of
// its own; those two writes are forwarded from registers, the older off
// the chain, the newer by one compare of the previous value's slot.  A
// step is then some 17 instructions, five of them dependent from prev to
// the value (three logic operations, an add and a select).  kResets: the
// tile holds a reset, which re-seeds the state on a branch.
template <bool kSummary, bool kResets>
__device__ uint32_t walk(uint4* e, int n, uint32_t prev, uint32_t* tab,
                         uint32_t* written) {
  if (n == 0) return prev;
  // an entry's table offset (reset tiles: without the reset flag)
  auto offset = [](uint32_t x) { return kResets ? x & kOffset : x; };
  // entries k + 1 .. k + 4 in registers
  uint4 e0 = e[0], e1 = e[1], e2 = e[2], e3 = e[3];
  // the reads of the slots of entries k and k + 1
  uint32_t l0 = word_at(tab, offset(e0.x)), l1 = word_at(tab, offset(e1.x));
  // the offsets written by entries k - 1 and k - 2, and k - 2's value
  uint32_t w1 = kNoWrite, w2 = kNoWrite, v2 = 0u;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const uint4 ek = e0;
    const uint32_t at = offset(ek.x);
    e0 = e1;
    e1 = e2;
    e2 = e3;
    e3 = e[k + kAhead];
    uint32_t cur = l0;
    l0 = l1;
    if constexpr (kResets) {
      if (ek.x & kReset) {  // stream-start reset: re-seed the state
        prev = qk::kStartPixel;
        fill64(tab, 0u);
        tab[qk::kStartHash] = qk::kStartPixel;
        if constexpr (kSummary) fill64(written, 1u);
        cur = word_at(tab, at);
        l0 = word_at(tab, offset(e0.x));
        w1 = w2 = kNoWrite;
      }
    }
    // entry k + 2's slot, read before this entry's write
    l1 = word_at(tab, offset(e1.x));
    const uint32_t slot = w2 == at ? v2 : cur;
    const uint32_t lo = (prev & (ek.y & 0x7F7F7F7Fu)) + ek.z;
    const uint32_t hi = prev & (ek.y & 0x80808080u);
    const uint32_t alu = lo ^ hi ^ (ek.w ^ slot);
    const uint32_t v = w1 == at ? prev : alu;
    const uint32_t wrote = hash_offset(v);
    word_at(tab, wrote) = v;
    if constexpr (kSummary) word_at(written, wrote) = 1u;
    e[k].w = v;
    v2 = prev;
    w2 = w1;
    w1 = wrote;
    prev = v;
  }
  return prev;
}

template <bool kSummary>
__global__ void __launch_bounds__(kThreads)
replay_kernel(const uint32_t* __restrict__ meta,
              const uint32_t* __restrict__ val,
              const uint32_t* __restrict__ prev_in,
              const uint32_t* __restrict__ seen_in,
              uint32_t* __restrict__ emits, uint32_t* __restrict__ prev_out,
              uint32_t* __restrict__ seen_out, int32_t* __restrict__ pupd_out,
              int32_t* __restrict__ swr_out, long long C, int B,
              long long rs, long long ls, long long ers, long long els) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ntiles = (C + kTile - 1) / kTile;
  const uint32_t* lm = meta + lane * ls;
  const uint32_t* lx = val + lane * ls;
  uint32_t* le = emits + lane * els;
  const int h = tid - 32;              // helper index
  const int hw = h >> 5;               // helper warp
  const int hl = tid & 31;             // lane in the warp
  const uint32_t below = (1u << hl) - 1u;

  auto stage = [&](long long t) {  // helpers: tile t's rows, asynchronously
    const long long base = t * kTile;
    uint32_t* dm = sh.raw_m[t & 1];
    uint32_t* dx = sh.raw_x[t & 1];
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int r = j * kHelpers + h;
      if (base + r < C) {
        cp_async4(dm + r, lm + (base + r) * rs);
        cp_async4(dx + r, lx + (base + r) * rs);
      }
    }
  };

  if (tid < 64) {
    sh.table[tid] = seen_in[static_cast<long long>(tid) * B + lane];
    sh.written[tid] = 0u;
  }
  if (tid == 64) sh.table[64] = 0u;  // kZeroSlot
  if (h >= 0 && ntiles > 0) {
    stage(0);
    asm volatile("cp.async.commit_group;\n");
  }
  __syncthreads();

  uint32_t prev = prev_in[lane];  // the chain thread's carry
  bool pupd = false;              // K5: the lane wrote prev
  for (long long i = 0; i < ntiles + 2; ++i) {
    if (tid == 0) {
      if (i >= 1 && i <= ntiles) {  // walk tile i - 1
        const int s = static_cast<int>((i - 1) % kStages);
        const int n = sh.count[s];
        sh.start_prev[s] = prev;
        pupd |= n > 0;
        bool resets = false;
#pragma unroll
        for (int w = 0; w < kHelperWarps; ++w) resets |= sh.resets[s][w];
        prev = resets ? walk<kSummary, true>(sh.ent[s], n, prev, sh.table,
                                             sh.written)
                      : walk<kSummary, false>(sh.ent[s], n, prev, sh.table,
                                              sh.written);
      }
    } else if (h >= 0) {
      if (i + 1 < ntiles) stage(i + 1);
      asm volatile("cp.async.commit_group;\n");  // empty groups keep count
      if (i < ntiles) {  // compact tile i: its rows landed (group i)
        asm volatile("cp.async.wait_group 1;\n");
        const int s = static_cast<int>(i % kStages);
        const long long base = i * kTile;
        const uint32_t* rm = sh.raw_m[i & 1];
        const uint32_t* rx = sh.raw_x[i & 1];
        uint32_t m[kSlices], bal[kSlices];
        bool rst = false;
#pragma unroll
        for (int j = 0; j < kSlices; ++j) {
          const int r = j * kHelpers + h;
          m[j] = base + r < C ? rm[r] : 0u;
          bal[j] = __ballot_sync(0xFFFFFFFFu, is_state(m[j]));
          rst |= (m[j] & kRst) != 0u;
        }
        rst = __any_sync(0xFFFFFFFFu, rst);
        if (hl == 0) {
          sh.resets[s][hw] = rst;
#pragma unroll
          for (int j = 0; j < kSlices; ++j)
            sh.slice_base[j * kHelperWarps + hw] = __popc(bal[j]);
        }
        helpers_sync();
        if (hw == 0) {  // exclusive prefix over (slice, warp) in row order
          static_assert(kSlices * kHelperWarps == 32, "one count a lane");
          const uint32_t cnt = sh.slice_base[hl];
          uint32_t incl = cnt;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (hl >= d) incl += o;
          }
          sh.slice_base[hl] = incl - cnt;
          const uint32_t total = __shfl_sync(0xFFFFFFFFu, incl, 31);
          if (hl == 0) sh.count[s] = static_cast<int>(total);
          // the entries the chain loads past the last: no reset, kZeroSlot
          if (hl < kAhead)
            sh.ent[s][total + hl] = make_uint4(kZeroSlot, 0u, 0u, 0u);
        }
        helpers_sync();
#pragma unroll
        for (int j = 0; j < kSlices; ++j) {
          const int r = j * kHelpers + h;
          const uint32_t mine = (bal[j] >> hl) & 1u;
          const uint32_t at =
              sh.slice_base[j * kHelperWarps + hw] + __popc(bal[j] & below);
          if (mine) {
            const uint32_t mj = m[j], x = rx[r], cls = mj & 7u;
            const bool is_set = cls - 1u < 2u;  // SETA, SETC
            sh.ent[s][at] = make_uint4(
                (cls == 4u ? ((mj >> 3) & 63u) * 4u : kZeroSlot) |
                    ((mj & kRst) ? kReset : 0u),
                cls == 1u   ? 0u
                : cls == 2u ? 0xFF000000u & ~x
                : cls == 4u ? 0u
                            : 0xFFFFFFFFu,
                cls == 3u ? x & 0x7F7F7F7Fu : 0u,
                cls == 3u ? x & 0x80808080u : is_set ? x : 0u);
          }
          sh.upto[s][r] = static_cast<uint16_t>(at + mine);
        }
      }
      if (i >= 2) {  // fill tile i - 2: the last state row's value
        const long long t = i - 2;
        const int s = static_cast<int>(t % kStages);
        const long long base = t * kTile;
        const uint32_t carry = sh.start_prev[s];
#pragma unroll
        for (int j = 0; j < kSlices; ++j) {
          const int r = j * kHelpers + h;
          if (base + r < C) {
            const int p = sh.upto[s][r];
            le[(base + r) * ers] = p ? sh.ent[s][p - 1].w : carry;
          }
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    sh.final_prev = prev;
    sh.pupd = pupd;
  }
  __syncthreads();
  if (tid == 0) prev_out[lane] = sh.final_prev;
  if (tid < 64) {
    const long long at = static_cast<long long>(tid) * B + lane;
    seen_out[at] = sh.table[tid];
    if constexpr (kSummary) {
      if (tid == 0) pupd_out[lane] = sh.pupd ? 1 : 0;
      swr_out[at] = sh.written[tid] ? 1 : 0;
    }
  }
}

template <bool kSummary>
int launch_replay(const void* meta, const void* val, const void* prev_in,
                  const void* seen_in, void* emits, void* prev_out,
                  void* seen_out, void* pupd, void* swr, long long C, int B,
                  long long rs, long long ls, long long ers, long long els,
                  void* stream) {
  const int bytes = static_cast<int>(sizeof(Shared));
  cudaFuncSetAttribute(replay_kernel<kSummary>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  replay_kernel<kSummary>
      <<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(meta),
          static_cast<const uint32_t*>(val),
          static_cast<const uint32_t*>(prev_in),
          static_cast<const uint32_t*>(seen_in), static_cast<uint32_t*>(emits),
          static_cast<uint32_t*>(prev_out), static_cast<uint32_t*>(seen_out),
          static_cast<int32_t*>(pupd), static_cast<int32_t*>(swr), C, B, rs,
          ls, ers, els);
  return qk::launch_status();
}

}  // namespace

// meta/val (C, B) at element strides rs (row) and ls (lane), emits (C, B)
// at ers and els: (B, 1) for chunk-major rows, (1, C) for lane-major
// planes; prev_in/prev_out (1, B); seen_in/seen_out (64, B).  All uint32
// (int32 on the Python side).
QK_API int qk_replay(const void* meta, const void* val, const void* prev_in,
                     const void* seen_in, void* emits, void* prev_out,
                     void* seen_out, long long C, int B, long long rs,
                     long long ls, long long ers, long long els,
                     void* stream) {
  return launch_replay<false>(meta, val, prev_in, seen_in, emits, prev_out,
                              seen_out, nullptr, nullptr, C, B, rs, ls, ers,
                              els, stream);
}

// qk_replay's arguments plus pupd (1, B) and swr (64, B) int32 0/1 outputs.
QK_API int qk_replay_summary(const void* meta, const void* val,
                             const void* prev_in, const void* seen_in,
                             void* emits, void* prev_out, void* seen_out,
                             void* pupd, void* swr, long long C, int B,
                             long long rs, long long ls, long long ers,
                             long long els, void* stream) {
  return launch_replay<true>(meta, val, prev_in, seen_in, emits, prev_out,
                             seen_out, pupd, swr, C, B, rs, ls, ers, els,
                             stream);
}

QK_API const char* qk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
