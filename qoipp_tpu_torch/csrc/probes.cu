// E8, E9: the design probes of benchmarks/profile_r2.py.
//
// E8 replaces `run` (body tiny_kernel): x + 1 over (steps, 8, 128) words,
// one (8, 128) block per grid step, the probe of the TPU's per-grid-step
// overhead.  Here it is one 1,024-word block per step (256 threads, one
// 16-byte load and store each), so the time per step reads the card's
// per-block cost.  Bound: bytes, 8 per word.
//
// E9 replaces `prun` (body place_kernel): per block of K targets t in
// [0, S * 128) and values v, out[t / 128][t % 128] += v, the probe of
// one-hot matrix-unit placement.  On Hopper the function is a scatter-add:
// a one-hot GEMM would spend S * 128 * K multiply-adds per block to place K
// values, so the kernel is one block per row of targets with its S * 128
// bins in shared memory, shared atomics, and one coalesced store.  The
// bins sum in float64 and round to float32 once, so the result does not
// depend on the order the atomics land in; targets outside the bins are
// dropped, as the one-hot product drops them.  Bound: bytes, 8 per target
// read and 4 per bin written.
//
// dep_chain is no TPU kernel's counterpart: it measures the card for the
// replay chain's bound (benchmarks/replay_probe).  One thread runs rounds
// x kChainUnroll steps of x = (x + a) ^ b, two dependent 32-bit integer
// instructions a step (an add and a logic operation) and nothing else on
// the chain, and reads the SM's cycle counter and the global nanosecond
// timer around the loop: cycles over instructions is the dependent-issue
// latency, cycles over nanoseconds the SM clock while it ran.
#include "qoipp_kernels.cuh"

namespace {

constexpr int kStepWords = 1024;  // one (8, 128) block
constexpr int kStepThreads = kStepWords / 4;
constexpr int kPlaceThreads = 512;
constexpr int kChainUnroll = 64;

__global__ void __launch_bounds__(kStepThreads)
grid_step_kernel(const uint4* __restrict__ x, uint4* __restrict__ y) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kStepThreads + threadIdx.x;
  uint4 v = x[i];
  v.x += 1u;
  v.y += 1u;
  v.z += 1u;
  v.w += 1u;
  y[i] = v;
}

__global__ void __launch_bounds__(kPlaceThreads)
onehot_place_kernel(const int32_t* __restrict__ t, const float* __restrict__ v,
                    float* __restrict__ out, long long K, int nbins) {
  extern __shared__ double bins[];
  for (int i = threadIdx.x; i < nbins; i += kPlaceThreads) bins[i] = 0.0;
  __syncthreads();
  const long long row = blockIdx.x;
  const int32_t* tr = t + row * K;
  const float* vr = v + row * K;
  for (long long k = threadIdx.x; k < K; k += kPlaceThreads) {
    const int32_t x = tr[k];
    if (x >= 0 && x < nbins) atomicAdd(bins + x, static_cast<double>(vr[k]));
  }
  __syncthreads();
  float* o = out + row * nbins;
  for (int i = threadIdx.x; i < nbins; i += kPlaceThreads)
    o[i] = static_cast<float>(bins[i]);
}

// out[0] cycles, out[1] ns, out[2] the final x.  Each timer read takes x
// as an operand, so the loop can move across neither; adding threadIdx.x
// (0) keeps x in a thread's registers, where the replay chain runs, and
// off the uniform datapath, where a value the whole warp shares would go.
__global__ void dep_chain_kernel(long long* out, uint32_t x, uint32_t a,
                                 uint32_t b, long long rounds) {
  unsigned long long g0, g1, c0, c1;
  x += threadIdx.x;
  asm volatile(
      "mov.u64 %0, %%globaltimer;\n\tmov.u64 %1, %%clock64;\n\t"
      "mov.b32 %2, %2;"
      : "=l"(g0), "=l"(c0), "+r"(x));
  for (long long i = 0; i < rounds; ++i) {
#pragma unroll
    for (int k = 0; k < kChainUnroll; ++k) x = (x + a) ^ b;
  }
  asm volatile(
      "mov.b32 %2, %2;\n\tmov.u64 %1, %%clock64;\n\t"
      "mov.u64 %0, %%globaltimer;"
      : "=l"(g1), "=l"(c1), "+r"(x));
  out[0] = static_cast<long long>(c1 - c0);
  out[1] = static_cast<long long>(g1 - g0);
  out[2] = x;
}

}  // namespace

// x, y (steps, 8, 128) 32-bit words: y = x + 1 (wrapping).
QK_API int qk_grid_step(const void* x, void* y, long long steps,
                        void* stream) {
  if (steps <= 0 || steps > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  grid_step_kernel<<<static_cast<unsigned>(steps), kStepThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y));
  return qk::launch_status();
}

// t (nblk, K) int32, v (nblk, K) float32 -> out (nblk, nbins) float32.
QK_API int qk_onehot_place(const void* t, const void* v, void* out, int nblk,
                           long long K, int nbins, void* stream) {
  const size_t smem = sizeof(double) * static_cast<size_t>(nbins);
  const cudaError_t rc = cudaFuncSetAttribute(
      onehot_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  onehot_place_kernel<<<nblk, kPlaceThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t), static_cast<const float*>(v),
      static_cast<float*>(out), K, nbins);
  return qk::launch_status();
}

// out (3,) int64: the cycles and nanoseconds of rounds x 64 steps of
// x = (x + a) ^ b on one thread, and the final x.
QK_API int qk_dep_chain(void* out, uint32_t x, uint32_t a, uint32_t b,
                        long long rounds, void* stream) {
  if (rounds <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dep_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), x, a, b, rounds);
  return qk::launch_status();
}
