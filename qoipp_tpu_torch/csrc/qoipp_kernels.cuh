// Shared definitions of the qoipp_tpu_torch CUDA kernels (sm_90a).
//
// Pixel words are uint32 r | g<<8 | b<<16 | a<<24; on the Python side they
// travel as int32 tensors with the same bits.  Every C entry point takes its
// tensors as raw device pointers plus the CUDA stream, launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the ctypes
// wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define QK_API extern "C" __attribute__((visibility("default")))

namespace qk {

constexpr uint32_t kStartPixel = 0xFF000000u;  // (0, 0, 0, 255)
constexpr int kStartHash = (11 * 255) % 64;     // hash of the start pixel: 53

__device__ __forceinline__ uint32_t hash6(uint32_t v) {
  return ((v & 0xFFu) * 3u + ((v >> 8) & 0xFFu) * 5u +
          ((v >> 16) & 0xFFu) * 7u + (v >> 24) * 11u) & 63u;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace qk
