// Device helpers shared by the tile compositors (composite3_common.cuh, the
// v3 kernels; composite12_fwd.cuh, the v1 / v2 forward): cp.async copies
// into shared memory and the thread-to-ray map of a block.

#pragma once

#include <cuda_runtime.h>

// One 4-byte cp.async copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ray a thread holds: with R == NT and NT a multiple of 256, each 256
// rays are a 16 x 16 pixel block in row-major order (rf_tiled's tile
// layout) and warp w of it takes the 4 x 8 patch (rows 4 (w / 2) ..,
// columns 8 (w % 2) ..), whose rays span a narrower cone and hit fewer
// distinct columns than a 2 x 16 strip; else the thread's own index.
// Every ray reads its inputs and writes its outputs at its own index, so
// results do not depend on the map.
__device__ __forceinline__ int ray_of_thread(int tid, int R, int NT) {
  if (R != NT || (NT & 255) != 0) return tid;
  const int group = tid & ~255, local = tid & 255;
  const int w = local >> 5, lane = local & 31;
  const int row = 4 * (w >> 1) + (lane >> 3), col = 8 * (w & 1) + (lane & 7);
  return group + 16 * row + col;
}
