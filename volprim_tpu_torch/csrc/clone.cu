// The per-stage profiler's DMA-floor probe, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/profile_rf.py:405 (_ckern, called
// from clone :415): a kernel with the fused compositor's call shape (one
// program per tile, the tile's d8 [8, R], pf [16, S] and sh3 [3k, S] blocks
// brought into fast memory, an [R, 8] output block) that does no compositing,
// so its time is the floor that the grid and the data movement of that call
// shape set. The plain PyTorch version is clone_reference in
// volprim_tpu_torch/kernels/clone.py; the wrapper clone there launches this
// kernel for CUDA tensors.
//
// Per tile t (one block) it writes
//   out[t, r, c] = 0 + (((f32(n_seg_t[t]) + d8[t, 0, 0]) + pf[t, 0, 0])
//                       + f32(sh3[t, 0, 0])) + ut[0, 0]
// for every ray r and column c < 8, summed in that order, as the TPU
// kernel does (bit for bit: the file is built with -fmad=false).
//
// What bounds it on this card: device-memory bytes. Every tile block is
// read once and the output written once; ut is read once per block from
// the cache (the TPU fetches it once: its block index never changes). The
// point of the kernel is that the reads happen, although only three values
// of them reach the output: plain loads whose values are unused would be
// removed by the compiler, and the probe would time only the writes. So
// each block streams its three blocks through a two-stage ring of shared
// memory with asynchronous copies (cp.async, 16 bytes a thread), as the
// TPU's BlockSpec pipeline copies each block into VMEM, and takes the three
// values from the staged data. The copies are asm volatile: the compiler
// keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;  // bytes per ring stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts the copy of chunk c of the tile's three blocks (the chunks of d8,
// then of pf, then of sh3, none crossing a block) into ring stage buf.
__device__ __forceinline__ void issue_chunk(const unsigned char* const* src,
                                            const int* bytes,
                                            const int* first_chunk, int c,
                                            unsigned char* buf) {
  int b = 0;
  while (b < 2 && c >= first_chunk[b + 1]) ++b;
  const int off = (c - first_chunk[b]) * kChunk;
  const int n = min(kChunk, bytes[b] - off);
  for (int i = threadIdx.x * 16; i < n; i += kThreads * 16)
    cp_async16(buf + i, src[b] + off + i);
}

__global__ void __launch_bounds__(kThreads)
    clone_kernel(const int* __restrict__ n_seg_t, const float* __restrict__ d8,
                 const float* __restrict__ pf,
                 const __nv_bfloat16* __restrict__ sh3,
                 const float* __restrict__ ut, float* __restrict__ out, int R,
                 int S, int sh_rows) {
  __shared__ __align__(16) unsigned char ring[2][kChunk];
  __shared__ float s_first[3];  // d8[t, 0, 0], pf[t, 0, 0], f32(sh3[t, 0, 0])
  const int t = blockIdx.x;
  const unsigned char* src[3] = {
      reinterpret_cast<const unsigned char*>(d8 + static_cast<size_t>(t) * 8 * R),
      reinterpret_cast<const unsigned char*>(pf + static_cast<size_t>(t) * 16 * S),
      reinterpret_cast<const unsigned char*>(
          sh3 + static_cast<size_t>(t) * sh_rows * S)};
  const int bytes[3] = {8 * R * 4, 16 * S * 4, sh_rows * S * 2};
  int first_chunk[4] = {0, 0, 0, 0};
  for (int b = 0; b < 3; ++b)
    first_chunk[b + 1] = first_chunk[b] + (bytes[b] + kChunk - 1) / kChunk;
  const int n_chunks = first_chunk[3];

  issue_chunk(src, bytes, first_chunk, 0, ring[0]);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      // stage (c + 1) & 1 was last read in iteration c - 1, before its
      // closing barrier
      issue_chunk(src, bytes, first_chunk, c + 1, ring[(c + 1) & 1]);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk c is in ring[c & 1] for every thread
    if (threadIdx.x == 0) {
      const unsigned char* buf = ring[c & 1];
      if (c == first_chunk[0]) s_first[0] = *reinterpret_cast<const float*>(buf);
      if (c == first_chunk[1]) s_first[1] = *reinterpret_cast<const float*>(buf);
      if (c == first_chunk[2])
        s_first[2] =
            __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(buf));
    }
    __syncthreads();  // ring[c & 1] may be refilled
  }

  const float v = static_cast<float>(n_seg_t[t]) + s_first[0] + s_first[1] +
                  s_first[2] + ut[0];
  float* o = out + static_cast<size_t>(t) * R * 8;
  for (int i = threadIdx.x; i < R * 8; i += kThreads) o[i] = 0.0f + v;
}

}  // namespace

// C entry point (clone_probe: glibc has a clone), bound with ctypes.
// Tensors: n_seg_t [T] int32, d8 [T, 8, R] f32, pf [T, 16, S] f32, sh3
// [T, sh_rows, S] bf16, ut [seg, seg] f32 and out [T, R, 8] f32, contiguous on one device, the tensors' data
// 16-byte aligned and S a multiple of 8 (every block a whole number of
// 16-byte copies). Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int clone_probe(const void* n_seg_t, const void* d8,
                           const void* pf, const void* sh3, const void* ut,
                           void* out, int T, int R, int S, int sh_rows,
                           void* stream) {
  if (T < 0 || R < 1 || S < 8 || S % 8 != 0 || sh_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  clone_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(n_seg_t), static_cast<const float*>(d8),
      static_cast<const float*>(pf), static_cast<const __nv_bfloat16*>(sh3),
      static_cast<const float*>(ut), static_cast<float*>(out), R, S, sh_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clone_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
