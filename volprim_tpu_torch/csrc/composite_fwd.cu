// Tile compositor v1, forward pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/composite.py:38
// (_kernel, called from composite_tiles :119). The plain PyTorch version of
// the same function is composite_tiles_reference in
// volprim_tpu_torch/kernels/composite.py; the wrapper composite_tiles there
// launches this kernel for CUDA tensors. The pair math is
// composite12_common.cuh's (policy V1: a, b, c as three 10-term dot
// products of ray and primitive features); the kernel is fwd12_kernel<1,
// 16, NT> of composite12_fwd.cuh, which finds the basis columns that are
// live in its tile itself.
//
// What bounds it on this card: FP32 issue per (ray, column) pair on the
// columns of opacity > 0, about 57 instructions of dot products and 20 of
// q and the early miss per pair, not device-memory bytes. The design
// (composite12_fwd.cuh): those columns alone, compacted in order into
// cp.async double buffers (the shortlist's padding and any opacity-0
// column cost no pair math); pair_hit_walk's early miss, two columns per
// branch; the live SH coefficients only (found per block); warps on
// pixel patches; 256 / 512 / 1024-thread instantiations whose 256-thread
// build keeps three blocks on an SM without spills.

#include "composite12_fwd.cuh"

using namespace composite12;

// C entry point, bound with ctypes. Tensors: fa, fb, fc, basis [T, R, 16]
// f32, pf [T, S, 16] f32, opac [T, 1, S] f32, sh3 [T, S, 48] f32, outputs
// out_l [T, R, 3] and out_beta [T, R] f32, all contiguous on one device.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it does not synchronise.
extern "C" int composite_fwd(const void* fa, const void* fb, const void* fc,
                             const void* basis, const void* pf,
                             const void* opac, const void* sh3, void* out_l,
                             void* out_beta, int T, int R, int S, int seg,
                             float e2, int max_depth, float log_kill,
                             void* stream) {
  Args A{};
  A.ray0 = static_cast<const float*>(fa);
  A.ray1 = static_cast<const float*>(fb);
  A.ray2 = static_cast<const float*>(fc);
  A.ray3 = static_cast<const float*>(basis);
  A.pf = static_cast<const float*>(pf);
  A.col = static_cast<const float*>(opac);
  A.sh3 = static_cast<const float*>(sh3);
  A.out_l = static_cast<float*>(out_l);
  A.out_beta = static_cast<float*>(out_beta);
  A.R = R;
  A.S = S;
  A.seg = seg;
  A.e2 = e2;
  A.max_depth = max_depth;
  A.log_kill = log_kill;
  return static_cast<int>(
      launch_fwd1(A, T, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* composite_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
