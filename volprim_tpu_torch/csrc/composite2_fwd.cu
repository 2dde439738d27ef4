// Camera-relative tile compositor v2, forward pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/composite2.py:105
// (_fwd_kernel, called from _forward :307). The plain PyTorch version of the
// same function is composite_tiles2_reference in
// volprim_tpu_torch/kernels/composite2.py; composite_tiles2 there launches
// this kernel for CUDA tensors. The pair math is composite12_common.cuh's
// (policy V2<K>: a = F6(d) . M6, b = d . U, c = c0, F6 and the SH basis of
// degree sqrt(K) - 1 built from d); the kernel is fwd12_kernel<2, K, NT> of
// composite12_fwd.cuh.
//
// What bounds it on this card: FP32 issue per (ray, column) pair on the
// columns of opacity > 0, about 16 instructions for a and b and 20 for q
// and the early miss per pair, not device-memory bytes. The design
// (composite12_fwd.cuh): those columns alone, compacted in order into one
// cp.async staging buffer (a second measured slower at four blocks per
// SM); pair_hit_walk's early miss, two columns per branch; the k live SH
// coefficients; warps on pixel patches; 256 / 512 / 1024-thread
// instantiations whose 256-thread build keeps four blocks on an SM
// without spills at k = 4.

#include "composite12_fwd.cuh"

using namespace composite12;

// C entry point, bound with ctypes. Tensors: d8 [T, R, 8] f32 (direction in
// 0-2), pf_cam [T, S, 16] f32 (M6, U, ...), aux [T, 2, S] f32 (opacity, c0),
// sh3 [T, S, 48] f32, outputs out_l [T, R, 3] and out_beta [T, R] f32, all
// contiguous on one device; k is the live SH count (1, 4, 9 or 16).
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// it does not synchronise.
extern "C" int composite2_fwd(const void* d8, const void* pf, const void* aux,
                              const void* sh3, void* out_l, void* out_beta,
                              int T, int R, int S, int seg, int k, float e2,
                              int max_depth, float log_kill, void* stream) {
  Args A{};
  A.ray0 = static_cast<const float*>(d8);
  A.pf = static_cast<const float*>(pf);
  A.col = static_cast<const float*>(aux);
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
      launch_fwd2(A, T, k, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* composite2_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
