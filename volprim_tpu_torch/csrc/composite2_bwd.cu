// Camera-relative tile compositor v2, backward pass (its vector-Jacobian
// product), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/composite2.py:159
// (_bwd_kernel, called from _bwd_rule :339). The plain PyTorch version of
// the same function is composite_tiles2_bwd_reference in
// volprim_tpu_torch/kernels/composite2.py; composite_tiles2_bwd there
// launches this kernel for CUDA tensors. The carry pass and one walk per
// segment, the column sums in a fixed order and what bounds it are
// described in composite12_bwd.cuh (bwd12_kernel, V = 2): gpf rows 0-5
// sum F6(d) g_a and rows 6-8 d g_b over the tile's rays (rows 9-15 are
// written 0), gaux row 0 sums g_raw exp(-q/2) and row 1 g_q (c = c0), gsh
// sums basis[k] [e > 0] g_L w; d8 gets no gradient.

#include "composite12_bwd.cuh"

using namespace composite12;

// C entry point, bound with ctypes. Tensors: the forward's inputs (d8
// [T, R, 8], pf_cam [T, S, 16], aux [T, 2, S], sh3 [T, S, 48]), g_l
// [T, R, 3], g_beta [T, R], scratch lb_scr [T, S / seg, R] f32 and cnt_scr
// [T, S / seg, R] int32, outputs gpf [T, S, 16], gaux [T, 2, S], gsh
// [T, S, 48], all f32 but cnt_scr, contiguous on one device; k is the live
// SH count (1, 4, 9 or 16). Every output element is written. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int composite2_bwd(const void* d8, const void* pf, const void* aux,
                              const void* sh3, const void* g_l,
                              const void* g_beta, void* lb_scr, void* cnt_scr,
                              void* gpf, void* gaux, void* gsh, int T, int R,
                              int S, int seg, int k, float e2, int max_depth,
                              float log_kill, void* stream) {
  Args A{};
  A.ray0 = static_cast<const float*>(d8);
  A.pf = static_cast<const float*>(pf);
  A.col = static_cast<const float*>(aux);
  A.sh3 = static_cast<const float*>(sh3);
  A.g_l = static_cast<const float*>(g_l);
  A.g_beta = static_cast<const float*>(g_beta);
  A.lb_scr = static_cast<float*>(lb_scr);
  A.cnt_scr = static_cast<int*>(cnt_scr);
  A.gpf = static_cast<float*>(gpf);
  A.gcol = static_cast<float*>(gaux);
  A.gsh = static_cast<float*>(gsh);
  A.R = R;
  A.S = S;
  A.seg = seg;
  A.e2 = e2;
  A.max_depth = max_depth;
  A.log_kill = log_kill;
  return static_cast<int>(
      launch_bwd<2>(A, T, k, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* composite2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
