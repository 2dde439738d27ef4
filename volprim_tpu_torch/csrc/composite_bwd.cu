// Tile compositor v1, backward pass (its vector-Jacobian product), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// volprim_tpu/pallas_kernels/composite_vjp.py:48 (_bwd_kernel, called from
// _bwd_rule :238). The plain PyTorch version of the same function is
// composite_tiles_bwd_reference in volprim_tpu_torch/kernels/composite_vjp.py;
// composite_tiles_bwd there launches this kernel for CUDA tensors. The
// carry pass and one walk per segment, the column sums in a fixed order and
// what bounds it are described in composite12_bwd.cuh (bwd12_kernel, V = 1):
// gpf[c, f] sums fa[f] g_a + fb[f] g_b + fc[f] g_c over the tile's rays for
// f < 10 (columns 10-15 are written 0), gopac sums g_raw exp(-q/2), gsh
// sums basis[k] [e > 0] g_L w over the k live basis columns (the rest are
// written 0), all f32.

#include "composite12_bwd.cuh"

using namespace composite12;

// C entry point, bound with ctypes. Tensors: the forward's inputs (fa, fb,
// fc, basis [T, R, 16], pf [T, S, 16], opac [T, 1, S], sh3 [T, S, 48]),
// g_l [T, R, 3], g_beta [T, R], scratch lb_scr [T, S / seg, R] f32 and
// cnt_scr [T, S / seg, R] int32, outputs gpf [T, S, 16], gopac [T, 1, S],
// gsh [T, S, 48], all f32 but cnt_scr, contiguous on one device; k (1, 4,
// 9 or 16) covers every basis column that is nonzero somewhere (the later
// ones must be 0). Every output element is written. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int composite_bwd(const void* fa, const void* fb, const void* fc,
                             const void* basis, const void* pf,
                             const void* opac, const void* sh3,
                             const void* g_l, const void* g_beta, void* lb_scr,
                             void* cnt_scr, void* gpf, void* gopac, void* gsh,
                             int T, int R, int S, int seg, int k, float e2,
                             int max_depth, float log_kill, void* stream) {
  Args A{};
  A.ray0 = static_cast<const float*>(fa);
  A.ray1 = static_cast<const float*>(fb);
  A.ray2 = static_cast<const float*>(fc);
  A.ray3 = static_cast<const float*>(basis);
  A.pf = static_cast<const float*>(pf);
  A.col = static_cast<const float*>(opac);
  A.sh3 = static_cast<const float*>(sh3);
  A.g_l = static_cast<const float*>(g_l);
  A.g_beta = static_cast<const float*>(g_beta);
  A.lb_scr = static_cast<float*>(lb_scr);
  A.cnt_scr = static_cast<int*>(cnt_scr);
  A.gpf = static_cast<float*>(gpf);
  A.gcol = static_cast<float*>(gopac);
  A.gsh = static_cast<float*>(gsh);
  A.R = R;
  A.S = S;
  A.seg = seg;
  A.e2 = e2;
  A.max_depth = max_depth;
  A.log_kill = log_kill;
  return static_cast<int>(
      launch_bwd<1>(A, T, k, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* composite_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
