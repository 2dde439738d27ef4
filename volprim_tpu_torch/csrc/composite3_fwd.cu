// Fused tile compositor, forward pass, for Hopper (sm_90a): the path's
// instantiations of the kernel in composite3_fwd.cuh (its design notes are
// there) and their C entry point. Per SH width k (1, 4, 9, 16) and block
// size (256, 512, 1024 threads): unbanded, and banded for any band up to
// kMaxBand. No timing ablation is compiled in here (composite3_fwd_abl.cu
// has them).

#include "composite3_fwd.cuh"

namespace {

using namespace composite3;

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, float* out_l, float* out_beta,
                   int* out_walked, int* out_live, int* idx_scr, int T, int R,
                   int S, int seg, float e2h, int max_depth, float log_kill,
                   int compact, int band, int early_exit,
                   cudaStream_t stream) {
  if (band == 0)
    return fwd_launch_nt<K, false, kAblNone>(
        d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr,
        T, R, S, seg, e2h, max_depth, log_kill, compact, band, early_exit,
        stream);
  return fwd_launch_nt<K, true, kAblNone>(
      d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr, T,
      R, S, seg, e2h, max_depth, log_kill, compact, band, early_exit, stream);
}

}  // namespace

// C entry point, bound with ctypes. Tensors: d8 [T, 8, R] f32, pf [T, 16, S]
// f32, sh3 [T, 3k, S] bf16, n_seg_t [T] int32, out_l [T, R, 3] f32,
// out_beta [T, R] f32, out_walked and out_live [T] int32, and with compact a
// scratch idx_scr [T, S] int32, all contiguous on one device; 0 <= band <=
// kMaxBand; early_exit nonzero stops a tile once every ray is capped or
// saturated (without compaction only). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int composite3_fwd(const void* d8, const void* pf, const void* sh3,
                              const void* n_seg_t, void* out_l, void* out_beta,
                              void* out_walked, void* out_live, void* idx_scr,
                              int T, int R, int S, int seg, int k, float e2h,
                              int max_depth, float log_kill, int compact,
                              int band, int early_exit, void* stream) {
  if (!args_ok(T, R, S, seg, band))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(d8);
  const auto* p = static_cast<const float*>(pf);
  const auto* s = static_cast<const __nv_bfloat16*>(sh3);
  const auto* n = static_cast<const int*>(n_seg_t);
  auto* l = static_cast<float*>(out_l);
  auto* b = static_cast<float*>(out_beta);
  auto* wk = static_cast<int*>(out_walked);
  auto* lv = static_cast<int*>(out_live);
  auto* ix = static_cast<int*>(idx_scr);
  switch (k) {
    case 1:
      return static_cast<int>(launch<1>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, early_exit, st));
    case 4:
      return static_cast<int>(launch<4>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, early_exit, st));
    case 9:
      return static_cast<int>(launch<9>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, early_exit, st));
    case 16:
      return static_cast<int>(launch<16>(d, p, s, n, l, b, wk, lv, ix, T, R,
                                         S, seg, e2h, max_depth, log_kill,
                                         compact, band, early_exit, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* composite3_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
