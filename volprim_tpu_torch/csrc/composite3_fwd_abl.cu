// The forward compositor's timing ablations (composite3_fwd.cuh, enum
// Ablation): the kernel of the path with one piece of its work removed,
// for tools/profile_rf.py's abl_* stages. Their results are wrong by
// design. Instantiated for k = 4 (the bench scene's SH width), unbanded, at
// every block size; the path's library (composite3_fwd.cu) compiles none of
// them.

#include "composite3_fwd.cuh"

namespace {

using namespace composite3;

template <int ABL>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, float* out_l, float* out_beta,
                   int* out_walked, int* out_live, int* idx_scr, int T, int R,
                   int S, int seg, float e2h, int max_depth, float log_kill,
                   int compact, int early_exit, cudaStream_t stream) {
  return fwd_launch_nt<4, false, ABL>(d8, pf, sh3, n_seg_t, out_l, out_beta,
                                      out_walked, out_live, idx_scr, T, R, S,
                                      seg, e2h, max_depth, log_kill, compact, 0,
                                      early_exit, stream);
}

}  // namespace

// C entry point, bound with ctypes: composite3_fwd's tensors (k = 4, no
// band) and scalars, with the ablation `abl` (1-8, enum Ablation) in place
// of k and no band argument (static and fori ignore early_exit).
extern "C" int composite3_fwd_abl(const void* d8, const void* pf,
                                  const void* sh3, const void* n_seg_t,
                                  void* out_l, void* out_beta, void* out_walked,
                                  void* out_live, void* idx_scr, int T, int R,
                                  int S, int seg, int abl, float e2h,
                                  int max_depth, float log_kill, int compact,
                                  int early_exit, void* stream) {
  if (!args_ok(T, R, S, seg, 0)) return static_cast<int>(cudaErrorInvalidValue);
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
#define ABL_CASE(A)                                                        \
  case A:                                                                  \
    return static_cast<int>(launch<A>(d, p, s, n, l, b, wk, lv, ix, T, R, \
                                      S, seg, e2h, max_depth, log_kill,    \
                                      compact, early_exit, st));
  switch (abl) {
    ABL_CASE(kAblNodepth)
    ABL_CASE(kAblNoemis)
    ABL_CASE(kAblNotrans)
    ABL_CASE(kAblNocum)
    ABL_CASE(kAblNoop)
    ABL_CASE(kAblNoop2)
    ABL_CASE(kAblStatic)
    ABL_CASE(kAblFori)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ABL_CASE
}

extern "C" const char* composite3_fwd_abl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
