// The compositing backbone of the v1 and v2 tile compositors, forward and
// backward, for Hopper (sm_90a), templated on the pair math:
//   V1 (composite_fwd.cu, composite_bwd.cu): a, b, c are three 10-term dot
//      products of per-ray features fa, fb, fc [T, R, 16] with the column's
//      primitive features pf [T, S, 16]; the SH basis [T, R, 16] is an input;
//   V2 (composite2_fwd.cu, composite2_bwd.cu): a = F6(d) . M6, b = d . U and
//      c = c0 per column (pf_cam [T, S, 16], aux [T, 2, S] = opacity, c0);
//      F6 and the SH basis come from the direction d8 [T, R, 8] in-kernel.
// The plain PyTorch versions are walk_reference / walk_bwd_reference in
// volprim_tpu_torch/kernels/composite.py with v1_coeffs, and the v2 ones in
// kernels/composite2.py.
//
// Then, per pair (the TPU kernels composite.py:59-103, composite2.py:81-148):
//   q = max(c - b^2 / a, 0),  disc = (e^2 - q) / a,  t_near = -b/a - sqrt(disc)
//   hit = disc >= 0 and t_near > 0,  alpha = min(opac exp(-q / 2), 0.9999),
//   zeroed once the ray's count of hits with alpha > 0 passes max_depth,
//   L += exp(log_beta) alpha max(basis . sh + 0.5, 0) while log_beta > log(beta_kill),
//   log_beta += log1p(-alpha).
// The TPU kernels' triangular 0/1 matmul cumsums and the bf16 hi/lo split of
// log(1 - alpha) become each ray's running f32 sums; their transposed dot
// layouts become plain loops.
//
// q = c - b^2 / a cancels (c reaches 1e6-1e7 at small primitive scales), so
// a, b and c are formed in the plain version's fixed order, each product and
// sum rounded once: the files are built with -fmad=false (kernels/_build.py).
// Then the kernels and the plain versions take the same hit decisions and
// differ by the ulps of expf / log1pf and the order of later sums.
//
// The forward (composite12_fwd.cuh) and the backward (composite12_bwd.cuh)
// walk each ray's columns in stream order and take every hit, cap and
// beta_kill decision through the functions here (pair_hit_walk, pair_hit).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace composite12 {

constexpr int kFeat = 16;  // columns of the [.., 16] feature tables
constexpr int kRec = 12;   // floats per staged column record
constexpr int kSH = 16;    // SH coefficients per channel block of sh3
constexpr int kMaxRays = 1024;
constexpr unsigned kFull = 0xffffffffu;

// SH constants (volprim_tpu/ops/sh.py), as f32
constexpr float kC0 = 0.28209479177387814f, kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

// Everything a launch passes: pointers (unused ones are null) and sizes.
struct Args {
  const float* ray0;  // V1: fa [T, R, 16]; V2: d8 [T, R, 8]
  const float* ray1;  // V1: fb
  const float* ray2;  // V1: fc
  const float* ray3;  // V1: basis [T, R, 16]
  const float* pf;    // [T, S, 16]
  const float* col;   // V1: opac [T, 1, S]; V2: aux [T, 2, S]
  const float* sh3;   // [T, S, 48], channel-major blocks of 16
  float* out_l;       // [T, R, 3]
  float* out_beta;    // [T, R]
  const float* g_l;   // [T, R, 3]
  const float* g_beta;  // [T, R]
  float* lb_scr;      // [T, S / seg, R] per-segment carries
  int* cnt_scr;       // [T, S / seg, R]
  float* gpf;         // [T, S, 16]
  float* gcol;        // V1: gopac [T, 1, S]; V2: gaux [T, 2, S]
  float* gsh;         // [T, S, 48]
  int R, S, seg;
  float e2;  // extent^2 (not halved: v1 and v2 use the full M)
  int max_depth;
  float log_kill;
};

// SH basis of a unit direction, degree from K, l-major then m = -l..l,
// with the true constant Y00 in column 0 (the same operation order as
// ops/sh.basis_columns).
template <int K>
__device__ __forceinline__ void sh_basis(float dx, float dy, float dz,
                                         float* out) {
  out[0] = kC0;
  if (K >= 4) {
    out[1] = -kC1 * dy;
    out[2] = kC1 * dz;
    out[3] = -kC1 * dx;
  }
  if (K >= 9) {
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    out[4] = kC20 * dx * dy;
    out[5] = kC21 * dy * dz;
    out[6] = kC22 * (2.0f * zz - xx - yy);
    out[7] = kC23 * dx * dz;
    out[8] = kC24 * (xx - yy);
  }
  if (K >= 16) {
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    out[9] = kC30 * dy * (3.0f * xx - yy);
    out[10] = kC31 * dx * dy * dz;
    out[11] = kC32 * dy * (4.0f * zz - xx - yy);
    out[12] = kC33 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    out[13] = kC34 * dx * (4.0f * zz - xx - yy);
    out[14] = kC35 * dz * (xx - yy);
    out[15] = kC36 * dx * (xx - 3.0f * yy);
  }
}

// v1: column record [p0..p9, opac, 0]; a, b, c = fa . p, fb . p, fc . p
// over features 0..9. The ray holds fa, fb, fc; the basis [T, R, 16] is an
// input that each kernel reads itself.
struct V1 {
  struct Ray {
    float fa[10], fb[10], fc[10];
  };
  __device__ static void load_ray(const Args& A, int t, int r, bool ok,
                                  Ray& ray) {
    const size_t o = (static_cast<size_t>(t) * A.R + r) * kFeat;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      ray.fa[i] = ok ? A.ray0[o + i] : 0.0f;
      ray.fb[i] = ok ? A.ray1[o + i] : 0.0f;
      ray.fc[i] = ok ? A.ray2[o + i] : 0.0f;
    }
  }
  __device__ static float record(const Args& A, int t, int col, int i) {
    const size_t tc = static_cast<size_t>(t) * A.S + col;
    if (i < 10) return A.pf[tc * kFeat + i];
    return i == 10 ? A.col[tc] : 0.0f;
  }
  // any ray type with fa, fb, fc (the backward's also carries its basis)
  template <class R>
  __device__ static void coeffs(const R& r, const float4 m0, const float4 m1,
                                const float4 m2, float& a, float& b,
                                float& c) {
    const float p[10] = {m0.x, m0.y, m0.z, m0.w, m1.x,
                         m1.y, m1.z, m1.w, m2.x, m2.y};
    a = r.fa[0] * p[0];
    b = r.fb[0] * p[0];
    c = r.fc[0] * p[0];
#pragma unroll
    for (int i = 1; i < 10; ++i) {
      a = a + r.fa[i] * p[i];
      b = b + r.fb[i] * p[i];
      c = c + r.fc[i] * p[i];
    }
  }
};

// v2: column record [M6, U, c0, opac, 0]; a = F6(d) . M6 (0..5),
// b = d . U (0..2), c = c0. The basis is built from d.
template <int K>
struct V2 {
  static constexpr int kK = K;
  struct Ray {
    float d[3], f6[6], basis[K];
  };
  __device__ static void load_ray(const Args& A, int t, int r, bool ok,
                                  Ray& ray) {
    const size_t o = (static_cast<size_t>(t) * A.R + r) * 8;
    const float dx = ok ? A.ray0[o] : 0.0f, dy = ok ? A.ray0[o + 1] : 0.0f,
                dz = ok ? A.ray0[o + 2] : 0.0f;
    ray.d[0] = dx;
    ray.d[1] = dy;
    ray.d[2] = dz;
    ray.f6[0] = dx * dx;
    ray.f6[1] = dy * dy;
    ray.f6[2] = dz * dz;
    ray.f6[3] = dx * dy;
    ray.f6[4] = dx * dz;
    ray.f6[5] = dy * dz;
    sh_basis<K>(dx, dy, dz, ray.basis);
  }
  __device__ static float record(const Args& A, int t, int col, int i) {
    const size_t tc = static_cast<size_t>(t) * A.S + col;
    if (i < 9) return A.pf[tc * kFeat + i];
    const float* aux = A.col + static_cast<size_t>(t) * 2 * A.S;
    if (i == 9) return aux[A.S + col];  // c0
    return i == 10 ? aux[col] : 0.0f;   // opacity
  }
  __device__ static void coeffs(const Ray& r, const float4 m0, const float4 m1,
                                const float4 m2, float& a, float& b,
                                float& c) {
    a = r.f6[0] * m0.x;
    a = a + r.f6[1] * m0.y;
    a = a + r.f6[2] * m0.z;
    a = a + r.f6[3] * m0.w;
    a = a + r.f6[4] * m1.x;
    a = a + r.f6[5] * m1.y;
    b = r.d[0] * m1.z;
    b = b + r.d[1] * m1.w;
    b = b + r.d[2] * m2.x;
    c = m2.y;
  }
};

// The pair after its coefficients (the plain versions' pair_terms).
struct Hit {
  float q_raw, dens, raw, alpha;
};

__device__ __forceinline__ bool pair_hit(float a, float b, float c,
                                         float opac, float e2, Hit& h) {
  h.q_raw = c - b * b / a;
  const float q = fmaxf(h.q_raw, 0.0f);
  const float disc = (e2 - q) / a;
  const float t_near = -b / a - sqrtf(fmaxf(disc, 0.0f));
  if (!(disc >= 0.0f && t_near > 0.0f)) return false;
  h.dens = expf(-0.5f * q);
  h.raw = opac * h.dens;
  h.alpha = fminf(h.raw, 0.9999f);
  return true;
}

// pair_hit's miss, decided early. Where 0 < a < 1e20 e2 and e2 - q < 0,
// |e2 - q| is at least e2's f32 spacing (or e2), so disc = (e2 - q) / a is
// negative and not 0, and pair_hit returns false: the same decision,
// without its two further divides and square root (most pairs miss so).
__device__ __forceinline__ bool early_miss(float a, float b, float c,
                                           float e2) {
  const float q = fmaxf(c - b * b / a, 0.0f);
  return a > 0.0f && a < 1e20f * e2 && e2 - q < 0.0f;
}

// pair_hit with the early miss: the hit decision of both walks, the
// forward's and the backward's, so that they take the same hits.
__device__ __forceinline__ bool pair_hit_walk(float a, float b, float c,
                                              float opac, float e2, Hit& h) {
  if (early_miss(a, b, c, e2)) return false;
  return pair_hit(a, b, c, opac, e2, h);
}

// basis . sh of one channel over the first n (<= K) basis columns, summed
// k = 0, 1, ..., then + 0.5: the emission of the forward and the backward
// alike. Bits of `live` clear mark basis columns that are 0 for every ray
// of the warp (the backward's live_columns; v1's 16-column basis carries
// 16 - k zero columns): their terms are exactly 0 for a finite table, so
// they are skipped. The ray's basis is basis[k * BS]: registers (BS = 1,
// the backward: n = K, the loop unrolled, indices constant) or its column
// of shared rows of stride BS (the forward: n is its block's live count,
// v1's known only at run time, so four columns a step; it passes every
// bit of `live` set, since a test per column costs more in its divergent
// hit path than the exact zeros it would skip).
template <int K, int BS = 1>
__device__ __forceinline__ float emission(const float* basis, const float* sh,
                                          int n, unsigned live) {
  float e = 0.0f;
#pragma unroll (BS == 1 ? K : 4)
  for (int k = 0; k < n; ++k)
    if (live >> k & 1u) e = e + basis[k * BS] * sh[k];
  return e + 0.5f;
}

// The basis columns that are nonzero for some ray of the warp (a
// warp-uniform bit mask; every thread of the warp must call it).
template <int K>
__device__ __forceinline__ unsigned live_columns(const float* basis) {
  unsigned live = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (__any_sync(kFull, basis[k] != 0.0f)) live |= 1u << k;
  return live;
}

// Copies segment columns [col0, col0 + seg) of tile t into shared memory:
// [seg][12] records and, when s_sh is given, [seg][3K] SH rows.
template <class P>
__device__ __forceinline__ void stage(const Args& A, int t, int col0,
                                      float* s_rec, float* s_sh) {
  constexpr int K = P::kK;
  const int tid = threadIdx.x, n = blockDim.x;
  for (int e = tid; e < A.seg * kRec; e += n) {
    const int c = e / kRec;
    s_rec[e] = P::record(A, t, col0 + c, e - c * kRec);
  }
  if (s_sh == nullptr) return;
  const float* sht = A.sh3 + (static_cast<size_t>(t) * A.S + col0) * 3 * kSH;
  for (int e = tid; e < A.seg * 3 * K; e += n) {
    const int c = e / (3 * K), j = e - c * 3 * K, ch = j / K, k = j - ch * K;
    s_sh[e] = sht[static_cast<size_t>(c) * 3 * kSH + ch * kSH + k];
  }
}

__device__ __forceinline__ void load_record(const float* s_rec, int c,
                                            float4& m0, float4& m1,
                                            float4& m2) {
  const float4* rec = reinterpret_cast<const float4*>(s_rec + c * kRec);
  m0 = rec[0];
  m1 = rec[1];
  m2 = rec[2];  // m2.z is the opacity
}

inline bool bad_sizes(int T, const Args& A) {
  return T < 0 || A.R < 1 || A.R > kMaxRays || A.seg < 1 || A.S < A.seg ||
         A.S % A.seg != 0;
}

}  // namespace composite12
