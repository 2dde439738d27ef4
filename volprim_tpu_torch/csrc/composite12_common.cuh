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
// One block per tile, one thread per ray (R <= 1024). Each segment's columns
// are staged in shared memory as 12-float records (the live features and
// the opacity) and 3K-float SH rows; every thread walks them in stream order.
// What bounds it on this card: FP32 issue per (ray, column) pair (the
// pair math runs for all of the tile's S columns; v1 and v2 have no
// compaction) and, in the backward, the per-column reduction over the
// block's rays; not device-memory bytes (a tile's columns are read once per
// walk while every column meets R rays).

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
// over features 0..9. The basis is an input with all 16 columns.
struct V1 {
  static constexpr int kK = kSH;
  static constexpr int kGrad = 10;  // gpf rows written (10-15 are 0)
  static constexpr int kCol = 1;    // column adjoint rows: opacity
  struct Ray {
    float fa[10], fb[10], fc[10], basis[kK];
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
#pragma unroll
    for (int k = 0; k < kK; ++k) ray.basis[k] = ok ? A.ray3[o + k] : 0.0f;
  }
  __device__ static float record(const Args& A, int t, int col, int i) {
    const size_t tc = static_cast<size_t>(t) * A.S + col;
    if (i < 10) return A.pf[tc * kFeat + i];
    return i == 10 ? A.col[tc] : 0.0f;
  }
  __device__ static void coeffs(const Ray& r, const float4 m0, const float4 m1,
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
  // adjoint of feature row i: fa g_a + fb g_b + fc g_c (g_c = g_q)
  __device__ static float grad_row(const Ray& r, int i, float g_a, float g_b,
                                   float g_q) {
    return r.fa[i] * g_a + r.fb[i] * g_b + r.fc[i] * g_q;
  }
  __device__ static void col_rows(float g_op, float /*g_q*/, float* v) {
    v[0] = g_op;
  }
  __device__ static void write_col(const Args& A, int t, int col,
                                   const float* acc) {
    A.gcol[static_cast<size_t>(t) * A.S + col] = acc[0];
  }
  __device__ static void zero_col(const Args& A, int t, int col) {
    A.gcol[static_cast<size_t>(t) * A.S + col] = 0.0f;
  }
};

// v2: column record [M6, U, c0, opac, 0]; a = F6(d) . M6 (0..5),
// b = d . U (0..2), c = c0. The basis is built from d.
template <int K>
struct V2 {
  static constexpr int kK = K;
  static constexpr int kGrad = 9;  // gpf rows written: M6, U (9-15 are 0)
  static constexpr int kCol = 2;   // column adjoint rows: opacity, c0
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
  __device__ static float grad_row(const Ray& r, int i, float g_a, float g_b,
                                   float /*g_q*/) {
    return i < 6 ? r.f6[i] * g_a : r.d[i >= 6 ? i - 6 : 0] * g_b;
  }
  // opacity, then c0, whose adjoint is g_q (c = c0)
  __device__ static void col_rows(float g_op, float g_q, float* v) {
    v[0] = g_op;
    v[1] = g_q;
  }
  __device__ static void write_col(const Args& A, int t, int col,
                                   const float* acc) {
    float* g = A.gcol + static_cast<size_t>(t) * 2 * A.S;
    g[col] = acc[0];
    g[A.S + col] = acc[1];
  }
  __device__ static void zero_col(const Args& A, int t, int col) {
    float* g = A.gcol + static_cast<size_t>(t) * 2 * A.S;
    g[col] = 0.0f;
    g[A.S + col] = 0.0f;
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

// basis . sh of one channel, summed over k = 0, 1, ..., then + 0.5. Bits
// of `live` clear mark basis columns that are 0 for every ray of the warp
// (v1's 16-column basis carries 16 - k zero columns): their terms are
// exactly 0 for a finite table, so they are skipped.
template <int K>
__device__ __forceinline__ float emission(const float* basis, const float* sh,
                                          unsigned live) {
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live >> k & 1u) e = e + basis[k] * sh[k];
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

template <class P>
__global__ void __launch_bounds__(kMaxRays) fwd_kernel(const Args A) {
  constexpr int K = P::kK;
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;
  float* s_sh = s_rec + A.seg * kRec;
  const int t = blockIdx.x, tid = threadIdx.x;
  const bool ray_ok = tid < A.R;
  typename P::Ray ray;
  P::load_ray(A, t, tid, ray_ok, ray);
  const unsigned live = live_columns<K>(ray.basis);

  float log_beta = 0.0f, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int count = 0;
  const int n_seg = A.S / A.seg;
  for (int si = 0; si < n_seg; ++si) {
    const bool active = ray_ok && count <= A.max_depth;
    // also the barrier that retires the previous segment's shared reads
    if (!__syncthreads_or(active)) break;  // every ray capped: alpha 0 on
    stage<P>(A, t, si * A.seg, s_rec, s_sh);
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < A.seg; ++c) {
      float4 m0, m1, m2;
      load_record(s_rec, c, m0, m1, m2);
      float a, b, cc;
      P::coeffs(ray, m0, m1, m2, a, b, cc);
      Hit h;
      if (!pair_hit(a, b, cc, m2.z, A.e2, h)) continue;
      if (!(h.alpha > 0.0f)) continue;
      if (++count > A.max_depth) break;  // capped: every later alpha is 0
      if (log_beta > A.log_kill) {
        const float w = expf(log_beta) * h.alpha;
        const float* shc = s_sh + c * 3 * K;
        l0 = l0 + w * fmaxf(emission<K>(ray.basis, shc, live), 0.0f);
        l1 = l1 + w * fmaxf(emission<K>(ray.basis, shc + K, live), 0.0f);
        l2 = l2 + w * fmaxf(emission<K>(ray.basis, shc + 2 * K, live), 0.0f);
      }
      // past the beta_kill cutoff beta still falls: it is an output
      log_beta = log_beta + log1pf(-h.alpha);
    }
  }
  if (ray_ok) {
    const size_t o = static_cast<size_t>(t) * A.R + tid;
    A.out_l[3 * o + 0] = l0;
    A.out_l[3 * o + 1] = l1;
    A.out_l[3 * o + 2] = l2;
    A.out_beta[o] = expf(log_beta);
  }
}

// The backward (composite_vjp.py:48 / composite2.py:159), per tile and ray:
//   1. the forward walk without emission, storing each ray's (log beta, hit
//      count) at each segment start in lb_scr / cnt_scr; g_lb = g_beta beta;
//   2. segments in reverse, each walked twice from its stored carry:
//      walk A sums g_lw = g_w w over the segment (g_w = g_L . max(e, 0));
//      walk B takes, at each hit under the cap (alpha = 0 hits included,
//      as the TPU kernel's depth_ok & hit mask does),
//        g_logt  = g_lb_next + (sum_seg g_lw - prefix_incl g_lw)   (f64 sums)
//        g_alpha = [alive] g_w exp(lw) - g_logt / (1 - alpha)
//        g_raw = [raw < 0.9999] g_alpha, g_opac = g_raw dens,
//        g_q = [q_raw > 0] g_raw opac dens (-1/2),
//        g_a = g_q b^2 / a^2, g_b = g_q (-2 b / a), g_c = g_q,
//        g_sh[ch][k] = basis[k] [e_ch > 0] g_L[ch] w;
//      then g_lb_prev = g_lb_next + sum_seg g_lw;
//   3. per column the block's rays are summed: a warp skips a column none of
//      its rays contributes to (__any_sync), else reduces each adjoint row
//      with shuffles and one lane adds it into a [seg][rows] shared
//      accumulator with shared atomics (so the last f32 bits vary from run
//      to run); the accumulator is written out at the segment's end.
template <class P>
__global__ void __launch_bounds__(kMaxRays) bwd_kernel(const Args A) {
  constexpr int K = P::kK;
  constexpr int kAcc = P::kGrad + P::kCol + 3 * K;
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;
  float* s_sh = s_rec + A.seg * kRec;
  float* s_acc = s_sh + A.seg * 3 * K;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n = blockDim.x;
  const bool ray_ok = tid < A.R;
  const int n_seg = A.S / A.seg;
  typename P::Ray ray;
  P::load_ray(A, t, tid, ray_ok, ray);
  const unsigned live = live_columns<K>(ray.basis);
  float gl0 = 0.0f, gl1 = 0.0f, gl2 = 0.0f, gbeta = 0.0f;
  if (ray_ok) {
    const size_t o = static_cast<size_t>(t) * A.R + tid;
    gl0 = A.g_l[3 * o + 0];
    gl1 = A.g_l[3 * o + 1];
    gl2 = A.g_l[3 * o + 2];
    gbeta = A.g_beta[o];
  }
  float* lbt = A.lb_scr + static_cast<size_t>(t) * n_seg * A.R;
  int* cntt = A.cnt_scr + static_cast<size_t>(t) * n_seg * A.R;

  // ---- 1. forward pass: per-segment carries -----------------------------
  float log_beta = 0.0f;
  int count = 0;
  int nwalk = n_seg;  // segments some ray of the tile enters under its cap
  for (int si = 0; si < n_seg; ++si) {
    const bool active = ray_ok && count <= A.max_depth;
    if (!__syncthreads_or(active)) {
      nwalk = si;
      break;
    }
    if (ray_ok) {
      lbt[si * A.R + tid] = log_beta;
      cntt[si * A.R + tid] = count;
    }
    stage<P>(A, t, si * A.seg, s_rec, nullptr);
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < A.seg; ++c) {
      float4 m0, m1, m2;
      load_record(s_rec, c, m0, m1, m2);
      float a, b, cc;
      P::coeffs(ray, m0, m1, m2, a, b, cc);
      Hit h;
      if (!pair_hit(a, b, cc, m2.z, A.e2, h)) continue;
      if (!(h.alpha > 0.0f)) continue;
      if (++count > A.max_depth) break;
      log_beta = log_beta + log1pf(-h.alpha);
    }
  }
  float g_lb = gbeta * expf(log_beta);

  // ---- 2. segments in reverse ---------------------------------------------
  for (int si = n_seg - 1; si >= 0; --si) {
    const int col0 = si * A.seg;
    __syncthreads();  // the previous segment's shared reads are done
    if (si >= nwalk) {
      // no ray of the tile enters this segment under its cap: zero adjoints
      for (int e = tid; e < A.seg * kFeat; e += n) {
        const int c = e / kFeat;
        A.gpf[(static_cast<size_t>(t) * A.S + col0 + c) * kFeat + e - c * kFeat] = 0.0f;
      }
      for (int e = tid; e < A.seg * 3 * kSH; e += n) {
        const int c = e / (3 * kSH);
        A.gsh[(static_cast<size_t>(t) * A.S + col0 + c) * 3 * kSH + e - c * 3 * kSH] = 0.0f;
      }
      for (int c = tid; c < A.seg; c += n) P::zero_col(A, t, col0 + c);
      continue;
    }
    stage<P>(A, t, col0, s_rec, s_sh);
    for (int e = tid; e < A.seg * kAcc; e += n) s_acc[e] = 0.0f;
    __syncthreads();

    float lb0 = 0.0f;
    int cnt0 = A.max_depth + 1;
    if (ray_ok) {
      lb0 = lbt[si * A.R + tid];
      cnt0 = cntt[si * A.R + tid];
    }

    // walk A: sum of g_lw over the segment (f64, see walk B)
    double sum_glw = 0.0;
    if (cnt0 <= A.max_depth) {
      float lb = lb0;
      int cnt = cnt0;
      for (int c = 0; c < A.seg; ++c) {
        float4 m0, m1, m2;
        load_record(s_rec, c, m0, m1, m2);
        float a, b, cc;
        P::coeffs(ray, m0, m1, m2, a, b, cc);
        Hit h;
        if (!pair_hit(a, b, cc, m2.z, A.e2, h)) continue;
        if (!(h.alpha > 0.0f)) continue;
        if (++cnt > A.max_depth) break;
        if (lb > A.log_kill) {
          const float w = expf(lb) * h.alpha;
          const float* shc = s_sh + c * 3 * K;
          const float g_w =
              gl0 * fmaxf(emission<K>(ray.basis, shc, live), 0.0f) +
              gl1 * fmaxf(emission<K>(ray.basis, shc + K, live), 0.0f) +
              gl2 * fmaxf(emission<K>(ray.basis, shc + 2 * K, live), 0.0f);
          sum_glw += static_cast<double>(g_w * w);
        }
        lb = lb + log1pf(-h.alpha);
      }
    }

    // walk B: per-pair adjoints, reduced over the block per column
    {
      float lb = lb0;
      int cnt = cnt0;
      bool done = cnt0 > A.max_depth;
      // the suffix sum of g_lw is the total less the inclusive prefix, both
      // in f64: in f32 the difference of two long sums loses the small
      // suffixes at a segment's end
      double prefix = 0.0;
      for (int c = 0; c < A.seg; ++c) {
        if (!__any_sync(kFull, !done)) break;  // the whole warp is capped
        bool has = false, has_sh = false;
        float g_a = 0.0f, g_b = 0.0f, g_q = 0.0f, g_op = 0.0f;
        float ge0 = 0.0f, ge1 = 0.0f, ge2 = 0.0f;
        const float* shc = s_sh + c * 3 * K;
        if (!done) {
          float4 m0, m1, m2;
          load_record(s_rec, c, m0, m1, m2);
          float a, b, cc;
          P::coeffs(ray, m0, m1, m2, a, b, cc);
          Hit h;
          if (pair_hit(a, b, cc, m2.z, A.e2, h)) {
            if (h.alpha > 0.0f) ++cnt;
            if (cnt > A.max_depth) {
              done = true;  // this pair and every later one: alpha 0
            } else {
              has = true;
              const bool alive = lb > A.log_kill;
              float g_w = 0.0f, exp_lw = 0.0f, w = 0.0f;
              if (alive) {
                exp_lw = expf(lb);
                w = exp_lw * h.alpha;
                const float e0 = emission<K>(ray.basis, shc, live);
                const float e1 = emission<K>(ray.basis, shc + K, live);
                const float e2 = emission<K>(ray.basis, shc + 2 * K, live);
                g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                      gl2 * fmaxf(e2, 0.0f);
                ge0 = e0 > 0.0f ? gl0 * w : 0.0f;
                ge1 = e1 > 0.0f ? gl1 * w : 0.0f;
                ge2 = e2 > 0.0f ? gl2 * w : 0.0f;
                has_sh = true;
              }
              const float g_lw = g_w * w;
              prefix += static_cast<double>(g_lw);
              const float g_logt = g_lb + static_cast<float>(sum_glw - prefix);
              const float g_alpha = (alive ? g_w * exp_lw : 0.0f) +
                                    g_logt * (-1.0f / (1.0f - h.alpha));
              const float g_raw = h.raw < 0.9999f ? g_alpha : 0.0f;
              g_op = g_raw * h.dens;
              g_q = h.q_raw > 0.0f ? g_raw * m2.z * h.dens * (-0.5f) : 0.0f;
              g_a = g_q * (b * b) / (a * a);
              g_b = g_q * (-2.0f * b / a);
              if (h.alpha > 0.0f) lb = lb + log1pf(-h.alpha);
            }
          }
        }
        float* dst = s_acc + c * kAcc;
        if (__any_sync(kFull, has)) {
#pragma unroll
          for (int i = 0; i < P::kGrad; ++i) {
            const float v = warp_sum(P::grad_row(ray, i, g_a, g_b, g_q));
            if (lane == 0) atomicAdd(dst + i, v);
          }
          float cv[P::kCol];
          P::col_rows(g_op, g_q, cv);
#pragma unroll
          for (int i = 0; i < P::kCol; ++i) {
            const float v = warp_sum(cv[i]);
            if (lane == 0) atomicAdd(dst + P::kGrad + i, v);
          }
        }
        if (__any_sync(kFull, has_sh)) {
          float* dsh = dst + P::kGrad + P::kCol;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (!(live >> k & 1u)) continue;  // exactly 0 for the whole warp
            const float v0 = warp_sum(ray.basis[k] * ge0);
            const float v1 = warp_sum(ray.basis[k] * ge1);
            const float v2 = warp_sum(ray.basis[k] * ge2);
            if (lane == 0) {
              atomicAdd(dsh + k, v0);
              atomicAdd(dsh + K + k, v1);
              atomicAdd(dsh + 2 * K + k, v2);
            }
          }
        }
      }
    }
    g_lb = g_lb + static_cast<float>(sum_glw);
    __syncthreads();

    // write the segment's adjoints; gpf rows past kGrad and SH past K are 0
    for (int e = tid; e < A.seg * kFeat; e += n) {
      const int c = e / kFeat, i = e - c * kFeat;
      A.gpf[(static_cast<size_t>(t) * A.S + col0 + c) * kFeat + i] =
          i < P::kGrad ? s_acc[c * kAcc + i] : 0.0f;
    }
    for (int e = tid; e < A.seg * 3 * kSH; e += n) {
      const int c = e / (3 * kSH), j = e - c * 3 * kSH, ch = j / kSH,
                k = j - ch * kSH;
      A.gsh[(static_cast<size_t>(t) * A.S + col0 + c) * 3 * kSH + j] =
          k < K ? s_acc[c * kAcc + P::kGrad + P::kCol + ch * K + k] : 0.0f;
    }
    for (int c = tid; c < A.seg; c += n)
      P::write_col(A, t, col0 + c, s_acc + c * kAcc + P::kGrad);
  }
}

inline bool bad_sizes(int T, const Args& A) {
  return T < 0 || A.R < 1 || A.R > kMaxRays || A.seg < 1 || A.S < A.seg ||
         A.S % A.seg != 0;
}

template <class P>
cudaError_t launch_fwd(const Args& A, int T, cudaStream_t stream) {
  if (bad_sizes(T, A)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const int threads = (A.R + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(A.seg) * (kRec + 3 * P::kK) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fwd_kernel<P><<<T, threads, smem, stream>>>(A);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch_bwd(const Args& A, int T, cudaStream_t stream) {
  if (bad_sizes(T, A)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const int threads = (A.R + 31) / 32 * 32;
  constexpr int kAcc = P::kGrad + P::kCol + 3 * P::kK;
  const size_t smem =
      static_cast<size_t>(A.seg) * (kRec + 3 * P::kK + kAcc) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwd_kernel<P><<<T, threads, smem, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace composite12
