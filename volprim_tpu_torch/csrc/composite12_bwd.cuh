// The backward (vector-Jacobian product) of the v1 and v2 tile
// compositors, for Hopper (sm_90a): the kernel of composite_bwd.cu (v1)
// and composite2_bwd.cu (v2), on the pair math of composite12_common.cuh.
//
// Given the forward's inputs and the cotangents g_L [T, R, 3] and
// g_beta [T, R] it writes gpf [T, S, 16] (v1 rows 0-9, v2 rows 0-8; the
// rest 0), the column adjoints gcol (v1: opacity [T, 1, S]; v2: opacity
// and c0 [T, 2, S]) and gsh [T, S, 48] (k live coefficients per channel
// block; the rest 0), as composite_vjp.py:48 / composite2.py:159 do.
// Per tile (one block of NT = 256, 512 or 1024 threads) and ray (one
// thread):
//
//   1. Carry pass over the segments: the forward's walk without emission,
//      storing each ray's (log beta, hit count) at each segment start in
//      lb_scr / cnt_scr; it ends with beta, so g_lb = g_beta beta.
//   2. Segments in reverse, each in two phases:
//      A. one walk of the segment from the ray's stored carry: every hit
//         under the cap (alpha = 0 hits included, as the TPU kernel's
//         depth_ok & hit mask has them) sets its bit in the ray's hit mask
//         in shared memory, and the ray sums g_lw = g_w w in f64
//         (g_w = g_L . max(e, 0); an alpha = 0 hit has w = 0);
//      B. the ray's recorded hits, column chunk by column chunk, in order:
//         alpha, w and the prefix of g_lw are formed again by the same
//         sequence of operations (only at the hits), and
//           g_logt  = g_lb_next + (sum_seg g_lw - prefix_incl g_lw)  (f64)
//           g_alpha = [alive] g_w exp(lw) - g_logt / (1 - alpha)
//           g_raw = [raw < 0.9999] g_alpha,  g_opac = g_raw dens,
//           g_q = [q_raw > 0] g_raw opac dens (-1/2),
//           g_a = g_q b^2 / a^2,  g_b = g_q (-2 b / a),  g_c = g_q,
//           g_e[ch] = [e_ch > 0] g_L[ch] w;
//         the hit leaves seven scalars in shared memory: g_q, g_opac, g_e
//         and two of its pair (v2: g_a, g_b; v1: b / a as h + l, see
//         V1B::HitRows). A column whose opacity is 0 has alpha = 0 for
//         every ray, so its g_q, g_a, g_b and g_e are 0 and the hit leaves
//         g_opac alone.
//      Then one warp per chunk column sums the block's rays in a fixed
//      order: a column of opacity 0 sums g_opac (each lane its rays in
//      order, then a butterfly over the lanes) and writes 0 to its other
//      rows; any other column's hits go to the lanes in ray order (hit i to
//      lane i mod 32), each lane adds its hits' rows
//        v1: fa[i] g_a + fb[i] g_b + fc[i] g_q (i < 10), g_opac,
//        v2: F6_i(d) g_a (i < 6), d g_b, g_opac, g_q (c0),
//        SH: basis[k] g_e[ch],
//      reading the ray's features from device memory (they stay in L1),
//      and the lanes' sums are added in lane order through shared memory.
//      v1's three terms cancel where c = fc . p is large, so a hit's
//      feature row is formed with their rounding errors carried
//      (V1B::HitRows): the kernel lies nearer an f64 run than the plain
//      version's three products do.
//      No atomics: gpf, gcol and gsh are bit-reproducible.
//      Then g_lb_prev = g_lb_next + sum_seg g_lw.
//
// Every hit, cap and beta_kill decision is the forward's (both evaluate the
// pair with composite12_common.cuh and are built with -fmad=false; the
// carries are the same sequential f32 sums of log1p(-alpha)).
//
// What bounds it on this card: FP32 issue per (ray, column) pair, which
// the design walks twice (the carry pass and phase A), not device-memory
// bytes. A block of 256 threads keeps its registers at 128 and its shared
// memory near 100 KB at k = 4, so two fit on an SM; the SH staging and
// adjoints take the k live basis columns only (v1's wrapper finds k in
// the basis).

#pragma once

#include <type_traits>

#include "composite12_common.cuh"

// Timing ablations of the phases (scripts/bwd12_phases.py builds them; the
// results are wrong by design): 1 skips the column sums, 2 also phase B,
// 3 also phase A. The path's build leaves it 0.
#ifndef BWD12_ABL
#define BWD12_ABL 0
#endif

namespace composite12 {

constexpr int kScal = 7;  // two of the pair, g_q, g_opac, g_e (3) per hit

// columns per phase-B chunk: the scalars [CH][7][NT] take 56 KB
template <int NT>
__host__ __device__ constexpr int bwd_chunk() {
  return 2048 / NT;
}

// blocks per SM the register budget is sized for
template <int NT>
__host__ __device__ constexpr int bwd_min_blocks() {
  return NT == 256 ? 2 : 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// the position of the k-th (0-based) set bit of m (which has more than k)
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// v1's backward policy: the forward's pair math (V1) on a ray that holds
// the k live basis columns only.
template <int K>
struct V1B {
  static constexpr int kK = K;
  static constexpr int kGrad = 10;  // gpf rows written (10-15 are 0)
  static constexpr int kCol = 1;    // column adjoint rows: opacity
  // adjoint rows a column sum forms at a time (12: 0 spills at k = 4)
  static constexpr int kBlock = 12;
  struct Ray {
    float fa[10], fb[10], fc[10], basis[K];
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
    for (int k = 0; k < K; ++k) ray.basis[k] = ok ? A.ray3[o + k] : 0.0f;
  }
  __device__ static float record(const Args& A, int t, int col, int i) {
    return V1::record(A, t, col, i);
  }
  __device__ static void coeffs(const Ray& r, const float4 m0, const float4 m1,
                                const float4 m2, float& a, float& b,
                                float& c) {
    V1::coeffs(r, m0, m1, m2, a, b, c);
  }
  // The two scalars of a hit beside g_q: b / a as h + l (l the rounded
  // remainder), from which the feature rows are formed (HitRows).
  __device__ static void pair_scalars(float /*g_q*/, float a, float b,
                                      float& s0, float& s1) {
    s0 = b / a;
    s1 = __fmaf_rn(-s0, a, b) / a;
  }
  // One hit of a column sum: ray r and its scalars (h, l, g_q, g_opac,
  // g_e). Feature row i is
  //   fa[i] g_a + fb[i] g_b + fc[i] g_q = g_q (fa[i] t1 + fb[i] t2 + fc[i]),
  // t1 = b^2 / a^2, t2 = -2 b / a. The three terms cancel where c = fc . p
  // is large (by 100x at the headline scales), so the bracket is formed
  // from b / a = h + l with the products' and sums' rounding errors
  // carried (FMA and TwoSum): it is then near its exact value for the f32
  // a, b, and the row near an f64 run's, where g_a and g_b rounded to f32
  // would each move it by an f32 ulp of the terms.
  struct HitRows {
    size_t o;  // the ray's row of fa, fb, fc and the basis
    float p, t1_lo, h2, l2, g_q, g_op, ge[3];
    __device__ HitRows(const Args& A, int t, int r, const float* s, int ns) {
      o = (static_cast<size_t>(t) * A.R + r) * kFeat;
      const float h = s[0], l = s[ns];
      p = h * h;  // t1 = p + t1_lo, t2 = h2 + l2
      t1_lo = __fmaf_rn(h, h, -p) + 2.0f * h * l;
      h2 = -2.0f * h;
      l2 = -2.0f * l;
      g_q = s[2 * ns];
      g_op = s[3 * ns];
      ge[0] = s[4 * ns];
      ge[1] = s[5 * ns];
      ge[2] = s[6 * ns];
    }
    // adds this hit's term of row `row` to v
    __device__ float add(const Args& A, int row, float v) const {
      if (row < 10) {
        const float fa = __ldg(A.ray0 + o + row), fb = __ldg(A.ray1 + o + row),
                    fc = __ldg(A.ray2 + o + row);
        const float p1 = fa * p, e1 = __fmaf_rn(fa, p, -p1);
        const float p2 = fb * h2, e2 = __fmaf_rn(fb, h2, -p2);
        const float s1 = p1 + p2, z1 = s1 - p1;
        const float w1 = (p1 - (s1 - z1)) + (p2 - z1);
        const float s2 = s1 + fc, z2 = s2 - s1;
        const float w2 = (s1 - (s2 - z2)) + (fc - z2);
        const float d =
            s2 + (((e1 + e2) + (w1 + w2)) + (fa * t1_lo + fb * l2));
        return __fmaf_rn(g_q, d, v);
      }
      if (row == 10) return v + g_op;
      const int k = (row - 11) % K, ch = (row - 11) / K;
      return __fmaf_rn(__ldg(A.ray3 + o + k), ge[ch], v);
    }
  };
  __device__ static void write_col(const Args& A, size_t tc, int /*i*/,
                                   float v) {
    A.gcol[tc] = v;
  }
};

// v2's backward policy: V2's ray and pair math; F6 and the basis are
// formed again from the direction where a hit's rows need them.
template <int K>
struct V2B : V2<K> {
  static constexpr int kGrad = 9;  // gpf rows written: M6, U (9-15 are 0)
  static constexpr int kCol = 2;   // column adjoint rows: opacity, c0
  static constexpr int kBlock = 32;  // rows a column sum forms at a time
  // the two scalars of a hit beside g_q: g_a and g_b
  __device__ static void pair_scalars(float g_q, float a, float b, float& s0,
                                      float& s1) {
    s0 = g_q * (b * b) / (a * a);
    s1 = g_q * (-2.0f * b / a);
  }
  // one hit of a column sum: ray r's direction and its scalars
  // (g_a, g_b, g_q, g_opac, g_e); F6 and the basis are formed again
  struct HitRows {
    float d[3], f6[6], basis[K], g_a, g_b, g_q, g_op, ge[3];
    __device__ HitRows(const Args& A, int t, int r, const float* s, int ns) {
      const float* dr = A.ray0 + (static_cast<size_t>(t) * A.R + r) * 8;
      const float dx = __ldg(dr), dy = __ldg(dr + 1), dz = __ldg(dr + 2);
      d[0] = dx;
      d[1] = dy;
      d[2] = dz;
      f6[0] = dx * dx;
      f6[1] = dy * dy;
      f6[2] = dz * dz;
      f6[3] = dx * dy;
      f6[4] = dx * dz;
      f6[5] = dy * dz;
      sh_basis<K>(dx, dy, dz, basis);
      g_a = s[0];
      g_b = s[ns];
      g_q = s[2 * ns];
      g_op = s[3 * ns];
      ge[0] = s[4 * ns];
      ge[1] = s[5 * ns];
      ge[2] = s[6 * ns];
    }
    // adds this hit's term of row `row` (M6, U, opacity, c0 = c, SH) to v
    __device__ float add(const Args& /*A*/, int row, float v) const {
      if (row < 6) return __fmaf_rn(f6[row], g_a, v);
      if (row < 9) return __fmaf_rn(d[row - 6], g_b, v);
      if (row == 9) return v + g_op;
      if (row == 10) return v + g_q;
      const int k = (row - 11) % K, ch = (row - 11) / K;
      return __fmaf_rn(basis[k], ge[ch], v);
    }
  };
  __device__ static void write_col(const Args& A, size_t tc, int i, float v) {
    const size_t t = tc / A.S, col = tc - t * A.S;
    A.gcol[(2 * t + i) * A.S + col] = v;
  }
};

template <int V, int K>
using PolicyB = std::conditional_t<V == 1, V1B<K>, V2B<K>>;

// Writes row `row` of column tc's adjoints: gpf rows, then the column
// rows, then the SH rows (channel-major blocks of K).
template <class P>
__device__ __forceinline__ void write_row(const Args& A, size_t tc, int row,
                                          float v) {
  constexpr int K = P::kK;
  if (row < P::kGrad) {
    A.gpf[tc * kFeat + row] = v;
  } else if (row < P::kGrad + P::kCol) {
    P::write_col(A, tc, row - P::kGrad, v);
  } else {
    const int j = row - P::kGrad - P::kCol, ch = j / K;
    A.gsh[tc * 3 * kSH + ch * kSH + j - ch * K] = v;
  }
}

// Writes 0 to every adjoint of column tc that no hit row covers (gpf rows
// past kGrad, SH coefficients past K) and, with `all`, to every row.
template <class P>
__device__ __forceinline__ void write_zeros(const Args& A, size_t tc, int lane,
                                            bool all) {
  constexpr int K = P::kK;
  if (lane < kFeat && (all || lane >= P::kGrad)) A.gpf[tc * kFeat + lane] = 0.0f;
  for (int e = lane; e < 3 * kSH; e += 32)
    if (all || (e & (kSH - 1)) >= K) A.gsh[tc * 3 * kSH + e] = 0.0f;
  if (all && lane < P::kCol) P::write_col(A, tc, lane, 0.0f);
}

// Whether a column sum forms all its rows in one pass (kBlock at least its
// rows): then it needs no lane-sum area of its own
template <class P>
__host__ __device__ constexpr bool one_pass() {
  return P::kGrad + P::kCol + 3 * P::kK <= P::kBlock;
}

// Sums column j of the segment (tile column col) over the block's rays and
// writes its adjoints; `sc` is the column's scalars [7][NT]. Every lane of
// the warp calls it.
template <class P, int NT>
__device__ __forceinline__ void column_sum(const Args& A, int t, int col,
                                           int j, const unsigned* s_hit,
                                           unsigned* s_cm, float* sc,
                                           float* red, float opac, int lane) {
  constexpr int K = P::kK;
  constexpr int kRows = P::kGrad + P::kCol + 3 * K;
  constexpr int kGroups = NT / 32;
  const size_t tc = static_cast<size_t>(t) * A.S + col;
  // the column's hits: one ballot word per 32 rays, kept in s_cm
  int total = 0;
  const int wd = j >> 5, bit = j & 31;
  for (int g = 0; g < kGroups; ++g) {
    const unsigned b =
        __ballot_sync(kFull, (s_hit[wd * NT + g * 32 + lane] >> bit) & 1u);
    if (lane == 0) s_cm[g] = b;
    total += __popc(b);
  }
  if (total == 0) {
    write_zeros<P>(A, tc, lane, true);
    return;
  }
  __syncwarp();
  if (opac == 0.0f) {
    // alpha = 0 for every ray: only the opacity row, sum of g_opac
    float v = 0.0f;
    for (int g = 0; g < kGroups; ++g)
      if ((s_cm[g] >> lane) & 1u) v += sc[3 * NT + g * 32 + lane];
    v = warp_sum(v);
    write_zeros<P>(A, tc, lane, true);
    if (lane == 0) P::write_col(A, tc, 0, v);
    return;
  }
  // the hits go to the lanes in ray order (hit i to lane i mod 32); each
  // lane sums its hits' terms of kBlock rows at a time, and the lanes' sums
  // are added in lane order through [32][kBlock + 1]: the warp's `red`, or
  // in one pass the column's scalars (read by then)
  constexpr int kBlock = P::kBlock;
  if (one_pass<P>()) red = sc;
  const int nl = min(total, 32);
#pragma unroll
  for (int lo = 0; lo < kRows; lo += kBlock) {
    float acc[kBlock];
#pragma unroll
    for (int i = 0; i < kBlock; ++i) acc[i] = 0.0f;
    for (int i = lane; i < total; i += 32) {
      int k = i, r = 0;  // the ray of the column's i-th hit
#pragma unroll 1
      for (int g = 0; g < kGroups; ++g) {
        const unsigned m = s_cm[g];
        const int c = __popc(m);
        if (k < c) {
          r = g * 32 + nth_set_bit(m, k);
          break;
        }
        k -= c;
      }
      const typename P::HitRows hit(A, t, r, sc + r, NT);
#pragma unroll
      for (int q = 0; q < kBlock; ++q)
        if (lo + q < kRows) acc[q] = hit.add(A, lo + q, acc[q]);
    }
    __syncwarp();
    if (lane < nl) {
#pragma unroll
      for (int q = 0; q < kBlock; ++q) red[lane * (kBlock + 1) + q] = acc[q];
    }
    __syncwarp();
    if (lane < kBlock && lo + lane < kRows) {
      float v = 0.0f;
      for (int i = 0; i < nl; ++i) v += red[i * (kBlock + 1) + lane];
      write_row<P>(A, tc, lo + lane, v);
    }
    __syncwarp();
  }
  write_zeros<P>(A, tc, lane, false);
}

template <int V, int K, int NT>
__global__ void __launch_bounds__(NT, bwd_min_blocks<NT>())
    bwd12_kernel(const Args A) {
  using P = PolicyB<V, K>;
  constexpr int CH = bwd_chunk<NT>();
  constexpr int kWarps = NT / 32;
  extern __shared__ __align__(16) float smem[];
  const int nwords = (A.seg + 31) >> 5;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  // staged records [seg][12] and SH rows [seg][3K], the hit masks
  // [nwords][NT], the chunk's scalars [CH][7][NT], the column sums' ballot
  // words [warps][warps], the column sums' lane sums [CH][32][kBlock + 1]
  // (none in one pass)
  constexpr int kBlock = P::kBlock;
  float* s_rec = smem;
  float* s_sh = s_rec + A.seg * kRec;
  unsigned* s_hit = reinterpret_cast<unsigned*>(s_sh + A.seg * 3 * K);
  float* s_scal = reinterpret_cast<float*>(s_hit + nwords * NT);
  unsigned* s_cm =
      reinterpret_cast<unsigned*>(s_scal + CH * kScal * NT) + warp * kWarps;
  float* s_red = reinterpret_cast<float*>(s_cm - warp * kWarps + kWarps * kWarps) +
                 min(warp, CH - 1) * 32 * (kBlock + 1);

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

  // ---- 1. carry pass: per-segment (log beta, count) ------------------------
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
      if (m2.z == 0.0f) continue;  // opacity 0: alpha 0 at a hit
      float a, b, cc;
      P::coeffs(ray, m0, m1, m2, a, b, cc);
      Hit h;
      if (!pair_hit_walk(a, b, cc, m2.z, A.e2, h)) continue;
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
      for (int c = warp; c < A.seg; c += kWarps)
        write_zeros<P>(A, static_cast<size_t>(t) * A.S + col0 + c, lane, true);
      continue;
    }
    stage<P>(A, t, col0, s_rec, s_sh);
    for (int wd = 0; wd < nwords; ++wd) s_hit[wd * NT + tid] = 0u;
    float lb0 = 0.0f;
    int cnt0 = A.max_depth + 1;
    if (ray_ok) {
      lb0 = lbt[si * A.R + tid];
      cnt0 = cntt[si * A.R + tid];
    }
    __syncthreads();

    // ---- A. one walk: the hits under the cap, and sum_seg g_lw ----------
    double sum_glw = 0.0;
    if (BWD12_ABL < 3 && cnt0 <= A.max_depth) {
      float lb = lb0;
      int cnt = cnt0;
      bool capped = false;
      for (int wd = 0; wd < nwords && !capped; ++wd) {
        unsigned bits = 0u;
        const int n = min(32, A.seg - wd * 32);
        for (int b = 0; b < n; ++b) {
          const int c = wd * 32 + b;
          float4 m0, m1, m2;
          load_record(s_rec, c, m0, m1, m2);
          float a, bb, cc;
          P::coeffs(ray, m0, m1, m2, a, bb, cc);
          Hit h;
          if (!pair_hit_walk(a, bb, cc, m2.z, A.e2, h)) continue;
          if (h.alpha > 0.0f) {
            if (++cnt > A.max_depth) {
              capped = true;  // this pair and every later one: alpha 0
              break;
            }
            if (lb > A.log_kill) {
              const float w = expf(lb) * h.alpha;
              const float* shc = s_sh + c * 3 * K;
              const float g_w =
                  gl0 * fmaxf(emission<K>(ray.basis, shc, K, live), 0.0f) +
                  gl1 * fmaxf(emission<K>(ray.basis, shc + K, K, live), 0.0f) +
                  gl2 * fmaxf(emission<K>(ray.basis, shc + 2 * K, K, live), 0.0f);
              sum_glw += static_cast<double>(g_w * w);
            }
            lb = lb + log1pf(-h.alpha);
          }
          bits |= 1u << b;
        }
        s_hit[wd * NT + tid] = bits;
      }
    }

    // ---- B. the recorded hits, chunk by chunk; the column sums ----------
    float lb = lb0;
    // the suffix sum of g_lw is the total less the inclusive prefix, both
    // in f64: in f32 the difference of two long sums loses the small
    // suffixes at a segment's end
    double prefix = 0.0;
    // g_logt and exp(lw) change only where alpha > 0
    float g_logt = g_lb + static_cast<float>(sum_glw - prefix);
    float exp_lb = 0.0f;
    bool exp_ok = false;
    for (int c0 = 0; c0 < A.seg; c0 += CH) {
      unsigned m =
          (s_hit[(c0 >> 5) * NT + tid] >> (c0 & 31)) & ((1u << CH) - 1u);
      while (BWD12_ABL < 2 && m) {
        const int jj = __ffs(m) - 1;
        const int j = c0 + jj;
        m &= m - 1;
        float4 m0, m1, m2;
        load_record(s_rec, j, m0, m1, m2);
        float a, b, cc;
        P::coeffs(ray, m0, m1, m2, a, b, cc);
        const bool alive = lb > A.log_kill;
        if (alive && !exp_ok) {
          exp_lb = expf(lb);
          exp_ok = true;
        }
        const float exp_lw = alive ? exp_lb : 0.0f;
        float* sc = s_scal + jj * kScal * NT + tid;
        const float* shc = s_sh + j * 3 * K;
        if (m2.z == 0.0f) {
          // opacity 0: alpha = 0, so w = 0, g_lw = 0 (g_logt as before),
          // 1 / (1 - alpha) = 1, and only pair_hit's dens is needed
          const float dens = expf(-0.5f * fmaxf(cc - b * b / a, 0.0f));
          float g_w = 0.0f;
          if (alive)
            g_w = gl0 * fmaxf(emission<K>(ray.basis, shc, K, live), 0.0f) +
                  gl1 * fmaxf(emission<K>(ray.basis, shc + K, K, live), 0.0f) +
                  gl2 * fmaxf(emission<K>(ray.basis, shc + 2 * K, K, live), 0.0f);
          const float g_alpha =
              (alive ? g_w * exp_lw : 0.0f) + g_logt * -1.0f;
          sc[3 * NT] = g_alpha * dens;
          continue;
        }
        Hit h;
        pair_hit(a, b, cc, m2.z, A.e2, h);  // a hit (phase A)
        float g_w = 0.0f, w = 0.0f;
        float ge0 = 0.0f, ge1 = 0.0f, ge2 = 0.0f;
        if (alive) {
          w = exp_lw * h.alpha;
          const float e0 = emission<K>(ray.basis, shc, K, live);
          const float e1 = emission<K>(ray.basis, shc + K, K, live);
          const float e2 = emission<K>(ray.basis, shc + 2 * K, K, live);
          g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                gl2 * fmaxf(e2, 0.0f);
          ge0 = e0 > 0.0f ? gl0 * w : 0.0f;
          ge1 = e1 > 0.0f ? gl1 * w : 0.0f;
          ge2 = e2 > 0.0f ? gl2 * w : 0.0f;
        }
        const float g_lw = g_w * w;
        prefix += static_cast<double>(g_lw);
        g_logt = g_lb + static_cast<float>(sum_glw - prefix);
        const float g_alpha = (alive ? g_w * exp_lw : 0.0f) +
                              g_logt * (-1.0f / (1.0f - h.alpha));
        const float g_raw = h.raw < 0.9999f ? g_alpha : 0.0f;
        const float g_q =
            h.q_raw > 0.0f ? g_raw * m2.z * h.dens * (-0.5f) : 0.0f;
        P::pair_scalars(g_q, a, b, sc[0], sc[NT]);
        sc[2 * NT] = g_q;
        sc[3 * NT] = g_raw * h.dens;
        sc[4 * NT] = ge0;
        sc[5 * NT] = ge1;
        sc[6 * NT] = ge2;
        if (h.alpha > 0.0f) {
          lb = lb + log1pf(-h.alpha);
          exp_ok = false;
        }
      }
      __syncthreads();
      // one warp per chunk column sums the block's rays
      if (BWD12_ABL < 1 && warp < CH && c0 + warp < A.seg) {
        const int j = c0 + warp;
        column_sum<P, NT>(A, t, col0 + j, j, s_hit, s_cm,
                          s_scal + warp * kScal * NT, s_red,
                          s_rec[j * kRec + 10], lane);
      }
      __syncthreads();
    }
    g_lb = g_lb + static_cast<float>(sum_glw);
  }
}

template <int V, int K, int NT>
cudaError_t launch_bwd_as(const Args& A, int T, cudaStream_t stream) {
  constexpr int CH = bwd_chunk<NT>();
  constexpr int kBlock = PolicyB<V, K>::kBlock;
  const int nwords = (A.seg + 31) / 32;
  const size_t smem =
      (static_cast<size_t>(A.seg) * (kRec + 3 * K) +
       static_cast<size_t>(nwords) * NT + static_cast<size_t>(CH) * kScal * NT +
       static_cast<size_t>(NT / 32) * (NT / 32) +
       (one_pass<PolicyB<V, K>>() ? 0 : static_cast<size_t>(CH) * 32 * (kBlock + 1))) *
      4;
  if (smem > 232448) return cudaErrorInvalidValue;  // a Hopper block's most
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd12_kernel<V, K, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwd12_kernel<V, K, NT><<<T, NT, smem, stream>>>(A);
  return cudaGetLastError();
}

// The smallest block of 256, 512 or 1024 threads that holds R rays.
template <int V, int K>
cudaError_t launch_bwd_nt(const Args& A, int T, cudaStream_t stream) {
  if (A.R <= 256) return launch_bwd_as<V, K, 256>(A, T, stream);
  if (A.R <= 512) return launch_bwd_as<V, K, 512>(A, T, stream);
  return launch_bwd_as<V, K, 1024>(A, T, stream);
}

// The backward of v1 (V = 1) or v2 (V = 2) with k live SH coefficients.
template <int V>
cudaError_t launch_bwd(const Args& A, int T, int k, cudaStream_t stream) {
  if (bad_sizes(T, A)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  switch (k) {
    case 1: return launch_bwd_nt<V, 1>(A, T, stream);
    case 4: return launch_bwd_nt<V, 4>(A, T, stream);
    case 9: return launch_bwd_nt<V, 9>(A, T, stream);
    case 16: return launch_bwd_nt<V, 16>(A, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace composite12
