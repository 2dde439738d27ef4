// Fused tile compositor, backward pass (its vector-Jacobian product), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/composite3.py:830
// (_bwd3_kernel / _bwd3_subtile :864, called from _bwd3_rule :1308). The
// plain PyTorch version of the same function is composite_tiles3_bwd_reference
// in volprim_tpu_torch/kernels/composite3.py; the autograd function around
// composite_tiles3 there launches this kernel for CUDA tensors.
//
// Given the forward's inputs and the cotangents g_L [T, R, 3] and
// g_beta [T, R], it writes the adjoints of the packed columns
// gpf [T, 16, S] f32 (rows 0-12: M/2, u, w, opacity; rows 13-15 are 0, as
// the TPU kernel's stable-q rows) and of the SH table gsh [T, 3k, S] bf16.
// Per tile (one block) and ray (one thread):
//
//   1. Forward pass over the segments: the forward kernel's walk without
//      emission, storing each ray's (log beta, hit count) at each segment
//      start in a global scratch [T, n_seg, R] (the TPU kernel's
//      lb_scratch / cnt_scratch). It ends with beta, so g_lb = g_beta beta.
//   2. Segments in reverse. A ray cannot hold a segment's per-column
//      values, so it walks the segment twice forward from its stored carry:
//      walk A sums g_lw = g_w w over the segment (g_w = g_L . max(e, 0));
//      walk B takes, at each hit,
//        g_logt = g_lb_next + (sum_seg g_lw - prefix_incl g_lw)
//      (the two sums in f64, then rounded to f32)
//        g_alpha = [alive] g_w exp(lw) - g_logt / (1 - alpha)
//        g_raw = [raw < 0.9999] g_alpha,  g_opac = g_raw exp(-q)
//        g_q = -[q > 0] g_raw opac exp(-q)
//      and the stable-q adjoints of q = p^T (M/2) p with p = w + t* d,
//      t* = -b / a (six M rows, three w rows, then g_a and g_b into the M
//      and u rows), plus g_sh[ch][k] = basis_f32[k] [e_raw > 0] g_L[ch] w.
//      Then g_lb_prev = g_lb_next + sum_seg g_lw.
//   3. Per column, the contributions of the block's rays are summed: a warp
//      skips a column none of its rays hit (__any_sync), else it reduces
//      its 13 + 3k values with shuffles and one lane adds them into a
//      [seg][13 + 3k] f32 shared accumulator with shared-memory atomics. At
//      segment end the accumulator is written out, gsh rounded to bf16
//      once, as the TPU kernel does. The warps' atomics land in a varying
//      order, so gpf and gsh vary from run to run in the last bits of f32.
//
// With compaction both walks visit the tile's packed stream of survivors
// (compact_stream, identical to the forward's) and a column's adjoint goes
// to its tile slot; every other slot is written as 0 (a dropped column has
// alpha = 0 for every ray of the tile, so its adjoint is 0). With the order
// band (B > 0) the lane weights are the forward's corrected ones, and
// g_logt also collects the transposed band,
//   g_logt_j += sum_{s=1..B} [tkey_j < tkey_{j-s}] g_lw_{j-s}
//                          - [tkey_j > tkey_{j+s}] g_lw_{j+s}
// (the keys get no gradient): walk A finishes a hit's weight B lanes after
// it, walk B its adjoints 2B lanes after it, from a window of the ray's
// hits (composite3_common.cuh); walk B's lanes still advance together
// across the warp, so the column reduction is unchanged.
//
// Every hit, cap, band and beta_kill decision is the forward kernel's: both
// evaluate the pair with composite3_common.cuh and are built with
// -fmad=false, and the carries are the same sequential f32 sums of
// log1p(-alpha).
//
// What bounds it on this card: FP32 and SFU issue per (ray, column) pair,
// three walks of the pair math instead of the forward's one, and the
// cross-ray reduction of every hit column, not device-memory bytes (a tile
// reads its columns three times and writes its adjoints once).
// This first version is plain: one thread per ray, shuffle reductions,
// shared atomics.

#include "composite3_common.cuh"

namespace {

using namespace composite3;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The ray's adjoints of one pair's 13 column rows, from g_alpha:
// g_raw = [raw < 0.9999] g_alpha, g_opac = g_raw exp(-q),
// g_q = -[q > 0] g_raw opac exp(-q), then the stable-q adjoints of
// q = p^T (M/2) p with p = w + t* d, t* = -b / a.
__device__ __forceinline__ void pair_adjoint_rows(const float4 m0,
                                                  const float4 m1,
                                                  const Pair& p,
                                                  const Ray& ray, float opac,
                                                  float dens, float raw,
                                                  float g_alpha, float* acc) {
  const float g_raw = raw < 0.9999f ? g_alpha : 0.0f;
  const float g_q = p.q_raw > 0.0f ? -(g_raw * opac * dens) : 0.0f;
  // q = m11 px^2 + m22 py^2 + m33 pz^2 + m12_2 px py
  //   + m13_2 px pz + m23_2 py pz
  const float g_px = g_q * (2.0f * m0.x * p.px + m0.w * p.py + m1.x * p.pz);
  const float g_py = g_q * (2.0f * m0.y * p.py + m0.w * p.px + m1.y * p.pz);
  const float g_pz = g_q * (2.0f * m0.z * p.pz + m1.x * p.px + m1.y * p.py);
  const float g_t = g_px * ray.dx + g_py * ray.dy + g_pz * ray.dz;
  const float g_b = -g_t / p.a;
  const float g_a = g_t * p.b / (p.a * p.a);
  acc[0] = g_q * p.px * p.px + ray.f0 * g_a;
  acc[1] = g_q * p.py * p.py + ray.f1 * g_a;
  acc[2] = g_q * p.pz * p.pz + ray.f2 * g_a;
  acc[3] = g_q * p.px * p.py + ray.f3 * g_a;
  acc[4] = g_q * p.px * p.pz + ray.f4 * g_a;
  acc[5] = g_q * p.py * p.pz + ray.f5 * g_a;
  acc[6] = ray.dx * g_b;
  acc[7] = ray.dy * g_b;
  acc[8] = ray.dz * g_b;
  acc[9] = g_px;
  acc[10] = g_py;
  acc[11] = g_pz;
  acc[12] = g_raw * dens;
}

// The ray's SH adjoints of one column: basis_f32[k] [e > 0] g_L[ch] w.
template <int K>
__device__ __forceinline__ void sh_adjoint_rows(const float* basis_f, float e0,
                                                float e1, float e2, float gl0,
                                                float gl1, float gl2, float w,
                                                float* acc_sh) {
  const float ge0 = e0 > 0.0f ? gl0 * w : 0.0f;
  const float ge1 = e1 > 0.0f ? gl1 * w : 0.0f;
  const float ge2 = e2 > 0.0f ? gl2 * w : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc_sh[k] = basis_f[k] * ge0;
    acc_sh[K + k] = basis_f[k] * ge1;
    acc_sh[2 * K + k] = basis_f[k] * ge2;
  }
}

// Adds the warp's rays' adjoints of one column into the shared accumulator
// row dst (one shuffle reduction per row; the warp skips what none of its
// rays has).
template <int K>
__device__ __forceinline__ void reduce_column(float* dst, const float* acc,
                                              const float* acc_sh, bool has,
                                              bool has_sh, int lane) {
  if (__any_sync(kFull, has)) {
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      const float v = warp_sum(acc[i]);
      if (lane == 0) atomicAdd(dst + i, v);
    }
  }
  if (__any_sync(kFull, has_sh)) {
#pragma unroll
    for (int i = 0; i < 3 * K; ++i) {
      const float v = warp_sum(acc_sh[i]);
      if (lane == 0) atomicAdd(dst + 13 + i, v);
    }
  }
}

// Per-ray constants of the backward walks.
template <int K>
struct RayB {
  Ray ray;
  float basis[K], basis_f[K];
  float gl0, gl1, gl2;
};

// Walks A and B of one stream segment with the order band. Each walk steps
// its lanes j together across the warp; a hit enters the window at its
// lane, its weight is finished B lanes later (stage 1: corr, lw, w, g_w,
// g_lw, and in walk B the running f64 prefix of g_lw), and in walk B its
// adjoints 2B lanes later (stage 2: the transposed band, g_alpha, rows),
// reduced over the warp for that lane's column. Returns walk A's f64 sum
// of g_lw (walk B returns 0).
template <int K, bool ADJ>
__device__ double walk_band(const float* s_pf, const __nv_bfloat16* s_sh,
                            float* s_acc, int n, const RayB<K>& rb, float e2h,
                            int max_depth, float log_kill, int band, float lb0,
                            int cnt0, float g_lb, double sum_glw,
                            BandWindow<true>& win) {
  constexpr int kAcc = 13 + 3 * K;
  const int lane_id = threadIdx.x & 31;
  win.reset((ADJ ? 3 : 2) * band + 1);  // the hits of lanes [j - 3B, j]
  float lb = lb0;
  int cnt = cnt0;
  bool done = cnt0 > max_depth;
  double total = 0.0;  // walk A: the sum; walk B: the running prefix
  const int n_steps = n + (ADJ ? 2 : 1) * band;
  for (int j = 0; j < n_steps; ++j) {
    // walk A's rays stop alone; walk B's warps stop together
    if (!ADJ && done && win.i2 == win.tail) break;
    if (ADJ && !__any_sync(kFull, !done || win.i3 < win.tail)) break;
    // stage 0: the pair at lane j enters the window when it is a hit under
    // the cap (alpha = 0 hits too: they have adjoints)
    if (j < n && !done) {
      const float4* rec = reinterpret_cast<const float4*>(s_pf + j * kFeat);
      const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];
      Pair p;
      pair_peak(m0, m1, m2, rb.ray, p);
      if (p.tp > 0.0f && pair_hit(m0, m1, m2, rb.ray, e2h, p)) {
        float dens, raw;
        const float alpha =
            pair_alpha(s_pf[j * kFeat + kOpacRow], p.q, dens, raw);
        if (!under_cap(alpha, cnt, max_depth)) {
          done = true;  // this pair and every later one: alpha 0
        } else {
          const float logt = alpha > 0.0f ? log1pf(-alpha) : 0.0f;
          win.push(BandHit{j, entry_key(p, e2h), logt, alpha, lb});
          lb = lb + logt;
        }
      }
    }
    // stage 1: the hit at lane j - B has every partner in the window
    if (win.i2 < win.tail && win.at(win.i2).lane == j - band) {
      const BandHit& h = win.at(win.i2);
      const float lw = h.lbe + band_corr(win, win.i2, band);
      float g_w = 0.0f, w = 0.0f;
      if (lw > log_kill) {
        w = expf(lw) * h.alpha;
        float e0, e1, e2;
        emission<K>(rb.basis, s_sh + (j - band) * 3 * K, e0, e1, e2);
        g_w = rb.gl0 * fmaxf(e0, 0.0f) + rb.gl1 * fmaxf(e1, 0.0f) +
              rb.gl2 * fmaxf(e2, 0.0f);
      }
      const float g_lw = g_w * w;
      total += static_cast<double>(g_lw);
      // the suffix sum of g_lw is the total less the inclusive prefix,
      // both in f64, as in the unbanded walk
      win.grad[win.slot(win.i2)] = BandGrad{
          lw, g_w, w, g_lw,
          ADJ ? g_lb + static_cast<float>(sum_glw - total) : 0.0f};
      ++win.i2;
    }
    if (!ADJ) {
      win.drop(j + 1 - 2 * band, win.i2);
      continue;
    }
    // stage 2: the hit at lane p = j - 2B has every partner's g_lw
    const int pl = j - 2 * band;
    if (pl < 0) continue;
    float acc[13];
    float acc_sh[3 * K];
#pragma unroll
    for (int i = 0; i < 13; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 3 * K; ++i) acc_sh[i] = 0.0f;
    bool has = false, has_sh = false;
    if (win.i3 < win.i2 && win.at(win.i3).lane == pl) {
      const BandGrad gr = win.grad[win.slot(win.i3)];
      const float g_logt = band_adjoint(win, win.i3, band);
      const float lw = gr.lw, g_w = gr.g_w, alpha = win.at(win.i3).alpha;
      const bool alive = lw > log_kill;
      const float* col = s_pf + pl * kFeat;
      const float4* rec = reinterpret_cast<const float4*>(col);
      const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];
      Pair p;
      pair_peak(m0, m1, m2, rb.ray, p);
      pair_hit(m0, m1, m2, rb.ray, e2h, p);  // p and q (a hit, see stage 0)
      const float opac = col[kOpacRow];
      float dens, raw;
      pair_alpha(opac, p.q, dens, raw);
      const float g_alpha = (alive ? g_w * expf(lw) : 0.0f) +
                            g_logt * (-1.0f / (1.0f - alpha));
      pair_adjoint_rows(m0, m1, p, rb.ray, opac, dens, raw, g_alpha, acc);
      has = true;
      if (alive) {
        float e0, e1, e2;
        emission<K>(rb.basis, s_sh + pl * 3 * K, e0, e1, e2);
        sh_adjoint_rows<K>(rb.basis_f, e0, e1, e2, rb.gl0, rb.gl1, rb.gl2,
                           gr.w, acc_sh);
        has_sh = true;
      }
      ++win.i3;
    }
    if (pl < n)
      reduce_column<K>(s_acc + pl * kAcc, acc, acc_sh, has, has_sh, lane_id);
    win.drop(j + 1 - 3 * band, win.i3);
  }
  return ADJ ? 0.0 : total;
}

template <int K, bool BAND>
__global__ void __launch_bounds__(kMaxRays)
    bwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t,
                const float* __restrict__ g_l,
                const float* __restrict__ g_beta, float* __restrict__ lb_scr,
                int* __restrict__ cnt_scr, int* __restrict__ idx_scr,
                float* __restrict__ gpf, __nv_bfloat16* __restrict__ gsh,
                int R, int S, int seg, float e2h, int max_depth,
                float log_kill, int compact, int band) {
  constexpr int kAcc = 13 + 3 * K;  // accumulated rows per column
  // shared memory: columns as [seg][16] f32 records, the adjoint
  // accumulator [seg][13 + 3K] f32, the lanes' tile columns, one count per
  // warp for the scan, SH as [seg][3K] bf16
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pf = reinterpret_cast<float*>(smem);
  float* s_acc = s_pf + seg * kFeat;
  int* s_col = reinterpret_cast<int*>(s_acc + seg * kAcc);
  int* s_warp = s_col + seg;
  __nv_bfloat16* s_sh = reinterpret_cast<__nv_bfloat16*>(s_warp + 32);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int n_seg_all = S / seg;
  const float* d8t = d8 + static_cast<size_t>(t) * 8 * R;
  const float* pft = pf + static_cast<size_t>(t) * kFeat * S;
  const __nv_bfloat16* sht = sh3 + static_cast<size_t>(t) * 3 * K * S;
  float* gpft = gpf + static_cast<size_t>(t) * kFeat * S;
  __nv_bfloat16* gsht = gsh + static_cast<size_t>(t) * 3 * K * S;
  float* lbt = lb_scr + static_cast<size_t>(t) * n_seg_all * R;
  int* cntt = cnt_scr + static_cast<size_t>(t) * n_seg_all * R;
  int* idx = compact ? idx_scr + static_cast<size_t>(t) * S : nullptr;

  const bool ray_ok = tid < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  RayB<K> rb;
  rb.gl0 = rb.gl1 = rb.gl2 = 0.0f;
  float gbeta = 0.0f;
  if (ray_ok) {
    dx = d8t[tid];
    dy = d8t[R + tid];
    dz = d8t[2 * R + tid];
    const size_t o = static_cast<size_t>(t) * R + tid;
    rb.gl0 = g_l[3 * o + 0];
    rb.gl1 = g_l[3 * o + 1];
    rb.gl2 = g_l[3 * o + 2];
    gbeta = g_beta[o];
  }
  rb.ray = make_ray(dx, dy, dz);
  ray_basis<K>(dx, dy, dz, rb.basis);
  ray_basis_f32<K>(dx, dy, dz, rb.basis_f);
  const Ray& ray = rb.ray;
  const float gl0 = rb.gl0, gl1 = rb.gl1, gl2 = rb.gl2;

  // every slot starts at 0: dead segments, dropped columns, rows 13-15
  for (int i = tid; i < kFeat * S; i += nthreads) gpft[i] = 0.0f;
  for (int i = tid; i < 3 * K * S; i += nthreads)
    gsht[i] = __float2bfloat16_rn(0.0f);

  // the stream: the live segments' columns, or their survivors
  const int nseg = max(0, min(n_seg_t[t], n_seg_all));
  int n_cols = nseg * seg;
  if (compact)
    n_cols = compact_stream(pft, S, n_cols, idx, s_warp, tile_cone(d8t, R));
  const int n_str = (n_cols + seg - 1) / seg;

  // ---- 1. forward pass: per-segment carries -----------------------------
  float log_beta = 0.0f;
  int count = 0;
  int nwalk = n_str;  // segments some ray of the tile enters under its cap
  for (int si = 0; si < n_str; ++si) {
    const bool active = ray_ok && count <= max_depth;
    if (!__syncthreads_or(active)) {
      nwalk = si;
      break;
    }
    if (ray_ok) {
      lbt[si * R + tid] = log_beta;
      cntt[si * R + tid] = count;
    }
    const int n = min(seg, n_cols - si * seg);
    stage_stream<K>(pft, sht, idx, s_pf, nullptr, s_col, S, si * seg, n, tid,
                    nthreads);
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4* rec = reinterpret_cast<const float4*>(s_pf + j * kFeat);
        const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
        Pair p;
        pair_peak(m0, m1, m2, ray, p);
        if (!(p.tp > 0.0f)) continue;
        if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
        float dens, raw;
        const float alpha =
            pair_alpha(s_pf[j * kFeat + kOpacRow], p.q, dens, raw);
        if (!(alpha > 0.0f)) continue;
        if (!under_cap(alpha, count, max_depth)) break;
        log_beta = log_beta + log1pf(-alpha);
      }
    }
  }
  float g_lb = gbeta * expf(log_beta);
  [[maybe_unused]] BandWindow<true> win;

  // ---- 2. segments in reverse ---------------------------------------------
  for (int si = nwalk - 1; si >= 0; --si) {
    const int n = min(seg, n_cols - si * seg);
    __syncthreads();  // the previous segment's shared reads are done
    stage_stream<K>(pft, sht, idx, s_pf, s_sh, s_col, S, si * seg, n, tid,
                    nthreads);
    for (int i = tid; i < kAcc * n; i += nthreads) s_acc[i] = 0.0f;
    __syncthreads();

    float lb0 = 0.0f;
    int cnt0 = max_depth + 1;
    if (ray_ok) {
      lb0 = lbt[si * R + tid];
      cnt0 = cntt[si * R + tid];
    }

    double sum_glw = 0.0;
    if constexpr (BAND) {
      // walk A: every ray's finished weights, summed; walk B: adjoints
      sum_glw = walk_band<K, false>(s_pf, s_sh, s_acc, n, rb, e2h, max_depth,
                                    log_kill, band, lb0, cnt0, g_lb, 0.0,
                                    win);
      walk_band<K, true>(s_pf, s_sh, s_acc, n, rb, e2h, max_depth, log_kill,
                         band, lb0, cnt0, g_lb, sum_glw, win);
    } else {
      // walk A: sum of g_lw over the segment (f64, see walk B)
      if (cnt0 <= max_depth) {
        float lb = lb0;
        int cnt = cnt0;
        for (int j = 0; j < n; ++j) {
          const float4* rec =
              reinterpret_cast<const float4*>(s_pf + j * kFeat);
          const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
          Pair p;
          pair_peak(m0, m1, m2, ray, p);
          if (!(p.tp > 0.0f)) continue;
          if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
          float dens, raw;
          const float alpha =
              pair_alpha(s_pf[j * kFeat + kOpacRow], p.q, dens, raw);
          if (!(alpha > 0.0f)) continue;
          if (!under_cap(alpha, cnt, max_depth)) break;
          if (lb > log_kill) {
            const float w = expf(lb) * alpha;
            float e0, e1, e2;
            emission<K>(rb.basis, s_sh + j * 3 * K, e0, e1, e2);
            const float g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                              gl2 * fmaxf(e2, 0.0f);
            sum_glw += static_cast<double>(g_w * w);
          }
          lb = lb + log1pf(-alpha);
        }
      }

      // walk B: per-pair adjoints, reduced over the block per column
      float lb = lb0;
      int cnt = cnt0;
      bool done = cnt0 > max_depth;
      // the suffix sum of g_lw is the total less the inclusive prefix, both
      // in f64: in f32 the difference of two long sums loses the small
      // suffixes at a segment's end
      double prefix = 0.0;
      for (int j = 0; j < n; ++j) {
        if (!__any_sync(kFull, !done)) break;  // the whole warp is capped
        float acc[13];
        float acc_sh[3 * K];
#pragma unroll
        for (int i = 0; i < 13; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < 3 * K; ++i) acc_sh[i] = 0.0f;
        bool has = false, has_sh = false;
        const float* col = s_pf + j * kFeat;
        const float4* rec = reinterpret_cast<const float4*>(col);
        const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
        Pair p;
        if (!done) pair_peak(m0, m1, m2, ray, p);
        if (!done && p.tp > 0.0f && pair_hit(m0, m1, m2, ray, e2h, p)) {
          const float opac = col[kOpacRow];
          float dens, raw;
          const float alpha = pair_alpha(opac, p.q, dens, raw);
          if (!under_cap(alpha, cnt, max_depth)) {
            done = true;  // this pair and every later one: alpha 0
          } else {
            has = true;
            const bool alive = lb > log_kill;
            float g_w = 0.0f, exp_lw = 0.0f, w = 0.0f;
            if (alive) {
              exp_lw = expf(lb);
              w = exp_lw * alpha;
              float e0, e1, e2;
              emission<K>(rb.basis, s_sh + j * 3 * K, e0, e1, e2);
              g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                    gl2 * fmaxf(e2, 0.0f);
              sh_adjoint_rows<K>(rb.basis_f, e0, e1, e2, gl0, gl1, gl2, w,
                                 acc_sh);
              has_sh = true;
            }
            const float g_lw = g_w * w;
            prefix += static_cast<double>(g_lw);
            const float g_logt = g_lb + static_cast<float>(sum_glw - prefix);
            const float g_alpha = (alive ? g_w * exp_lw : 0.0f) +
                                  g_logt * (-1.0f / (1.0f - alpha));
            pair_adjoint_rows(m0, m1, p, ray, opac, dens, raw, g_alpha, acc);
            if (alpha > 0.0f) lb = lb + log1pf(-alpha);
          }
        }
        reduce_column<K>(s_acc + j * kAcc, acc, acc_sh, has, has_sh, lane);
      }
    }
    g_lb = g_lb + static_cast<float>(sum_glw);
    __syncthreads();

    // the segment's adjoints to their tile slots; gsh rounded to bf16 once
    for (int i = tid; i < 13 * n; i += nthreads) {
      const int row = i / n, j = i - row * n;
      gpft[static_cast<size_t>(row) * S + s_col[j]] = s_acc[j * kAcc + row];
    }
    for (int i = tid; i < 3 * K * n; i += nthreads) {
      const int row = i / n, j = i - row * n;
      gsht[static_cast<size_t>(row) * S + s_col[j]] =
          __float2bfloat16_rn(s_acc[j * kAcc + 13 + row]);
    }
  }
}

template <int K, bool BAND>
cudaError_t launch_as(const float* d8, const float* pf,
                      const __nv_bfloat16* sh3, const int* n_seg_t,
                      const float* g_l, const float* g_beta, float* lb_scr,
                      int* cnt_scr, int* idx_scr, float* gpf,
                      __nv_bfloat16* gsh, int T, int R, int S, int seg,
                      float e2h, int max_depth, float log_kill, int compact,
                      int band, cudaStream_t stream) {
  const int threads = (R + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(seg) * (kFeat + 13 + 3 * K) * sizeof(float) +
      static_cast<size_t>(seg) * sizeof(int) + 32 * sizeof(int) +
      static_cast<size_t>(seg) * 3 * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd3_kernel<K, BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwd3_kernel<K, BAND><<<T, threads, smem, stream>>>(
      d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr, cnt_scr, idx_scr, gpf, gsh, R,
      S, seg, e2h, max_depth, log_kill, compact, band);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, const float* g_l, const float* g_beta,
                   float* lb_scr, int* cnt_scr, int* idx_scr, float* gpf,
                   __nv_bfloat16* gsh, int T, int R, int S, int seg, float e2h,
                   int max_depth, float log_kill, int compact, int band,
                   cudaStream_t stream) {
  if (band > 0)
    return launch_as<K, true>(d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr,
                              cnt_scr, idx_scr, gpf, gsh, T, R, S, seg, e2h,
                              max_depth, log_kill, compact, band, stream);
  return launch_as<K, false>(d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr,
                             cnt_scr, idx_scr, gpf, gsh, T, R, S, seg, e2h,
                             max_depth, log_kill, compact, band, stream);
}

}  // namespace

// C entry point, bound with ctypes. Tensors: d8 [T, 8, R] f32, pf [T, 16, S]
// f32, sh3 [T, 3k, S] bf16, n_seg_t [T] int32, g_l [T, R, 3] f32,
// g_beta [T, R] f32, scratch lb_scr [T, S / seg, R] f32, cnt_scr
// [T, S / seg, R] int32 and, with compact, idx_scr [T, S] int32, outputs gpf
// [T, 16, S] f32 and gsh [T, 3k, S] bf16, all contiguous on one device;
// 0 <= band <= kMaxBand. Every output element is written. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int composite3_bwd(const void* d8, const void* pf, const void* sh3,
                              const void* n_seg_t, const void* g_l,
                              const void* g_beta, void* lb_scr, void* cnt_scr,
                              void* idx_scr, void* gpf, void* gsh, int T,
                              int R, int S, int seg, int k, float e2h,
                              int max_depth, float log_kill, int compact,
                              int band, void* stream) {
  if (T < 0 || R < 1 || R > kMaxRays || seg < 1 || S < seg || S % seg != 0 ||
      band < 0 || band > kMaxBand)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(d8);
  const auto* p = static_cast<const float*>(pf);
  const auto* s = static_cast<const __nv_bfloat16*>(sh3);
  const auto* n = static_cast<const int*>(n_seg_t);
  const auto* gl = static_cast<const float*>(g_l);
  const auto* gb = static_cast<const float*>(g_beta);
  auto* lb = static_cast<float*>(lb_scr);
  auto* cn = static_cast<int*>(cnt_scr);
  auto* ix = static_cast<int*>(idx_scr);
  auto* gp = static_cast<float*>(gpf);
  auto* gs = static_cast<__nv_bfloat16*>(gsh);
  switch (k) {
    case 1:
      return static_cast<int>(launch<1>(d, p, s, n, gl, gb, lb, cn, ix, gp, gs,
                                        T, R, S, seg, e2h, max_depth, log_kill,
                                        compact, band, st));
    case 4:
      return static_cast<int>(launch<4>(d, p, s, n, gl, gb, lb, cn, ix, gp, gs,
                                        T, R, S, seg, e2h, max_depth, log_kill,
                                        compact, band, st));
    case 9:
      return static_cast<int>(launch<9>(d, p, s, n, gl, gb, lb, cn, ix, gp, gs,
                                        T, R, S, seg, e2h, max_depth, log_kill,
                                        compact, band, st));
    case 16:
      return static_cast<int>(launch<16>(d, p, s, n, gl, gb, lb, cn, ix, gp,
                                         gs, T, R, S, seg, e2h, max_depth,
                                         log_kill, compact, band, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* composite3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
