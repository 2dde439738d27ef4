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
// Per tile (one block of NT = 256, 512 or 1024 threads) and ray (one
// thread):
//
//   1. Carry pass over the segments: the forward kernel's walk without
//      emission, storing each ray's (log beta, hit count) at each segment
//      start in a global scratch [T, n_seg, R] (the TPU kernel's
//      lb_scratch / cnt_scratch). It ends with beta, so g_lb = g_beta beta.
//   2. Segments in reverse, each in two phases:
//      A. one walk of the segment from the ray's stored carry: at each hit
//         under the cap it sets the hit's bit in the ray's hit mask (shared
//         memory) and sums g_lw = g_w w in f64 (g_w = g_L . max(e, 0));
//      B. the ray's recorded hits, column chunk by column chunk, in order:
//         alpha, w and the prefix of g_lw are taken again from the same
//         sequence of operations (only at the hits, no pair is tested),
//           g_logt = g_lb_next + (sum_seg g_lw - prefix_incl g_lw)
//         (the two sums in f64, then rounded to f32),
//           g_alpha = [alive] g_w exp(lw) - g_logt / (1 - alpha)
//           g_raw = [raw < 0.9999] g_alpha,  g_q = -[q > 0] g_raw opac exp(-q)
//           g_p = g_q dq/dp,  g_t = g_p . d,  g_b = -g_t / a
//         and the hit leaves seven scalars in shared memory: g_q, t*, g_b,
//         g_raw exp(-q) and g_e = [e > 0] g_L w per channel.
//      Then per chunk column one warp sums the block's rays: its lanes take
//      the hits (the i-th hit of the column to lane i mod 32, rays in
//      order), form the 13 + 3k adjoint rows from the scalars
//        rows 0-5  g_q p_i p_j + F6_i(d) g_a  (g_a = g_b t*)
//        rows 6-8  d g_b,  rows 9-11  g_p,  row 12  g_raw exp(-q)
//        SH        basis_f32[k] g_e[ch]
//      with p = w + t* d formed again, and sums them in a fixed order (each
//      lane its hits, then over lanes through shared memory). gsh is
//      rounded to bf16 once, as the TPU kernel does. Nothing is summed
//      with atomics, so gpf and gsh are bit-reproducible.
//      Then g_lb_prev = g_lb_next + sum_seg g_lw.
//
// With compaction both passes visit the tile's packed stream of survivors
// (compact_stream, identical to the forward's) and a column's adjoint goes
// to its tile slot; every other slot is written as 0 (a dropped column has
// alpha = 0 for every ray of the tile, so its adjoint is 0). With the order
// band (B > 0) the lane weights are the forward's corrected ones, and
// g_logt also collects the transposed band,
//   g_logt_j += sum_{s=1..B} [tkey_j < tkey_{j-s}] g_lw_{j-s}
//                          - [tkey_j > tkey_{j+s}] g_lw_{j+s}
// (the keys get no gradient): phase A finishes a hit's weight B lanes after
// it, phase B its weight again and its adjoints 2B lanes after it, from a
// window of the ray's hits (composite3_common.cuh).
//
// Every hit, cap, band and beta_kill decision is the forward kernel's: both
// evaluate the pair with composite3_common.cuh and are built with
// -fmad=false, the carries are the same sequential f32 sums of
// log1p(-alpha), and both passes walk a warp's survivors of the same warp
// cull, which drops only columns none of its rays can hit.
//
// What bounds it on this card: FP32 and SFU issue per (ray, column) pair
// and the cross-ray sum of every hit column, not device-memory bytes (a
// tile reads its columns twice and writes its adjoints once). The design
// walks the pairs twice (the carry pass and phase A; the old design three
// times), culls them per warp, stages each segment with cp.async double
// buffered, and sums a column once per block instead of once per warp.

#include "composite3_common.cuh"

namespace {

using namespace composite3;

constexpr int kScal = 7;  // scalars a hit leaves for the column sum

// columns per phase-B chunk: the scalars [CH][7][NT] take 28 KB
template <int NT>
__host__ __device__ constexpr int chunk_cols() {
  return 1024 / NT;
}

// blocks per SM the register budget is sized for
template <int NT>
__host__ __device__ constexpr int bwd_min_blocks() {
  return NT == 256 ? 2 : 1;
}

// g_p = g_q dq/dp for q = p^T (M/2) p in the halved rows: the ray's
// phase B and the column sum form it alike.
__device__ __forceinline__ void grad_p(const float4 m0, const float4 m1,
                                       float px, float py, float pz, float g_q,
                                       float& g_px, float& g_py, float& g_pz) {
  g_px = g_q * __fmaf_rn(2.0f * m0.x, px, __fmaf_rn(m0.w, py, m1.x * pz));
  g_py = g_q * __fmaf_rn(2.0f * m0.y, py, __fmaf_rn(m0.w, px, m1.y * pz));
  g_pz = g_q * __fmaf_rn(2.0f * m0.z, pz, __fmaf_rn(m1.x, px, m1.y * py));
}

// The seven scalars of one hit from its g_alpha (see the header note).
__device__ __forceinline__ void hit_scalars(const float4 m0, const float4 m1,
                                            const Pair& p, const Ray& ray,
                                            float opac, float dens, float raw,
                                            float g_alpha, float ge0, float ge1,
                                            float ge2, float* s, int stride) {
  const float g_raw = raw < 0.9999f ? g_alpha : 0.0f;
  const float g_q = p.q_raw > 0.0f ? -(g_raw * opac * dens) : 0.0f;
  float g_px, g_py, g_pz;
  grad_p(m0, m1, p.px, p.py, p.pz, g_q, g_px, g_py, g_pz);
  const float g_t =
      __fmaf_rn(g_px, ray.dx, __fmaf_rn(g_py, ray.dy, g_pz * ray.dz));
  s[0] = g_q;
  s[stride] = p.tp;
  s[2 * stride] = -g_t / p.a;
  s[3 * stride] = g_raw * dens;
  s[4 * stride] = ge0;
  s[5 * stride] = ge1;
  s[6 * stride] = ge2;
}

// Per-ray constants of the backward.
template <int K>
struct RayB {
  Ray ray;
  float basis[K];
  float gl0, gl1, gl2;
};

// g_w = g_L . max(e, 0) and the SH adjoints' g_e of a live hit at lane j
template <int K>
__device__ __forceinline__ float emission_grad(const RayB<K>& rb,
                                               const Stage& cur, int j,
                                               float w, float& ge0, float& ge1,
                                               float& ge2) {
  float e0, e1, e2;
  emission<K>(rb.basis, cur.sh + j * 3 * K, cur.col[j] & 1, e0, e1, e2);
  ge0 = e0 > 0.0f ? rb.gl0 * w : 0.0f;
  ge1 = e1 > 0.0f ? rb.gl1 * w : 0.0f;
  ge2 = e2 > 0.0f ? rb.gl2 * w : 0.0f;
  return rb.gl0 * fmaxf(e0, 0.0f) + rb.gl1 * fmaxf(e1, 0.0f) +
         rb.gl2 * fmaxf(e2, 0.0f);
}

// the pair at lane j of the staged segment, which is a hit: p, q, alpha
struct HitPair {
  float4 m0, m1, m2;
  Pair p;
  float opac, dens, raw, alpha;
};

__device__ __forceinline__ bool eval_pair(const Stage& cur, int j,
                                          const Ray& ray, float e2h,
                                          HitPair& h) {
  const float* col = cur.pf + j * kFeat;
  const float4* rec = reinterpret_cast<const float4*>(col);
  h.m0 = rec[0];
  h.m1 = rec[1];
  h.m2 = rec[2];
  pair_peak(h.m0, h.m1, h.m2, ray, h.p);
  if (!(h.p.tp > 0.0f)) return false;
  if (!pair_hit(h.m0, h.m1, h.m2, ray, e2h, h.p)) return false;
  h.opac = col[kOpacRow];
  h.alpha = pair_alpha(h.opac, h.p.q, h.dens, h.raw);
  return true;
}

// the smallest recorded hit lane in [pos, last] of this thread's mask, or -1
__device__ __forceinline__ int next_hit(const unsigned* s_hit, int NT,
                                        int tid, int pos, int last) {
  while (pos <= last) {
    const int wd = pos >> 5;
    unsigned m = s_hit[wd * NT + tid] & (kFull << (pos & 31));
    const int hi = min(last, (wd << 5) + 31);
    if (hi - (wd << 5) < 31) m &= (2u << (hi & 31)) - 1u;
    if (m) return (wd << 5) + __ffs(m) - 1;
    pos = (wd + 1) << 5;
  }
  return -1;
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

// Sums column j of the chunk over the block's rays and writes its adjoint
// rows to the tile slot `slot`: the warp's lanes take the column's hits in
// ray order (hit i to lane i mod 32), form each hit's 13 + 3k rows from the
// scalars `sc` ([7][NT], this column's) and add them in order; then the
// lanes' sums are added over the lanes in order through shared memory (the
// column's scalars, which are read by then). Every lane of the warp calls
// it.
template <int K, int NT>
__device__ __forceinline__ void column_sum(const unsigned* s_hit,
                                           unsigned* s_cm, float* sc,
                                           const float* s_ray,
                                           const float* rec, int j, int slot,
                                           int S, float* gpft,
                                           __nv_bfloat16* gsht, int lane) {
  constexpr int kRows = 13 + 3 * K;
  constexpr int kGroups = NT / 32;
  // the column's hits: one ballot word per 32 rays, kept in s_cm
  int total = 0;
  const int wd = j >> 5, bit = j & 31;
  for (int g = 0; g < kGroups; ++g) {
    const unsigned b =
        __ballot_sync(kFull, (s_hit[wd * NT + g * 32 + lane] >> bit) & 1u);
    if (lane == 0) s_cm[g] = b;
    total += __popc(b);
  }
  if (total == 0) return;  // the slot keeps its 0
  __syncwarp();
  const float4 m0 = reinterpret_cast<const float4*>(rec)[0];
  const float4 m1 = reinterpret_cast<const float4*>(rec)[1];
  const float4 m2 = reinterpret_cast<const float4*>(rec)[2];
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  for (int i = lane; i < total; i += 32) {
    // the ray of the column's i-th hit
    int k = i, r = 0;
    for (int g = 0; g < kGroups; ++g) {
      const unsigned m = s_cm[g];
      const int c = __popc(m);
      if (k < c) {
        r = g * 32 + nth_set_bit(m, k);
        break;
      }
      k -= c;
    }
    const float g_q = sc[r], tp = sc[NT + r], g_b = sc[2 * NT + r];
    const float grd = sc[3 * NT + r];
    const float ge[3] = {sc[4 * NT + r], sc[5 * NT + r], sc[6 * NT + r]};
    const Ray ray = make_ray(s_ray[r], s_ray[NT + r], s_ray[2 * NT + r]);
    float px, py, pz, g_px, g_py, g_pz;
    peak_point(m2, tp, ray.dx, ray.dy, ray.dz, px, py, pz);
    grad_p(m0, m1, px, py, pz, g_q, g_px, g_py, g_pz);
    const float g_a = g_b * tp;
    acc[0] += __fmaf_rn(g_q * px, px, ray.f0 * g_a);
    acc[1] += __fmaf_rn(g_q * py, py, ray.f1 * g_a);
    acc[2] += __fmaf_rn(g_q * pz, pz, ray.f2 * g_a);
    acc[3] += __fmaf_rn(g_q * px, py, ray.f3 * g_a);
    acc[4] += __fmaf_rn(g_q * px, pz, ray.f4 * g_a);
    acc[5] += __fmaf_rn(g_q * py, pz, ray.f5 * g_a);
    acc[6] += ray.dx * g_b;
    acc[7] += ray.dy * g_b;
    acc[8] += ray.dz * g_b;
    acc[9] += g_px;
    acc[10] += g_py;
    acc[11] += g_pz;
    acc[12] += grd;
    float basis_f[K];
    ray_basis_f32<K>(ray.dx, ray.dy, ray.dz, basis_f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        acc[13 + ch * K + kk] = __fmaf_rn(basis_f[kk], ge[ch],
                                          acc[13 + ch * K + kk]);
  }
  // over the lanes, 32 rows at a time, through the column's scalar area
  const int nl = min(total, 32);
  float* red = sc;  // [32][33]
  __syncwarp();
#pragma unroll
  for (int rb = 0; rb < kRows; rb += 32) {
    if (lane < nl) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (rb + i < kRows) red[lane * 33 + i] = acc[rb + i];
    }
    __syncwarp();
    const int row = rb + lane;
    if (row < kRows) {
      float v = 0.0f;
      for (int i = 0; i < nl; ++i) v += red[i * 33 + lane];
      if (row < 13)
        gpft[static_cast<size_t>(row) * S + slot] = v;
      else
        gsht[static_cast<size_t>(row - 13) * S + slot] = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
}

template <int K, bool BAND, int NT>
__global__ void __launch_bounds__(NT, bwd_min_blocks<NT>())
    bwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t,
                const float* __restrict__ g_l,
                const float* __restrict__ g_beta, float* __restrict__ lb_scr,
                int* __restrict__ cnt_scr, int* __restrict__ idx_scr,
                float* __restrict__ gpf, __nv_bfloat16* __restrict__ gsh,
                int R, int S, int seg, float e2h, int max_depth,
                float log_kill, int compact, int band, int nbuf,
                int sh_async) {
  constexpr int CH = chunk_cols<NT>();
  extern __shared__ __align__(16) unsigned char smem[];
  // nbuf staging buffers (stage_at), the masks, the scan's counts and the
  // warps' cones (mask_bytes), then the hit masks, the chunk's scalars, the
  // rays' directions, the columns that some ray hits and the column sums'
  // ballot words
  const int nwords = (seg + 31) >> 5;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* sp = smem + nbuf * stage_bytes<K>(seg);
  unsigned* s_mask = reinterpret_cast<unsigned*>(sp) + warp * nwords;
  int* s_warp =
      reinterpret_cast<int*>(sp + align16(size_t(NT / 32) * nwords * 4));
  float* s_cone = reinterpret_cast<float*>(s_warp + 32) + warp * 8;
  sp += mask_bytes(seg, NT);
  unsigned* s_hit = reinterpret_cast<unsigned*>(sp);  // [nwords][NT]
  sp += align16(size_t(nwords) * NT * 4);
  float* s_scal = reinterpret_cast<float*>(sp);  // [CH][7][NT]
  sp += align16(size_t(CH) * kScal * NT * 4);
  float* s_ray = reinterpret_cast<float*>(sp);  // [3][NT]
  sp += align16(size_t(3) * NT * 4);
  unsigned* s_colany = reinterpret_cast<unsigned*>(sp);  // [nwords]
  sp += align16(size_t(nwords) * 4);
  unsigned* s_cm = reinterpret_cast<unsigned*>(sp) + warp * (NT / 32);

  const int n_seg_all = S / seg;
  const float* d8t = d8 + static_cast<size_t>(t) * 8 * R;
  const float* pft = pf + static_cast<size_t>(t) * kFeat * S;
  const __nv_bfloat16* sht = sh3 + static_cast<size_t>(t) * 3 * K * S;
  float* gpft = gpf + static_cast<size_t>(t) * kFeat * S;
  __nv_bfloat16* gsht = gsh + static_cast<size_t>(t) * 3 * K * S;
  float* lbt = lb_scr + static_cast<size_t>(t) * n_seg_all * R;
  int* cntt = cnt_scr + static_cast<size_t>(t) * n_seg_all * R;
  int* idx = compact ? idx_scr + static_cast<size_t>(t) * S : nullptr;

  const int ray_i = ray_of_thread(tid, R, NT);
  const bool ray_ok = ray_i < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  RayB<K> rb;
  rb.gl0 = rb.gl1 = rb.gl2 = 0.0f;
  float gbeta = 0.0f;
  if (ray_ok) {
    dx = d8t[ray_i];
    dy = d8t[R + ray_i];
    dz = d8t[2 * R + ray_i];
    const size_t o = static_cast<size_t>(t) * R + ray_i;
    rb.gl0 = g_l[3 * o + 0];
    rb.gl1 = g_l[3 * o + 1];
    rb.gl2 = g_l[3 * o + 2];
    gbeta = g_beta[o];
  }
  rb.ray = make_ray(dx, dy, dz);
  ray_basis<K>(dx, dy, dz, rb.basis);
  const Ray& ray = rb.ray;
  store_cone(warp_cone(ray, ray_ok), s_cone, lane);
  s_ray[tid] = dx;
  s_ray[NT + tid] = dy;
  s_ray[2 * NT + tid] = dz;

  // every slot starts at 0: dead segments, dropped columns, rows 13-15
  for (int i = tid; i < kFeat * S; i += NT) gpft[i] = 0.0f;
  for (int i = tid; i < 3 * K * S; i += NT) gsht[i] = __float2bfloat16_rn(0.0f);

  // the stream: the live segments' columns, or their survivors
  const int nseg = max(0, min(n_seg_t[t], n_seg_all));
  int n_cols = nseg * seg;
  if (compact)
    n_cols = compact_stream(pft, S, n_cols, idx, s_warp, tile_cone(d8t, R));
  const int n_str = (n_cols + seg - 1) / seg;
  auto seg_len = [&](int si) { return min(seg, n_cols - si * seg); };

  // ---- 1. carry pass: per-segment (log beta, count) ------------------------
  float log_beta = 0.0f;
  int count = 0;
  int nwalk = n_str;  // segments some ray of the tile enters under its cap
  if (nbuf == 2 && n_str > 0) {
    stage_async<K, false>(pft, sht, idx, stage_at<K>(smem, seg, 0), S, 0,
                          seg_len(0), sh_async);
    cp_async_commit();
  }
  for (int si = 0; si < n_str; ++si) {
    const bool active = ray_ok && count <= max_depth;
    if (!__syncthreads_or(active)) {
      nwalk = si;
      break;
    }
    if (ray_ok) {
      lbt[si * R + ray_i] = log_beta;
      cntt[si * R + ray_i] = count;
    }
    const Stage cur = stage_at<K>(smem, seg, nbuf == 2 ? si & 1 : 0);
    const int n = seg_len(si);
    if (nbuf == 2) {
      if (si + 1 < n_str)
        stage_async<K, false>(pft, sht, idx,
                              stage_at<K>(smem, seg, (si + 1) & 1), S,
                              (si + 1) * seg, seg_len(si + 1), sh_async);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      stage_async<K, false>(pft, sht, idx, cur, S, si * seg, n, sh_async);
      cp_async_commit();
      cp_async_wait<0>();
    }
    stage_radii(cur, n, e2h);
    __syncthreads();
    warp_survivors(s_cone, cur.pf, n, s_mask, lane);
    if (!active) continue;
    const int nw = (n + 31) >> 5;
    bool capped = false;
    for (int wd = 0; wd < nw && !capped; ++wd) {
      unsigned m = s_mask[wd];
      while (m) {
        const int j = (wd << 5) + __ffs(m) - 1;
        m &= m - 1;
        HitPair h;
        if (!eval_pair(cur, j, ray, e2h, h)) continue;
        if (!(h.alpha > 0.0f)) continue;
        if (!under_cap(h.alpha, count, max_depth)) {
          capped = true;
          break;
        }
        log_beta = log_beta + log1pf(-h.alpha);
      }
    }
  }
  cp_async_wait<0>();
  float g_lb = gbeta * expf(log_beta);
  [[maybe_unused]] BandWindow<true, BAND ? kBandCap : 1> win;
  const int bnd = band;

  // ---- 2. segments in reverse ---------------------------------------------
  if (nbuf == 2 && nwalk > 0) {
    __syncthreads();  // the carry pass's reads of the buffers are done
    stage_async<K, true>(pft, sht, idx, stage_at<K>(smem, seg, (nwalk - 1) & 1),
                         S, (nwalk - 1) * seg, seg_len(nwalk - 1), sh_async);
    cp_async_commit();
  }
  for (int si = nwalk - 1; si >= 0; --si) {
    const int n = seg_len(si);
    const int nw = (n + 31) >> 5;
    __syncthreads();  // the previous segment's shared reads are done
    const Stage cur = stage_at<K>(smem, seg, nbuf == 2 ? si & 1 : 0);
    if (nbuf == 2) {
      if (si > 0)
        stage_async<K, true>(pft, sht, idx, stage_at<K>(smem, seg, (si - 1) & 1),
                             S, (si - 1) * seg, seg_len(si - 1), sh_async);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      stage_async<K, true>(pft, sht, idx, cur, S, si * seg, n, sh_async);
      cp_async_commit();
      cp_async_wait<0>();
    }
    stage_radii(cur, n, e2h);
    if (tid < nwords) s_colany[tid] = 0u;
    __syncthreads();
    warp_survivors(s_cone, cur.pf, n, s_mask, lane);

    float lb0 = 0.0f;
    int cnt0 = max_depth + 1;
    if (ray_ok) {
      lb0 = lbt[si * R + ray_i];
      cnt0 = cntt[si * R + ray_i];
    }
    for (int wd = 0; wd < nw; ++wd) s_hit[wd * NT + tid] = 0u;

    // ---- A. one walk: the hits under the cap, and sum_seg g_lw ----------
    double sum_glw = 0.0;
    if (cnt0 <= max_depth) {
      float lb = lb0;
      int cnt = cnt0;
      if constexpr (!BAND) {
        bool capped = false;
        for (int wd = 0; wd < nw && !capped; ++wd) {
          unsigned m = s_mask[wd], bits = 0u;
          while (m) {
            const int b = __ffs(m) - 1;
            const int j = (wd << 5) + b;
            m &= m - 1;
            HitPair h;
            if (!eval_pair(cur, j, ray, e2h, h)) continue;
            if (!under_cap(h.alpha, cnt, max_depth)) {
              capped = true;  // this pair and every later one: alpha 0
              break;
            }
            bits |= 1u << b;
            if (lb > log_kill) {
              const float w = expf(lb) * h.alpha;
              float ge0, ge1, ge2;
              const float g_w = emission_grad<K>(rb, cur, j, w, ge0, ge1, ge2);
              sum_glw += static_cast<double>(g_w * w);
            }
            if (h.alpha > 0.0f) lb = lb + log1pf(-h.alpha);
          }
          s_hit[wd * NT + tid] = bits;
        }
      } else {
        // stage 0 at each hit (alpha = 0 hits too: they have adjoints),
        // stage 1 (the corrected weight) B lanes after it
        win.reset(2 * bnd + 1);
        auto finish = [&](int x) {
          const BandHit& hh = win.at(x);
          const float lw = hh.lbe + band_corr(win, x, bnd);
          if (lw > log_kill) {
            const float w = expf(lw) * hh.alpha;
            float ge0, ge1, ge2;
            const float g_w =
                emission_grad<K>(rb, cur, hh.lane, w, ge0, ge1, ge2);
            sum_glw += static_cast<double>(g_w * w);
          }
        };
        bool capped = false;
        for (int wd = 0; wd < nw && !capped; ++wd) {
          unsigned m = s_mask[wd], bits = 0u;
          while (m) {
            const int b = __ffs(m) - 1;
            const int j = (wd << 5) + b;
            m &= m - 1;
            HitPair h;
            if (!eval_pair(cur, j, ray, e2h, h)) continue;
            if (!under_cap(h.alpha, cnt, max_depth)) {
              capped = true;
              break;
            }
            bits |= 1u << b;
            for (; win.i2 < win.tail && win.at(win.i2).lane + bnd < j;
                 ++win.i2)
              finish(win.i2);
            win.drop((win.i2 < win.tail ? win.at(win.i2).lane : j) - bnd,
                     win.i2);
            const float logt = h.alpha > 0.0f ? log1pf(-h.alpha) : 0.0f;
            win.push(BandHit{j, entry_key(h.p, e2h), logt, h.alpha, lb});
            lb = lb + logt;
          }
          s_hit[wd * NT + tid] = bits;
        }
        for (; win.i2 < win.tail; ++win.i2) finish(win.i2);
      }
    }
    // the columns some ray of the block hits
    __syncwarp();
    for (int wd = 0; wd < nw; ++wd) {
      const unsigned v = __reduce_or_sync(kFull, s_hit[wd * NT + tid]);
      if (lane == 0 && v) atomicOr(s_colany + wd, v);
    }
    __syncthreads();

    // ---- B. the recorded hits, chunk by chunk; the column sums ----------
    float lb = lb0;
    double prefix = 0.0;
    int pos = 0;  // band: the next lane to push
    if constexpr (BAND) win.reset(CH + 3 * bnd);
    for (int c0 = 0; c0 < n; c0 += CH) {
      const unsigned chunk_any =
          (s_colany[c0 >> 5] >> (c0 & 31)) & ((1u << CH) - 1u);
      if (chunk_any == 0u) continue;  // block-uniform
      float* s_c = s_scal;
      if constexpr (!BAND) {
        unsigned m = (s_hit[(c0 >> 5) * NT + tid] >> (c0 & 31)) &
                     ((1u << CH) - 1u);
        while (m) {
          const int jj = __ffs(m) - 1;
          const int j = c0 + jj;
          m &= m - 1;
          HitPair h;
          eval_pair(cur, j, ray, e2h, h);  // a hit (phase A)
          const bool alive = lb > log_kill;
          float g_w = 0.0f, exp_lw = 0.0f, w = 0.0f;
          float ge0 = 0.0f, ge1 = 0.0f, ge2 = 0.0f;
          if (alive) {
            exp_lw = expf(lb);
            w = exp_lw * h.alpha;
            g_w = emission_grad<K>(rb, cur, j, w, ge0, ge1, ge2);
          }
          prefix += static_cast<double>(g_w * w);
          const float g_logt = g_lb + static_cast<float>(sum_glw - prefix);
          const float g_alpha = (alive ? g_w * exp_lw : 0.0f) +
                                g_logt * (-1.0f / (1.0f - h.alpha));
          hit_scalars(h.m0, h.m1, h.p, ray, h.opac, h.dens, h.raw, g_alpha, ge0,
                      ge1, ge2, s_c + jj * kScal * NT + tid, NT);
          if (h.alpha > 0.0f) lb = lb + log1pf(-h.alpha);
        }
      } else {
        const int last = min(n - 1, c0 + CH + 2 * bnd - 1);
        // stage 0: push the recorded hits through lane `last`
        for (int j = next_hit(s_hit, NT, tid, pos, last); j >= 0;
             j = next_hit(s_hit, NT, tid, pos, last)) {
          HitPair h;
          eval_pair(cur, j, ray, e2h, h);
          const float logt = h.alpha > 0.0f ? log1pf(-h.alpha) : 0.0f;
          win.push(BandHit{j, entry_key(h.p, e2h), logt, h.alpha, lb});
          lb = lb + logt;
          pos = j + 1;
        }
        pos = last + 1;
        // stage 1: the weights whose band is complete
        for (; win.i2 < win.tail &&
               (win.at(win.i2).lane + bnd <= last || last == n - 1);
             ++win.i2) {
          const BandHit& hh = win.at(win.i2);
          const float lw = hh.lbe + band_corr(win, win.i2, bnd);
          float g_w = 0.0f, w = 0.0f;
          if (lw > log_kill) {
            w = expf(lw) * hh.alpha;
            float ge0, ge1, ge2;
            g_w = emission_grad<K>(rb, cur, hh.lane, w, ge0, ge1, ge2);
          }
          const float g_lw = g_w * w;
          prefix += static_cast<double>(g_lw);
          win.grad[win.slot(win.i2)] = BandGrad{
              lw, g_w, w, g_lw, g_lb + static_cast<float>(sum_glw - prefix)};
        }
        // stage 2: the adjoints of the chunk's hits
        for (; win.i3 < win.i2 && win.at(win.i3).lane < c0 + CH; ++win.i3) {
          const BandHit& hh = win.at(win.i3);
          const BandGrad gr = win.grad[win.slot(win.i3)];
          const float g_logt = band_adjoint(win, win.i3, bnd);
          const bool alive = gr.lw > log_kill;
          HitPair h;
          eval_pair(cur, hh.lane, ray, e2h, h);
          float ge0 = 0.0f, ge1 = 0.0f, ge2 = 0.0f;
          if (alive) emission_grad<K>(rb, cur, hh.lane, gr.w, ge0, ge1, ge2);
          const float g_alpha = (alive ? gr.g_w * expf(gr.lw) : 0.0f) +
                                g_logt * (-1.0f / (1.0f - hh.alpha));
          hit_scalars(h.m0, h.m1, h.p, ray, h.opac, h.dens, h.raw, g_alpha,
                      ge0, ge1, ge2, s_c + (hh.lane - c0) * kScal * NT + tid,
                      NT);
        }
        win.drop(c0 + CH - bnd, win.i3);
      }
      __syncthreads();
      // one warp per chunk column sums the block's rays
      if (warp < CH) {
        const int j = c0 + warp;
        if (j < n && ((chunk_any >> warp) & 1u))
          column_sum<K, NT>(s_hit, s_cm, s_c + warp * kScal * NT, s_ray,
                            cur.pf + j * kFeat, j, cur.col[j], S, gpft, gsht,
                            lane);
      }
      __syncthreads();
    }
    g_lb = g_lb + static_cast<float>(sum_glw);
  }
  cp_async_wait<0>();
}

template <int K, bool BAND, int NT>
cudaError_t launch_as(const float* d8, const float* pf,
                      const __nv_bfloat16* sh3, const int* n_seg_t,
                      const float* g_l, const float* g_beta, float* lb_scr,
                      int* cnt_scr, int* idx_scr, float* gpf,
                      __nv_bfloat16* gsh, int T, int R, int S, int seg,
                      float e2h, int max_depth, float log_kill, int compact,
                      int band, cudaStream_t stream) {
  constexpr int CH = chunk_cols<NT>();
  const int nwords = (seg + 31) / 32;
  const size_t rest = mask_bytes(seg, NT) + align16(size_t(nwords) * NT * 4) +
                      align16(size_t(CH) * kScal * NT * 4) +
                      align16(size_t(3) * NT * 4) + align16(size_t(nwords) * 4) +
                      size_t(NT / 32) * (NT / 32) * 4;
  int nbuf = 2;
  size_t smem = 2 * stage_bytes<K>(seg) + rest;
  if (smem > kMaxSmem) {
    nbuf = 1;
    smem = stage_bytes<K>(seg) + rest;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int sh_async =
      (reinterpret_cast<uintptr_t>(sh3) & 3) == 0 && (S & 1) == 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd3_kernel<K, BAND, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwd3_kernel<K, BAND, NT><<<T, NT, smem, stream>>>(
      d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr, cnt_scr, idx_scr, gpf, gsh, R,
      S, seg, e2h, max_depth, log_kill, compact, band, nbuf, sh_async);
  return cudaGetLastError();
}

template <int K, bool BAND>
cudaError_t launch_nt(const float* d8, const float* pf,
                      const __nv_bfloat16* sh3, const int* n_seg_t,
                      const float* g_l, const float* g_beta, float* lb_scr,
                      int* cnt_scr, int* idx_scr, float* gpf,
                      __nv_bfloat16* gsh, int T, int R, int S, int seg,
                      float e2h, int max_depth, float log_kill, int compact,
                      int band, cudaStream_t stream) {
  switch (block_threads(R)) {
    case 256:
      return launch_as<K, BAND, 256>(d8, pf, sh3, n_seg_t, g_l, g_beta,
                                     lb_scr, cnt_scr, idx_scr, gpf, gsh, T, R,
                                     S, seg, e2h, max_depth, log_kill, compact,
                                     band, stream);
    case 512:
      return launch_as<K, BAND, 512>(d8, pf, sh3, n_seg_t, g_l, g_beta,
                                     lb_scr, cnt_scr, idx_scr, gpf, gsh, T, R,
                                     S, seg, e2h, max_depth, log_kill, compact,
                                     band, stream);
    default:
      return launch_as<K, BAND, 1024>(d8, pf, sh3, n_seg_t, g_l, g_beta,
                                      lb_scr, cnt_scr, idx_scr, gpf, gsh, T, R,
                                      S, seg, e2h, max_depth, log_kill,
                                      compact, band, stream);
  }
}

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, const float* g_l, const float* g_beta,
                   float* lb_scr, int* cnt_scr, int* idx_scr, float* gpf,
                   __nv_bfloat16* gsh, int T, int R, int S, int seg, float e2h,
                   int max_depth, float log_kill, int compact, int band,
                   cudaStream_t stream) {
  if (band == 0)
    return launch_nt<K, false>(d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr,
                               cnt_scr, idx_scr, gpf, gsh, T, R, S, seg, e2h,
                               max_depth, log_kill, compact, band, stream);
  return launch_nt<K, true>(d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr, cnt_scr,
                            idx_scr, gpf, gsh, T, R, S, seg, e2h, max_depth,
                            log_kill, compact, band, stream);
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
  if (!args_ok(T, R, S, seg, band))
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
