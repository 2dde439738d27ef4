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
// Every hit, cap and beta_kill decision is the forward kernel's: both
// evaluate the pair with composite3_common.cuh and are built with
// -fmad=false, and the carries are the same sequential f32 sums of
// log1p(-alpha). With compaction both walks visit the survivors of the
// forward's ballot scan; a survivor's adjoint goes straight to its original
// slot and every other slot of a live segment is written as 0 (a dropped
// column has alpha = 0 for every ray of the tile, so its adjoint is 0).
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

template <int K>
__global__ void __launch_bounds__(kMaxRays)
    bwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t,
                const float* __restrict__ g_l,
                const float* __restrict__ g_beta, float* __restrict__ lb_scr,
                int* __restrict__ cnt_scr, float* __restrict__ gpf,
                __nv_bfloat16* __restrict__ gsh, int R, int S, int seg,
                float e2h, int max_depth, float log_kill, int compact) {
  constexpr int kAcc = 13 + 3 * K;  // accumulated rows per column
  // shared memory: columns as [seg][16] f32 records, the adjoint
  // accumulator [seg][13 + 3K] f32, the survivors' indices, one count per
  // warp for the scan, SH as [seg][3K] bf16
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pf = reinterpret_cast<float*>(smem);
  float* s_acc = s_pf + seg * kFeat;
  int* s_idx = reinterpret_cast<int*>(s_acc + seg * kAcc);
  int* s_warp = s_idx + seg;
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

  const bool ray_ok = tid < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float gl0 = 0.0f, gl1 = 0.0f, gl2 = 0.0f, gbeta = 0.0f;
  if (ray_ok) {
    dx = d8t[tid];
    dy = d8t[R + tid];
    dz = d8t[2 * R + tid];
    const size_t o = static_cast<size_t>(t) * R + tid;
    gl0 = g_l[3 * o + 0];
    gl1 = g_l[3 * o + 1];
    gl2 = g_l[3 * o + 2];
    gbeta = g_beta[o];
  }
  const Ray ray = make_ray(dx, dy, dz);
  float basis[K], basis_f[K];
  ray_basis<K>(dx, dy, dz, basis);
  ray_basis_f32<K>(dx, dy, dz, basis_f);
  const float ax0 = d8t[3 * R], ax1 = d8t[4 * R], ax2 = d8t[5 * R];
  const float cone_ch = d8t[6 * R], cone_sh = d8t[7 * R];

  const int nseg = max(0, min(n_seg_t[t], n_seg_all));

  // ---- 1. forward pass: per-segment carries -----------------------------
  float log_beta = 0.0f;
  int count = 0;
  int nwalk = nseg;  // segments some ray of the tile enters under its cap
  for (int si = 0; si < nseg; ++si) {
    const bool active = ray_ok && count <= max_depth;
    if (!__syncthreads_or(active)) {
      nwalk = si;
      break;
    }
    if (ray_ok) {
      lbt[si * R + tid] = log_beta;
      cntt[si * R + tid] = count;
    }
    stage_segment<K>(pft, sht, s_pf, nullptr, S, si * seg, seg, tid,
                     nthreads);
    __syncthreads();
    const int live = compact ? compact_segment(s_pf, s_idx, s_warp, seg, ax0,
                                               ax1, ax2, cone_ch, cone_sh)
                             : seg;
    if (active) {
      for (int j = 0; j < live; ++j) {
        const int c = compact ? s_idx[j] : j;
        const float4* rec = reinterpret_cast<const float4*>(s_pf + c * kFeat);
        const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
        Pair p;
        pair_peak(m0, m1, m2, ray, p);
        if (!(p.tp > 0.0f)) continue;
        if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
        float dens, raw;
        const float alpha =
            pair_alpha(s_pf[c * kFeat + kOpacRow], p.q, dens, raw);
        if (!(alpha > 0.0f)) continue;
        if (!under_cap(alpha, count, max_depth)) break;
        log_beta = log_beta + log1pf(-alpha);
      }
    }
  }
  float g_lb = gbeta * expf(log_beta);

  // ---- 2. segments in reverse ---------------------------------------------
  for (int si = n_seg_all - 1; si >= 0; --si) {
    const int col0 = si * seg;
    __syncthreads();  // the previous segment's shared reads are done
    if (si >= nwalk) {
      // dead segment, or one no ray reaches under its cap: zero adjoints
      for (int i = tid; i < kFeat * seg; i += nthreads) {
        const int row = i / seg, c = i - row * seg;
        gpft[static_cast<size_t>(row) * S + col0 + c] = 0.0f;
      }
      for (int i = tid; i < 3 * K * seg; i += nthreads) {
        const int row = i / seg, c = i - row * seg;
        gsht[static_cast<size_t>(row) * S + col0 + c] = __float2bfloat16_rn(0.0f);
      }
      continue;
    }
    stage_segment<K>(pft, sht, s_pf, s_sh, S, col0, seg, tid, nthreads);
    for (int i = tid; i < kAcc * seg; i += nthreads) s_acc[i] = 0.0f;
    __syncthreads();
    const int live = compact ? compact_segment(s_pf, s_idx, s_warp, seg, ax0,
                                               ax1, ax2, cone_ch, cone_sh)
                             : seg;

    float lb0 = 0.0f;
    int cnt0 = max_depth + 1;
    if (ray_ok) {
      lb0 = lbt[si * R + tid];
      cnt0 = cntt[si * R + tid];
    }

    // walk A: sum of g_lw over the segment (f64, see walk B)
    double sum_glw = 0.0;
    if (cnt0 <= max_depth) {
      float lb = lb0;
      int cnt = cnt0;
      for (int j = 0; j < live; ++j) {
        const int c = compact ? s_idx[j] : j;
        const float4* rec = reinterpret_cast<const float4*>(s_pf + c * kFeat);
        const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
        Pair p;
        pair_peak(m0, m1, m2, ray, p);
        if (!(p.tp > 0.0f)) continue;
        if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
        float dens, raw;
        const float alpha =
            pair_alpha(s_pf[c * kFeat + kOpacRow], p.q, dens, raw);
        if (!(alpha > 0.0f)) continue;
        if (!under_cap(alpha, cnt, max_depth)) break;
        if (lb > log_kill) {
          const float w = expf(lb) * alpha;
          float e0, e1, e2;
          emission<K>(basis, s_sh + c * 3 * K, e0, e1, e2);
          const float g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                            gl2 * fmaxf(e2, 0.0f);
          sum_glw += static_cast<double>(g_w * w);
        }
        lb = lb + log1pf(-alpha);
      }
    }

    // walk B: per-pair adjoints, reduced over the block per column
    {
      float lb = lb0;
      int cnt = cnt0;
      bool done = cnt0 > max_depth;
      // the suffix sum of g_lw is the total less the inclusive prefix, both
      // in f64: in f32 the difference of two long sums loses the small
      // suffixes at a segment's end
      double prefix = 0.0;
      for (int j = 0; j < live; ++j) {
        if (!__any_sync(kFull, !done)) break;  // the whole warp is capped
        const int c = compact ? s_idx[j] : j;
        float acc[13];
        float acc_sh[3 * K];
#pragma unroll
        for (int i = 0; i < 13; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < 3 * K; ++i) acc_sh[i] = 0.0f;
        bool has = false, has_sh = false;
        const float* col = s_pf + c * kFeat;
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
              emission<K>(basis, s_sh + c * 3 * K, e0, e1, e2);
              g_w = gl0 * fmaxf(e0, 0.0f) + gl1 * fmaxf(e1, 0.0f) +
                    gl2 * fmaxf(e2, 0.0f);
              const float ge0 = e0 > 0.0f ? gl0 * w : 0.0f;
              const float ge1 = e1 > 0.0f ? gl1 * w : 0.0f;
              const float ge2 = e2 > 0.0f ? gl2 * w : 0.0f;
              has_sh = true;
#pragma unroll
              for (int k = 0; k < K; ++k) {
                acc_sh[k] = basis_f[k] * ge0;
                acc_sh[K + k] = basis_f[k] * ge1;
                acc_sh[2 * K + k] = basis_f[k] * ge2;
              }
            }
            const float g_lw = g_w * w;
            prefix += static_cast<double>(g_lw);
            const float g_logt = g_lb + static_cast<float>(sum_glw - prefix);
            const float g_alpha = (alive ? g_w * exp_lw : 0.0f) +
                                  g_logt * (-1.0f / (1.0f - alpha));
            const float g_raw = raw < 0.9999f ? g_alpha : 0.0f;
            const float g_q = p.q_raw > 0.0f ? -(g_raw * opac * dens) : 0.0f;
            // q = m11 px^2 + m22 py^2 + m33 pz^2 + m12_2 px py
            //   + m13_2 px pz + m23_2 py pz
            const float g_px =
                g_q * (2.0f * m0.x * p.px + m0.w * p.py + m1.x * p.pz);
            const float g_py =
                g_q * (2.0f * m0.y * p.py + m0.w * p.px + m1.y * p.pz);
            const float g_pz =
                g_q * (2.0f * m0.z * p.pz + m1.x * p.px + m1.y * p.py);
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
            if (alpha > 0.0f) lb = lb + log1pf(-alpha);
          }
        }
        float* dst = s_acc + c * kAcc;
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
    }
    g_lb = g_lb + static_cast<float>(sum_glw);
    __syncthreads();

    // write the segment's adjoints: rows 13-15 of gpf are 0
    for (int i = tid; i < kFeat * seg; i += nthreads) {
      const int row = i / seg, c = i - row * seg;
      gpft[static_cast<size_t>(row) * S + col0 + c] =
          row < 13 ? s_acc[c * kAcc + row] : 0.0f;
    }
    for (int i = tid; i < 3 * K * seg; i += nthreads) {
      const int row = i / seg, c = i - row * seg;
      gsht[static_cast<size_t>(row) * S + col0 + c] =
          __float2bfloat16_rn(s_acc[c * kAcc + 13 + row]);
    }
  }
}

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, const float* g_l, const float* g_beta,
                   float* lb_scr, int* cnt_scr, float* gpf, __nv_bfloat16* gsh,
                   int T, int R, int S, int seg, float e2h, int max_depth,
                   float log_kill, int compact, cudaStream_t stream) {
  const int threads = (R + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(seg) * (kFeat + 13 + 3 * K) * sizeof(float) +
      static_cast<size_t>(seg) * sizeof(int) + 32 * sizeof(int) +
      static_cast<size_t>(seg) * 3 * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd3_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwd3_kernel<K><<<T, threads, smem, stream>>>(
      d8, pf, sh3, n_seg_t, g_l, g_beta, lb_scr, cnt_scr, gpf, gsh, R, S, seg,
      e2h, max_depth, log_kill, compact);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Tensors: d8 [T, 8, R] f32, pf [T, 16, S]
// f32, sh3 [T, 3k, S] bf16, n_seg_t [T] int32, g_l [T, R, 3] f32,
// g_beta [T, R] f32, scratch lb_scr [T, S / seg, R] f32 and cnt_scr
// [T, S / seg, R] int32, outputs gpf [T, 16, S] f32 and gsh [T, 3k, S] bf16,
// all contiguous on one device. Every output element is written. Launches
// on `stream` and returns the launch's cudaError_t (0 on success); it does
// not synchronise.
extern "C" int composite3_bwd(const void* d8, const void* pf, const void* sh3,
                              const void* n_seg_t, const void* g_l,
                              const void* g_beta, void* lb_scr, void* cnt_scr,
                              void* gpf, void* gsh, int T, int R, int S,
                              int seg, int k, float e2h, int max_depth,
                              float log_kill, int compact, void* stream) {
  if (T < 0 || R < 1 || R > kMaxRays || seg < 1 || S < seg || S % seg != 0)
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
  auto* gp = static_cast<float*>(gpf);
  auto* gs = static_cast<__nv_bfloat16*>(gsh);
  switch (k) {
    case 1:
      return static_cast<int>(launch<1>(d, p, s, n, gl, gb, lb, cn, gp, gs, T,
                                        R, S, seg, e2h, max_depth, log_kill,
                                        compact, st));
    case 4:
      return static_cast<int>(launch<4>(d, p, s, n, gl, gb, lb, cn, gp, gs, T,
                                        R, S, seg, e2h, max_depth, log_kill,
                                        compact, st));
    case 9:
      return static_cast<int>(launch<9>(d, p, s, n, gl, gb, lb, cn, gp, gs, T,
                                        R, S, seg, e2h, max_depth, log_kill,
                                        compact, st));
    case 16:
      return static_cast<int>(launch<16>(d, p, s, n, gl, gb, lb, cn, gp, gs, T,
                                         R, S, seg, e2h, max_depth, log_kill,
                                         compact, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* composite3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
