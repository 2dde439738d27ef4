// Fused tile compositor, forward pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/composite3.py:496
// (_fwd3_kernel, with its compaction phase _compact_phase :403 and the pair
// math _fwd3_core :284). The plain PyTorch version of the same function is
// composite_tiles3_reference in volprim_tpu_torch/kernels/composite3.py; the
// wrapper composite_tiles3 there launches this kernel for CUDA tensors.
//
// What it computes, per tile t (one block) and ray r (one thread), over the
// tile's packed primitive columns in stream order:
//   a = F6(d) . m6,  b = d . u,  t* = -b / a,  p = w + t* d,
//   q = p^T (M/2) p                      (closest approach, halved-M rows)
//   hit   = q <= e^2/2  and  t* > 0  and  q - b t* > e^2/2
//   alpha = min(opac exp(-q), 0.9999), zeroed once the ray's hit count
//           passes max_depth
//   L    += exp(log_beta) alpha max(basis(d) . sh, 0)   while log_beta > log(beta_kill)
//   log_beta += log1p(-alpha)
// and writes L [T, R, 3] and beta = exp(log_beta) [T, R]. The basis column 0
// is 1.0 (the DC row of the table carries Y00 dc + 0.5) and the basis is
// rounded to bf16 before the emission product, as the TPU kernel does; the
// product accumulates in f32.
//
// With compaction (``compact``) the tile's surviving columns form one packed
// stream, cut into segments of seg; with the order band (``order_band`` =
// B > 0) each hit's transmittance prefix is corrected for the entry order
// of the hits within B lanes of it in its stream segment
// (composite3_common.cuh). It also writes, per tile, the stream segments it
// walked and the stream's segment count (the TPU kernel's profiling
// columns 4-5).
//
// What bounds it on this card: not device-memory bytes (each tile reads its
// columns once, ~64 B + 6k B per column, while every column meets R = 512
// rays), but FP32/SFU issue per (ray, column) pair and the shared-memory
// reads that broadcast each column to the block. The design therefore
//   * drops, before the walk, every column whose bounding sphere misses the
//     tile's ray cone (d8 rows 3-7): one thread per column evaluates the
//     mask on the column's rows 9-11 and 14, and a block-wide ballot scan
//     writes the survivors' indices in stream order to a device scratch
//     (exact: a dropped column has alpha = 0 for every ray of the tile);
//   * stages one stream segment per block in shared memory as an array of
//     16-float records (gathered through those indices), so a ray reads a
//     column with three 16-byte broadcast loads (rows 0-11) and touches
//     opacity and SH only on a hit;
//   * rejects a non-hit pair after ~30 multiplies and adds and one divide,
//     so exp and log1p run only on hits;
//   * stops a ray at its hit cap (every later alpha is 0) and a block when
//     all its rays are capped. After the beta_kill cutoff a ray skips the
//     emission work but keeps summing log1p(-alpha), so beta stays the full
//     capped product;
//   * with the band, holds each ray's hits of the last 2B + 1 lanes in a
//     window in local memory and finishes a hit (its corrected weight and
//     emission) B lanes after it, visiting only the hits within B lanes:
//     the cutoff tests the corrected weight, which can exceed the
//     uncorrected one.
// The pair math, compaction, staging and the band live in
// composite3_common.cuh, shared with the backward kernel (composite3_bwd.cu)
// so that both take the same hit, cap, band and beta_kill decisions. The
// file is compiled with -fmad=false: the hit test compares q against e^2/2
// at a hard edge, and contracting the pair math into FMAs would round
// differently from the unfused plain version and flip borderline pairs.

#include "composite3_common.cuh"

namespace {

using namespace composite3;

// One ray's walk of one staged stream segment of n columns, with the order
// band: hits enter the window as they are walked; a hit is finished (its
// band correction, weight and emission) once the walk is B lanes past it,
// and every hit is finished at the segment's end.
template <int K>
__device__ void walk_band(const float* s_pf, const __nv_bfloat16* s_sh, int n,
                          const Ray& ray, const float* basis, float e2h,
                          int max_depth, float log_kill, int band,
                          BandWindow<false>& win, float& log_beta, int& count,
                          float& l0, float& l1, float& l2) {
  win.reset(2 * band + 1);  // the hits of lanes [j - 2B, j]
  auto finish = [&](int x) {
    const BandHit& h = win.at(x);
    const float lw = h.lbe + band_corr(win, x, band);
    if (lw > log_kill) {
      const float w = expf(lw) * h.alpha;
      float e0, e1, e2;
      emission<K>(basis, s_sh + h.lane * 3 * K, e0, e1, e2);
      l0 = l0 + w * fmaxf(e0, 0.0f);
      l1 = l1 + w * fmaxf(e1, 0.0f);
      l2 = l2 + w * fmaxf(e2, 0.0f);
    }
  };
  for (int j = 0; j < n; ++j) {
    const float4* rec = reinterpret_cast<const float4*>(s_pf + j * kFeat);
    const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
    Pair p;
    pair_peak(m0, m1, m2, ray, p);
    if (!(p.tp > 0.0f)) continue;
    if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
    float dens, raw;
    const float alpha = pair_alpha(s_pf[j * kFeat + kOpacRow], p.q, dens, raw);
    if (!(alpha > 0.0f)) continue;
    if (!under_cap(alpha, count, max_depth)) break;  // every later alpha is 0
    // the hits whose band is complete: nothing after lane j - 1 reaches them
    for (; win.i2 < win.tail && win.at(win.i2).lane + band < j; ++win.i2)
      finish(win.i2);
    win.drop((win.i2 < win.tail ? win.at(win.i2).lane : j) - band, win.i2);
    const float logt = log1pf(-alpha);
    win.push(BandHit{j, entry_key(p, e2h), logt, alpha, log_beta});
    log_beta = log_beta + logt;
  }
  for (; win.i2 < win.tail; ++win.i2) finish(win.i2);
}

template <int K, bool BAND>
__global__ void __launch_bounds__(kMaxRays)
    fwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t, float* __restrict__ out_l,
                float* __restrict__ out_beta, int* __restrict__ out_walked,
                int* __restrict__ out_live, int* __restrict__ idx_scr, int R,
                int S, int seg, float e2h, int max_depth, float log_kill,
                int compact, int band) {
  // shared memory: columns as [seg][16] f32 records, the lanes' tile
  // columns, one count per warp for the scan, SH as [seg][3K] bf16
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pf = reinterpret_cast<float*>(smem);
  int* s_col = reinterpret_cast<int*>(s_pf + seg * kFeat);
  int* s_warp = s_col + seg;
  __nv_bfloat16* s_sh = reinterpret_cast<__nv_bfloat16*>(s_warp + 32);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const float* d8t = d8 + static_cast<size_t>(t) * 8 * R;
  const float* pft = pf + static_cast<size_t>(t) * kFeat * S;
  const __nv_bfloat16* sht = sh3 + static_cast<size_t>(t) * 3 * K * S;
  int* idx = compact ? idx_scr + static_cast<size_t>(t) * S : nullptr;

  const bool ray_ok = tid < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray_ok) {
    dx = d8t[tid];
    dy = d8t[R + tid];
    dz = d8t[2 * R + tid];
  }
  const Ray ray = make_ray(dx, dy, dz);
  float basis[K];
  ray_basis<K>(dx, dy, dz, basis);

  // the stream: the live segments' columns, or their survivors
  const int nseg = max(0, min(n_seg_t[t], S / seg));
  int n_cols = nseg * seg;
  if (compact)
    n_cols = compact_stream(pft, S, n_cols, idx, s_warp, tile_cone(d8t, R));
  const int n_str = (n_cols + seg - 1) / seg;

  float log_beta = 0.0f, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int count = 0, walked = n_str;
  [[maybe_unused]] BandWindow<false> win;

  for (int si = 0; si < n_str; ++si) {
    const bool active = ray_ok && count <= max_depth;
    // also the barrier that retires the previous segment's shared reads
    if (!__syncthreads_or(active)) {
      walked = si;
      break;
    }
    const int n = min(seg, n_cols - si * seg);
    stage_stream<K>(pft, sht, idx, s_pf, s_sh, s_col, S, si * seg, n, tid,
                    nthreads);
    __syncthreads();
    if (!active) continue;
    if constexpr (BAND) {
      walk_band<K>(s_pf, s_sh, n, ray, basis, e2h, max_depth, log_kill, band,
                   win, log_beta, count, l0, l1, l2);
      continue;
    }
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
      // capped: every later alpha is 0
      if (!under_cap(alpha, count, max_depth)) break;
      if (log_beta > log_kill) {
        const float w = expf(log_beta) * alpha;
        float e0, e1, e2;
        emission<K>(basis, s_sh + j * 3 * K, e0, e1, e2);
        l0 = l0 + w * fmaxf(e0, 0.0f);
        l1 = l1 + w * fmaxf(e1, 0.0f);
        l2 = l2 + w * fmaxf(e2, 0.0f);
      }
      log_beta = log_beta + log1pf(-alpha);
    }
  }

  if (ray_ok) {
    const size_t o = static_cast<size_t>(t) * R + tid;
    out_l[3 * o + 0] = l0;
    out_l[3 * o + 1] = l1;
    out_l[3 * o + 2] = l2;
    out_beta[o] = expf(log_beta);
  }
  if (tid == 0) {
    out_walked[t] = walked;
    out_live[t] = n_str;
  }
}

template <int K, bool BAND>
cudaError_t launch_as(const float* d8, const float* pf,
                      const __nv_bfloat16* sh3, const int* n_seg_t,
                      float* out_l, float* out_beta, int* out_walked,
                      int* out_live, int* idx_scr, int T, int R, int S,
                      int seg, float e2h, int max_depth, float log_kill,
                      int compact, int band, cudaStream_t stream) {
  const int threads = (R + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(seg) * kFeat * sizeof(float) +
                      static_cast<size_t>(seg) * sizeof(int) +
                      32 * sizeof(int) +
                      static_cast<size_t>(seg) * 3 * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd3_kernel<K, BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fwd3_kernel<K, BAND><<<T, threads, smem, stream>>>(
      d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr, R,
      S, seg, e2h, max_depth, log_kill, compact, band);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, float* out_l, float* out_beta,
                   int* out_walked, int* out_live, int* idx_scr, int T, int R,
                   int S, int seg, float e2h, int max_depth, float log_kill,
                   int compact, int band, cudaStream_t stream) {
  if (band > 0)
    return launch_as<K, true>(d8, pf, sh3, n_seg_t, out_l, out_beta,
                              out_walked, out_live, idx_scr, T, R, S, seg, e2h,
                              max_depth, log_kill, compact, band, stream);
  return launch_as<K, false>(d8, pf, sh3, n_seg_t, out_l, out_beta,
                             out_walked, out_live, idx_scr, T, R, S, seg, e2h,
                             max_depth, log_kill, compact, band, stream);
}

}  // namespace

// C entry point, bound with ctypes. Tensors: d8 [T, 8, R] f32, pf [T, 16, S]
// f32, sh3 [T, 3k, S] bf16, n_seg_t [T] int32, out_l [T, R, 3] f32,
// out_beta [T, R] f32, out_walked and out_live [T] int32, and with compact a
// scratch idx_scr [T, S] int32, all contiguous on one device; 0 <= band <=
// kMaxBand. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it does not synchronise.
extern "C" int composite3_fwd(const void* d8, const void* pf, const void* sh3,
                              const void* n_seg_t, void* out_l, void* out_beta,
                              void* out_walked, void* out_live, void* idx_scr,
                              int T, int R, int S, int seg, int k, float e2h,
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
  auto* l = static_cast<float*>(out_l);
  auto* b = static_cast<float*>(out_beta);
  auto* wk = static_cast<int*>(out_walked);
  auto* lv = static_cast<int*>(out_live);
  auto* ix = static_cast<int*>(idx_scr);
  switch (k) {
    case 1:
      return static_cast<int>(launch<1>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, st));
    case 4:
      return static_cast<int>(launch<4>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, st));
    case 9:
      return static_cast<int>(launch<9>(d, p, s, n, l, b, wk, lv, ix, T, R, S,
                                        seg, e2h, max_depth, log_kill, compact,
                                        band, st));
    case 16:
      return static_cast<int>(launch<16>(d, p, s, n, l, b, wk, lv, ix, T, R,
                                         S, seg, e2h, max_depth, log_kill,
                                         compact, band, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* composite3_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
