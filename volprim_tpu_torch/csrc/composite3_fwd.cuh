// Fused tile compositor, forward pass, for Hopper (sm_90a): the kernel
// template. composite3_fwd.cu instantiates it for the path (its C entry
// point composite3_fwd); composite3_fwd_abl.cu for the profiler's timing
// ablations (composite3_fwd_abl).
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
// columns once, ~64 B + 6k B per column, while every column meets R = 256
// or 512 rays), but FP32/SFU issue per (ray, column) pair and the
// shared-memory reads that broadcast each column to a warp. The design:
//   * drops, before the walk, every column whose bounding sphere misses the
//     tile's ray cone (d8 rows 3-7), with a block-wide ballot scan that
//     writes the survivors' indices in stream order to a device scratch
//     (exact: a dropped column has alpha = 0 for every ray of the tile);
//   * stages each stream segment in shared memory with cp.async, double
//     buffered: the next segment's copies are in flight while the current
//     one is walked (the banded walk, which spends most of a segment in its
//     window, keeps one buffer and a block more per SM). Columns are
//     [seg][16] f32 records, so a ray reads one
//     with three 16-byte broadcast loads (rows 0-11), and opacity and SH
//     only on a hit;
//   * a warp culls each staged segment again against the cone of its own
//     32 rays (a 4 x 8 pixel patch, ray_of_thread), which is several times
//     narrower than the tile's, and walks only its survivors, in stream
//     order (warp_keeps: conservative, with a margin ten times the f32
//     pair math's rounding, on a bounding radius that cull_radius checks
//     against the column's M, so that a quaternion off unit length drops
//     no hit);
//   * rejects a non-hit pair after ~30 multiplies and adds and one divide,
//     so exp and log1p run only on hits;
//   * stops a ray at its hit cap (every later alpha is 0) and a block when
//     all its rays are capped. After the beta_kill cutoff a ray skips the
//     emission work but keeps summing log1p(-alpha), so beta stays the full
//     capped product;
//   * with ``early_exit`` and no compaction (the TPU kernel's while-loop
//     walk, composite3.py:728-747), also stops a block before the first
//     segment at which every ray is capped or at or below log(beta_kill):
//     beta is then exp(log beta) where the tile stopped, and the walked
//     count is that segment's index. The vote is the same block-wide
//     __syncthreads_or; a saturated ray that is under its cap goes on
//     summing log1p(-alpha) while another ray keeps the block walking, as
//     every ray of the TPU tile does. The segment the double buffer
//     prefetched before the stopping vote is waited for after the loop, and
//     no copy starts after that vote;
//   * with the band, holds each ray's hits of the last 2B + 1 lanes in a
//     window in local memory (a ring masked to the band at run time), and
//     finishes a hit (its corrected weight and emission) B lanes after it,
//     visiting only the hits within B lanes: the cutoff tests the
//     corrected weight.
// A block has NT = 256, 512 or 1024 threads, with __launch_bounds__ sized
// for three blocks of 256 (80 registers) or two of 512 (64).
// The pair math, the culls, staging and the band live in
// composite3_common.cuh, shared with the backward kernel (composite3_bwd.cu)
// so that both take the same hit, cap, band and beta_kill decisions. The
// file is compiled with -fmad=false: the hit test compares q against e^2/2
// at a hard edge, and contracting the pair math into FMAs would round
// differently from the unfused plain version and flip borderline pairs.

#pragma once

#include "composite3_common.cuh"

namespace composite3 {

// Timing ablations of the forward (the TPU kernel's _ABL switches,
// composite3.py:47-56, swept by tools/profile_rf.py): each removes one piece
// of the work to attribute the kernel's time. Its results are wrong by
// design; the path never launches them (composite3_fwd_abl.cu only).
enum Ablation {
  kAblNone = 0,
  kAblNodepth = 1,  // no hit cap: every hit counts, no ray stops early
  kAblNoemis = 2,   // no SH emission product: L += w (1, 1.01, 1.02)
  kAblNotrans = 3,  // no exp / log1p: alpha = opac (1 - q), logt = -alpha,
                    // w = (1 + log beta) alpha
  kAblNocum = 4,    // no transmittance prefix: log beta stays 0
  kAblNoop = 5,     // no compaction and no walk: set-up, ray terms, outputs
  kAblNoop2 = 6,    // not even the ray terms: outputs only (launch floor)
  kAblStatic = 7,   // every segment of S / seg walked (n_seg_t ignored), no
                    // early exit of the block (neither stop)
  kAblFori = 8,     // the live segments, no early exit of the block (neither
                    // stop)
};

// blocks per SM the register budget is sized for: 64 registers a thread
// from 512 threads up (two blocks of 512, 32 warps), 80 at 256 (three)
template <int NT>
__host__ __device__ constexpr int fwd_min_blocks() {
  return NT == 256 ? 3 : (NT == 512 ? 2 : 1);
}

// One ray's walk of one staged segment, its warp's survivors in stream
// order (unbanded).
template <int K, int ABL>
__device__ __forceinline__ void walk_segment(
    const Stage& cur, const unsigned* s_mask, int n, const Ray& ray,
    const float* basis, float e2h, int max_depth, float log_kill,
    float& log_beta, int& count, float& l0, float& l1, float& l2) {
  const int nw = (n + 31) >> 5;
  for (int wd = 0; wd < nw; ++wd) {
    unsigned m = s_mask[wd];
    while (m) {
      const int j = (wd << 5) + __ffs(m) - 1;
      m &= m - 1;
      const float* col = cur.pf + j * kFeat;
      const float4* rec = reinterpret_cast<const float4*>(col);
      const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];  // rows 0-11
      Pair p;
      pair_peak(m0, m1, m2, ray, p);
      if (!(p.tp > 0.0f)) continue;
      if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
      const float opac = col[kOpacRow];
      float alpha;
      if constexpr (ABL == kAblNotrans) {
        alpha = fminf(opac * (1.0f - p.q), 0.9999f);
      } else {
        float dens, raw;
        alpha = pair_alpha(opac, p.q, dens, raw);
      }
      if (!(alpha > 0.0f)) continue;
      // capped: every later alpha is 0
      if (ABL != kAblNodepth && !under_cap(alpha, count, max_depth)) return;
      if (log_beta > log_kill) {
        const float w = ABL == kAblNotrans ? (1.0f + log_beta) * alpha
                                           : expf(log_beta) * alpha;
        if constexpr (ABL == kAblNoemis) {
          l0 = l0 + w;
          l1 = l1 + w * 1.01f;
          l2 = l2 + w * 1.02f;
        } else {
          float e0, e1, e2;
          emission<K>(basis, cur.sh + j * 3 * K, cur.col[j] & 1, e0, e1, e2);
          l0 = l0 + w * fmaxf(e0, 0.0f);
          l1 = l1 + w * fmaxf(e1, 0.0f);
          l2 = l2 + w * fmaxf(e2, 0.0f);
        }
      }
      if constexpr (ABL == kAblNotrans) {
        log_beta = log_beta - alpha;
      } else if constexpr (ABL != kAblNocum) {
        log_beta = log_beta + log1pf(-alpha);
      }
    }
  }
}

// One ray's walk of one staged segment with the order band: hits enter the
// window as they are walked; a hit is finished (its band correction, weight
// and emission) once the walk is B lanes past it, and every hit is finished
// at the segment's end.
template <int K, int CAP>
__device__ __forceinline__ void walk_segment_band(
    const Stage& cur, const unsigned* s_mask, int n, const Ray& ray,
    const float* basis, float e2h, int max_depth, float log_kill, int band,
    BandWindow<false, CAP>& win, float& log_beta, int& count, float& l0,
    float& l1, float& l2) {
  win.reset(2 * band + 1);  // the hits of lanes [j - 2B, j]
  auto finish = [&](int x) {
    const BandHit& h = win.at(x);
    const float lw = h.lbe + band_corr(win, x, band);
    if (lw > log_kill) {
      const float w = expf(lw) * h.alpha;
      float e0, e1, e2;
      emission<K>(basis, cur.sh + h.lane * 3 * K, cur.col[h.lane] & 1, e0, e1,
                  e2);
      l0 = l0 + w * fmaxf(e0, 0.0f);
      l1 = l1 + w * fmaxf(e1, 0.0f);
      l2 = l2 + w * fmaxf(e2, 0.0f);
    }
  };
  const int nw = (n + 31) >> 5;
  bool capped = false;
  for (int wd = 0; wd < nw && !capped; ++wd) {
    unsigned m = s_mask[wd];
    while (m) {
      const int j = (wd << 5) + __ffs(m) - 1;
      m &= m - 1;
      const float* col = cur.pf + j * kFeat;
      const float4* rec = reinterpret_cast<const float4*>(col);
      const float4 m0 = rec[0], m1 = rec[1], m2 = rec[2];
      Pair p;
      pair_peak(m0, m1, m2, ray, p);
      if (!(p.tp > 0.0f)) continue;
      if (!pair_hit(m0, m1, m2, ray, e2h, p)) continue;
      float dens, raw;
      const float alpha = pair_alpha(col[kOpacRow], p.q, dens, raw);
      if (!(alpha > 0.0f)) continue;
      if (!under_cap(alpha, count, max_depth)) {  // every later alpha is 0
        capped = true;
        break;
      }
      // the hits whose band is complete: nothing after lane j - 1 reaches them
      for (; win.i2 < win.tail && win.at(win.i2).lane + band < j; ++win.i2)
        finish(win.i2);
      win.drop((win.i2 < win.tail ? win.at(win.i2).lane : j) - band, win.i2);
      const float logt = log1pf(-alpha);
      win.push(BandHit{j, entry_key(p, e2h), logt, alpha, log_beta});
      log_beta = log_beta + logt;
    }
  }
  for (; win.i2 < win.tail; ++win.i2) finish(win.i2);
}

template <int K, bool BAND, int NT, int ABL>
__global__ void __launch_bounds__(NT, fwd_min_blocks<NT>())
    fwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t, float* __restrict__ out_l,
                float* __restrict__ out_beta, int* __restrict__ out_walked,
                int* __restrict__ out_live, int* __restrict__ idx_scr, int R,
                int S, int seg, float e2h, int max_depth, float log_kill,
                int compact, int band, int early_exit, int nbuf,
                int sh_async) {
  extern __shared__ __align__(16) unsigned char smem[];
  // nbuf staging buffers (stage_at), then the masks, the scan's counts and
  // the warps' cones (mask_bytes)
  const int nwords = (seg + 31) >> 5;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* sp = smem + nbuf * stage_bytes<K>(seg);
  unsigned* s_mask = reinterpret_cast<unsigned*>(sp) + warp * nwords;
  int* s_warp = reinterpret_cast<int*>(
      sp + align16(size_t(NT / 32) * nwords * 4));
  float* s_cone = reinterpret_cast<float*>(s_warp + 32) + warp * 8;

  const int ray_i = ray_of_thread(tid, R, NT);
  const bool ray_ok = ray_i < R;
  const size_t o = static_cast<size_t>(t) * R + ray_i;
  if constexpr (ABL == kAblNoop2) {
    if (ray_ok) {
      out_l[3 * o + 0] = 0.0f;
      out_l[3 * o + 1] = 0.0f;
      out_l[3 * o + 2] = 0.0f;
      out_beta[o] = 1.0f;
    }
    if (tid == 0) out_walked[t] = out_live[t] = 0;
    return;
  }

  const float* d8t = d8 + static_cast<size_t>(t) * 8 * R;
  const float* pft = pf + static_cast<size_t>(t) * kFeat * S;
  const __nv_bfloat16* sht = sh3 + static_cast<size_t>(t) * 3 * K * S;
  int* idx = compact ? idx_scr + static_cast<size_t>(t) * S : nullptr;

  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray_ok) {
    dx = d8t[ray_i];
    dy = d8t[R + ray_i];
    dz = d8t[2 * R + ray_i];
  }
  const Ray ray = make_ray(dx, dy, dz);
  float basis[K];
  ray_basis<K>(dx, dy, dz, basis);
  store_cone(warp_cone(ray, ray_ok), s_cone, lane);

  // the stream: the live segments' columns, or their survivors
  int nseg = max(0, min(n_seg_t[t], S / seg));
  if (ABL == kAblStatic) nseg = S / seg;
  if (ABL == kAblNoop) nseg = 0;
  int n_cols = nseg * seg;
  if (compact && ABL != kAblNoop)
    n_cols = compact_stream(pft, S, n_cols, idx, s_warp, tile_cone(d8t, R));
  const int n_str = (n_cols + seg - 1) / seg;

  float log_beta = 0.0f, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int count = 0, walked = n_str;
  // the saturation stop (early exit): the TPU kernel takes it only without
  // compaction; the barrier-only ablations take no stop at all
  const bool sat_stop = early_exit && !compact;
  [[maybe_unused]] BandWindow<false, BAND ? kBandCap : 1> win;

  if (nbuf == 2 && n_str > 0) {
    stage_async<K, true>(pft, sht, idx, stage_at<K>(smem, seg, 0), S, 0,
                         min(seg, n_cols), sh_async);
    cp_async_commit();
  }
  for (int si = 0; si < n_str; ++si) {
    const bool walks = ray_ok && count <= max_depth;
    const bool active = walks && (!sat_stop || log_beta > log_kill);
    // also the barrier that retires the reads of the buffer restaged next
    if (ABL == kAblStatic || ABL == kAblFori) {
      __syncthreads();
    } else if (!__syncthreads_or(active)) {
      walked = si;
      break;
    }
    const Stage cur = stage_at<K>(smem, seg, nbuf == 2 ? si & 1 : 0);
    const int n = min(seg, n_cols - si * seg);
    if (nbuf == 2) {
      if (si + 1 < n_str)
        stage_async<K, true>(pft, sht, idx,
                             stage_at<K>(smem, seg, (si + 1) & 1), S,
                             (si + 1) * seg, min(seg, n_cols - (si + 1) * seg),
                             sh_async);
      cp_async_commit();
      cp_async_wait<1>();  // this segment's copies have landed
    } else {
      stage_async<K, true>(pft, sht, idx, cur, S, si * seg, n, sh_async);
      cp_async_commit();
      cp_async_wait<0>();
    }
    stage_radii(cur, n, e2h);
    __syncthreads();
    warp_survivors(s_cone, cur.pf, n, s_mask, lane);
    if (!walks) continue;
    if constexpr (BAND) {
      walk_segment_band<K>(cur, s_mask, n, ray, basis, e2h, max_depth,
                           log_kill, band, win, log_beta, count, l0, l1, l2);
    } else {
      walk_segment<K, ABL>(cur, s_mask, n, ray, basis, e2h, max_depth,
                           log_kill, log_beta, count, l0, l1, l2);
    }
  }
  cp_async_wait<0>();  // the prefetch still in flight after a stop

  if (ray_ok) {
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

template <int K, bool BAND, int NT, int ABL>
cudaError_t fwd_launch_as(const float* d8, const float* pf,
                          const __nv_bfloat16* sh3, const int* n_seg_t,
                          float* out_l, float* out_beta, int* out_walked,
                          int* out_live, int* idx_scr, int T, int R, int S,
                          int seg, float e2h, int max_depth, float log_kill,
                          int compact, int band, int early_exit,
                          cudaStream_t stream) {
  // Double-buffered when two buffers fit, else one. The banded walk stages
  // through one buffer: it spends most of a segment in its window, and the
  // second buffer's shared memory would cost a block per SM (at 256
  // threads, four blocks instead of three).
  int nbuf = BAND ? 1 : 2;
  size_t smem = nbuf * stage_bytes<K>(seg) + mask_bytes(seg, NT);
  if (smem > kMaxSmem) {
    nbuf = 1;
    smem = stage_bytes<K>(seg) + mask_bytes(seg, NT);
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int sh_async =
      (reinterpret_cast<uintptr_t>(sh3) & 3) == 0 && (S & 1) == 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd3_kernel<K, BAND, NT, ABL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fwd3_kernel<K, BAND, NT, ABL><<<T, NT, smem, stream>>>(
      d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr, R,
      S, seg, e2h, max_depth, log_kill, compact, band, early_exit, nbuf,
      sh_async);
  return cudaGetLastError();
}

// the instantiation for a tile of R rays and SH width K
template <int K, bool BAND, int ABL>
cudaError_t fwd_launch_nt(const float* d8, const float* pf,
                          const __nv_bfloat16* sh3, const int* n_seg_t,
                          float* out_l, float* out_beta, int* out_walked,
                          int* out_live, int* idx_scr, int T, int R, int S,
                          int seg, float e2h, int max_depth, float log_kill,
                          int compact, int band, int early_exit,
                          cudaStream_t stream) {
  switch (block_threads(R)) {
    case 256:
      return fwd_launch_as<K, BAND, 256, ABL>(
          d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr,
          T, R, S, seg, e2h, max_depth, log_kill, compact, band, early_exit,
          stream);
    case 512:
      return fwd_launch_as<K, BAND, 512, ABL>(
          d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr,
          T, R, S, seg, e2h, max_depth, log_kill, compact, band, early_exit,
          stream);
    default:
      return fwd_launch_as<K, BAND, 1024, ABL>(
          d8, pf, sh3, n_seg_t, out_l, out_beta, out_walked, out_live, idx_scr,
          T, R, S, seg, e2h, max_depth, log_kill, compact, band, early_exit,
          stream);
  }
}

}  // namespace composite3
