// The forward of the v1 and v2 tile compositors, for Hopper (sm_90a): the
// kernel of composite_fwd.cu (v1) and composite2_fwd.cu (v2), on the pair
// math of composite12_common.cuh. It writes L [T, R, 3] and beta [T, R] as
// composite.py:38 / composite2.py:105 do.
//
// One block of NT = 256, 512 or 1024 threads per tile (the smallest that
// holds R), one thread per ray (each warp a 4 x 8 pixel patch of a 16 x 16
// tile, ray_of_thread), instantiated as fwd12_kernel<V, K, NT>:
// v2 over its k live SH coefficients (K = 1, 4, 9, 16); v1 once per NT
// with K = 16, the most it takes: v1's basis is an input with 16 columns
// of which rf_tiled fills the first k, so the block finds its live count
// kb (the last basis column that is nonzero for one of its rays, plus one)
// in-kernel, by a block-wide OR, without a read back to the host.
//
// The tile's columns are taken in windows of W (at most NT, one per
// thread). A window's columns of opacity > 0 (and NaN or -inf: walked as
// before) are compacted, in order, into a staging buffer with cp.async:
// 12-float records (the live features, c0, the opacity) and the kb live SH
// coefficients of each channel. Every ray then walks the buffer in stream
// order; a window with no such column is neither staged nor walked. A
// column of opacity <= 0 (finite) gives alpha <= 0 at every hit, which the
// walk would drop after the full pair math: it touches neither the count,
// nor log beta, nor L, so skipping it keeps every result bit. v1 stages
// the next window into a second buffer while it walks the current one; v2
// keeps one buffer (fwd_nbuf). The basis rows [kb][NT] sit in shared
// memory beside the buffers: the emission (composite12_common.cuh's, the
// backward's too) reads them only at hits, which are rare.
//
// Per pair: a, b, c in the plain version's fixed order (-fmad=false), then
// the early miss of pair_hit_walk (most pairs are decided by it after one
// divide), two columns per step before one branch; a pair that it does not
// decide goes through pair_hit_walk, and per hit with alpha > 0 the count,
// the emission over the block's kb basis columns and log1p. The sums of
// L and log beta keep the per-ray order of the plain version's walk.
//
// What bounds it on this card: FP32 issue per (ray, column) pair on the
// columns of opacity > 0 (v1 ~57 instructions of dots, v2 ~16, then q and
// the early miss), not device-memory bytes (a tile's columns are read once
// and each meets R rays). So the design keeps the pair loop to that work:
// no pair math on columns of opacity 0, no divides past the early miss,
// one branch per two pairs, a register budget per block size
// (__launch_bounds__(NT, fwd_min_blocks)) that keeps three (v1) or four
// (v2) 256-thread blocks on an SM without spills at k = 4, and staging
// small enough for them (24 KB a buffer whatever k).

#pragma once

#include <type_traits>

#include "composite12_common.cuh"
#include "tile_common.cuh"

// Timing ablations (scripts/fwd12_variants.py; the results are wrong by
// design): 1 skips the emission at hits, 2 counts the pairs past the early
// miss into L instead of taking them. The path's build leaves it 0.
#ifndef FWD12_ABL
#define FWD12_ABL 0
#endif

namespace composite12 {

constexpr int kStage = 6144;  // floats of one staging buffer (24 KB)

// blocks per SM the register budget is sized for (v1 holds 30 features)
template <int V, int NT>
__host__ __device__ constexpr int fwd_min_blocks() {
  return NT == 256 ? (V == 1 ? 3 : 4) : (NT == 512 && V == 2 ? 2 : 1);
}

// staging buffers: v1 stages the next window with cp.async while it walks
// the current one; v2 measured faster with one buffer (its four blocks of
// 256 threads per SM hide the staging)
template <int V>
__host__ __device__ constexpr int fwd_nbuf() {
  return V == 1 ? 2 : 1;
}

// basis rows in shared memory: v1 sizes for 16, v2 for its K
template <int V, int K>
__host__ __device__ constexpr int fwd_basis_rows() {
  return V == 1 ? kSH : K;
}

// Whether the forward walks a column of this opacity: a finite opacity
// <= 0 gives alpha <= 0 at every hit. -inf is walked as before (times a
// dens that underflowed to 0 it is NaN, which fminf turns into 0.9999), and
// so is NaN.
__device__ __forceinline__ bool walked(float opac) {
  return !(opac <= 0.0f) || isinf(opac);
}

// v1's forward policy: V1's ray (fa, fb, fc) and pair math; the basis
// is read by the kernel.
struct F1 : V1 {
  __device__ static float opacity(const Args& A, int t, int c) {
    return A.col[static_cast<size_t>(t) * A.S + c];
  }
  // the record's features [p0..p9] (the opacity goes in by a store)
  __device__ static void stage_record(const Args& A, int t, int c, float* rec) {
    const float* p = A.pf + (static_cast<size_t>(t) * A.S + c) * kFeat;
#pragma unroll
    for (int i = 0; i < 10; ++i) cp_async4(rec + i, p + i);
  }
};

// v2's forward policy: V2's ray and pair math (its basis is built from d).
template <int K>
struct F2 : V2<K> {
  __device__ static float opacity(const Args& A, int t, int c) {
    return A.col[static_cast<size_t>(t) * 2 * A.S + c];
  }
  // the record's [M6, U, c0] (the opacity goes in by a store)
  __device__ static void stage_record(const Args& A, int t, int c, float* rec) {
    const float* p = A.pf + (static_cast<size_t>(t) * A.S + c) * kFeat;
#pragma unroll
    for (int i = 0; i < 9; ++i) cp_async4(rec + i, p + i);
    cp_async4(rec + 9, A.col + (static_cast<size_t>(t) * 2 + 1) * A.S + c);
  }
};

template <int V, int K>
using PolicyF = std::conditional_t<V == 1, F1, F2<K>>;

// Loads ray r's part of the pair math and writes its basis rows
// s_basis[k * NT + tid] for k < kb (tid: the thread's slot); returns kb,
// the block's live basis columns (v2: K; v1: one past the last column that
// is nonzero for some ray of the block, found through s_live [NT / 32]).
// Every thread calls it.
template <int V, int K, int NT>
__device__ __forceinline__ int load_ray_basis(const Args& A, int t, int r,
                                              int tid, bool ok,
                                              typename PolicyF<V, K>::Ray& ray,
                                              float* s_basis, unsigned* s_live) {
  PolicyF<V, K>::load_ray(A, t, r, ok, ray);
  if constexpr (V == 2) {
#pragma unroll
    for (int k = 0; k < K; ++k) s_basis[k * NT + tid] = ray.basis[k];
    return K;
  } else {
    const size_t o = (static_cast<size_t>(t) * A.R + r) * kFeat;
    float basis[kSH];
    unsigned mask = 0u;
#pragma unroll
    for (int k = 0; k < kSH; ++k) {
      basis[k] = ok ? A.ray3[o + k] : 0.0f;
      if (basis[k] != 0.0f) mask |= 1u << k;
    }
    mask = __reduce_or_sync(kFull, mask);
    if ((tid & 31) == 0) s_live[tid >> 5] = mask;
    __syncthreads();
    mask = 0u;
#pragma unroll 1
    for (int w = 0; w < NT / 32; ++w) mask |= s_live[w];
    const int kb = 32 - __clz(mask);
#pragma unroll
    for (int k = 0; k < kSH; ++k)
      if (k < kb) s_basis[k * NT + tid] = basis[k];
    return kb;
  }
}

// Stages window [col0, col0 + W) of tile t into buf (records [W][12], then
// SH rows [W][3 kb]), one thread per column: the walked columns, compacted
// in order. Returns how many columns it staged; `any` is the block-wide OR of `active` (the barrier
// that publishes the warps' counts s_cnt [NT / 32]; two windows in a row
// take two such arrays, since no barrier separates the reads of one from
// the writes of the next). Copies are issued only if `any`, and committed
// as one group in every case. Every thread calls it.
template <class P, int NT>
__device__ __forceinline__ int stage_window(const Args& A, int t, int col0,
                                            int W, int kb, float* buf,
                                            int* s_cnt, bool active,
                                            bool& any) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = col0 + tid;
  const bool in = tid < W && c < A.S;
  const float opac = in ? P::opacity(A, t, c) : 0.0f;
  const bool keep = in && walked(opac);
  const unsigned bal = __ballot_sync(kFull, keep);
  if (lane == 0) s_cnt[warp] = __popc(bal);
  any = __syncthreads_or(active);
  int before = 0, n = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int v = s_cnt[w];
    before += w < warp ? v : 0;
    n += v;
  }
  if (any && keep) {
    const int j = before + __popc(bal & ((1u << lane) - 1u));
    float* rec = buf + j * kRec;
    P::stage_record(A, t, c, rec);
    rec[10] = opac;
    const float* sh = A.sh3 + (static_cast<size_t>(t) * A.S + c) * 3 * kSH;
    float* dsh = buf + W * kRec + j * 3 * kb;
    for (int ch = 0; ch < 3; ++ch)
      for (int k = 0; k < kb; ++k) cp_async4(dsh + ch * kb + k, sh + ch * kSH + k);
  }
  cp_async_commit();
  return n;
}

// One pair after its coefficients: the hit decision (pair_hit_walk), the
// cap, the emission (over the kb basis rows sb, stride NT, every one of
// them: a column that is 0 for this ray adds an exact 0; shc: the column's
// SH rows [3][kb]) and the carries. Returns true when the pair takes the
// ray past its cap (every later alpha is 0).
template <int KB, int NT>
__device__ __forceinline__ bool take_pair(const Args& A, float a, float b,
                                          float c, float opac, const float* shc,
                                          int kb, const float* sb,
                                          float& log_beta, int& count,
                                          float& l0, float& l1, float& l2) {
  if (FWD12_ABL >= 2) {
    l0 = l0 + 1.0f;
    return false;
  }
  Hit h;
  if (!pair_hit_walk(a, b, c, opac, A.e2, h)) return false;
  if (!(h.alpha > 0.0f)) return false;
  if (++count > A.max_depth) return true;
  if (FWD12_ABL < 1 && log_beta > A.log_kill) {
    const float w = expf(log_beta) * h.alpha;
    l0 = l0 + w * fmaxf(emission<KB, NT>(sb, shc, kb, ~0u), 0.0f);
    l1 = l1 + w * fmaxf(emission<KB, NT>(sb, shc + kb, kb, ~0u), 0.0f);
    l2 = l2 + w * fmaxf(emission<KB, NT>(sb, shc + 2 * kb, kb, ~0u), 0.0f);
  }
  // past the beta_kill cutoff beta still falls: it is an output
  log_beta = log_beta + log1pf(-h.alpha);
  return false;
}

// One ray's walk of the n columns staged in buf, in stream order. Two
// columns' coefficients and early misses are formed before one branch
// (most pairs miss: then neither takes pair_hit_walk's further work); a
// pair that is not an early miss goes through take_pair, the first column
// before the second.
template <class P, int KB, int NT>
__device__ __forceinline__ void walk_window(const Args& A,
                                            const typename P::Ray& ray,
                                            const float* buf, int n, int W,
                                            int kb, const float* sb,
                                            float& log_beta, int& count,
                                            float& l0, float& l1, float& l2) {
  const float* s_sh = buf + W * kRec;
  int j = 0;
  for (; j + 1 < n; j += 2) {
    float4 m0, m1, m2, n0, n1, n2;
    load_record(buf, j, m0, m1, m2);
    load_record(buf, j + 1, n0, n1, n2);
    float a0, b0, c0, a1, b1, c1;
    P::coeffs(ray, m0, m1, m2, a0, b0, c0);
    P::coeffs(ray, n0, n1, n2, a1, b1, c1);
    const bool miss0 = early_miss(a0, b0, c0, A.e2);
    const bool miss1 = early_miss(a1, b1, c1, A.e2);
    if (miss0 && miss1) continue;
    if (take_pair<KB, NT>(A, a0, b0, c0, m2.z, s_sh + j * 3 * kb, kb, sb,
                          log_beta, count, l0, l1, l2) ||
        take_pair<KB, NT>(A, a1, b1, c1, n2.z, s_sh + (j + 1) * 3 * kb, kb, sb,
                          log_beta, count, l0, l1, l2))
      return;
  }
  if (j < n) {
    float4 m0, m1, m2;
    load_record(buf, j, m0, m1, m2);
    float a, b, c;
    P::coeffs(ray, m0, m1, m2, a, b, c);
    take_pair<KB, NT>(A, a, b, c, m2.z, s_sh + j * 3 * kb, kb, sb, log_beta,
                      count, l0, l1, l2);
  }
}

template <int V, int K, int NT>
__global__ void __launch_bounds__(NT, fwd_min_blocks<V, NT>())
    fwd12_kernel(const Args A) {
  using P = PolicyF<V, K>;
  constexpr int KB = fwd_basis_rows<V, K>();
  // basis rows [rows][NT], fwd_nbuf staging buffers of kStage floats,
  // the warps' counts [2][NT / 32] (by window parity) and v1's live masks
  // [NT / 32]
  extern __shared__ __align__(16) float smem[];
  float* s_basis = smem;
  float* s_buf = s_basis + KB * NT;
  int* s_cnt = reinterpret_cast<int*>(s_buf + fwd_nbuf<V>() * kStage);
  unsigned* s_live = reinterpret_cast<unsigned*>(s_cnt + 2 * (NT / 32));
  const int t = blockIdx.x, tid = threadIdx.x;
  const int r = ray_of_thread(tid, A.R, NT);
  const bool ray_ok = r < A.R;
  typename P::Ray ray;
  const int kb =
      load_ray_basis<V, K, NT>(A, t, r, tid, ray_ok, ray, s_basis, s_live);
  const float* sb = s_basis + tid;
  const int W = min(NT, kStage / (kRec + 3 * kb));
  const int nwin = (A.S + W - 1) / W;

  float log_beta = 0.0f, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int count = 0;
  bool active = ray_ok && count <= A.max_depth;
  bool any;
  if constexpr (fwd_nbuf<V>() == 2) {
    // window w + 1 is staged into the other buffer while w is walked
    int n = stage_window<P, NT>(A, t, 0, W, kb, s_buf, s_cnt, active, any);
    for (int w = 0; any && w < nwin; ++w) {
      int n_next = 0;
      if (w + 1 < nwin) {
        // also the barrier after which buffer (w + 1) & 1 is free again
        n_next = stage_window<P, NT>(A, t, (w + 1) * W, W, kb,
                                     s_buf + ((w + 1) & 1) * kStage,
                                     s_cnt + ((w + 1) & 1) * (NT / 32),
                                     active, any);
        if (!any) break;  // every ray capped: alpha 0 on
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // window w's buffer is complete
      if (active && n > 0)
        walk_window<P, KB, NT>(A, ray, s_buf + (w & 1) * kStage, n, W, kb, sb,
                               log_beta, count, l0, l1, l2);
      active = ray_ok && count <= A.max_depth;
      n = n_next;
    }
    cp_async_wait<0>();
  } else {
    for (int w = 0; w < nwin; ++w) {
      // also the barrier after which the buffer is free again
      const int n = stage_window<P, NT>(A, t, w * W, W, kb, s_buf,
                                        s_cnt + (w & 1) * (NT / 32), active,
                                        any);
      if (!any) break;  // every ray capped: alpha 0 on
      cp_async_wait<0>();
      __syncthreads();  // the buffer is complete
      if (active && n > 0)
        walk_window<P, KB, NT>(A, ray, s_buf, n, W, kb, sb, log_beta, count,
                               l0, l1, l2);
      active = ray_ok && count <= A.max_depth;
    }
  }
  if (ray_ok) {
    const size_t o = static_cast<size_t>(t) * A.R + r;
    A.out_l[3 * o + 0] = l0;
    A.out_l[3 * o + 1] = l1;
    A.out_l[3 * o + 2] = l2;
    A.out_beta[o] = expf(log_beta);
  }
}

template <int V, int K, int NT>
cudaError_t launch_fwd_as(const Args& A, int T, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(fwd_basis_rows<V, K>()) * NT +
                       static_cast<size_t>(fwd_nbuf<V>()) * kStage + 3 * (NT / 32)) *
                      4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd12_kernel<V, K, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fwd12_kernel<V, K, NT><<<T, NT, smem, stream>>>(A);
  return cudaGetLastError();
}

// The smallest block of 256, 512 or 1024 threads that holds R rays.
template <int V, int K>
cudaError_t launch_fwd_nt(const Args& A, int T, cudaStream_t stream) {
  if (A.R <= 256) return launch_fwd_as<V, K, 256>(A, T, stream);
  if (A.R <= 512) return launch_fwd_as<V, K, 512>(A, T, stream);
  return launch_fwd_as<V, K, 1024>(A, T, stream);
}

// The forward of v1: one build per block size, K = 16 (each block finds
// its live basis columns).
inline cudaError_t launch_fwd1(const Args& A, int T, cudaStream_t stream) {
  if (bad_sizes(T, A)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  return launch_fwd_nt<1, kSH>(A, T, stream);
}

// The forward of v2 over its k live SH coefficients (1, 4, 9 or 16).
inline cudaError_t launch_fwd2(const Args& A, int T, int k,
                               cudaStream_t stream) {
  if (bad_sizes(T, A)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  switch (k) {
    case 1: return launch_fwd_nt<2, 1>(A, T, stream);
    case 4: return launch_fwd_nt<2, 4>(A, T, stream);
    case 9: return launch_fwd_nt<2, 9>(A, T, stream);
    case 16: return launch_fwd_nt<2, 16>(A, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace composite12
