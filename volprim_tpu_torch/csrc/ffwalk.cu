// Fused free-flight window walk of the path tracer, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volprim_tpu/pallas_kernels/ffwalk.py:81
// (_kernel, launched by walk :272). The plain PyTorch version of the same
// function is walk_reference in volprim_tpu_torch/kernels/ffwalk.py; the
// wrapper walk there launches this kernel for CUDA tensors.
//
// What it computes, per ray, over its table of K' collected intervals
// (entry ascending, +inf padding) and up to n_windows windows from t_min0:
//   1. select the first k open intervals (exit > t_min) by entry rank;
//   2. nxt = entry of the (k+1)-th open one, t_limit = nxt (or the earliest
//      selected exit when nxt <= t_min; BIG when there is none), capped by
//      t_budget and t_cap;
//   3. the window's depth tau_win = sum_j max(cp_j (erf(al_j hi_j + be_j) -
//      erf(al_j lo_j + be_j)), 0) over the selected intervals clamped to
//      [t_min, t_limit];
//   4. found if tau_win > chi_rem; else resolved (no more intervals, or the
//      cap reached) or budget-dead (t_budget reached), else continue;
//   5. for a found ray, bisect_iters bisection steps of F_w(t) > chi_rem;
//   6. the snap to the tightest enclosing pair of interval boundaries;
//   7. the midpoint solve of solver_iters steps inside it;
//   8. the carry update (chi_rem -= tau_win, t_min = t_limit).
// +inf is carried as BIG = 3e37 (the wrapper's inputs may hold inf; they
// are mapped here as the TPU kernel's wrapper maps them), so comparisons
// such as t_limit >= t_budget decide as there.
//
// The work per ray: each window reads entry and exit only up to its
// (k+1)-th open interval (or the first padding entry) and cp, alpha, beta
// only of the <= k intervals it selects; a window takes 2 erff per selected
// interval, and the window where the ray is found (bisect + solver + 2)
// more. The design:
//   * one warp per ray, 8 warps per block, so no block-level sync at all;
//   * the rank is a warp ballot per 32-interval chunk of the row (coalesced
//     loads, popc prefix), which stops as soon as k + 1 open intervals were
//     seen: exact, since later intervals can neither be selected nor be the
//     (k+1)-th;
//   * the <= k selected intervals are compacted in rank order into the
//     warp's slice of shared memory, so each bisection or solver step is
//     ceil(k / 32) erff per lane and one xor-shuffle sum (which leaves the
//     same bits on every lane, so the warp's control flow stays uniform);
//   * only found rays bisect and solve; a ray leaves the window loop as soon
//     as it is found, resolved or dead.
// The TPU's workarounds do not carry over: the bf16 triangular matmul for
// the rank, the polynomial erf (Mosaic has none; erff here), the 128-lane
// K' padding, SMEM scalars and f32-encoded flags. Compiled with -fmad=false
// so that al * x + be and the sums round as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e37f;
constexpr int kWarps = 8;  // rays per block
constexpr int kMaxKp = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float cap_big(float x) { return isfinite(x) ? x : kBig; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The selected intervals of one warp's ray, in rank order (slot = rank - 1),
// structure of arrays of `cap` slots each.
struct Slots {
  float *lo, *hi, *cp, *al, *be, *elo, *et0;
};

// F_w(t): the window's depth from its start to t.
__device__ __forceinline__ float tau_to(const Slots& s, int n_sel, int lane, float t) {
  float acc = 0.0f;
  for (int j = lane; j < n_sel; j += 32) {
    const float e = erff(s.al[j] * clampf(t, s.lo[j], s.hi[j]) + s.be[j]);
    acc += fmaxf(s.cp[j] * (e - s.elo[j]), 0.0f);
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kWarps * 32)
    ffwalk_kernel(const float* __restrict__ entry, const float* __restrict__ exit_t,
                  const float* __restrict__ cp, const float* __restrict__ al,
                  const float* __restrict__ be, const float* __restrict__ chi,
                  const float* __restrict__ t_budget_in, const float* __restrict__ t_cap_in,
                  const uint8_t* __restrict__ active, const float* __restrict__ t_min0,
                  uint8_t* __restrict__ out_found, uint8_t* __restrict__ out_resolved,
                  uint8_t* __restrict__ out_bdead, uint8_t* __restrict__ out_capres,
                  float* __restrict__ out_t, int R, int KP, int k, int cap, int n_windows,
                  int bisect_iters, int solver_iters, int solver_disabled) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;  // uniform per warp

  float* base = smem + static_cast<size_t>(warp) * 7 * cap;
  const Slots s{base, base + cap, base + 2 * cap, base + 3 * cap,
                base + 4 * cap, base + 5 * cap, base + 6 * cap};
  const size_t row = static_cast<size_t>(ray) * KP;
  const float t_budget = cap_big(t_budget_in[ray]);
  const float t_cap = cap_big(t_cap_in[ray]);
  const bool has_budget = t_budget < kBig * 0.5f;
  const unsigned lanemask_le = kFull >> (31 - lane);

  float t_min = t_min0[ray];
  float chi_rem = chi[ray];
  bool found = false, resolved = false, bdead = false, capres = false;
  float t_samp = kBig;

  if (active[ray]) {
    for (int w = 0; w < n_windows; ++w) {
      // ---- 1-2. selection by entry rank, window end ---------------------
      int n_open = 0;
      float nxt = kBig, min_exit = kBig;
      for (int c = 0; c < KP && n_open <= k; c += 32) {
        const int i = c + lane;
        const float e = i < KP ? cap_big(entry[row + i]) : kBig;
        const float x = i < KP ? cap_big(exit_t[row + i]) : kBig;
        const bool open = e < kBig * 0.5f && x > t_min;
        const unsigned ballot = __ballot_sync(kFull, open);
        const int rank = n_open + __popc(ballot & lanemask_le);  // inclusive
        if (open && rank <= k) {
          const int slot = rank - 1;
          s.lo[slot] = e;  // raw entry and exit for now, clamped below
          s.hi[slot] = x;
          s.cp[slot] = cp[row + i];
          s.al[slot] = al[row + i];
          s.be[slot] = be[row + i];
          min_exit = fminf(min_exit, x);
        }
        if (open && rank == k + 1) nxt = e;
        n_open += __popc(ballot);
      }
      nxt = warp_min(nxt);
      min_exit = warp_min(min_exit);
      const int n_sel = min(n_open, k);
      __syncwarp();

      const bool has_more = nxt < kBig * 0.5f;
      float t_limit = has_more ? (nxt > t_min ? nxt : min_exit) : kBig;
      t_limit = fminf(t_limit, t_budget);
      const bool hit_cap = t_limit >= t_cap;
      t_limit = fminf(t_limit, t_cap);
      const bool full = has_more || has_budget;

      // ---- 3. the window's depth ----------------------------------------
      float acc = 0.0f, span_hi = 0.0f;
      for (int j = lane; j < n_sel; j += 32) {
        const float lo = fmaxf(s.lo[j], t_min);
        const float hi = fmaxf(fminf(s.hi[j], t_limit), lo);
        const float elo = erff(s.al[j] * lo + s.be[j]);
        s.lo[j] = lo;
        s.hi[j] = hi;
        s.elo[j] = elo;
        acc += fmaxf(s.cp[j] * (erff(s.al[j] * hi + s.be[j]) - elo), 0.0f);
        span_hi = fmaxf(span_hi, hi);
      }
      const float tau_win = warp_sum(acc);
      __syncwarp();

      // ---- 4. decisions -------------------------------------------------
      const bool found_w = tau_win > chi_rem;
      const bool resolved_w = !found_w && (!full || hit_cap);
      const bool bdead_w = !found_w && full && !hit_cap && t_limit >= t_budget;

      if (found_w) {
        // ---- 5. bisection of F_w(t) > chi_rem ----------------------------
        float b_lo = t_min, b_hi = fmaxf(warp_max(span_hi), t_min);
        for (int it = 0; it < bisect_iters; ++it) {
          const float mid = 0.5f * (b_lo + b_hi);
          if (tau_to(s, n_sel, lane, mid) > chi_rem) {
            b_hi = mid;
          } else {
            b_lo = mid;
          }
        }
        const float t_star = 0.5f * (b_lo + b_hi);

        // ---- 6. snap to the tightest enclosing boundary pair -------------
        float ev_lo = -kBig, ev_hi = kBig;
        for (int j = lane; j < n_sel; j += 32) {
          const float lo = s.lo[j], hi = s.hi[j];
          if (lo <= t_star) ev_lo = fmaxf(ev_lo, lo);
          if (hi <= t_star) ev_lo = fmaxf(ev_lo, hi);
          if (lo > t_star) ev_hi = fminf(ev_hi, lo);
          if (hi > t_star) ev_hi = fminf(ev_hi, hi);
        }
        const float t0 = fmaxf(warp_max(ev_lo), t_min);
        const float t1 = fmaxf(fminf(warp_min(ev_hi), t_limit), t0);

        // ---- 7. the midpoint solve ---------------------------------------
        const float chi_loc = chi_rem - tau_to(s, n_sel, lane, t0);
        float tt = 0.5f * (t0 + t1);
        if (!solver_disabled) {
          for (int j = lane; j < n_sel; j += 32)
            s.et0[j] = erff(s.al[j] * clampf(t0, s.lo[j], s.hi[j]) + s.be[j]);
          __syncwarp();
          float step = 0.25f * (t1 - t0);
          for (int it = 0; it < solver_iters; ++it) {
            float p = 0.0f;
            for (int j = lane; j < n_sel; j += 32) {
              const float e = erff(s.al[j] * clampf(tt, s.lo[j], s.hi[j]) + s.be[j]);
              p += s.cp[j] * (e - s.et0[j]);
            }
            tt = warp_sum(p) > chi_loc ? tt - step : tt + step;
            tt = clampf(tt, t0, t1);
            step *= 0.5f;
          }
        }
        t_samp = tt;
        found = resolved = true;
        break;
      }
      // ---- 8. the carry update ------------------------------------------
      if (resolved_w) {
        resolved = true;
        capres = hit_cap && t_cap < kBig * 0.5f;
        break;
      }
      if (bdead_w) {
        bdead = true;
        break;
      }
      chi_rem -= tau_win;
      t_min = t_limit;
      __syncwarp();  // the next window overwrites the slots
    }
  }
  if (lane == 0) {
    out_found[ray] = found;
    out_resolved[ray] = resolved;
    out_bdead[ray] = bdead;
    out_capres[ray] = capres;
    out_t[ray] = t_samp;
  }
}

}  // namespace

// C entry point, bound with ctypes. Tensors: entry, exit_t, cp, al, be
// [R, KP] f32; chi, t_budget, t_cap, t_min0 [R] f32; active [R] bool (one
// byte); outputs found, resolved, bdead, capres [R] uint8 and t_samp [R] f32
// (BIG where not found). All contiguous on one device. Launches on `stream`
// and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int ffwalk(const void* entry, const void* exit_t, const void* cp, const void* al,
                      const void* be, const void* chi, const void* t_budget, const void* t_cap,
                      const void* active, const void* t_min0, void* found, void* resolved,
                      void* bdead, void* capres, void* t_samp, int R, int KP, int k,
                      int n_windows, int bisect_iters, int solver_iters, int solver_disabled,
                      void* stream) {
  if (R < 0 || KP < 1 || KP > kMaxKp || k < 1 || n_windows < 0 || bisect_iters < 0 ||
      solver_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int cap = k < KP ? k : KP;  // at most K' intervals are ever selected
  const size_t smem = static_cast<size_t>(kWarps) * 7 * cap * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ffwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (R + kWarps - 1) / kWarps;
  ffwalk_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry), static_cast<const float*>(exit_t),
      static_cast<const float*>(cp), static_cast<const float*>(al),
      static_cast<const float*>(be), static_cast<const float*>(chi),
      static_cast<const float*>(t_budget), static_cast<const float*>(t_cap),
      static_cast<const uint8_t*>(active), static_cast<const float*>(t_min0),
      static_cast<uint8_t*>(found), static_cast<uint8_t*>(resolved),
      static_cast<uint8_t*>(bdead), static_cast<uint8_t*>(capres),
      static_cast<float*>(t_samp), R, KP, k, cap, n_windows, bisect_iters, solver_iters,
      solver_disabled);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ffwalk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
