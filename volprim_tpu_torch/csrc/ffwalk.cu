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
// What bounds it: not bytes or operations (a frame's launches walk 1 to
// 10,000 rays, at 2-30% of their bound in bytes) but one ray's serial
// chain: memory latency in the selection, and the bisection's and solver's
// dependent steps, each an erff and a five-step shuffle sum. One warp walks
// one ray (8 warps a block, no block-level sync), and the design shortens
// that chain without changing any value that reaches an output:
//   * the first window's reads (the ray's scalars and group 0 of its row)
//     are all in flight together, before the active test;
//   * the row is read in groups of 128 intervals, four coalesced loads of
//     entry and exit per lane issued together, and kept in the warp's
//     shared memory for the ray's later windows; a group is read from
//     device memory once, and only when a window's scan reaches it (the
//     (k+1)-th open interval not yet seen);
//   * the scan ends at the first group that holds padding: the table's
//     entries ascend with +inf last, so no later group is open;
//   * a per-ray cursor skips the groups that held no open interval at an
//     earlier window's t_min: t_min only grows, so they stay closed and
//     every rank is unchanged (exits are not sorted, so an early long
//     interval keeps its group live);
//   * the rank is four ballots per group (popc prefix), the selected
//     intervals' row indices are staged in rank order, and cp, alpha and
//     beta of all of them are loaded in one batch;
//   * at k <= 32 (the path) each lane holds its one selected interval in
//     registers (slot j = rank - 1 on lane j), at k <= 64 two, above that
//     the slots stay in shared memory (a size class: the same code);
//   * the bisection evaluates kLevels levels per pass: the 2^kLevels - 1
//     nodes of those levels are fixed by b_lo and b_hi, so their erffs and
//     shuffle sums run side by side, and the pass then takes the same
//     decisions on the same F values as kLevels single steps; the solver's
//     steps (tt -/+ step clamped to [t0, t1]) form such a tree too, and its
//     first pass also takes F(t0) and erf at t0;
//   * the bisection stops once its bracket holds no boundary of a selected
//     interval: the snap, the only use of its result, is then decided
//     (boundary_in);
//   * the flags are written as bytes the wrapper views as torch.bool.
// Each F(t) that is evaluated keeps the same terms in the same slot order
// (j = lane, lane + 32, ...) and the same xor-shuffle tree as a one-point
// evaluation, so found, resolved, bdead, capres and t_samp are
// bit-identical to the one-step design's (scripts/walk_variants.py
// --parent checks it on the card).
// The TPU's workarounds do not carry over: the bf16 triangular matmul for
// the rank, the polynomial erf (Mosaic has none; erff here), the 128-lane
// K' padding, SMEM scalars and f32-encoded flags. Compiled with -fmad=false
// so that al * x + be and the sums round as the plain version does.
//
// FFWALK_ABL (timing ablations, built only by scripts/walk_variants.py;
// their outputs are wrong by design): 1 skips the bisection, the snap and
// the solver of a found ray; 2 also skips each window's depth (no ray is
// found, so rays walk until resolved, budget-dead or out of windows).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FFWALK_ABL
#define FFWALK_ABL 0
#endif

namespace {

constexpr float kBig = 3.0e37f;
constexpr int kWarps = 8;  // rays per block, fewer where shared memory is short
constexpr int kMaxKp = 1024;
constexpr int kGroup = 128;  // intervals per group: four per lane
constexpr int kLevels = 2;   // bisection and solver levels per pass
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float cap_big(float x) { return isfinite(x) ? x : kBig; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// warp_sum of N values side by side: each sum takes the same steps
template <int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
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

// the level of node c of a heap-ordered binary tree (root 0)
__host__ __device__ constexpr int level_of(int c) {
  return c == 0 ? 0 : 1 + level_of((c - 1) / 2);
}

// v[i] for a run-time i < N, without indexing a register array at run time
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float r = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) r = c == i ? v[c] : r;
  return r;
}

// One selected interval: clamped entry and exit, the antiderivative's
// columns, erf at lo and (in the solver) at t0.
struct Slot {
  float lo, hi, cp, al, be, elo, et0;
};

// The selected intervals of a warp's window, slot j = rank - 1 on lane
// j % 32 as its (j / 32)-th slot: S > 0 slots per lane in registers, or
// (S == 0) ceil(cap / 32) per lane in the warp's shared memory. A slot is
// only ever read and written by its own lane.
template <int S>
struct Slots {
  Slot v[S];
  __device__ static constexpr int per_lane() { return S; }
  __device__ Slot get(int s, int) const { return v[s]; }
  __device__ void set(int s, int, const Slot& x) { v[s] = x; }
};

template <>
struct Slots<0> {
  float* p;  // 7 arrays of cap floats
  int cap;
  __device__ int per_lane() const { return (cap + 31) / 32; }
  __device__ Slot get(int s, int lane) const {
    const int j = lane + 32 * s;
    return Slot{p[j], p[cap + j], p[2 * cap + j], p[3 * cap + j],
                p[4 * cap + j], p[5 * cap + j], p[6 * cap + j]};
  }
  __device__ void set(int s, int lane, const Slot& x) {
    const int j = lane + 32 * s;
    p[j] = x.lo;
    p[cap + j] = x.hi;
    p[2 * cap + j] = x.cp;
    p[3 * cap + j] = x.al;
    p[4 * cap + j] = x.be;
    p[5 * cap + j] = x.elo;
    p[6 * cap + j] = x.et0;
  }
};

// One bisection pass of L levels: F_w at the 2^L - 1 midpoints the next L
// steps can reach (heap order: node c's crossing child 2c + 1 halves
// [lo, mid], the other 2c + 2 [mid, hi]), then the L steps' decisions.
template <int L, int S>
__device__ __forceinline__ void bisect_pass(const Slots<S>& st, int lane, int n, float chi_rem,
                                            float& b_lo, float& b_hi) {
  constexpr int N = (1 << L) - 1;
  float lo[N], hi[N], mid[N], acc[N];
  lo[0] = b_lo;
  hi[0] = b_hi;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    mid[c] = 0.5f * (lo[c] + hi[c]);
    if (2 * c + 2 < N) {
      lo[2 * c + 1] = lo[c];
      hi[2 * c + 1] = mid[c];
      lo[2 * c + 2] = mid[c];
      hi[2 * c + 2] = hi[c];
    }
    acc[c] = 0.0f;
  }
  const int ns = st.per_lane();
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    if (lane + 32 * s < n) {
      const Slot x = st.get(s, lane);
#pragma unroll
      for (int c = 0; c < N; ++c)
        acc[c] += fmaxf(x.cp * (erff(x.al * clampf(mid[c], x.lo, x.hi) + x.be) - x.elo), 0.0f);
    }
  }
  warp_sum_n(acc);
  int c = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float m = pick(mid, c);
    const bool cross = pick(acc, c) > chi_rem;
    if (cross) {
      b_hi = m;
    } else {
      b_lo = m;
    }
    c = 2 * c + (cross ? 1 : 2);
  }
}

// Whether a selected interval's lo or hi lies in [b_lo, b_hi]. While none
// does, every boundary is < b_lo <= t_star or > b_hi >= t_star for any
// t_star the remaining steps can reach (a midpoint never leaves its
// bracket), so the snap, and all that follows, is already decided.
template <int S>
__device__ __forceinline__ bool boundary_in(const Slots<S>& st, int lane, int n, float b_lo,
                                            float b_hi) {
  bool in = false;
  const int ns = st.per_lane();
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    if (lane + 32 * s < n) {
      const Slot x = st.get(s, lane);
      in |= (x.lo >= b_lo && x.lo <= b_hi) || (x.hi >= b_lo && x.hi <= b_hi);
    }
  }
  return __any_sync(kFull, in);
}

// `left` bisection steps in passes of L levels (then fewer), ending early
// once the bracket holds no boundary: t_star = 0.5 (b_lo + b_hi) then
// snaps to the pair the full bisection's would.
template <int L, int S>
__device__ __forceinline__ void bisect(const Slots<S>& st, int lane, int n, float chi_rem,
                                       float& b_lo, float& b_hi, int left) {
  for (; left >= L; left -= L) {
    if (!boundary_in(st, lane, n, b_lo, b_hi)) return;
    bisect_pass<L>(st, lane, n, chi_rem, b_lo, b_hi);
  }
  if constexpr (L > 1) bisect<L - 1>(st, lane, n, chi_rem, b_lo, b_hi, left);
}

// One solver pass of L levels from tt: the depth past t0 at the 2^L - 1
// points the next L steps can reach (node c's crossing child 2c + 1 is
// clamp(t_c - step_l), the other clamp(t_c + step_l)), then the L steps.
// The first pass (T0) also takes erf at t0 into each slot and chi_loc =
// chi_rem - F_w(t0), the same terms as a separate evaluation at t0.
template <int L, bool T0, int S>
__device__ __forceinline__ void solver_pass(Slots<S>& st, int lane, int n, float t0, float t1,
                                            float& chi_loc, float& tt, float& step) {
  constexpr int N = (1 << L) - 1;
  float sl[L], pt[N], acc[T0 ? N + 1 : N];
  sl[0] = step;
#pragma unroll
  for (int l = 1; l < L; ++l) sl[l] = sl[l - 1] * 0.5f;
  pt[0] = tt;
#pragma unroll
  for (int c = 0; 2 * c + 2 < N; ++c) {
    pt[2 * c + 1] = clampf(pt[c] - sl[level_of(c)], t0, t1);
    pt[2 * c + 2] = clampf(pt[c] + sl[level_of(c)], t0, t1);
  }
#pragma unroll
  for (int c = 0; c < (T0 ? N + 1 : N); ++c) acc[c] = 0.0f;
  const int ns = st.per_lane();
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    if (lane + 32 * s < n) {
      Slot x = st.get(s, lane);
      if constexpr (T0) {
        x.et0 = erff(x.al * clampf(t0, x.lo, x.hi) + x.be);
        acc[N] += fmaxf(x.cp * (x.et0 - x.elo), 0.0f);
        st.set(s, lane, x);
      }
#pragma unroll
      for (int c = 0; c < N; ++c)
        acc[c] += x.cp * (erff(x.al * clampf(pt[c], x.lo, x.hi) + x.be) - x.et0);
    }
  }
  warp_sum_n(acc);
  if constexpr (T0) chi_loc -= acc[N];
  int c = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool cross = pick(acc, c) > chi_loc;  // c < N: acc[N] is F_w(t0)
    tt = clampf(cross ? tt - sl[l] : tt + sl[l], t0, t1);
    c = 2 * c + (cross ? 1 : 2);
  }
  step = sl[L - 1] * 0.5f;
}

template <int L, int S>
__device__ __forceinline__ void solve(Slots<S>& st, int lane, int n, float t0, float t1,
                                      float& chi_loc, float& tt, float& step, int left,
                                      bool first) {
  for (; left >= L; left -= L) {
    if (first) {
      solver_pass<L, true>(st, lane, n, t0, t1, chi_loc, tt, step);
    } else {
      solver_pass<L, false>(st, lane, n, t0, t1, chi_loc, tt, step);
    }
    first = false;
  }
  if constexpr (L > 1) solve<L - 1>(st, lane, n, t0, t1, chi_loc, tt, step, left, first);
}

// Shared memory of one warp, in 4-byte words: the row cache (entry and
// exit of the K' intervals, BIG for non-finite), the staged row indices of
// the <= cap selected intervals, and with S == 0 the slots.
__host__ __device__ constexpr int warp_words(int S, int kp, int cap) {
  return 2 * kp + cap + (S == 0 ? 7 * cap : 0);
}

template <int S>
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
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * warps + warp;
  if (ray >= R) return;  // uniform per warp

  float* row_e = smem + static_cast<size_t>(warp) * warp_words(S, KP, cap);
  float* row_x = row_e + KP;
  int* sidx = reinterpret_cast<int*>(row_x + KP);
  Slots<S> st;
  if constexpr (S == 0) st = Slots<0>{reinterpret_cast<float*>(sidx + cap), cap};
  const size_t row = static_cast<size_t>(ray) * KP;
  const unsigned lanemask_le = kFull >> (31 - lane);
  const int n_groups = (KP + kGroup - 1) / kGroup;

  // group g of the row from device memory into the row cache (and e, x),
  // its eight loads issued before any is waited on
  auto load_group = [&](int g, float (&e)[4], float (&x)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = g * kGroup + 32 * q + lane;
      e[q] = i < KP ? cap_big(entry[row + i]) : kBig;
      x[q] = i < KP ? cap_big(exit_t[row + i]) : kBig;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = g * kGroup + 32 * q + lane;
      if (i < KP) {
        row_e[i] = e[q];
        row_x[i] = x[q];
      }
    }
  };

  // The first window's reads, all in flight together: the ray's scalars
  // and group 0 of the row.
  const float t_budget = cap_big(t_budget_in[ray]);
  const float t_cap = cap_big(t_cap_in[ray]);
  float t_min = t_min0[ray];
  float chi_rem = chi[ray];
  const bool is_active = active[ray];
  {
    float e[4], x[4];
    load_group(0, e, x);
  }
  const bool has_budget = t_budget < kBig * 0.5f;
  bool found = false, resolved = false, bdead = false, capres = false;
  float t_samp = kBig;
  int cur = 0;     // groups before cur held no open interval at an earlier t_min
  int loaded = 1;  // groups [0, loaded) are in row_e / row_x

  if (is_active) {
    for (int w = 0; w < n_windows; ++w) {
      // ---- 1-2. selection by entry rank, window end ---------------------
      __syncwarp();  // the previous window's reads of sidx are done
      int n_open = 0, live = n_groups;
      float nxt = kBig, min_exit = kBig;
      for (int g = cur; g < n_groups && n_open <= k; ++g) {
        float e[4], x[4];
        if (g < loaded) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = g * kGroup + 32 * q + lane;
            e[q] = i < KP ? row_e[i] : kBig;
            x[q] = i < KP ? row_x[i] : kBig;
          }
        } else {
          load_group(g, e, x);
          loaded = g + 1;
        }
        unsigned ballot[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ballot[q] = __ballot_sync(kFull, e[q] < kBig * 0.5f && x[q] > t_min);
        if (live == n_groups && (ballot[0] | ballot[1] | ballot[2] | ballot[3])) live = g;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool open = (ballot[q] >> lane) & 1u;
          const int rank = n_open + __popc(ballot[q] & lanemask_le);  // inclusive
          if (open && rank <= k) {
            sidx[rank - 1] = g * kGroup + 32 * q + lane;
            min_exit = fminf(min_exit, x[q]);
          }
          if (open && rank == k + 1) nxt = e[q];
          n_open += __popc(ballot[q]);
        }
        // past a padding entry the row holds only padding (entries
        // ascend, +inf last), so no later group has an open interval
        if (__any_sync(kFull, e[0] >= kBig * 0.5f || e[1] >= kBig * 0.5f ||
                                  e[2] >= kBig * 0.5f || e[3] >= kBig * 0.5f))
          break;
      }
      cur = live;
      nxt = warp_min(nxt);
      min_exit = warp_min(min_exit);
      const bool has_more = nxt < kBig * 0.5f;
      const int n_sel = min(n_open, k);
      __syncwarp();  // sidx and row_e / row_x written by other lanes

      // the selected intervals: row indices in rank order, then one batch
      // of loads of their columns
      const int ns = st.per_lane();
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        const int j = lane + 32 * s;
        if (j < n_sel) {
          const int i = sidx[j];
          st.set(s, lane, Slot{row_e[i], row_x[i], cp[row + i], al[row + i], be[row + i],
                               0.0f, 0.0f});
        }
      }

      float t_limit = has_more ? (nxt > t_min ? nxt : min_exit) : kBig;
      t_limit = fminf(t_limit, t_budget);
      const bool hit_cap = t_limit >= t_cap;
      t_limit = fminf(t_limit, t_cap);
      const bool full = has_more || has_budget;

      // ---- 3. the window's depth ----------------------------------------
      float acc = 0.0f, span_hi = 0.0f;
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        if (lane + 32 * s < n_sel) {
          Slot x = st.get(s, lane);
          x.lo = fmaxf(x.lo, t_min);
          x.hi = fmaxf(fminf(x.hi, t_limit), x.lo);
          if constexpr (FFWALK_ABL == 2) {
            acc += x.cp + x.al + x.be;  // keeps the loads
          } else {
            x.elo = erff(x.al * x.lo + x.be);
            acc += fmaxf(x.cp * (erff(x.al * x.hi + x.be) - x.elo), 0.0f);
          }
          span_hi = fmaxf(span_hi, x.hi);
          st.set(s, lane, x);
        }
      }
      float tau_win = warp_sum(acc);
      if constexpr (FFWALK_ABL == 2) tau_win *= 0.0f;

      // ---- 4. decisions -------------------------------------------------
      const bool found_w = tau_win > chi_rem;
      const bool resolved_w = !found_w && (!full || hit_cap);
      const bool bdead_w = !found_w && full && !hit_cap && t_limit >= t_budget;

      if (found_w) {
        if constexpr (FFWALK_ABL == 0) {
          // ---- 5. bisection of F_w(t) > chi_rem --------------------------
          float b_lo = t_min, b_hi = fmaxf(warp_max(span_hi), t_min);
          bisect<kLevels>(st, lane, n_sel, chi_rem, b_lo, b_hi, bisect_iters);
          const float t_star = 0.5f * (b_lo + b_hi);

          // ---- 6. snap to the tightest enclosing boundary pair -----------
          float ev_lo = -kBig, ev_hi = kBig;
#pragma unroll
          for (int s = 0; s < ns; ++s) {
            if (lane + 32 * s < n_sel) {
              const Slot x = st.get(s, lane);
              if (x.lo <= t_star) ev_lo = fmaxf(ev_lo, x.lo);
              if (x.hi <= t_star) ev_lo = fmaxf(ev_lo, x.hi);
              if (x.lo > t_star) ev_hi = fminf(ev_hi, x.lo);
              if (x.hi > t_star) ev_hi = fminf(ev_hi, x.hi);
            }
          }
          const float t0 = fmaxf(warp_max(ev_lo), t_min);
          const float t1 = fmaxf(fminf(warp_min(ev_hi), t_limit), t0);

          // ---- 7. the midpoint solve ---------------------------------------
          float tt = 0.5f * (t0 + t1);
          if (!solver_disabled) {
            float chi_loc = chi_rem, step = 0.25f * (t1 - t0);
            solve<kLevels>(st, lane, n_sel, t0, t1, chi_loc, tt, step, solver_iters, true);
          }
          t_samp = tt;
        } else {
          t_samp = t_min;
        }
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

template <int S>
cudaError_t launch(const void* entry, const void* exit_t, const void* cp, const void* al,
                   const void* be, const void* chi, const void* t_budget, const void* t_cap,
                   const void* active, const void* t_min0, void* found, void* resolved,
                   void* bdead, void* capres, void* t_samp, int R, int KP, int k, int cap,
                   int n_windows, int bisect_iters, int solver_iters, int solver_disabled,
                   cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(warp_words(S, KP, cap)) * sizeof(float);
  const int warps = static_cast<int>(
      per_warp * kWarps <= static_cast<size_t>(kMaxSmem) ? kWarps : kMaxSmem / per_warp);
  const size_t smem = per_warp * warps;
  // above 48 KB only after an opt-in, made once per device and size
  static int opted_in[64] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (static_cast<int>(smem) > opted_in[dev]) {
      e = cudaFuncSetAttribute(ffwalk_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      opted_in[dev] = static_cast<int>(smem);
    }
  }
  const int blocks = (R + warps - 1) / warps;
  ffwalk_kernel<S><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const float*>(entry), static_cast<const float*>(exit_t),
      static_cast<const float*>(cp), static_cast<const float*>(al),
      static_cast<const float*>(be), static_cast<const float*>(chi),
      static_cast<const float*>(t_budget), static_cast<const float*>(t_cap),
      static_cast<const uint8_t*>(active), static_cast<const float*>(t_min0),
      static_cast<uint8_t*>(found), static_cast<uint8_t*>(resolved),
      static_cast<uint8_t*>(bdead), static_cast<uint8_t*>(capres),
      static_cast<float*>(t_samp), R, KP, k, cap, n_windows, bisect_iters, solver_iters,
      solver_disabled);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Tensors: entry, exit_t, cp, al, be
// [R, KP] f32; chi, t_budget, t_cap, t_min0 [R] f32; active [R] bool (one
// byte); outputs found, resolved, bdead, capres [R] bytes 0 / 1 (torch.bool
// storage) and t_samp [R] f32 (BIG where not found). All contiguous on one
// device. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it does not synchronise.
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
  auto* go = cap <= 32 ? launch<1> : cap <= 64 ? launch<2> : launch<0>;
  return static_cast<int>(go(entry, exit_t, cp, al, be, chi, t_budget, t_cap, active, t_min0,
                             found, resolved, bdead, capres, t_samp, R, KP, k, cap, n_windows,
                             bisect_iters, solver_iters, solver_disabled,
                             static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ffwalk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
