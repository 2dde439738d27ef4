// Pair math shared by the fused compositor's forward (composite3_fwd.cu)
// and backward (composite3_bwd.cu) kernels.
//
// The backward re-walks every (ray, column) pair and must take each hit,
// hit-cap and beta_kill decision exactly as the forward did, or its
// gradients belong to another image. Both kernels therefore evaluate the
// pair with these functions, in the same operation order, and both files
// are compiled with -fmad=false (kernels/_build.py): the hit test compares
// q against e^2/2 at a hard edge, and an FMA contracted in one file but not
// the other would flip borderline pairs.
//
// Column records: 16 floats in the HALVED convention of
// pack_fused_features (rows 0-8 carry M/2):
//   [M11, M22, M33, 2 M12, 2 M13, 2 M23, u(3) = M w, w(3) = o - c,
//    opac, c0, bounding radius, entry-distance key]

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace composite3 {

constexpr int kFeat = 16;       // rows of the packed column table
constexpr int kOpacRow = 12;    // opacity
constexpr int kRadiusRow = 14;  // bounding-sphere radius (compaction mask)
constexpr int kMaxRays = 1024;  // one thread per ray

// SH constants (volprim_tpu/ops/sh.py), as f32
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// SH basis with column 0 = 1.0, same operation order as the TPU kernel's
// _ray_blocks_t, in f32 (the backward's SH adjoint uses it unrounded).
template <int K>
__device__ __forceinline__ void ray_basis_f32(float dx, float dy, float dz,
                                              float* out) {
  out[0] = 1.0f;
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

// The basis rounded to the table's dtype (bf16), as the emission product
// of the TPU kernel takes it.
template <int K>
__device__ __forceinline__ void ray_basis(float dx, float dy, float dz,
                                          float* out) {
  ray_basis_f32<K>(dx, dy, dz, out);
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = bf16_round(out[i]);
}

// One ray: its unit direction and the six products F6(d) that contract
// with the M rows.
struct Ray {
  float dx, dy, dz, f0, f1, f2, f3, f4, f5;
};

__device__ __forceinline__ Ray make_ray(float dx, float dy, float dz) {
  return Ray{dx, dy, dz, dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz};
}

// One (ray, column) pair at its closest approach.
struct Pair {
  float a, b, tp;      // a = F6(d) . m6, b = d . u, t* = -b / a
  float px, py, pz;    // p = w + t* d
  float q_raw, q;      // q = p^T (M/2) p, and max(q, 0)
};

// a, b and t* of the pair, from the column's first three float4s (rows
// 0-11). The walk loads those three once into locals and rejects t* <= 0
// in its own branch before calling pair_hit: an early return inside one
// function compiled to a flag and a convergence region on every pair, and
// rows read again after the branch were reloaded from shared memory; both
// slowed the forward walk.
__device__ __forceinline__ void pair_peak(const float4 m0, const float4 m1,
                                          const float4 m2, const Ray& r,
                                          Pair& p) {
  // m0 = M11 M22 M33 2M12, m1 = 2M13 2M23 ux uy, m2 = uz wx wy wz
  float a = r.f0 * m0.x;
  a = a + r.f1 * m0.y;
  a = a + r.f2 * m0.z;
  a = a + r.f3 * m0.w;
  a = a + r.f4 * m1.x;
  a = a + r.f5 * m1.y;
  p.a = a;
  p.b = r.dx * m1.z + r.dy * m1.w + r.dz * m2.x;
  p.tp = -p.b / a;
}

// p and q of a pair with t* > 0 (after pair_peak), and the rest of the hit
// test: q <= e^2/2 and q - b t* > e^2/2.
__device__ __forceinline__ bool pair_hit(const float4 m0, const float4 m1,
                                         const float4 m2, const Ray& r,
                                         float e2h, Pair& p) {
  p.px = m2.y + p.tp * r.dx;
  p.py = m2.z + p.tp * r.dy;
  p.pz = m2.w + p.tp * r.dz;
  p.q_raw = p.px * (m0.x * p.px + m0.w * p.py + m1.x * p.pz) +
            p.py * (m0.y * p.py + m1.y * p.pz) + (p.pz * p.pz) * m0.z;
  p.q = fmaxf(p.q_raw, 0.0f);
  return p.q <= e2h && p.q - p.b * p.tp > e2h;
}

// alpha = min(opac exp(-q), 0.9999) of a hit, with dens = exp(-q) and
// raw = opac dens kept for the backward.
__device__ __forceinline__ float pair_alpha(float opac, float q, float& dens,
                                            float& raw) {
  dens = expf(-q);
  raw = opac * dens;
  return fminf(raw, 0.9999f);
}

// Counts a hit with alpha > 0 towards the ray's cap. False once the count
// passes max_depth: this pair and every later one then has alpha 0.
__device__ __forceinline__ bool under_cap(float alpha, int& count,
                                          int max_depth) {
  if (alpha > 0.0f) ++count;
  return count <= max_depth;
}

// Emission before the clamp: basis (bf16-rounded) . SH, per channel, with
// f32 accumulation in the order k = 0, 1, ...
template <int K>
__device__ __forceinline__ void emission(const float* basis,
                                         const __nv_bfloat16* shc, float& e0,
                                         float& e1, float& e2) {
  e0 = 0.0f;
  e1 = 0.0f;
  e2 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e0 = e0 + basis[k] * __bfloat162float(shc[k]);
    e1 = e1 + basis[k] * __bfloat162float(shc[K + k]);
    e2 = e2 + basis[k] * __bfloat162float(shc[2 * K + k]);
  }
}

// Does the column's bounding sphere meet the tile's ray cone? The squared
// point-cone distance test of the TPU kernel's _column_mask (multiplies and
// compares only) on the column's w = o - c (rows 9-11) and radius (row 14);
// conservative, and radius < 0 (neutral slots) never passes.
__device__ __forceinline__ bool column_mask(float wx, float wy, float wz,
                                            float r, float ax0, float ax1,
                                            float ax2, float ch, float sh) {
  const float vx = -wx, vy = -wy, vz = -wz;  // c - o
  const float dist2 = vx * vx + vy * vy + vz * vz;
  const float a = vx * ax0 + vy * ax1 + vz * ax2;  // depth along the axis
  const float b2 = fmaxf(dist2 - a * a, 0.0f);     // squared axis distance
  const float ch2 = ch * ch;
  const bool inside = (a > 0.0f) && (b2 * ch2 <= (a * a) * (sh * sh));
  const float rhs = r + a * sh;
  const bool near_surf = (rhs >= 0.0f) && (b2 * ch2 <= rhs * rhs);
  const bool in_front = a + r > 1e-4f;
  const bool contains = dist2 <= r * r;
  return (((inside || near_surf) && in_front) || contains) && (r >= 0.0f);
}

// The tile's bounding cone: unit axis, cosine and sine of the half-angle
// (d8 rows 3-7, the same value for every ray).
struct Cone {
  float ax0, ax1, ax2, ch, sh;
};

__device__ __forceinline__ Cone tile_cone(const float* d8t, int R) {
  return Cone{d8t[3 * R], d8t[4 * R], d8t[5 * R], d8t[6 * R], d8t[7 * R]};
}

// Compaction: writes the tile's columns [0, ncols) that pass column_mask to
// idx (device memory), in stream order, and returns their count
// (block-uniform). The survivors form one packed stream, cut into segments
// of seg as the TPU kernel's _compact_phase packs them, so a segment's
// lanes are the ones the order band sees. A block-wide ballot scan over the
// columns' rows 9-11 and 14, one count per warp in s_warp. Every thread of
// the block must call it; it ends with a barrier, after which idx is
// complete for the whole block.
__device__ __forceinline__ int compact_stream(const float* __restrict__ pft,
                                              int S, int ncols, int* idx,
                                              int* s_warp, const Cone& cone) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  int live = 0;
  for (int base = 0; base < ncols; base += nthreads) {
    const int c = base + tid;
    const bool keep =
        c < ncols &&
        column_mask(pft[9 * S + c], pft[10 * S + c], pft[11 * S + c],
                    pft[kRadiusRow * S + c], cone.ax0, cone.ax1, cone.ax2,
                    cone.ch, cone.sh);
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = s_warp[w];
      off += w < warp ? v : 0;
      total += v;
    }
    if (keep) idx[live + off + __popc(bal & ((1u << lane) - 1u))] = c;
    live += total;
    __syncthreads();  // s_warp is rewritten next round; idx complete
  }
  return live;
}

// Copies the n columns of one stream segment, starting at stream position
// first, into shared memory: s_col[j] = the tile column of lane j
// (idx[first + j] from compact_stream, or first + j without compaction),
// the columns as [n][16] f32 records and, when s_sh is given, the SH as
// [n][3K] bf16. Every thread of the block must call it after a barrier that
// retires the previous segment's shared reads; it does not end with one.
template <int K>
__device__ __forceinline__ void stage_stream(
    const float* __restrict__ pft, const __nv_bfloat16* __restrict__ sht,
    const int* idx, float* s_pf, __nv_bfloat16* s_sh, int* s_col, int S,
    int first, int n, int tid, int nthreads) {
  for (int j = tid; j < n; j += nthreads)
    s_col[j] = idx != nullptr ? idx[first + j] : first + j;
  __syncthreads();
  for (int i = tid; i < kFeat * n; i += nthreads) {
    const int row = i / n, j = i - row * n;
    s_pf[j * kFeat + row] = pft[static_cast<size_t>(row) * S + s_col[j]];
  }
  if (s_sh == nullptr) return;
  for (int i = tid; i < 3 * K * n; i += nthreads) {
    const int row = i / n, j = i - row * n;
    s_sh[j * 3 * K + row] = sht[static_cast<size_t>(row) * S + s_col[j]];
  }
}

// ---- the order band (TPU kernel composite3.py:579-608, :1049-1066) -------
//
// With order_band = B > 0 each lane i of a stream segment has its
// transmittance prefix corrected for the entry order of the hits within B
// lanes of it in the same segment:
//   corr_i = sum_{s=1..B} [tkey_{i+s} < tkey_i] logt_{i+s}
//                       - [tkey_{i-s} > tkey_i] logt_{i-s}
//   lw_i = log beta_i + corr_i   (the carry to the next segment is not
//                                 corrected)
// with tkey = t* - sqrt(max(e^2/2 - q, 0) / a), the pair's entry distance.
// A ray walks its columns in stream order, so it holds its hits of the
// last lanes in a window and finishes a hit once the lanes it compares with
// have been walked: the forward after B lanes (corr, lw, emission), the
// backward's second stage after 2B (the transposed band on the weights'
// adjoints, which needs the finished g_lw of the lanes around it). Only
// hits enter the window: a lane without a hit under the cap has logt = 0
// and g_lw = 0 and changes nothing. Windows never cross a segment.
constexpr int kMaxBand = 32;
constexpr int kBandCap = 128;  // a power of two >= 3 kMaxBand + 1

// A ray's window of hits: a ring in local memory, sized by the walk to the
// power of two that holds the hits of the lanes it keeps (2B + 1 or
// 3B + 1), so its cache footprint follows the band, not kMaxBand. What
// every walk reads of a hit and what only the backward's stages add are
// two arrays of records: the forward touches 20 bytes a hit, and a stage
// reads each record it needs from one place.
struct BandHit {
  int lane;
  float tkey, logt, alpha;
  float lbe;  // log beta before this hit, uncorrected
};

struct BandGrad {
  float lw;      // lbe + corr
  float g_w;     // g_L . max(e, 0)
  float w;       // the emission weight
  float g_lw;    // g_w w
  float g_base;  // g_logt before the band: g_lb + the later g_lw
};

template <bool GRAD>
struct BandWindow {
  BandHit hit[kBandCap];
  BandGrad grad[GRAD ? kBandCap : 1];
  int head, i2, i3, tail;  // running indices: oldest kept, next to finish
                           // (forward / backward stage 1), next to finish
                           // in the backward's stage 2, next free
  int mask;
  __device__ __forceinline__ int slot(int i) const { return i & mask; }
  __device__ __forceinline__ const BandHit& at(int i) const {
    return hit[slot(i)];
  }
  __device__ __forceinline__ void reset(int span) {
    head = i2 = i3 = tail = 0;
    int cap = 1;
    while (cap < span) cap <<= 1;
    mask = cap - 1;
  }
  __device__ __forceinline__ void push(const BandHit& h) {
    hit[slot(tail++)] = h;
  }
  // forget the hits before lane `keep` that are finished (index < upto)
  __device__ __forceinline__ void drop(int keep, int upto) {
    while (head < upto && at(head).lane < keep) ++head;
  }
};

__device__ __forceinline__ float entry_key(const Pair& p, float e2h) {
  return p.tp - sqrtf(fmaxf(e2h - p.q, 0.0f) / p.a);
}

// corr of the hit at index x, summed in the TPU kernel's order: for
// s = 1..B, the forward term of lane + s, then the backward term of
// lane - s. The walk takes the hits within B lanes in order of distance
// (the forward one first on a tie), which is that order with the empty
// lanes skipped. Every hit within B lanes must be in the window.
template <bool GRAD>
__device__ __forceinline__ float band_corr(const BandWindow<GRAD>& win, int x,
                                           int band) {
  const int lane = win.at(x).lane;
  const float key = win.at(x).tkey;
  float corr = 0.0f;
  int f = x + 1, b = x - 1;
  int df = f < win.tail ? win.at(f).lane - lane : band + 1;
  int db = b >= win.head ? lane - win.at(b).lane : band + 1;
  while (df <= band || db <= band) {
    if (df <= db) {
      const BandHit& h = win.at(f);
      if (h.tkey < key) corr = corr + h.logt;
      ++f;
      df = f < win.tail ? win.at(f).lane - lane : band + 1;
    } else {
      const BandHit& h = win.at(b);
      if (h.tkey > key) corr = corr - h.logt;
      --b;
      db = b >= win.head ? lane - win.at(b).lane : band + 1;
    }
  }
  return corr;
}

// g_logt of the hit at index x: its g_base plus the transposed band on the
// finished g_lw of the hits within B lanes, in the TPU kernel's order: for
// s = 1..B, + g_lw of lane - s where this key is nearer, then - g_lw of
// lane + s where this key is farther (the backward one first on a tie).
__device__ __forceinline__ float band_adjoint(const BandWindow<true>& win,
                                              int x, int band) {
  const int lane = win.at(x).lane;
  const float key = win.at(x).tkey;
  float g = win.grad[win.slot(x)].g_base;
  int f = x + 1, b = x - 1;
  int df = f < win.tail ? win.at(f).lane - lane : band + 1;
  int db = b >= win.head ? lane - win.at(b).lane : band + 1;
  while (df <= band || db <= band) {
    if (db <= df) {
      if (key < win.at(b).tkey) g = g + win.grad[win.slot(b)].g_lw;
      --b;
      db = b >= win.head ? lane - win.at(b).lane : band + 1;
    } else {
      if (key > win.at(f).tkey) g = g - win.grad[win.slot(f)].g_lw;
      ++f;
      df = f < win.tail ? win.at(f).lane - lane : band + 1;
    }
  }
  return g;
}

}  // namespace composite3
