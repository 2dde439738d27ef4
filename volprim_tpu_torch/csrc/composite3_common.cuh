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
// compares only); conservative, and radius < 0 (neutral slots) never passes.
__device__ __forceinline__ bool column_mask(const float* col, float ax0,
                                            float ax1, float ax2, float ch,
                                            float sh) {
  const float vx = -col[9], vy = -col[10], vz = -col[11];  // c - o
  const float r = col[kRadiusRow];
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

// Copies segment columns [col0, col0 + seg) of one tile into shared memory
// as [seg][16] f32 records and, when s_sh is given, [seg][3K] bf16 SH.
template <int K>
__device__ __forceinline__ void stage_segment(
    const float* __restrict__ pft, const __nv_bfloat16* __restrict__ sht,
    float* s_pf, __nv_bfloat16* s_sh, int S, int col0, int seg, int tid,
    int nthreads) {
  for (int i = tid; i < kFeat * seg; i += nthreads) {
    const int row = i / seg, c = i - row * seg;
    s_pf[c * kFeat + row] = pft[static_cast<size_t>(row) * S + col0 + c];
  }
  if (s_sh == nullptr) return;
  for (int i = tid; i < 3 * K * seg; i += nthreads) {
    const int row = i / seg, c = i - row * seg;
    s_sh[c * 3 * K + row] = sht[static_cast<size_t>(row) * S + col0 + c];
  }
}

// Writes the indices of the staged columns that pass column_mask into
// s_idx, in stream order, and returns their count (block-uniform). A
// block-wide ballot scan: one thread per column, one count per warp in
// s_warp. Every thread of the block must call it, after the segment is
// staged and a barrier.
__device__ __forceinline__ int compact_segment(const float* s_pf, int* s_idx,
                                               int* s_warp, int seg,
                                               float ax0, float ax1,
                                               float ax2, float ch, float sh) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  int live = 0;
  for (int base = 0; base < seg; base += nthreads) {
    const int c = base + tid;
    const bool keep =
        c < seg && column_mask(s_pf + c * kFeat, ax0, ax1, ax2, ch, sh);
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = s_warp[w];
      off += w < warp ? v : 0;
      total += v;
    }
    if (keep) s_idx[live + off + __popc(bal & ((1u << lane) - 1u))] = c;
    live += total;
    __syncthreads();  // s_warp is rewritten next round; s_idx complete
  }
  return live;
}

}  // namespace composite3
