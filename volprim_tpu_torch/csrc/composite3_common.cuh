// Pair math, culls, staging and the order band shared by the fused
// compositor's forward (composite3_fwd.cuh) and backward (composite3_bwd.cu)
// kernels.
//
// The backward re-walks every (ray, column) pair and must take each hit,
// hit-cap and beta_kill decision exactly as the forward did, or its
// gradients belong to another image. Both kernels therefore evaluate the
// pair with these functions, in the same operation order, and both files
// are compiled with -fmad=false (kernels/_build.py): the hit test compares
// q against e^2/2 at a hard edge, and an FMA contracted in one file but not
// the other would flip borderline pairs. Arithmetic that decides nothing
// (the backward's adjoint rows) asks for its FMAs explicitly (__fmaf_rn).
//
// Column records: 16 floats in the HALVED convention of
// pack_fused_features (rows 0-8 carry M/2):
//   [M11, M22, M33, 2 M12, 2 M13, 2 M23, u(3) = M w, w(3) = o - c,
//    opac, c0, bounding radius, entry-distance key]
//
// Block shape. A block is one tile and has NT = 256, 512 or 1024 threads
// (the kernels are instantiated for each, with __launch_bounds__ to match);
// a thread holds one ray. When the tile has exactly NT rays and NT is a
// multiple of 256, the rays of each 256 are taken as a 16 x 16 pixel tile
// in row-major order (rf_tiled's layout) and each warp gets a 4 x 8 pixel
// patch of them (ray_of_thread), so that a warp's rays span a narrow cone.
// Every ray still reads its inputs and writes its outputs at its own index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace composite3 {

constexpr int kFeat = 16;       // rows of the packed column table
constexpr int kOpacRow = 12;    // opacity
constexpr int kRadiusRow = 14;  // bounding-sphere radius (compaction mask)
constexpr int kCullRow = 13;    // staged slot of the warp cull's radius
constexpr int kMaxRays = 1024;  // one thread per ray
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBand = 32;   // widest order band
constexpr int kBandCap = 128;  // a power of two >= 3 kMaxBand + 8 (band window)

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
// in its own branch before calling pair_hit.
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

// p = w + t* d of a pair, as pair_hit forms it (the backward's column
// reduction forms it again from t* and must get the same p).
__device__ __forceinline__ void peak_point(const float4 m2, float tp,
                                           float dx, float dy, float dz,
                                           float& px, float& py, float& pz) {
  px = m2.y + tp * dx;
  py = m2.z + tp * dy;
  pz = m2.w + tp * dz;
}

// p and q of a pair with t* > 0 (after pair_peak), and the rest of the hit
// test: q <= e^2/2 and q - b t* > e^2/2.
__device__ __forceinline__ bool pair_hit(const float4 m0, const float4 m1,
                                         const float4 m2, const Ray& r,
                                         float e2h, Pair& p) {
  peak_point(m2, p.tp, r.dx, r.dy, r.dz, p.px, p.py, p.pz);
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

// ---- the staged SH words --------------------------------------------------
//
// A segment's SH is staged as 32-bit words: the word of the [3k, S] bf16
// table that holds the column's value (its pair of columns c & ~1, c | 1),
// so that cp.async, whose smallest copy is 4 bytes, can move it. The value
// is the low half for an even column and the high half for an odd one.
__device__ __forceinline__ float sh_word_value(uint32_t w, int odd) {
  return __uint_as_float(odd ? (w & 0xffff0000u) : (w << 16));
}

// Emission before the clamp: basis (bf16-rounded) . SH, per channel, with
// f32 accumulation in the order k = 0, 1, ... ``shw`` is the column's 3k
// staged words, ``odd`` its column's parity.
template <int K>
__device__ __forceinline__ void emission(const float* basis,
                                         const uint32_t* shw, int odd,
                                         float& e0, float& e1, float& e2) {
  e0 = 0.0f;
  e1 = 0.0f;
  e2 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e0 = e0 + basis[k] * sh_word_value(shw[k], odd);
    e1 = e1 + basis[k] * sh_word_value(shw[K + k], odd);
    e2 = e2 + basis[k] * sh_word_value(shw[2 * K + k], odd);
  }
}

// ---- the tile cull (compaction) -------------------------------------------

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
    const unsigned bal = __ballot_sync(kFull, keep);
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

// ---- the warp cull ----------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The bounding cone of a warp's rays: unit axis (their normalised sum),
// cosine and sine of the half-angle, the cosine less 1e-6 of slack as the
// tile's (pack_direction_rows). ``cull`` is false for a warp without rays
// and for one whose cone is wider than 60 degrees (no cull then).
struct WarpCone {
  float ax0, ax1, ax2, ch, sh;
  bool cull, any;
};

// Every lane of the warp must call it; ``ok`` marks the lanes with a ray.
__device__ __forceinline__ WarpCone warp_cone(const Ray& r, bool ok) {
  WarpCone c;
  const float sx = warp_sum(ok ? r.dx : 0.0f);
  const float sy = warp_sum(ok ? r.dy : 0.0f);
  const float sz = warp_sum(ok ? r.dz : 0.0f);
  const float n = sqrtf(sx * sx + sy * sy + sz * sz);
  c.any = __any_sync(kFull, ok);
  const float inv = n > 1e-6f ? 1.0f / n : 0.0f;
  c.ax0 = sx * inv;
  c.ax1 = sy * inv;
  c.ax2 = sz * inv;
  const float cosr = r.dx * c.ax0 + r.dy * c.ax1 + r.dz * c.ax2;
  c.ch = warp_min(ok ? cosr : 1.0f) - 1e-6f;
  c.sh = sqrtf(fmaxf(1.0f - c.ch * c.ch, 0.0f));
  c.cull = c.any && n > 1e-6f && c.ch > 0.5f;
  return c;
}

// A radius about the column's centre that bounds every point p the pair
// math can call a hit, q = p^T (M/2) p <= e^2/2, whatever M/2 it reads.
// Row 14's r (extent x the largest scale) is that bound only for a unit
// quaternion, where lambda_min(M/2) = e2h / r^2 = kappa:
// pack_fused_features does not normalise the quaternions, and below unit
// length the ellipsoid outgrows r. So x = f kappa is tried for f = 0.99,
// 0.6, 0.25, and the first for which M/2 - x I is positive definite (an
// LDL^T factorisation: then lambda_min(M/2) >= x) gives the radius
// sqrt(e2h / (x - 4e-6 tr(M/2))); the 4e-6 tr covers the factorisation's
// rounding and that of the f32 q (each ~1e-6 lambda_max |p|^2 at worst),
// and the few ulps of its correctly rounded reciprocals. Infinity (the
// column is kept) when none is, when r is not positive (neutral slots) and
// for non-finite rows.
__device__ __forceinline__ float cull_radius(const float* rec, float e2h) {
  const float r = rec[kRadiusRow];
  const float a00 = rec[0], a11 = rec[1], a22 = rec[2];
  const float a01 = 0.5f * rec[3], a02 = 0.5f * rec[4], a12 = 0.5f * rec[5];
  const float slack = 4e-6f * (a00 + a11 + a22);
  const float kappa = e2h * __frcp_rn(r * r);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float x = (i == 0 ? 0.99f : (i == 1 ? 0.6f : 0.25f)) * kappa;
    const float xs = x - slack;
    if (!(r > 0.0f) || !(xs > 0.0f)) break;
    const float d0 = a00 - x;
    if (!(d0 > 0.0f)) continue;
    const float inv0 = __frcp_rn(d0);
    const float l1 = a01 * inv0, l2 = a02 * inv0;
    const float d1 = (a11 - x) - a01 * l1;
    if (!(d1 > 0.0f)) continue;
    const float e = a12 - a01 * l2;
    const float d2 = ((a22 - x) - a02 * l2) - (e * e) * __frcp_rn(d1);
    if (d2 > 0.0f) return sqrtf(e2h * __frcp_rn(xs));
  }
  return __int_as_float(0x7f800000);  // +inf
}

// Can any ray of the warp hit the column? Its bounding sphere (centre
// c = o - w, radius r from cull_radius) against the warp's cone,
// conservatively: the sphere is grown by 1e-5 of r and of |c - o|, ten
// times the rounding of the f32 pair math at that distance (p = w + t* d
// cancels to ~1e-6 |w|), so that no pair that the f32 hit test calls a hit
// is dropped. The distance of a point to the cone is b cos - a sin (a
// along the axis, b = |v x axis| without cancellation), or |v| where the
// apex is nearest. An infinite r keeps the column.
__device__ __forceinline__ bool warp_keeps(const WarpCone& c, float wx,
                                           float wy, float wz, float r) {
  if (!c.cull) return true;
  const float vx = -wx, vy = -wy, vz = -wz;
  const float a = vx * c.ax0 + vy * c.ax1 + vz * c.ax2;
  const float cx = vy * c.ax2 - vz * c.ax1;
  const float cy = vz * c.ax0 - vx * c.ax2;
  const float cz = vx * c.ax1 - vy * c.ax0;
  const float b = sqrtf(cx * cx + cy * cy + cz * cz);
  const float d2 = vx * vx + vy * vy + vz * vz;
  const float rr = r + 1e-5f * r + 1e-5f * sqrtf(d2);
  return (b * c.ch - a * c.sh <= rr && a + rr > 0.0f) || d2 <= rr * rr;
}

// The warp's cone kept in shared memory (8 floats a warp), so that the walk
// does not hold it in registers: written by lane 0, read by the whole warp.
__device__ __forceinline__ void store_cone(const WarpCone& c, float* s_cone,
                                           int lane) {
  if (lane == 0) {
    s_cone[0] = c.ax0;
    s_cone[1] = c.ax1;
    s_cone[2] = c.ax2;
    s_cone[3] = c.ch;
    s_cone[4] = c.sh;
    s_cone[5] = c.cull ? 1.0f : 0.0f;
    s_cone[6] = c.any ? 1.0f : 0.0f;
  }
  __syncwarp();
}

__device__ __forceinline__ WarpCone load_cone(const float* s_cone) {
  WarpCone c;
  c.ax0 = s_cone[0];
  c.ax1 = s_cone[1];
  c.ax2 = s_cone[2];
  c.ch = s_cone[3];
  c.sh = s_cone[4];
  c.cull = s_cone[5] != 0.0f;
  c.any = s_cone[6] != 0.0f;
  return c;
}

// Writes the warp's survivor mask of a staged segment of n columns (after
// stage_radii): bit j of word j / 32 of s_mask is set when warp_keeps
// passes column j against the warp's cone (stored by store_cone). Every
// lane of the warp must call it.
__device__ __forceinline__ void warp_survivors(const float* s_cone,
                                               const float* s_pf, int n,
                                               unsigned* s_mask, int lane) {
  const WarpCone c = load_cone(s_cone);
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool keep = false;
    if (c.any && j < n) {
      const float* rec = s_pf + j * kFeat;
      keep = warp_keeps(c, rec[9], rec[10], rec[11], rec[kCullRow]);
    }
    const unsigned bal = __ballot_sync(kFull, keep);
    if (lane == 0) s_mask[base >> 5] = bal;
  }
  __syncwarp();
}

// ---- asynchronous staging ---------------------------------------------------

// One staging buffer: the segment's columns as [seg][16] f32 records (rows
// 13 and 15 are not staged: no kernel reads them), their SH words
// [seg][3K], and the lanes' tile columns.
struct Stage {
  float* pf;
  uint32_t* sh;
  int* col;
};

// Issues the copies of the n columns of one stream segment, starting at
// stream position first, into st: st.col[j] = the tile column of lane j
// (idx[first + j] from compact_stream, or first + j without compaction),
// its record and, with SH, its SH words. One thread per column. Every
// thread must call it (and then commit). ``sh_async`` says the SH table's
// words are 4-byte aligned (S even, aligned base); else the SH is loaded
// and stored synchronously into the same word layout.
template <int K, bool SH>
__device__ __forceinline__ void stage_async(
    const float* __restrict__ pft, const __nv_bfloat16* __restrict__ sht,
    const int* idx, const Stage& st, int S, int first, int n, bool sh_async) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int c = idx != nullptr ? idx[first + j] : first + j;
    st.col[j] = c;
    float* dst = st.pf + j * kFeat;
#pragma unroll
    for (int row = 0; row < kFeat; ++row) {
      if (row == 13 || row == 15) continue;
      cp_async4(dst + row, pft + static_cast<size_t>(row) * S + c);
    }
    if (!SH) continue;
    uint32_t* dsh = st.sh + j * 3 * K;
    if (sh_async) {
      const int even = c & ~1;
#pragma unroll
      for (int row = 0; row < 3 * K; ++row)
        cp_async4(dsh + row, sht + static_cast<size_t>(row) * S + even);
    } else {
      const int shift = (c & 1) ? 16 : 0;
      for (int row = 0; row < 3 * K; ++row) {
        const __nv_bfloat16 v = sht[static_cast<size_t>(row) * S + c];
        dsh[row] = static_cast<uint32_t>(__bfloat16_as_ushort(v)) << shift;
      }
    }
  }
}

// Writes each staged column's cull_radius into its record's slot kCullRow
// (row 13 is not staged). A thread takes the columns it staged
// (stage_async's mapping), once it has waited for their copies, so the
// barrier that then publishes the segment publishes the radii too.
__device__ __forceinline__ void stage_radii(const Stage& st, int n,
                                            float e2h) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float* rec = st.pf + j * kFeat;
    rec[kCullRow] = cull_radius(rec, e2h);
  }
}

// Shared memory of a block: nbuf staging buffers (records, SH words,
// columns; each part 16-byte aligned), the warps' survivor masks and the
// compaction scan's per-warp counts, then what the backward adds.
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

template <int K>
__host__ __device__ inline size_t stage_bytes(int seg) {
  return align16(size_t(seg) * kFeat * 4) + align16(size_t(seg) * 3 * K * 4) +
         align16(size_t(seg) * 4);
}

// the warps' survivor masks [NT / 32][ceil(seg / 32)], the compaction
// scan's counts [32] and the warps' cones [NT / 32][8]
__host__ __device__ inline size_t mask_bytes(int seg, int nt) {
  return align16(size_t(nt / 32) * ((seg + 31) / 32) * 4) + 32 * 4 +
         size_t(nt / 32) * 8 * 4;
}


template <int K>
__device__ __forceinline__ Stage carve_stage(unsigned char*& p, int seg) {
  Stage st;
  st.pf = reinterpret_cast<float*>(p);
  p += align16(size_t(seg) * kFeat * 4);
  st.sh = reinterpret_cast<uint32_t*>(p);
  p += align16(size_t(seg) * 3 * K * 4);
  st.col = reinterpret_cast<int*>(p);
  p += align16(size_t(seg) * 4);
  return st;
}

// the block's staging buffer b (carve_stage's layout from smem)
template <int K>
__device__ __forceinline__ Stage stage_at(unsigned char* smem, int seg, int b) {
  unsigned char* p = smem + b * stage_bytes<K>(seg);
  return carve_stage<K>(p, seg);
}

// the block size of a tile of R rays
inline int block_threads(int R) { return R <= 256 ? 256 : (R <= 512 ? 512 : 1024); }

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on Hopper

// the entry points' argument checks: 1 <= R <= kMaxRays, seg divides S,
// 0 <= band <= kMaxBand
inline bool args_ok(int T, int R, int S, int seg, int band) {
  return T >= 0 && R >= 1 && R <= kMaxRays && seg >= 1 && S >= seg &&
         S % seg == 0 && band >= 0 && band <= kMaxBand;
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
// backward's adjoints after 2B (the transposed band on the weights'
// adjoints, which needs the finished g_lw of the lanes around it). Only
// hits enter the window: a lane without a hit under the cap has logt = 0
// and g_lw = 0 and changes nothing, and the culls drop only lanes without
// hits, so the lanes stay the stream's. Windows never cross a segment.

// the ring size of a window that holds `span` lanes of hits
__host__ __device__ constexpr int band_ring(int span) {
  int cap = 1;
  while (cap < span) cap <<= 1;
  return cap;
}

// A ray's window of hits: a ring in local memory of CAP = kBandCap slots
// (1 in an unbanded kernel, which keeps none), masked at run time to the
// band_ring of the lanes the walk keeps, so that a band touches only as
// many slots as it needs. What every walk reads of a hit and what only the
// backward adds are two arrays of records.
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

template <bool GRAD, int CAP>
struct BandWindow {
  BandHit hit[CAP];
  BandGrad grad[GRAD ? CAP : 1];
  int head, i2, i3, tail;  // running indices: oldest kept, next to finish
                           // (stage 1), next to finish in the backward's
                           // stage 2, next free
  int mask;
  __device__ __forceinline__ int slot(int i) const { return i & mask; }
  __device__ __forceinline__ const BandHit& at(int i) const {
    return hit[slot(i)];
  }
  __device__ __forceinline__ void reset(int span) {
    head = i2 = i3 = tail = 0;
    mask = band_ring(span) - 1;
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
template <class W>
__device__ __forceinline__ float band_corr(const W& win, int x, int band) {
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
template <class W>
__device__ __forceinline__ float band_adjoint(const W& win, int x, int band) {
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
