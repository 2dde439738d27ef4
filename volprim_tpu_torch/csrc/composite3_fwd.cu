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
// What bounds it on this card: not device-memory bytes (each tile reads its
// columns once, ~64 B + 6k B per column, while every column meets R = 512
// rays), but FP32/SFU issue per (ray, column) pair and the shared-memory
// reads that broadcast each column to the block. The design therefore
//   * stages one segment of columns per block in shared memory as an
//     array of 16-float records, so a ray reads a column with three 16-byte
//     broadcast loads (rows 0-11) and touches opacity and SH only on a hit;
//   * drops, before the walk, every column whose bounding sphere misses the
//     tile's ray cone (d8 rows 3-7): one thread per column evaluates the
//     mask, a block-wide ballot scan writes the survivors' indices in
//     stream order (exact: a dropped column has alpha = 0 for every ray of
//     the tile, and per-segment compaction keeps the stream order);
//   * rejects a non-hit pair after ~30 multiplies and adds and one divide,
//     so exp and log1p run only on hits;
//   * stops a ray at its hit cap (every later alpha is 0) and a block when
//     all its rays are capped. After the beta_kill cutoff a ray skips the
//     emission work but keeps summing log1p(-alpha), so beta stays the full
//     capped product.
// The file is compiled with -fmad=false: the hit test compares q against
// e^2/2 at a hard edge, and contracting the pair math into FMAs would round
// differently from the unfused plain version and flip borderline pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFeat = 16;       // rows of the packed column table
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
// _ray_blocks_t, rounded to the table's dtype (bf16).
template <int K>
__device__ __forceinline__ void ray_basis(float dx, float dy, float dz,
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
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = bf16_round(out[i]);
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

template <int K>
__global__ void __launch_bounds__(kMaxRays)
    fwd3_kernel(const float* __restrict__ d8, const float* __restrict__ pf,
                const __nv_bfloat16* __restrict__ sh3,
                const int* __restrict__ n_seg_t, float* __restrict__ out_l,
                float* __restrict__ out_beta, int R, int S, int seg, float e2h,
                int max_depth, float log_kill, int compact) {
  // shared memory: columns as [seg][16] f32 records, SH as [seg][3K] bf16,
  // the survivors' indices, and one count per warp for the scan
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pf = reinterpret_cast<float*>(smem);
  int* s_idx = reinterpret_cast<int*>(s_pf + seg * kFeat);
  int* s_warp = s_idx + seg;
  __nv_bfloat16* s_sh = reinterpret_cast<__nv_bfloat16*>(s_warp + 32);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* d8t = d8 + static_cast<size_t>(t) * 8 * R;
  const float* pft = pf + static_cast<size_t>(t) * kFeat * S;
  const __nv_bfloat16* sht = sh3 + static_cast<size_t>(t) * 3 * K * S;

  const bool ray_ok = tid < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray_ok) {
    dx = d8t[tid];
    dy = d8t[R + tid];
    dz = d8t[2 * R + tid];
  }
  const float f0 = dx * dx, f1 = dy * dy, f2 = dz * dz;
  const float f3 = dx * dy, f4 = dx * dz, f5 = dy * dz;
  float basis[K];
  ray_basis<K>(dx, dy, dz, basis);
  // the tile's bounding cone (rows 3-7 hold the same value for every ray)
  const float ax0 = d8t[3 * R], ax1 = d8t[4 * R], ax2 = d8t[5 * R];
  const float cone_ch = d8t[6 * R], cone_sh = d8t[7 * R];

  const int nseg = min(n_seg_t[t], S / seg);
  float log_beta = 0.0f, l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
  int count = 0;

  for (int si = 0; si < nseg; ++si) {
    const bool active = ray_ok && count <= max_depth;
    // also the barrier that retires the previous segment's shared reads
    if (!__syncthreads_or(active)) break;
    const int col0 = si * seg;
    for (int i = tid; i < kFeat * seg; i += nthreads) {
      const int row = i / seg, c = i - row * seg;
      s_pf[c * kFeat + row] = pft[static_cast<size_t>(row) * S + col0 + c];
    }
    for (int i = tid; i < 3 * K * seg; i += nthreads) {
      const int row = i / seg, c = i - row * seg;
      s_sh[c * 3 * K + row] = sht[static_cast<size_t>(row) * S + col0 + c];
    }
    __syncthreads();

    int live = seg;
    if (compact) {
      live = 0;
      for (int base = 0; base < seg; base += nthreads) {
        const int c = base + tid;
        const bool keep =
            c < seg && column_mask(s_pf + c * kFeat, ax0, ax1, ax2, cone_ch,
                                   cone_sh);
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
    }

    if (active) {
      for (int j = 0; j < live; ++j) {
        const int c = compact ? s_idx[j] : j;
        const float4* rec = reinterpret_cast<const float4*>(s_pf + c * kFeat);
        const float4 m0 = rec[0];  // M11 M22 M33 2M12   (all halved)
        const float4 m1 = rec[1];  // 2M13 2M23 ux uy
        const float4 m2 = rec[2];  // uz wx wy wz
        float a = f0 * m0.x;
        a = a + f1 * m0.y;
        a = a + f2 * m0.z;
        a = a + f3 * m0.w;
        a = a + f4 * m1.x;
        a = a + f5 * m1.y;
        const float b = dx * m1.z + dy * m1.w + dz * m2.x;
        const float tp = -b / a;
        if (!(tp > 0.0f)) continue;
        const float px = m2.y + tp * dx;
        const float py = m2.z + tp * dy;
        const float pz = m2.w + tp * dz;
        const float q_raw = px * (m0.x * px + m0.w * py + m1.x * pz) +
                            py * (m0.y * py + m1.y * pz) + (pz * pz) * m0.z;
        const float q = fmaxf(q_raw, 0.0f);
        if (!(q <= e2h && q - b * tp > e2h)) continue;
        const float opac = s_pf[c * kFeat + 12];
        const float alpha = fminf(opac * expf(-q), 0.9999f);
        if (!(alpha > 0.0f)) continue;
        if (++count > max_depth) break;  // capped: every later alpha is 0
        if (log_beta > log_kill) {
          const float w = expf(log_beta) * alpha;
          const __nv_bfloat16* shc = s_sh + c * 3 * K;
          float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            e0 = e0 + basis[k] * __bfloat162float(shc[k]);
            e1 = e1 + basis[k] * __bfloat162float(shc[K + k]);
            e2 = e2 + basis[k] * __bfloat162float(shc[2 * K + k]);
          }
          l0 = l0 + w * fmaxf(e0, 0.0f);
          l1 = l1 + w * fmaxf(e1, 0.0f);
          l2 = l2 + w * fmaxf(e2, 0.0f);
        }
        log_beta = log_beta + log1pf(-alpha);
      }
    }
  }

  if (ray_ok) {
    const size_t o = static_cast<size_t>(t) * R + tid;
    out_l[3 * o + 0] = l0;
    out_l[3 * o + 1] = l1;
    out_l[3 * o + 2] = l2;
    out_beta[o] = expf(log_beta);
  }
}

template <int K>
cudaError_t launch(const float* d8, const float* pf, const __nv_bfloat16* sh3,
                   const int* n_seg_t, float* out_l, float* out_beta, int T,
                   int R, int S, int seg, float e2h, int max_depth,
                   float log_kill, int compact, cudaStream_t stream) {
  const int threads = (R + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(seg) * kFeat * sizeof(float) +
                      static_cast<size_t>(seg) * sizeof(int) +
                      32 * sizeof(int) +
                      static_cast<size_t>(seg) * 3 * K * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd3_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fwd3_kernel<K><<<T, threads, smem, stream>>>(d8, pf, sh3, n_seg_t, out_l,
                                               out_beta, R, S, seg, e2h,
                                               max_depth, log_kill, compact);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Tensors: d8 [T, 8, R] f32, pf [T, 16, S]
// f32, sh3 [T, 3k, S] bf16, n_seg_t [T] int32, out_l [T, R, 3] f32,
// out_beta [T, R] f32, all contiguous on one device. Launches on `stream`
// and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
extern "C" int composite3_fwd(const void* d8, const void* pf, const void* sh3,
                              const void* n_seg_t, void* out_l, void* out_beta,
                              int T, int R, int S, int seg, int k, float e2h,
                              int max_depth, float log_kill, int compact,
                              void* stream) {
  if (T < 0 || R < 1 || R > kMaxRays || seg < 1 || S < seg || S % seg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(d8);
  const auto* p = static_cast<const float*>(pf);
  const auto* s = static_cast<const __nv_bfloat16*>(sh3);
  const auto* n = static_cast<const int*>(n_seg_t);
  auto* l = static_cast<float*>(out_l);
  auto* b = static_cast<float*>(out_beta);
  cudaError_t e;
  switch (k) {
    case 1:
      e = launch<1>(d, p, s, n, l, b, T, R, S, seg, e2h, max_depth, log_kill,
                    compact, st);
      break;
    case 4:
      e = launch<4>(d, p, s, n, l, b, T, R, S, seg, e2h, max_depth, log_kill,
                    compact, st);
      break;
    case 9:
      e = launch<9>(d, p, s, n, l, b, T, R, S, seg, e2h, max_depth, log_kill,
                    compact, st);
      break;
    case 16:
      e = launch<16>(d, p, s, n, l, b, T, R, S, seg, e2h, max_depth, log_kill,
                     compact, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* composite3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
