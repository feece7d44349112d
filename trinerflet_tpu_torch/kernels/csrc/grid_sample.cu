// K2: fused triplane projection + bilinear sample (forward).
//
// Replaces trinerflet_tpu/ops/grid_sample.py:131 grid_sample_2d_quad
// (_quad_fwd :138) as reached from models/triplane.py:289 sample_triplane
// after project_to_planes (:272). The TPU version packs each texel's 2x2
// neighbourhood into one (4C) row so bilinear costs one row gather per
// (sample, plane) -- TPU gathers cost per ROW, not per byte.
//
// What bounds it on the H100: bytes, as scattered row reads. Each
// (sample, plane) reads 4 corner rows of C channels (4 x 32 B for bf16 C=16)
// from a 3 x 1024^2 x 16 bf16 table (100 MB, twice the L2) and writes C f32
// outputs; the arithmetic (8 flops per channel) is negligible.
//
// Design: one thread per (sample, plane). It projects the point itself
// (plane 0 = (x, z), 1 = (x, y), 2 = (y, z), divided by lbound), clamps,
// takes x0 = min(floor(x), W - 2), reads the four corner rows straight from
// the channel-last plane with 16-byte vector loads and writes its C outputs
// with 16-byte stores. No quad table is needed on a GPU: the four rows of a
// corner pair are adjacent, so the 2x2 neighbourhood is two 64 B segments.
//
// Backward (replaces _quad_bwd :151 / _corner_bwd :210 and the sort +
// one-hot-matmul scatter they call, ops/scatter.py:375 scatter_add_outer):
// the plane gradient sum_corners w_corner * g. One thread per (sample,
// plane) recomputes its corner weights, reads its C-channel cotangent row
// and adds w * g into the four corner rows of a float32 (3, H, W, C) buffer
// with atomicAdd; rows whose cotangent is all zero (masked samples) add
// nothing. A second kernel casts the buffer to bf16. Bound: bytes (the
// cotangent rows in, the touched texel rows read-modify-written, the plane
// gradient written); the atomics' contention on shared texels is the risk.
//
// K2x, the coordinate gradient (replaces JAX's autodiff of grid_sample_2d
// :23 / sample_planes :61 in the coordinates, which models/triplane.py:310-321
// switches to when the rotation or the lbound zoom is learned): per point
// and plane dL/du = (sum_c g_c [(f01 - f00)(1 - wy) + (f11 - f10) wy])
// clip'(x) (W - 1) / 2, dL/dv alike, clip' being JAX's (1 inside, 0.5 at
// either bound, 0 outside); the three planes' (u, v) sum into dL/dxyz
// (plane 0 is (x, z), 1 (x, y), 2 (y, z)), divided by lbound. One thread
// per point loops over the three planes: it reads the cotangent row and
// the four corner rows, adds w * g into the float32 plane gradient with
// atomics as K2's backward does, and keeps dL/dxyz in registers, written
// once (no atomics). Bound: bytes (the cotangent, the corner rows of the
// points that carry one, the touched texels read-modify-written, the
// gradients written).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

template <int C>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ r, float* v) {
  if constexpr (C % 8 == 0) {
#pragma unroll
    for (int k = 0; k < C / 8; ++k) {
      uint4 q = reinterpret_cast<const uint4*>(r)[k];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(h[e]);
        v[8 * k + 2 * e] = f.x;
        v[8 * k + 2 * e + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __bfloat162float(r[c]);
  }
}

template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ r, float* v) {
#pragma unroll
  for (int k = 0; k < C / 4; ++k) {
    float4 q = reinterpret_cast<const float4*>(r)[k];
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

template <int C, typename T>
__global__ void sample_points_kernel(const T* __restrict__ planes, const float* __restrict__ xyz,
                                     int M, int H, int W, float lbound, float* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3LL * M) return;
  int p = (int)(idx % 3);
  long long m = idx / 3;
  float px = xyz[3 * m], py = xyz[3 * m + 1], pz = xyz[3 * m + 2];
  float u = p == 2 ? py : px;
  float v = p == 1 ? py : pz;
  u = u / lbound;
  v = v / lbound;
  float x = fminf(fmaxf((u + 1.f) * 0.5f * (float)(W - 1), 0.f), (float)(W - 1));
  float y = fminf(fmaxf((v + 1.f) * 0.5f * (float)(H - 1), 0.f), (float)(H - 1));
  float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  int x0 = (int)fx0, y0 = (int)fy0;
  float wx = x - fx0, wy = y - fy0;
  float w00 = (1.f - wx) * (1.f - wy);
  float w01 = wx * (1.f - wy);
  float w10 = (1.f - wx) * wy;
  float w11 = wx * wy;
  const T* r00 = planes + (((long long)p * H + y0) * W + x0) * C;
  const T* r10 = r00 + (long long)W * C;
  float a[C], b[C];
  float acc[C];
  load_row<C>(r00, a);
  load_row<C>(r00 + C, b);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = a[c] * w00 + b[c] * w01;
  load_row<C>(r10, a);
  load_row<C>(r10 + C, b);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = acc[c] + a[c] * w10 + b[c] * w11;
  float4* o = reinterpret_cast<float4*>(out + idx * C);
#pragma unroll
  for (int k = 0; k < C / 4; ++k) o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
}

// Corner weights of sample m on plane p: flat (y0, x0) texel index and the
// weights of (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1).
__device__ __forceinline__ long long corners(const float* __restrict__ xyz, long long m, int p,
                                             int H, int W, float lbound, float w[4]) {
  float px = xyz[3 * m], py = xyz[3 * m + 1], pz = xyz[3 * m + 2];
  float u = (p == 2 ? py : px) / lbound;
  float v = (p == 1 ? py : pz) / lbound;
  float x = fminf(fmaxf((u + 1.f) * 0.5f * (float)(W - 1), 0.f), (float)(W - 1));
  float y = fminf(fmaxf((v + 1.f) * 0.5f * (float)(H - 1), 0.f), (float)(H - 1));
  float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
  float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
  float wx = x - fx0, wy = y - fy0;
  w[0] = (1.f - wx) * (1.f - wy);
  w[1] = wx * (1.f - wy);
  w[2] = (1.f - wx) * wy;
  w[3] = wx * wy;
  return ((long long)p * H + (int)fy0) * W + (int)fx0;
}

template <int C>
__global__ void sample_points_backward_kernel(const float* __restrict__ xyz,
                                              const float* __restrict__ g, int M, int H, int W,
                                              float lbound, float* __restrict__ grad) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3LL * M) return;
  int p = (int)(idx % 3);
  long long m = idx / 3;
  float gv[C];
  const float4* gr = reinterpret_cast<const float4*>(g + idx * C);
  bool any = false;
#pragma unroll
  for (int k = 0; k < C / 4; ++k) {
    float4 q = gr[k];
    gv[4 * k] = q.x;
    gv[4 * k + 1] = q.y;
    gv[4 * k + 2] = q.z;
    gv[4 * k + 3] = q.w;
    any |= (q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f);
  }
  if (!any) return;
  float w[4];
  long long t00 = corners(xyz, m, p, H, W, lbound, w);
  const long long rows[4] = {t00, t00 + 1, t00 + W, t00 + W + 1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* dst = grad + rows[r] * C;
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, w[r] * gv[c]);
  }
}

// The JAX package's gradient of clip(v, 0, hi): a tie at either bound
// splits it, 0.5.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  if (v > 0.f && v < hi) return 1.f;
  return (v == 0.f || v == hi) ? 0.5f : 0.f;
}

template <int C, typename T>
__global__ void sample_points_backward_xyz_kernel(const T* __restrict__ planes,
                                                  const float* __restrict__ xyz,
                                                  const float* __restrict__ g, int M, int H, int W,
                                                  float lbound, float* __restrict__ grad,
                                                  float* __restrict__ dxyz) {
  long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float px = xyz[3 * m], py = xyz[3 * m + 1], pz = xyz[3 * m + 2];
  float du[3], dv[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    du[p] = 0.f;
    dv[p] = 0.f;
    float gv[C];
    const float4* gr = reinterpret_cast<const float4*>(g + (3 * m + p) * C);
    bool any = false;
#pragma unroll
    for (int k = 0; k < C / 4; ++k) {
      float4 q = gr[k];
      gv[4 * k] = q.x;
      gv[4 * k + 1] = q.y;
      gv[4 * k + 2] = q.z;
      gv[4 * k + 3] = q.w;
      any |= (q.x != 0.f) | (q.y != 0.f) | (q.z != 0.f) | (q.w != 0.f);
    }
    if (!any) continue;  // unrouted or masked samples: both gradients are 0
    float u = (p == 2 ? py : px) / lbound;
    float v = (p == 1 ? py : pz) / lbound;
    float xr = (u + 1.f) * 0.5f * (float)(W - 1);
    float yr = (v + 1.f) * 0.5f * (float)(H - 1);
    float x = fminf(fmaxf(xr, 0.f), (float)(W - 1));
    float y = fminf(fmaxf(yr, 0.f), (float)(H - 1));
    float fx0 = fminf(fmaxf(floorf(x), 0.f), (float)(W - 2));
    float fy0 = fminf(fmaxf(floorf(y), 0.f), (float)(H - 2));
    float wx = x - fx0, wy = y - fy0;
    const float w[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
    long long t00 = ((long long)p * H + (int)fy0) * W + (int)fx0;
    const long long rows[4] = {t00, t00 + 1, t00 + W, t00 + W + 1};
    float f00[C], f01[C], f10[C], f11[C];
    load_row<C>(planes + rows[0] * C, f00);
    load_row<C>(planes + rows[1] * C, f01);
    load_row<C>(planes + rows[2] * C, f10);
    load_row<C>(planes + rows[3] * C, f11);
    float dwx = 0.f, dwy = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dwx += gv[c] * ((f01[c] - f00[c]) * (1.f - wy) + (f11[c] - f10[c]) * wy);
      dwy += gv[c] * ((f10[c] - f00[c]) * (1.f - wx) + (f11[c] - f01[c]) * wx);
    }
    du[p] = dwx * clip_grad(xr, (float)(W - 1)) * (float)(W - 1) * 0.5f;
    dv[p] = dwy * clip_grad(yr, (float)(H - 1)) * (float)(H - 1) * 0.5f;
    if (grad == nullptr) continue;  // the planes need no gradient (an analytic normal)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = grad + rows[r] * C;
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, w[r] * gv[c]);
    }
  }
  dxyz[3 * m] = (du[0] + du[1]) / lbound;
  dxyz[3 * m + 1] = (dv[1] + du[2]) / lbound;
  dxyz[3 * m + 2] = (dv[0] + dv[2]) / lbound;
}

__global__ void cast_bf16_kernel(const float* __restrict__ x, long long n,
                                 __nv_bfloat16* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(x[i]);
}

template <int C>
static void launch_c(const void* planes, const float* xyz, int M, int H, int W, int bf16,
                     float lbound, float* out, cudaStream_t stream) {
  const int threads = 128;
  unsigned int blocks = (unsigned int)((3LL * M + threads - 1) / threads);
  if (bf16)
    sample_points_kernel<C, __nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)planes, xyz, M, H, W, lbound, out);
  else
    sample_points_kernel<C, float><<<blocks, threads, 0, stream>>>(
        (const float*)planes, xyz, M, H, W, lbound, out);
}

// planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3) f32
// -> out (M, 3, C) f32. C must be 4, 8, 16 or 32 and H, W >= 2.
extern "C" int sample_points_launch(const void* planes, const float* xyz, int M, int H, int W,
                                    int C, int bf16, float lbound, float* out,
                                    cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 4: launch_c<4>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 8: launch_c<8>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 16: launch_c<16>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    case 32: launch_c<32>(planes, xyz, M, H, W, bf16, lbound, out, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xyz (M, 3) f32, g (M, 3, C) f32 -> grad (3, H, W, C) f32, which the caller
// zeroes; sums w_corner * g into it (order of the float atomics unspecified).
extern "C" int sample_points_backward_launch(const float* xyz, const float* g, int M, int H,
                                             int W, int C, float lbound, float* grad,
                                             cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  unsigned int blocks = (unsigned int)((3LL * M + threads - 1) / threads);
  switch (C) {
    case 4: sample_points_backward_kernel<4><<<blocks, threads, 0, stream>>>(xyz, g, M, H, W, lbound, grad); break;
    case 8: sample_points_backward_kernel<8><<<blocks, threads, 0, stream>>>(xyz, g, M, H, W, lbound, grad); break;
    case 16: sample_points_backward_kernel<16><<<blocks, threads, 0, stream>>>(xyz, g, M, H, W, lbound, grad); break;
    case 32: sample_points_backward_kernel<32><<<blocks, threads, 0, stream>>>(xyz, g, M, H, W, lbound, grad); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int C>
static void launch_xyz_c(const void* planes, const float* xyz, const float* g, int M, int H, int W,
                         int bf16, float lbound, float* grad, float* dxyz, cudaStream_t stream) {
  const int threads = 128;
  unsigned int blocks = (unsigned int)(((long long)M + threads - 1) / threads);
  if (bf16)
    sample_points_backward_xyz_kernel<C, __nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)planes, xyz, g, M, H, W, lbound, grad, dxyz);
  else
    sample_points_backward_xyz_kernel<C, float><<<blocks, threads, 0, stream>>>(
        (const float*)planes, xyz, g, M, H, W, lbound, grad, dxyz);
}

// K2x. planes (3, H, W, C) channel-last, bf16 (bf16 != 0) or f32; xyz (M, 3)
// f32; g (M, 3, C) f32 -> grad (3, H, W, C) f32, which the caller zeroes (the
// plane gradient, float atomics in an unspecified order; null: not computed),
// and dxyz (M, 3) f32, every row written.
extern "C" int sample_points_backward_xyz_launch(const void* planes, const float* xyz,
                                                 const float* g, int M, int H, int W, int C,
                                                 int bf16, float lbound, float* grad, float* dxyz,
                                                 cudaStream_t stream) {
  if (M == 0) return 0;
  if (H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 4: launch_xyz_c<4>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 8: launch_xyz_c<8>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 16: launch_xyz_c<16>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    case 32: launch_xyz_c<32>(planes, xyz, g, M, H, W, bf16, lbound, grad, dxyz, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (n,) f32 -> out (n,) bf16, round to nearest even.
extern "C" int cast_bf16_launch(const float* x, long long n, void* out, cudaStream_t stream) {
  if (n == 0) return 0;
  const int threads = 256;
  cast_bf16_kernel<<<(unsigned int)((n + threads - 1) / threads), threads, 0, stream>>>(
      x, n, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
