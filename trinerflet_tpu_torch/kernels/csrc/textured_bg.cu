// K11: the registry's textured background, an equirectangular learnable
// texture sampled by view direction, forward and texture-gradient backward.
//
// Replaces trinerflet_tpu/models/registry.py:204 background_textured and its
// autodiff. On the TPU the 4 texel lookups are flat row-takes of the
// (H*W, 3) texture, because a TPU gather costs per row; its backward is
// XLA's scatter-add.
//
// What bounds it on the H100: bytes. Per ray it reads the direction and 4
// texel rows of 3 f32 (a 64 x 128 texture, 96 KB, stays in L2) and writes 3
// f32; about 60 flops with acosf, atan2f and expf. The floor is the
// directions in and the colours out.
//
// One thread per ray, as JAX computes it (this file is compiled with
// -fmad=false, so every operation rounds alone): dn = d / |d|,
// theta = acos(clip(dn_y, -1, 1)), phi = atan2(dn_x, dn_z) + pi,
// v = clip(theta / pi * (H - 1), 0, float32(H - 1 - 1e-6)),
// u = clip(phi / (2 pi) * (W - 1), 0, float32(W - 1 - 1e-6)), the 4 taps
// (min(v0 + dv, H-1), min(u0 + du, W-1)), dv the outer, with weights
// wv * wu, summed in that order, then a sigmoid. The seam: phi jumps from
// 2 pi to 0 where d_x crosses 0 with d_z < 0, and the texture does not wrap,
// so u jumps from W - 1 to 0 there; CUDA's atan2f and XLA's may put a
// direction within an ulp of the seam on opposite sides.
//
// Backward: the same thread recomputes its taps and adds w * g s (1 - s)
// (s the sigmoid output the forward stored) into the 4 texel rows with
// float32 atomics. The direction gets no gradient: it is a ray direction.
// Bound: bytes (directions, cotangents and outputs in, the texture gradient
// written); the atomics' contention on the texels that many rays share is
// the risk.

#include <cuda_runtime.h>
#include <stdint.h>

#define K11_PI 3.14159265358979323846f
#define K11_TWO_PI 6.28318530717958647692f

__device__ __forceinline__ void texel_taps(const float* __restrict__ d, long long n, int H, int W, float hi_v,
                                           float hi_u, long long rows[4], float w[4]) {
  const float dx = d[3 * n], dy = d[3 * n + 1], dz = d[3 * n + 2];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float ux = dx / nrm, uy = dy / nrm, uz = dz / nrm;
  const float theta = acosf(fminf(fmaxf(uy, -1.0f), 1.0f));
  const float phi = atan2f(ux, uz) + K11_PI;
  const float v = fminf(fmaxf(theta / K11_PI * (float)(H - 1), 0.0f), hi_v);
  const float u = fminf(fmaxf(phi / K11_TWO_PI * (float)(W - 1), 0.0f), hi_u);
  const float fv0 = floorf(v), fu0 = floorf(u);
  const int v0 = (int)fv0, u0 = (int)fu0;
  const float fv = v - fv0, fu = u - fu0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int bv = k >> 1, bu = k & 1;
    w[k] = (bv ? fv : 1.0f - fv) * (bu ? fu : 1.0f - fu);
    rows[k] = (long long)min(v0 + bv, H - 1) * W + min(u0 + bu, W - 1);
  }
}

__global__ void textured_bg_kernel(const float* __restrict__ d, const float* __restrict__ tex, long long N,
                                   int H, int W, float hi_v, float hi_u, float* __restrict__ out) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  long long rows[4];
  float w[4];
  texel_taps(d, n, H, W, hi_v, hi_u, rows, w);
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* __restrict__ r = tex + rows[k] * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + r[c] * w[k];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * n + c] = 1.0f / (1.0f + expf(-acc[c]));
}

__global__ void textured_bg_backward_kernel(const float* __restrict__ d, const float* __restrict__ g,
                                            const float* __restrict__ s, long long N, int H, int W,
                                            float hi_v, float hi_u, float* __restrict__ gtex) {
  long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float gs[3];
  bool any = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sc = s[3 * n + c];
    gs[c] = g[3 * n + c] * (sc * (1.0f - sc));
    any |= gs[c] != 0.0f;
  }
  if (!any) return;
  long long rows[4];
  float w[4];
  texel_taps(d, n, H, W, hi_v, hi_u, rows, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float* dst = gtex + rows[k] * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(dst + c, w[k] * gs[c]);
  }
}

// d (N, 3) f32 directions, tex (H*W, 3) f32 -> out (N, 3) f32 sigmoid RGB.
extern "C" int textured_bg_launch(const float* d, const float* tex, long long N, int H, int W, float hi_v,
                                  float hi_u, float* out, cudaStream_t stream) {
  if (N == 0) return 0;
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  textured_bg_kernel<<<(unsigned int)((N + threads - 1) / threads), threads, 0, stream>>>(
      d, tex, N, H, W, hi_v, hi_u, out);
  return (int)cudaGetLastError();
}

// d (N, 3) f32, g (N, 3) f32 cotangent, s (N, 3) f32 forward output -> adds
// w * g s (1 - s) into gtex (H*W, 3) f32, which the caller zeroes (float
// atomics in an unspecified order).
extern "C" int textured_bg_backward_launch(const float* d, const float* g, const float* s, long long N, int H,
                                           int W, float hi_v, float hi_u, float* gtex, cudaStream_t stream) {
  if (N == 0) return 0;
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  textured_bg_backward_kernel<<<(unsigned int)((N + threads - 1) / threads), threads, 0, stream>>>(
      d, g, s, N, H, W, hi_v, hi_u, gtex);
  return (int)cudaGetLastError();
}
