// K3: dense per-ray volume compositing, forward and analytic backward, one
// thread per ray.
//
// Replaces trinerflet_tpu/ops/raymarch.py:805 composite_dense as called from
// render/renderer.py:631 (the per-ray layout). The JAX package composites
// with an exclusive cumprod over the (N, T) sample axis and masked sums.
//
// What bounds it on the H100: bytes. Per sample it reads sigma, delta, t,
// rgb (24 B) and the mask byte and writes its weight (4 B) for ~10 flops;
// the floor is one pass over those arrays.
//
// Design: each thread walks its ray's T samples in order, carrying the
// transmittance: alpha = 1 - exp(-sigma*delta) (0 off-mask), w = alpha*T
// where T >= t_thresh, then T *= (1 - alpha + 1e-15) -- the same factors in
// the same order as the cumprod. It writes the weights and sum(w),
// sum(w*t), sum(w*rgb). The z-variance stays in the renderer, as in JAX.
//
// Backward (the JAX package differentiates through the cumprod; this is the
// reverse pass in the manner of torch-ngp's
// kernel_composite_rays_train_backward, exact for cotangents at all four
// outputs). Per ray, a forward walk recomputes T_i and parks it in the
// dsigma row; the reverse walk keeps the suffix sum
// R_{i-1} = a_i alpha_i c_i + x_i R_i with x_i = 1 - alpha_i + 1e-15,
// c_i = [T_i >= t_thresh] and a_i = g_ws + g_depth t_i + g_image . rgb_i +
// g_weights_i, so dL/dalpha_i = T_i (a_i c_i - R_i) needs no division.
// Bound: bytes again -- per sample it reads sigma, delta, t, rgb, mask and
// g_weights and writes dsigma and drgb (T_i round-trips through dsigma).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                                 const float* __restrict__ delta, const float* __restrict__ ts,
                                 const uint8_t* __restrict__ mask, int N, int T, float t_thresh,
                                 float* __restrict__ ws, float* __restrict__ depth,
                                 float* __restrict__ image, float* __restrict__ weights) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  long long base = (long long)n * T;
  float trans = 1.0f, s_w = 0.f, s_t = 0.f, r = 0.f, g = 0.f, b = 0.f;
  for (int i = 0; i < T; ++i) {
    long long k = base + i;
    float sd = mask[k] ? sigma[k] * delta[k] : 0.0f;
    float alpha = 1.0f - expf(-sd);
    float w = trans >= t_thresh ? alpha * trans : 0.0f;
    weights[k] = w;
    s_w += w;
    s_t += w * ts[k];
    r += w * rgb[3 * k];
    g += w * rgb[3 * k + 1];
    b += w * rgb[3 * k + 2];
    trans = trans * ((1.0f - alpha) + 1e-15f);
  }
  ws[n] = s_w;
  depth[n] = s_t;
  image[3 * n] = r;
  image[3 * n + 1] = g;
  image[3 * n + 2] = b;
}

// sigma, delta, ts (N, T) f32; rgb (N, T, 3) f32; mask (N, T) bool bytes
// -> ws (N,), depth (N,), image (N, 3), weights (N, T), all f32.
extern "C" int composite_launch(const float* sigma, const float* rgb, const float* delta,
                                const float* ts, const uint8_t* mask, int N, int T,
                                float t_thresh, float* ws, float* depth, float* image,
                                float* weights, cudaStream_t stream) {
  if (N == 0) return 0;
  const int threads = 128;
  composite_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, delta, ts, mask, N, T, t_thresh, ws, depth, image, weights);
  return (int)cudaGetLastError();
}

__global__ void composite_backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb,
    const float* __restrict__ delta, const float* __restrict__ ts,
    const uint8_t* __restrict__ mask, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, int N, int T, float t_thresh,
    float* __restrict__ dsigma, float* __restrict__ drgb) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  long long base = (long long)n * T;
  float trans = 1.0f;
  for (int i = 0; i < T; ++i) {
    long long k = base + i;
    dsigma[k] = trans;  // T_i, read back by the reverse walk
    float sd = mask[k] ? sigma[k] * delta[k] : 0.0f;
    float alpha = 1.0f - expf(-sd);
    trans = trans * ((1.0f - alpha) + 1e-15f);
  }
  const float gw = g_ws[n], gd = g_depth[n];
  const float gr = g_image[3 * n], gg = g_image[3 * n + 1], gb = g_image[3 * n + 2];
  float R = 0.0f;
  for (int i = T - 1; i >= 0; --i) {
    long long k = base + i;
    float Ti = dsigma[k];
    bool m = mask[k] != 0;
    float sd = m ? sigma[k] * delta[k] : 0.0f;
    float e = expf(-sd);
    float alpha = 1.0f - e;
    bool c = Ti >= t_thresh;
    float a = c ? gw + gd * ts[k] + gr * rgb[3 * k] + gg * rgb[3 * k + 1] + gb * rgb[3 * k + 2] +
                      g_weights[k]
                : 0.0f;
    float w = c ? alpha * Ti : 0.0f;
    drgb[3 * k] = w * gr;
    drgb[3 * k + 1] = w * gg;
    drgb[3 * k + 2] = w * gb;
    dsigma[k] = m ? delta[k] * e * (Ti * (a - R)) : 0.0f;
    R = a * alpha + ((1.0f - alpha) + 1e-15f) * R;
  }
}

// Inputs as composite_launch plus the cotangents g_ws, g_depth (N,),
// g_image (N, 3), g_weights (N, T) f32 -> dsigma (N, T), drgb (N, T, 3) f32.
extern "C" int composite_backward_launch(const float* sigma, const float* rgb, const float* delta,
                                         const float* ts, const uint8_t* mask, const float* g_ws,
                                         const float* g_depth, const float* g_image,
                                         const float* g_weights, int N, int T, float t_thresh,
                                         float* dsigma, float* drgb, cudaStream_t stream) {
  if (N == 0) return 0;
  const int threads = 128;
  composite_backward_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, delta, ts, mask, g_ws, g_depth, g_image, g_weights, N, T, t_thresh, dsigma,
      drgb);
  return (int)cudaGetLastError();
}
