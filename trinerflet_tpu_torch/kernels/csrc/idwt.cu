// K4: one level of the inverse 2D DWT (stride-2 synthesis), separable.
//
// Replaces trinerflet_tpu/ops/wavelets.py:510 idwt2d (via _synthesis_1d :460,
// _synthesis_operator :365, _apply_operator :389), driven by
// trinerflet_tpu/models/triplane.py:168 _idwt_ladder. The JAX package runs
// each 1-D pass as a dense banded-matrix product on the TPU's matrix unit,
// where more than 99% of the operator entries are zero.
//
// What bounds it on the H100: bytes. Each output is ~L/2 taps from `lo` and
// ~L/2 from `hi` (9 + 9 for bior6.8): a few flops per byte, far below the
// card's ~20 flop/byte f32 ridge, so the floor is reading yl + yh once and
// writing the plane once.
//
// Design: polyphase taps instead of the banded matrix -- only the nonzero
// taps are summed. Two launches per level: the W pass reads yl/lh (-> lo)
// and hl/hh (-> hi) and writes them in f32; the H pass reads lo/hi and
// writes the bf16 (or f32) plane. Neighbouring threads own neighbouring
// output columns, so every load and store is coalesced. Accumulation is f32;
// the f32 intermediate is kept between the passes (the plain version rounds
// to the plane dtype there, as the JAX package does), so the kernel is held
// to the plain version within a bf16 tolerance. Fusing both passes through
// shared-memory tiles (no f32 round trip) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_TAPS 32

struct Taps {
  float g0[MAX_TAPS];
  float g1[MAX_TAPS];
  int L;
  int pl;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// out[j] = sum_i x[i] * g[j - 2i + L - 1 - pl] over 0 <= i < n: with
// u = j + L - 1 - pl = 2i + t, only taps t of u's parity contribute.

template <typename T>
__global__ void idwt_w_kernel(const T* __restrict__ yl, const T* __restrict__ yh,
                              int P, int H, int W, int Wo, Taps tp,
                              float* __restrict__ lo, float* __restrict__ hi) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)P * H * Wo;
  if (idx >= total) return;
  int j = (int)(idx % Wo);
  long long pr = idx / Wo;
  int r = (int)(pr % H);
  long long p = pr / H;
  long long plane = (long long)H * W;
  const T* a_yl = yl + p * plane + (long long)r * W;
  const T* a_hl = yh + (p * 3 + 0) * plane + (long long)r * W;
  const T* a_lh = yh + (p * 3 + 1) * plane + (long long)r * W;
  const T* a_hh = yh + (p * 3 + 2) * plane + (long long)r * W;
  int u = j + tp.L - 1 - tp.pl;
  float s_lo = 0.f, s_hi = 0.f;
  for (int t = u & 1; t < tp.L; t += 2) {
    int i = (u - t) >> 1;
    if (i < 0 || i >= W) continue;
    float g0 = tp.g0[t], g1 = tp.g1[t];
    s_lo += to_f32(a_yl[i]) * g0 + to_f32(a_lh[i]) * g1;
    s_hi += to_f32(a_hl[i]) * g0 + to_f32(a_hh[i]) * g1;
  }
  lo[idx] = s_lo;
  hi[idx] = s_hi;
}

template <typename T>
__global__ void idwt_h_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                              int P, int H, int Wo, int Ho, Taps tp, T* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)P * Ho * Wo;
  if (idx >= total) return;
  int c = (int)(idx % Wo);
  long long pj = idx / Wo;
  int jh = (int)(pj % Ho);
  long long p = pj / Ho;
  const float* a_lo = lo + p * H * Wo + c;
  const float* a_hi = hi + p * H * Wo + c;
  int u = jh + tp.L - 1 - tp.pl;
  float s = 0.f;
  for (int t = u & 1; t < tp.L; t += 2) {
    int i = (u - t) >> 1;
    if (i < 0 || i >= H) continue;
    s += a_lo[(long long)i * Wo] * tp.g0[t] + a_hi[(long long)i * Wo] * tp.g1[t];
  }
  store(out + idx, s);
}

static Taps make_taps(const float* g0, const float* g1, int L, int pl) {
  Taps tp;
  for (int t = 0; t < MAX_TAPS; ++t) {
    tp.g0[t] = t < L ? g0[t] : 0.f;
    tp.g1[t] = t < L ? g1[t] : 0.f;
  }
  tp.L = L;
  tp.pl = pl;
  return tp;
}

static unsigned int blocks_for(long long total, int threads) {
  return (unsigned int)((total + threads - 1) / threads);
}

// yl (P, H, W), yh (P, 3, H, W) of bf16 (bf16 != 0) or f32 -> lo, hi (P, H, Wo) f32.
// g0/g1 are host arrays of L taps.
extern "C" int idwt_w_launch(const void* yl, const void* yh, int P, int H, int W, int Wo,
                             int bf16, const float* g0, const float* g1, int L, int pl,
                             float* lo, float* hi, cudaStream_t stream) {
  if (L > MAX_TAPS || L <= 0) return (int)cudaErrorInvalidValue;
  Taps tp = make_taps(g0, g1, L, pl);
  long long total = (long long)P * H * Wo;
  if (total == 0) return 0;
  const int threads = 256;
  if (bf16)
    idwt_w_kernel<__nv_bfloat16><<<blocks_for(total, threads), threads, 0, stream>>>(
        (const __nv_bfloat16*)yl, (const __nv_bfloat16*)yh, P, H, W, Wo, tp, lo, hi);
  else
    idwt_w_kernel<float><<<blocks_for(total, threads), threads, 0, stream>>>(
        (const float*)yl, (const float*)yh, P, H, W, Wo, tp, lo, hi);
  return (int)cudaGetLastError();
}

// lo, hi (P, H, Wo) f32 -> out (P, Ho, Wo) of bf16 (bf16 != 0) or f32.
extern "C" int idwt_h_launch(const float* lo, const float* hi, int P, int H, int Wo, int Ho,
                             int bf16, const float* g0, const float* g1, int L, int pl,
                             void* out, cudaStream_t stream) {
  if (L > MAX_TAPS || L <= 0) return (int)cudaErrorInvalidValue;
  Taps tp = make_taps(g0, g1, L, pl);
  long long total = (long long)P * Ho * Wo;
  if (total == 0) return 0;
  const int threads = 256;
  if (bf16)
    idwt_h_kernel<__nv_bfloat16><<<blocks_for(total, threads), threads, 0, stream>>>(
        lo, hi, P, H, Wo, Ho, tp, (__nv_bfloat16*)out);
  else
    idwt_h_kernel<float><<<blocks_for(total, threads), threads, 0, stream>>>(
        lo, hi, P, H, Wo, Ho, tp, (float*)out);
  return (int)cudaGetLastError();
}
