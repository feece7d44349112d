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
// and hl/hh (-> hi), the H pass reads lo/hi and writes the bf16 (or f32)
// plane. Neighbouring threads own neighbouring output columns, so every load
// and store is coalesced. Sums are f32, rounded to the plane dtype where the
// JAX package rounds (after each 1-D operator, e.g. S0 . yl and S1 . lh, and
// after their add), so the kernel matches the plain version up to the order
// of its f32 sums. The rounded intermediates travel between the passes in an
// f32 buffer; a bf16 buffer, or fusing both passes through shared-memory
// tiles, is later work.
//
// Adjoint (the backward of a level; the JAX package differentiates its
// banded matmuls, i.e. multiplies by the transposed operator): each 1-D
// synthesis out[j] = sum_i x[i] g[j - 2i + off] (off = L - 1 - pl)
// transposes to the stride-2 correlation x[i] = sum_t y[2i + t - off] g[t],
// the analysis shape, with the same taps. The H adjoint reads the cotangent
// of the plane and writes the cotangents of lo and hi, the W adjoint reads
// those and writes yl's and the three bands'; each result rounds to the
// plane dtype, where the JAX package's transposed operators round. Same
// bound (bytes) as the forward.

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
// x rounded to T (round to nearest even), kept as a float
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
  float yl0 = 0.f, lh1 = 0.f, hl0 = 0.f, hh1 = 0.f;
  for (int t = u & 1; t < tp.L; t += 2) {
    int i = (u - t) >> 1;
    if (i < 0 || i >= W) continue;
    float g0 = tp.g0[t], g1 = tp.g1[t];
    yl0 += to_f32(a_yl[i]) * g0;
    lh1 += to_f32(a_lh[i]) * g1;
    hl0 += to_f32(a_hl[i]) * g0;
    hh1 += to_f32(a_hh[i]) * g1;
  }
  lo[idx] = rnd<T>(rnd<T>(yl0) + rnd<T>(lh1));
  hi[idx] = rnd<T>(rnd<T>(hl0) + rnd<T>(hh1));
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
  float s0 = 0.f, s1 = 0.f;
  for (int t = u & 1; t < tp.L; t += 2) {
    int i = (u - t) >> 1;
    if (i < 0 || i >= H) continue;
    s0 += a_lo[(long long)i * Wo] * tp.g0[t];
    s1 += a_hi[(long long)i * Wo] * tp.g1[t];
  }
  store(out + idx, rnd<T>(s0) + rnd<T>(s1));
}

// d_lo[p, i, c] = sum_t G[p, 2i + t - off, c] g0[t] (d_hi with g1), i < H.
template <typename T>
__global__ void idwt_adj_h_kernel(const T* __restrict__ G, int P, int H, int Ho, int Wo, Taps tp,
                                  float* __restrict__ d_lo, float* __restrict__ d_hi) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)P * H * Wo;
  if (idx >= total) return;
  int c = (int)(idx % Wo);
  long long pi = idx / Wo;
  int i = (int)(pi % H);
  long long p = pi / H;
  const T* col = G + p * Ho * Wo + c;
  int j0 = 2 * i - (tp.L - 1 - tp.pl);
  float s_lo = 0.f, s_hi = 0.f;
  for (int t = 0; t < tp.L; ++t) {
    int j = j0 + t;
    if (j < 0 || j >= Ho) continue;
    float v = to_f32(col[(long long)j * Wo]);
    s_lo += v * tp.g0[t];
    s_hi += v * tp.g1[t];
  }
  d_lo[idx] = rnd<T>(s_lo);
  d_hi[idx] = rnd<T>(s_hi);
}

// d_yl[p, r, i] = sum_t d_lo[p, r, 2i + t - off] g0[t], d_lh the same with g1,
// d_hl / d_hh from d_hi with g0 / g1; bands stored (hl, lh, hh).
template <typename T>
__global__ void idwt_adj_w_kernel(const float* __restrict__ d_lo, const float* __restrict__ d_hi,
                                  int P, int H, int W, int Wo, Taps tp, T* __restrict__ d_yl,
                                  T* __restrict__ d_yh) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)P * H * W;
  if (idx >= total) return;
  int i = (int)(idx % W);
  long long pr = idx / W;
  int r = (int)(pr % H);
  long long p = pr / H;
  const float* a_lo = d_lo + (p * H + r) * Wo;
  const float* a_hi = d_hi + (p * H + r) * Wo;
  int j0 = 2 * i - (tp.L - 1 - tp.pl);
  float yl = 0.f, lh = 0.f, hl = 0.f, hh = 0.f;
  for (int t = 0; t < tp.L; ++t) {
    int j = j0 + t;
    if (j < 0 || j >= Wo) continue;
    float vl = a_lo[j], vh = a_hi[j];
    yl += vl * tp.g0[t];
    lh += vl * tp.g1[t];
    hl += vh * tp.g0[t];
    hh += vh * tp.g1[t];
  }
  long long plane = (long long)H * W;
  long long off = (long long)r * W + i;
  store(d_yl + p * plane + off, yl);
  store(d_yh + (p * 3 + 0) * plane + off, hl);
  store(d_yh + (p * 3 + 1) * plane + off, lh);
  store(d_yh + (p * 3 + 2) * plane + off, hh);
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

// G (P, Ho, Wo) of bf16 (bf16 != 0) or f32 -> d_lo, d_hi (P, H, Wo) f32.
extern "C" int idwt_adj_h_launch(const void* G, int P, int H, int Ho, int Wo, int bf16,
                                 const float* g0, const float* g1, int L, int pl, float* d_lo,
                                 float* d_hi, cudaStream_t stream) {
  if (L > MAX_TAPS || L <= 0) return (int)cudaErrorInvalidValue;
  Taps tp = make_taps(g0, g1, L, pl);
  long long total = (long long)P * H * Wo;
  if (total == 0) return 0;
  const int threads = 256;
  if (bf16)
    idwt_adj_h_kernel<__nv_bfloat16><<<blocks_for(total, threads), threads, 0, stream>>>(
        (const __nv_bfloat16*)G, P, H, Ho, Wo, tp, d_lo, d_hi);
  else
    idwt_adj_h_kernel<float><<<blocks_for(total, threads), threads, 0, stream>>>(
        (const float*)G, P, H, Ho, Wo, tp, d_lo, d_hi);
  return (int)cudaGetLastError();
}

// d_lo, d_hi (P, H, Wo) f32 -> d_yl (P, H, W), d_yh (P, 3, H, W) of bf16
// (bf16 != 0) or f32.
extern "C" int idwt_adj_w_launch(const float* d_lo, const float* d_hi, int P, int H, int W,
                                 int Wo, int bf16, const float* g0, const float* g1, int L, int pl,
                                 void* d_yl, void* d_yh, cudaStream_t stream) {
  if (L > MAX_TAPS || L <= 0) return (int)cudaErrorInvalidValue;
  Taps tp = make_taps(g0, g1, L, pl);
  long long total = (long long)P * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  if (bf16)
    idwt_adj_w_kernel<__nv_bfloat16><<<blocks_for(total, threads), threads, 0, stream>>>(
        d_lo, d_hi, P, H, W, Wo, tp, (__nv_bfloat16*)d_yl, (__nv_bfloat16*)d_yh);
  else
    idwt_adj_w_kernel<float><<<blocks_for(total, threads), threads, 0, stream>>>(
        d_lo, d_hi, P, H, W, Wo, tp, (float*)d_yl, (float*)d_yh);
  return (int)cudaGetLastError();
}
