// K5: global compaction of the per-ray (N, B) sample layout into a shared
// ray-major buffer of M slots, and K3c: volume compositing of that buffer,
// forward and analytic backward.
//
// K5 replaces trinerflet_tpu/ops/raymarch.py:422 compact_global_dense (both
// its prefix-mask path and its sort path) and :361 compact_samples, as called
// from render/renderer.py:606 (the global layout the budget tuner engages).
// The JAX package finds each slot's source by a flat sort of position keys
// or, for prefix masks, by a boundary scatter-add and two cumsums: the TPU
// has no cheap compaction. Here it is what it is on a GPU: per-ray counts,
// an exclusive scan, one copy pass. An arbitrary mask is compacted in row
// order, which is what both JAX paths yield.
//
// What bounds K5 on the H100: bytes. It reads the (N, B) t, dt and mask and
// the rays, and writes 9 words per slot of the M-slot buffer plus the per-ray
// offsets and counts; a few integer operations per candidate. The design
// (three launches: count, one-block scan, copy) reads the mask three times;
// the copy threads are one per candidate, so reads are coalesced and each
// ray's writes land in one contiguous run. No atomics: the layout is
// deterministic and equal to the JAX package's. The scan is one block of
// 1,024 threads, each owning a contiguous chunk of rays (32 at N = 32,768).
// Built with -fmad=false: xyz = clip(o + d*t) and ts = t + dt - t0 round as
// separate operations, as the plain version's do, so the buffer is equal bit
// for bit.
//
// K3c replaces trinerflet_tpu/ops/raymarch.py:754 composite_compact (the JAX
// package differentiates it through segmented global cumsums). One thread per
// ray walks its segment [offset, offset + count) with a running sum S of
// sd = sigma*dt, kept in float64 and rounded to f32 for T = exp(-S) as the
// plain version rounds its float64 sum (so both take the same t_thresh cut):
// alpha = 1 - exp(-sd), w = alpha*T where T >= t_thresh. It writes sum w,
// sum w*t, sum w*rgb and sum w*t^2; the z-variance is formed from them in
// the wrapper. The JAX package's global
// f32 cumsum minus a per-ray base cancels badly on a large buffer; the
// running per-ray sum is the quantity it stands for.
// Backward: a forward walk parks S_i in the dsigma slot; the reverse walk
// keeps R = sum_{k>i} a_k w_k, with a_k = g_ws + g_depth t_k +
// g_image . rgb_k + g_z2 t_k^2, and writes
// dsigma_i = dt_i (alive_i a_i exp(-sd_i) T_i - R), drgb_i = w_i g_image.
// Padding slots (ray_id >= N) get zeros. Bound: bytes (per slot it reads
// sigma, dt, t, rgb, ray_id and writes dsigma, drgb) for ~20 flops.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 1024
#define PAD_RAY_ID (1 << 30)

__global__ void compact_count_kernel(const uint8_t* __restrict__ mask, int N, int B,
                                     int* __restrict__ counts_full) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint8_t* row = mask + (long long)n * B;
  int c = 0;
  for (int k = 0; k < B; ++k) c += row[k] != 0;
  counts_full[n] = c;
}

// One block: thread i sums the counts of its chunk of rays, the block scans
// the 1,024 partial sums (Hillis-Steele in shared memory), then each thread
// walks its chunk again writing the clipped offsets and counts.
__global__ void compact_scan_kernel(const int* __restrict__ counts_full, int N, int M,
                                    int* __restrict__ offsets, int* __restrict__ counts,
                                    int* __restrict__ num_valid) {
  __shared__ long long part[SCAN_THREADS];
  const int tid = threadIdx.x;
  const int per = (N + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  long long s = 0;
  for (int i = lo; i < hi; ++i) s += counts_full[i];
  part[tid] = s;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    long long v = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  long long run = tid > 0 ? part[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int c = counts_full[i];
    const long long o = run < M ? run : (long long)M;
    const long long room = (long long)M - o;
    offsets[i] = (int)o;
    counts[i] = (int)(c < room ? (long long)c : room);
    run += c;
  }
  if (tid == SCAN_THREADS - 1) {
    const long long total = part[SCAN_THREADS - 1];
    num_valid[0] = (int)(total < M ? total : (long long)M);
  }
}

// One thread per candidate (n, k) of the (N, B) layout, and per buffer slot
// for the padding: a valid candidate goes to slot offsets[n] + (its rank in
// the row) while that is below M; slots at or past num_valid are padding.
__global__ void compact_copy_kernel(const float* __restrict__ rays_o,
                                    const float* __restrict__ rays_d, const float* __restrict__ t,
                                    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
                                    const float* __restrict__ t0, int N, int B, int M, float bound,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ num_valid, float* __restrict__ xyzs,
                                    float* __restrict__ dirs, float* __restrict__ ts,
                                    float* __restrict__ dts, int* __restrict__ ray_id) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long NB = (long long)N * B;
  if (g < NB && mask[g]) {
    const int n = (int)(g / B);
    const int k = (int)(g - (long long)n * B);
    const uint8_t* row = mask + (long long)n * B;
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += row[j] != 0;
    const long long dst = (long long)offsets[n] + rank;
    if (dst < M) {
      const float tt = t[g], d0 = dt[g];
      for (int c = 0; c < 3; ++c) {
        const float o = rays_o[3 * n + c], d = rays_d[3 * n + c];
        const float x = o + d * tt;  // two roundings (-fmad=false)
        xyzs[3 * dst + c] = fminf(fmaxf(x, -bound), bound);
        dirs[3 * dst + c] = d;
      }
      ts[dst] = (tt + d0) - t0[n];
      dts[dst] = d0;
      ray_id[dst] = n;
    }
  }
  if (g < M && g >= num_valid[0]) {
    for (int c = 0; c < 3; ++c) {
      xyzs[3 * g + c] = 0.0f;
      dirs[3 * g + c] = 0.0f;
    }
    ts[g] = 0.0f;
    dts[g] = 0.0f;
    ray_id[g] = PAD_RAY_ID;
  }
}

// rays_o, rays_d (N, 3), t, dt (N, B) f32, mask (N, B) bool bytes, t0 (N,) f32
// -> xyzs, dirs (M, 3), ts, dts (M,) f32, ray_id (M,), offsets, counts (N,),
// num_valid () int32; counts_full (N,) int32 is scratch. Three launches.
extern "C" int compact_launch(const float* rays_o, const float* rays_d, const float* t,
                              const float* dt, const uint8_t* mask, const float* t0, int N, int B,
                              int M, float bound, float* xyzs, float* dirs, float* ts, float* dts,
                              int* ray_id, int* offsets, int* counts, int* num_valid,
                              int* counts_full, cudaStream_t stream) {
  if (N > 0) {
    compact_count_kernel<<<(N + 127) / 128, 128, 0, stream>>>(mask, N, B, counts_full);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  compact_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts_full, N, M, offsets, counts,
                                                       num_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long NB = (long long)N * B;
  const long long work = NB > M ? NB : (long long)M;
  const int threads = 256;
  compact_copy_kernel<<<(unsigned int)((work + threads - 1) / threads), threads, 0, stream>>>(
      rays_o, rays_d, t, dt, mask, t0, N, B, M, bound, offsets, num_valid, xyzs, dirs, ts, dts,
      ray_id);
  return (int)cudaGetLastError();
}

__global__ void composite_compact_kernel(const float* __restrict__ sigma,
                                         const float* __restrict__ rgb,
                                         const float* __restrict__ dts,
                                         const float* __restrict__ ts,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ counts, int N, float t_thresh,
                                         float* __restrict__ ws, float* __restrict__ depth,
                                         float* __restrict__ image, float* __restrict__ z2) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int beg = offsets[n], end = offsets[n] + counts[n];
  double S = 0.0;
  float s_w = 0.f, s_t = 0.f, s_z = 0.f, r = 0.f, g = 0.f, b = 0.f;
  for (int i = beg; i < end; ++i) {
    const float sd = sigma[i] * dts[i];
    const float T = expf(-(float)S);
    const float w = T >= t_thresh ? (1.0f - expf(-sd)) * T : 0.0f;
    const float wt = w * ts[i];
    s_w += w;
    s_t += wt;
    s_z += wt * ts[i];
    r += w * rgb[3 * i];
    g += w * rgb[3 * i + 1];
    b += w * rgb[3 * i + 2];
    S += (double)sd;
  }
  ws[n] = s_w;
  depth[n] = s_t;
  image[3 * n] = r;
  image[3 * n + 1] = g;
  image[3 * n + 2] = b;
  z2[n] = s_z;
}

// sigma, dts, ts (M,) f32, rgb (M, 3) f32, offsets, counts (N,) int32 -> ws,
// depth, z2 (N,), image (N, 3) f32. Only the slots of the segments
// [offset, offset + count) are read.
extern "C" int composite_compact_launch(const float* sigma, const float* rgb, const float* dts,
                                        const float* ts, const int* offsets, const int* counts,
                                        int N, float t_thresh, float* ws, float* depth,
                                        float* image, float* z2, cudaStream_t stream) {
  if (N == 0) return 0;
  const int threads = 128;
  composite_compact_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, dts, ts, offsets, counts, N, t_thresh, ws, depth, image, z2);
  return (int)cudaGetLastError();
}

// One thread per ray (its segment) and per slot (zeros for padding slots).
__global__ void composite_compact_backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ dts,
    const float* __restrict__ ts, const int* __restrict__ ray_id, const int* __restrict__ offsets,
    const int* __restrict__ counts, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_z2, int N, int M, float t_thresh, float* __restrict__ dsigma,
    float* __restrict__ drgb) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < M && ray_id[gid] >= N) {
    dsigma[gid] = 0.0f;
    drgb[3 * gid] = 0.0f;
    drgb[3 * gid + 1] = 0.0f;
    drgb[3 * gid + 2] = 0.0f;
  }
  if (gid >= N) return;
  const int n = gid;
  const int beg = offsets[n], end = offsets[n] + counts[n];
  double S = 0.0;
  for (int i = beg; i < end; ++i) {
    dsigma[i] = (float)S;  // S_i as the forward rounds it, read back by the reverse walk
    S += (double)(sigma[i] * dts[i]);
  }
  const float gw = g_ws[n], gd = g_depth[n], gz = g_z2[n];
  const float gr = g_image[3 * n], gg = g_image[3 * n + 1], gb = g_image[3 * n + 2];
  float R = 0.f;
  for (int i = end - 1; i >= beg; --i) {
    const float T = expf(-dsigma[i]);
    const float sd = sigma[i] * dts[i];
    const float e = expf(-sd);
    const bool alive = T >= t_thresh;
    const float t = ts[i];
    const float a = gw + gd * t + gr * rgb[3 * i] + gg * rgb[3 * i + 1] + gb * rgb[3 * i + 2] +
                    gz * t * t;
    const float w = alive ? (1.0f - e) * T : 0.0f;
    drgb[3 * i] = w * gr;
    drgb[3 * i + 1] = w * gg;
    drgb[3 * i + 2] = w * gb;
    dsigma[i] = dts[i] * ((alive ? a * e * T : 0.0f) - R);
    R += a * w;
  }
}

// Inputs as composite_compact_launch plus ray_id (M,) int32 (to zero the
// padding slots) and the cotangents g_ws, g_depth, g_z2 (N,), g_image (N, 3)
// f32 -> dsigma (M,), drgb (M, 3) f32.
extern "C" int composite_compact_backward_launch(
    const float* sigma, const float* rgb, const float* dts, const float* ts, const int* ray_id,
    const int* offsets, const int* counts, const float* g_ws, const float* g_depth,
    const float* g_image, const float* g_z2, int N, int M, float t_thresh, float* dsigma,
    float* drgb, cudaStream_t stream) {
  const int work = N > M ? N : M;
  if (work == 0) return 0;
  const int threads = 128;
  composite_compact_backward_kernel<<<(work + threads - 1) / threads, threads, 0, stream>>>(
      sigma, rgb, dts, ts, ray_id, offsets, counts, g_ws, g_depth, g_image, g_z2, N, M, t_thresh,
      dsigma, drgb);
  return (int)cudaGetLastError();
}
