// K11: the registry's textured background, an equirectangular learnable
// texture sampled by view direction, forward and texture-gradient backward.
//
// Replaces trinerflet_tpu/models/registry.py:204 background_textured and its
// autodiff. On the TPU the 4 texel lookups are flat row-takes of the
// (H*W, 3) texture, because a TPU gather costs per row; its backward is
// XLA's scatter-add.
//
// The function, per ray, as JAX computes it op by op (this file is compiled
// with -fmad=false, so every operation rounds alone): dn = d / |d|,
// theta = acos(clip(dn_y, -1, 1)), phi = atan2(dn_x, dn_z) + pi,
// v = clip(theta / pi * (H - 1), 0, float32(H - 1 - 1e-6)),
// u = clip(phi / (2 pi) * (W - 1), 0, float32(W - 1 - 1e-6)), the 4 taps
// (min(v0 + dv, H-1), min(u0 + du, W-1)), dv the outer, with weights
// wv * wu, summed acc + row * w in tap order, then a sigmoid. The seam: phi
// jumps from 2 pi to 0 where d_x crosses 0 with d_z < 0, and the texture
// does not wrap, so u jumps from W - 1 to 0 there; CUDA's atan2f and XLA's
// may put a direction within an ulp of the seam on opposite sides.
//
// What bounds it on the H100: bytes in principle (per ray the direction in,
// 4 texel rows of 3 f32 from the L2, 3 f32 out; ~80 flops with acosf,
// atan2f and expf), but at the registry's 16,384-32,768 rays the whole call
// is a few microseconds: one dependent chain of arithmetic per ray and the
// launch itself. Measured (scripts/torch_k7x_k11_timing.py --profile): the
// forward kernel runs 2-3 us, less than the ~5 us a timed one-element fill_
// takes; the backward ~9 us at 32,768 rays, of which its float atomics take
// ~4 and the fill with its grid.sync ~2.
//
// Forward: one thread per ray in 256-thread blocks. 64-ray blocks, each
// tap's row read as an aligned float2 and a float, and the directions and
// colours staged through shared memory as 16-byte accesses were measured
// and dropped: none moved the time of a call that is mostly its launch.
//
// Backward: one cooperative launch. The grid is the resident blocks (no
// more than the 64-ray tiles or the fill need); it zeroes the (H, W, 3)
// gradient grid-stride, meets at one grid.sync(), then walks the tiles
// grid-stride: a tile's directions, cotangents and forward outputs are
// staged coalesced, each ray forms gs = g s (1 - s) once (a ray whose gs
// is all zero adds nothing) and its 4 taps. Per tap the warp's lanes are
// grouped by texel row (__match_any_sync); each group's terms w * gs are
// summed in lane order by shuffles and its lowest lane adds the sum: a
// float2 vector atomic on the aligned pair of channels (rows are 12 bytes:
// channels 0-1 of an even row, 1-2 of an odd one) plus one scalar atomic. The texture gradient needs no
// shared memory, so any H and W work. The fill folded into the launch took
// 0.0134 ms against 0.0133 for a torch.zeros plus the accumulating launch
// on the registry-grid step's call, and 0.0135 against 0.0139 on one
// camera's rays (--two-launch). Float atomics add in an unspecified
// order across warps; every entry stays a float32 sum of the plain
// version's terms. The direction gets no gradient: it is a ray direction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace cg = cooperative_groups;

#define K11_PI 3.14159265358979323846f
#define K11_TWO_PI 6.28318530717958647692f
#define K11_RAYS 64  // rays a backward block, a thread each

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

// n consecutive global floats into 16-byte aligned shared memory, the
// block's threads on consecutive float4s where the source is aligned.
__device__ __forceinline__ void stage_in(const float* __restrict__ src, int n, float* dst) {
  int j = threadIdx.x;
  if (((uintptr_t)src & 15) == 0) {
    const int n4 = n >> 2;
    for (; j < n4; j += blockDim.x)
      reinterpret_cast<float4*>(dst)[j] = __ldg(reinterpret_cast<const float4*>(src) + j);
    j = 4 * n4 + threadIdx.x;
  }
  for (; j < n; j += blockDim.x) dst[j] = __ldg(src + j);
}

// Adds v (3 floats) into texel row r: one float2 atomic on the aligned pair
// and one scalar atomic.
__device__ __forceinline__ void add_texel(float* gtex, int r, const float v[3]) {
  float* p = gtex + 3 * (size_t)r;
  if (r & 1) {
    atomicAdd(p, v[0]);
    atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(v[1], v[2]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    atomicAdd(p + 2, v[2]);
  }
}

// One tap of the warp: lanes with key >= 0 (their texel row) are grouped by
// row; each group's terms are summed in lane order, its lowest lane adding
// the sum. Every lane of the warp calls it.
__device__ __forceinline__ void merge_and_add(float* gtex, int key, const float v[3], int lane) {
  const unsigned FULL = 0xffffffffu;
  const unsigned grp = __match_any_sync(FULL, key);
  const bool leads = key >= 0 && (__ffs(grp) - 1) == lane;
  unsigned todo = leads ? grp & (grp - 1) : 0u;  // the leader takes the others in lane order
  float acc[3] = {v[0], v[1], v[2]};
  while (__any_sync(FULL, todo != 0u)) {
    const int src = todo ? __ffs(todo) - 1 : lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float y = __shfl_sync(FULL, v[c], src);
      if (todo) acc[c] = acc[c] + y;
    }
    todo &= todo - 1u;
  }
  if (leads) add_texel(gtex, key, acc);
}

// A cooperative launch: zeroes the 3 H W gradient grid-stride, meets at
// grid.sync(), then adds the tiles' merged terms.
__global__ void __launch_bounds__(K11_RAYS) textured_bg_backward_kernel(
    const float* __restrict__ d, const float* __restrict__ g, const float* __restrict__ s, long long N, int H,
    int W, float hi_v, float hi_u, float* __restrict__ gtex) {
  __shared__ __align__(16) float ds[3 * K11_RAYS], gsh[3 * K11_RAYS], ss[3 * K11_RAYS];
  {
    const long long n = 3LL * H * W, n4 = n >> 2;  // gtex is 16-byte aligned (the launcher checks)
    const long long stride = (long long)gridDim.x * blockDim.x, i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = i0; i < n4; i += stride) reinterpret_cast<float4*>(gtex)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = 4 * n4 + i0; i < n; i += stride) gtex[i] = 0.0f;
  }
  cg::this_grid().sync();
  const int t = threadIdx.x, lane = t & 31;
  const long long tiles = (N + K11_RAYS - 1) / K11_RAYS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long n0 = tile * K11_RAYS;
    const int nr = (int)min((long long)K11_RAYS, N - n0);
    stage_in(d + 3 * n0, 3 * nr, ds);
    stage_in(g + 3 * n0, 3 * nr, gsh);
    stage_in(s + 3 * n0, 3 * nr, ss);
    __syncthreads();
    float gs[3] = {0.0f, 0.0f, 0.0f};
    bool any = false;
    if (t < nr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float sc = ss[3 * t + c];
        gs[c] = gsh[3 * t + c] * (sc * (1.0f - sc));
        any |= gs[c] != 0.0f;
      }
    }
    long long rows[4];
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (any) texel_taps(ds, t, H, W, hi_v, hi_u, rows, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v[3] = {w[k] * gs[0], w[k] * gs[1], w[k] * gs[2]};
      merge_and_add(gtex, any ? (int)rows[k] : -1, v, lane);  // a 32-bit key: a 64-bit match was slower
    }
    __syncthreads();  // the next tile overwrites the staged rows
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

// The cooperative grid of the backward: the SMs times its resident blocks
// an SM, read once per device.
static cudaError_t resident_blocks(long long* out) {
  static std::atomic<long long> cached[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && (*out = cached[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, textured_bg_backward_kernel, K11_RAYS, 0);
  if (err) return err;
  *out = (long long)sms * per_sm;
  if (dev < 64) cached[dev].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

// d (N, 3) f32, g (N, 3) f32 cotangent, s (N, 3) f32 forward output -> the
// texture gradient gtex (H*W, 3) f32 (16-byte aligned), the sums of w * g
// s (1 - s) over each row's taps (float atomics in an unspecified order).
// One cooperative launch that zeroes gtex first; a card that refuses it
// returns its error. H * W < 2^31 (rows are merged by a 32-bit key).
extern "C" int textured_bg_backward_launch(const float* d, const float* g, const float* s, long long N, int H,
                                           int W, float hi_v, float hi_u, float* gtex, cudaStream_t stream) {
  if (H < 1 || W < 1 || (long long)H * W > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)gtex % 16) return (int)cudaErrorMisalignedAddress;
  long long resident;
  cudaError_t err = resident_blocks(&resident);
  if (err) return (int)err;
  const long long tiles = (N + K11_RAYS - 1) / K11_RAYS;
  const long long fill_blocks = (3LL * H * W / 4 + K11_RAYS - 1) / K11_RAYS;
  const long long blocks = std::max(1LL, std::min(resident, std::max(tiles, fill_blocks)));
  void* args[] = {(void*)&d, (void*)&g, (void*)&s, (void*)&N, (void*)&H, (void*)&W, (void*)&hi_v, (void*)&hi_u,
                  (void*)&gtex};
  return (int)cudaLaunchCooperativeKernel((const void*)textured_bg_backward_kernel, dim3((unsigned int)blocks),
                                          dim3(K11_RAYS), args, 0, stream);
}
