// K3: dense per-ray volume compositing, forward and analytic backward, a
// lane group per ray.
//
// Replaces trinerflet_tpu/ops/raymarch.py:805 composite_dense as called from
// render/renderer.py:631 and :671 (the per-ray layout, B ~ 20 samples),
// :505 (the dense renderer, T = 512 and 576) and render/proposal.py:122
// (P = 64, F = 32). The JAX package composites with an exclusive cumprod
// over the (N, T) sample axis and masked sums.
//
// What bounds it on the H100: bytes. Per sample the forward reads sigma,
// delta, t, rgb (24 B) and the mask byte and writes its weight (4 B) for ~10
// flops; the backward also reads g_weights and writes dsigma and drgb.
//
// Design. A group of G lanes (group_for: 8 for rows of up to 24
// samples, 16 up to 64, 32 past that) takes one ray and walks its row in
// chunks of G samples, one sample a lane, so every load of sigma, delta, t,
// the mask and g_weights and every store of a weight or of dsigma is
// contiguous across the group; a block holds 128 / G rays. rgb and drgb move
// as the chunk's 3G contiguous floats, lane l holding elements l, l + G and
// l + 2G, and shuffles hand each lane its own sample's three channels (and
// each element its sample's weight). The next chunk's loads are issued
// before the current chunk's arithmetic. Indices are 32-bit (the wrapper
// refuses rows past that).
//
// Forward. alpha = 1 - exp(-sigma delta) (0 off the mask) and x = (1 -
// alpha) + 1e-15 per lane; the transmittance T_i = prod_{j<i} x_j is an
// exclusive product scan in the order of torch's CUDA cumprod, the plain
// version's (BlockScan: blocks of 32 samples, Sklansky's tree, log2 G
// shuffle steps in a chunk), so the weights are the plain version's bit for
// bit on the card and no weight crosses t_thresh on one side only. w = alpha
// T_i where T_i >= t_thresh, else 0; each lane keeps its sums of w, w t and
// w rgb, reduced once per ray by xor shuffles. The z-variance stays in the
// renderer, as in JAX.
//
// Backward (the JAX package differentiates through the cumprod; this is the
// reverse pass in the manner of torch-ngp's
// kernel_composite_rays_train_backward, exact for cotangents at all four
// outputs). With x_i as above, c_i = [T_i >= t_thresh] and a_i = c_i (g_ws +
// g_depth t_i + g_image . rgb_i + g_weights_i), the suffix sum R_{i-1} =
// b_i + x_i R_i (R_{T-1} = 0, b_i = a_i alpha_i) gives dL/dalpha_i =
// T_i (a_i - R_i) with no division. A first walk runs the forward's scan
// and keeps only each chunk's starting transmittance and its multipliers
// from the 32-block's tree, in shared memory (ceil(T / G) floats a ray at 32
// lanes, 2 and 3 a chunk at 16 and 8); a second walk takes the chunks from
// the last to the first, rebuilds T_i bit for bit from them, and finds R_i
// from a reverse scan of the affine maps f_i(R) = b_i + x_i R (see
// suffix_compose). No T_i goes through device memory and nothing is added
// atomically: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// What one lane holds of a chunk: its own sample's scalars and three of the
// chunk's 3G rgb floats (elements lane, lane + G, lane + 2G).
struct Chunk {
  float sigma, delta, t, g_w;
  float rgb[3];
  bool m;
};

// Which loads a walk needs: the density alone (the backward's first walk),
// the forward's inputs, or those and g_weights.
enum Need { kDensity, kForward, kBackward };

template <int G, Need need>
__device__ __forceinline__ Chunk load_chunk(const float* __restrict__ sigma,
                                            const float* __restrict__ rgb,
                                            const float* __restrict__ delta,
                                            const float* __restrict__ ts,
                                            const uint8_t* __restrict__ mask,
                                            const float* __restrict__ g_weights, int row, int c,
                                            int lane, int T, bool live) {
  Chunk k;
  const int i = c * G + lane;
  const bool ok = live && c >= 0 && i < T;
  const int idx = row + i;
  k.sigma = ok ? sigma[idx] : 0.0f;
  k.delta = ok ? delta[idx] : 0.0f;
  k.m = ok && mask[idx] != 0;
  k.t = 0.0f;
  k.g_w = 0.0f;
  k.rgb[0] = k.rgb[1] = k.rgb[2] = 0.0f;
  if (need != kDensity) {
    k.t = ok ? ts[idx] : 0.0f;
    const int base = 3 * (row + c * G), lim = 3 * (T - c * G);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = lane + j * G;
      k.rgb[j] = (live && c >= 0 && e < lim) ? rgb[base + e] : 0.0f;
    }
  }
  if (need == kBackward) k.g_w = ok ? g_weights[idx] : 0.0f;
  return k;
}

__device__ __forceinline__ float slot(const float v[3], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : v[2]);
}

// Where lane's rgb elements sit: element e_j = lane + j G of a chunk is
// channel e_j % 3 of the chunk's sample e_j / 3; pick[ch] is the slot j
// whose channel is ch, j = (ch - lane) / G mod 3 (G is no multiple of 3, and
// 1 / G mod 3 is G mod 3). No array is indexed at run time, so none leaves
// the registers.
template <int G>
struct Slots {
  int sample[3], channel[3], pick[3];
  __device__ explicit Slots(int lane) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = lane + j * G;
      sample[j] = e / 3;
      channel[j] = e % 3;
      pick[j] = ((j + 3 - lane % 3) * (G % 3)) % 3;
    }
  }
};

// The three channels of this lane's own sample from the chunk's rgb slots:
// channel ch of sample l is element 3l + ch, in lane (3l + ch) % G, which
// sends its slot of channel ch.
template <int G>
__device__ __forceinline__ void own_rgb(const Chunk& k, const Slots<G>& s, int lane,
                                        float col[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    col[ch] = __shfl_sync(kFull, slot(k.rgb, s.pick[ch]), (3 * lane + ch) & (G - 1), G);
}

// Inclusive product scan over a group's G lanes in Sklansky's tree: at step
// s each lane with bit s set multiplies in the last product of the lower
// half of its 2s-block, as ATen's scan does (row_buf[ti] * row_buf[si]).
template <int G>
__device__ __forceinline__ float scan_product(float p, int lane) {
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
    const float y = __shfl_sync(kFull, p, (lane & ~(2 * s - 1)) | (s - 1), G);
    if (lane & s) p = p * y;
  }
  return p;
}

// The transmittance in ATen's order, as checked against torch 2.11.0+cu128
// (CUDA 12.8): a torch whose scan order differs fails
// test_composite_weights_equal_the_plain_version_bit_for_bit with the
// kernel unchanged. torch's CUDA cumprod scans a row in blocks of 32 samples
// (tensor_kernel_scan_innermost_dim at these shapes):
// the earlier blocks' product folded into the block's first factor, then
// Sklansky's tree over the 32. A block is NB = 32 / G chunks. The tree's
// steps below G run inside a chunk (scan_product); step G 2^t multiplies
// every chunk k with bit t set by the last product of chunk (k & ~(2^t -
// 1)) - 1 as it stood before that step (hist), in order of t.
template <int G>
struct BlockScan {
  static constexpr int NB = 32 / G;
  static constexpr int LV = NB == 4 ? 2 : (NB == 2 ? 1 : 0);  // steps from G up
  float hist[NB][LV + 1];  // each chunk's last product before each such step
  float prev = 1.0f;       // the product before the next chunk's first sample

  // Chunk k of its block, from its lanes' factors x: returns T at this
  // lane's sample; m[t] is the multiplier the chunk took at step G 2^t (1
  // where that step passed it by).
  __device__ __forceinline__ float chunk(int k, float x, int lane, float* m) {
    float v = scan_product<G>(lane == 0 && k == 0 ? x * prev : x, lane);
    float last = __shfl_sync(kFull, v, G - 1, G);
    hist[k][0] = last;
#pragma unroll
    for (int t = 0; t < LV; ++t) {
      m[t] = 1.0f;
      if ((k >> t) & 1) {
        m[t] = hist[(k & ~((1 << t) - 1)) - 1][t];
        v = v * m[t];
        last = last * m[t];
      }
      hist[k][t + 1] = last;
    }
    const float up = __shfl_up_sync(kFull, v, 1, G);
    const float trans = lane == 0 ? prev : up;
    prev = last;
    return trans;
  }
};

// Reverse scan of the affine maps f_i(R) = B_i + A_i R over a group's
// lanes. On return lane l holds the composition f_l o f_{l+1} o ... o
// f_{G-1} (the later maps applied first), as (A, B): composing g after h
// gives (A_g A_h, B_g + A_g B_h), and at offset d lane l puts its own map
// after lane l + d's.
template <int G>
__device__ __forceinline__ void suffix_compose(float* A, float* B, int lane) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const float a = __shfl_down_sync(kFull, *A, d, G);
    const float b = __shfl_down_sync(kFull, *B, d, G);
    if (lane + d < G) {
      *B = *B + *A * b;
      *A = *A * a;
    }
  }
}

__device__ __forceinline__ float sum_group(float v, int G) {
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, G);
  return v;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    composite_kernel(const float* __restrict__ sigma, const float* __restrict__ rgb,
                     const float* __restrict__ delta, const float* __restrict__ ts,
                     const uint8_t* __restrict__ mask, int N, int T, float t_thresh,
                     float* __restrict__ ws, float* __restrict__ depth,
                     float* __restrict__ image, float* __restrict__ weights) {
  using Scan = BlockScan<G>;
  const int lane = threadIdx.x & (G - 1);
  const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = n < N;  // every group runs the loop: the shuffles take the whole warp
  const int row = live ? n * T : 0;
  const Slots<G> sl(lane);
  Scan scan;
  float s_w = 0.f, s_t = 0.f, s_r = 0.f, s_g = 0.f, s_b = 0.f;
  Chunk cur = load_chunk<G, kForward>(sigma, rgb, delta, ts, mask, nullptr, row, 0, lane, T, live);
  for (int b = 0; 32 * b < T; ++b) {
#pragma unroll
    for (int k = 0; k < Scan::NB; ++k) {
      const int c = b * Scan::NB + k;
      if (c * G >= T) break;
      const Chunk nxt =
          load_chunk<G, kForward>(sigma, rgb, delta, ts, mask, nullptr, row, c + 1, lane, T, live);
      const int i = c * G + lane;
      const bool ok = live && i < T;
      const float sd = cur.m ? cur.sigma * cur.delta : 0.0f;
      const float alpha = 1.0f - expf(-sd);
      const float x = ok ? (1.0f - alpha) + 1e-15f : 1.0f;
      float m[Scan::LV + 1];
      const float trans = scan.chunk(k, x, lane, m);
      const float w = trans >= t_thresh ? alpha * trans : 0.0f;
      if (ok) weights[row + i] = w;
      float col[3];
      own_rgb<G>(cur, sl, lane, col);
      s_w += w;
      s_t += w * cur.t;
      s_r += w * col[0];
      s_g += w * col[1];
      s_b += w * col[2];
      cur = nxt;
    }
  }
  s_w = sum_group(s_w, G);
  s_t = sum_group(s_t, G);
  s_r = sum_group(s_r, G);
  s_g = sum_group(s_g, G);
  s_b = sum_group(s_b, G);
  if (live && lane == 0) {
    ws[n] = s_w;
    depth[n] = s_t;
    image[3 * n] = s_r;
    image[3 * n + 1] = s_g;
    image[3 * n + 2] = s_b;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) composite_backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ rgb,
    const float* __restrict__ delta, const float* __restrict__ ts,
    const uint8_t* __restrict__ mask, const float* __restrict__ g_ws,
    const float* __restrict__ g_depth, const float* __restrict__ g_image,
    const float* __restrict__ g_weights, int N, int T, float t_thresh,
    float* __restrict__ dsigma, float* __restrict__ drgb) {
  using Scan = BlockScan<G>;
  constexpr int S = Scan::LV + 1;  // floats kept a chunk
  // (kThreads / G) rays x nch chunks x S: each chunk's T at its first sample,
  // then its multipliers from step G up
  extern __shared__ float starts[];
  const int lane = threadIdx.x & (G - 1);
  const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = n < N;
  const int row = live ? n * T : 0;
  const int nch = (T + G - 1) / G;
  float* start = starts + (threadIdx.x / G) * nch * S;

  // walk 1: the forward's scan, keeping each chunk's start and multipliers
  Scan scan;
  Chunk cur = load_chunk<G, kDensity>(sigma, rgb, delta, ts, mask, nullptr, row, 0, lane, T, live);
  for (int b = 0; 32 * b < T; ++b) {
#pragma unroll
    for (int k = 0; k < Scan::NB; ++k) {
      const int c = b * Scan::NB + k;
      if (c * G >= T) break;
      const Chunk nxt =
          load_chunk<G, kDensity>(sigma, rgb, delta, ts, mask, nullptr, row, c + 1, lane, T, live);
      const bool ok = live && c * G + lane < T;
      const float sd = cur.m ? cur.sigma * cur.delta : 0.0f;
      const float alpha = 1.0f - expf(-sd);
      const float x = ok ? (1.0f - alpha) + 1e-15f : 1.0f;
      float m[S];
      const float trans = scan.chunk(k, x, lane, m);
      if (lane == 0) {
        start[c * S] = trans;
#pragma unroll
        for (int t = 0; t < Scan::LV; ++t) start[c * S + 1 + t] = m[t];
      }
      cur = nxt;
    }
  }
  __syncwarp();

  // walk 2: the chunks from the last to the first, carrying R
  const Slots<G> sl(lane);
  const float gw = live ? g_ws[n] : 0.0f, gd = live ? g_depth[n] : 0.0f;
  const float gi[3] = {live ? g_image[3 * n] : 0.0f, live ? g_image[3 * n + 1] : 0.0f,
                       live ? g_image[3 * n + 2] : 0.0f};
  const float g_slot[3] = {slot(gi, sl.channel[0]), slot(gi, sl.channel[1]),
                           slot(gi, sl.channel[2])};  // g_image at each rgb slot's channel
  float R = 0.0f;  // R after the chunk's last sample: R_{T-1} = 0
  cur = load_chunk<G, kBackward>(sigma, rgb, delta, ts, mask, g_weights, row, nch - 1, lane, T,
                                 live);
  for (int c = nch - 1; c >= 0; --c) {
    const Chunk nxt = load_chunk<G, kBackward>(sigma, rgb, delta, ts, mask, g_weights, row, c - 1,
                                               lane, T, live);
    const int i = c * G + lane;
    const bool ok = live && i < T;
    const float sd = cur.m ? cur.sigma * cur.delta : 0.0f;
    const float e = expf(-sd);
    const float alpha = 1.0f - e;
    const float x = ok ? (1.0f - alpha) + 1e-15f : 1.0f;
    // T_i as walk 1 (and the forward) formed it
    const float* st = start + c * S;
    float v = scan_product<G>(lane == 0 && c % Scan::NB == 0 ? x * st[0] : x, lane);
#pragma unroll
    for (int t = 0; t < Scan::LV; ++t) v = v * st[1 + t];
    const float up = __shfl_up_sync(kFull, v, 1, G);
    const float Ti = lane == 0 ? st[0] : up;
    float col[3];
    own_rgb<G>(cur, sl, lane, col);
    const bool keep = ok && Ti >= t_thresh;
    const float a = keep ? gw + gd * cur.t + gi[0] * col[0] + gi[1] * col[1] + gi[2] * col[2] +
                               cur.g_w
                         : 0.0f;
    const float w = keep ? alpha * Ti : 0.0f;
    float A = x, B = ok ? a * alpha : 0.0f;  // f_i; identity past the row's end
    suffix_compose<G>(&A, &B, lane);
    // R_i applies the maps after sample i (lane l + 1 on) to the carry
    const float A1 = __shfl_down_sync(kFull, A, 1, G), B1 = __shfl_down_sync(kFull, B, 1, G);
    const float Ri = lane == G - 1 ? R : B1 + A1 * R;
    if (ok) dsigma[row + i] = cur.m ? cur.delta * e * (Ti * (a - Ri)) : 0.0f;
    const int base = 3 * (row + c * G), lim = 3 * (T - c * G);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float wj = __shfl_sync(kFull, w, sl.sample[j], G);
      const int el = lane + j * G;
      if (live && el < lim) drgb[base + el] = wj * g_slot[j];
    }
    R = __shfl_sync(kFull, B, 0, G) + __shfl_sync(kFull, A, 0, G) * R;
    cur = nxt;
  }
}

template <int G>
int launch_forward(const float* sigma, const float* rgb, const float* delta, const float* ts,
                   const uint8_t* mask, int N, int T, float t_thresh, float* ws, float* depth,
                   float* image, float* weights, cudaStream_t stream) {
  constexpr int rays = kThreads / G;
  composite_kernel<G><<<(N + rays - 1) / rays, kThreads, 0, stream>>>(
      sigma, rgb, delta, ts, mask, N, T, t_thresh, ws, depth, image, weights);
  return (int)cudaGetLastError();
}

template <int G>
int launch_backward(const float* sigma, const float* rgb, const float* delta, const float* ts,
                    const uint8_t* mask, const float* g_ws, const float* g_depth,
                    const float* g_image, const float* g_weights, int N, int T, float t_thresh,
                    float* dsigma, float* drgb, cudaStream_t stream) {
  constexpr int rays = kThreads / G;
  const size_t smem = sizeof(float) * rays * ((T + G - 1) / G) * (BlockScan<G>::LV + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  composite_backward_kernel<G><<<(N + rays - 1) / rays, kThreads, smem, stream>>>(
      sigma, rgb, delta, ts, mask, g_ws, g_depth, g_image, g_weights, N, T, t_thresh, dsigma,
      drgb);
  return (int)cudaGetLastError();
}

// Lanes per ray for rows of T samples: short rows take several rays a warp.
int group_for(int T) { return T <= 24 ? 8 : (T <= 64 ? 16 : 32); }

}  // namespace

// sigma, delta, ts (N, T) f32; rgb (N, T, 3) f32; mask (N, T) bool bytes
// -> ws (N,), depth (N,), image (N, 3), weights (N, T), all f32.
extern "C" int composite_launch(const float* sigma, const float* rgb, const float* delta,
                                const float* ts, const uint8_t* mask, int N, int T,
                                float t_thresh, float* ws, float* depth, float* image,
                                float* weights, cudaStream_t stream) {
  if (N == 0) return 0;
  switch (group_for(T)) {
    case 8:
      return launch_forward<8>(sigma, rgb, delta, ts, mask, N, T, t_thresh, ws, depth, image,
                               weights, stream);
    case 16:
      return launch_forward<16>(sigma, rgb, delta, ts, mask, N, T, t_thresh, ws, depth, image,
                                weights, stream);
    default:
      return launch_forward<32>(sigma, rgb, delta, ts, mask, N, T, t_thresh, ws, depth, image,
                                weights, stream);
  }
}

// Inputs as composite_launch plus the cotangents g_ws, g_depth (N,),
// g_image (N, 3), g_weights (N, T) f32 -> dsigma (N, T), drgb (N, T, 3) f32.
// Refuses (cudaErrorInvalidValue) rows whose chunk starts pass 48 KB of
// shared memory a block: T > 98,304 at 32 lanes.
extern "C" int composite_backward_launch(const float* sigma, const float* rgb, const float* delta,
                                         const float* ts, const uint8_t* mask, const float* g_ws,
                                         const float* g_depth, const float* g_image,
                                         const float* g_weights, int N, int T, float t_thresh,
                                         float* dsigma, float* drgb, cudaStream_t stream) {
  if (N == 0) return 0;
  switch (group_for(T)) {
    case 8:
      return launch_backward<8>(sigma, rgb, delta, ts, mask, g_ws, g_depth, g_image, g_weights, N,
                                T, t_thresh, dsigma, drgb, stream);
    case 16:
      return launch_backward<16>(sigma, rgb, delta, ts, mask, g_ws, g_depth, g_image, g_weights,
                                 N, T, t_thresh, dsigma, drgb, stream);
    default:
      return launch_backward<32>(sigma, rgb, delta, ts, mask, g_ws, g_depth, g_image, g_weights,
                                 N, T, t_thresh, dsigma, drgb, stream);
  }
}
