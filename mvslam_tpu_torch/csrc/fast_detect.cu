// Kernel K1: fused FAST-9/16 corner response + 3x3 NMS + border mask.
//
// Replaces mvslam_tpu/ops/pallas_fast.py::fast_detect_pallas (body
// _detect_kernel / _score_rows). Same function as the Python plain version
// mvslam_tpu_torch/ops/cuda_fast.py::fast_detect_plain:
//
//   raw(y, x) = FAST-9 score: the sum of (|tap - centre| - t) over the taps
//               of a polarity that has a contiguous arc of >= 9 taps beyond
//               the threshold (max of the two polarities), else 0. Taps
//               outside the image read as 0.
//   det(y, x) = raw if raw >= max of its 3x3 window and (y, x) lies
//               `margin` pixels inside the image, else 0.
//
// Design. One thread per output pixel. A block owns a 32x16 output tile and
// stages the tile plus a 4-pixel halo (3 for the radius-3 circle, 1 for the
// NMS window) in shared memory, replacing the TPU kernel's two overlapping
// row views and lane rolls. The block scores the tile plus a 1-pixel ring
// into shared memory, then each thread runs NMS and the border mask from
// there. uint8 input is scored in int32 (exact, and equal to the
// reference's int16 and f32 scores); float input accumulates in f32 in
// circle order, as the plain version does.
//
// Bound: memory traffic (1 B in and 8 B out per pixel on the uint8 path)
// and integer issue (16 taps x ~8 ops per scored pixel, 1.27x scored
// pixels per output for the ring). Not compute throughput: no tensor-core
// work exists here. The halo tile keeps every input pixel to one global
// read per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kPixW = kTileW + 2 * kHalo;  // 40
constexpr int kPixH = kTileH + 2 * kHalo;  // 24
constexpr int kRingW = kTileW + 2;         // 34: tile + 1-pixel NMS ring
constexpr int kRingH = kTileH + 2;         // 18

// FAST circle of radius 3, clockwise from 12 o'clock (ops/fast.py::_CIRCLE).
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// Circular run of 9 set bits in a 16-bit mask: double the mask to 32 bits,
// then log-depth AND-shift halving; bit i of m9 means bits i..i+8 are set.
__device__ __forceinline__ bool has_arc9(unsigned m) {
  const unsigned d = m | (m << 16);
  const unsigned m2 = d & (d >> 1);
  const unsigned m4 = m2 & (m2 >> 2);
  const unsigned m8 = m4 & (m4 >> 4);
  const unsigned m9 = m8 & (d >> 8);
  return (m9 & 0xFFFFu) != 0u;
}

__device__ __forceinline__ int abs_v(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ float abs_v(float v) { return fabsf(v); }

template <typename V>
__device__ __forceinline__ float fast_score(const V (*pix)[kPixW], int sy, int sx, V t) {
  const V c = pix[sy][sx];
  V sb = V(0), sd = V(0);
  unsigned bm = 0u, dm = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const V diff = pix[sy + c_dy[i]][sx + c_dx[i]] - c;
    const bool br = diff > t;
    const bool dk = diff < -t;
    const V excess = abs_v(diff) - t;
    sb = sb + (br ? excess : V(0));
    sd = sd + (dk ? excess : V(0));
    bm |= unsigned(br) << i;
    dm |= unsigned(dk) << i;
  }
  const float fb = has_arc9(bm) ? float(sb) : 0.0f;
  const float fd = has_arc9(dm) ? float(sd) : 0.0f;
  return fmaxf(fb, fd);
}

template <typename T, typename V>
__global__ void __launch_bounds__(kTileW * kTileH)
fast_detect_kernel(const T* __restrict__ img, float* __restrict__ det, float* __restrict__ raw,
                   int H, int W, V t, int margin) {
  __shared__ V pix[kPixH][kPixW];
  __shared__ float score[kRingH][kRingW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * (size_t)W;
  const T* src = img + (size_t)b * plane;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kThreads = kTileW * kTileH;

  // Stage tile + halo; outside the image reads as zero.
  for (int i = tid; i < kPixH * kPixW; i += kThreads) {
    const int sy = i / kPixW, sx = i % kPixW;
    const int gy = y0 - kHalo + sy, gx = x0 - kHalo + sx;
    V v = V(0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = V(src[(size_t)gy * W + gx]);
    pix[sy][sx] = v;
  }
  __syncthreads();

  // Score the tile plus a 1-pixel ring. Ring pixels outside the image score
  // 0, which equals -inf padding for the NMS because every score is >= 0.
  for (int i = tid; i < kRingH * kRingW; i += kThreads) {
    const int ry = i / kRingW, rx = i % kRingW;
    const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
    float s = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) s = fast_score<V>(pix, ry + kHalo - 1, rx + kHalo - 1, t);
    score[ry][rx] = s;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ty = threadIdx.y + 1, tx = threadIdx.x + 1;
  const float c = score[ty][tx];
  float pooled = c;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) pooled = fmaxf(pooled, score[ty + dy][tx + dx]);
  const bool inside = y >= margin && y < H - margin && x >= margin && x < W - margin;
  const size_t o = (size_t)b * plane + (size_t)y * W + x;
  raw[o] = c;
  det[o] = (inside && c >= pooled) ? c : 0.0f;
}

template <typename T, typename V>
int launch(const T* img, float* det, float* raw, int B, int H, int W, V t, int margin,
           cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_detect_kernel<T, V><<<grid, block, 0, stream>>>(img, det, raw, H, W, t, margin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fast_detect_u8(const void* img, void* det, void* raw, int B, int H, int W,
                              int threshold, int margin, void* stream) {
  return launch<uint8_t, int>(static_cast<const uint8_t*>(img), static_cast<float*>(det),
                              static_cast<float*>(raw), B, H, W, threshold, margin,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fast_detect_f32(const void* img, void* det, void* raw, int B, int H, int W,
                               float threshold, int margin, void* stream) {
  return launch<float, float>(static_cast<const float*>(img), static_cast<float*>(det),
                              static_cast<float*>(raw), B, H, W, threshold, margin,
                              static_cast<cudaStream_t>(stream));
}
