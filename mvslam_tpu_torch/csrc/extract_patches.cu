// Kernel K2: one 32x32 image tile per keypoint (BRIEF patch extraction).
//
// Replaces mvslam_tpu/ops/pallas_patches.py::extract_patches_pallas (core
// _extract_batched, custom-vmap rules _extract_vmappable and
// _extract_vmappable_narrow). Same function as the Python plain version
// mvslam_tpu_torch/ops/cuda_patches.py::extract_patches_plain:
//
//   start = clip(rint(xy) - 15, 0, dim - 32)       (per axis)
//   out[b, k, r * 32 + c] = image[b, ys + r, xs + c]  (r, c in 0..31)
//
// rintf rounds half to even, like jnp.round / torch.round: subpixel offsets
// are clipped to +-0.5, so exact .5 coordinates do occur.
//
// Bound: memory traffic. 4 KiB read and 2 or 4 KiB written per keypoint, no
// arithmetic beyond the start computation. On the H100 (chip_smoke.py
// --ab-k2, PERF.md) a one-frame launch takes about the floor (a kernel with
// this grid doing one load and one store per tile: 1.1-1.3 us) plus the
// bytes bound; windows of 4 to 16 frames reach 71-89% of the bound.
//
// Design. One warp per keypoint, the whole window of frames in one launch
// (grid.y = frame), 8 keypoints per 256-thread block; a grid that would give
// the card's 132 SMs fewer than two such blocks each (one frame: 2,048
// keypoints make 256, 512 make 64) takes 4 keypoints per block instead, so
// that more SMs hold tiles in flight. Lane c copies column c of each of the
// 32 rows, 8 rows in flight: every row is one coalesced 128-byte read and one
// contiguous 64-byte (bf16) or 128-byte (f32) write, and the writes of one
// group of rows overlap the reads of the next. The bf16 narrowing
// (__float2bfloat16_rn, round to nearest even) happens in registers. Designs
// that put all 32 rows of a tile in flight (cp.async into shared memory, then
// 16-byte vector or cp.async.bulk stores; or all rows in registers) and one
// that stages a shared image window per block of tile starts are kept in
// csrc/ab/extract_patches_designs.cu: each measured slower (PERF.md). Tiled
// TMA loads cannot describe the image (a tensor map's row stride must be a
// multiple of 16 bytes; W * 4 rarely is), and a row start at xs * 4 bytes
// rules out copies wider than 4 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kRadius = 15;
constexpr int kSpreadBelow = 2 * 132;  // 8-keypoint blocks under which a grid takes 4-keypoint blocks

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

template <int kWarpsPerBlock, typename OutT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
extract_patches_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                       OutT* __restrict__ out, int H, int W, int N) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (k >= N) return;  // whole warps: N need not be a multiple of the block's keypoints
  const int lane = threadIdx.x;
  const size_t kp = (size_t)b * N + k;
  const int xs = min(max((int)rintf(xy[2 * kp]) - kRadius, 0), W - kPatch);
  const int ys = min(max((int)rintf(xy[2 * kp + 1]) - kRadius, 0), H - kPatch);
  const float* src = img + ((size_t)b * H + ys) * W + xs + lane;
  OutT* dst = out + kp * (kPatch * kPatch) + lane;
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r) store(dst + r * kPatch, src[(size_t)r * W]);
}

template <int kWarpsPerBlock, typename OutT>
int launch_with(const void* img, const void* xy, void* out, int B, int H, int W, int N, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  extract_patches_kernel<kWarpsPerBlock, OutT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(xy), static_cast<OutT*>(out), H, W, N);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* img, const void* xy, void* out, int B, int H, int W, int N, void* stream) {
  if ((long long)B * ((N + 7) / 8) < kSpreadBelow) return launch_with<4, OutT>(img, xy, out, B, H, W, N, stream);
  return launch_with<8, OutT>(img, xy, out, B, H, W, N, stream);
}

}  // namespace

extern "C" int extract_patches_f32(const void* img, const void* xy, void* out, int B, int H, int W,
                                   int N, void* stream) {
  return launch<float>(img, xy, out, B, H, W, N, stream);
}

extern "C" int extract_patches_bf16(const void* img, const void* xy, void* out, int B, int H, int W,
                                    int N, void* stream) {
  return launch<__nv_bfloat16>(img, xy, out, B, H, W, N, stream);
}
