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
// Design. One warp per keypoint, 8 keypoints per 256-thread block, the
// whole window of frames in one launch (grid.y = frame). Lane c copies
// column c of each of the 32 rows: every row is one coalesced 128-byte
// read and one contiguous 64-byte (bf16) or 128-byte (f32) write. The
// optional bf16 narrowing (__float2bfloat16_rn, round to nearest even)
// happens in registers, halving the write. None of the TPU kernel's
// tile-aligned slabs, packed int32 starts or in-register rolls is needed:
// the GPU reads unaligned rows directly.
//
// Bound: memory traffic. 4 KiB read (mostly L2 hits: neighbouring
// keypoints share rows) and 2 or 4 KiB written per keypoint, no arithmetic
// beyond the start computation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kRadius = 15;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

template <typename OutT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
extract_patches_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                       OutT* __restrict__ out, int H, int W, int N) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (k >= N) return;
  const int lane = threadIdx.x;
  const size_t kp = (size_t)b * N + k;
  const int xs = min(max((int)rintf(xy[2 * kp]) - kRadius, 0), W - kPatch);
  const int ys = min(max((int)rintf(xy[2 * kp + 1]) - kRadius, 0), H - kPatch);
  const float* src = img + (size_t)b * H * W + (size_t)ys * W + xs + lane;
  OutT* dst = out + kp * (kPatch * kPatch) + lane;
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r) store(dst + r * kPatch, src[(size_t)r * W]);
}

template <typename OutT>
int launch(const void* img, const void* xy, void* out, int B, int H, int W, int N, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  extract_patches_kernel<OutT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(xy), static_cast<OutT*>(out), H, W, N);
  return (int)cudaGetLastError();
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
