// K2's latency floor, built only by `chip_smoke.py --ab-k2`: the grid and
// blocks of csrc/extract_patches.cu (one warp per keypoint, grid.y = frame,
// 8 keypoints per block or 4 where that gives fewer than two blocks per SM)
// doing one load and one store per tile. What a launch of that grid costs
// before any tile's bytes move.

#include <cuda_runtime.h>

namespace {

constexpr int kSpreadBelow = 2 * 132;

template <int kWarpsPerBlock>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k2_floor_kernel(const float* __restrict__ xy, float* __restrict__ out, int N) {
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (k >= N || threadIdx.x != 0) return;
  const size_t kp = (size_t)blockIdx.y * N + k;
  out[kp * 1024] = xy[2 * kp];
}

template <int kWarpsPerBlock>
int launch(const void* xy, void* out, int B, int N, void* stream) {
  k2_floor_kernel<kWarpsPerBlock><<<dim3((N + kWarpsPerBlock - 1) / kWarpsPerBlock, B), dim3(32, kWarpsPerBlock), 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xy), static_cast<float*>(out), N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k2_floor(const void* xy, void* out, int B, int N, void* stream) {
  if ((long long)B * ((N + 7) / 8) < kSpreadBelow) return launch<4>(xy, out, B, N, stream);
  return launch<8>(xy, out, B, N, stream);
}
