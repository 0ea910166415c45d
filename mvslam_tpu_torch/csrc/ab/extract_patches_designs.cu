// Designs of K2 (csrc/extract_patches.cu) that were measured against it and
// lost; built only by `chip_smoke.py --ab-k2`, which times each beside the
// library's kernel, never by the library (csrc/ab/ is not one of its
// sources). The same C entry points and the same function, bit for bit;
// DESIGN picks one:
//
//   1  staged, vector stores: each lane issues all 32 of its rows at once as
//      4-byte cp.async copies into the warp's 4 KiB of shared memory, waits
//      once, then the warp writes the tile with 16-byte stores (the bf16
//      narrowing on the way out);
//   2  staged, bulk store: as 1, then one cp.async.bulk store per tile from
//      shared memory (bf16 narrowed into a second 2 KiB buffer first);
//   3  rows in registers: all 32 rows loaded into registers before the
//      first of the 32 per-row stores;
//   4  shared window: a 256-thread block owns 128 x 32 tile starts of one
//      frame, stages the 63 x 159 image window they cover in shared memory,
//      scans the frame's keypoints for its own and writes their tiles out of
//      shared memory with 16-byte stores;
//   5  streaming stores: the library's kernel with its stores marked
//      evict-first (st.global.cs), so that the tiles do not push the image
//      out of L2. The tiles' consumer (BRIEF's tests, LK's sums) reads them
//      right after, so evicting them first would move the cost there.
//
// Designs 1-3 and 5 give one warp to each keypoint, 4 keypoints per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef DESIGN
#define DESIGN 1
#endif

namespace {

constexpr int kPatch = 32;
constexpr int kRadius = 15;
constexpr int kTileFloats = kPatch * kPatch;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int tile_start(float p, int radius, int dim) {
  return min(max((int)rintf(p) - radius, 0), dim - kPatch);
}

#if DESIGN == 1 || DESIGN == 2
// A staged f32 tile (row-major 32 x 32 in shared memory) out to global.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic-proxy writes before the bulk read
  __syncwarp();
  if (lane == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void store_tile(const float* tile, uint4*, float* dst, int lane) {
#if DESIGN == 2
  bulk_store(dst, tile, kTileFloats * 4, lane);
#else
  const float4* src = reinterpret_cast<const float4*>(tile);
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kTileFloats / 4 / 32; ++i) out[i * 32 + lane] = src[i * 32 + lane];
#endif
}

__device__ __forceinline__ void store_tile(const float* tile, uint4* narrow, __nv_bfloat16* dst, int lane) {
  const float4* src = reinterpret_cast<const float4*>(tile);
  uint4* out = DESIGN == 2 ? narrow : reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < kTileFloats / 8 / 32; ++i) {
    const int q = i * 32 + lane;  // 8 values: row q / 4, columns (q % 4) * 8 ..
    const float4 a = src[2 * q], c = src[2 * q + 1];
    out[q] = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(c.x, c.y),
                        pack_bf16x2(c.z, c.w));
  }
#if DESIGN == 2
  bulk_store(dst, narrow, kTileFloats * 2, lane);
#endif
}
#endif

#if DESIGN == 5
__device__ __forceinline__ void store(float* dst, float v) { __stcs(dst, v); }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  asm volatile("st.global.cs.b16 [%0], %1;\n" :: "l"(dst), "h"(__bfloat16_as_ushort(__float2bfloat16_rn(v))) : "memory");
}
#else
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }
#endif

#if DESIGN != 4
template <typename OutT>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
extract_patches_kernel(const float* __restrict__ img, const float* __restrict__ xy,
                       OutT* __restrict__ out, int H, int W, int N) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (k >= N) return;
  const int lane = threadIdx.x;
  const size_t kp = (size_t)b * N + k;
  const int xs = tile_start(xy[2 * kp], kRadius, W);
  const int ys = tile_start(xy[2 * kp + 1], kRadius, H);
  const float* src = img + ((size_t)b * H + ys) * W + xs + lane;
#if DESIGN == 5
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r) store(out + kp * kTileFloats + r * kPatch + lane, src[(size_t)r * W]);
#elif DESIGN == 3
  float v[kPatch];
#pragma unroll
  for (int r = 0; r < kPatch; ++r) v[r] = src[(size_t)r * W];
#pragma unroll
  for (int r = 0; r < kPatch; ++r) store(out + kp * kTileFloats + r * kPatch + lane, v[r]);
#else
  __shared__ __align__(128) float stage[kWarpsPerBlock][kTileFloats];
#if DESIGN == 2
  __shared__ __align__(128) uint4 narrow[kWarpsPerBlock][kTileFloats / 8];
  uint4* tile_narrow = narrow[threadIdx.y];
#else
  uint4* tile_narrow = nullptr;
#endif
  float* tile = stage[threadIdx.y];
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(tile + lane));
#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst + r * kPatch * 4), "l"(src + (size_t)r * W) : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  store_tile(tile, tile_narrow, out + kp * kTileFloats, lane);
#endif
}

template <typename OutT>
int launch(const void* img, const void* xy, void* out, int B, int H, int W, int N, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  extract_patches_kernel<OutT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(xy), static_cast<OutT*>(out), H, W, N);
  return (int)cudaGetLastError();
}
#else
constexpr int kRegionX = 128, kRegionY = 32;  // tile starts a block owns
constexpr int kWindowX = kRegionX + kPatch - 1, kWindowY = kRegionY + kPatch - 1;
constexpr int kWindowStride = kWindowX + 2;  // odd: a warp's tile reads fall in distinct banks
constexpr int kChunk = 1024;                 // keypoints scanned per round

__device__ __forceinline__ void emit(const float* t, float* dst, int lane) {
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = i * 32 + lane, r = q >> 3, c = (q & 7) * 4;
    const float* p = t + r * kWindowStride + c;
    out[q] = make_float4(p[0], p[1], p[2], p[3]);
  }
}

__device__ __forceinline__ void emit(const float* t, __nv_bfloat16* dst, int lane) {
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = i * 32 + lane, r = q >> 2, c = (q & 3) * 8;
    const float* p = t + r * kWindowStride + c;
    out[q] = make_uint4(pack_bf16x2(p[0], p[1]), pack_bf16x2(p[2], p[3]), pack_bf16x2(p[4], p[5]),
                        pack_bf16x2(p[6], p[7]));
  }
}

template <typename OutT>
__global__ void __launch_bounds__(256)
extract_patches_kernel(const float* __restrict__ img, const float* __restrict__ xy, OutT* __restrict__ out,
                       int H, int W, int N, int regions_x) {
  __shared__ float window[kWindowY * kWindowStride];
  __shared__ int list_k[kChunk];
  __shared__ int list_at[kChunk];
  __shared__ int count;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = (blockIdx.x % regions_x) * kRegionX, y0 = (blockIdx.x / regions_x) * kRegionY;
  const int wx = min(kWindowX, W - x0), wy = min(kWindowY, H - y0);
  const float* base = img + ((size_t)b * H + y0) * W + x0;
#pragma unroll 4
  for (int r = warp; r < wy; r += 8) {
    float v[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) v[j] = lane + 32 * j < wx ? base[(size_t)r * W + lane + 32 * j] : 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (lane + 32 * j < kWindowX) window[r * kWindowStride + lane + 32 * j] = v[j];
    }
  }
  const float* kxy = xy + (size_t)b * N * 2;
  OutT* kout = out + (size_t)b * N * kTileFloats;
  for (int k0 = 0; k0 < N; k0 += kChunk) {
    if (tid == 0) count = 0;
    __syncthreads();
    for (int k = k0 + tid; k < min(N, k0 + kChunk); k += 256) {
      const int xs = tile_start(kxy[2 * k], kRadius, W) - x0;
      const int ys = tile_start(kxy[2 * k + 1], kRadius, H) - y0;
      if (xs >= 0 && xs < kRegionX && ys >= 0 && ys < kRegionY) {
        const int slot = atomicAdd(&count, 1);
        list_k[slot] = k;
        list_at[slot] = ys * kWindowStride + xs;
      }
    }
    __syncthreads();
    const int n = count;
    for (int i = warp; i < n; i += 8) emit(window + list_at[i], kout + (size_t)list_k[i] * kTileFloats, lane);
    __syncthreads();
  }
}

template <typename OutT>
int launch(const void* img, const void* xy, void* out, int B, int H, int W, int N, void* stream) {
  const int rx = (W - kPatch + kRegionX) / kRegionX, ry = (H - kPatch + kRegionY) / kRegionY;
  extract_patches_kernel<OutT><<<dim3(rx * ry, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(xy), static_cast<OutT*>(out), H, W, N, rx);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

extern "C" int extract_patches_f32(const void* img, const void* xy, void* out, int B, int H, int W,
                                   int N, void* stream) {
  return launch<float>(img, xy, out, B, H, W, N, stream);
}

extern "C" int extract_patches_bf16(const void* img, const void* xy, void* out, int B, int H, int W,
                                    int N, void* stream) {
  return launch<__nv_bfloat16>(img, xy, out, B, H, W, N, stream);
}
