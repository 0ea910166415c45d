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
// Bound. At the main path's uint8 (16, 370, 1226) the function moves 1 B in
// and 8 B out per pixel: 65.3 MB, 19.5 us at 3.35 TB/s; the reference's own
// cost estimate (180 ops/px) gives the same 19.5 us at the 67 TFLOP/s
// float32 peak. The float32 route moves 12 B/px: 26.0 us. On the card the
// kernel reaches neither: its phases (staging, arcs, scores, NMS + stores)
// add up instead of overlapping (PERF.md, PR 3).
//
// Design. A tile is 126 output columns x SH - 2 rows (SH = 32, or 16 when a
// launch has too few tiles to fill the card, as for one frame). As many
// 256-thread blocks as fit on the card at once walk the tiles.
//   1. Staging: the tile's scored region (128 x SH, the tile plus its
//      1-pixel NMS ring) plus the circle's 3-pixel halo goes to shared memory
//      once, in 4-column groups. The next tile's global loads are issued
//      before this tile is scored and land in registers meanwhile. uint8
//      rows are only 2-byte aligned: two aligned 32-bit loads and a funnel
//      shift per group, bytes one by one only in the tiles at the image's
//      left and right edges. uint8 is staged as biased halves (1024 + v).
//   2. Arcs: a thread takes 8 horizontally adjacent pixels of one scored
//      row; the region holds exactly SH x 16 such items, a whole number of
//      passes for 256 threads. Tap offsets are compile-time constants: each
//      row segment is read with 128-bit shared loads and the taps picked
//      from registers. The compares land tap-major, one bit per pixel and
//      polarity, so one bit-sliced run test covers all 16 pixel-polarities
//      of an item. uint8 compares two pixels per instruction in packed fp16,
//      every value an integer and exact, and sums each tap's bits in fp16;
//      float32 compares diff = tap - c with t and -t as the plain version
//      does.
//   3. Scores: only a corner (a pixel with an arc, a few percent of them)
//      has a nonzero score, so the block lists its tile's corners in shared
//      memory and sums their excesses 256 at a time: int32 for uint8 (equal
//      to the plain version's int32 score), and for float32 the plain
//      version's expressions in circle order (diff = tap - c, excess =
//      |diff| - t; there is no multiply, so no FMA can form).
//   4. NMS + border: a thread takes 2 output columns down a quarter of the
//      tile's rows, keeping the 3x3 window's row maxima in registers, and
//      writes det and raw as float2 where the element index is even (rows
//      of 1226 floats are only 8-byte aligned).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 8;                 // scored pixels per item, along x
constexpr int kSegs = 16;              // items per scored row
constexpr int kScoreW = kPx * kSegs;   // 128 scored columns: tile + NMS ring
constexpr int kTileW = kScoreW - 2;    // 126 output columns per block
constexpr int kStageW = kScoreW + 8;   // 136 staged columns
constexpr int kStageX = 5;             // staged column k is image column x0 - 5 + k
constexpr int kGroups = kStageW / 4;   // 34 four-column staging groups per row

// FAST circle of radius 3, clockwise from 12 o'clock (ops/fast.py::_CIRCLE).
__host__ __device__ constexpr int circle_dy(int i) {
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[i];
}
__host__ __device__ constexpr int circle_dx(int i) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[i];
}

// Bit-sliced test for a circular run of 9 among 16 taps, for 16 lanes at
// once (a lane is one pixel and polarity): w[k] holds every lane's bit for
// tap k in bits 0-15 and for tap k + 8 in bits 16-31, so swapping the
// halves of a word steps 8 taps round the circle. Returns the lanes with a
// run: m3 lane bit k = taps k..k+2 set, m9 = taps k..k+8 set.
__device__ __forceinline__ uint32_t swap_halves(uint32_t x) { return __byte_perm(x, 0, 0x1032); }
__device__ __forceinline__ uint32_t runs9(const uint32_t (&w)[8]) {
  uint32_t m3[14];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    m3[k] = w[k] & (k + 1 < 8 ? w[k + 1] : swap_halves(w[k - 7])) & (k + 2 < 8 ? w[k + 2] : swap_halves(w[k - 6]));
#pragma unroll
  for (int k = 0; k < 6; ++k) m3[8 + k] = swap_halves(m3[k]);
  uint32_t r = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) r |= m3[k] & m3[k + 3] & m3[k + 6];
  return (r | r >> 16) & 0xFFFFu;
}

// Bits 0-3 of each byte to its even bits (0, 2, 4, 6).
__device__ __forceinline__ uint32_t spread_even(uint32_t x) {
  x = (x | x << 2) & 0x3333u;
  return (x | x << 1) & 0x5555u;
}

__device__ __forceinline__ __half2 as_h2(uint32_t u) {
  __half2 h;
  memcpy(&h, &u, sizeof(h));
  return h;
}

__device__ __forceinline__ uint32_t as_u32(__half2 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// ---- staging: 4-column groups of a tile, held in registers from their
// loads to their store into shared memory ----

// A thread's share of one tile's staging groups: group k is item
// threadIdx.x + k * kThreads of the tile's rows x kGroups. load() only
// issues the global loads (zero outside the image); store() consumes them.
// Called one tile ahead, the loads fly while the block scores a tile.
template <typename T, int N>
struct Groups;

template <int N>
struct Groups<uint8_t, N> {
  uint32_t lo[N], hi[N], shifts;  // aligned words around each group; 2 bits of byte shift each

  __device__ __forceinline__ void load(const uint8_t* src, int H, int W, int x0, int y0, int items) {
    shifts = 0u;
    if (x0 - kStageX >= 0 && x0 - kStageX + kStageW <= W) {
      // Every staged column lies inside the image (block-uniform): rows are
      // only 2-byte aligned, so load the aligned words around each group and
      // funnel-shift them in store().
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int sr = i / kGroups, gy = y0 - 4 + sr;
        lo[k] = hi[k] = 0u;
        if (i < items && gy >= 0 && gy < H) {
          const uintptr_t p = reinterpret_cast<uintptr_t>(src + (size_t)gy * W + x0 - kStageX + 4 * (i - sr * kGroups));
          const uint32_t* w = reinterpret_cast<const uint32_t*>(p & ~uintptr_t(3));
          lo[k] = __ldg(w);
          if (p & 3u) hi[k] = __ldg(w + 1);
          shifts |= uint32_t(p & 3u) << (2 * k);
        }
      }
    } else {
      // A tile at the left or right edge: bytes one by one, zero outside.
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int sr = i / kGroups, gy = y0 - 4 + sr, gx = x0 - kStageX + 4 * (i - sr * kGroups);
        lo[k] = hi[k] = 0u;
        if (i < items && gy >= 0 && gy < H) {
          const uint8_t* row = src + (size_t)gy * W;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gx + c >= 0 && gx + c < W) lo[k] |= uint32_t(row[gx + c]) << (8 * c);
        }
      }
    }
  }

  // Biased halves (0x6400 | v = 1024 + v), two words per group.
  __device__ __forceinline__ void store(uint32_t* stage, int items) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= items) break;
      const uint32_t w = __funnelshift_r(lo[k], hi[k], ((shifts >> (2 * k)) & 3u) * 8u);
      *reinterpret_cast<uint2*>(stage + 2 * i) =
          make_uint2(__byte_perm(w, 0x64646464u, 0x4140), __byte_perm(w, 0x64646464u, 0x4342));
    }
  }
};

template <int N>
struct Groups<float, N> {
  float v[N][4];

  __device__ __forceinline__ void load(const float* src, int H, int W, int x0, int y0, int items) {
    const bool cols_in = x0 - kStageX >= 0 && x0 - kStageX + kStageW <= W;  // block-uniform
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int sr = i / kGroups, gy = y0 - 4 + sr, gx = x0 - kStageX + 4 * (i - sr * kGroups);
      const bool row_in = i < items && gy >= 0 && gy < H;
      const float* row = src + (size_t)(row_in ? gy : 0) * W;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[k][c] = (row_in && (cols_in || (gx + c >= 0 && gx + c < W))) ? __ldg(row + gx + c) : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* stage, int items) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= items) break;
      *reinterpret_cast<float4*>(stage + 4 * i) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
};

// ---- arcs and scores: 8 pixels, centre at staged columns 8s+4 .. 8s+11 ----

// uint8 route. A staged row segment is 8 words w[0..7] (16 biased halves at
// staged columns 8s .. 8s+15); pixel pair j (columns 8s+4+2j, +1) at tap
// offset DX is word 2+j+DX/2 for even DX, and straddles two words for odd DX.
template <int DX>
__device__ __forceinline__ uint32_t tap_pair(const uint32_t (&w)[8], int j) {
  if constexpr ((DX & 1) == 0) {
    return w[(4 + 2 * j + DX) / 2];
  } else {
    constexpr int k0 = (3 + DX) / 2;
    return __byte_perm(w[k0 + j], w[k0 + j + 1], 0x5432);
  }
}

__device__ __forceinline__ void load_row(uint32_t (&w)[8], const uint32_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// One tap of 4 pixel pairs (pixel 2j in the low half of pair j, 2j + 1 in
// the high half): 1024 + the tap's bits in fp16 (exact below 2048), whose
// low byte is bright pair j at bit j and dark at bit 4 + j. Bright compares
// are HSET2s to 1.0/0.0 on the integer pipe, dark ones saturated HFMA2s
// (1 exactly when the integer difference is >= 1) on the FMA pipe.
template <int I>
__device__ __forceinline__ __half2 u8_tap(const __half2 (&ct)[4], const __half2 (&cmt)[4], const uint32_t (&w)[8]) {
  __half2 acc = __float2half2_rn(1024.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __half2 v = as_h2(tap_pair<circle_dx(I)>(w, j));
    const __half2 bright = __hgt2(v, ct[j]);
    const __half2 dark = __hfma2_sat(v, __float2half2_rn(-1.0f), cmt[j]);  // 1 iff tap < c - t
    acc = __hfma2(bright, __float2half2_rn(float(1 << j)), acc);
    acc = __hfma2(dark, __float2half2_rn(float(16 << j)), acc);
  }
  return acc;
}

// Arcs of the 8 pixels whose dy = -3 row starts at seg (word 4s of a staged
// row; row stride kStageW / 2 words): bit k = bright arc of pixel k, bit
// 8 + k = dark arc.
__device__ __forceinline__ uint32_t arcs8(const uint32_t* seg, int t) {
  constexpr int kRow = kStageW / 2;
  __half2 ct[4], cmt[4], acc[16];
  uint32_t w[8];
  const __half2 t2 = __float2half2_rn(float(t));
  load_row(w, seg + 3 * kRow);  // centre row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __half2 c = as_h2(w[2 + j]);
    ct[j] = __hadd2_rn(c, t2);
    cmt[j] = __hsub2_rn(c, t2);
  }
  acc[4] = u8_tap<4>(ct, cmt, w);
  acc[12] = u8_tap<12>(ct, cmt, w);
  load_row(w, seg);  // dy = -3
  acc[0] = u8_tap<0>(ct, cmt, w);
  acc[1] = u8_tap<1>(ct, cmt, w);
  acc[15] = u8_tap<15>(ct, cmt, w);
  load_row(w, seg + kRow);  // dy = -2
  acc[2] = u8_tap<2>(ct, cmt, w);
  acc[14] = u8_tap<14>(ct, cmt, w);
  load_row(w, seg + 2 * kRow);  // dy = -1
  acc[3] = u8_tap<3>(ct, cmt, w);
  acc[13] = u8_tap<13>(ct, cmt, w);
  load_row(w, seg + 4 * kRow);  // dy = 1
  acc[5] = u8_tap<5>(ct, cmt, w);
  acc[11] = u8_tap<11>(ct, cmt, w);
  load_row(w, seg + 5 * kRow);  // dy = 2
  acc[6] = u8_tap<6>(ct, cmt, w);
  acc[10] = u8_tap<10>(ct, cmt, w);
  load_row(w, seg + 6 * kRow);  // dy = 3
  acc[7] = u8_tap<7>(ct, cmt, w);
  acc[8] = u8_tap<8>(ct, cmt, w);
  acc[9] = u8_tap<9>(ct, cmt, w);
  // Lanes: the low bytes of taps k and k + 8, pair halves side by side, so
  // lane bits 0-3 = bright of pixels 0, 2, 4, 6, 4-7 = their dark, 8-15 the
  // same for pixels 1, 3, 5, 7.
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __byte_perm(as_u32(acc[k]), as_u32(acc[k + 8]), 0x6420);
  const uint32_t r = runs9(w);
  const uint32_t even = (r & 0xFu) | (r & 0xF0u) << 4, odd = (r >> 8 & 0xFu) | (r >> 4 & 0xF00u);
  return spread_even(even) | spread_even(odd) << 1;
}

// The score of one corner (a pixel with an arc), at staged column col of
// scored row r: the sum over its arc's polarity (two arcs cannot coexist
// for t >= 0) of max(tap - (c + t), 0) or max((c - t) - tap, 0), in int32
// like the plain version. A staged half's low byte is the pixel value.
__device__ __forceinline__ float corner_score(const uint32_t* stage, int r, int col, int t, bool bright,
                                              bool /*dark*/) {
  const uint8_t* px = reinterpret_cast<const uint8_t*>(stage) + 2 * ((r + 3) * kStageW + col);
  const int c = px[0], sign = bright ? 1 : -1;
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) sum += max(sign * (int(px[2 * (circle_dy(i) * kStageW + circle_dx(i))]) - c) - t, 0);
  return float(sum);
}

// float32 route, the arcs of 8 pixels: dy = -3 row at seg (column 8s of a
// staged row), row stride kStageW floats; bits as for uint8. Masks use the
// plain version's diff = tap - c and compares diff > t, diff < -t; lane k is
// bright pixel k, lane 8 + k dark pixel k.
__device__ __forceinline__ uint32_t arcs8(const float* seg, float t) {
  float c[kPx];
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    c[k] = seg[3 * kStageW + 4 + k];
    w[k] = 0u;
  }
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
    float v[16];
    const float4* row = reinterpret_cast<const float4*>(seg + dy * kStageW);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = row[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (circle_dy(i) != dy - 3) continue;
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const float diff = v[4 + k + circle_dx(i)] - c[k];
        if (diff > t) w[i & 7] |= 1u << (k + (i & 8) * 2);
        if (diff < -t) w[i & 7] |= 1u << (8 + k + (i & 8) * 2);
      }
    }
  }
  return runs9(w);
}

// The score of one float32 corner: the plain version's expressions and
// summation order (circle order; diff = tap - c, excess = |diff| - t).
__device__ __forceinline__ float corner_score(const float* stage, int r, int col, float t, bool bright,
                                              bool dark) {
  const float* px = stage + (r + 3) * kStageW + col;
  const float c = px[0];
  float sb = 0.0f, sd = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float diff = px[circle_dy(i) * kStageW + circle_dx(i)] - c;
    const float excess = fabsf(diff) - t;
    sb = sb + (diff > t ? excess : 0.0f);
    sd = sd + (diff < -t ? excess : 0.0f);
  }
  return fmaxf(bright ? sb : 0.0f, dark ? sd : 0.0f);
}

// ---- the kernel ----

template <typename T>
using StageT = std::conditional_t<std::is_same_v<T, uint8_t>, uint32_t, float>;
template <typename T>
constexpr int kStageRow = std::is_same_v<T, uint8_t> ? kStageW / 2 : kStageW;  // elements per staged row

// Horizontal 3-max of scored row r around the pair of output columns
// 2p, 2p + 1 (scored columns 2p + 1, 2p + 2), and the pair's own scores.
struct RowMax {
  float a, b, ca, cb;
};
__device__ __forceinline__ RowMax row_max(const float* score, int r, int p) {
  const float* s = score + r * kScoreW + 2 * p;
  const float2 u = *reinterpret_cast<const float2*>(s);
  const float2 v = *reinterpret_cast<const float2*>(s + 2);
  const float mid = fmaxf(u.y, v.x);
  return {fmaxf(u.x, mid), fmaxf(mid, v.y), u.y, v.x};
}

template <typename T, typename V, int SH>
__global__ void __launch_bounds__(kThreads, std::is_same_v<T, uint8_t> ? 4 : 2)
fast_detect_kernel(const T* __restrict__ img, float* __restrict__ det, float* __restrict__ raw,
                   int H, int W, V t, int margin, int tiles_x, int tiles_y, int tiles) {
  constexpr int kRows = SH + 6;                   // scored rows plus the circle's 3-row halo
  constexpr int kTileH = SH - 2;                  // output rows per tile
  constexpr int kItems = kRows * kGroups;         // staging groups per tile
  static_assert(SH * kScoreW <= 4096, "a corner's score index must fit 12 bits");
  constexpr int kNmsRows = (kTileH + 3) / 4;      // output rows per thread in the NMS
  constexpr int kGroupElems = std::is_same_v<T, uint8_t> ? 2 : 4;
  __shared__ __align__(16) StageT<T> stage[kRows * kStageRow<T>];
  __shared__ __align__(16) float score[SH * kScoreW];
  __shared__ uint16_t corners[SH * kScoreW];  // this tile's corners, in any order
  __shared__ int num_corners;

  // Persistent blocks walk the tiles (x fastest, then y, then frame) and
  // load tile k + 1's staging groups into registers while scoring tile k.
  const int plane_tiles = tiles_x * tiles_y;
  Groups<T, (kItems + kThreads - 1) / kThreads> groups;
  if (blockIdx.x < tiles) {
    const int tile = blockIdx.x;
    groups.load(img + (size_t)(tile / plane_tiles) * H * W, H, W, (tile % tiles_x) * kTileW,
                tile / tiles_x % tiles_y * kTileH, kItems);
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x0 = (tile % tiles_x) * kTileW, y0 = tile / tiles_x % tiles_y * kTileH;
    const size_t plane = (size_t)(tile / plane_tiles) * H * W;

    // 1. Stage image rows y0-4 .. y0+SH+1, columns x0-5 .. x0+130 (zero
    //    outside), then start the next tile's loads.
    groups.store(stage, kItems);
    if (threadIdx.x == 0) num_corners = 0;
    const int next = tile + gridDim.x;
    if (next < tiles)
      groups.load(img + (size_t)(next / plane_tiles) * H * W, H, W, (next % tiles_x) * kTileW,
                  next / tiles_x % tiles_y * kTileH, kItems);
    __syncthreads();

    // 2. Score rows y0-1 .. y0+SH-2, columns x0-1 .. x0+126; 0 outside the
    //    image, which is -inf padding for the NMS because every score is >= 0.
    //    First the arcs of every pixel (8 per item), listing the corners
    //    (a few percent of the pixels); then the block sums the excesses of
    //    the listed corners only, 256 at a time.
#pragma unroll
    for (int it = 0; it < SH * kSegs / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kSegs, s = i % kSegs;
      const int gy = y0 - 1 + r, gx = x0 - 1 + kPx * s;
      uint32_t arcs = 0u;
      if (gy >= 0 && gy < H && gx < W) {
        const uint32_t inside = ((gx + kPx <= W ? 0xFFu : (1u << (W - gx)) - 1u) & (gx < 0 ? 0xFEu : 0xFFu)) * 0x101u;
        arcs = arcs8(stage + r * kStageRow<T> + s * (kPx * kGroupElems / 4), t) & inside;
      }
      float4* dst = reinterpret_cast<float4*>(score + r * kScoreW + kPx * s);
      dst[0] = dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      uint32_t px = (arcs | arcs >> 8) & 0xFFu;
      if (px != 0u) {
        int slot = atomicAdd(&num_corners, __popc(px));
        for (; px != 0u; px &= px - 1u, ++slot) {
          const int k = __ffs(px) - 1;
          // score index (12 bits), bright arc (bit 12), dark arc (bit 13)
          corners[slot] = uint16_t((r * kScoreW + kPx * s + k) | ((arcs >> k) & 1u) << 12 |
                                   ((arcs >> (8 + k)) & 1u) << 13);
        }
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < num_corners; q += kThreads) {
      const int e = corners[q], idx = e & 0xFFF;
      score[idx] = corner_score(stage, idx / kScoreW, idx % kScoreW + 4, t, (e >> 12) & 1, (e >> 13) & 1);
    }
    __syncthreads();

    // 3. NMS + border mask. Thread (p, q) takes output columns x0 + 2p,
    //    x0 + 2p + 1 down its quarter of the tile's rows, sliding the 3x3
    //    window one row at a time: scored row r + 1 holds output row r.
    const int p = threadIdx.x & 63, x = x0 + 2 * p;
    const int r0 = (threadIdx.x >> 6) * kNmsRows, r1 = min(min(r0 + kNmsRows, kTileH), H - y0);
    if (p < 63 && x < W && r0 < r1) {
      const bool a_in = x >= margin && x < W - margin, b_in = x + 1 >= margin && x + 1 < W - margin;
      RowMax m0 = row_max(score, r0, p), m1 = row_max(score, r0 + 1, p);
      size_t o = plane + (size_t)(y0 + r0) * W + x;
      for (int r = r0; r < r1; ++r, o += W) {
        const RowMax m2 = row_max(score, r + 2, p);
        const bool rows_in = y0 + r >= margin && y0 + r < H - margin;
        const float da = (rows_in && a_in && m1.ca >= fmaxf(fmaxf(m0.a, m1.a), m2.a)) ? m1.ca : 0.0f;
        const float db = (rows_in && b_in && m1.cb >= fmaxf(fmaxf(m0.b, m1.b), m2.b)) ? m1.cb : 0.0f;
        if (x + 1 < W && (o & 1) == 0) {
          *reinterpret_cast<float2*>(raw + o) = make_float2(m1.ca, m1.cb);
          *reinterpret_cast<float2*>(det + o) = make_float2(da, db);
        } else {
          raw[o] = m1.ca;
          det[o] = da;
          if (x + 1 < W) {
            raw[o + 1] = m1.cb;
            det[o + 1] = db;
          }
        }
        m0 = m1;
        m1 = m2;
      }
    }
  }
}

// One block per tile, or as many persistent blocks as the card holds at
// once when there are more tiles than that.
template <typename T, typename V, int SH>
int launch_tiles(const T* img, float* det, float* raw, int B, int H, int W, V t, int margin,
                 int sms, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fast_detect_kernel<T, V, SH>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + SH - 3) / (SH - 2);
  const long long tiles = (long long)tiles_x * tiles_y * B;
  const int grid = (int)std::min<long long>(tiles, (long long)per_sm * sms);
  fast_detect_kernel<T, V, SH><<<grid, kThreads, 0, stream>>>(img, det, raw, H, W, t, margin, tiles_x,
                                                               tiles_y, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T, typename V>
int launch(const T* img, float* det, float* raw, int B, int H, int W, V t, int margin,
           cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Tall tiles (less ring recompute) when they still give 4 tiles per SM;
  // else short ones, so that one frame fills the card too.
  const long long tall = (long long)((W + kTileW - 1) / kTileW) * ((H + 29) / 30) * B;
  if (tall >= 4LL * sms) return launch_tiles<T, V, 32>(img, det, raw, B, H, W, t, margin, sms, stream);
  return launch_tiles<T, V, 16>(img, det, raw, B, H, W, t, margin, sms, stream);
}

}  // namespace

// uint8 image with an integral threshold >= 0 (the wrapper's uint8 route).
extern "C" int fast_detect_u8(const void* img, void* det, void* raw, int B, int H, int W,
                              int threshold, int margin, void* stream) {
  if (threshold < 0) return (int)cudaErrorInvalidValue;
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
