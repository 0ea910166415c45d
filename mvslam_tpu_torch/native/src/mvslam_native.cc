// mvslam_native — the host data plane of mvslam_tpu_torch, in C++.
//
// The compute path is PyTorch and CUDA; this library is the runtime
// around it on the host CPU:
//
//   * mvn_decode_gray  — PNG (grey, grey+alpha, RGB, RGBA and palette, at
//     every bit depth the format allows, Adam7 interlacing included) and
//     binary PGM (P5) decode straight into a caller-owned 8-bit grey
//     buffer. PNG is parsed and unfiltered here on zlib's inflate alone,
//     so the library needs no libpng. The pixels are those libpng gives
//     under png_set_rgb_to_gray_fixed(png, 1, 29900, 58700) with
//     strip_16, palette_to_rgb, expand_gray_1_2_4_to_8, tRNS_to_alpha and
//     strip_alpha: colour to grey by weights 9797/19234/3737 over 2^15,
//     truncated for 8-bit samples and rounded for 16-bit ones before their
//     low byte is dropped; grey colour (R = G = B) passes unchanged.
//     A colour file whose gAMA or sRGB chunk makes libpng's gamma
//     significant takes libpng's gamma path instead (GammaPath below).
//     iCCP and cHRM chunks are not read.
//   * mvn_loader_*     — a decode pool (std::thread) over a preallocated
//     slot ring that delivers frames strictly in sequence order with
//     bounded-capacity backpressure: workers may finish out of order, the
//     consumer always sees sequence order.
//   * mvn_hamming_match — the packed-Hamming brute-force matcher, equal to
//     ops/hamming.py::match_descriptors bit for bit.
//
// A plain C ABI for ctypes. Thread safety: one consumer thread per loader;
// any number of internal workers. A loader allocates all of its buffers
// when it is created.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrTooLarge = -3;
constexpr int kErrDecode = -4;

// ---------------------------------------------------------------------------
// PGM (P5) decode
// ---------------------------------------------------------------------------

bool SkipPgmWhitespace(const uint8_t*& p, const uint8_t* end) {
  while (p < end) {
    if (*p == '#') {  // comment to end of line
      while (p < end && *p != '\n') ++p;
    } else if (std::isspace(*p)) {
      ++p;
    } else {
      return true;
    }
  }
  return false;
}

bool ParsePgmInt(const uint8_t*& p, const uint8_t* end, long* out) {
  if (!SkipPgmWhitespace(p, end) || !std::isdigit(*p)) return false;
  long v = 0;
  while (p < end && std::isdigit(*p)) {
    v = v * 10 + (*p++ - '0');
    if (v > (1L << 31)) return false;
  }
  *out = v;
  return true;
}

int DecodePgmGray(const uint8_t* data, size_t size, uint8_t* out,
                  int32_t cap_h, int32_t cap_w, int32_t* h, int32_t* w) {
  const uint8_t* p = data;
  const uint8_t* end = data + size;
  if (size < 2 || p[0] != 'P' || p[1] != '5') return kErrFormat;
  p += 2;
  long width = 0, height = 0, maxval = 0;
  if (!ParsePgmInt(p, end, &width) || !ParsePgmInt(p, end, &height) ||
      !ParsePgmInt(p, end, &maxval)) {
    return kErrDecode;
  }
  if (p >= end || !std::isspace(*p)) return kErrDecode;
  ++p;  // single whitespace after maxval
  if (width <= 0 || height <= 0 || maxval <= 0 || maxval > 65535) return kErrDecode;
  if (height > cap_h || width > cap_w) return kErrTooLarge;
  const size_t n = static_cast<size_t>(width) * static_cast<size_t>(height);
  if (maxval < 256) {
    if (static_cast<size_t>(end - p) < n) return kErrDecode;
    if (maxval == 255) {
      std::memcpy(out, p, n);
    } else {  // rescale a non-standard maxval to [0, 255] with rounding
      for (size_t i = 0; i < n; ++i) {
        long v = p[i] > maxval ? maxval : p[i];
        out[i] = static_cast<uint8_t>((v * 255 + maxval / 2) / maxval);
      }
    }
  } else {  // 16-bit big-endian -> scaled to [0, 255] with rounding
    if (static_cast<size_t>(end - p) < 2 * n) return kErrDecode;
    for (size_t i = 0; i < n; ++i) {
      long v = (static_cast<long>(p[2 * i]) << 8) | p[2 * i + 1];
      if (v > maxval) v = maxval;
      out[i] = static_cast<uint8_t>((v * 255 + maxval / 2) / maxval);
    }
  }
  *h = static_cast<int32_t>(height);
  *w = static_cast<int32_t>(width);
  return kOk;
}

// ---------------------------------------------------------------------------
// PNG decode on zlib
// ---------------------------------------------------------------------------

constexpr uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
constexpr uint32_t kPngMaxLength = 0x7fffffffu;  // PNG's 31-bit limit

// libpng's coefficients for png_set_rgb_to_gray_fixed(png, 1, 29900, 58700):
// red and green truncated to 2^15 / 100000 units, blue the remainder.
constexpr uint32_t kRedCoeff = 9797;
constexpr uint32_t kGreenCoeff = 19234;
constexpr uint32_t kBlueCoeff = 32768 - kRedCoeff - kGreenCoeff;

// Adam7 passes: x start, y start, x step, y step.
constexpr int kAdam7[7][4] = {
    {0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2},
};

inline uint32_t ReadBE32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

inline uint8_t Luma8(uint32_t r, uint32_t g, uint32_t b) {
  if (r == g && r == b) return static_cast<uint8_t>(r);
  return static_cast<uint8_t>((kRedCoeff * r + kGreenCoeff * g + kBlueCoeff * b) >> 15);
}

inline uint8_t Luma16(uint32_t r, uint32_t g, uint32_t b) {
  if (r == g && r == b) return static_cast<uint8_t>(r >> 8);
  const uint32_t grey = (kRedCoeff * r + kGreenCoeff * g + kBlueCoeff * b + 16384) >> 15;
  return static_cast<uint8_t>(grey >> 8);
}

struct PngHeader {
  uint32_t width = 0;
  uint32_t height = 0;
  int depth = 0;
  int color = 0;
  int interlace = 0;
  int channels = 0;
};

// ---------------------------------------------------------------------------
// libpng 1.6's gamma path for rgb_to_gray
// ---------------------------------------------------------------------------
//
// With no screen gamma set, libpng takes the screen gamma to be the
// reciprocal of the file's; it builds its gamma tables, and rgb_to_gray
// then converts through them, when either value lies more than
// PNG_GAMMA_THRESHOLD_FIXED (5000) from 1.0 (units of 1e-5). Colour goes
// to linear (to_1), is weighted and rounded (+16384), and comes back
// (from_1); grey colour (R = G = B) goes through the file-to-screen table.
// Every table entry is libpng's own double expression (its floating
// arithmetic build); the code is built with -ffp-contract=off so that no
// multiply-add is fused where libpng's is not.

constexpr int32_t kFixedOne = 100000;
constexpr int32_t kGammaThreshold = 5000;
constexpr int32_t kGammaSrgb = 45455;  // PNG_GAMMA_sRGB_INVERSE
constexpr int kMaxGamma8 = 11;         // PNG_MAX_GAMMA_8

inline bool GammaSignificant(int64_t g) {  // png_gamma_significant
  return g < kFixedOne - kGammaThreshold || g > kFixedOne + kGammaThreshold;
}

inline int64_t FixedRound(double r) {  // floor(r + .5), 0 past 32 bits as libpng
  r = std::floor(r + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int64_t>(r) : 0;
}

inline int64_t Reciprocal(int64_t a) { return FixedRound(1E10 / a); }  // png_reciprocal

inline int64_t Reciprocal2(int64_t a, int64_t b) {  // png_reciprocal2
  double r = 1E15 / a;
  r /= b;
  return FixedRound(r);
}

inline int64_t Product2(int64_t a, int64_t b) {  // png_product2
  double r = a * 1E-5;
  r *= b;
  return FixedRound(r);
}

// png_build_8bit_table with png_gamma_8bit_correct.
void BuildTable8(int64_t gamma, uint8_t* table) {
  for (int i = 0; i < 256; ++i) {
    if (GammaSignificant(gamma) && i > 0 && i < 255) {
      table[i] = static_cast<uint8_t>(std::floor(255 * std::pow(i / 255., gamma * .00001) + .5));
    } else {
      table[i] = static_cast<uint8_t>(i);
    }
  }
}

// png_build_16bit_table: (256 >> shift) sub-tables of 256, entry
// [low][high] at low * 256 + high.
void BuildTable16(int shift, int64_t gamma, std::vector<uint16_t>* table) {
  const unsigned num = 1u << (8 - shift);
  const double fmax = 1.0 / ((1 << (16 - shift)) - 1);
  const unsigned max = (1u << (16 - shift)) - 1u;
  const unsigned max_by_2 = 1u << (15 - shift);
  table->assign(num * 256, 0);
  for (unsigned i = 0; i < num; ++i) {
    for (unsigned j = 0; j < 256; ++j) {
      uint32_t ig = (j << (8 - shift)) + i;
      if (GammaSignificant(gamma)) {
        (*table)[i * 256 + j] =
            static_cast<uint16_t>(std::floor(65535. * std::pow(ig * fmax, gamma * .00001) + .5));
      } else {
        if (shift != 0) ig = (ig * 65535u + max_by_2) / max;
        (*table)[i * 256 + j] = static_cast<uint16_t>(ig);
      }
    }
  }
}

inline uint32_t GammaCorrect16(uint32_t value, int64_t gamma) {  // png_gamma_16bit_correct
  if (value == 0 || value >= 65535) return value;
  return static_cast<uint32_t>(std::floor(65535 * std::pow(value / 65535., gamma * .00001) + .5));
}

// png_build_16to8_table: the nearest 8-bit output (times 257) per input.
void BuildTable16To8(int shift, int64_t gamma, std::vector<uint16_t>* table) {
  const unsigned num = 1u << (8 - shift);
  const uint32_t max = (1u << (16 - shift)) - 1u;
  table->assign(num * 256, 0);
  uint32_t last = 0;
  auto put = [&](uint32_t v, uint16_t out) {
    (*table)[(v & (0xffu >> shift)) * 256 + (v >> (8 - shift))] = out;
  };
  for (unsigned i = 0; i < 255; ++i) {
    const uint16_t out = static_cast<uint16_t>(i * 257u);
    uint32_t bound = GammaCorrect16(out + 128u, gamma);
    bound = (bound * max + 32768u) / 65535u + 1u;
    while (last < bound) put(last++, out);
  }
  while (last < (num << 8)) put(last++, 65535u);
}

// What libpng reads from gAMA, sRGB and sBIT before PLTE and IDAT, with its
// rules: an ancillary chunk with a bad CRC or the wrong length is dropped;
// a gAMA out of [16, 625000000] or a second stored gAMA, or an sRGB chunk
// with an undefined intent, marks the colour space invalid, and after that
// no gAMA or sRGB is stored (the gamma already stored stays); sRGB sets
// 45455 once; a gAMA after sRGB is stored only where it agrees with 45455
// within the threshold. The first valid sBIT counts.
struct ColourChunks {
  int64_t gamma = 0;  // 0: the file states none
  bool from_gama = false;
  bool from_srgb = false;
  bool invalid = false;
  int sig_bit = 0;  // largest colour sBIT, 0 without one
  bool have_sbit = false;

  void Chunk(const uint8_t* type, const uint8_t* body, uint32_t len, const PngHeader& hd) {
    if (std::memcmp(type, "gAMA", 4) == 0 && len == 4) {
      const uint32_t raw = ReadBE32(body);
      const int64_t g = raw > 0x7fffffffu ? -1 : raw;  // png_get_fixed_point
      if (g < 16 || g > 625000000 || from_gama) {
        invalid = true;
      } else if (!invalid) {
        if (from_srgb) {  // png_colorspace_check_gamma against sRGB
          double r = static_cast<double>(gamma);
          r *= kFixedOne;
          r /= g;
          r = std::floor(r + .5);
          if (r > 2147483647. || GammaSignificant(static_cast<int64_t>(r))) return;
        }
        gamma = g;
        from_gama = true;
      }
    } else if (std::memcmp(type, "sRGB", 4) == 0 && len == 1) {
      if (invalid || from_srgb) return;
      if (body[0] > 3) {
        invalid = true;
        return;
      }
      gamma = kGammaSrgb;
      from_srgb = true;
    } else if (std::memcmp(type, "sBIT", 4) == 0 && !have_sbit) {
      const uint32_t want = hd.color == 3 ? 3 : static_cast<uint32_t>(hd.channels);
      const int sample_depth = hd.color == 3 ? 8 : hd.depth;
      if (len != want) return;
      for (uint32_t i = 0; i < len; ++i) {
        if (body[i] == 0 || body[i] > sample_depth) return;
      }
      have_sbit = true;
      sig_bit = (hd.color & 2) ? std::max({body[0], body[1], body[2]}) : body[0];
    }
  }
};

// The tables of libpng's gamma path, for 8-bit samples (palette entries
// included) or 16-bit ones; `on` is false where libpng takes the plain path.
struct GammaPath {
  bool on = false;
  uint8_t to1[256], from1[256], grey[256];
  int shift = 0;
  std::vector<uint16_t> to1_16, from1_16, grey_16;

  void Build(const ColourChunks& cs, const PngHeader& hd) {
    const bool colour = hd.color == 2 || hd.color == 3 || hd.color == 6;
    if (!colour || cs.gamma == 0) return;
    const int64_t file = cs.gamma;
    const int64_t screen = Reciprocal(file);
    if (!GammaSignificant(file) && !GammaSignificant(screen)) return;
    on = true;
    if (hd.depth <= 8) {
      BuildTable8(Reciprocal2(file, screen), grey);
      BuildTable8(Reciprocal(file), to1);
      BuildTable8(Reciprocal(screen), from1);
      return;
    }
    // png_build_gamma_table's shift: the insignificant bits (sBIT), at
    // least 16 - PNG_MAX_GAMMA_8 since strip_16 follows, at most 8.
    shift = (cs.sig_bit > 0 && cs.sig_bit < 16) ? 16 - cs.sig_bit : 0;
    shift = std::min(std::max(shift, 16 - kMaxGamma8), 8);
    BuildTable16To8(shift, Product2(file, screen), &grey_16);
    BuildTable16(shift, Reciprocal(file), &to1_16);
    BuildTable16(shift, Reciprocal(screen), &from1_16);
  }

  uint8_t Luma8(uint32_t r, uint32_t g, uint32_t b) const {
    if (r == g && r == b) return grey[r];
    return from1[(kRedCoeff * to1[r] + kGreenCoeff * to1[g] + kBlueCoeff * to1[b] + 16384) >> 15];
  }

  uint16_t Look16(const std::vector<uint16_t>& table, uint32_t v) const {
    return table[((v & 0xffu) >> shift) * 256 + (v >> 8)];
  }

  uint8_t Luma16(uint32_t r, uint32_t g, uint32_t b) const {
    if (r == g && r == b) return static_cast<uint8_t>(Look16(grey_16, r) >> 8);
    const uint32_t lin = (kRedCoeff * Look16(to1_16, r) + kGreenCoeff * Look16(to1_16, g) +
                          kBlueCoeff * Look16(to1_16, b) + 16384) >> 15;
    return static_cast<uint8_t>(Look16(from1_16, lin) >> 8);
  }
};


bool ValidHeader(const PngHeader& hd) {
  if (hd.width == 0 || hd.height == 0 || hd.width > kPngMaxLength || hd.height > kPngMaxLength) {
    return false;
  }
  switch (hd.color) {
    case 0:
      return hd.depth == 1 || hd.depth == 2 || hd.depth == 4 || hd.depth == 8 || hd.depth == 16;
    case 3:
      return hd.depth == 1 || hd.depth == 2 || hd.depth == 4 || hd.depth == 8;
    case 2:
    case 4:
    case 6:
      return hd.depth == 8 || hd.depth == 16;
    default:
      return false;
  }
}

inline size_t RowBytes(const PngHeader& hd, size_t pixels) {
  return (pixels * hd.channels * hd.depth + 7) / 8;
}

// Undo one scanline's filter in place; `prev` is the unfiltered row above
// (all zero for a pass's first row). Returns false on an undefined filter.
bool UnfilterRow(int filter, uint8_t* row, const uint8_t* prev, size_t len, size_t bpp) {
  switch (filter) {
    case 0:
      return true;
    case 1:  // Sub
      for (size_t i = bpp; i < len; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:  // Up
      for (size_t i = 0; i < len; ++i) row[i] = static_cast<uint8_t>(row[i] + prev[i]);
      return true;
    case 3:  // Average
      for (size_t i = 0; i < bpp && i < len; ++i) {
        row[i] = static_cast<uint8_t>(row[i] + (prev[i] >> 1));
      }
      for (size_t i = bpp; i < len; ++i) {
        row[i] = static_cast<uint8_t>(row[i] + ((row[i - bpp] + prev[i]) >> 1));
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < bpp && i < len; ++i) row[i] = static_cast<uint8_t>(row[i] + prev[i]);
      for (size_t i = bpp; i < len; ++i) {
        const int a = row[i - bpp], b = prev[i], c = prev[i - bpp];
        const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        row[i] = static_cast<uint8_t>(row[i] + pred);
      }
      return true;
    default:
      return false;
  }
}

// One unfiltered row of `n` pixels to grey, written at dst[0], dst[step], ...
void RowToGray(const PngHeader& hd, const GammaPath& gp, const uint8_t* row, size_t n,
               const uint8_t* palette, uint8_t* dst, size_t step) {
  const int depth = hd.depth;
  switch (hd.color) {
    case 0:  // grey
      if (depth == 8) {
        for (size_t i = 0; i < n; ++i) dst[i * step] = row[i];
      } else if (depth == 16) {
        for (size_t i = 0; i < n; ++i) dst[i * step] = row[2 * i];
      } else {
        const int mask = (1 << depth) - 1;
        const int scale = 255 / mask;  // 1 -> 255, 2 -> 0x55, 4 -> 0x11
        for (size_t i = 0; i < n; ++i) {
          const size_t bit = i * depth;
          const int v = (row[bit >> 3] >> (8 - depth - static_cast<int>(bit & 7))) & mask;
          dst[i * step] = static_cast<uint8_t>(v * scale);
        }
      }
      return;
    case 4:  // grey + alpha
      for (size_t i = 0; i < n; ++i) dst[i * step] = row[i * (depth / 4)];
      return;
    case 2:
    case 6: {  // RGB, RGBA
      const size_t px = static_cast<size_t>(hd.channels) * (depth / 8);
      if (depth == 8) {
        for (size_t i = 0; i < n; ++i) {
          const uint8_t* s = row + i * px;
          dst[i * step] = gp.on ? gp.Luma8(s[0], s[1], s[2]) : Luma8(s[0], s[1], s[2]);
        }
      } else {
        for (size_t i = 0; i < n; ++i) {
          const uint8_t* s = row + i * px;
          const uint32_t r = (s[0] << 8) | s[1], g = (s[2] << 8) | s[3], b = (s[4] << 8) | s[5];
          dst[i * step] = gp.on ? gp.Luma16(r, g, b) : Luma16(r, g, b);
        }
      }
      return;
    }
    case 3: {  // palette
      const int mask = (1 << depth) - 1;
      for (size_t i = 0; i < n; ++i) {
        int idx;
        if (depth == 8) {
          idx = row[i];
        } else {
          const size_t bit = i * depth;
          idx = (row[bit >> 3] >> (8 - depth - static_cast<int>(bit & 7))) & mask;
        }
        const uint8_t* c = palette + 3 * idx;
        dst[i * step] = gp.on ? gp.Luma8(c[0], c[1], c[2]) : Luma8(c[0], c[1], c[2]);
      }
      return;
    }
  }
}

// Inflate the concatenated IDAT bodies into exactly `want` bytes.
bool InflateIdat(const uint8_t* data, const std::vector<std::pair<size_t, uint32_t>>& idat,
                 uint8_t* out, size_t want) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  size_t produced = 0;
  bool ok = true;
  for (const auto& span : idat) {
    zs.next_in = const_cast<Bytef*>(data + span.first);
    zs.avail_in = span.second;
    while (zs.avail_in > 0 && produced < want) {
      const size_t chunk = std::min<size_t>(want - produced, 1u << 30);
      zs.next_out = out + produced;
      zs.avail_out = static_cast<uInt>(chunk);
      const int rc = inflate(&zs, Z_NO_FLUSH);
      produced += chunk - zs.avail_out;
      if (rc == Z_STREAM_END) break;
      if (rc != Z_OK && rc != Z_BUF_ERROR) {
        ok = false;
        break;
      }
    }
    if (!ok || produced >= want) break;
  }
  inflateEnd(&zs);
  return ok && produced == want;
}

int DecodePngGray(const uint8_t* data, size_t size, uint8_t* out, int32_t cap_h,
                  int32_t cap_w, int32_t* h, int32_t* w, std::vector<uint8_t>* inflated) {
  if (size < 8 || std::memcmp(data, kPngSignature, 8) != 0) return kErrFormat;
  PngHeader hd;
  ColourChunks colour;
  bool have_header = false, have_palette = false, have_end = false;
  uint8_t palette[256 * 3] = {0};  // indices past the palette read black
  std::vector<std::pair<size_t, uint32_t>> idat;
  size_t pos = 8;
  while (pos + 12 <= size) {
    const uint32_t len = ReadBE32(data + pos);
    if (len > kPngMaxLength || size - pos - 12 < len) return kErrDecode;
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    const bool critical = (type[0] & 0x20) == 0;
    if (critical && ReadBE32(body + len) != crc32(crc32(0L, Z_NULL, 0), type, len + 4)) {
      return kErrDecode;
    }
    if (!have_header && std::memcmp(type, "IHDR", 4) != 0) return kErrDecode;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_header || len != 13) return kErrDecode;
      hd.width = ReadBE32(body);
      hd.height = ReadBE32(body + 4);
      hd.depth = body[8];
      hd.color = body[9];
      hd.interlace = body[12];
      hd.channels = hd.color == 2 ? 3 : hd.color == 4 ? 2 : hd.color == 6 ? 4 : 1;
      if (!ValidHeader(hd) || body[10] != 0 || body[11] != 0 || hd.interlace > 1) {
        return kErrDecode;
      }
      if (static_cast<int64_t>(hd.height) > cap_h || static_cast<int64_t>(hd.width) > cap_w) {
        return kErrTooLarge;
      }
      have_header = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len == 0 || len > 3 * 256) return kErrDecode;
      std::memcpy(palette, body, len);
      have_palette = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (hd.color == 3 && !have_palette) return kErrDecode;
      idat.emplace_back(pos + 8, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_end = true;
      break;
    } else if (std::memcmp(type, "gAMA", 4) == 0 || std::memcmp(type, "sRGB", 4) == 0 ||
               std::memcmp(type, "sBIT", 4) == 0) {
      // libpng drops these after PLTE or IDAT, or on a bad CRC.
      if (!have_palette && idat.empty() &&
          ReadBE32(body + len) == crc32(crc32(0L, Z_NULL, 0), type, len + 4)) {
        colour.Chunk(type, body, len, hd);
      }
    } else if (critical) {
      return kErrDecode;  // an unknown critical chunk cannot be skipped
    }
    pos += 12 + static_cast<size_t>(len);
  }
  if (!have_header || !have_end || idat.empty()) return kErrDecode;

  GammaPath gp;
  gp.Build(colour, hd);

  // The sub-images: the whole image, or Adam7's seven passes.
  const int passes = hd.interlace ? 7 : 1;
  size_t total = 0;
  size_t pass_w[7], pass_h[7];
  for (int p = 0; p < passes; ++p) {
    const int* a = kAdam7[p];
    pass_w[p] = hd.interlace ? (hd.width + a[2] - 1 - a[0]) / a[2] : hd.width;
    pass_h[p] = hd.interlace ? (hd.height + a[3] - 1 - a[1]) / a[3] : hd.height;
    if (hd.interlace && (hd.width <= static_cast<uint32_t>(a[0]) || hd.height <= static_cast<uint32_t>(a[1]))) {
      pass_w[p] = pass_h[p] = 0;  // an empty pass stores no rows
    }
    if (pass_w[p] && pass_h[p]) total += pass_h[p] * (RowBytes(hd, pass_w[p]) + 1);
  }
  inflated->resize(total + RowBytes(hd, hd.width));  // tail: a zero row
  if (!InflateIdat(data, idat, inflated->data(), total)) return kErrDecode;

  const size_t bpp = std::max<size_t>(1, static_cast<size_t>(hd.channels) * hd.depth / 8);
  uint8_t* zero_row = inflated->data() + total;
  std::memset(zero_row, 0, RowBytes(hd, hd.width));
  uint8_t* cursor = inflated->data();
  for (int p = 0; p < passes; ++p) {
    if (!pass_w[p] || !pass_h[p]) continue;
    const int* a = hd.interlace ? kAdam7[p] : kAdam7[6];  // Adam7 pass 7 has x step 1
    const size_t len = RowBytes(hd, pass_w[p]);
    const uint8_t* prev = zero_row;
    for (size_t y = 0; y < pass_h[p]; ++y) {
      uint8_t* row = cursor + 1;
      if (!UnfilterRow(cursor[0], row, prev, len, bpp)) return kErrDecode;
      const size_t oy = hd.interlace ? a[1] + y * a[3] : y;
      const size_t ox = hd.interlace ? a[0] : 0;
      const size_t step = hd.interlace ? a[2] : 1;
      RowToGray(hd, gp, row, pass_w[p], palette, out + oy * hd.width + ox, step);
      prev = row;
      cursor += len + 1;
    }
  }
  *h = static_cast<int32_t>(hd.height);
  *w = static_cast<int32_t>(hd.width);
  return kOk;
}

int DecodeGrayFromMemory(const uint8_t* data, size_t size, uint8_t* out, int32_t cap_h,
                         int32_t cap_w, int32_t* h, int32_t* w, std::vector<uint8_t>* inflated) {
  if (size >= 8 && std::memcmp(data, kPngSignature, 8) == 0) {
    return DecodePngGray(data, size, out, cap_h, cap_w, h, w, inflated);
  }
  if (size >= 2 && data[0] == 'P' && data[1] == '5') {
    return DecodePgmGray(data, size, out, cap_h, cap_w, h, w);
  }
  return kErrFormat;
}

int DecodeGrayFromFile(const char* path, uint8_t* out, int32_t cap_h, int32_t cap_w,
                       int32_t* h, int32_t* w, std::vector<uint8_t>* file_scratch,
                       std::vector<uint8_t>* inflated) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  std::fseek(f, 0, SEEK_END);
  const long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize <= 0) {
    std::fclose(f);
    return kErrOpen;
  }
  file_scratch->resize(static_cast<size_t>(fsize));
  const size_t got = std::fread(file_scratch->data(), 1, static_cast<size_t>(fsize), f);
  std::fclose(f);
  if (got != static_cast<size_t>(fsize)) return kErrOpen;
  return DecodeGrayFromMemory(file_scratch->data(), got, out, cap_h, cap_w, h, w, inflated);
}

// ---------------------------------------------------------------------------
// Frame loader: decode pool + in-order slot ring
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> pixels;  // cap_h * cap_w, allocated once
  int32_t h = 0;
  int32_t w = 0;
  int status = kOk;
  int64_t seq = -1;  // which frame occupies the slot (-1 = free)
};

class FrameLoader {
 public:
  FrameLoader(std::vector<std::string> paths, int workers, int capacity,
              int32_t cap_h, int32_t cap_w)
      : paths_(std::move(paths)),
        cap_h_(cap_h),
        cap_w_(cap_w),
        capacity_(capacity),
        slots_(capacity) {
    for (auto& s : slots_) s.pixels.resize(static_cast<size_t>(cap_h) * cap_w);
    const int n = std::max(1, workers);
    threads_.reserve(n);
    for (int i = 0; i < n; ++i) threads_.emplace_back([this] { WorkerLoop(); });
  }

  ~FrameLoader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stopping_ = true;
    }
    cv_slot_free_.notify_all();
    cv_slot_ready_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Blocks until frame `delivered_` is ready, copies it out, frees the slot.
  // Returns 1 when a frame was delivered, 0 at the end of the sequence.
  // `status` receives the decode result for this index (kOk or an error
  // code; on error h = w = 0).
  int Next(uint8_t* out, int32_t* index, int32_t* h, int32_t* w, int32_t* status) {
    std::unique_lock<std::mutex> lock(mu_);
    if (delivered_ >= static_cast<int64_t>(paths_.size())) return 0;
    const int64_t want = delivered_;
    Slot& slot = slots_[want % capacity_];
    const auto wait_start = std::chrono::steady_clock::now();
    cv_slot_ready_.wait(lock, [&] { return slot.seq == want || stopping_; });
    consumer_wait_ns_ += std::chrono::duration_cast<std::chrono::nanoseconds>(
                             std::chrono::steady_clock::now() - wait_start)
                             .count();
    if (stopping_ && slot.seq != want) return 0;
    *index = static_cast<int32_t>(want);
    *status = slot.status;
    *h = slot.h;
    *w = slot.w;
    if (slot.status == kOk) {
      std::memcpy(out, slot.pixels.data(), static_cast<size_t>(slot.h) * slot.w);
    }
    slot.seq = -1;
    ++delivered_;
    lock.unlock();
    cv_slot_free_.notify_all();
    return 1;
  }

  void Stats(int64_t* decoded, int64_t* failed, int64_t* consumer_wait_ns,
             int64_t* worker_wait_ns) const {
    std::lock_guard<std::mutex> lock(mu_);
    *decoded = decoded_;
    *failed = failed_;
    *consumer_wait_ns = consumer_wait_ns_;
    *worker_wait_ns = worker_wait_ns_;
  }

 private:
  void WorkerLoop() {
    std::vector<uint8_t> file_scratch;
    std::vector<uint8_t> inflated;
    std::vector<uint8_t> decode_scratch(static_cast<size_t>(cap_h_) * cap_w_);
    while (true) {
      const int64_t seq = next_task_.fetch_add(1, std::memory_order_relaxed);
      if (seq >= static_cast<int64_t>(paths_.size())) return;
      // Decode outside the lock into thread-local scratch; only the copy
      // into the delivery slot needs the slot.
      int32_t h = 0, w = 0;
      const int status = DecodeGrayFromFile(paths_[seq].c_str(), decode_scratch.data(), cap_h_,
                                            cap_w_, &h, &w, &file_scratch, &inflated);
      std::unique_lock<std::mutex> lock(mu_);
      Slot& slot = slots_[seq % capacity_];
      const auto wait_start = std::chrono::steady_clock::now();
      // Backpressure: wait until the consumer has freed this slot's ring
      // position (seq is within `capacity_` of the delivery cursor).
      cv_slot_free_.wait(lock, [&] {
        return stopping_ || (slot.seq == -1 && seq - delivered_ < capacity_);
      });
      worker_wait_ns_ += std::chrono::duration_cast<std::chrono::nanoseconds>(
                             std::chrono::steady_clock::now() - wait_start)
                             .count();
      if (stopping_) return;
      slot.status = status;
      if (status == kOk) {
        slot.h = h;
        slot.w = w;
        std::memcpy(slot.pixels.data(), decode_scratch.data(), static_cast<size_t>(h) * w);
        ++decoded_;
      } else {
        slot.h = 0;
        slot.w = 0;
        ++failed_;
      }
      slot.seq = seq;
      lock.unlock();
      cv_slot_ready_.notify_all();
    }
  }

  const std::vector<std::string> paths_;
  const int32_t cap_h_;
  const int32_t cap_w_;
  const int capacity_;

  mutable std::mutex mu_;
  std::condition_variable cv_slot_ready_;
  std::condition_variable cv_slot_free_;
  std::vector<Slot> slots_;
  std::vector<std::thread> threads_;
  std::atomic<int64_t> next_task_{0};
  int64_t delivered_ = 0;
  int64_t decoded_ = 0;
  int64_t failed_ = 0;
  int64_t consumer_wait_ns_ = 0;
  int64_t worker_wait_ns_ = 0;
  bool stopping_ = false;
};

}  // namespace

// The library is compiled with -fvisibility=hidden; only the C ABI below
// is exported.
#define MVN_EXPORT extern "C" __attribute__((visibility("default")))

MVN_EXPORT int32_t mvn_abi_version() { return 1; }

// Decode one image file to 8-bit grey. Returns 0 on success, a negative
// error code otherwise (-1 open, -2 unknown format, -3 larger than the
// cap_h x cap_w buffer, -4 corrupt).
MVN_EXPORT int32_t mvn_decode_gray(const char* path, uint8_t* out, int32_t cap_h,
                                   int32_t cap_w, int32_t* h, int32_t* w) {
  std::vector<uint8_t> file_scratch, inflated;
  return DecodeGrayFromFile(path, out, cap_h, cap_w, h, w, &file_scratch, &inflated);
}

// Decode from an in-memory buffer (e.g. mmap'd or read by the caller).
MVN_EXPORT int32_t mvn_decode_gray_buffer(const uint8_t* data, int64_t size, uint8_t* out,
                                          int32_t cap_h, int32_t cap_w, int32_t* h,
                                          int32_t* w) {
  std::vector<uint8_t> inflated;
  return DecodeGrayFromMemory(data, static_cast<size_t>(size), out, cap_h, cap_w, h, w,
                              &inflated);
}

MVN_EXPORT void* mvn_loader_create(const char** paths, int32_t n, int32_t workers,
                                   int32_t capacity, int32_t cap_h, int32_t cap_w) {
  if (n < 0 || capacity <= 0 || cap_h <= 0 || cap_w <= 0) return nullptr;
  std::vector<std::string> p;
  p.reserve(n);
  for (int32_t i = 0; i < n; ++i) p.emplace_back(paths[i]);
  return new FrameLoader(std::move(p), workers, capacity, cap_h, cap_w);
}

MVN_EXPORT int32_t mvn_loader_next(void* loader, uint8_t* out, int32_t* index, int32_t* h,
                                   int32_t* w, int32_t* status) {
  return static_cast<FrameLoader*>(loader)->Next(out, index, h, w, status);
}

MVN_EXPORT void mvn_loader_stats(void* loader, int64_t* decoded, int64_t* failed,
                                 int64_t* consumer_wait_ns, int64_t* worker_wait_ns) {
  static_cast<FrameLoader*>(loader)->Stats(decoded, failed, consumer_wait_ns, worker_wait_ns);
}

MVN_EXPORT void mvn_loader_destroy(void* loader) { delete static_cast<FrameLoader*>(loader); }

// ---------------------------------------------------------------------------
// Packed-Hamming brute-force matcher: the host matching path's hot op.
//
// Equal to ops/hamming.py::match_descriptors bit for bit (integer Hamming
// distances; argmin ties go to the lowest index; masked rows and columns
// behave like the 1e9 sentinel): the torch path computes d by an exact 0/1
// bf16 product, so both give the same float32 distances
// (tests/test_torch_native.py).
//
// The inner loop XORs 4 u64 lanes per pair and relies on -march=native
// auto-vectorisation (AVX-512 VPOPCNTQ where present; build.py falls back
// to a generic build if -march=native fails).
//
// Outputs per query row i: best_idx (first-min column), best / second
// distances (second excludes only the best COLUMN, so duplicate minima
// yield second == best). col_best[j] is the first-min ROW per train column
// (cross-check support). Invalid rows and all-invalid columns give index 0
// and distance 1e9, as argmin over an all-sentinel row does.
MVN_EXPORT void mvn_hamming_match(const uint32_t* desc_a, const uint8_t* valid_a, int32_t na,
                                  const uint32_t* desc_b, const uint8_t* valid_b, int32_t nb,
                                  int32_t* best_idx, float* best, float* second,
                                  int32_t* col_best) {
  constexpr float kBig = 1e9f;
  // Planar u64 transpose of desc_b: lane k of every row contiguous, so the
  // per-row distance loop vectorises across j.
  std::vector<uint64_t> plane(static_cast<size_t>(nb) * 4);
  uint64_t* p0 = plane.data();
  uint64_t* p1 = p0 + nb;
  uint64_t* p2 = p1 + nb;
  uint64_t* p3 = p2 + nb;
  for (int32_t j = 0; j < nb; ++j) {
    uint64_t row[4];
    std::memcpy(row, desc_b + static_cast<size_t>(j) * 8, 32);
    p0[j] = row[0];
    p1[j] = row[1];
    p2[j] = row[2];
    p3[j] = row[3];
  }
  std::vector<uint16_t> drow(nb);
  std::vector<float> col_val(nb, kBig);
  for (int32_t j = 0; j < nb; ++j) col_best[j] = 0;
  for (int32_t i = 0; i < na; ++i) {
    if (!valid_a[i]) {
      best_idx[i] = 0;
      best[i] = kBig;
      second[i] = kBig;
      continue;
    }
    uint64_t a[4];
    std::memcpy(a, desc_a + static_cast<size_t>(i) * 8, 32);
    const uint64_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
    uint16_t* d = drow.data();
    for (int32_t j = 0; j < nb; ++j) {
      d[j] = static_cast<uint16_t>(
          __builtin_popcountll(a0 ^ p0[j]) + __builtin_popcountll(a1 ^ p1[j]) +
          __builtin_popcountll(a2 ^ p2[j]) + __builtin_popcountll(a3 ^ p3[j]));
    }
    float bv = kBig, sv = kBig;
    int32_t bi = 0;
    for (int32_t j = 0; j < nb; ++j) {
      if (!valid_b[j]) continue;
      const float dj = static_cast<float>(d[j]);
      if (dj < bv) {
        sv = bv;
        bv = dj;
        bi = j;
      } else if (dj < sv) {
        sv = dj;
      }
      if (dj < col_val[j]) {
        col_val[j] = dj;
        col_best[j] = i;
      }
    }
    best_idx[i] = bi;
    best[i] = bv;
    second[i] = sv;
  }
}
