// The image data of a PNG after zlib (host code, not a kernel): undo the
// five row filters, split the Adam7 passes and unpack the samples, as
// libpng and PIL's ZipDecode read them.
//
// utils/png.py walks the chunks, checks them and inflates the IDAT stream;
// png_unfilter() takes the inflated bytes and writes every sample of the
// image, unscaled: one byte per sample at bit depths 1, 2, 4 and 8 (a 1-,
// 2- or 4-bit sample in the low bits), one native uint16 per sample at 16
// (the big-endian pair combined).  What PIL's modes make of the samples
// (the gray scaling, a palette lookup, the high byte of a 16-bit colour) is
// numpy in utils/png.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Adam7's passes: first column, first row, column step, row step.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo filter `f` of one scanline in place: `cur` holds the filtered
// bytes, `prev` the previous unfiltered line (zeros above the first).
bool unfilter_row(int f, uint8_t* cur, const uint8_t* prev, int64_t stride, int bpp) {
  switch (f) {
    case 0:
      return true;
    case 1:  // Sub
      for (int64_t i = bpp; i < stride; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
      return true;
    case 2:  // Up
      for (int64_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
      return true;
    case 3:  // Average
      for (int64_t i = 0; i < bpp && i < stride; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + (prev[i] >> 1));
      for (int64_t i = bpp; i < stride; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
      return true;
    case 4:  // Paeth
      for (int64_t i = 0; i < bpp && i < stride; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
      for (int64_t i = bpp; i < stride; ++i)
        cur[i] = static_cast<uint8_t>(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
      return true;
    default:
      return false;
  }
}

// Write the `n` pixels of one unfiltered line to out at pixel offsets
// base, base + step, ...  (samples of `channels` each).
void unpack_row(const uint8_t* line, int64_t n, int depth, int channels, void* out,
                int64_t base, int64_t step) {
  if (depth == 16) {
    uint16_t* o = static_cast<uint16_t*>(out);
    for (int64_t i = 0; i < n; ++i) {
      uint16_t* px = o + (base + i * step) * channels;
      const uint8_t* s = line + 2 * i * channels;
      for (int c = 0; c < channels; ++c)
        px[c] = static_cast<uint16_t>((s[2 * c] << 8) | s[2 * c + 1]);
    }
    return;
  }
  uint8_t* o = static_cast<uint8_t*>(out);
  if (depth == 8) {
    if (step == 1) {
      std::memcpy(o + base * channels, line, static_cast<size_t>(n) * channels);
      return;
    }
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(o + (base + i * step) * channels, line + i * channels, channels);
    return;
  }
  // 1, 2 or 4 bits, one channel: packed from the high bit of each byte.
  const int per = 8 / depth, mask = (1 << depth) - 1;
  for (int64_t i = 0; i < n; ++i) {
    const int shift = 8 - depth * (1 + static_cast<int>(i % per));
    o[base + i * step] = static_cast<uint8_t>((line[i / per] >> shift) & mask);
  }
}

}  // namespace

extern "C" {

// Decode the inflated image data of a PNG.
//   data, len: the zlib-inflated IDAT stream (bytes past the image's are
//     ignored, as PIL ignores them)
//   depth: 1, 2, 4, 8 or 16; channels: 1 to 4 (1 below 8 bits)
//   interlace: 0, or Adam7
//   out: height x width x channels samples, uint8 (uint16 at depth 16)
// Returns 0, or 1 with a message in err (a filter byte other than 0-4, or
// data that ends before the image does).
int png_unfilter(const uint8_t* data, int64_t len, int width, int height, int depth,
                 int channels, int interlace, void* out, char* err, int err_len) {
  const int bits = depth * channels;
  const int bpp = bits < 8 ? 1 : bits / 8;
  const int passes = interlace ? 7 : 1;
  std::vector<uint8_t> prev, cur;
  int64_t pos = 0;
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    if (width <= x0 || height <= y0) continue;  // an empty pass: no bytes at all
    const int64_t pw = (width - x0 + dx - 1) / dx, ph = (height - y0 + dy - 1) / dy;
    const int64_t stride = (pw * bits + 7) / 8;
    prev.assign(stride, 0);
    cur.resize(stride);
    for (int64_t r = 0; r < ph; ++r) {
      if (pos + 1 + stride > len) {
        std::snprintf(err, err_len,
                      "truncated image data: %lld bytes inflated, the image needs more "
                      "(pass %d, row %lld)", static_cast<long long>(len), p + 1,
                      static_cast<long long>(r));
        return 1;
      }
      const int f = data[pos];
      std::memcpy(cur.data(), data + pos + 1, stride);
      pos += 1 + stride;
      if (!unfilter_row(f, cur.data(), prev.data(), stride, bpp)) {
        std::snprintf(err, err_len, "unknown filter type %d (pass %d, row %lld)", f, p + 1,
                      static_cast<long long>(r));
        return 1;
      }
      const int64_t y = y0 + r * dy;
      unpack_row(cur.data(), pw, depth, channels, out, y * width + x0, dx);
      prev.swap(cur);
    }
  }
  return 0;
}

}  // extern "C"
