// The per-pixel work of the port's GIF writer and reader (host code, not a
// kernel): a frame's palette (its own colours where it has at most 256, else
// 256 by median cut with no dithering), the nearest-entry mapping, and LZW
// in both directions with the sub-block framing of a GIF image.
//
// utils/gif.py builds the blocks around these: the screen, the colour
// tables, the loop and control extensions, and how a reader composites the
// frames.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCodes = 4096;  // 12-bit LZW codes

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
}

inline uint32_t pixel_key(const uint8_t* px, int channels) {
  if (channels == 1) return px[0] * 0x010101u;
  return (static_cast<uint32_t>(px[0]) << 16) | (static_cast<uint32_t>(px[1]) << 8) | px[2];
}

inline int channel(uint32_t key, int c) { return (key >> (16 - 8 * c)) & 0xff; }

struct Color {
  uint32_t key;
  uint32_t count;
};

// The distinct colours of the frame with their pixel counts, and each
// pixel's colour id (an open-addressing table keyed by the 24-bit colour).
std::vector<Color> histogram(const uint8_t* px, int64_t n, int channels,
                             std::vector<uint32_t>& pixel_id) {
  int64_t cap = 1024;
  while (cap < 2 * std::min<int64_t>(n, int64_t{1} << 24)) cap <<= 1;
  const uint64_t mask = static_cast<uint64_t>(cap - 1);
  std::vector<uint32_t> slot_key(static_cast<size_t>(cap), 0);  // key + 1; 0 is empty
  std::vector<uint32_t> slot_id(static_cast<size_t>(cap));
  std::vector<Color> colors;
  pixel_id.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t key = pixel_key(px + i * channels, channels);
    uint64_t h = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) >> 32;
    for (;; h = (h + 1) & mask) {
      uint32_t& k = slot_key[h & mask];
      if (k == key + 1) {
        const uint32_t id = slot_id[h & mask];
        colors[id].count++;
        pixel_id[static_cast<size_t>(i)] = id;
        break;
      }
      if (k == 0) {
        k = key + 1;
        const uint32_t id = static_cast<uint32_t>(colors.size());
        slot_id[h & mask] = id;
        colors.push_back({key, 1});
        pixel_id[static_cast<size_t>(i)] = id;
        break;
      }
    }
  }
  return colors;
}

struct Box {
  int64_t lo, hi;  // a range of `order`
  uint64_t count;
  double sse;      // the count-weighted squared distance to the box's mean
  int lo_c[3], hi_c[3];
};

void measure(Box& b, const std::vector<uint32_t>& order, const std::vector<Color>& colors) {
  double sum[3] = {0, 0, 0}, sq = 0;
  b.count = 0;
  for (int c = 0; c < 3; ++c) b.lo_c[c] = 255, b.hi_c[c] = 0;
  for (int64_t i = b.lo; i < b.hi; ++i) {
    const Color& col = colors[order[static_cast<size_t>(i)]];
    b.count += col.count;
    for (int c = 0; c < 3; ++c) {
      const int v = channel(col.key, c);
      b.lo_c[c] = std::min(b.lo_c[c], v);
      b.hi_c[c] = std::max(b.hi_c[c], v);
      sum[c] += static_cast<double>(v) * col.count;
      sq += static_cast<double>(v) * v * col.count;
    }
  }
  b.sse = sq - (sum[0] * sum[0] + sum[1] * sum[1] + sum[2] * sum[2]) / static_cast<double>(b.count);
}

// Median cut: split the box of largest squared error along its widest
// channel at the median pixel's value, until there are `k` boxes; each
// entry is its box's mean, rounded.
std::vector<uint32_t> median_cut(const std::vector<Color>& colors, int k) {
  std::vector<uint32_t> order(colors.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<uint32_t>(i);
  std::vector<Box> boxes(1);
  boxes[0].lo = 0;
  boxes[0].hi = static_cast<int64_t>(order.size());
  measure(boxes[0], order, colors);
  while (static_cast<int>(boxes.size()) < k) {
    int pick = -1;
    for (int b = 0; b < static_cast<int>(boxes.size()); ++b)
      if (boxes[b].hi - boxes[b].lo > 1 && (pick < 0 || boxes[b].sse > boxes[pick].sse)) pick = b;
    if (pick < 0) break;
    Box box = boxes[pick];
    int axis = 0;
    for (int c = 1; c < 3; ++c)
      if (box.hi_c[c] - box.lo_c[c] > box.hi_c[axis] - box.lo_c[axis]) axis = c;
    // The weighted median along the axis, from a count per value; split
    // between values, so both sides keep at least one colour.
    uint64_t per_value[256] = {};
    for (int64_t i = box.lo; i < box.hi; ++i) {
      const Color& col = colors[order[static_cast<size_t>(i)]];
      per_value[channel(col.key, axis)] += col.count;
    }
    uint64_t acc = 0;
    int cut = box.lo_c[axis];
    for (; cut < box.hi_c[axis] - 1; ++cut) {
      acc += per_value[cut];
      if (2 * acc >= box.count) break;
    }
    const int64_t split = std::stable_partition(order.begin() + box.lo, order.begin() + box.hi,
                                                [&](uint32_t id) {
                                                  return channel(colors[id].key, axis) <= cut;
                                                }) - order.begin();
    Box left = box, right = box;
    left.hi = split;
    right.lo = split;
    measure(left, order, colors);
    measure(right, order, colors);
    boxes[pick] = left;
    boxes.push_back(right);
  }
  std::vector<uint32_t> entries;
  for (const Box& b : boxes) {
    uint64_t sum[3] = {0, 0, 0};
    for (int64_t i = b.lo; i < b.hi; ++i) {
      const Color& col = colors[order[static_cast<size_t>(i)]];
      for (int c = 0; c < 3; ++c) sum[c] += static_cast<uint64_t>(channel(col.key, c)) * col.count;
    }
    uint32_t key = 0;
    for (int c = 0; c < 3; ++c)
      key = (key << 8) | static_cast<uint32_t>((2 * sum[c] + b.count) / (2 * b.count));
    entries.push_back(key);
  }
  return entries;
}

// The nearest entry of a palette sorted by key, descending (so by red,
// descending): scan outward from the colour's red while the red distance
// alone can still beat the best; ties go to the lower index.
struct Nearest {
  std::vector<int> r, g, b;
  explicit Nearest(const std::vector<uint32_t>& pal) {
    for (uint32_t key : pal) {
      r.push_back(channel(key, 0));
      g.push_back(channel(key, 1));
      b.push_back(channel(key, 2));
    }
  }
  int operator()(uint32_t key) const {
    const int cr = channel(key, 0), cg = channel(key, 1), cb = channel(key, 2);
    const int m = static_cast<int>(r.size());
    int lo = 0, hi = m;  // first index whose red is <= cr
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (r[mid] > cr) lo = mid + 1; else hi = mid;
    }
    int best = -1, bd = 0;
    auto visit = [&](int i) {
      const int dr = r[i] - cr, dg = g[i] - cg, db = b[i] - cb;
      const int d = dr * dr + dg * dg + db * db;
      if (best < 0 || d < bd || (d == bd && i < best)) best = i, bd = d;
    };
    for (int i = lo; i < m; ++i) {  // red <= cr, falling away
      if (best >= 0 && (cr - r[i]) * (cr - r[i]) > bd) break;
      visit(i);
    }
    for (int i = lo - 1; i >= 0; --i) {  // red > cr, rising away
      if (best >= 0 && (r[i] - cr) * (r[i] - cr) > bd) break;
      visit(i);
    }
    return best;
  }
};

// LSB-first codes packed into sub-blocks of up to 255 bytes.
struct BlockWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint8_t block[255];
  int fill = 0;
  uint32_t bits = 0;
  int nbits = 0;
  bool overflow = false;
  BlockWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}
  void flush_block() {
    if (fill == 0) return;
    if (pos + 1 + fill > cap) {
      overflow = true;
      fill = 0;
      return;
    }
    out[pos++] = static_cast<uint8_t>(fill);
    std::memcpy(out + pos, block, static_cast<size_t>(fill));
    pos += fill;
    fill = 0;
  }
  void byte(uint8_t v) {
    block[fill++] = v;
    if (fill == 255) flush_block();
  }
  void code(int c, int width) {
    bits |= static_cast<uint32_t>(c) << nbits;
    nbits += width;
    while (nbits >= 8) {
      byte(static_cast<uint8_t>(bits & 0xff));
      bits >>= 8;
      nbits -= 8;
    }
  }
  void finish() {
    if (nbits > 0) byte(static_cast<uint8_t>(bits & 0xff));
    flush_block();
    if (pos + 1 > cap) overflow = true; else out[pos++] = 0;  // the block terminator
  }
};

}  // namespace

extern "C" {

// The frame's palette and each pixel's entry.  `px` holds `n` pixels of
// `channels` (1: gray, 3: RGB) bytes; `palette` gets up to 256 RGB
// entries, sorted by colour descending, `index` one byte a pixel.
// Returns the number of entries.
int gif_quantize(const uint8_t* px, int64_t n, int channels, uint8_t* palette, uint8_t* index) {
  std::vector<uint32_t> pixel_id;
  const std::vector<Color> colors = histogram(px, n, channels, pixel_id);
  std::vector<uint32_t> entries;
  if (colors.size() <= 256) {
    for (const Color& c : colors) entries.push_back(c.key);
  } else {
    entries = median_cut(colors, 256);
  }
  std::sort(entries.begin(), entries.end(), std::greater<uint32_t>());
  std::vector<uint8_t> lut(colors.size());
  if (colors.size() <= 256) {
    for (size_t i = 0; i < colors.size(); ++i)
      lut[i] = static_cast<uint8_t>(std::find(entries.begin(), entries.end(), colors[i].key) -
                                    entries.begin());
  } else {
    const Nearest nearest(entries);
    for (size_t i = 0; i < colors.size(); ++i) lut[i] = static_cast<uint8_t>(nearest(colors[i].key));
  }
  for (size_t e = 0; e < entries.size(); ++e)
    for (int c = 0; c < 3; ++c) palette[3 * e + c] = static_cast<uint8_t>(channel(entries[e], c));
  for (int64_t i = 0; i < n; ++i) index[i] = lut[pixel_id[static_cast<size_t>(i)]];
  return static_cast<int>(entries.size());
}

// LZW-compress `n` indices of `min_code_size` bits (2..8) into GIF
// sub-blocks ending with the zero-length terminator: 9- to 12-bit codes,
// a clear code first and whenever the table is full, the end code last.
// Returns the bytes written, or -1 when `cap` is too small.
int64_t gif_lzw_encode(const uint8_t* idx, int64_t n, int min_code_size, uint8_t* out,
                       int64_t cap) {
  const int clear = 1 << min_code_size, eoi = clear + 1;
  constexpr int kSlots = 1 << 13;  // twice the codes: probes stay short
  std::vector<uint32_t> slot_key(kSlots);  // (prefix << 8 | byte) + 1; 0 is empty
  std::vector<uint16_t> slot_code(kSlots);
  BlockWriter w(out, cap);
  int width = min_code_size + 1, next = eoi + 1;
  w.code(clear, width);
  int prefix = idx[0];
  for (int64_t i = 1; i < n; ++i) {
    const uint32_t key = (static_cast<uint32_t>(prefix) << 8 | idx[i]) + 1;
    uint32_t h = (key * 2654435761u) >> 19;
    bool found = false;
    for (;; h = (h + 1) & (kSlots - 1)) {
      if (slot_key[h] == key) {
        prefix = slot_code[h];
        found = true;
        break;
      }
      if (slot_key[h] == 0) break;
    }
    if (found) continue;
    w.code(prefix, width);
    slot_key[h] = key;
    slot_code[h] = static_cast<uint16_t>(next++);
    if (next == kMaxCodes) {
      w.code(clear, width);
      std::fill(slot_key.begin(), slot_key.end(), 0);
      width = min_code_size + 1;
      next = eoi + 1;
    } else if (next > (1 << width)) {
      ++width;
    }
    prefix = idx[i];
  }
  w.code(prefix, width);
  w.code(eoi, width);
  w.finish();
  return w.overflow ? -1 : w.pos;
}

// Decode the LZW sub-blocks that start at data[pos] into `width * height`
// indices (rows in interlaced order put back in place when `interlace`).
// `*end` gets the offset just past the block terminator.  Returns 0, or 1
// with a message in `err`: a sub-block or the stream cut short, a code past
// the table, the end code before the last pixel.
int gif_lzw_decode(const uint8_t* data, int64_t len, int64_t pos, int min_code_size,
                   int width, int height, int interlace, uint8_t* out, int64_t* end,
                   char* err, int errlen) {
  const int64_t total = static_cast<int64_t>(width) * height;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(kMaxCodes);
  std::vector<uint8_t> suffix(kMaxCodes), first(kMaxCodes);
  std::vector<uint16_t> length(kMaxCodes);
  for (int c = 0; c < clear; ++c) {
    suffix[c] = first[c] = static_cast<uint8_t>(c);
    length[c] = 1;
  }
  std::vector<uint8_t> linear(interlace ? static_cast<size_t>(total) : 0);
  uint8_t* dst = interlace ? linear.data() : out;
  int code_width = min_code_size + 1, next = eoi + 1, prev = -1;
  int64_t written = 0;
  uint32_t bits = 0;
  int nbits = 0;
  int block_left = 0;
  bool stream_done = false;  // the terminator was read
  while (written < total) {
    while (nbits < code_width) {
      if (block_left == 0) {
        if (stream_done || pos >= len) {
          set_error(err, errlen, "the image data ends before its last pixel (truncated)");
          return 1;
        }
        block_left = data[pos++];
        if (block_left == 0) {
          stream_done = true;
          continue;
        }
      }
      if (pos >= len) {
        set_error(err, errlen, "a sub-block runs past the end of the file (truncated)");
        return 1;
      }
      bits |= static_cast<uint32_t>(data[pos++]) << nbits;
      nbits += 8;
      --block_left;
    }
    const int code = static_cast<int>(bits & ((1u << code_width) - 1));
    bits >>= code_width;
    nbits -= code_width;
    if (code == clear) {
      code_width = min_code_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) {
      set_error(err, errlen, "the end code comes before the image's last pixel");
      return 1;
    }
    int emit = code;
    if (code > eoi && code >= next) {
      if (code != next || prev < 0) {
        char msg[96];
        std::snprintf(msg, sizeof msg, "LZW code %d is past the table (%d entries)", code, next);
        set_error(err, errlen, msg);
        return 1;
      }
    }
    if (prev >= 0 && next < kMaxCodes) {
      // code == next (KwKwK) takes prev's own first byte
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = code == next ? first[prev] : first[code];
      first[next] = first[prev];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
      if (next == (1 << code_width) && code_width < 12) ++code_width;
    }
    int64_t n = length[emit];
    for (int64_t i = n - 1, c = emit; i >= 0; --i, c = prefix[c])
      if (written + i < total) dst[written + i] = suffix[c];
    written += n;
    prev = code;
  }
  // Skip what is left of the stream: the rest of the codes and the blocks.
  while (!stream_done) {
    pos += block_left;
    if (pos >= len) {
      set_error(err, errlen, "the image data has no block terminator (truncated)");
      return 1;
    }
    block_left = data[pos++];
    if (block_left == 0) stream_done = true;
  }
  *end = pos;
  if (interlace) {
    static const int kPasses[4][2] = {{0, 8}, {4, 8}, {2, 4}, {1, 2}};
    int64_t row = 0;
    for (const auto& p : kPasses)
      for (int y = p[0]; y < height; y += p[1], ++row)
        std::memcpy(out + static_cast<int64_t>(y) * width, linear.data() + row * width,
                    static_cast<size_t>(width));
  }
  return 0;
}

}  // extern "C"
