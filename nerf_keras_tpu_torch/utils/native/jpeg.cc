// The scans of a baseline or progressive Huffman JPEG, decoded as
// libjpeg-turbo decodes them with its defaults (host code, not a kernel):
// Huffman entropy decoding with restart markers into coefficient buffers
// (sequential blocks; jdphuff.c's DC and AC first and refinement passes
// with end-of-band runs), then dequantisation, the accurate integer IDCT
// (JDCT_ISLOW), fancy (triangle) chroma upsampling and the fixed-point
// YCbCr -> RGB tables.
//
// The marker segments (tables, frame and scan headers) are parsed in
// utils/jpeg.py, which calls jpeg_scan() once per scan with the entropy-
// coded data that follows its SOS header, then jpeg_finish() with each
// component's latched quantisation table in natural order.  Anything the
// stream does not support is reported through `err` with a nonzero return;
// the decoder never guesses.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLook = 9;  // bits of the Huffman lookahead table

struct Huffman {
  int32_t maxcode[18];  // the largest code of each length, -1 if none
  int32_t offset[18];   // value index minus the first code of each length
  uint8_t values[256];
  uint16_t look[1 << kLook];  // (length << 8) | value; 0: longer code
};

// Canonical codes from BITS/HUFFVAL (ITU T.81 Annex C); false if the counts
// overflow the code space.
bool build_huffman(const uint8_t* bits, const uint8_t* values, Huffman* h) {
  std::memcpy(h->values, values, 256);
  std::memset(h->look, 0, sizeof(h->look));
  int32_t code = 0;
  int p = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = bits[len];
    if (code + n > (1 << len)) return false;
    if (n) {
      h->offset[len] = p - code;
      for (int i = 0; i < n; ++i, ++p, ++code) {
        if (len <= kLook) {
          int shift = kLook - len;
          for (int fill = 0; fill < (1 << shift); ++fill)
            h->look[(code << shift) | fill] =
                static_cast<uint16_t>((len << 8) | values[p]);
        }
      }
      h->maxcode[len] = code - 1;
    } else {
      h->maxcode[len] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  return true;
}

// The entropy-coded segment as a bit stream: 0xFF00 stuffing removed, fill
// 0xFF bytes skipped, and zero bits supplied (and counted in `pad`) once a
// marker or the end of the data is reached, as libjpeg does; consuming any
// of those bits means the data was truncated.
struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  uint64_t buf = 0;
  int nbits = 0;
  int pad = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      if (!at_marker) {
        if (pos >= len) {
          at_marker = true;
          continue;
        }
        uint8_t c = data[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;
          if (q < len && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
            continue;
          }
        } else {
          ++pos;
        }
        buf = (buf << 8) | c;
      } else {
        buf <<= 8;
        pad += 8;
      }
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (nbits - n)) & ((1u << n) - 1);
  }
  bool skip(int n) {
    nbits -= n;
    return nbits >= pad;
  }
  bool bits(int n, int32_t* out) {
    if (n == 0) {
      *out = 0;
      return true;
    }
    *out = static_cast<int32_t>(peek(n));
    return skip(n);
  }
  // -1: no code of 16 bits or fewer matches; -2: truncated.
  int decode(const Huffman& h) {
    uint32_t e = h.look[peek(kLook)];
    if (e >> 8) return skip(e >> 8) ? static_cast<int>(e & 0xFF) : -2;
    uint32_t code16 = peek(16);
    for (int len = kLook + 1; len <= 16; ++len) {
      int32_t code = static_cast<int32_t>(code16 >> (16 - len));
      if (code <= h.maxcode[len])
        return skip(len) ? h.values[h.offset[len] + code] : -2;
    }
    return -1;
  }
  int real_bits() const { return nbits - pad; }
  void discard() {  // byte-align at a restart: drop the fill bits
    buf = 0;
    nbits = 0;
    pad = 0;
  }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline uint8_t clamp255(int32_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One 1-D pass of jidctint.c's jpeg_idct_islow (CONST_BITS 13) over
// in[0..7], in its JLONG arithmetic: the eight sums before the descale, in
// output order.
inline void idct_1d(const int64_t* in, int64_t* sums) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * F0_541;
  int64_t tmp2 = z1 + z3 * -F1_847;
  int64_t tmp3 = z1 + z2 * F0_765;
  int64_t tmp0 = (in[0] + in[4]) * (1 << 13);
  int64_t tmp1 = (in[0] - in[4]) * (1 << 13);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7];
  tmp1 = in[5];
  tmp2 = in[3];
  tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  const int64_t z5 = (z3 + z4) * F1_175;
  tmp0 *= F0_298;
  tmp1 *= F2_053;
  tmp2 *= F3_072;
  tmp3 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 = z3 * -F1_961 + z5;
  z4 = z4 * -F0_390 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  sums[0] = tmp10 + tmp3;
  sums[7] = tmp10 - tmp3;
  sums[1] = tmp11 + tmp2;
  sums[6] = tmp11 - tmp2;
  sums[2] = tmp12 + tmp1;
  sums[5] = tmp12 - tmp1;
  sums[3] = tmp13 + tmp0;
  sums[4] = tmp13 - tmp0;
}

// jpeg_idct_islow on a dequantised block: columns descaled by CONST_BITS -
// PASS1_BITS into an int workspace, rows by CONST_BITS + PASS1_BITS + 3,
// then + 128 and clamped to [0, 255] as libjpeg-turbo's SIMD version
// saturates (its C version wraps values beyond +-512, which valid data
// never reaches).
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  int64_t in[8], sums[8];
  for (int c = 0; c < 8; ++c) {
    for (int r = 0; r < 8; ++r)
      in[r] = static_cast<int32_t>(coef[r * 8 + c]) * static_cast<int32_t>(q[r * 8 + c]);
    idct_1d(in, sums);
    for (int r = 0; r < 8; ++r)
      ws[r * 8 + c] = static_cast<int32_t>((sums[r] + (1 << 10)) >> 11);
  }
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) in[c] = ws[r * 8 + c];
    idct_1d(in, sums);
    uint8_t* o = out + r * stride;
    for (int c = 0; c < 8; ++c)
      o[c] = clamp255(static_cast<int32_t>((sums[c] + (1 << 17)) >> 18) + 128);
  }
}

int fail(char* err, int err_len, const char* msg) {
  std::snprintf(err, err_len, "%s", msg);
  return 1;
}

// One component of a scan: its coefficient blocks (64 each, natural order,
// `stride` blocks a row), its blocks per MCU in an interleaved scan (its
// sampling factors), its own block grid (a scan of it alone covers that,
// not the MCU-padded one), its Huffman tables and its DC predictor.
struct ScanComp {
  int16_t* coef;
  int stride, h, v, bw, bh;
  const Huffman* dc;
  const Huffman* ac;
  int32_t pred;
};

// The state of one scan: the bit stream, the spectral band [ss, se], the
// successive approximation (ah, al) and the end-of-band run left.
struct Scan {
  BitReader br;
  bool progressive;
  int ss, se, ah, al;
  int32_t eobrun;
  const char* why;  // set when a block fails

  bool bad(const char* msg) {
    why = msg;
    return false;
  }
  bool huff(const Huffman& h, int* v, const char* code) {
    *v = br.decode(h);
    if (*v == -2) return bad("truncated data in the scan");
    if (*v < 0) return bad(code);
    return true;
  }
  bool get(int n, int32_t* v) { return br.bits(n, v) || bad("truncated data in the scan"); }

  // A sequential block: the DC difference and the run-length AC codes.
  bool sequential(ScanComp& c, int16_t* blk) {
    int s;
    int32_t v;
    if (!huff(*c.dc, &s, "corrupt data: bad DC Huffman code")) return false;
    if (s > 15) return bad("corrupt data: DC magnitude category > 15");
    if (!get(s, &v)) return false;
    c.pred += s ? extend(v, s) : 0;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs;
      if (!huff(*c.ac, &rs, "corrupt data: bad AC Huffman code")) return false;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) return bad("corrupt data: AC run past the block");
        if (!get(sz, &v)) return false;
        blk[kNatural[k]] = static_cast<int16_t>(extend(v, sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }

  // jdphuff.c's decode_mcu_DC_first: the difference, scaled by 2^al.
  bool dc_first(ScanComp& c, int16_t* blk) {
    int s;
    int32_t v;
    if (!huff(*c.dc, &s, "corrupt data: bad DC Huffman code")) return false;
    if (s > 15) return bad("corrupt data: DC magnitude category > 15");
    if (!get(s, &v)) return false;
    c.pred += s ? extend(v, s) : 0;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
    return true;
  }

  // decode_mcu_DC_refine: one more bit of the DC coefficient.
  bool dc_refine(int16_t* blk) {
    int32_t bit;
    if (!get(1, &bit)) return false;
    if (bit) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    return true;
  }

  // decode_mcu_AC_first: the band's first pass, with end-of-band runs
  // that span blocks.
  bool ac_first(ScanComp& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    for (int k = ss; k <= se; ++k) {
      int rs;
      int32_t v;
      if (!huff(*c.ac, &rs, "corrupt data: bad AC Huffman code")) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) return bad("corrupt data: AC run past the spectral band");
        if (!get(s, &v)) return false;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(v, s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) {
          if (!get(r, &v)) return false;
          eobrun += v;
        }
        --eobrun;
        break;
      }
    }
    return true;
  }

  // One correction bit of a coefficient already nonzero: its magnitude
  // grows by 2^al where the bit says so and that bit is not set yet.
  bool correct(int16_t* coef, int p1) {
    int32_t bit;
    if (!get(1, &bit)) return false;
    if (bit && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef - p1);
    return true;
  }

  // decode_mcu_AC_refine: new coefficients of magnitude 2^al placed after
  // a run of still-zero ones, correction bits for the nonzero ones passed
  // on the way and through an end-of-band run.
  bool ac_refine(ScanComp& c, int16_t* blk) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs;
        int32_t v;
        if (!huff(*c.ac, &rs, "corrupt data: bad AC Huffman code")) return false;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) return bad("corrupt data: a refined AC coefficient of size > 1");
          if (!get(1, &v)) return false;
          s = v ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) {
            if (!get(r, &v)) return false;
            eobrun += v;
          }
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (!correct(coef, p1)) return false;
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) return bad("corrupt data: AC run past the spectral band");
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && !correct(coef, p1)) return false;
      }
      --eobrun;
    }
    return true;
  }

  bool block(ScanComp& c, int16_t* blk) {
    if (!progressive) return sequential(c, blk);
    if (ss == 0) return ah == 0 ? dc_first(c, blk) : dc_refine(blk);
    return ah == 0 ? ac_first(c, blk) : ac_refine(c, blk);
  }
};

// One component's samples: the IDCT of each of its bw x bh blocks.
struct Plane {
  std::vector<uint8_t> px;
  int stride = 0;  // bytes a row (whole blocks)
  int w = 0, h = 0;  // libjpeg's downsampled_width/height
  int at(int y, int x) const { return px[static_cast<size_t>(y) * stride + x]; }
};

// One component upsampled to (height, width) as jdsample.c's fancy methods
// do: the triangle filter (3/4 nearer + 1/4 further sample, per axis) with
// the edge samples replicated; plain replication where libjpeg takes it.
std::vector<uint8_t> upsample(const Plane& p, int rh, int rv, int width, int height) {
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  const int ow = p.w * rh;  // output columns libjpeg computes, >= width
  std::vector<uint8_t> row(ow);
  for (int y = 0; y < height; ++y) {
    int iy = y / rv;
    if (rv == 1) {
      if (rh == 1 || p.w <= 2) {
        for (int x = 0; x < ow; ++x) row[x] = p.at(iy, x / rh);
      } else {  // h2v1_fancy_upsample
        const int last = p.w - 1;
        row[0] = p.at(iy, 0);
        row[1] = (p.at(iy, 0) * 3 + p.at(iy, 1) + 2) >> 2;
        for (int x = 1; x < last; ++x) {
          int v = p.at(iy, x) * 3;
          row[2 * x] = (v + p.at(iy, x - 1) + 1) >> 2;
          row[2 * x + 1] = (v + p.at(iy, x + 1) + 2) >> 2;
        }
        row[2 * last] = (p.at(iy, last) * 3 + p.at(iy, last - 1) + 1) >> 2;
        row[2 * last + 1] = p.at(iy, last);
      }
    } else {
      const bool below = y % 2;
      int oy = below ? iy + 1 : iy - 1;
      if (oy < 0) oy = 0;
      if (oy > p.h - 1) oy = p.h - 1;
      if (rh == 1) {  // h1v2_fancy_upsample
        const int bias = below ? 2 : 1;
        for (int x = 0; x < ow; ++x)
          row[x] = (p.at(iy, x) * 3 + p.at(oy, x) + bias) >> 2;
      } else if (p.w <= 2) {  // h2v2_upsample
        for (int x = 0; x < ow; ++x) row[x] = p.at(iy, x / 2);
      } else {  // h2v2_fancy_upsample
        auto colsum = [&](int x) { return p.at(iy, x) * 3 + p.at(oy, x); };
        const int last = p.w - 1;
        int thiscol = colsum(0), nextcol = colsum(1), lastcol;
        row[0] = (thiscol * 4 + 8) >> 4;
        row[1] = (thiscol * 3 + nextcol + 7) >> 4;
        lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < last; ++x) {
          nextcol = colsum(x + 1);
          row[2 * x] = (thiscol * 3 + lastcol + 8) >> 4;
          row[2 * x + 1] = (thiscol * 3 + nextcol + 7) >> 4;
          lastcol = thiscol;
          thiscol = nextcol;
        }
        row[2 * last] = (thiscol * 3 + lastcol + 8) >> 4;
        row[2 * last + 1] = (thiscol * 4 + 7) >> 4;
      }
    }
    std::memcpy(&out[static_cast<size_t>(y) * width], row.data(), width);
  }
  return out;
}

}  // namespace

extern "C" {

// Entropy-decode one scan into the frame's coefficient buffers.
//   scan, scan_len: the bytes after the SOS header, to the end of the file
//   ns: components in the scan; desc: per scan component (buffer stride in
//     blocks, h, v, blocks wide, blocks high, DC table, AC table)
//   coefs: per scan component, its coefficient buffer (zero before the
//     frame's first scan; each scan adds its band or its bits)
//   mcux, mcuy: the frame's MCU grid (an interleaved scan walks it)
//   progressive: 0 for a sequential scan (ss, se, ah, al = 0, 63, 0, 0)
//   huff_bits, huff_vals: 8 tables (DC 0-3, then AC 0-3) of 17 counts
//     (index 1..16) and 256 values; huff_present says which were defined
//   consumed: the offset in `scan` where the marker after the scan starts
// Returns 0, or 1 with a message in err.
int jpeg_scan(const uint8_t* scan, int64_t scan_len, int ns, const int32_t* desc,
              int16_t* const* coefs, int mcux, int mcuy, int progressive, int ss, int se,
              int ah, int al, const uint8_t* huff_bits, const uint8_t* huff_vals,
              const int32_t* huff_present, int restart_interval, int64_t* consumed,
              char* err, int err_len) {
  if (ns < 1 || ns > 4) return fail(err, err_len, "SOS: component count not 1-4");
  Huffman tables[8];
  for (int t = 0; t < 8; ++t) {
    if (huff_present[t] && !build_huffman(huff_bits + 17 * t, huff_vals + 256 * t, &tables[t]))
      return fail(err, err_len, "DHT: code counts overflow the code space");
  }
  ScanComp comps[4];
  for (int c = 0; c < ns; ++c) {
    const int32_t* d = desc + 7 * c;
    comps[c] = {coefs[c], d[0], d[1], d[2], d[3], d[4], &tables[d[5]], &tables[4 + d[6]], 0};
  }
  Scan s{BitReader{scan, scan_len}, progressive != 0, ss, se, ah, al, 0, nullptr};
  // A scan of one component is not interleaved: its MCU is one block, over
  // the component's own grid.
  const bool interleaved = ns > 1;
  const int64_t cols = interleaved ? mcux : comps[0].bw;
  const int64_t total = interleaved ? static_cast<int64_t>(mcux) * mcuy
                                    : static_cast<int64_t>(comps[0].bw) * comps[0].bh;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      BitReader& br = s.br;
      if (br.real_bits() >= 8)
        return fail(err, err_len, "extraneous data before a restart marker (RST)");
      br.discard();
      int64_t p = br.pos;
      if (p >= scan_len || scan[p] != 0xFF)
        return fail(err, err_len, "truncated data: a restart marker (RST) is missing");
      while (p < scan_len && scan[p] == 0xFF) ++p;
      if (p >= scan_len || scan[p] != 0xD0 + next_rst) {
        std::snprintf(err, err_len, "expected marker RST%d, found %s", next_rst,
                      p >= scan_len ? "the end of the data" : "another marker");
        return 1;
      }
      br.pos = p + 1;
      br.at_marker = false;
      next_rst = (next_rst + 1) & 7;
      for (int c = 0; c < ns; ++c) comps[c].pred = 0;
      s.eobrun = 0;
    }
    const int mx = static_cast<int>(m % cols), my = static_cast<int>(m / cols);
    for (int c = 0; c < ns; ++c) {
      ScanComp& sc = comps[c];
      const int bv = interleaved ? sc.v : 1, bh = interleaved ? sc.h : 1;
      for (int by = 0; by < bv; ++by) {
        for (int bx = 0; bx < bh; ++bx) {
          const int64_t row = static_cast<int64_t>(my) * bv + by, col = mx * bh + bx;
          if (!s.block(sc, sc.coef + (row * sc.stride + col) * 64))
            return fail(err, err_len, s.why);
        }
      }
    }
  }
  if (s.br.real_bits() >= 8) return fail(err, err_len, "extraneous data after the scan");
  *consumed = s.br.pos;
  return 0;
}

// The image from the frame's coefficients: dequantised by each component's
// latched table, the IDCT of every block of its own grid, upsampled and
// turned to RGB (one component: gray).
//   comps: per component (h, v, buffer stride in blocks, blocks wide,
//     blocks high)
//   quant: per component, its 64 quantisation values, natural order
//   out: height x width x (1 if ncomp == 1 else 3) bytes
int jpeg_finish(int width, int height, int ncomp, const int32_t* comps,
                const int32_t* quant, int16_t* const* coefs, uint8_t* out, char* err,
                int err_len) {
  if (ncomp != 1 && ncomp != 3) return fail(err, err_len, "component count not 1 or 3");
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    hmax = comps[5 * c] > hmax ? comps[5 * c] : hmax;
    vmax = comps[5 * c + 1] > vmax ? comps[5 * c + 1] : vmax;
  }
  Plane planes[3];
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* d = comps + 5 * c;
    int16_t q16[64];
    for (int i = 0; i < 64; ++i) q16[i] = static_cast<int16_t>(quant[64 * c + i]);
    Plane& p = planes[c];
    p.w = (width * d[0] + hmax - 1) / hmax;
    p.h = (height * d[1] + vmax - 1) / vmax;
    p.stride = d[3] * 8;
    p.px.assign(static_cast<size_t>(p.stride) * d[4] * 8, 0);
    for (int by = 0; by < d[4]; ++by)
      for (int bx = 0; bx < d[3]; ++bx)
        idct_islow(coefs[c] + (static_cast<int64_t>(by) * d[2] + bx) * 64, q16,
                   &p.px[static_cast<size_t>(by) * 8 * p.stride + bx * 8], p.stride);
  }
  if (ncomp == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(out + static_cast<size_t>(y) * width,
                  &planes[0].px[static_cast<size_t>(y) * planes[0].stride], width);
    return 0;
  }
  std::vector<uint8_t> full[3];
  for (int c = 0; c < 3; ++c) {
    const int rh = hmax / comps[5 * c], rv = vmax / comps[5 * c + 1];
    if (rh * comps[5 * c] != hmax || rv * comps[5 * c + 1] != vmax || rh > 2 || rv > 2)
      return fail(err, err_len, "SOF: sampling factors other than 4:4:4, 4:2:2, 4:2:0, 4:4:0");
    full[c] = upsample(planes[c], rh, rv, width, height);
  }
  // jdcolor.c's ycc_rgb_convert: SCALEBITS 16, tables rounded as libjpeg.
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  const int32_t one_half = 1 << 15;
  for (int i = 0; i < 256; ++i) {
    int32_t x = i - 128;
    cr_r[i] = static_cast<int>((91881 * x + one_half) >> 16);
    cb_b[i] = static_cast<int>((116130 * x + one_half) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + one_half;
  }
  const size_t n = static_cast<size_t>(width) * height;
  for (size_t i = 0; i < n; ++i) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[3 * i] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + cb_b[cb]);
  }
  return 0;
}

}  // extern "C"
