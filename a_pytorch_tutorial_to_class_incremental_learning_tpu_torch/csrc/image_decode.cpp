// Host image decoding for the image-folder dataset (``--data_set imagenet1000``).
//
// Files decode to the bytes that Pillow (on libjpeg-turbo, libjpeg API 6.2)
// gives for ``np.asarray(Image.open(path).convert("RGB"))``, and the crop-
// resize is Pillow's BICUBIC ``resize(size, box=...)`` in its own fixed-point
// arithmetic, so the pixels of the JAX package's PIL pipeline come out byte
// for byte without PIL.
//
// JPEG: baseline/extended and progressive Huffman, 8-bit; 1, 3 (YCbCr or
//   RGB) or 4 (Adobe CMYK/YCCK) components; sampling factors 1-4 with
//   integral ratios; restart intervals.  libjpeg's decompression defaults:
//   the integer "islow" IDCT (the SIMD clamp: saturate to 0..255), fancy
//   upsampling (triangle filter, alternating rounding bias) where libjpeg
//   uses it and box replication elsewhere, and jdcolor.c's fixed-point
//   YCbCr->RGB tables.  CMYK goes through Pillow's "CMYK;I" unpack and its
//   cmyk2rgb conversion.
// PNG: bit depth 8 (gray, gray+alpha, RGB, RGBA, palette) and 1/2/4 (gray,
//   palette), not interlaced, through a small inflate of its own; alpha is
//   dropped as convert("RGB") drops it.
// Anything else fails with a status and a message naming the feature:
//   arithmetic-coded, 12-bit, lossless or hierarchical JPEG, progressive
//   JPEG whose scans leave low AC coefficients unrefined (libjpeg would
//   smooth the blocks), interlaced or 16-bit PNG, other formats, and data
//   that ends early or is corrupt.  No pixel is ever made up.
//
// The C entry points take paths and write into caller-owned buffers; batch
// entry points spread the images over a pool of threads.  Bound with ctypes
// (``utils/image_native.py``), which releases the GIL for the call.
//
// Build: g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared -pthread.  The
// resampler's coefficients are doubles: contracting them into FMA would move
// a rounded coefficient, so the flags forbid it and name no -march.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status : int32_t {
  kOk = 0,
  kIoError = 1,
  kUnsupported = 2,
  kCorrupt = 3,
  kNotImage = 4,
  kBadArgument = 5,
};

struct DecodeError {
  int32_t status;
  std::string msg;
};

[[noreturn]] void fail(int32_t status, const std::string& msg) { throw DecodeError{status, msg}; }

std::vector<uint8_t> read_file(const char* path, size_t limit) {
  FILE* f = std::fopen(path, "rb");
  if (!f) fail(kIoError, std::string("cannot open: ") + std::strerror(errno));
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  while (data.size() < limit) {
    size_t want = std::min(sizeof(chunk), limit - data.size());
    size_t got = std::fread(chunk, 1, want, f);
    data.insert(data.end(), chunk, chunk + got);
    if (got < want) break;
  }
  bool err = std::ferror(f) != 0;
  std::fclose(f);
  if (err) fail(kIoError, "read error");
  return data;
}

constexpr int64_t kMaxPixels = int64_t(1) << 28;

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
};

// ---------------------------------------------------------------- JPEG ---

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.look_len, 0, sizeof(h.look_len));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; l++) {
    h.valoffset[l] = p - code;
    if (counts[l - 1] == 0) {
      h.maxcode[l] = -1;
    } else {
      for (int i = 0; i < counts[l - 1]; i++, p++, code++) {
        if (l <= kLookBits) {
          int lo = code << (kLookBits - l), n = 1 << (kLookBits - l);
          for (int j = 0; j < n; j++) {
            h.look_len[lo + j] = uint8_t(l);
            h.look_val[lo + j] = vals[p];
          }
        }
      }
      h.maxcode[l] = code - 1;
    }
    if (code > (1 << l)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7FFFFFFF;
  h.defined = true;
}

// Entropy-coded data: 0xFF 0x00 is a data 0xFF; a marker ends the segment,
// after which zero bits are supplied (as libjpeg does) and counted, so a
// segment that needs bits past its end is reported as corrupt.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t size = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;
  int64_t fake_bits = 0;

  void start(const uint8_t* d, size_t n, size_t p) {
    data = d;
    size = n;
    pos = p;
    buf = 0;
    bits = 0;
    at_marker = false;
    fake_bits = 0;
  }
  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= size) fail(kCorrupt, "truncated file: entropy-coded data runs past the end");
        b = data[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) q++;
          if (q >= size) fail(kCorrupt, "truncated file: entropy-coded data runs past the end");
          if (data[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;  // the 0xFF that starts the marker
            b = 0;
            fake_bits += 8;
          }
        } else {
          pos++;
        }
      } else {
        fake_bits += 8;
      }
      buf |= uint64_t(b) << (56 - bits);
      bits += 8;
    }
  }
  uint32_t get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (bits < n) fill();
    uint32_t v = uint32_t(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  int get_bit() { return int(get(1)); }
  int extend(int s) {  // receive and extend an s-bit magnitude
    if (s == 0) return 0;
    int v = int(get(s));
    if (v < (1 << (s - 1))) v += 1 - (1 << s);
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int look = int(buf >> (64 - kLookBits));
    int l = h.look_len[look];
    if (l) {
      buf <<= l;
      bits -= l;
      return h.look_val[look];
    }
    for (l = kLookBits + 1; l <= 16; l++) {
      int32_t code = int32_t(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        bits -= l;
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
  }
  // Consumed past the end of the segment?
  void check_overrun() const {
    if (fake_bits > bits) fail(kCorrupt, "corrupt JPEG data: premature end of an entropy-coded segment");
  }
  // Position of the next marker (0xFF not followed by 0x00 or 0xFF).
  size_t next_marker() const {
    size_t q = pos;
    while (q + 1 < size) {
      if (data[q] == 0xFF && data[q + 1] != 0 && data[q + 1] != 0xFF) return q;
      q++;
    }
    fail(kCorrupt, "truncated file: no marker after entropy-coded data");
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;    // blocks that cover the component's samples
  int bwp = 0, bhp = 0;  // blocks padded to whole MCUs
  int dw = 0, dh = 0;    // downsampled_width / downsampled_height
  int dc_pred = 0;
  bool latched = false;
  uint16_t q[64];
  int coef_bits[64];
  std::vector<int16_t> coef;  // bhp * bwp * 64, natural order
};

struct Jpeg {
  const std::vector<uint8_t>& d;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, have_frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  BitReader br;
  int eobrun = 0;

  explicit Jpeg(const std::vector<uint8_t>& data) : d(data) {}

  int u16(size_t p) const {
    if (p + 2 > d.size()) fail(kCorrupt, "truncated file: marker segment runs past the end");
    return (d[p] << 8) | d[p + 1];
  }

  void frame(size_t p, int len, int marker) {
    if (have_frame) fail(kUnsupported, "JPEG with more than one frame");
    if (len < 8) fail(kCorrupt, "bad SOF length");
    int precision = d[p];
    if (precision != 8) fail(kUnsupported, std::to_string(precision) + "-bit JPEG (only 8-bit samples are read)");
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (height == 0) fail(kUnsupported, "JPEG with its height in a DNL marker");
    if (width == 0) fail(kCorrupt, "JPEG with zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(kUnsupported, "JPEG with " + std::to_string(ncomp) + " components");
    if (len != 8 + 3 * ncomp) fail(kCorrupt, "bad SOF length");
    if (int64_t(width) * height > kMaxPixels) fail(kUnsupported, "image larger than 2^28 pixels");
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt, "bad JPEG component parameters");
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.bw = int((int64_t(width) * c.h + 8 * maxh - 1) / (8 * maxh));
      c.bh = int((int64_t(height) * c.v + 8 * maxv - 1) / (8 * maxv));
      c.bwp = mcux * c.h;
      c.bhp = mcuy * c.v;
      c.coef.assign(size_t(c.bwp) * c.bhp * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      p++;
      if (tq > 3 || pq > 1) fail(kCorrupt, "bad DQT");
      if (p + (pq ? 128 : 64) > end) fail(kCorrupt, "bad DQT length");
      for (int k = 0; k < 64; k++) {
        qt[tq][kNatural[k]] = uint16_t(pq ? (d[p + 2 * k] << 8 | d[p + 2 * k + 1]) : d[p + k]);
      }
      qt_defined[tq] = true;
      p += pq ? 128 : 64;
    }
  }

  void dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) fail(kCorrupt, "bad DHT length");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "bad DHT");
      const uint8_t* counts = &d[p + 1];
      int n = 0;
      for (int i = 0; i < 16; i++) n += counts[i];
      if (n > 256 || p + 17 + n > end) fail(kCorrupt, "bad DHT length");
      build_huffman(tc ? ac[th] : dc[th], counts, &d[p + 17], n);
      p += 17 + n;
    }
  }

  void app(size_t p, int len, int marker) {
    int n = len - 2;
    if (marker == 0xE0 && n >= 14 && std::memcmp(&d[p], "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(&d[p], "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[p + 11];
    }
  }

  int16_t* block(Component& c, int bx, int by) { return &c.coef[(size_t(by) * c.bwp + bx) * 64]; }

  void decode_block_baseline(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    if (s > 16) fail(kCorrupt, "corrupt JPEG data: bad DC magnitude");
    c.dc_pred += br.extend(s);
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(br.extend(s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Component& c, int16_t* blk, int al) {
    int s = br.decode(dc[c.td]);
    if (s > 16) fail(kCorrupt, "corrupt JPEG data: bad DC magnitude");
    c.dc_pred += br.extend(s);
    blk[0] = int16_t(uint32_t(c.dc_pred) << al);
  }

  void decode_dc_refine(int16_t* blk, int al) {
    if (br.get_bit()) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void decode_ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& ha = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(uint32_t(br.extend(s)) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += int(br.get(r));
          eobrun--;
          break;
        }
      }
    }
  }

  void decode_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const Huffman& ha = ac[c.ta];
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail(kCorrupt, "corrupt JPEG data: bad refinement magnitude");
          s = br.get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += int(br.get(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get_bit()) {
              if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get_bit()) {
            if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // Decodes one scan whose header is at p; returns the position after its data.
  size_t scan(size_t p, int len) {
    if (!have_frame) fail(kCorrupt, "SOS before SOF");
    int ns = d[p];
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail(kCorrupt, "bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail(kCorrupt, "SOS names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail(kCorrupt, "bad SOS table selector");
      sc[i] = c;
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    if (progressive) {
      bool bad = ss > se || se > 63 || al > 13 || (ah != 0 && al != ah - 1);
      if (ss == 0 && se != 0) bad = true;
      if (ss > 0 && ns != 1) bad = true;
      if (bad) fail(kCorrupt, "bad progression parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      // libjpeg tolerates these with a warning; the scan is read as baseline.
    }
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail(kCorrupt, "component uses an undefined quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      bool need_dc = !progressive || ss == 0;
      bool need_ac = !progressive || ss > 0;
      if (need_dc && !(progressive && ah != 0) && !dc[c.td].defined) fail(kCorrupt, "undefined DC Huffman table");
      if (need_ac && !ac[c.ta].defined) fail(kCorrupt, "undefined AC Huffman table");
      if (progressive) {
        for (int k = ss; k <= se; k++) {
          int expected = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
          if (ah != expected) fail(kCorrupt, "bad progression: successive approximation out of order");
          c.coef_bits[k] = al;
        }
      } else {
        for (int k = 0; k < 64; k++) c.coef_bits[k] = 0;
      }
      c.dc_pred = 0;
    }
    eobrun = 0;
    size_t data_start = p + len - 2;
    br.start(d.data(), d.size(), data_start);

    auto decode_one = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        decode_block_baseline(c, blk);
      } else if (ss == 0) {
        if (ah == 0)
          decode_dc_first(c, blk, al);
        else
          decode_dc_refine(blk, al);
      } else if (ah == 0) {
        decode_ac_first(c, blk, ss, se, al);
      } else {
        decode_ac_refine(c, blk, ss, se, al);
      }
    };

    int64_t total, per_row;
    if (ns == 1) {
      per_row = sc[0]->bw;
      total = per_row * sc[0]->bh;
    } else {
      per_row = mcux;
      total = int64_t(mcux) * mcuy;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.check_overrun();
        size_t q = br.next_marker();
        int mk = d[q + 1];
        if (mk != 0xD0 + next_rst) fail(kCorrupt, "corrupt JPEG data: missing restart marker");
        next_rst = (next_rst + 1) & 7;
        br.start(d.data(), d.size(), q + 2);
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        eobrun = 0;
      }
      int my = int(m / per_row), mx = int(m % per_row);
      if (ns == 1) {
        decode_one(*sc[0], block(*sc[0], mx, my));
      } else {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++) decode_one(c, block(c, mx * c.h + bx, my * c.v + by));
        }
      }
    }
    br.check_overrun();
    return br.next_marker();
  }

  void parse() {
    if (d.size() < 4 || d[0] != 0xFF || d[1] != 0xD8) fail(kNotImage, "not a JPEG file");
    size_t p = 2;
    bool eoi = false;
    while (!eoi) {
      while (p < d.size() && d[p] != 0xFF) p++;  // junk between markers
      while (p < d.size() && d[p] == 0xFF) p++;  // fill bytes
      if (p >= d.size()) fail(kCorrupt, "truncated file: no EOI marker");
      int marker = d[p++];
      if (marker == 0xD9) {
        eoi = true;
        break;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;  // no length
      int len = u16(p);
      if (len < 2 || p + len > d.size()) fail(kCorrupt, "truncated file: marker segment runs past the end");
      size_t body = p + 2, end = p + len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          frame(body, len, marker);
          p = end;
          break;
        case 0xC3:
          fail(kUnsupported, "lossless JPEG");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(kUnsupported, "hierarchical JPEG");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCC:
          fail(kUnsupported, "arithmetic-coded JPEG");
        case 0xC4:
          dht(body, end);
          p = end;
          break;
        case 0xDB:
          dqt(body, end);
          p = end;
          break;
        case 0xDD:
          if (len != 4) fail(kCorrupt, "bad DRI");
          restart_interval = u16(body);
          p = end;
          break;
        case 0xDC:
          fail(kUnsupported, "JPEG with a DNL marker");
        case 0xDA:
          p = scan(body, len);
          break;
        default:
          if (marker >= 0xE0 && marker <= 0xEF) app(body, len, marker);
          p = end;
          break;
      }
    }
    if (!have_frame) fail(kCorrupt, "JPEG without a frame");
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched || c.coef_bits[0] < 0) fail(kCorrupt, "truncated file: a component was never coded");
      if (progressive) {
        for (int k = 1; k < 10; k++)
          if (c.coef_bits[k] != 0)
            fail(kUnsupported,
                 "progressive JPEG whose scans leave low AC coefficients unrefined (libjpeg block smoothing)");
      }
    }
  }
};

// jidctint.c's jpeg_idct_islow; the output clamp saturates as the SIMD
// versions do (the C table wraps values far outside 0..255).
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }
inline uint8_t clamp_idct(int64_t v) {
  v += 128;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dcval = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int k = 0; k < 8; k++) wp[8 * k] = dcval;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = int64_t(ip[16]) * qp[16];
    z3 = int64_t(ip[48]) * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; row++) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + size_t(row) * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = clamp_idct(descale(tmp10 + tmp3, sh));
    o[7] = clamp_idct(descale(tmp10 - tmp3, sh));
    o[1] = clamp_idct(descale(tmp11 + tmp2, sh));
    o[6] = clamp_idct(descale(tmp11 - tmp2, sh));
    o[2] = clamp_idct(descale(tmp12 + tmp1, sh));
    o[5] = clamp_idct(descale(tmp12 - tmp1, sh));
    o[3] = clamp_idct(descale(tmp13 + tmp0, sh));
    o[4] = clamp_idct(descale(tmp13 - tmp0, sh));
  }
}

// One component's samples (dh rows of dw) brought to the full image size
// with libjpeg's upsampler choice (jdsample.c, API 6.2 defaults).
std::vector<uint8_t> upsample(const Jpeg& j, const Component& c, const std::vector<uint8_t>& plane, int stride) {
  const int W = j.width, H = j.height;
  std::vector<uint8_t> out(size_t(W) * H);
  if (j.maxh % c.h || j.maxv % c.v) fail(kUnsupported, "JPEG with fractional sampling ratios");
  const int he = j.maxh / c.h, ve = j.maxv / c.v;
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) { return plane.data() + size_t(std::min(std::max(r, 0), dh - 1)) * stride; };
  std::vector<uint8_t> tmp(size_t(2) * dw + 2);
  if (he == 1 && ve == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[size_t(y) * W], row(y), W);
  } else if (he == 2 && ve == 1 && dw > 2) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = tmp.data();
      int v = in[0];
      *o++ = uint8_t(v);
      *o++ = uint8_t((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        *o++ = uint8_t((v + in[x - 1] + 1) >> 2);
        *o++ = uint8_t((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *o++ = uint8_t((v * 3 + in[dw - 2] + 1) >> 2);
      *o++ = uint8_t(v);
      std::memcpy(&out[size_t(y) * W], tmp.data(), W);
    }
  } else if (he == 1 && ve == 2) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in0 = row(y >> 1);
      const uint8_t* in1 = (y & 1) ? row((y >> 1) + 1) : row((y >> 1) - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; x++) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    }
  } else if (he == 2 && ve == 2 && dw > 2) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in0 = row(y >> 1);
      const uint8_t* in1 = (y & 1) ? row((y >> 1) + 1) : row((y >> 1) - 1);
      uint8_t* o = tmp.data();
      int thiscol = in0[0] * 3 + in1[0], nextcol = in0[1] * 3 + in1[1], lastcol;
      *o++ = uint8_t((thiscol * 4 + 8) >> 4);
      *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < dw; x++) {
        nextcol = in0[x] * 3 + in1[x];
        *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = uint8_t((thiscol * 4 + 7) >> 4);
      std::memcpy(&out[size_t(y) * W], tmp.data(), W);
    }
  } else {  // box replication: int_upsample, h2v1_upsample, h2v2_upsample
    for (int y = 0; y < H; y++) {
      const uint8_t* in = row(y / ve);
      uint8_t* o = &out[size_t(y) * W];
      for (int x = 0; x < W; x++) o[x] = in[x / he];
    }
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

Image decode_jpeg(const std::vector<uint8_t>& data) {
  Jpeg j(data);
  j.parse();
  const int W = j.width, H = j.height;
  std::vector<std::vector<uint8_t>> full(j.ncomp);
  for (int ci = 0; ci < j.ncomp; ci++) {
    const Component& c = j.comp[ci];
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane(size_t(stride) * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(&c.coef[(size_t(by) * c.bwp + bx) * 64], c.q, &plane[size_t(by) * 8 * stride + bx * 8], stride);
    full[ci] = upsample(j, c, plane, stride);
  }
  Image im;
  im.w = W;
  im.h = H;
  im.rgb.resize(size_t(W) * H * 3);
  uint8_t* o = im.rgb.data();
  const size_t n = size_t(W) * H;
  if (j.ncomp == 1) {
    for (size_t i = 0; i < n; i++) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
    return im;
  }
  if (j.ncomp == 3) {
    bool rgb;
    if (j.saw_jfif) {
      rgb = false;
    } else if (j.saw_adobe) {
      rgb = j.adobe_transform == 0;
    } else {
      int c0 = j.comp[0].id, c1 = j.comp[1].id, c2 = j.comp[2].id;
      rgb = !(c0 == 1 && c1 == 2 && c2 == 3) && (c0 == 82 && c1 == 71 && c2 == 66);
    }
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (rgb) {
      for (size_t i = 0; i < n; i++) {
        o[3 * i] = p0[i];
        o[3 * i + 1] = p1[i];
        o[3 * i + 2] = p2[i];
      }
    } else {
      for (size_t i = 0; i < n; i++) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        o[3 * i] = clamp8(y + kYcc.cr_r[cr]);
        o[3 * i + 1] = clamp8(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        o[3 * i + 2] = clamp8(y + kYcc.cb_b[cb]);
      }
    }
    return im;
  }
  // 4 components: libjpeg gives CMYK (YCCK converted when the Adobe
  // transform says so); Pillow unpacks it inverted ("CMYK;I") and converts.
  const bool ycck = j.saw_adobe && j.adobe_transform != 0;
  const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data(), *p3 = full[3].data();
  for (size_t i = 0; i < n; i++) {
    int c, m, y, k = p3[i];
    if (ycck) {
      int yy = p0[i], cb = p1[i], cr = p2[i];
      c = clamp8(255 - (yy + kYcc.cr_r[cr]));
      m = clamp8(255 - (yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
      y = clamp8(255 - (yy + kYcc.cb_b[cb]));
    } else {
      c = p0[i];
      m = p1[i];
      y = p2[i];
    }
    c = 255 - c;
    m = 255 - m;
    y = 255 - y;
    k = 255 - k;
    int nk = 255 - k;
    auto muldiv255 = [](int a, int b) {
      int t = a * b + 128;
      return ((t >> 8) + t) >> 8;
    };
    o[3 * i] = clamp8(nk - muldiv255(c, nk));
    o[3 * i + 1] = clamp8(nk - muldiv255(m, nk));
    o[3 * i + 2] = clamp8(nk - muldiv255(y, nk));
  }
  return im;
}

// ----------------------------------------------------------------- PNG ---

// RFC 1951 inflate (after puff.c): canonical Huffman decoding bit by bit.
struct Inflate {
  const uint8_t* src;
  size_t n, pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  std::vector<uint8_t>& out;
  size_t limit;

  struct Table {
    int16_t count[16];
    int16_t symbol[288];
  };

  Inflate(const uint8_t* s, size_t len, std::vector<uint8_t>& o, size_t lim) : src(s), n(len), out(o), limit(lim) {}

  uint32_t bits(int need) {
    uint32_t val = bitbuf;
    while (bitcnt < need) {
      if (pos >= n) fail(kCorrupt, "truncated file: compressed PNG data runs past the end");
      val |= uint32_t(src[pos++]) << bitcnt;
      bitcnt += 8;
    }
    bitbuf = val >> need;
    bitcnt -= need;
    return val & ((1u << need) - 1);
  }

  static int construct(Table& t, const int16_t* length, int count) {
    for (int l = 0; l < 16; l++) t.count[l] = 0;
    for (int s = 0; s < count; s++) t.count[length[s]]++;
    if (t.count[0] == count) return 0;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left <<= 1;
      left -= t.count[l];
      if (left < 0) return left;
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = int16_t(offs[l] + t.count[l]);
    for (int s = 0; s < count; s++)
      if (length[s] != 0) t.symbol[offs[length[s]]++] = int16_t(s);
    return left;
  }

  int decode(const Table& t) {
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; l++) {
      code |= int(bits(1));
      int count = t.count[l];
      if (code - count < first) return t.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    fail(kCorrupt, "corrupt PNG data: bad deflate code");
  }

  void codes(const Table& lencode, const Table& distcode) {
    static const int16_t lbase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                      31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const int16_t lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const int16_t dbase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
                                      193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    static const int16_t dext[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int symbol = decode(lencode);
      if (symbol < 256) {
        if (out.size() >= limit) fail(kCorrupt, "corrupt PNG data: too much image data");
        out.push_back(uint8_t(symbol));
      } else if (symbol == 256) {
        return;
      } else {
        symbol -= 257;
        if (symbol >= 29) fail(kCorrupt, "corrupt PNG data: bad length code");
        size_t len = size_t(lbase[symbol]) + bits(lext[symbol]);
        symbol = decode(distcode);
        if (symbol < 0 || symbol >= 30) fail(kCorrupt, "corrupt PNG data: bad distance code");
        size_t dist = size_t(dbase[symbol]) + bits(dext[symbol]);
        if (dist > out.size()) fail(kCorrupt, "corrupt PNG data: distance too far back");
        if (out.size() + len > limit) fail(kCorrupt, "corrupt PNG data: too much image data");
        size_t from = out.size() - dist;
        for (size_t i = 0; i < len; i++) out.push_back(out[from + i]);
      }
    }
  }

  void run() {
    Table lencode, distcode;
    int last;
    do {
      last = int(bits(1));
      int type = int(bits(2));
      if (type == 0) {
        bitbuf = 0;
        bitcnt = 0;
        if (pos + 4 > n) fail(kCorrupt, "truncated file: compressed PNG data runs past the end");
        size_t len = src[pos] | (src[pos + 1] << 8);
        size_t nlen = src[pos + 2] | (src[pos + 3] << 8);
        pos += 4;
        if (len != (~nlen & 0xFFFF)) fail(kCorrupt, "corrupt PNG data: bad stored block");
        if (pos + len > n) fail(kCorrupt, "truncated file: compressed PNG data runs past the end");
        if (out.size() + len > limit) fail(kCorrupt, "corrupt PNG data: too much image data");
        out.insert(out.end(), src + pos, src + pos + len);
        pos += len;
      } else if (type == 1) {
        static Table fixed_len, fixed_dist;
        static const bool built = [] {
          int16_t lengths[288];
          int s = 0;
          for (; s < 144; s++) lengths[s] = 8;
          for (; s < 256; s++) lengths[s] = 9;
          for (; s < 280; s++) lengths[s] = 7;
          for (; s < 288; s++) lengths[s] = 8;
          construct(fixed_len, lengths, 288);
          for (s = 0; s < 30; s++) lengths[s] = 5;
          construct(fixed_dist, lengths, 30);
          return true;
        }();
        (void)built;
        codes(fixed_len, fixed_dist);
      } else if (type == 2) {
        static const int16_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        int nlen = int(bits(5)) + 257, ndist = int(bits(5)) + 1, ncode = int(bits(4)) + 4;
        if (nlen > 286 || ndist > 30) fail(kCorrupt, "corrupt PNG data: bad counts");
        int16_t lengths[320];
        int idx;
        for (idx = 0; idx < ncode; idx++) lengths[order[idx]] = int16_t(bits(3));
        for (; idx < 19; idx++) lengths[order[idx]] = 0;
        if (construct(lencode, lengths, 19) != 0) fail(kCorrupt, "corrupt PNG data: bad code lengths");
        idx = 0;
        while (idx < nlen + ndist) {
          int symbol = decode(lencode);
          if (symbol < 16) {
            lengths[idx++] = int16_t(symbol);
          } else {
            int len = 0, rep;
            if (symbol == 16) {
              if (idx == 0) fail(kCorrupt, "corrupt PNG data: repeat with no first length");
              len = lengths[idx - 1];
              rep = 3 + int(bits(2));
            } else if (symbol == 17) {
              rep = 3 + int(bits(3));
            } else {
              rep = 11 + int(bits(7));
            }
            if (idx + rep > nlen + ndist) fail(kCorrupt, "corrupt PNG data: too many lengths");
            while (rep--) lengths[idx++] = int16_t(len);
          }
        }
        if (lengths[256] == 0) fail(kCorrupt, "corrupt PNG data: no end-of-block code");
        int err = construct(lencode, lengths, nlen);
        if (err < 0 || (err > 0 && nlen - lencode.count[0] != 1)) fail(kCorrupt, "corrupt PNG data: bad literal/length code");
        err = construct(distcode, lengths + nlen, ndist);
        if (err < 0 || (err > 0 && ndist - distcode.count[0] != 1)) fail(kCorrupt, "corrupt PNG data: bad distance code");
        codes(lencode, distcode);
      } else {
        fail(kCorrupt, "corrupt PNG data: bad block type");
      }
    } while (!last);
  }
};

uint32_t be32(const uint8_t* p) { return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3]; }

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

struct PngHeader {
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
};

PngHeader png_header(const std::vector<uint8_t>& d) {
  if (d.size() < 33) fail(kCorrupt, "truncated file: PNG header");
  if (be32(&d[8]) != 13 || std::memcmp(&d[12], "IHDR", 4) != 0) fail(kCorrupt, "PNG without IHDR");
  PngHeader h;
  h.w = int(be32(&d[16]));
  h.h = int(be32(&d[20]));
  h.depth = d[24];
  h.ctype = d[25];
  h.interlace = d[28];
  if (h.w <= 0 || h.h <= 0) fail(kCorrupt, "PNG with zero size");
  if (d[26] != 0 || d[27] != 0) fail(kCorrupt, "PNG with an unknown compression or filter method");
  return h;
}

Image decode_png(const std::vector<uint8_t>& d) {
  PngHeader hd = png_header(d);
  const int W = hd.w, H = hd.h, depth = hd.depth, ct = hd.ctype;
  if (hd.interlace) fail(kUnsupported, "interlaced PNG");
  int channels;
  switch (ct) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: fail(kCorrupt, "PNG with an unknown color type");
  }
  if (depth == 16) fail(kUnsupported, "16-bit PNG");
  bool depth_ok = depth == 8 || ((ct == 0 || ct == 3) && (depth == 1 || depth == 2 || depth == 4));
  if (!depth_ok) fail(kCorrupt, "PNG with a bad bit depth");
  if (int64_t(W) * H > kMaxPixels) fail(kUnsupported, "image larger than 2^28 pixels");
  std::vector<uint8_t> idat;
  uint8_t palette[256 * 3];
  std::memset(palette, 0, sizeof(palette));  // Pillow: indexes past PLTE give black
  bool have_plte = false, iend = false;
  size_t p = 8;
  while (!iend) {
    if (p + 8 > d.size()) fail(kCorrupt, "truncated file: PNG ends before IEND");
    size_t len = be32(&d[p]);
    const uint8_t* type = &d[p + 4];
    if (p + 12 + len > d.size()) fail(kCorrupt, "truncated file: PNG chunk runs past the end");
    const uint8_t* body = &d[p + 8];
    if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 || len > 768) fail(kCorrupt, "bad PNG palette");
      std::memcpy(palette, body, len);
      have_plte = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      iend = true;
    }
    p += 12 + len;
  }
  if (ct == 3 && !have_plte) fail(kCorrupt, "palette PNG without PLTE");
  if (idat.size() < 2) fail(kCorrupt, "PNG without image data");
  if ((idat[0] & 15) != 8 || ((idat[0] << 8) | idat[1]) % 31 != 0 || (idat[1] & 0x20))
    fail(kCorrupt, "corrupt PNG data: bad zlib header");
  const size_t rowbytes = (size_t(W) * channels * depth + 7) / 8;
  const size_t bpp = std::max<size_t>(1, size_t(channels) * depth / 8);
  const size_t total = size_t(H) * (rowbytes + 1);
  std::vector<uint8_t> raw;
  raw.reserve(total);
  Inflate inf(idat.data() + 2, idat.size() - 2, raw, total);
  inf.run();
  if (raw.size() != total) fail(kCorrupt, "truncated file: PNG image data ends early");
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  Image im;
  im.w = W;
  im.h = H;
  im.rgb.resize(size_t(W) * H * 3);
  for (int y = 0; y < H; y++) {
    const uint8_t* r = &raw[size_t(y) * (rowbytes + 1)];
    int filter = r[0];
    const uint8_t* s = r + 1;
    for (size_t i = 0; i < rowbytes; i++) {
      int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
      int v;
      switch (filter) {
        case 0: v = s[i]; break;
        case 1: v = s[i] + a; break;
        case 2: v = s[i] + b; break;
        case 3: v = s[i] + ((a + b) >> 1); break;
        case 4: {
          int pp = a + b - c, pa = std::abs(pp - a), pb = std::abs(pp - b), pc = std::abs(pp - c);
          v = s[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
          break;
        }
        default: fail(kCorrupt, "corrupt PNG data: bad row filter");
      }
      cur[i] = uint8_t(v);
    }
    uint8_t* o = &im.rgb[size_t(y) * W * 3];
    for (int x = 0; x < W; x++) {
      if (ct == 2 || ct == 6) {
        const uint8_t* px = &cur[size_t(x) * channels];
        o[3 * x] = px[0];
        o[3 * x + 1] = px[1];
        o[3 * x + 2] = px[2];
        continue;
      }
      int v;
      if (depth == 8) {
        v = cur[size_t(x) * channels];
      } else {
        size_t bit = size_t(x) * depth;
        v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
      }
      if (ct == 3) {
        o[3 * x] = palette[3 * v];
        o[3 * x + 1] = palette[3 * v + 1];
        o[3 * x + 2] = palette[3 * v + 2];
      } else {
        // Pillow's gray unpackers: "1" -> 0/255, "L;2" x85, "L;4" x17.
        int g = depth == 8 ? v : depth == 4 ? v * 17 : depth == 2 ? v * 85 : v * 255;
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = uint8_t(g);
      }
    }
    std::swap(prev, cur);
  }
  return im;
}

// --------------------------------------------------------- dispatching ---

std::string sniff_other(const std::vector<uint8_t>& d) {
  auto starts = [&](const char* s, size_t n) { return d.size() >= n && std::memcmp(d.data(), s, n) == 0; };
  if (starts("GIF8", 4)) return "GIF";
  if (starts("BM", 2)) return "BMP";
  if (d.size() >= 12 && std::memcmp(d.data(), "RIFF", 4) == 0 && std::memcmp(&d[8], "WEBP", 4) == 0) return "WebP";
  if (starts("II*\0", 4) || starts("MM\0*", 4)) return "TIFF";
  return "";
}

bool is_jpeg(const std::vector<uint8_t>& d) { return d.size() >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF; }
bool is_png(const std::vector<uint8_t>& d) { return d.size() >= 8 && std::memcmp(d.data(), kPngSig, 8) == 0; }

[[noreturn]] void not_image(const std::vector<uint8_t>& d) {
  std::string other = sniff_other(d);
  if (!other.empty()) fail(kUnsupported, other + " file (only JPEG and PNG are read)");
  fail(kNotImage, "not a JPEG or PNG file");
}

Image decode_file(const char* path) {
  std::vector<uint8_t> d = read_file(path, SIZE_MAX);
  if (is_jpeg(d)) return decode_jpeg(d);
  if (is_png(d)) return decode_png(d);
  not_image(d);
}

// Width and height from the header alone (SOFn or IHDR); reads the first
// 64 KiB, and the whole file only when the frame header lies further on.
bool jpeg_sof_size(const std::vector<uint8_t>& d, int32_t* wh) {
  size_t p = 2;
  for (;;) {
    while (p < d.size() && d[p] != 0xFF) p++;
    while (p < d.size() && d[p] == 0xFF) p++;
    if (p + 3 > d.size()) return false;
    int marker = d[p++];
    if (marker == 0xD9 || marker == 0xDA) fail(kCorrupt, "JPEG without a frame header");
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    int len = (d[p] << 8) | d[p + 1];
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 && marker != 0xCC) {
      if (p + 7 > d.size()) return false;
      wh[1] = (d[p + 3] << 8) | d[p + 4];
      wh[0] = (d[p + 5] << 8) | d[p + 6];
      return true;
    }
    p += len;
  }
}

void probe_file(const char* path, int32_t* wh) {
  const size_t head = size_t(1) << 16;
  std::vector<uint8_t> d = read_file(path, head);
  if (is_png(d)) {
    PngHeader h = png_header(d);
    wh[0] = h.w;
    wh[1] = h.h;
    return;
  }
  if (!is_jpeg(d)) not_image(d);
  if (jpeg_sof_size(d, wh)) return;
  if (d.size() == head && jpeg_sof_size(read_file(path, SIZE_MAX), wh)) return;
  fail(kCorrupt, "truncated file: no SOF marker");
}

// ------------------------------------------------------------ resample ---

// Pillow's Resample.c (8 bits a channel): BICUBIC, a = -0.5.
constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // xmin, xmax (count) per output
  std::vector<int32_t> kk;
};

Coeffs precompute_coeffs(int in_size, float in0, float in1, int out_size) {
  Coeffs c;
  double filterscale, scale;
  filterscale = scale = double(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = 2.0 * filterscale;
  int ksize = int(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds.resize(size_t(out_size) * 2);
  c.kk.assign(size_t(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = 0; x < xmax; x++) {
      double v = k[x];
      c.kk[size_t(xx) * ksize + x] =
          v < 0 ? int32_t(-0.5 + v * (1 << kPrecisionBits)) : int32_t(0.5 + v * (1 << kPrecisionBits));
    }
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

// in: h x w x 3; box: x0, y0, x1, y1 (Pillow takes them as float).
std::vector<uint8_t> resample(const uint8_t* in, int w, int h, const float* box, int ow, int oh) {
  const bool need_h = ow != w || box[0] != 0.0f || box[2] != float(ow);
  const bool need_v = oh != h || box[1] != 0.0f || box[3] != float(oh);
  Coeffs ch = precompute_coeffs(w, box[0], box[2], ow);
  Coeffs cv = precompute_coeffs(h, box[1], box[3], oh);
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int sw = w;
  std::vector<int> vb = cv.bounds;
  if (need_h) {
    int yfirst = cv.bounds[0];
    int ylast = cv.bounds[2 * oh - 2] + cv.bounds[2 * oh - 1];
    for (int i = 0; i < oh; i++) vb[2 * i] -= yfirst;
    int rows = ylast - yfirst;
    tmp.resize(size_t(rows) * ow * 3);
    for (int yy = 0; yy < rows; yy++) {
      const uint8_t* r = in + size_t(yy + yfirst) * w * 3;
      uint8_t* o = &tmp[size_t(yy) * ow * 3];
      for (int xx = 0; xx < ow; xx++) {
        int xmin = ch.bounds[2 * xx], xmax = ch.bounds[2 * xx + 1];
        const int32_t* k = &ch.kk[size_t(xx) * ch.ksize];
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const uint8_t* px = r + size_t(x + xmin) * 3;
          s0 += px[0] * k[x];
          s1 += px[1] * k[x];
          s2 += px[2] * k[x];
        }
        o[3 * xx] = clip8(s0);
        o[3 * xx + 1] = clip8(s1);
        o[3 * xx + 2] = clip8(s2);
      }
    }
    src = tmp.data();
    sw = ow;
  }
  if (!need_v) {
    if (src == in) return std::vector<uint8_t>(in, in + size_t(w) * h * 3);
    return tmp;
  }
  std::vector<uint8_t> out(size_t(oh) * sw * 3);
  for (int yy = 0; yy < oh; yy++) {
    const int32_t* k = &cv.kk[size_t(yy) * cv.ksize];
    int ymin = vb[2 * yy], ymax = vb[2 * yy + 1];
    uint8_t* o = &out[size_t(yy) * sw * 3];
    for (int xx = 0; xx < sw; xx++) {
      int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      for (int y = 0; y < ymax; y++) {
        const uint8_t* px = src + (size_t(y + ymin) * sw + xx) * 3;
        s0 += px[0] * k[y];
        s1 += px[1] * k[y];
        s2 += px[2] * k[y];
      }
      o[3 * xx] = clip8(s0);
      o[3 * xx + 1] = clip8(s1);
      o[3 * xx + 2] = clip8(s2);
    }
  }
  return out;
}

void set_msg(char* msgs, int64_t msg_len, int64_t i, const std::string& m) {
  if (!msgs || msg_len <= 0) return;
  char* dst = msgs + i * msg_len;
  size_t n = std::min<size_t>(m.size(), size_t(msg_len - 1));
  std::memcpy(dst, m.data(), n);
  dst[n] = 0;
}

template <class F>
void parallel_for(int64_t n, int64_t threads, F&& f) {
  int64_t t = std::max<int64_t>(1, std::min<int64_t>(threads <= 0 ? 16 : threads, n));
  std::atomic<int64_t> next{0};
  auto worker = [&] {
    for (int64_t i; (i = next.fetch_add(1)) < n;) f(i);
  };
  std::vector<std::thread> pool;
  for (int64_t k = 1; k < t; k++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

template <class F>
int32_t guarded(char* msgs, int64_t msg_len, int64_t i, F&& f) {
  try {
    f();
    return kOk;
  } catch (const DecodeError& e) {
    set_msg(msgs, msg_len, i, e.msg);
    return e.status;
  } catch (const std::bad_alloc&) {
    set_msg(msgs, msg_len, i, "out of memory");
    return kIoError;
  } catch (const std::exception& e) {
    set_msg(msgs, msg_len, i, e.what());
    return kIoError;
  }
}

}  // namespace

extern "C" {

// Header sizes of n files: wh[2i], wh[2i+1] = width, height.  Returns the
// number of files that failed; status[i] and msgs[i * msg_len] say why.
int64_t cil_img_probe(const char* const* paths, int64_t n, int32_t* wh, int32_t* status, char* msgs,
                      int64_t msg_len, int64_t threads) {
  std::atomic<int64_t> bad{0};
  parallel_for(n, threads, [&](int64_t i) {
    status[i] = guarded(msgs, msg_len, i, [&] { probe_file(paths[i], wh + 2 * i); });
    if (status[i]) bad++;
  });
  return bad.load();
}

// The whole image as RGB into out (cap bytes, at least w * h * 3, with w
// and h from cil_img_probe).  Returns a status; msg gets the reason.
int32_t cil_img_decode_full(const char* path, uint8_t* out, int64_t cap, int32_t* wh, char* msg, int64_t msg_len) {
  return guarded(msg, msg_len, 0, [&] {
    Image im = decode_file(path);
    wh[0] = im.w;
    wh[1] = im.h;
    if (int64_t(im.rgb.size()) > cap) fail(kBadArgument, "output buffer too small");
    std::memcpy(out, im.rgb.data(), im.rgb.size());
  });
}

// A batch: image i is decoded, resized to geom[4i], geom[4i+1] (width,
// height) from the source box boxes[4i..4i+3] with Pillow's BICUBIC (or
// copied when that is the whole image at its own size), and the window of
// s x s pixels at left = geom[4i+2], top = geom[4i+3] is written to
// out + i * s * s * 3 (zeros where the window leaves the resized image, as
// Image.crop fills).  Returns the number of files that failed.
int64_t cil_img_decode_batch(const char* const* paths, int64_t n, const float* boxes, const int32_t* geom, int64_t s,
                             uint8_t* out, int32_t* status, char* msgs, int64_t msg_len, int64_t threads) {
  std::atomic<int64_t> bad{0};
  parallel_for(n, threads, [&](int64_t i) {
    status[i] = guarded(msgs, msg_len, i, [&] {
      Image im = decode_file(paths[i]);
      const float* box = boxes + 4 * i;
      const int rw = geom[4 * i], rh = geom[4 * i + 1], left = geom[4 * i + 2], top = geom[4 * i + 3];
      if (rw <= 0 || rh <= 0) fail(kBadArgument, "bad resize target");
      if (box[0] < 0 || box[1] < 0 || box[2] > im.w || box[3] > im.h || box[2] < box[0] || box[3] < box[1])
        fail(kBadArgument, "crop box outside the image (is the file the one that was probed?)");
      std::vector<uint8_t> r;
      const bool whole = rw == im.w && rh == im.h && box[0] == 0.0f && box[1] == 0.0f && box[2] == float(im.w) &&
                         box[3] == float(im.h);
      if (whole)
        r.swap(im.rgb);
      else
        r = resample(im.rgb.data(), im.w, im.h, box, rw, rh);
      uint8_t* o = out + i * s * s * 3;
      for (int64_t y = 0; y < s; y++) {
        int64_t sy = top + y;
        for (int64_t x = 0; x < s; x++) {
          int64_t sx = left + x;
          uint8_t* d = o + (y * s + x) * 3;
          if (sy < 0 || sy >= rh || sx < 0 || sx >= rw) {
            d[0] = d[1] = d[2] = 0;
          } else {
            const uint8_t* p = &r[(size_t(sy) * rw + sx) * 3];
            d[0] = p[0];
            d[1] = p[1];
            d[2] = p[2];
          }
        }
      }
    });
    if (status[i]) bad++;
  });
  return bad.load();
}

// Pillow's BICUBIC resize of an RGB array (h x w x 3) from a float box to
// ow x oh, into out (oh x ow x 3).  Returns a status.
int32_t cil_img_resample(const uint8_t* in, int64_t w, int64_t h, const float* box, int64_t ow, int64_t oh,
                         uint8_t* out) {
  return guarded(nullptr, 0, 0, [&] {
    if (w <= 0 || h <= 0 || ow <= 0 || oh <= 0) fail(kBadArgument, "bad size");
    std::vector<uint8_t> r = resample(in, int(w), int(h), box, int(ow), int(oh));
    std::memcpy(out, r.data(), r.size());
  });
}

}  // extern "C"
