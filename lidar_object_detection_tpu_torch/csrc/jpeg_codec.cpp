// JPEG decoding and encoding on the host, bit for bit as libjpeg(-turbo)
// computes them at the settings Pillow uses: Image.open(p).convert("RGB")
// and Image.fromarray(rgb).save("x.jpg") at its defaults.
//
// Decoder: SOF0, SOF1 and SOF2 (baseline, extended and progressive
// Huffman), 8-bit samples, one or three components, luma sampled 1 or 2
// in each direction with chroma 1 x 1, interleaved and non-interleaved
// scans, DRI and RST markers, DQT of 8 or 16 bits.  The integer "islow"
// IDCT with its 10-bit range-limit table, the "fancy" triangle upsampling
// filters (h2v1, h1v2, h2v2; plain replication where a downsampled width
// is 2 or less) and the fixed-point YCbCr -> RGB tables.  A progressive
// file whose scans leave coefficient bits unknown (where libjpeg would
// smooth the blocks) is refused, as is everything outside the scope above.
//
// Encoder, at Pillow's defaults only (quality 75, 4:2:0): RGB in, YCbCr
// out, the standard quantisation tables scaled to quality 75 with
// libjpeg's clamp to 1..255, edge replication to the iMCU, the 2 x 2
// downsampler with its alternating bias, the integer islow FDCT
// with libjpeg-turbo's reciprocal quantisation, dummy blocks, the standard
// Huffman tables, JFIF APP0 1.01.
//
// C interface (ctypes): jpeg_codec_probe, jpeg_codec_decode,
// jpeg_codec_encode.  Each returns a negative status and writes a message
// into `err` when it refuses the input.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw JpegError(buf);
}

// zigzag index -> natural (row-major) index
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// the standard tables of the JPEG specification (Annex K)
constexpr uint8_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

constexpr uint8_t kDcCounts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kDcSymbols[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcCounts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kAcSymbols[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// islow (I)DCT constants: FIX(x) = x * 2^13 rounded
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// fixed-point colour tables: FIX(x) = x * 2^16 rounded, as libjpeg's
inline int64_t fix16(double x) { return int64_t(x * 65536.0 + 0.5); }

struct Tables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  Tables() {
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix16(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix16(1.77200) * x + half) >> 16);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + half;
    }
  }
};
const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int16_t wrap16(int64_t x) { return int16_t(uint16_t(uint64_t(x))); }
inline int32_t wrap32(int64_t x) { return int32_t(uint32_t(uint64_t(x))); }
inline int16_t sat16(int32_t x) {
  return int16_t(x > 32767 ? 32767 : x < -32768 ? -32768 : x);
}

// One 1-D islow IDCT over 8 16-bit lanes in the SIMD code's form: each
// rotation is one pmaddwd of two lanes by 16-bit constants, the sums
// ahead of the rotations are 16-bit adds, and each output is descaled by
// `shift` in 32 bits.  Equal to the C code's pass where nothing wraps.
void simd_pass(const int16_t* x, int shift, int32_t* out) {
  auto madd = [](int16_t a, int64_t ca, int16_t b, int64_t cb) {
    return int64_t(a) * ca + int64_t(b) * cb;
  };
  int64_t tmp3 = madd(x[2], F0_541196100 + F0_765366865, x[6], F0_541196100);
  int64_t tmp2 = madd(x[2], F0_541196100, x[6], F0_541196100 - F1_847759065);
  int64_t tmp0 = int64_t(wrap16(int32_t(x[0]) + x[4])) * (1 << kConstBits);
  int64_t tmp1 = int64_t(wrap16(int32_t(x[0]) - x[4])) * (1 << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int16_t z3 = wrap16(int32_t(x[7]) + x[3]), z4 = wrap16(int32_t(x[5]) + x[1]);
  int64_t z3r = madd(z3, F1_175875602 - F1_961570560, z4, F1_175875602);
  int64_t z4r = madd(z3, F1_175875602, z4, F1_175875602 - F0_390180644);
  int64_t o0 = madd(x[7], F0_298631336 - F0_899976223, x[1], -F0_899976223) + z3r;
  int64_t o3 = madd(x[7], -F0_899976223, x[1], F1_501321110 - F0_899976223) + z4r;
  int64_t o1 = madd(x[5], F2_053119869 - F2_562915447, x[3], -F2_562915447) + z4r;
  int64_t o2 = madd(x[5], -F2_562915447, x[3], F3_072711026 - F2_562915447) + z3r;
  const int64_t sums[8] = {tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                           tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3};
  for (int i = 0; i < 8; i++)
    out[i] = wrap32(sums[i] + (int64_t(1) << (shift - 1))) >> shift;
}

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct Huff {
  bool defined = false;
  uint8_t counts[16] = {};
  uint8_t symbols[256] = {};
  int nsym = 0;
  // derived
  bool built = false;
  uint8_t look_len[512];
  uint8_t look_sym[512];
  int maxcode[17];
  int valoff[17];
};

void define_huff(Huff& t, const uint8_t* counts, const uint8_t* symbols) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += counts[i];
  if (n > 256) fail("bad Huffman table: %d symbols (DHT)", n);
  t.defined = true;
  t.built = false;
  t.nsym = n;
  std::memcpy(t.counts, counts, 16);
  std::memcpy(t.symbols, symbols, size_t(n));
}

void build_huff(Huff& t, bool dc) {
  std::memset(t.look_len, 0, sizeof t.look_len);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    t.valoff[l] = k - code;
    for (int i = 0; i < t.counts[l - 1]; i++, k++, code++) {
      if (l <= 9) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); j++) {
          t.look_len[(code << shift) | j] = uint8_t(l);
          t.look_sym[(code << shift) | j] = t.symbols[k];
        }
      }
    }
    if (code >= (1 << l) && k > 0)
      fail("bad Huffman table: codes of length %d overflow (DHT)", l);
    t.maxcode[l] = t.counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  if (dc)
    for (int i = 0; i < t.nsym; i++)
      if (t.symbols[i] > 15)
        fail("bad Huffman table: DC symbol %d (DHT)", t.symbols[i]);
  t.built = true;
}

struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;
  int64_t real = 0, used = 0;
  bool marker = false;

  void start(const uint8_t* data, size_t size, size_t p) {
    d = data;
    n = size;
    pos = p;
    acc = 0;
    cnt = 0;
    real = used = 0;
    marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker) {
        if (pos >= n) {
          marker = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
          real += 8;
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
            real += 8;
          } else {
            marker = true;
          }
        }
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return uint32_t(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
    used += k;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return int(v);
  }
  void check() const {
    if (used > real)
      fail("entropy-coded data ends early (truncated or corrupt file)");
  }
};

inline int decode_symbol(Bits& b, const Huff& t) {
  uint32_t p = b.peek(16);
  int l = t.look_len[p >> 7];
  if (l) {
    b.skip(l);
    return t.look_sym[p >> 7];
  }
  for (l = 10; l <= 16; l++) {
    int code = int(p >> (16 - l));
    if (code <= t.maxcode[l]) {
      b.skip(l);
      return t.symbols[t.valoff[l] + code];
    }
  }
  fail("bad Huffman code in the entropy-coded data (corrupt file)");
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks covering the component's samples
  int bw = 0, bh = 0;    // blocks stored (padded to whole MCUs)
  int dw = 0, dh = 0;    // downsampled width and height
  std::vector<int16_t> coef;
  bool latched = false;
  int16_t qt[64];        // dequantisation table in natural order (a short, as libjpeg keeps it)
  int coef_bits[64];
  int dc_pred = 0;
  bool scanned = false;
  int16_t* block(int by, int bx) { return &coef[(size_t(by) * bw + bx) * 64]; }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void header_only() { run(false); }
  void decode(uint8_t* out) {
    run(true);
    output(out);
  }
  int height() const { return H_; }
  int width() const { return W_; }
  int components() const { return nc_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int H_ = 0, W_ = 0, nc_ = 0;
  int sof_ = -1;
  bool progressive_ = false;
  Component comp_[3];
  int maxh_ = 1, maxv_ = 1, mcux_ = 0, mcuy_ = 0;
  int16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];
  bool std_tables_ = false;
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  int scans_ = 0;
  Bits bits_;
  int eobrun_ = 0;

  int u8(size_t p) const {
    if (p >= n_) fail("unexpected end of file (truncated file)");
    return d_[p];
  }
  int u16(size_t p) const { return (u8(p) << 8) | u8(p + 1); }

  // next marker code at pos_, skipping any bytes before it as libjpeg does
  int next_marker() {
    for (;;) {
      if (pos_ >= n_) fail("unexpected end of file: no EOI marker (truncated file)");
      if (d_[pos_] != 0xFF) {
        pos_++;
        continue;
      }
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      if (pos_ >= n_) fail("unexpected end of file: no EOI marker (truncated file)");
      int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  size_t segment(size_t& len) {
    len = size_t(u16(pos_));
    if (len < 2) fail("bad marker length %zu", len);
    if (pos_ + len > n_) fail("unexpected end of file in a marker segment (truncated file)");
    size_t body = pos_ + 2;
    pos_ += len;
    len -= 2;
    return body;
  }

  void run(bool decode) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8)
      fail("not a JPEG file: no SOI marker");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      size_t len = 0, b = 0;
      if (m == 0xD8) fail("second SOI marker (corrupt file)");
      if (m == 0xD9) {
        if (sof_ < 0) fail("no SOF marker before EOI (corrupt file)");
        if (decode && scans_ == 0) fail("no SOS marker before EOI (corrupt file)");
        break;
      }
      if (m >= 0xD0 && m <= 0xD7) fail("RST%d marker outside a scan (corrupt file)", m - 0xD0);
      if (m == 0x01) continue;  // TEM: no length
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        b = segment(len);
        parse_sof(m, b, len);
        if (!decode) return;
        continue;
      }
      if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xC8)
        fail("lossless or hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF)
        fail("arithmetic coding (SOF%d) is not supported", m - 0xC0);
      if (m == 0xCC) fail("arithmetic coding (DAC marker) is not supported");
      if (m == 0xDC) fail("DNL marker is not supported");
      b = segment(len);
      if (m == 0xC4) {
        parse_dht(b, len);
      } else if (m == 0xDB) {
        parse_dqt(b, len);
      } else if (m == 0xDD) {
        if (len < 2) fail("bad DRI marker length");
        restart_interval_ = u16(b);
      } else if (m == 0xDA) {
        if (sof_ < 0) fail("SOS marker before SOF (corrupt file)");
        if (!decode) return;
        scan(b, len);
      } else if (m == 0xE0) {
        if (len >= 14 && std::memcmp(d_ + b, "JFIF\0", 5) == 0) jfif_ = true;
      } else if (m == 0xEE) {
        if (len >= 12 && std::memcmp(d_ + b, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[b + 11];
        }
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
        // APPn, COM and JPGn: skipped
      } else {
        fail("unknown JPEG marker 0xFF%02X", m);
      }
    }
    if (decode) finish_check();
  }

  void parse_sof(int m, size_t b, size_t len) {
    if (sof_ >= 0) fail("second SOF marker (corrupt file)");
    if (len < 6) fail("bad SOF%d marker length", m - 0xC0);
    int precision = u8(b);
    H_ = u16(b + 1);
    W_ = u16(b + 3);
    nc_ = u8(b + 5);
    if (precision != 8)
      fail("%d-bit precision (SOF%d) is not supported: 8-bit samples only", precision, m - 0xC0);
    if (nc_ == 4) fail("four components (CMYK or YCCK) are not supported");
    if (nc_ != 1 && nc_ != 3) fail("%d components are not supported: 1 or 3 only", nc_);
    if (len < size_t(6 + 3 * nc_)) fail("bad SOF%d marker length", m - 0xC0);
    if (H_ == 0) fail("image height 0 (DNL) is not supported");
    if (W_ == 0) fail("image width 0 (corrupt file)");
    sof_ = m - 0xC0;
    progressive_ = m == 0xC2;
    for (int c = 0; c < nc_; c++) {
      Component& k = comp_[c];
      k.id = u8(b + 6 + 3 * c);
      int hv = u8(b + 7 + 3 * c);
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = u8(b + 8 + 3 * c);
      if (k.tq > 3) fail("quantization table %d out of range (SOF%d)", k.tq, sof_);
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
        fail("sampling factors %dx%d out of range (SOF%d)", k.h, k.v, sof_);
    }
    if (nc_ == 1) {
      comp_[0].h = comp_[0].v = 1;
    } else {
      bool ok = comp_[0].h <= 2 && comp_[0].v <= 2;
      for (int c = 1; c < 3; c++) ok = ok && comp_[c].h == 1 && comp_[c].v == 1;
      if (!ok)
        fail("sampling factors %dx%d,%dx%d,%dx%d are not supported: luma 1 or 2 "
             "in each direction with chroma 1x1 only",
             comp_[0].h, comp_[0].v, comp_[1].h, comp_[1].v, comp_[2].h, comp_[2].v);
    }
    maxh_ = comp_[0].h;
    maxv_ = comp_[0].v;
    mcux_ = (W_ + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy_ = (H_ + 8 * maxv_ - 1) / (8 * maxv_);
    for (int c = 0; c < nc_; c++) {
      Component& k = comp_[c];
      k.wib = int((int64_t(W_) * k.h + 8 * maxh_ - 1) / (8 * maxh_));
      k.hib = int((int64_t(H_) * k.v + 8 * maxv_ - 1) / (8 * maxv_));
      k.dw = int((int64_t(W_) * k.h + maxh_ - 1) / maxh_);
      k.dh = int((int64_t(H_) * k.v + maxv_ - 1) / maxv_);
      k.bw = nc_ == 1 ? k.wib : mcux_ * k.h;
      k.bh = nc_ == 1 ? k.hib : mcuy_ * k.v;
      for (int i = 0; i < 64; i++) k.coef_bits[i] = -1;
    }
  }

  void parse_dht(size_t b, size_t len) {
    size_t end = b + len;
    while (b < end) {
      if (b + 17 > end) fail("bad DHT marker length");
      int tc = d_[b] >> 4, th = d_[b] & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table class %d or id %d (DHT)", tc, th);
      int n = 0;
      for (int i = 0; i < 16; i++) n += d_[b + 1 + i];
      if (n > 256 || b + 17 + n > end) fail("bad DHT marker length");
      define_huff(tc ? ac_[th] : dc_[th], d_ + b + 1, d_ + b + 17);
      b += 17 + n;
    }
  }

  void parse_dqt(size_t b, size_t len) {
    size_t end = b + len;
    while (b < end) {
      int pq = d_[b] >> 4, tq = d_[b] & 15;
      if (tq > 3) fail("quantization table id %d out of range (DQT)", tq);
      if (pq > 1) fail("bad quantization table precision %d (DQT)", pq);
      size_t size = pq ? 128 : 64;
      if (b + 1 + size > end) fail("bad DQT marker length");
      for (int i = 0; i < 64; i++) {
        int v = pq ? (d_[b + 1 + 2 * i] << 8) | d_[b + 2 + 2 * i] : d_[b + 1 + i];
        // libjpeg keeps the islow multiplier in a short
        qt_[tq][kNatural[i]] = int16_t(uint16_t(v));
      }
      qt_defined_[tq] = true;
      b += 1 + size;
    }
  }

  // libjpeg-turbo gives Motion-JPEG style files without DHT the standard
  // tables: the first time the entropy decoder starts, each undefined
  // table 0 and 1 is set to its standard counterpart.
  void standard_tables() {
    if (std_tables_) return;
    std_tables_ = true;
    for (int i = 0; i < 2; i++) {
      if (!dc_[i].defined) define_huff(dc_[i], kDcCounts[i], kDcSymbols);
      if (!ac_[i].defined) define_huff(ac_[i], kAcCounts[i], kAcSymbols[i]);
    }
  }

  void scan(size_t b, size_t len) {
    if (len < 1) fail("bad SOS marker length");
    int ns = u8(b);
    if (ns < 1 || ns > 4 || len < size_t(4 + 2 * ns)) fail("bad SOS marker (%d components)", ns);
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(b + 1 + 2 * i), t = u8(b + 2 + 2 * i);
      idx[i] = -1;
      for (int c = 0; c < nc_; c++)
        if (comp_[c].id == id) idx[i] = c;
      if (idx[i] < 0) fail("SOS names component id %d, which SOF does not", id);
      for (int j = 0; j < i; j++)
        if (idx[j] == idx[i]) fail("SOS names component id %d twice", id);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("Huffman table id out of range (SOS)");
    }
    int ss = u8(b + 1 + 2 * ns), se = u8(b + 2 + 2 * ns);
    int ah = u8(b + 3 + 2 * ns) >> 4, al = u8(b + 3 + 2 * ns) & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += comp_[idx[i]].h * comp_[idx[i]].v;
      if (blocks > 10) fail("too many blocks in an MCU (SOS)");
    }
    // latch each component's quantisation table at its first scan
    for (int i = 0; i < ns; i++) {
      Component& k = comp_[idx[i]];
      if (!k.latched) {
        if (!qt_defined_[k.tq]) fail("quantization table %d is not defined (DQT)", k.tq);
        std::memcpy(k.qt, qt_[k.tq], sizeof k.qt);
        k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
        k.latched = true;
      }
      k.scanned = true;
      k.dc_pred = 0;
    }
    standard_tables();
    enum Kind { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind = SEQ;
    if (progressive_) {
      bool bad = false;
      if (ss == 0) {
        bad = se != 0;
      } else {
        bad = ss > se || se > 63 || ns != 1;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("bad progressive scan (Ss=%d Se=%d Ah=%d Al=%d)", ss, se, ah, al);
      for (int i = 0; i < ns; i++) {
        Component& k = comp_[idx[i]];
        if (ss > 0 && k.coef_bits[0] < 0)
          fail("bogus progression: AC scan before DC (component %d)", idx[i]);
        for (int c = ss; c <= se; c++) {
          int expected = k.coef_bits[c] < 0 ? 0 : k.coef_bits[c];
          if (ah != expected)
            fail("bogus progression: component %d coefficient %d (Ah=%d)", idx[i], c, ah);
          k.coef_bits[c] = al;
        }
      }
      kind = ss == 0 ? (ah == 0 ? DC_FIRST : DC_REFINE) : (ah == 0 ? AC_FIRST : AC_REFINE);
    }
    // build the tables this scan uses
    for (int i = 0; i < ns; i++) {
      bool need_dc = kind == SEQ || kind == DC_FIRST;
      bool need_ac = kind == SEQ || kind == AC_FIRST || kind == AC_REFINE;
      if (need_dc) {
        if (!dc_[td[i]].defined) fail("Huffman table DC%d is not defined (DHT)", td[i]);
        if (!dc_[td[i]].built) build_huff(dc_[td[i]], true);
      }
      if (need_ac) {
        if (!ac_[ta[i]].defined) fail("Huffman table AC%d is not defined (DHT)", ta[i]);
        if (!ac_[ta[i]].built) build_huff(ac_[ta[i]], false);
      }
    }
    scans_++;

    bits_.start(d_, n_, pos_);
    eobrun_ = 0;
    int restarts_left = restart_interval_;
    int next_rst = 0;
    auto restart = [&]() {
      // discard the bits left in the buffer and read RSTn
      pos_ = bits_.pos;
      int m = next_marker();
      if (m != 0xD0 + next_rst)
        fail("expected RST%d marker, found 0xFF%02X (corrupt file)", next_rst, m);
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; i++) comp_[idx[i]].dc_pred = 0;
      eobrun_ = 0;
      bits_.start(d_, n_, pos_);
      restarts_left = restart_interval_;
    };
    auto one_block = [&](Component& k, int t, int by, int bx) {
      int16_t* blk = k.block(by, bx);
      switch (kind) {
        case SEQ: seq_block(k, dc_[td[t]], ac_[ta[t]], blk); break;
        case DC_FIRST: dc_first(k, dc_[td[t]], blk, al); break;
        case DC_REFINE: if (bits_.get(1)) blk[0] = int16_t(blk[0] | (1 << al)); break;
        case AC_FIRST: ac_first(ac_[ta[t]], blk, ss, se, al); break;
        case AC_REFINE: ac_refine(ac_[ta[t]], blk, ss, se, al); break;
      }
    };
    if (ns == 1) {
      Component& k = comp_[idx[0]];
      for (int by = 0; by < k.hib; by++)
        for (int bx = 0; bx < k.wib; bx++) {
          if (restart_interval_) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          one_block(k, 0, by, bx);
          bits_.check();
        }
    } else {
      for (int my = 0; my < mcuy_; my++)
        for (int mx = 0; mx < mcux_; mx++) {
          if (restart_interval_) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          for (int i = 0; i < ns; i++) {
            Component& k = comp_[idx[i]];
            for (int y = 0; y < k.v; y++)
              for (int x = 0; x < k.h; x++) one_block(k, i, my * k.v + y, mx * k.h + x);
          }
          bits_.check();
        }
    }
    pos_ = bits_.pos;
  }

  void seq_block(Component& k, const Huff& dc, const Huff& ac, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = decode_symbol(bits_, dc);
    int diff = s ? extend(bits_.get(s), s) : 0;
    k.dc_pred += diff;
    blk[0] = int16_t(k.dc_pred);
    for (int i = 1; i < 64; i++) {
      int rs = decode_symbol(bits_, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) fail("bad coefficient index in the entropy-coded data (corrupt file)");
        blk[kNatural[i]] = int16_t(extend(bits_.get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void dc_first(Component& k, const Huff& dc, int16_t* blk, int al) {
    int s = decode_symbol(bits_, dc);
    int diff = s ? extend(bits_.get(s), s) : 0;
    k.dc_pred += diff;
    blk[0] = int16_t(k.dc_pred * (1 << al));
  }

  void ac_first(const Huff& ac, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    for (int i = ss; i <= se; i++) {
      int rs = decode_symbol(bits_, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        if (i > se) fail("bad coefficient index in the entropy-coded data (corrupt file)");
        blk[kNatural[i]] = int16_t(extend(bits_.get(s), s) * (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits_.get(r);
        eobrun_--;
        break;
      }
    }
  }

  void ac_refine(const Huff& ac, int16_t* blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& c) {
      if (bits_.get(1) && (c & p1) == 0) c = int16_t(c >= 0 ? c + p1 : c + m1);
    };
    if (eobrun_ == 0) {
      for (; k <= se; k++) {
        int rs = decode_symbol(bits_, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("bad Huffman symbol in a refinement scan (corrupt file)");
          s = bits_.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += bits_.get(r);
          break;
        }
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > se) fail("bad coefficient index in the entropy-coded data (corrupt file)");
          blk[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; k++) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) correct(c);
      }
      eobrun_--;
    }
  }

  void finish_check() {
    for (int c = 0; c < nc_; c++) {
      const Component& k = comp_[c];
      if (!k.scanned) fail("component %d has no scan (truncated or corrupt file)", c);
      if (progressive_)
        for (int i = 0; i < 64; i++)
          if (k.coef_bits[i] != 0)
            fail("progressive scans leave coefficient bits unknown (component %d, "
                 "coefficient %d): libjpeg would smooth these blocks",
                 c, i);
    }
  }

  // jpeg_idct_islow as libjpeg-turbo's x86 SIMD code (SSE2, AVX2) computes
  // it, into an 8 x 8 tile of `out` (row stride `stride`).  The
  // dequantised coefficients and the pass-1 results are 16-bit lanes: the
  // products and the sums ahead of the multiplies wrap, the descaled
  // results saturate, and the output is clamped to 0..255 (where the C
  // code's range-limit table would wrap).  For coefficients whose
  // dequantised values fit in 16 bits this is the C code's arithmetic.
  // A block whose rows 1..7 of coefficients are all zero takes the DC
  // shortcut of pass 1 (a 16-bit shift).
  static void idct(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    int16_t dq[64], ws[64];
    bool ac_zero = true;
    for (int i = 0; i < 64; i++) {
      dq[i] = wrap16(int32_t(in[i]) * q[i]);
      if (i >= 8 && in[i] != 0) ac_zero = false;
    }
    int32_t v[8];
    if (ac_zero) {
      for (int c = 0; c < 8; c++)
        for (int r = 0; r < 8; r++) ws[8 * r + c] = wrap16(int32_t(dq[c]) * 4);
    } else {
      for (int c = 0; c < 8; c++) {
        int16_t x[8];
        for (int r = 0; r < 8; r++) x[r] = dq[8 * r + c];
        simd_pass(x, kConstBits - kPass1Bits, v);
        for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(v[r]);
      }
    }
    for (int r = 0; r < 8; r++) {
      simd_pass(ws + 8 * r, kConstBits + kPass1Bits + 3, v);
      uint8_t* op = out + size_t(r) * stride;
      for (int c = 0; c < 8; c++)
        op[c] = uint8_t(std::min(std::max(v[c], -128), 127) + 128);
    }
  }

  // one component at full resolution, H x W
  std::vector<uint8_t> full_plane(Component& k) {
    int pw = k.wib * 8, ph = k.hib * 8;
    std::vector<uint8_t> plane(size_t(pw) * ph);
    for (int by = 0; by < k.hib; by++)
      for (int bx = 0; bx < k.wib; bx++)
        idct(k.block(by, bx), k.qt, &plane[size_t(by) * 8 * pw + bx * 8], pw);
    int hr = maxh_ / k.h, vr = maxv_ / k.v;
    std::vector<uint8_t> out(size_t(W_) * H_);
    auto row = [&](int y) {  // downsampled row y, edges replicated
      y = std::min(std::max(y, 0), k.dh - 1);
      return &plane[size_t(y) * pw];
    };
    std::vector<uint8_t> tmp(size_t(2) * k.dw + 2);
    for (int y = 0; y < H_; y++) {
      uint8_t* o = &out[size_t(y) * W_];
      if (hr == 1 && vr == 1) {
        std::memcpy(o, row(y), size_t(W_));
        continue;
      }
      if (vr == 1) {  // h2v1
        const uint8_t* in = row(y);
        if (k.dw > 2) {
          uint8_t* t = tmp.data();
          int v0 = in[0];
          t[0] = uint8_t(v0);
          t[1] = uint8_t((v0 * 3 + in[1] + 2) >> 2);
          for (int c = 1; c < k.dw - 1; c++) {
            int v = in[c] * 3;
            t[2 * c] = uint8_t((v + in[c - 1] + 1) >> 2);
            t[2 * c + 1] = uint8_t((v + in[c + 1] + 2) >> 2);
          }
          int last = k.dw - 1;
          t[2 * last] = uint8_t((in[last] * 3 + in[last - 1] + 1) >> 2);
          t[2 * last + 1] = in[last];
          std::memcpy(o, t, size_t(W_));
        } else {
          for (int x = 0; x < W_; x++) o[x] = in[x >> 1];
        }
        continue;
      }
      // vr == 2: output row y is the nearer input row y / 2, with the row
      // above (even y) or below (odd y) as the farther one
      const uint8_t* in0 = row(y >> 1);
      const uint8_t* in1 = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      if (hr == 1) {  // h1v2
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W_; x++) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
        continue;
      }
      if (k.dw <= 2) {  // h2v2 without context: replication
        for (int x = 0; x < W_; x++) o[x] = in0[x >> 1];
        continue;
      }
      uint8_t* t = tmp.data();
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      t[0] = uint8_t((this_sum * 4 + 8) >> 4);
      t[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 1; c < k.dw - 1; c++) {
        next_sum = in0[c + 1] * 3 + in1[c + 1];
        t[2 * c] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        t[2 * c + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      int last = k.dw - 1;
      t[2 * last] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      t[2 * last + 1] = uint8_t((this_sum * 4 + 7) >> 4);
      std::memcpy(o, t, size_t(W_));
    }
    return out;
  }

  void output(uint8_t* rgb) {
    size_t n = size_t(W_) * H_;
    if (nc_ == 1) {
      std::vector<uint8_t> g = full_plane(comp_[0]);
      for (size_t i = 0; i < n; i++) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p0 = full_plane(comp_[0]), p1 = full_plane(comp_[1]),
                         p2 = full_plane(comp_[2]);
    bool ycc = true;
    if (!jfif_ && adobe_) {
      ycc = adobe_transform_ != 0;
    } else if (!jfif_) {
      ycc = !(comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B');
    }
    if (!ycc) {
      for (size_t i = 0; i < n; i++) {
        rgb[3 * i] = p0[i];
        rgb[3 * i + 1] = p1[i];
        rgb[3 * i + 2] = p2[i];
      }
      return;
    }
    const Tables& t = tables();
    for (size_t i = 0; i < n; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      rgb[3 * i] = clamp255(y + t.cr_r[cr]);
      rgb[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      rgb[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// encoding
// ---------------------------------------------------------------------------

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
};

HuffCode make_codes(const uint8_t* counts, const uint8_t* symbols) {
  HuffCode h;
  std::memset(h.size, 0, sizeof h.size);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < counts[l - 1]; i++, k++, code++) {
      h.code[symbols[k]] = uint16_t(code);
      h.size[symbols[k]] = uint8_t(l);
    }
    code <<= 1;
  }
  return h;
}

class BitWriter {
 public:
  std::vector<uint8_t>& out;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((uint32_t(1) << size) - 1));
    cnt_ += size;
    while (cnt_ >= 8) {
      uint8_t b = uint8_t(acc_ >> (cnt_ - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt_ -= 8;
    }
  }
  void flush() { put(0x7F, 7); cnt_ = 0; acc_ = 0; }

 private:
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

// jpeg_fdct_islow on (sample - 128) values, in place
void fdct(int32_t* data) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = data + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541196100;
    const int sh = kConstBits - kPass1Bits;
    p[2] = int32_t(descale(z1 + tmp13 * F0_765366865, sh));
    p[6] = int32_t(descale(z1 + tmp12 * -F1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp4 *= F0_298631336;
    tmp5 *= F2_053119869;
    tmp6 *= F3_072711026;
    tmp7 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int32_t(descale(tmp4 + z1 + z3, sh));
    p[5] = int32_t(descale(tmp5 + z2 + z4, sh));
    p[3] = int32_t(descale(tmp6 + z2 + z3, sh));
    p[1] = int32_t(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = int32_t(descale(z1 + tmp13 * F0_765366865, sh));
    p[48] = int32_t(descale(z1 + tmp12 * -F1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp4 *= F0_298631336;
    tmp5 *= F2_053119869;
    tmp6 *= F3_072711026;
    tmp7 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int32_t(descale(tmp4 + z1 + z3, sh));
    p[40] = int32_t(descale(tmp5 + z2 + z4, sh));
    p[24] = int32_t(descale(tmp6 + z2 + z3, sh));
    p[8] = int32_t(descale(tmp7 + z1 + z4, sh));
  }
}

// libjpeg-turbo's reciprocal quantiser (16-bit DCTELEM) for divisor d
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor make_divisor(uint32_t d) {
  if (d == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(d);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / d, fr = (uint32_t(1) << r) % d;
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= d / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

inline int quantize(int32_t t, const Divisor& q) {
  uint32_t a = uint32_t(t < 0 ? -t : t);
  int v = int((uint64_t(a + q.corr) * q.recip) >> q.shift);
  return t < 0 ? -v : v;
}

// Pillow's default quality and luma sampling (4:2:0)
constexpr int kQuality = 75, kLumaSamp = 2;

// jpeg_set_quality(kQuality, TRUE)
void default_tables(uint16_t out[2][64]) {
  const int scale = 200 - kQuality * 2;
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long(kStdQuant[t][i]) * scale + 50) / 100;
      out[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
}

std::vector<uint8_t> encode(const uint8_t* rgb, int H, int W) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("image size %dx%d out of range", W, H);
  const int hs = kLumaSamp, vs = kLumaSamp;
  size_t n = size_t(H) * W;
  // colour conversion (jccolor.c rgb_ycc_convert)
  std::vector<uint8_t> ycc[3];
  for (auto& p : ycc) p.resize(n);
  const int64_t R_Y = fix16(0.29900), G_Y = fix16(0.58700), B_Y = fix16(0.11400),
                R_CB = fix16(0.16874), G_CB = fix16(0.33126), HALF_C = fix16(0.5),
                G_CR = fix16(0.41869), B_CR = fix16(0.08131);
  const int64_t one_half = int64_t(1) << 15, offset = int64_t(128) << 16;
  for (size_t i = 0; i < n; i++) {
    int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ycc[0][i] = uint8_t((R_Y * r + G_Y * g + B_Y * b + one_half) >> 16);
    ycc[1][i] = uint8_t((-R_CB * r - G_CB * g + HALF_C * b + offset + one_half - 1) >> 16);
    ycc[2][i] = uint8_t((HALF_C * r - G_CR * g - B_CR * b + offset + one_half - 1) >> 16);
  }
  const int hsamp[3] = {hs, 1, 1}, vsamp[3] = {vs, 1, 1};
  const int mcux = (W + 8 * hs - 1) / (8 * hs), mcuy = (H + 8 * vs - 1) / (8 * vs);
  const int group_rows = (H + vs - 1) / vs * vs;  // rows after the last group is padded
  uint16_t qt[2][64];
  default_tables(qt);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = make_divisor(uint32_t(qt[t][i]) << 3);

  // downsampled, edge-expanded planes and their quantised blocks
  struct Plane {
    int wib, hib, cols, rows;
    std::vector<uint8_t> px;
    std::vector<int16_t> coef;  // natural order, bw x bh blocks
    int bw, bh;
  } plane[3];
  for (int c = 0; c < 3; c++) {
    Plane& p = plane[c];
    int he = hs / hsamp[c], ve = vs / vsamp[c];
    p.wib = int((int64_t(W) * hsamp[c] + 8 * hs - 1) / (8 * hs));
    p.hib = int((int64_t(H) * vsamp[c] + 8 * vs - 1) / (8 * vs));
    p.cols = p.wib * 8;
    p.rows = mcuy * vsamp[c] * 8;
    p.px.assign(size_t(p.cols) * p.rows, 0);
    const std::vector<uint8_t>& src = ycc[c];
    // full-resolution row y with the right edge replicated out to
    // cols * he columns, and the bottom group padded with the last row
    auto sample = [&](int y, int x) {
      y = std::min(y, H - 1);
      x = std::min(x, W - 1);
      return int(src[size_t(y) * W + x]);
    };
    int drows = group_rows / ve;  // downsampled rows before the iMCU padding
    for (int y = 0; y < drows; y++) {
      uint8_t* o = &p.px[size_t(y) * p.cols];
      if (he == 1) {  // luma: a copy
        for (int x = 0; x < p.cols; x++) o[x] = uint8_t(sample(y, x));
      } else {  // chroma: h2v2_downsample
        int bias = 1;
        for (int x = 0; x < p.cols; x++, bias ^= 3)
          o[x] = uint8_t((sample(2 * y, 2 * x) + sample(2 * y, 2 * x + 1) +
                          sample(2 * y + 1, 2 * x) + sample(2 * y + 1, 2 * x + 1) + bias) >> 2);
      }
    }
    for (int y = drows; y < p.rows; y++)
      std::memcpy(&p.px[size_t(y) * p.cols], &p.px[size_t(drows - 1) * p.cols], size_t(p.cols));
    p.bw = mcux * hsamp[c];
    p.bh = mcuy * vsamp[c];
    p.coef.assign(size_t(p.bw) * p.bh * 64, 0);
    const Divisor* dv = div[c == 0 ? 0 : 1];
    int32_t ws[64];
    for (int by = 0; by < p.hib; by++)
      for (int bx = 0; bx < p.wib; bx++) {
        for (int r = 0; r < 8; r++)
          for (int x = 0; x < 8; x++)
            ws[8 * r + x] = int32_t(p.px[size_t(by * 8 + r) * p.cols + bx * 8 + x]) - 128;
        fdct(ws);
        int16_t* blk = &p.coef[(size_t(by) * p.bw + bx) * 64];
        for (int i = 0; i < 64; i++) blk[i] = int16_t(quantize(ws[i], dv[i]));
      }
  }

  std::vector<uint8_t> out;
  out.reserve(n / 2 + 1024);
  auto put16 = [&](int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 255));
  };
  const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                              0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), soi_app0, soi_app0 + sizeof soi_app0);
  for (int t = 0; t < 2; t++) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(67);
    out.push_back(uint8_t(t));
    for (int i = 0; i < 64; i++) out.push_back(uint8_t(qt[t][kNatural[i]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(17);
  out.push_back(8);
  put16(H);
  put16(W);
  out.push_back(3);
  for (int c = 0; c < 3; c++) {
    out.push_back(uint8_t(c + 1));
    out.push_back(uint8_t((hsamp[c] << 4) | vsamp[c]));
    out.push_back(uint8_t(c == 0 ? 0 : 1));
  }
  for (int t = 0; t < 2; t++) {
    for (int ac = 0; ac < 2; ac++) {
      const uint8_t* counts = ac ? kAcCounts[t] : kDcCounts[t];
      const uint8_t* syms = ac ? kAcSymbols[t] : kDcSymbols;
      int ns = 0;
      for (int i = 0; i < 16; i++) ns += counts[i];
      out.push_back(0xFF);
      out.push_back(0xC4);
      put16(2 + 17 + ns);
      out.push_back(uint8_t((ac << 4) | t));
      out.insert(out.end(), counts, counts + 16);
      out.insert(out.end(), syms, syms + ns);
    }
  }
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                         0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  out.insert(out.end(), sos, sos + sizeof sos);

  HuffCode dcc[2] = {make_codes(kDcCounts[0], kDcSymbols), make_codes(kDcCounts[1], kDcSymbols)};
  HuffCode acc[2] = {make_codes(kAcCounts[0], kAcSymbols[0]),
                     make_codes(kAcCounts[1], kAcSymbols[1])};
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  auto encode_block = [&](const int16_t* blk, int c) {
    const HuffCode& dh = dcc[c == 0 ? 0 : 1];
    const HuffCode& ah = acc[c == 0 ? 0 : 1];
    int temp = blk[0] - last_dc[c], temp2 = temp;
    last_dc[c] = blk[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    if (nbits > 11) fail("DC coefficient out of range");
    bw.put(dh.code[nbits], dh.size[nbits]);
    if (nbits) bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(ah.code[0xF0], ah.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      if (nbits > 10) fail("AC coefficient out of range");
      int s = (r << 4) + nbits;
      bw.put(ah.code[s], ah.size[s]);
      bw.put(uint32_t(temp2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(ah.code[0], ah.size[0]);
  };
  int16_t dummy[64];
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++)
      for (int c = 0; c < 3; c++) {
        Plane& p = plane[c];
        const int16_t* prev = nullptr;  // the MCU's previous block of c
        for (int y = 0; y < vsamp[c]; y++)
          for (int x = 0; x < hsamp[c]; x++) {
            int by = my * vsamp[c] + y, bx = mx * hsamp[c] + x;
            int16_t* blk = &p.coef[(size_t(by) * p.bw + bx) * 64];
            if (by >= p.hib) {
              // a dummy row: the DC of the last block of the row above
              const int16_t* above = &p.coef[(size_t(by - 1) * p.bw + mx * hsamp[c] +
                                              hsamp[c] - 1) * 64];
              std::memset(dummy, 0, sizeof dummy);
              dummy[0] = above[0];
              std::memcpy(blk, dummy, sizeof dummy);
            } else if (bx >= p.wib) {
              std::memset(dummy, 0, sizeof dummy);
              dummy[0] = prev[0];
              std::memcpy(blk, dummy, sizeof dummy);
            }
            encode_block(blk, c);
            prev = blk;
          }
      }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// hw_c[0..2] = height, width, components.  0, or -1 with `err` set.
int jpeg_codec_probe(const uint8_t* data, int64_t size, int32_t* hw_c, char* err, int errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.header_only();
    hw_c[0] = dec.height();
    hw_c[1] = dec.width();
    hw_c[2] = dec.components();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// `rgb` holds height * width * 3 bytes (from jpeg_codec_probe).
int jpeg_codec_decode(const uint8_t* data, int64_t size, uint8_t* rgb, int64_t rgb_size,
                      char* err, int errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.header_only();
    if (int64_t(dec.height()) * dec.width() * 3 != rgb_size) fail("output buffer size mismatch");
    Decoder full(data, size_t(size));
    full.decode(rgb);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// Encodes height x width RGB at Pillow's defaults.  Returns the file's
// size; when it exceeds `capacity` nothing is copied and the caller
// retries with that size.  -1 with `err` set on failure.
int64_t jpeg_codec_encode(const uint8_t* rgb, int32_t height, int32_t width, uint8_t* out,
                          int64_t capacity, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(rgb, height, width);
    if (int64_t(bytes.size()) <= capacity) std::memcpy(out, bytes.data(), bytes.size());
    return int64_t(bytes.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
