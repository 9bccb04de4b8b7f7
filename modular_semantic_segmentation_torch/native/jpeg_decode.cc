// JPEG decoding equal to cv2.imread's: libjpeg-turbo 3.1 with the
// defaults that OpenCV leaves alone, in plain C++17 without libjpeg.
//
// What it reads: SOF0 (baseline), SOF1 (extended sequential) and SOF2
// (progressive) Huffman files of 8-bit precision with one or three
// components, any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0,
// 4:1:1 among them), restart intervals, optimised Huffman tables, and the
// standard tables where a file leaves out its DHT (Motion JPEG), as
// libjpeg-turbo supplies them. What it computes, stage by stage, is what
// libjpeg-turbo computes:
//
// * the accurate integer IDCT (jidctint.c, JDCT_ISLOW), with its
//   post-IDCT range-limit table;
// * "fancy" triangle upsampling of subsampled components where libjpeg
//   does it (h2v1 and h2v2 when the component is wider than 2 samples,
//   h1v2), and replication where it does not (h4v1 and every other
//   integral factor; h2v1 and h2v2 of components 1 or 2 samples wide),
//   with the last real row and column repeated at the edges
//   (jdsample.c, jdmainct.c);
// * the fixed-point YCbCr -> BGR tables of jdcolor.c (JCS_EXT_BGR); gray
//   output (JCS_GRAYSCALE) as the Y component of YCbCr, and through
//   jdcolor.c's rgb_gray table from an RGB file;
// * libjpeg's colour-space rule (jdapimin.c): a JFIF APP0 means YCbCr,
//   else an Adobe APP14 transform (0: RGB, else YCbCr), else component
//   ids 'R' 'G' 'B' mean RGB, else YCbCr.
//
// A progressive file is decoded completely before its output (as libjpeg
// does when it is not asked for buffered-image output). libjpeg smooths
// the blocks of a progressive file only while some of the first ten
// coefficients of a component remain inexact; for such an incomplete
// file this decoder refuses rather than smoothing. A complete file gets
// no smoothing in either.
//
// Refused with an error code, never a crash: arithmetic coding (SOF9 -
// SOF15), lossless (SOF3) and hierarchical files, precisions other than
// 8 bits, component counts other than 1 and 3 (CMYK / YCCK among them),
// non-integral sampling ratios, entropy data that runs out before the
// last block or holds a code no table has, a missing restart marker, a
// missing EOI, and any marker segment whose length runs past the buffer.
// libjpeg decodes truncated and corrupt entropy data with a warning and
// gray-filled blocks; this decoder does not. Every read is bounds-checked.
//
// Also here: the orientation tag (0x0112) of the first EXIF APP1 segment,
// parsed as OpenCV's ExifReader parses it, for the caller to apply.
//
// A plain C interface, loaded with ctypes by datasets/native_backend.py,
// which compiles this file with native/host_ops.cc into one library.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2, kNoMemory = 3 };

struct DecodeError {
  Status status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& message) {
  throw DecodeError{kCorrupt, message};
}

[[noreturn]] void unsupported(const std::string& message) {
  throw DecodeError{kUnsupported, message};
}

// jpeg_natural_order with libjpeg's 16 extra entries, so that a corrupt
// run that overshoots coefficient 63 lands on 63, as in libjpeg
const uint8_t kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the standard Huffman tables of the JPEG specification (Annex K.3),
// which libjpeg-turbo installs in slots 0 and 1 that a file leaves empty
const uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcVals[2][162] = {
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

constexpr int kLookahead = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: number of codes of length l
  uint8_t vals[256] = {};
  // derived as jpeg_make_d_derived_tbl derives them
  bool built = false;
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // the next kLookahead bits -> (code length << 8) | symbol; 0 for codes
  // longer than kLookahead bits
  uint16_t look[1 << kLookahead] = {};
};

void set_table(HuffTable& t, const uint8_t* bits16, const uint8_t* vals,
               int count) {
  t.defined = true;
  t.built = false;
  t.bits[0] = 0;
  std::memcpy(t.bits + 1, bits16, 16);
  std::memset(t.vals, 0, sizeof(t.vals));
  std::memcpy(t.vals, vals, count);
}

void build_table(HuffTable& t, bool dc) {
  if (t.built) return;
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = t.bits[l];
    if (p + i > 256) corrupt("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int count = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    // no code may be all ones
    if (static_cast<uint64_t>(code) >= (uint64_t{1} << si))
      corrupt("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      uint32_t lookbits = huffcode[p] << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr)
        t.look[lookbits++] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < count; ++i)
      if (t.vals[i] > 15) corrupt("bad Huffman table (DC symbol > 15)");
  }
  t.built = true;
}

// Entropy-coded data: bytes with FF 00 stuffing, ended by a marker. Past
// the marker (or the buffer's end) it supplies zero bits and counts them,
// so that a scan that consumed any of them is known to have run out.
struct BitReader {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;       // next byte to read; at a marker, its FF
  uint64_t buf = 0;     // left-aligned
  int bits = 0;
  bool at_marker = false;
  int64_t pad_bits = 0;  // zero bits supplied past the end of the data

  void start(const uint8_t* d, size_t n, size_t p) {
    data = d;
    size = n;
    pos = p;
    buf = 0;
    bits = 0;
    at_marker = false;
    pad_bits = 0;
  }

  void refill() {
    while (bits <= 56) {
      uint64_t c = 0;
      if (!at_marker) {
        if (pos >= size) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          c = data[pos++];
        } else {
          // FF 00 is a data FF; libjpeg also takes FF FF ... FF 00 so
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;
          if (q < size && data[q] == 0) {
            c = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;
          }
        }
      }
      if (at_marker) pad_bits += 8;
      buf |= c << (56 - bits);
      bits += 8;
    }
  }

  inline unsigned peek(int k) {
    if (bits < k) refill();
    return static_cast<unsigned>(buf >> (64 - k));
  }
  inline void skip(int k) {
    buf <<= k;
    bits -= k;
  }
  inline unsigned get(int k) {
    const unsigned v = peek(k);
    skip(k);
    return v;
  }
  bool overrun() const { return pad_bits > bits; }

  inline int decode(const HuffTable& t) {
    const unsigned look = peek(16) >> (16 - kLookahead);
    const int entry = t.look[look];
    if (entry) {
      skip(entry >> 8);
      return entry & 0xFF;
    }
    const unsigned bits16 = peek(16);
    for (int l = kLookahead + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(bits16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        const int32_t index = code + t.valoffset[l];
        if (index < 0 || index > 255) corrupt("bad Huffman table");
        return t.vals[index];
      }
    }
    corrupt("corrupt entropy data (bad Huffman code)");
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + static_cast<int>((~0u << s) + 1) : v;
}

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;
  bool latched = false;
  int16_t quant[64] = {};  // natural order, as libjpeg's ISLOW_MULT_TYPE
  int width_in_blocks = 0, height_in_blocks = 0;
  int blocks_w = 0, blocks_h = 0;  // of the coefficient buffer (MCU-padded)
  int ds_w = 0, ds_h = 0;          // downsampled size in samples
  std::vector<int16_t> coef;       // blocks_h x blocks_w x 64
  int coef_bits[64];               // progressive: last Al per coefficient
  int dc_pred = 0;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * blocks_w + bx) * 64;
  }
};

struct Header {
  int height = 0, width = 0;
  int ncomp = 0;
  bool progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int orientation = 0;  // 0: no EXIF orientation tag
  bool saw_exif = false;
};

int read_u16(const uint8_t* p, bool little) {
  return little ? p[0] | (p[1] << 8) : (p[0] << 8) | p[1];
}

uint32_t read_u32(const uint8_t* p, bool little) {
  return little ? p[0] | (p[1] << 8) | (p[2] << 16) |
                      (static_cast<uint32_t>(p[3]) << 24)
                : (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) |
                      (p[2] << 8) | p[3];
}

// OpenCV's ExifReader on the TIFF data after "Exif\0\0": the byte order
// ("II" little-endian, else big-endian), the 0x2A mark, the first IFD's
// entries in order; the orientation entry's value is the 16-bit word at
// its offset + 8. Returns 0 where there is no such entry or the data end
// first.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 8) return 0;
  const bool little = d[0] == 'I' && d[1] == 'I';
  if (read_u16(d + 2, little) != 0x2A) return 0;
  const uint32_t ifd = read_u32(d + 4, little);
  if (static_cast<uint64_t>(ifd) + 2 > n) return 0;
  const int entries = read_u16(d + ifd, little);
  for (int e = 0; e < entries; ++e) {
    const uint64_t off = static_cast<uint64_t>(ifd) + 2 + 12 * e;
    if (off + 2 > n) return 0;
    if (read_u16(d + off, little) == 0x0112) {
      if (off + 10 > n) return 0;
      return read_u16(d + off + 8, little);
    }
  }
  return 0;
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // Parses the markers up to the first SOS (or up to the end, for a file
  // without one); leaves pos_ at the SOS marker.
  void read_header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8)
      corrupt("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      const int marker = next_marker();
      if (marker == 0xDA) {
        if (!saw_sof_) corrupt("SOS before SOF");
        check_size();
        return;
      }
      if (marker == 0xD9) corrupt("EOI before the first scan");
      handle_marker(marker);
    }
  }

  const Header& header() const { return hdr_; }

  // Decodes the scans from pos_ (at the first SOS) to EOI into the
  // coefficient buffers.
  void read_scans() {
    setup_components();
    bool first = true;
    for (;;) {
      const int marker = first ? 0xDA : next_marker();
      first = false;
      if (marker == 0xD9) break;
      if (marker == 0xDA) {
        read_scan();
      } else {
        handle_marker(marker);
      }
    }
    if (hdr_.progressive) check_no_smoothing();
  }

  // BGR (3 channels) or gray (1 channel) output, height x width.
  void output(bool gray, uint8_t* out) {
    const int W = hdr_.width, H = hdr_.height;
    const size_t plane = static_cast<size_t>(W) * H;
    const bool rgb_file = hdr_.ncomp == 3 && is_rgb();
    const int needed = (hdr_.ncomp == 1 || (gray && !rgb_file)) ? 1 : 3;
    std::vector<uint8_t> full(plane * needed);
    std::vector<uint8_t> samples;
    for (int ci = 0; ci < needed; ++ci) {
      Component& c = comp_[ci];
      samples.assign(static_cast<size_t>(c.width_in_blocks) * 8 *
                         c.height_in_blocks * 8,
                     0);
      inverse_dct(c, samples.data());
      upsample(c, samples.data(), full.data() + plane * ci);
    }
    if (needed == 1) {
      const uint8_t* y = full.data();
      if (gray) {
        std::memcpy(out, y, plane);
      } else {
        for (size_t i = 0; i < plane; ++i)
          out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    const uint8_t* p0 = full.data();
    const uint8_t* p1 = p0 + plane;
    const uint8_t* p2 = p1 + plane;
    if (rgb_file) {
      if (gray) {
        rgb_to_gray(p0, p1, p2, plane, out);
      } else {
        for (size_t i = 0; i < plane; ++i) {
          out[3 * i] = p2[i];
          out[3 * i + 1] = p1[i];
          out[3 * i + 2] = p0[i];
        }
      }
    } else {
      ycc_to_bgr(p0, p1, p2, plane, out);
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  Header hdr_;
  bool saw_sof_ = false;
  int precision_ = 8;
  std::vector<Component> comp_;
  int max_h_ = 1, max_v_ = 1;
  int mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0;
  bool qt_defined_[4] = {};
  uint16_t qt_[4][64] = {};  // natural order
  HuffTable dc_[4], ac_[4];

  int byte_at(size_t p) const {
    if (p >= n_) corrupt("premature end of JPEG file");
    return d_[p];
  }

  // libjpeg's next_marker: skips bytes up to an FF, swallows FF fill
  // bytes, and skips stuffed FF 00 pairs.
  int next_marker() {
    for (;;) {
      int c = byte_at(pos_++);
      while (c != 0xFF) c = byte_at(pos_++);
      do {
        c = byte_at(pos_++);
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // the body of the marker segment at pos_ (after its marker bytes);
  // advances pos_ past it
  std::pair<const uint8_t*, size_t> segment() {
    if (pos_ + 2 > n_) corrupt("premature end of JPEG file");
    const size_t length = (d_[pos_] << 8) | d_[pos_ + 1];
    if (length < 2) corrupt("bogus marker length");
    if (pos_ + length > n_)
      corrupt("marker segment runs past the end of the file");
    const uint8_t* body = d_ + pos_ + 2;
    pos_ += length;
    return {body, length - 2};
  }

  void handle_marker(int marker) {
    switch (marker) {
      case 0xC0:
      case 0xC1:
        read_sof(false);
        break;
      case 0xC2:
        read_sof(true);
        break;
      case 0xC3:
        unsupported("lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xC9: case 0xCA:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        unsupported("arithmetic-coded, hierarchical or lossless JPEG (SOF" +
                    std::to_string(marker - 0xC0) + ") is not supported");
      case 0xC4:
        read_dht();
        break;
      case 0xCC:  // DAC: arithmetic conditioning, unused without SOF9+
        segment();
        break;
      case 0xDB:
        read_dqt();
        break;
      case 0xDD:
        read_dri();
        break;
      case 0xE0:
        read_app0();
        break;
      case 0xE1:
        read_app1();
        break;
      case 0xEE:
        read_app14();
        break;
      case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6: case 0xE7:
      case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC: case 0xED:
      case 0xEF: case 0xFE: case 0xDC:  // APPn, COM, DNL
        segment();
        break;
      case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
      case 0xD5: case 0xD6: case 0xD7:
        break;  // TEM and stray RSTn carry no segment; libjpeg skips them
      case 0xD8:
        corrupt("duplicate SOI marker");
      default:
        corrupt("unknown JPEG marker 0x" + std::to_string(marker));
    }
  }

  void read_sof(bool progressive) {
    auto [b, len] = segment();
    if (saw_sof_) corrupt("duplicate SOF marker");
    if (len < 6) corrupt("bad SOF length");
    precision_ = b[0];
    hdr_.height = (b[1] << 8) | b[2];
    hdr_.width = (b[3] << 8) | b[4];
    hdr_.ncomp = b[5];
    if (hdr_.height <= 0 || hdr_.width <= 0 || hdr_.ncomp <= 0)
      corrupt("empty JPEG image (DNL not supported)");
    if (len != static_cast<size_t>(6 + 3 * hdr_.ncomp))
      corrupt("bad SOF length");
    if (precision_ != 8)
      unsupported(std::to_string(precision_) +
                  "-bit JPEG is not supported (only 8-bit)");
    if (hdr_.ncomp != 1 && hdr_.ncomp != 3)
      unsupported(std::to_string(hdr_.ncomp) +
                  "-component JPEG is not supported (only gray and "
                  "3-component colour)");
    comp_.assign(hdr_.ncomp, Component());
    for (int i = 0; i < hdr_.ncomp; ++i) {
      const uint8_t* p = b + 6 + 3 * i;
      comp_[i].id = p[0];
      comp_[i].h = p[1] >> 4;
      comp_[i].v = p[1] & 15;
      comp_[i].tq = p[2];
      if (comp_[i].h < 1 || comp_[i].h > 4 || comp_[i].v < 1 ||
          comp_[i].v > 4)
        corrupt("bogus sampling factors");
    }
    hdr_.progressive = progressive;
    saw_sof_ = true;
  }

  void read_dht() {
    auto [b, len] = segment();
    size_t p = 0;
    while (p < len) {
      if (p + 17 > len) corrupt("bad DHT length");
      const int index = b[p];
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += b[p + i];
      if (count > 256 || p + 17 + count > len) corrupt("bad Huffman table");
      const int slot = index & 0x0F;
      if ((index & 0xEF) >= 4 || slot >= 4) corrupt("bad DHT index");
      HuffTable& t = (index & 0x10) ? ac_[slot] : dc_[slot];
      set_table(t, b + p + 1, b + p + 17, count);
      p += 17 + count;
    }
  }

  void read_dqt() {
    auto [b, len] = segment();
    size_t p = 0;
    while (p < len) {
      const int prec = b[p] >> 4, n = b[p] & 0x0F;
      ++p;
      if (n >= 4) corrupt("bad DQT index");
      if (prec > 1) corrupt("bad DQT precision");
      const size_t need = prec ? 128 : 64;
      if (p + need > len) corrupt("bad DQT length");
      for (int i = 0; i < 64; ++i) {
        const int value = prec ? (b[p + 2 * i] << 8) | b[p + 2 * i + 1]
                               : b[p + i];
        qt_[n][kNaturalOrder[i]] = static_cast<uint16_t>(value);
      }
      qt_defined_[n] = true;
      p += need;
    }
  }

  void read_dri() {
    auto [b, len] = segment();
    if (len != 2) corrupt("bad DRI length");
    restart_interval_ = (b[0] << 8) | b[1];
  }

  void read_app0() {
    auto [b, len] = segment();
    if (len >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) hdr_.saw_jfif = true;
  }

  void read_app14() {
    auto [b, len] = segment();
    if (len >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      hdr_.saw_adobe = true;
      hdr_.adobe_transform = b[11];
    }
  }

  void read_app1() {
    auto [b, len] = segment();
    if (hdr_.saw_exif) return;
    if (len >= 6 && std::memcmp(b, "Exif\0\0", 6) == 0) {
      hdr_.saw_exif = true;
      hdr_.orientation = exif_orientation(b + 6, len - 6);
    }
  }

  // every block of a complete file is coded with at least one bit (a DC
  // code), so a file claims more blocks than its bytes can hold only if
  // it is truncated or corrupt; refused before anything is allocated
  void check_size() const {
    int mh = 1, mv = 1;
    for (const Component& c : comp_) {
      mh = std::max(mh, c.h);
      mv = std::max(mv, c.v);
    }
    uint64_t blocks = 0;
    for (const Component& c : comp_) {
      const uint64_t bw = (uint64_t{1} * hdr_.width * c.h + 8 * mh - 1) /
                          (8 * mh);
      const uint64_t bh = (uint64_t{1} * hdr_.height * c.v + 8 * mv - 1) /
                          (8 * mv);
      blocks += bw * bh;
    }
    if (blocks > 8 * static_cast<uint64_t>(n_))
      corrupt("premature end of JPEG file (the frame holds more blocks "
              "than the file has bits)");
  }

  bool is_rgb() const {
    if (hdr_.saw_jfif) return false;
    if (hdr_.saw_adobe) return hdr_.adobe_transform == 0;
    return comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  }

  void setup_components() {
    // libjpeg-turbo fills the empty slots 0 and 1 with the standard tables
    for (int i = 0; i < 2; ++i) {
      if (!dc_[i].defined) set_table(dc_[i], kStdDcBits[i], kStdDcVals, 12);
      if (!ac_[i].defined) set_table(ac_[i], kStdAcBits[i], kStdAcVals[i],
                                     162);
    }
    for (const Component& c : comp_) {
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    const int64_t W = hdr_.width, H = hdr_.height;
    mcus_x_ = static_cast<int>((W + 8 * max_h_ - 1) / (8 * max_h_));
    mcus_y_ = static_cast<int>((H + 8 * max_v_ - 1) / (8 * max_v_));
    for (Component& c : comp_) {
      if (max_h_ % c.h || max_v_ % c.v)
        unsupported("non-integral sampling ratio");
      c.ds_w = static_cast<int>((W * c.h + max_h_ - 1) / max_h_);
      c.ds_h = static_cast<int>((H * c.v + max_v_ - 1) / max_v_);
      c.width_in_blocks =
          static_cast<int>((W * c.h + 8 * max_h_ - 1) / (8 * max_h_));
      c.height_in_blocks =
          static_cast<int>((H * c.v + 8 * max_v_ - 1) / (8 * max_v_));
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
      c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }

  void latch_quant(Component& c) {
    if (c.latched) return;
    if (c.tq >= 4 || !qt_defined_[c.tq])
      corrupt("quantization table " + std::to_string(c.tq) +
              " is not defined");
    for (int i = 0; i < 64; ++i) c.quant[i] = static_cast<int16_t>(qt_[c.tq][i]);
    c.latched = true;
  }

  // the scan's parameters, as libjpeg's get_sos and start_pass read them
  struct Scan {
    int ncomp = 0;
    int comp[4] = {};
    int dc_tbl[4] = {}, ac_tbl[4] = {};
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  void read_scan() {
    auto [b, len] = segment();
    if (len < 1) corrupt("bad SOS length");
    Scan s;
    s.ncomp = b[0];
    if (len != static_cast<size_t>(4 + 2 * s.ncomp) || s.ncomp < 1 ||
        s.ncomp > 4)
      corrupt("bad SOS length");
    for (int i = 0; i < s.ncomp; ++i) {
      const int id = b[1 + 2 * i], tables = b[2 + 2 * i];
      int found = -1;
      for (int ci = 0; ci < hdr_.ncomp; ++ci)
        if (comp_[ci].id == id) found = ci;
      if (found < 0) corrupt("SOS names an unknown component");
      for (int j = 0; j < i; ++j)
        if (s.comp[j] == found) corrupt("SOS names a component twice");
      s.comp[i] = found;
      s.dc_tbl[i] = tables >> 4;
      s.ac_tbl[i] = tables & 15;
    }
    const uint8_t* q = b + 1 + 2 * s.ncomp;
    s.ss = q[0];
    s.se = q[1];
    s.ah = q[2] >> 4;
    s.al = q[2] & 15;
    if (s.ncomp > 1) {
      int blocks = 0;
      for (int i = 0; i < s.ncomp; ++i)
        blocks += comp_[s.comp[i]].h * comp_[s.comp[i]].v;
      if (blocks > 10) corrupt("sampling factors too large for an MCU");
    }
    for (int i = 0; i < s.ncomp; ++i) latch_quant(comp_[s.comp[i]]);
    if (hdr_.progressive) {
      const bool dc_band = s.ss == 0;
      bool bad = false;
      if (dc_band) {
        if (s.se != 0) bad = true;
      } else {
        if (s.ss > s.se || s.se > 63) bad = true;
        if (s.ncomp != 1) bad = true;
      }
      if (s.ah != 0 && s.al != s.ah - 1) bad = true;
      if (s.al > 13) bad = true;
      if (bad) corrupt("invalid progressive parameters");
      for (int i = 0; i < s.ncomp; ++i) {
        if (dc_band && s.ah == 0) table(dc_, s.dc_tbl[i], true);
        if (!dc_band) table(ac_, s.ac_tbl[i], false);
        for (int k = s.ss; k <= s.se; ++k) comp_[s.comp[i]].coef_bits[k] = s.al;
      }
    } else {
      for (int i = 0; i < s.ncomp; ++i) {
        table(dc_, s.dc_tbl[i], true);
        table(ac_, s.ac_tbl[i], false);
      }
    }
    decode_scan(s);
  }

  HuffTable& table(HuffTable* tables, int index, bool dc) {
    if (index >= 4 || !tables[index].defined)
      corrupt("Huffman table " + std::to_string(index) + " is not defined");
    build_table(tables[index], dc);
    return tables[index];
  }

  void decode_scan(const Scan& s) {
    BitReader br;
    br.start(d_, n_, pos_);
    for (int i = 0; i < s.ncomp; ++i) comp_[s.comp[i]].dc_pred = 0;
    unsigned eobrun = 0;
    int mcus_w, mcus_h;
    if (s.ncomp == 1) {
      const Component& c = comp_[s.comp[0]];
      mcus_w = c.width_in_blocks;
      mcus_h = c.height_in_blocks;
    } else {
      mcus_w = mcus_x_;
      mcus_h = mcus_y_;
    }
    const int64_t total = static_cast<int64_t>(mcus_w) * mcus_h;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        restart(br, next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < s.ncomp; ++i) comp_[s.comp[i]].dc_pred = 0;
        eobrun = 0;
      }
      const int my = static_cast<int>(m / mcus_w);
      const int mx = static_cast<int>(m % mcus_w);
      if (s.ncomp == 1) {
        decode_block(br, s, 0, comp_[s.comp[0]].block(my, mx), eobrun);
      } else {
        for (int i = 0; i < s.ncomp; ++i) {
          Component& c = comp_[s.comp[i]];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h)
              decode_block(br, s, i, c.block(my * c.v + v, mx * c.h + h),
                           eobrun);
        }
      }
    }
    if (br.overrun())
      corrupt("premature end of JPEG file (entropy data ran out)");
    pos_ = br.pos;
  }

  // the restart marker RST(num) must come next: libjpeg resyncs with a
  // warning where it does not, this decoder refuses
  void restart(BitReader& br, int num) {
    if (br.overrun())
      corrupt("premature end of JPEG file (entropy data ran out)");
    pos_ = br.pos;
    size_t p = pos_;
    // skip to the marker, as libjpeg's next_marker does
    int c = byte_at(p++);
    while (c != 0xFF) c = byte_at(p++);
    do {
      c = byte_at(p++);
    } while (c == 0xFF);
    if (c != 0xD0 + num) corrupt("restart marker missing or out of order");
    br.start(d_, n_, p);
  }

  void decode_block(BitReader& br, const Scan& s, int i, int16_t* blk,
                    unsigned& eobrun) {
    Component& c = comp_[s.comp[i]];
    if (!hdr_.progressive) {
      const HuffTable& dct = dc_[s.dc_tbl[i]];
      const HuffTable& act = ac_[s.ac_tbl[i]];
      int t = br.decode(dct);
      int diff = t ? extend(static_cast<int>(br.get(t)), t) : 0;
      // libjpeg-turbo adds in unsigned arithmetic, wrapping as it does
      c.dc_pred = static_cast<int>(static_cast<unsigned>(c.dc_pred) +
                                   static_cast<unsigned>(diff));
      blk[0] = static_cast<int16_t>(c.dc_pred);
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(act);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          const int v = extend(static_cast<int>(br.get(sz)), sz);
          blk[kNaturalOrder[k]] = static_cast<int16_t>(v);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {  // DC band
      if (s.ah == 0) {
        const int t = br.decode(dc_[s.dc_tbl[i]]);
        const int diff = t ? extend(static_cast<int>(br.get(t)), t) : 0;
        if ((c.dc_pred >= 0 && diff > INT_MAX - c.dc_pred) ||
            (c.dc_pred < 0 && diff < INT_MIN - c.dc_pred))
          corrupt("DC coefficient out of range");
        c.dc_pred += diff;
        blk[0] = static_cast<int16_t>(
            static_cast<unsigned>(c.dc_pred) << s.al);
      } else {
        if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << s.al));
      }
      return;
    }
    const HuffTable& act = ac_[s.ac_tbl[i]];
    if (s.ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = s.ss; k <= s.se; ++k) {
        const int rs = br.decode(act);
        int r = rs >> 4;
        const int sz = rs & 15;
        if (sz) {
          k += r;
          const int v = extend(static_cast<int>(br.get(sz)), sz);
          blk[kNaturalOrder[k]] =
              static_cast<int16_t>(static_cast<unsigned>(v) << s.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << s.al;
    const int m1 = -1 * (1 << s.al);
    int k = s.ss;
    if (eobrun == 0) {
      for (; k <= s.se; ++k) {
        const int rs = br.decode(act);
        int r = rs >> 4;
        int sz = rs & 15;
        if (sz) {
          sz = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) {
                *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                        : *coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= s.se);
        if (sz) blk[kNaturalOrder[k]] = static_cast<int16_t>(sz);
      }
    }
    if (eobrun > 0) {
      for (; k <= s.se; ++k) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) {
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                      : *coef + m1);
            }
          }
        }
      }
      --eobrun;
    }
  }

  // libjpeg's smoothing_ok (jdcoefct.c, SAVED_COEFS = 10): a progressive
  // file whose first ten coefficients are not all exact in every
  // component gets block smoothing, which this decoder does not do
  void check_no_smoothing() {
    for (const Component& c : comp_) {
      if (!c.latched) return;
      for (int k = 0; k < 10; ++k)
        if (c.quant[kNaturalOrder[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
    }
    for (const Component& c : comp_)
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          unsupported("incomplete progressive JPEG (libjpeg would smooth "
                      "its blocks; not supported)");
  }

  // jidctint.c jpeg_idct_islow over every block of the component that
  // holds real samples, into a plane of width_in_blocks * 8 columns
  void inverse_dct(Component& c, uint8_t* plane) {
    const size_t stride = static_cast<size_t>(c.width_in_blocks) * 8;
    for (int by = 0; by < c.height_in_blocks; ++by)
      for (int bx = 0; bx < c.width_in_blocks; ++bx)
        idct_islow(c.block(by, bx), c.quant,
                   plane + static_cast<size_t>(by) * 8 * stride + bx * 8,
                   stride);
  }

  static uint8_t range_limit(int64_t x) {
    // IDCT_range_limit(cinfo)[x & RANGE_MASK] of jdmaster.c's table
    const int i = static_cast<int>(x & 1023);
    if (i < 128) return static_cast<uint8_t>(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return static_cast<uint8_t>(i - 896);
  }

  static void idct_islow(const int16_t* in, const int16_t* quant,
                         uint8_t* out, size_t stride) {
    constexpr int kConstBits = 13, kPass1Bits = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t{1} << (n - 1))) >> n;
    };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const int16_t* qp = quant + col;
      int* wp = ws + col;
      auto deq = [&](int row) {
        return static_cast<int64_t>(static_cast<int>(ip[8 * row]) *
                                    static_cast<int>(qp[8 * row]));
      };
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        const int dc = static_cast<int>(
            static_cast<uint32_t>(static_cast<int>(deq(0))) << kPass1Bits);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = deq(2), z3 = deq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = deq(0);
      z3 = deq(4);
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = deq(7);
      tmp1 = deq(5);
      tmp2 = deq(3);
      tmp3 = deq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int n = kConstBits - kPass1Bits;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    constexpr int n2 = kConstBits + kPass1Bits + 3;
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + row * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
          wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        const uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
        std::memset(op, v, 8);
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) *
                     (int64_t{1} << kConstBits);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) *
                     (int64_t{1} << kConstBits);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = range_limit(descale(tmp10 + tmp3, n2));
      op[7] = range_limit(descale(tmp10 - tmp3, n2));
      op[1] = range_limit(descale(tmp11 + tmp2, n2));
      op[6] = range_limit(descale(tmp11 - tmp2, n2));
      op[2] = range_limit(descale(tmp12 + tmp1, n2));
      op[5] = range_limit(descale(tmp12 - tmp1, n2));
      op[3] = range_limit(descale(tmp13 + tmp0, n2));
      op[4] = range_limit(descale(tmp13 - tmp0, n2));
    }
  }

  // jdsample.c: the component's ds_h x ds_w samples (in a plane of
  // width_in_blocks * 8 columns) to height x width; rows and columns past
  // the real ones are the last real one, as jdmainct.c pads them
  void upsample(const Component& c, const uint8_t* in, uint8_t* out) {
    const int W = hdr_.width, H = hdr_.height;
    const size_t stride = static_cast<size_t>(c.width_in_blocks) * 8;
    const int hx = max_h_ / c.h, vx = max_v_ / c.v;
    auto row = [&](int y) {
      return in + static_cast<size_t>(std::min(std::max(y, 0), c.ds_h - 1)) *
                      stride;
    };
    const int last = c.ds_w - 1;
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < H; ++y)
        std::memcpy(out + static_cast<size_t>(y) * W, row(y), W);
    } else if (hx == 2 && vx == 1 && c.ds_w > 2) {
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = row(y);
        uint8_t* op = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          const int i = x >> 1;
          const int near3 = ip[i] * 3;
          op[x] = (x & 1) ? static_cast<uint8_t>(
                                (near3 + ip[std::min(i + 1, last)] + 2) >> 2)
                          : static_cast<uint8_t>(
                                (near3 + ip[std::max(i - 1, 0)] + 1) >> 2);
        }
      }
    } else if (hx == 1 && vx == 2) {
      for (int y = 0; y < H; ++y) {
        const int i = y >> 1;
        const uint8_t* ip0 = row(i);
        const uint8_t* ip1 = (y & 1) ? row(i + 1) : row(i - 1);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* op = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x)
          op[x] = static_cast<uint8_t>((ip0[x] * 3 + ip1[x] + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && c.ds_w > 2) {
      std::vector<int> colsum(c.ds_w);
      for (int y = 0; y < H; ++y) {
        const int i = y >> 1;
        const uint8_t* ip0 = row(i);
        const uint8_t* ip1 = (y & 1) ? row(i + 1) : row(i - 1);
        for (int j = 0; j < c.ds_w; ++j) colsum[j] = ip0[j] * 3 + ip1[j];
        uint8_t* op = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) {
          const int j = x >> 1;
          const int near3 = colsum[j] * 3;
          op[x] = (x & 1)
                      ? static_cast<uint8_t>(
                            (near3 + colsum[std::min(j + 1, last)] + 7) >> 4)
                      : static_cast<uint8_t>(
                            (near3 + colsum[std::max(j - 1, 0)] + 8) >> 4);
        }
      }
    } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = in + static_cast<size_t>(y / vx) * stride;
        uint8_t* op = out + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) op[x] = ip[x / hx];
      }
    }
  }

  // jdcolor.c ycc_rgb_convert with its tables (SCALEBITS 16), to BGR
  struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
      constexpr int64_t kHalf = int64_t{1} << 15;
      auto fix = [](double x) {
        return static_cast<int64_t>(x * (1 << 16) + 0.5);
      };
      for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> 16);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + kHalf;
      }
    }
  };

  static void ycc_to_bgr(const uint8_t* y, const uint8_t* cb,
                         const uint8_t* cr, size_t n, uint8_t* out) {
    static const YccTables t;
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < n; ++i) {
      const int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp(yy + t.cb_b[b]);
      out[3 * i + 1] =
          clamp(yy + static_cast<int>((t.cb_g[b] + t.cr_g[r]) >> 16));
      out[3 * i + 2] = clamp(yy + t.cr_r[r]);
    }
  }

  // jdcolor.c rgb_gray_convert
  static void rgb_to_gray(const uint8_t* r, const uint8_t* g,
                          const uint8_t* b, size_t n, uint8_t* out) {
    constexpr int64_t kR = 19595, kG = 38470, kB = 7471, kHalf = 32768;
    for (size_t i = 0; i < n; ++i)
      out[i] = static_cast<uint8_t>(
          (kR * r[i] + kG * g[i] + kB * b[i] + kHalf) >> 16);
  }
};

int finish(const DecodeError& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.message.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return e.status;
}

}  // namespace

extern "C" {

// Reads the markers up to the first scan. info[0..3] = height, width,
// components (1 or 3), EXIF orientation (0 where the file has none).
// Returns 0, or a Status with a message in err.
int jpeg_header(const uint8_t* data, int64_t size, int32_t* info, char* err,
                int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.read_header();
    const Header& h = dec.header();
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.ncomp;
    info[3] = h.orientation;
    return kOk;
  } catch (const DecodeError& e) {
    return finish(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return finish(DecodeError{kNoMemory, "out of memory"}, err, errlen);
  }
}

// Decodes the whole file into out: height x width x 3 BGR bytes, or
// height x width gray bytes when gray is nonzero. out_size must be that
// many bytes. Returns 0, or a Status with a message in err.
int jpeg_decode(const uint8_t* data, int64_t size, int gray, uint8_t* out,
                int64_t out_size, char* err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.read_header();
    const Header& h = dec.header();
    const int64_t need =
        static_cast<int64_t>(h.height) * h.width * (gray ? 1 : 3);
    if (need != out_size)
      throw DecodeError{kCorrupt, "output buffer has the wrong size"};
    dec.read_scans();
    dec.output(gray != 0, out);
    return kOk;
  } catch (const DecodeError& e) {
    return finish(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return finish(DecodeError{kNoMemory, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
