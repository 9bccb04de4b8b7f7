// Native host-side data ops of the input pipeline.
//
// The port's own copy of the JAX package's native/host_ops.cc: the same
// resize, LUT and uint8 -> float32 pack, with the same arithmetic, so the
// two libraries give the same bytes; and the per-row unfiltering of PNG
// image data (datasets/image_io.py), whose Sub, Average and Paeth filters
// depend on the pixel to the left and cannot be vectorised across a row.
// A plain C interface, loaded with ctypes (datasets/native_backend.py),
// which builds this file on first use:
//
//   g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17
//
// -ffp-contract=off: no FMA contraction, so pack_normalize rounds like
// numpy's separate multiply and add, and the bilinear resize like the JAX
// package's library. Single-threaded, unlike the JAX package's OpenMP
// loops (the GPU machine's compiler has no OpenMP runtime): the loader's
// worker threads run these calls side by side, as ctypes releases the
// GIL around them.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Bilinear resize of a uint8 HWC image (C contiguous, any channel count),
// OpenCV's INTER_LINEAR pixel-centre convention:
//   src_x = (dst_x + 0.5) * scale - 0.5
void resize_bilinear_u8(const uint8_t* src, int src_h, int src_w, int ch,
                        uint8_t* dst, int dst_h, int dst_w,
                        double scale_y, double scale_x) {
  for (int y = 0; y < dst_h; ++y) {
    float fy = static_cast<float>((y + 0.5) * scale_y - 0.5);
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), src_h - 1);
    int y1c = std::min(std::max(y0 + 1, 0), src_h - 1);
    for (int x = 0; x < dst_w; ++x) {
      float fx = static_cast<float>((x + 0.5) * scale_x - 0.5);
      int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), src_w - 1);
      int x1c = std::min(std::max(x0 + 1, 0), src_w - 1);
      const uint8_t* p00 = src + (static_cast<int64_t>(y0c) * src_w + x0c) * ch;
      const uint8_t* p01 = src + (static_cast<int64_t>(y0c) * src_w + x1c) * ch;
      const uint8_t* p10 = src + (static_cast<int64_t>(y1c) * src_w + x0c) * ch;
      const uint8_t* p11 = src + (static_cast<int64_t>(y1c) * src_w + x1c) * ch;
      uint8_t* out = dst + (static_cast<int64_t>(y) * dst_w + x) * ch;
      for (int c = 0; c < ch; ++c) {
        float top = p00[c] + wx * (p01[c] - p00[c]);
        float bot = p10[c] + wx * (p11[c] - p10[c]);
        float val = top + wy * (bot - top);
        out[c] = static_cast<uint8_t>(val + 0.5f);
      }
    }
  }
}

// Nearest-neighbour resize for any element size (labels, depth), OpenCV's
// INTER_NEAREST convention: src_x = floor(dst_x * scale).
void resize_nearest(const void* src_v, int src_h, int src_w, int ch,
                    int elem_size, void* dst_v, int dst_h, int dst_w,
                    double scale_y, double scale_x) {
  const char* src = static_cast<const char*>(src_v);
  char* dst = static_cast<char*>(dst_v);
  const int px = ch * elem_size;
  for (int y = 0; y < dst_h; ++y) {
    int sy = std::min(static_cast<int>(std::floor(y * scale_y)), src_h - 1);
    for (int x = 0; x < dst_w; ++x) {
      int sx = std::min(static_cast<int>(std::floor(x * scale_x)), src_w - 1);
      std::memcpy(dst + (static_cast<int64_t>(y) * dst_w + x) * px,
                  src + (static_cast<int64_t>(sy) * src_w + sx) * px, px);
    }
  }
}

// 256-entry LUT over a uint8 buffer (gamma correction).
void apply_lut_u8(const uint8_t* src, int64_t n, const uint8_t* lut,
                  uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// uint8 -> float32 conversion with scale and offset: the per-batch
// packing loop.
void pack_normalize_f32(const uint8_t* src, int64_t n, float scale,
                        float offset, float* dst) {
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * scale + offset;
}

// PNG row unfiltering (PNG specification, section 9). ``src`` holds
// ``height`` rows of one filter-type byte followed by ``rowbytes`` filtered
// bytes, as the inflated image data of a non-interlaced image; ``bpp`` is
// the bytes per complete pixel (at least 1). Writes the ``height x
// rowbytes`` reconstructed bytes to ``dst``. Returns 0, or 1 + the index
// of the first row whose filter type is not 0-4.
int png_unfilter(const uint8_t* src, int64_t height, int64_t rowbytes,
                 int bpp, uint8_t* dst) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y > 0 ? out - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = in[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return static_cast<int>(y) + 1;
    }
  }
  return 0;
}

}  // extern "C"
