// Frozen channel-diagonal transposed convolution (the expert CNN's bilinear
// upsample) and its adjoint, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the function with XLA
// (modular_semantic_segmentation_tpu/ops/fast_upsample.py:73,
// `diagonal_upsample`, a phase decomposition into shifted einsums). On the
// card the port ran it as cuDNN's grouped transposed convolution
// (F.conv_transpose2d with groups=C), which took 3.7 ms an expert at the
// 768x384 flagship, about 300 times its bound; this pair takes its place.
//
// Function. x is NHWC [N, H, W, C], K the per-channel kernels [k, k, C],
// s the stride, lo = max(k - s, 0) / 2 TF SAME's leading crop. Output row
// o = q*s + p (phase p) takes input rows q + d with kernel rows a, where
// (d, a) = (d0(p) - t, a0(p) + t*s) for t = 0 .. taps-1, taps = ceil(k/s),
// d0(p) = (p + lo) / s, a0(p) = (p + lo) % s, a tap with a >= k being
// empty; columns likewise:
//   out[n, o, r, c] = sum_{ty, tx} K[a(py,ty), a(px,tx), c]
//                                  * x[n, qy + d(py,ty), qx + d(px,tx), c]
// with x zero outside. The wrapper (ops/cuda/upsample.py, `tap_table`)
// hands the kernels the table (d0(p), a0(p)) of every phase, and its plain
// version gathers from the same table. The adjoint gives the input's
// gradient:
//   gx[n, i, j, c] = sum_{py, ty, px, tx} K[a(py,ty), a(px,tx), c]
//        * g[n, (i - d(py,ty))*s + py, (j - d(px,tx))*s + px, c],
// g zero outside the output. No gradient for K is computed: the kernels
// are frozen.
//
// Bound: bytes. At the flagship's second call (16x16/s8, [1, 96, 48, 64]
// -> [1, 768, 384, 64], bf16) the forward writes 37.7 MB and reads 0.6 MB,
// 11.4 us at 3.35 TB/s, against 151 MFLOP (0.15 us at 989 TFLOP/s; 4 taps
// an output value). The adjoint at the training shape ([4, 46, 80, 64]
// float32, g [4, 368, 640, 64]) reads 241 MB of g once, 72 us, and its
// 0.48 GFLOP of float32 FMAs take 7 us at 67 TFLOP/s.
//
// Design of the forward, a streaming store of the output:
//   * output-stationary: each thread owns one vector of V channels (16
//     bytes where C and the pointers allow: 8 bf16, 4 float32, 2
//     float64), one output row and one column phase px, and walks `run`
//     input columns qx, writing output pixel qx*s + px of each.
//     Neighbouring threads take neighbouring channel vectors, then
//     neighbouring phases, so a warp's stores at each step cover
//     consecutive output pixels: whole 32-byte sectors, written with
//     streaming (evict-first) stores. The wrapper sets `run` from the work
//     (ops/cuda/upsample.py, `forward_run`): one column a thread for the
//     small 4/s2 call, which needs every thread it can get, eight for the
//     16/s8 calls;
//   * a thread's taps^2 weight vectors are the same for its whole walk:
//     they are read once (L2 holds the [k, k, C] kernels) into registers
//     in the accumulator's type. Shared memory would hold the same values
//     for the block and be read back into the same registers;
//   * with taps = 2 (k = 2s: both of the flagship's calls) and 16-byte
//     vectors the tap loops are unrolled and the input window slides:
//     stepping qx by one moves every tap's column by one, so each step
//     loads taps new vectors (one per tap row) and keeps the others,
//     packed, in registers. The input (0.6 MB at the flagship) stays in L1
//     and L2; it is read from device memory about once;
//   * float32 accumulation (float64 for float64 data), tap rows outer and
//     tap columns inner as in the plain version, one rounding to the
//     output's dtype;
//   * other shapes (k > 2s, k < 2s with empty taps, narrower vectors) take
//     the same walk with the tap loops and the weight reads at run time;
//   * grid y and z carry the output row and the image, so no thread
//     divides a 64-bit index.
// Design of the adjoint: output-stationary over gx: each thread owns one
// channel vector of kAdjointRun consecutive input pixels of a row, loops
// over the s*s phases, reads each phase's taps^2 weight vectors once, and
// slides a window over that phase's columns of g as the forward does, so
// each g vector a thread reads serves every output of its run it reaches.
// A g vector is read by taps^2 threads (the neighbouring i and j). A
// block's tile of g with its halo is past shared memory at the training
// shape (16 rows of 264 pixels of 256 bytes, 1 MB), so L1 and L2 serve
// the reuse. Float32 accumulation (float64 for float64), one rounding.
// The adjoint is csrc/upsample_adjoint.cu and the code both share
// csrc/upsample.cuh: two libraries, which nvcc builds at once, so that
// the serving path waits only for the forward's. Nothing is allocated
// here; the launches go on the caller's stream.

#include "upsample.cuh"

namespace {

// One output row oy of image n for a thread's (channel vector, column
// phase px, chunk of input columns [qx0, qx1)). TAPS > 0: taps per
// dimension known at compile time (2); TAPS == 0: taps at run time.
template <typename T, int V, int TAPS>
__device__ __forceinline__ void forward_row(
    const T* image, const T* wv, int2 row_phase, int2 col_phase, int qy,
    int h, int width, int c, int k, int s, int taps, int qx0, int qx1,
    T* dst, int64_t dst_step) {
  using Word = typename Vec<T, V>::Word;
  using A = typename AccOf<T>::type;
  const int64_t row_len = (int64_t)width * c;
  if constexpr (TAPS > 0) {
    A wt[TAPS][TAPS][V];
    const T* src[TAPS];  // nullptr: no input row or an empty tap row
#pragma unroll
    for (int ty = 0; ty < TAPS; ++ty) {
      const int a = row_phase.y + ty * s;
      const int iy = qy + row_phase.x - ty;
      src[ty] = (a < k && iy >= 0 && iy < h) ? image + iy * row_len
                                              : nullptr;
#pragma unroll
      for (int tx = 0; tx < TAPS; ++tx) {
        load_weights<T, V>(wv, a, col_phase.y + tx * s, k, c, wt[ty][tx]);
      }
    }
    auto load = [&](int ty, int col) -> Word {
      return (src[ty] != nullptr && col >= 0 && col < width)
                 ? Vec<T, V>::load(src[ty] + (int64_t)col * c)
                 : Vec<T, V>::zero();
    };
    // window[ty][tx] holds column qx + d0 - tx; before the first step it
    // holds the columns that step shifts into tx = 1 .. TAPS-1
    Word window[TAPS][TAPS];
#pragma unroll
    for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
      for (int tx = 0; tx + 1 < TAPS; ++tx) {
        window[ty][tx] = load(ty, qx0 + col_phase.x - 1 - tx);
      }
    }
    for (int qx = qx0; qx < qx1; ++qx) {
#pragma unroll
      for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
        for (int tx = TAPS - 1; tx > 0; --tx) {
          window[ty][tx] = window[ty][tx - 1];
        }
        window[ty][0] = load(ty, qx + col_phase.x);
      }
      A acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
      for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
        for (int tx = 0; tx < TAPS; ++tx) {
          A xv[V];
          Vec<T, V>::unpack(window[ty][tx], xv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[v] = madd(wt[ty][tx][v], xv[v], acc[v]);
          }
        }
      }
      Vec<T, V>::store(dst, acc);
      dst += dst_step;
    }
  } else {
    for (int qx = qx0; qx < qx1; ++qx) {
      A acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
      for (int ty = 0; ty < taps; ++ty) {
        const int a = row_phase.y + ty * s;
        const int iy = qy + row_phase.x - ty;
        if (a >= k || iy < 0 || iy >= h) continue;
        for (int tx = 0; tx < taps; ++tx) {
          const int b = col_phase.y + tx * s;
          const int ix = qx + col_phase.x - tx;
          if (b >= k || ix < 0 || ix >= width) continue;
          A wt[V], xv[V];
          load_weights<T, V>(wv, a, b, k, c, wt);
          Vec<T, V>::unpack(
              Vec<T, V>::load(image + iy * row_len + (int64_t)ix * c), xv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = madd(wt[v], xv[v], acc[v]);
        }
      }
      Vec<T, V>::store(dst, acc);
      dst += dst_step;
    }
  }
}

// grid x: the (chunk, px, cv) items of an output row, cv fastest; grid y:
// the output row oy; grid z: the image n
template <typename T, int V, int TAPS>
__global__ void __launch_bounds__(kThreads)
    upsample_forward_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const int2* __restrict__ table,
                            T* __restrict__ out, int h, int width, int c,
                            int k, int s, int taps, int run, int per_row) {
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= per_row) return;
  const int vecs = c / V;
  const int cv = item % vecs;
  const int px = (item / vecs) % s;
  const int qx0 = item / (vecs * s) * run;
  const int oy = blockIdx.y;
  const int qy = oy / s;
  const int64_t n = blockIdx.z;
  forward_row<T, V, TAPS>(
      x + n * h * width * c + cv * V, w + cv * V, table[oy - qy * s],
      table[px], qy, h, width, c, k, s, taps, qx0, min(qx0 + run, width),
      out + (((n * h * s + oy) * width + qx0) * s + px) * c + cv * V,
      (int64_t)s * c);
}

template <typename T, int V>
cudaError_t forward_typed(const void* x, const void* w, const void* table,
                          void* out, int n, int h, int width, int c, int k,
                          int s, int run, cudaStream_t stream) {
  const int taps = (k + s - 1) / s;
  const int64_t per_row = (int64_t)(width + run - 1) / run * s * (c / V);
  if (per_row == 0 || n == 0 || h == 0) return cudaSuccess;
  if (per_row > INT32_MAX || (int64_t)h * s > kMaxGridYZ || n > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((per_row + kThreads - 1) / kThreads), h * s, n);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int2* tt = static_cast<const int2*>(table);
  T* ot = static_cast<T*>(out);
  // the unrolled two-tap instance only for 16-byte vectors: the
  // flagship's calls; every other shape takes the run-time taps
  if constexpr (sizeof(T) * V == 16) {
    if (taps == 2) {
      upsample_forward_kernel<T, V, 2><<<grid, kThreads, 0, stream>>>(
          xt, wt, tt, ot, h, width, c, k, s, taps, run, (int)per_row);
      return cudaGetLastError();
    }
  }
  upsample_forward_kernel<T, V, 0><<<grid, kThreads, 0, stream>>>(
      xt, wt, tt, ot, h, width, c, k, s, taps, run, (int)per_row);
  return cudaGetLastError();
}

template <typename T, int V>
struct Forward {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return forward_typed<T, V>(args...);
  }
};

}  // namespace

// out [n, h*s, width*s, c] from x [n, h, width, c], the kernels w [k, k, c]
// (x's type) and the tap table [s] of int2 (d0, a0); each thread walks
// `run` input columns. x, w and out aligned to V values, c a multiple of V.
extern "C" int upsample_forward_launch(const void* x, const void* w,
                                       const void* table, void* out, int n,
                                       int h, int width, int c, int k, int s,
                                       int run, int dtype, int vec,
                                       void* stream) {
  if (run < 1 || s < 1 || k < s || vec < 1 || c % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch<Forward>(dtype, vec, x, w, table, out, n, h, width, c,
                                k, s, run,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* upsample_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
