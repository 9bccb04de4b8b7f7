// The adjoint of the frozen channel-diagonal upsample (the gradient of its
// input), for Hopper (sm_90a): its function, bound and design are in the
// note of csrc/upsample.cu, whose forward it differentiates. A library of
// its own, so that nvcc builds it beside the forward's.

#include "upsample.cuh"

namespace {

// input pixels of a row per thread of the adjoint
constexpr int kAdjointRun = 4;

// kAdjointRun input pixels [j0, j0 + count) of input row i of image n for
// a thread's channel vector: the sum over every phase (py, px) and tap
template <typename T, int V, int TAPS>
__device__ __forceinline__ void adjoint_row(
    const T* image, const T* wv, const int2* table, int i, int h, int width,
    int c, int k, int s, int taps, int j0, int count, T* dst) {
  using Word = typename Vec<T, V>::Word;
  using A = typename AccOf<T>::type;
  const int64_t g_row = (int64_t)width * s * c;
  A acc[kAdjointRun][V];
#pragma unroll
  for (int r = 0; r < kAdjointRun; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0;
  }
  for (int py = 0; py < s; ++py) {
    const int2 row_phase = table[py];
    for (int px = 0; px < s; ++px) {
      const int2 col_phase = table[px];
      if constexpr (TAPS > 0) {
        A wt[TAPS][TAPS][V];
        const T* src[TAPS];
#pragma unroll
        for (int ty = 0; ty < TAPS; ++ty) {
          const int a = row_phase.y + ty * s;
          const int q = i - row_phase.x + ty;
          src[ty] = (a < k && q >= 0 && q < h)
                        ? image + ((int64_t)q * s + py) * g_row
                        : nullptr;
#pragma unroll
          for (int tx = 0; tx < TAPS; ++tx) {
            load_weights<T, V>(wv, a, col_phase.y + tx * s, k, c,
                               wt[ty][tx]);
          }
        }
        // g's column block u = j - d0 + tx, column u*s + px
        auto load = [&](int ty, int u) -> Word {
          return (src[ty] != nullptr && u >= 0 && u < width)
                     ? Vec<T, V>::load(src[ty] + ((int64_t)u * s + px) * c)
                     : Vec<T, V>::zero();
        };
        // window[ty][tx] holds block j - d0 + tx; before the first step it
        // holds the blocks that step shifts into tx = 0 .. TAPS-2
        Word window[TAPS][TAPS];
#pragma unroll
        for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
          for (int tx = 1; tx < TAPS; ++tx) {
            window[ty][tx] = load(ty, j0 - col_phase.x + tx - 1);
          }
        }
#pragma unroll
        for (int r = 0; r < kAdjointRun; ++r) {
          if (r < count) {
#pragma unroll
            for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
              for (int tx = 0; tx + 1 < TAPS; ++tx) {
                window[ty][tx] = window[ty][tx + 1];
              }
              window[ty][TAPS - 1] =
                  load(ty, j0 + r - col_phase.x + TAPS - 1);
            }
#pragma unroll
            for (int ty = 0; ty < TAPS; ++ty) {
#pragma unroll
              for (int tx = 0; tx < TAPS; ++tx) {
                A gv[V];
                Vec<T, V>::unpack(window[ty][tx], gv);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[r][v] = madd(wt[ty][tx][v], gv[v], acc[r][v]);
                }
              }
            }
          }
        }
      } else {
        for (int ty = 0; ty < taps; ++ty) {
          const int a = row_phase.y + ty * s;
          const int q = i - row_phase.x + ty;
          if (a >= k || q < 0 || q >= h) continue;
          const T* src = image + ((int64_t)q * s + py) * g_row;
          for (int tx = 0; tx < taps; ++tx) {
            const int b = col_phase.y + tx * s;
            if (b >= k) continue;
            A wt[V];
            load_weights<T, V>(wv, a, b, k, c, wt);
#pragma unroll
            for (int r = 0; r < kAdjointRun; ++r) {
              const int u = j0 + r - col_phase.x + tx;
              if (r < count && u >= 0 && u < width) {
                A gv[V];
                Vec<T, V>::unpack(
                    Vec<T, V>::load(src + ((int64_t)u * s + px) * c), gv);
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[r][v] = madd(wt[v], gv[v], acc[r][v]);
                }
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kAdjointRun; ++r) {
    if (r < count) Vec<T, V>::store(dst + (int64_t)r * c, acc[r]);
  }
}

// grid x: the (chunk, cv) items of an input row, cv fastest; grid y: the
// input row i; grid z: the image n
template <typename T, int V, int TAPS>
__global__ void __launch_bounds__(kThreads)
    upsample_adjoint_kernel(const T* __restrict__ g, const T* __restrict__ w,
                            const int2* __restrict__ table,
                            T* __restrict__ gx, int h, int width, int c,
                            int k, int s, int taps, int per_row) {
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= per_row) return;
  const int vecs = c / V;
  const int cv = item % vecs;
  const int j0 = item / vecs * kAdjointRun;
  const int i = blockIdx.y;
  const int64_t n = blockIdx.z;
  adjoint_row<T, V, TAPS>(
      g + n * h * s * width * s * c + cv * V, w + cv * V, table, i, h, width,
      c, k, s, taps, j0, min(kAdjointRun, width - j0),
      gx + ((n * h + i) * width + j0) * c + cv * V);
}

template <typename T, int V>
cudaError_t adjoint_typed(const void* g, const void* w, const void* table,
                          void* gx, int n, int h, int width, int c, int k,
                          int s, cudaStream_t stream) {
  const int taps = (k + s - 1) / s;
  const int64_t per_row =
      (int64_t)(width + kAdjointRun - 1) / kAdjointRun * (c / V);
  if (per_row == 0 || n == 0 || h == 0) return cudaSuccess;
  if (per_row > INT32_MAX || h > kMaxGridYZ || n > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((per_row + kThreads - 1) / kThreads), h, n);
  const T* gt = static_cast<const T*>(g);
  const T* wt = static_cast<const T*>(w);
  const int2* tt = static_cast<const int2*>(table);
  T* ot = static_cast<T*>(gx);
  // the unrolled two-tap instance only for 16-byte vectors: the
  // flagship's calls; every other shape takes the run-time taps
  if constexpr (sizeof(T) * V == 16) {
    if (taps == 2) {
      upsample_adjoint_kernel<T, V, 2><<<grid, kThreads, 0, stream>>>(
          gt, wt, tt, ot, h, width, c, k, s, taps, (int)per_row);
      return cudaGetLastError();
    }
  }
  upsample_adjoint_kernel<T, V, 0><<<grid, kThreads, 0, stream>>>(
      gt, wt, tt, ot, h, width, c, k, s, taps, (int)per_row);
  return cudaGetLastError();
}

template <typename T, int V>
struct Adjoint {
  template <typename... Args>
  static cudaError_t run(Args... args) {
    return adjoint_typed<T, V>(args...);
  }
};

}  // namespace

// gx [n, h, width, c] from g [n, h*s, width*s, c], with the forward's
// kernels and table
extern "C" int upsample_adjoint_launch(const void* g, const void* w,
                                       const void* table, void* gx, int n,
                                       int h, int width, int c, int k, int s,
                                       int dtype, int vec, void* stream) {
  if (s < 1 || k < s || vec < 1 || c % vec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch<Adjoint>(dtype, vec, g, w, table, gx, n, h, width, c,
                                k, s, static_cast<cudaStream_t>(stream));
}

extern "C" const char* upsample_adjoint_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
