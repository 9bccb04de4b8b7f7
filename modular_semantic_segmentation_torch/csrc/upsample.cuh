// Shared by csrc/upsample.cu (the forward) and csrc/upsample_adjoint.cu
// (its adjoint), two libraries that nvcc builds at once: element types,
// 16-byte vectors, the weights' loads and the dispatch on type and vector
// width. The design note is in csrc/upsample.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// threads a block: 128 ran the flagship's shapes 1-10% faster than 256
// and 7-29% faster than 512, and the training adjoint 1.7 times faster
// than 256 (its rows hold 320 items, which 256 split into one full block
// and one a quarter full)
constexpr int kThreads = 128;

// the accumulator of an element type: float32 for bf16 and float32,
// float64 for float64
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

template <typename A, typename T>
__device__ __forceinline__ A widen(T v) {
  return static_cast<A>(v);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A>
__device__ __forceinline__ T narrow(A v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

// the word that moves V values of T in one load or store
template <int Bytes>
struct WordOf;
template <>
struct WordOf<16> {
  using type = int4;
};
template <>
struct WordOf<8> {
  using type = int2;
};
template <>
struct WordOf<4> {
  using type = int;
};
template <>
struct WordOf<2> {
  using type = short;
};

template <typename T, int V>
struct Vec {
  using Word = typename WordOf<sizeof(T) * V>::type;
  using A = typename AccOf<T>::type;

  static __device__ __forceinline__ Word load(const T* p) {
    return __ldg(reinterpret_cast<const Word*>(p));
  }
  static __device__ __forceinline__ Word zero() {
    Word w;
    memset(&w, 0, sizeof(Word));
    return w;
  }
  static __device__ __forceinline__ void unpack(const Word& w, A* f) {
    T values[V];
    memcpy(values, &w, sizeof(Word));
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = widen<A>(values[i]);
  }
  // streaming store: the output is not read again by this kernel
  static __device__ __forceinline__ void store(T* p, const A* f) {
    T values[V];
#pragma unroll
    for (int i = 0; i < V; ++i) values[i] = narrow<T>(f[i]);
    Word w;
    memcpy(&w, values, sizeof(Word));
    __stcs(reinterpret_cast<Word*>(p), w);
  }
};

// V weights of tap (a, b) for channel vector cv, or zeros for an empty tap
template <typename T, int V>
__device__ __forceinline__ void load_weights(const T* w, int a, int b, int k,
                                             int c,
                                             typename AccOf<T>::type* out) {
  if (a < k && b < k) {
    Vec<T, V>::unpack(Vec<T, V>::load(w + ((int64_t)a * k + b) * c), out);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = 0;
  }
}

// grid y and z: the rows and the images
constexpr int kMaxGridYZ = 65535;

// one entry point per direction: the element type (0 float32, 1
// bfloat16, 2 float64) and the vector width V (values a thread moves at
// once) select the instance
template <template <typename, int> class Fn, typename... Args>
cudaError_t dispatch(int dtype, int vec, Args... args) {
  if (dtype == 1) {
    switch (vec) {
      case 8: return Fn<__nv_bfloat16, 8>::run(args...);
      case 4: return Fn<__nv_bfloat16, 4>::run(args...);
      case 2: return Fn<__nv_bfloat16, 2>::run(args...);
      case 1: return Fn<__nv_bfloat16, 1>::run(args...);
    }
  } else if (dtype == 0) {
    switch (vec) {
      case 4: return Fn<float, 4>::run(args...);
      case 2: return Fn<float, 2>::run(args...);
      case 1: return Fn<float, 1>::run(args...);
    }
  } else if (dtype == 2) {
    switch (vec) {
      case 2: return Fn<double, 2>::run(args...);
      case 1: return Fn<double, 1>::run(args...);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
