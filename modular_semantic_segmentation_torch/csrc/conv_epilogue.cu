// The served convolutions' epilogue for Hopper (sm_90a): bias add, bf16
// rounding and an optional ReLU in one pass over the convolution's output.
//
// Replaces no Pallas kernel: the JAX package leaves the epilogue to XLA,
// which fuses it into the convolution's consumer. On the card the port ran
// it as three PyTorch kernels a convolution (ops/layers.py, `conv2d`):
// `out + bias` (bf16 + float32, written as float32), `.to(bfloat16)` and
// `torch.relu`, which move 2.66 GB a fused 768x384 frame; this kernel
// moves 0.67 GB.
//
// Function. x is the convolution's bf16 output, dense NHWC with C channels
// last, bias the float32 [C] variable:
//   y[i] = relu?( bf16_rn( float(x[i]) + bias[i % C] ) )
// the same order as the JAX package and the PyTorch chain: the sum in
// float32, one round-to-nearest-even to bf16 (the conversion PyTorch's
// cast uses on this card), then the ReLU on the rounded value, with NaN
// passed through as torch.relu passes it, written over x (in place).
//
// Bound: bytes. Each element is read once (2 bytes) and written once (2
// bytes); the bias (C floats) stays in registers. At conv1_2's output
// ([1, 384, 768, 64], 18.9 M elements) that is 75.5 MB, 22.5 us at
// 3.35 TB/s; the add, the rounding and the ReLU are a few instructions an
// element.
//
// Design:
//   * one thread moves V values at once: 16-byte loads and stores of 8
//     bf16 where the element count is a multiple of 8 and x is 16-byte
//     aligned (every output of the flagship, the decoder's 14 classes
//     too: a vector may span two pixels), one value otherwise (views off
//     alignment);
//   * a grid-stride loop over the vectors. The wrapper
//     (ops/cuda/conv_epilogue.py, `grid_blocks`) makes the grid's stride,
//     in elements, a multiple of C, so each of a thread's V values has the
//     same channel at every step: its V bias values are read once, into
//     registers;
//   * the grid fills every SM with resident threads (the wrapper's
//     BLOCKS_PER_SM blocks of kThreads, fewer where the work is smaller),
//     each thread with kUnroll loads in flight before its stores, so that
//     enough bytes are in flight to keep device memory busy;
//   * plain loads and stores: the next convolution reads the result,
//     which may still be in L2, and the kernel writes what it reads, so
//     no read-only or streaming cache hints;
//   * nothing is allocated and nothing synchronises; the launch goes on
//     the caller's stream, which keeps the kernel legal inside a captured
//     CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

template <int Bytes>
struct WordOf;
template <>
struct WordOf<16> {
  using type = int4;
};
template <>
struct WordOf<2> {
  using type = unsigned short;
};

// bf16 of float(v) + b, rounded once to nearest even; with RELU, the
// rounded value clamped at zero as torch.relu clamps it (NaN passes)
template <int RELU>
__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 v, float b) {
  __nv_bfloat16 r = __float2bfloat16_rn(__bfloat162float(v) + b);
  if constexpr (RELU != 0) {
    const float f = __bfloat162float(r);
    if (!isnan(f)) r = __float2bfloat16_rn(fmaxf(f, 0.0f));
  }
  return r;
}

// x[i * V .. i * V + V) in place for every vector i of [0, vectors), c
// channels; the grid's thread count times V is a multiple of c
template <typename T, int V, int RELU>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(T* x, const float* __restrict__ bias,
                         int64_t vectors, int c) {
  using Word = typename WordOf<sizeof(T) * V>::type;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int channel = (int)(first * V % c);
  float b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) b[v] = __ldg(bias + (channel + v) % c);
  for (int64_t i = first; i < vectors; i += kUnroll * stride) {
    Word w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j < vectors) w[u] = *reinterpret_cast<const Word*>(x + j * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j >= vectors) break;
      T values[V];
      memcpy(values, &w[u], sizeof(Word));
#pragma unroll
      for (int v = 0; v < V; ++v) values[v] = apply<RELU>(values[v], b[v]);
      memcpy(&w[u], values, sizeof(Word));
      *reinterpret_cast<Word*>(x + j * V) = w[u];
    }
  }
}

template <int V, int RELU>
cudaError_t launch_typed(void* x, const void* bias, int64_t vectors, int c,
                         int blocks, cudaStream_t stream) {
  conv_epilogue_kernel<__nv_bfloat16, V, RELU>
      <<<blocks, kThreads, 0, stream>>>(static_cast<__nv_bfloat16*>(x),
                                        static_cast<const float*>(bias),
                                        vectors, c);
  return cudaGetLastError();
}

}  // namespace

// x, bf16 [numel] with c channels last, in place, and the float32 bias
// [c]; vec 8 (x 16-byte aligned, numel % 8 == 0) or 1; `blocks` of 256
// threads, whose count times vec is a multiple of c; relu 0 or 1.
// Returns cudaGetLastError() after the launch.
extern "C" int conv_epilogue_launch(void* x, const void* bias, int64_t numel,
                                    int c, int vec, int relu, int blocks,
                                    void* stream) {
  if (c < 1 || (vec != 8 && vec != 1) || numel % vec != 0 ||
      numel % c != 0 || blocks < 1 ||
      ((int64_t)blocks * kThreads * vec) % c != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (numel == 0) return (int)cudaSuccess;
  const int64_t vectors = numel / vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    return (int)(relu ? launch_typed<8, 1>(x, bias, vectors, c, blocks, s)
                      : launch_typed<8, 0>(x, bias, vectors, c, blocks, s));
  }
  return (int)(relu ? launch_typed<1, 1>(x, bias, vectors, c, blocks, s)
                    : launch_typed<1, 0>(x, bias, vectors, c, blocks, s));
}

extern "C" const char* conv_epilogue_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
