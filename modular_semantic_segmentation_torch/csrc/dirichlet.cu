// Fused Dirichlet classification for Hopper (sm_90a).
//
// Replaces: modular_semantic_segmentation_tpu/ops/pallas/dirichlet_kernel.py,
// `_kernel` (launched by `_run`).
//
// Function, per pixel p:
//   out[p] = argmax_c  sum_e sum_k log(1e-20 + probs[e, p, k]) * a[e, k, c]
//                      + bias[c]
// with a = sigma * alpha - 1 and bias = log(1e-20 + prior) - sum_e log B(
// sigma * alpha_e), both precomputed by the caller (the bias in float64 on
// the host, with gammaln). The first maximum wins ties, as jnp.argmax.
// No [pixels, C] score tensor is written.
//
// Bound: memory. The probabilities are read once (E*P*K values, float32 or
// bfloat16) and one int32 per pixel is written: at the flagship (E = 2,
// P = 768*384, K = C = 14, float32) 33.0 MB in and 1.2 MB out, about 10 us
// at 3.35 TB/s. The arithmetic, E*K logs and 2*E*K*C flops per pixel
// (about 0.24 GFLOP), is far below the card's float32 rate.
//
// Design: one thread per pixel, 128 pixels per block. The (E, K, C)
// coefficients and the bias sit in shared memory. A pixel row of K = 14
// values is 56 bytes and not 16-byte aligned, so the block first copies
// its contiguous slab of each expert's probabilities with coalesced loads
// (consecutive threads, consecutive elements), taking the log on the way
// into shared memory. Each thread then accumulates the class scores in
// registers, kChunk classes at a time, and keeps a running argmax. A
// [tile, K] @ [K, C] tensor-core form is later work. Nothing is allocated
// here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dirichlet_label_kernel(const T* __restrict__ probs,
                       const float* __restrict__ coeffs,
                       const float* __restrict__ bias, int* __restrict__ out,
                       long long pixels, int experts, int k, int c) {
  extern __shared__ float smem[];
  float* s_coeffs = smem;                       // [E, K, C]
  float* s_bias = s_coeffs + experts * k * c;   // [C]
  float* s_logp = s_bias + c;                   // [E, kThreads, K]

  const int tid = threadIdx.x;
  for (int i = tid; i < experts * k * c; i += kThreads) {
    s_coeffs[i] = coeffs[i];
  }
  for (int i = tid; i < c; i += kThreads) s_bias[i] = bias[i];

  const long long first = (long long)blockIdx.x * kThreads;
  const long long left = pixels - first;
  const int rows = left < kThreads ? (int)left : kThreads;
  const int slab = rows * k;
  for (int e = 0; e < experts; ++e) {
    const T* src = probs + ((long long)e * pixels + first) * k;
    float* dst = s_logp + e * kThreads * k;
    for (int i = tid; i < slab; i += kThreads) {
      dst[i] = logf(1e-20f + to_float(src[i]));
    }
  }
  __syncthreads();
  if (tid >= rows) return;

  int best = 0;
  float best_score = -CUDART_INF_F;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float total[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) total[j] = 0.0f;
    for (int e = 0; e < experts; ++e) {
      const float* logp = s_logp + e * kThreads * k + tid * k;
      const float* a = s_coeffs + e * k * c + c0;
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
      for (int kk = 0; kk < k; ++kk) {
        const float lp = logp[kk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c0 + j < c) acc[j] = fmaf(lp, a[kk * c + j], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) total[j] += acc[j];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < c) {
        const float score = total[j] + s_bias[c0 + j];
        if (score > best_score) {
          best_score = score;
          best = c0 + j;
        }
      }
    }
  }
  out[first + tid] = best;
}

}  // namespace

extern "C" int dirichlet_label_launch(const void* probs, int probs_bf16,
                                      const float* coeffs, const float* bias,
                                      int* out, long long pixels, int experts,
                                      int k, int c, void* stream) {
  if (pixels <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)experts * k * c + c +
                                       (size_t)experts * kThreads * k);
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (probs_bf16) {
    dirichlet_label_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(probs), coeffs, bias, out, pixels,
        experts, k, c);
  } else {
    dirichlet_label_kernel<float><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(probs), coeffs, bias, out, pixels, experts,
        k, c);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dirichlet_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
