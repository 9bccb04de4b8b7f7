// Confusion-matrix accumulation for Hopper (sm_90a).
//
// Replaces: modular_semantic_segmentation_tpu/ops/pallas/confusion_kernel.py,
// `_kernel` (launched by `_run`), a one-hot [K+1, tile] @ [tile, K] MXU
// contraction accumulated over the pixel grid in a revisited output block.
//
// Function: out[l * K + p] += 1 for every pixel with label l and
// prediction p. A label < 0 is counted in the extra row K (which the
// caller drops); a label > K, or a prediction outside [0, K), is counted
// nowhere. That is what the JAX one-hot forms compute
// (ops/metrics.py:33-37) and what the Pallas padding relies on.
//
// Bound: memory. Each pixel is read once (a 4-byte prediction and a
// 4-byte label) and costs one integer add: at 768x384 that is 2.36 MB,
// about 0.7 us at 3.35 TB/s; the (K+1)*K output is negligible.
//
// Design: a one-hot product would do K^2 operations per pixel for one
// useful count, so the TPU's matrix-unit form is not carried over. Each
// block strides over the pixels with coalesced 4-byte loads and counts
// into a (K+1)*K histogram of 32-bit bins in shared memory with
// atomicAdd; at the end each non-zero bin is added once into the global
// int32 [K+1, K] buffer that the wrapper zeroed. Counts are exact.
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 8;
constexpr long long kMaxBlocks = 132LL * 16;

__global__ void __launch_bounds__(kThreads)
confusion_kernel(const int* __restrict__ preds, const int* __restrict__ labels,
                 long long n, int k, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int bins = (k + 1) * k;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int label = labels[i];
    const int pred = preds[i];
    if (label < 0) label = k;
    if (label <= k && pred >= 0 && pred < k) {
      atomicAdd(&hist[label * k + pred], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int count = hist[i];
    if (count) atomicAdd(&out[i], count);
  }
}

}  // namespace

extern "C" int confusion_launch(const int* preds, const int* labels,
                                long long n, int k, int* out, void* stream) {
  if (n <= 0) return 0;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = sizeof(int) * (size_t)(k + 1) * (size_t)k;
  confusion_kernel<<<(unsigned)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(preds, labels, n,
                                                          k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* confusion_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
