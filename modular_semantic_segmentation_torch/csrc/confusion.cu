// Confusion-matrix accumulation for Hopper (sm_90a).
//
// Replaces: modular_semantic_segmentation_tpu/ops/pallas/confusion_kernel.py,
// `_kernel` (launched by `_run`), a one-hot [K+1, tile] @ [tile, K] MXU
// contraction accumulated over the pixel grid in a revisited output block.
//
// Function: total[l * K + p] += 1 for every pixel with label l and
// prediction p, both in [0, K). A label < 0 belongs to the dropped row K of
// the JAX forms, and a label > K or a prediction outside [0, K) counts
// nowhere (ops/metrics.py:33-37), so neither is counted here and the
// dropped row is not kept. `total` is the caller's [K, K] 64-bit
// accumulator: a scored measure set adds every batch into it with one
// launch each, and 10,000 frames of 768x384 cannot overflow it.
//
// Bound: memory. Each pixel is read once (a 4-byte prediction and a 4-byte
// label) and costs one integer add: at 768x384 that is 2.36 MB, about
// 0.7 us at 3.35 TB/s. At that size the whole input has to be in flight at
// once to come near it, and the pairs of a measure step are skewed: long
// runs of one class, and an accurate (or a random, untrained) expert puts
// most pixels on a few bins, where the atomics of a warp all hit one
// shared address and serialize.
//
// Design:
//  * 16-byte loads, 4 labels and 4 predictions a thread per step, two steps
//    a thread issued before either is used; a block walks tiles of 2048
//    pixels, and the grid is at most one wave, so a 768x384 frame is read
//    by 144 blocks at once. Pixels before the first 16-byte boundary, the
//    n % 4 after the last, and every pixel when the two pointers are
//    misaligned to each other, take a scalar loop.
//  * Each warp counts into its own sub-histogram of 32-bit bins in shared
//    memory (8 copies of K*K bins at K = 14: 6.3 KB), so warps never
//    contend for an address. Where K*K*8 bins exceed the 48 KB a block
//    gets without opting in, warps share copies (one copy at K = 100).
//  * Equal bins are merged before the atomic: a thread whose 4 pixels fall
//    in one bin offers that bin with weight 4 to one __match_any_sync
//    round, and the lowest lane of each group of equal offers adds
//    4 x group size. One-bin data costs one shared atomic per 128 pixels.
//    A thread whose 4 pixels differ adds each with its own atomic:
//    merging those too (four more match rounds a quad) was slower on
//    uniform pairs, on a measure step's pairs and on one bin alike, since
//    the per-warp copies already keep the warps from contending.
//  * At the end each block folds its copies and adds each non-zero bin
//    once into the 64-bit accumulator.
// Counts are exact. Nothing is allocated here; the launch goes on the
// caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 2;  // 16-byte steps a thread loads before using them
constexpr long long kTileQuads = (long long)kThreads * kQuads;
constexpr int kSharedBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int bin_of(int label, int pred, int k) {
  return ((unsigned)label < (unsigned)k && (unsigned)pred < (unsigned)k)
             ? label * k + pred
             : -1;
}

// Every lane of the warp calls this with its key (-1: nothing to add).
__device__ __forceinline__ void add_merged(unsigned* hist, int key,
                                           unsigned weight, int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&hist[key], weight * (unsigned)__popc(peers));
  }
}

__device__ __forceinline__ void add_quad(unsigned* hist, int4 label,
                                         int4 pred, int k, int lane) {
  const int b0 = bin_of(label.x, pred.x, k);
  const int b1 = bin_of(label.y, pred.y, k);
  const int b2 = bin_of(label.z, pred.z, k);
  const int b3 = bin_of(label.w, pred.w, k);
  const bool same = b0 == b1 && b1 == b2 && b2 == b3;
  add_merged(hist, same ? b0 : -1, 4u, lane);
  if (!same) {
    if (b0 >= 0) atomicAdd(&hist[b0], 1u);
    if (b1 >= 0) atomicAdd(&hist[b1], 1u);
    if (b2 >= 0) atomicAdd(&hist[b2], 1u);
    if (b3 >= 0) atomicAdd(&hist[b3], 1u);
  }
}

// Pixels [head, head + 4 * quads) are read 16 bytes at a time; the others
// of [0, n) one at a time.
__global__ void __launch_bounds__(kThreads)
confusion_kernel(const int* __restrict__ preds, const int* __restrict__ labels,
                 long long n, long long head, long long quads, int k,
                 int copies, unsigned long long* __restrict__ total) {
  extern __shared__ unsigned hist[];
  const int bins = k * k;
  for (int i = threadIdx.x; i < bins * copies; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* mine = hist + (warp % copies) * bins;

  const int4* preds4 = reinterpret_cast<const int4*>(preds + head);
  const int4* labels4 = reinterpret_cast<const int4*>(labels + head);
  const long long tiles = (quads + kTileQuads - 1) / kTileQuads;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int4 p[kQuads], l[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const long long i = tile * kTileQuads + q * kThreads + threadIdx.x;
      if (i < quads) {
        p[q] = __ldcs(preds4 + i);
        l[q] = __ldcs(labels4 + i);
      } else {
        p[q] = make_int4(0, 0, 0, 0);
        l[q] = make_int4(-1, -1, -1, -1);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) add_quad(mine, l[q], p[q], k, lane);
  }

  // the scalar pixels: the head, then the tail after the last quad
  const long long vec_end = head + 4 * quads;
  const long long scalar = head + (n - vec_end);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32;
       base < scalar; base += stride) {
    const long long s = base + lane;
    int key = -1;
    if (s < scalar) {
      const long long i = s < head ? s : vec_end + (s - head);
      key = bin_of(labels[i], preds[i], k);
    }
    add_merged(mine, key, 1u, lane);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < bins; i += kThreads) {
    unsigned sum = 0;
    for (int c = 0; c < copies; ++c) sum += hist[c * bins + i];
    if (sum) atomicAdd(total + i, (unsigned long long)sum);
  }
}

}  // namespace

// Adds the counts of n (prediction, label) pairs into total, [k, k] 64-bit
// integers, row = label. Returns a cudaError_t as int (0 on success).
extern "C" int confusion_accumulate_launch(const int* preds, const int* labels,
                                           long long n, int k,
                                           unsigned long long* total,
                                           void* stream) {
  if (n <= 0) return 0;
  const int bins = k * k;
  int copies = kSharedBytes / (int)(sizeof(unsigned) * bins);
  if (copies > kWarps) copies = kWarps;
  if (copies < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) * (size_t)bins * copies;

  const uintptr_t pa = reinterpret_cast<uintptr_t>(preds);
  const uintptr_t la = reinterpret_cast<uintptr_t>(labels);
  long long head = n;  // pointers misaligned to each other: all scalar
  if (((pa ^ la) & 15) == 0) {
    head = (long long)(((16 - (pa & 15)) & 15) / sizeof(int));
    if (head > n) head = n;
  }
  const long long quads = (n - head) / 4;
  const long long scalar = n - 4 * quads;

  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return (int)status;
  static int sm_count[kMaxDevices];
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[device] == 0) {
    status = cudaDeviceGetAttribute(&sm_count[device],
                                    cudaDevAttrMultiProcessorCount, device);
    if (status != cudaSuccess) return (int)status;
  }
  int per_sm = 0;
  status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, confusion_kernel, kThreads, smem);
  if (status != cudaSuccess) return (int)status;
  if (per_sm < 1) per_sm = 1;

  const long long wave = (long long)sm_count[device] * per_sm;
  long long blocks = (quads + kTileQuads - 1) / kTileQuads;
  const long long scalar_blocks = (scalar + kTileQuads * 4 - 1) /
                                  (kTileQuads * 4);
  if (scalar_blocks > blocks) blocks = scalar_blocks;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  confusion_kernel<<<(unsigned)blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      preds, labels, n, head, quads, k, copies, total);
  return (int)cudaGetLastError();
}

extern "C" const char* confusion_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
