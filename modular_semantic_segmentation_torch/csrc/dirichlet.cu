// Fused Dirichlet classification for Hopper (sm_90a).
//
// Replaces: modular_semantic_segmentation_tpu/ops/pallas/dirichlet_kernel.py,
// `_kernel` (launched by `_run`).
//
// Function, per pixel p:
//   out[p] = argmax_c  sum_e sum_k log(1e-20 + probs_e[p, k]) * a[e, k, c]
//                      + bias[c]
// with a = sigma * alpha - 1 and bias = log(1e-20 + prior) - sum_e log B(
// sigma * alpha_e), both precomputed by the caller (the bias in float64 on
// the host, with gammaln). The first maximum wins ties, as jnp.argmax.
// No [pixels, C] score tensor is written.
//
// Bound. The bytes: the probabilities are read once (E*P*K values, float32
// or bfloat16) and one int32 per pixel is written; at the flagship (E = 2,
// P = 768*384, K = C = 14, bfloat16) 17.7 MB, 5.3 us at 3.35 TB/s. The
// arithmetic: per pixel E*K logs and E*K*C float32 FMAs, which with
// accurate logf is about 1,300 thread instructions, 0.38 G at the flagship,
// about 12 us of issue on 132 SMs. So instruction issue, not memory, sets
// the floor, and the design takes every instruction it can off the path
// beside the FMAs.
//
// Design:
//   * the experts are read in place: the launcher takes E pointers (at most
//     kMaxExperts) and passes them by value, so no stacked copy is made;
//   * the coefficients and the bias go by value too, as launch parameters
//     in the constant bank: an FMA reads its coefficient through the
//     uniform datapath, with no shared-memory load (coefficients in shared
//     memory cost 7 broadcast loads per 14 FMAs, and the loads, not the
//     FMAs, set the pace);
//   * bfloat16 logs come from a table in shared memory: entry i is
//     log(1e-20 + v) for the v whose bits are i, made by the plain version's
//     own operations (ops/cuda/dirichlet.py, `log_table`), so they equal
//     its logs bit for bit. The table holds every value in [0, 1]; a pixel
//     with a value outside takes logf for all its values. float32 values
//     go through logf (accurate, as the plain version's torch.log);
//   * the grid is sized to the card (kBlocksPerSm resident blocks an SM)
//     and is persistent: block b takes slabs of kSlab pixels b, b + grid,
//     ... so the SMs finish within a slab of each other;
//   * a slab of each expert is contiguous in memory and starts at a
//     multiple of kSlab pixels, so it is copied with 16-byte cp.async into
//     a ring of kStages stages: the loads of a block's next slabs run under
//     the arithmetic of its current one. (The last bytes of the last slab,
//     when not a multiple of 16, are copied one value a thread);
//   * each thread takes kPixPerThread pixels and reads their values
//     straight from the ring (a pixel row of K values, 28 bytes in bfloat16
//     at K = 14, is 7 words from its neighbour's, so a warp's reads hit
//     distinct banks). Where K = C is even and at most 16 (the flagship's
//     14), K is a compile-time constant: a pixel's values come two at a
//     time, its K table loads issue back to back, and every coefficient is
//     named by constant indices;
//   * the classes go in chunks of CC, a compile-time even width chosen by
//     the launcher (CC = C rounded up to even, at most 16): C = 14 runs
//     exactly 14 classes in one chunk. Padded classes have zero
//     coefficients and a bias of -inf, so they never win.
// Float32 FMAs and exact logs keep the scores within rounding of the plain
// version's (a tensor-core product or __logf would not). Nothing is
// allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 1;
constexpr int kSlab = kThreads * kPixPerThread;  // pixels per slab
constexpr int kStages = 3;
// blocks an SM runs at once: few enough that each block walks several
// slabs, so its loads run under its own arithmetic
constexpr int kBlocksPerSm = 2;
constexpr int kMaxExperts = 4;
constexpr int kMaxChunk = 16;  // classes per chunk
// the by-value coefficients of a K other than C: at most kMaxCoefficients
// (chunk-major, padded) and kMaxClasses classes
constexpr int kMaxCoefficients = 4096;
constexpr int kMaxClasses = 256;
// entries of the bfloat16 log table: bit patterns 0 .. 0x3F87, every
// value in [0, 1] and a few above, rounded up to 16-byte copies
constexpr int kTableSize = 16264;

struct ExpertPtrs {
  const void* p[kMaxExperts];
};

// log(1e-20 + v): float32 values through logf; a bfloat16 value from the
// block's table of the same logs where its bits are below kTableSize
__device__ __forceinline__ float log_p(float v, const float*) {
  return logf(1e-20f + v);
}

__device__ __forceinline__ float log_bits(unsigned bits,
                                          const float* table) {
  if (bits < kTableSize) return table[bits];
  return logf(1e-20f + __uint_as_float(bits << 16));
}

__device__ __forceinline__ float log_p(__nv_bfloat16 v, const float* table) {
  return log_bits(__bfloat16_as_ushort(v), table);
}

// the logs of a pixel's K values, K even, read two values at a time
template <int KK>
__device__ __forceinline__ void load_logs(const float* src, float* lp,
                                          const float* table) {
  const float2* v = reinterpret_cast<const float2*>(src);
#pragma unroll
  for (int i = 0; i < KK / 2; ++i) {
    const float2 pair = v[i];
    lp[2 * i] = log_p(pair.x, table);
    lp[2 * i + 1] = log_p(pair.y, table);
  }
}

// bfloat16: every lookup unconditional, so the K loads issue back to
// back; a pixel with a value past the table (above 1.05, negative or NaN)
// takes logf for all its values, a branch that is almost never taken
template <int KK>
__device__ __forceinline__ void load_logs(const __nv_bfloat16* src,
                                          float* lp, const float* table) {
  const uint32_t* v = reinterpret_cast<const uint32_t*>(src);
  unsigned bits[KK];
  unsigned widest = 0;
#pragma unroll
  for (int i = 0; i < KK / 2; ++i) {
    const uint32_t pair = v[i];
    bits[2 * i] = pair & 0xFFFFu;
    bits[2 * i + 1] = pair >> 16;
    widest = max(widest, max(bits[2 * i], bits[2 * i + 1]));
  }
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    lp[kk] = table[min(bits[kk], (unsigned)kTableSize - 1)];
  }
  if (widest >= kTableSize) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      lp[kk] = logf(1e-20f + __uint_as_float(bits[kk] << 16));
    }
  }
}

// acc[j][c] += lp[j] * row[c] for the CC classes of a coefficient row
template <int CC>
__device__ __forceinline__ void accumulate(float (*acc)[CC], const float* lp,
                                           const float* row) {
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    const float w = row[cc];
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      acc[j][cc] = fmaf(lp[j], w, acc[j][cc]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One slab of every expert into a stage of the ring: 16-byte cp.async
// for whole vectors, plain copies for a tail of fewer than 16 bytes.
template <typename T>
__device__ __forceinline__ void load_slab(const ExpertPtrs& probs, T* stage,
                                          long long start, int count,
                                          int experts, int k) {
  const int values = count * k;
  const int vecs = values * (int)sizeof(T) / 16;
  const int vec_values = 16 / (int)sizeof(T);
  for (int e = 0; e < experts; ++e) {
    // picked with constant indices, so the pointers stay in registers
    const void* base = probs.p[0];
#pragma unroll
    for (int i = 1; i < kMaxExperts; ++i) {
      if (i == e) base = probs.p[i];
    }
    const T* src = static_cast<const T*>(base) + start * k;
    T* dst = stage + e * kSlab * k;
    for (int v = threadIdx.x; v < vecs; v += kThreads) {
      cp_async16(dst + v * vec_values, src + v * vec_values);
    }
    for (int i = vecs * vec_values + threadIdx.x; i < values;
         i += kThreads) {
      dst[i] = src[i];
    }
  }
}

// The coefficients and the bias go to the kernel by value: they sit in the
// constant bank, where an FMA reads a coefficient as an operand, with no
// load and no shared memory. K = C known at compile time (even, at most
// 16) lays them out [E][K][C]; any other K chunk-major, [chunk][E][K][CC].
template <int KK, int CC>
struct KnownCoefficients {
  float a[kMaxExperts][KK][CC];
  float bias[CC];
};

struct RuntimeCoefficients {
  float a[kMaxCoefficients];
  float bias[kMaxClasses];  // padded to chunks * CC with -inf
};

template <int KK, int CC>
using Coefficients =
    std::conditional_t<(KK > 0), KnownCoefficients<KK, CC>,
                       RuntimeCoefficients>;

// KK: K when it is known at compile time (even, read two values at a
// time), else 0
template <typename T, int KK, int CC>
__global__ void __launch_bounds__(kThreads)
dirichlet_label_kernel(ExpertPtrs probs,
                       const __grid_constant__ Coefficients<KK, CC> coeffs,
                       const float* __restrict__ log_table,
                       int* __restrict__ out, long long pixels, int experts,
                       int k, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bfloat16 only: the table of log(1e-20 + v) by the bits of v
  float* s_table = reinterpret_cast<float*>(smem_raw);
  constexpr int table_floats = sizeof(T) == 2 ? kTableSize : 0;
  // [stage][E][kSlab][K]
  T* ring = reinterpret_cast<T*>(s_table + table_floats);
  const int stage_values = experts * kSlab * k;
  const int tid = threadIdx.x;

  const long long n_slabs = (pixels + kSlab - 1) / kSlab;
  long long slab = blockIdx.x;
  if (slab >= n_slabs) return;
  // pixels of the slab that starts at `start` (all but the last: kSlab)
  auto count_at = [pixels](long long start) {
    return (int)min((long long)kSlab, pixels - start);
  };

  for (int v = tid; v < table_floats / 4; v += kThreads) {
    cp_async16(s_table + 4 * v, log_table + 4 * v);
  }
  // the ring's first kStages - 1 slabs, one commit group each (the first
  // with the table)
  for (int i = 0; i < kStages - 1; ++i) {
    const long long ahead = slab + (long long)i * gridDim.x;
    if (ahead < n_slabs) {
      load_slab<T>(probs, ring + i * stage_values, ahead * kSlab,
                   count_at(ahead * kSlab), experts, k);
    }
    cp_async_commit();
  }

  for (int s = 0; slab < n_slabs; ++s, slab += gridDim.x) {
    const long long start = slab * kSlab;
    const int count = count_at(start);
    // kStages - 1 slabs ahead, into the stage the last step read
    const long long ahead =
        (slab + (long long)(kStages - 1) * gridDim.x) * kSlab;
    if (ahead < pixels) {
      load_slab<T>(probs,
                   ring + ((s + kStages - 1) % kStages) * stage_values,
                   ahead, count_at(ahead), experts, k);
    }
    cp_async_commit();  // an empty group near the block's last slab
    cp_async_wait<kStages - 1>();  // this step's slab has landed
    __syncthreads();

    const T* stage = ring + (s % kStages) * stage_values;
    int local[kPixPerThread];
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      // a pixel past the end reads pixel 0 of the stage; it is not stored
      local[j] = tid + j * kThreads;
      if (local[j] >= count) local[j] = 0;
    }
    int best[kPixPerThread];
    float best_score[kPixPerThread];
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      best[j] = 0;
      best_score[j] = -CUDART_INF_F;
    }
    const int chunks = KK > 0 ? 1 : (c + CC - 1) / CC;
    for (int q = 0; q < chunks; ++q) {
      float total[kPixPerThread][CC];
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) total[j][cc] = 0.0f;
      if constexpr (KK > 0) {
        // every coefficient index a constant: the experts unrolled
#pragma unroll
        for (int e = 0; e < kMaxExperts; ++e) {
          if (e >= experts) break;
          const T* src = stage + e * kSlab * KK;
          float lp[kPixPerThread][KK];
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j) {
            load_logs<KK>(src + local[j] * KK, lp[j], s_table);
          }
          float acc[kPixPerThread][CC];
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) acc[j][cc] = 0.0f;
          // coefficients named by constant indices: FMA operands straight
          // from the constant bank
#pragma unroll
          for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc)
#pragma unroll
              for (int j = 0; j < kPixPerThread; ++j)
                acc[j][cc] = fmaf(lp[j][kk], coeffs.a[e][kk][cc], acc[j][cc]);
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) total[j][cc] += acc[j][cc];
        }
      } else {
        for (int e = 0; e < experts; ++e) {
          const T* src = stage + e * kSlab * k;
          const float* a = coeffs.a + (q * experts + e) * k * CC;
          float acc[kPixPerThread][CC];
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) acc[j][cc] = 0.0f;
          for (int kk = 0; kk < k; ++kk) {
            float lp[kPixPerThread];
#pragma unroll
            for (int j = 0; j < kPixPerThread; ++j) {
              lp[j] = log_p(src[local[j] * k + kk], s_table);
            }
            accumulate<CC>(acc, lp, a + kk * CC);
          }
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) total[j][cc] += acc[j][cc];
        }
      }
#pragma unroll
      for (int j = 0; j < kPixPerThread; ++j) {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float score = total[j][cc] + coeffs.bias[q * CC + cc];
          if (score > best_score[j]) {
            best_score[j] = score;
            best[j] = q * CC + cc;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const int p = tid + j * kThreads;
      if (p < count) out[start + p] = best[j];
    }
    __syncthreads();  // the next step refills this stage
  }
}

size_t smem_bytes(int experts, int k, size_t value_bytes) {
  const size_t table = value_bytes == 2 ? kTableSize * sizeof(float) : 0;
  return table + (size_t)kStages * experts * kSlab * k * value_bytes;
}

// The kernel's coefficients from the host's [E, K, C] coefficients and
// [C] bias, in its layout; padded classes get zero coefficients and a bias
// of -inf, so they never win.
template <int KK, int CC>
void fill(const float* a, const float* bias, int experts, int k, int c,
          Coefficients<KK, CC>* out) {
  const int chunks = KK > 0 ? 1 : (c + CC - 1) / CC;
  for (int q = 0; q < chunks; ++q) {
    for (int e = 0; e < experts; ++e) {
      for (int kk = 0; kk < k; ++kk) {
        for (int cc = 0; cc < CC; ++cc) {
          const int cls = q * CC + cc;
          const float v = cls < c ? a[((size_t)e * k + kk) * c + cls] : 0.0f;
          if constexpr (KK > 0) {
            out->a[e][kk][cc] = v;
          } else {
            out->a[((q * experts + e) * k + kk) * CC + cc] = v;
          }
        }
      }
    }
    for (int cc = 0; cc < CC; ++cc) {
      const int cls = q * CC + cc;
      out->bias[cls] = cls < c ? bias[cls] : -INFINITY;
    }
  }
}

template <typename T, int KK, int CC>
cudaError_t launch(const ExpertPtrs& probs, const float* coeffs,
                   const float* bias, const float* log_table, int* out,
                   long long pixels, int experts, int k, int c,
                   cudaStream_t stream) {
  const int chunks = KK > 0 ? 1 : (c + CC - 1) / CC;
  if (KK == 0 && (chunks * experts * k * CC > kMaxCoefficients ||
                  chunks * CC > kMaxClasses)) {
    return cudaErrorInvalidValue;
  }
  Coefficients<KK, CC> table = {};
  fill<KK, CC>(coeffs, bias, experts, k, c, &table);
  auto kernel = dirichlet_label_kernel<T, KK, CC>;
  const size_t smem = smem_bytes(experts, k, sizeof(T));
  // the attribute and the occupancy, per instance, for the last shared
  // memory size it launched with: serving launches the same one each frame
  static size_t last_smem = 0;
  static int last_device = -1, sms = 0, per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem != last_smem || device != last_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_smem = smem;
    last_device = device;
  }
  const long long slabs = (pixels + kSlab - 1) / kSlab;
  long long grid = (long long)sms * min(per_sm, kBlocksPerSm);
  if (grid > slabs) grid = slabs;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      probs, table, log_table, out, pixels, experts, k, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const ExpertPtrs& probs, const float* coeffs,
                     const float* bias, const float* log_table, int* out,
                     long long pixels, int experts, int k, int c,
                     cudaStream_t stream) {
  const int even = (c + 1) / 2 * 2;
  const int cc = even < kMaxChunk ? even : kMaxChunk;
  // K == C, even and at most 16 (the flagship's 14) is compiled with K
  // known; any other K is read one value at a time
  const bool known = k == c && k == cc;
#define DIRICHLET_CASE(W)                                                   \
  case W:                                                                   \
    return known ? launch<T, W, W>(probs, coeffs, bias, log_table, out,     \
                                   pixels, experts, k, c, stream)           \
                 : launch<T, 0, W>(probs, coeffs, bias, log_table, out,     \
                                   pixels, experts, k, c, stream)
  switch (cc) {
    DIRICHLET_CASE(2);
    DIRICHLET_CASE(4);
    DIRICHLET_CASE(6);
    DIRICHLET_CASE(8);
    DIRICHLET_CASE(10);
    DIRICHLET_CASE(12);
    DIRICHLET_CASE(14);
    DIRICHLET_CASE(16);
  }
#undef DIRICHLET_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// probs: host array of `experts` device pointers, each [pixels, k] and
// 16-byte aligned (the wrapper checks). coeffs [experts, k, c] and bias [c]:
// host float32, copied into the launch's parameters. log_table: for bfloat16 probs,
// kTableSize floats, entry i = log(1e-20 + the bfloat16 of bits i) as the
// plain version computes it (ops/cuda/dirichlet.py, `log_table`); unused
// for float32.
extern "C" int dirichlet_label_launch(const void* const* probs,
                                      int probs_bf16, const float* coeffs,
                                      const float* bias,
                                      const float* log_table, int* out,
                                      long long pixels, int experts, int k,
                                      int c, void* stream) {
  if (probs_bf16 && log_table == nullptr) return (int)cudaErrorInvalidValue;
  if (pixels <= 0) return 0;
  if (experts < 1 || experts > kMaxExperts || k < 1 || c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ExpertPtrs ptrs = {};
  for (int e = 0; e < experts; ++e) ptrs.p[e] = probs[e];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      probs_bf16
          ? dispatch<__nv_bfloat16>(ptrs, coeffs, bias, log_table, out,
                                    pixels, experts, k, c, s)
          : dispatch<float>(ptrs, coeffs, bias, log_table, out, pixels,
                            experts, k, c, s);
  if (err != cudaSuccess) cudaGetLastError();  // clear a refused launch
  return (int)err;
}

extern "C" const char* dirichlet_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
