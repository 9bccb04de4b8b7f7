// 3x3 SAME convolution + bias + ReLU for Hopper (sm_90a), bf16 in and out.
//
// Replaces: scripts/pallas_stem_conv_probe.py, `conv3x3_rowlanes` (body
// `_kernel`), the probe of the VGG16 stem conv at conv1_2.
//
// Function, NHWC activations and an HWIO kernel reshaped to [9*Cin, Cout]:
//   y[n, h, w, co] = bf16(relu(sum_{dy, dx, ci} x[n, h+dy-1, w+dx-1, ci]
//                                   * wmat[(dy*3 + dx)*Cin + ci, co]
//                               + bias[co]))
// with x zero outside the image, stride 1, float32 accumulation and a
// float32 bias.
//
// Bound: at conv1_2 of the flagship (1 x 768 x 384, 64 -> 64) the call
// reads 37.7 MB of input and writes 37.7 MB of output (75.57 MB with the
// weights and bias: 22.6 us at 3.35 TB/s) and does 21.74 GFLOP (22.0 us at
// the 989 TFLOP/s bf16 tensor-core rate): the two bounds are about equal,
// so the kernel has to keep both the memory and the tensor cores busy.
//
// Design: an implicit GEMM on wgmma, D[co, pixel] += W[co, k] * P[k, pixel]
// with M = 64 output channels, N = 64 output pixels of one image row and
// K = 9*Cin, both operands read from shared memory through descriptors in
// the no-swizzle core-matrix layout (a core matrix is 8 rows of 16 bytes,
// contiguous, 8 bf16 values of K per row):
//   * the weights (A) are pre-packed on the host (ops/cuda/stem_conv.py,
//     `pack_weights`) into [Cout/64][9*Cin/16][8 co groups][2 k halves]
//     [8 co][8 k], so a block copies its chunk of 64 output channels into
//     shared memory as it lies, once, with cp.async, under the first patch
//     load; the step of 16 K values is a 2 KB tile (LBO 128 B between the
//     k halves, SBO 256 B between groups of 8 channels);
//   * the input patch (B) of a tile, (kTileRows + 2) x (kTileW + 2) haloed
//     pixels, lies channel-group-major, [Cin/8][pixel][8]: 8 consecutive
//     pixels of 8 channels are one contiguous core matrix, so the operand
//     of tap (dy, dx) is the same descriptor moved by (dy*(kTileW+2) + dx)
//     * 16 bytes, SBO 128 B between groups of 8 pixels, LBO one channel
//     plane. A plane is padded by 16 bytes, so the 16-byte copies of
//     neighbouring channel groups land in distinct banks;
//   * the patch goes through a ring of two stages filled by 16-byte
//     cp.async with zero fill outside the image (SAME padding, any N, H,
//     W); a stage holds `cg` input channels (a multiple of 16 that divides
//     Cin, chosen on the host so that the weights and the ring fit 227 KB),
//     and one step of the ring is (tile, channel chunk). The load of step
//     i + 1 runs under the products of step i;
//   * a block is persistent, one per SM, with two warpgroups; a tile is
//     kTileRows = 4 output rows x kTileW = 64 columns, two rows per
//     warpgroup, each row a chain of m64n64k16 wgmmas into 32 float32
//     accumulators a thread;
//   * the epilogue adds the bias, applies ReLU, converts to bf16, stages a
//     row of the tile in shared memory as [pixel][channel] and writes it out
//     with 16-byte stores. Pixels past W or H and channels past Cout are
//     computed (on zeros) and not stored.
// Needs Cin % 16 == 0, Cin <= 128 (the stem convs; the launcher refuses a
// larger Cin) and Cout % 8 == 0 (the wrapper checks). Nothing is
// allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;
constexpr int kRowsPerGroup = 2;
constexpr int kTileRows = kWarpgroups * kRowsPerGroup;
constexpr int kTileW = 64;                    // N of the wgmma
constexpr int kPatchW = kTileW + 2;
constexpr int kPatchPixels = (kTileRows + 2) * kPatchW;
constexpr int kPlane = (kPatchPixels + 1) * 16;  // bytes, one channel group
constexpr int kChunk = 64;                    // output channels, M of wgmma
constexpr int kStepBytes = kChunk * 16 * 2;   // weights of 16 K values
constexpr int kOutRow = kChunk + 8;           // staged pixel, bf16 values
constexpr int kStages = 2;
constexpr int kMaxCin = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(size)
               : "memory");
}

// shared memory descriptor of a no-swizzle core-matrix operand
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

struct Geometry {
  int height, width, cin, cout, cg;
  int tiles_x, tiles_y;
  long long n_tiles;
};

// Queue the cp.async copies of ring step `step` of this block: the haloed
// patch of its tile, channels [chunk*cg, (chunk+1)*cg), into `stage`.
__device__ __forceinline__ void load_patch(const __nv_bfloat16* x,
                                           uint32_t stage, long long tile,
                                           int chunk, const Geometry& g) {
  const int tx = (int)(tile % g.tiles_x);
  const long long rest = tile / g.tiles_x;
  const int ty = (int)(rest % g.tiles_y);
  const int n = (int)(rest / g.tiles_y);
  const int y0 = ty * kTileRows - 1;
  const int x0 = tx * kTileW - 1;
  const int groups = g.cg / 8;
  const int c0 = chunk * g.cg;
  for (int i = threadIdx.x; i < kPatchPixels * groups; i += kThreads) {
    const int grp = i % groups;
    const int pix = i / groups;
    const int gy = y0 + pix / kPatchW;
    const int gx = x0 + pix % kPatchW;
    const bool inside = gy >= 0 && gy < g.height && gx >= 0 && gx < g.width;
    const __nv_bfloat16* src =
        inside ? x + (((size_t)n * g.height + gy) * g.width + gx) * g.cin +
                     c0 + grp * 8
               : x;
    cp_async16(stage + grp * kPlane + pix * 16, src, inside);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
stem_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wpack,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int k_steps = 9 * g.cin / 16;
  const uint32_t s_w = smem_addr(smem_raw);
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (size_t)k_steps * kStepBytes);  // [group][kTileW][kOutRow]
  const uint32_t s_ring =
      smem_addr(s_out + kWarpgroups * kTileW * kOutRow);
  const uint32_t stage_bytes = (g.cg / 8) * kPlane;

  const int tid = threadIdx.x;
  const int group = tid / 128;  // warpgroup
  const int gtid = tid % 128;
  const int warp = gtid / 32;
  const int lane = tid % 32;
  const int co0 = blockIdx.y * kChunk;
  const int chunks = g.cin / g.cg;
  const long long my_tiles =
      g.n_tiles > blockIdx.x
          ? (g.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;
  const long long steps = my_tiles * chunks;
  if (steps == 0) return;

  // this chunk's packed weights, as they lie, with the first patch
  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        wpack + (size_t)blockIdx.y * k_steps * (kStepBytes / 2));
    for (int i = tid; i < k_steps * kStepBytes / 16; i += kThreads) {
      cp_async16(s_w + i * 16, src + (size_t)i * 16, true);
    }
  }
  load_patch(x, s_ring, blockIdx.x, 0, g);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the two output channels of this thread's accumulator rows
  const int row_co = warp * 16 + lane / 4;
  const float bias0 = co0 + row_co < g.cout ? __ldg(bias + co0 + row_co)
                                            : 0.0f;
  const float bias1 = co0 + row_co + 8 < g.cout
                          ? __ldg(bias + co0 + row_co + 8)
                          : 0.0f;
  const int valid_co = min(kChunk, g.cout - co0);

  float acc[kRowsPerGroup][32];
  for (long long step = 0; step < steps; ++step) {
    const long long tile = blockIdx.x + (step / chunks) * gridDim.x;
    const int chunk = (int)(step % chunks);
    if (step + 1 < steps) {
      const long long next = step + 1;
      load_patch(x, s_ring + (uint32_t)(next % kStages) * stage_bytes,
                 blockIdx.x + (next / chunks) * gridDim.x,
                 (int)(next % chunks), g);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // the copies are generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int tx = (int)(tile % g.tiles_x);
    const long long rest = tile / g.tiles_x;
    const int ty = (int)(rest % g.tiles_y);
    const int n = (int)(rest / g.tiles_y);
    const int row0 = group * kRowsPerGroup;  // first tile row of the group
    // rows past H are computed on the zero-filled patch and not stored
    const int rows = min(kRowsPerGroup, g.height - ty * kTileRows - row0);

    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[r][i] = 0.0f;
    }
    const uint32_t stage = s_ring + (uint32_t)(step % kStages) * stage_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      for (int c16 = 0; c16 < g.cg / 16; ++c16) {
        const int k_step = (tap * g.cin + chunk * g.cg) / 16 + c16;
        const uint64_t a = descriptor(s_w + k_step * kStepBytes, 128, 256);
        const uint32_t b_base = stage + 2 * c16 * kPlane +
                                ((row0 + dy) * kPatchW + dx) * 16;
#pragma unroll
        for (int r = 0; r < kRowsPerGroup; ++r) {
          wgmma_m64n64k16(acc[r], a,
                          descriptor(b_base + r * kPatchW * 16, kPlane, 128));
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    if (chunk == chunks - 1) {
      __nv_bfloat16* out = s_out + group * kTileW * kOutRow;
      const int x0 = tx * kTileW;
      const int vecs = valid_co / 8;  // 16-byte vectors of a pixel
#pragma unroll
      for (int r = 0; r < kRowsPerGroup; ++r) {
        if (r >= rows) continue;
        // accumulator (i, e): channel row_co + 8 * (e / 2), pixel
        // 8 * i + 2 * (lane % 4) + e % 2
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pix = 8 * i + 2 * (lane % 4) + (e & 1);
            const int co = row_co + 8 * (e >> 1);
            const float v = fmaxf(acc[r][4 * i + e] + (e >> 1 ? bias1 : bias0),
                                  0.0f);
            out[pix * kOutRow + co] = __float2bfloat16_rn(v);
          }
        }
        group_barrier(1 + group);
        const int gy = ty * kTileRows + row0 + r;
        for (int i = gtid; i < kTileW * vecs; i += 128) {
          const int pix = i / vecs;
          const int v = i - pix * vecs;
          const int gx = x0 + pix;
          if (gx < g.width) {
            *reinterpret_cast<uint4*>(
                y + (((size_t)n * g.height + gy) * g.width + gx) * g.cout +
                co0 + v * 8) =
                *reinterpret_cast<const uint4*>(out + pix * kOutRow + v * 8);
          }
        }
        group_barrier(1 + group);
      }
    }
    __syncthreads();  // this stage is refilled at the next step
  }
}

size_t smem_bytes(int cin, int cg) {
  return (size_t)9 * cin / 16 * kStepBytes +
         (size_t)kWarpgroups * kTileW * kOutRow * 2 +
         (size_t)kStages * (cg / 8) * kPlane;
}

}  // namespace

// wpack: the weights as ops/cuda/stem_conv.pack_weights lays them out;
// cg: input channels per ring stage (ops/cuda/stem_conv.tile_config).
extern "C" int stem_conv_launch(const void* x, const void* wpack,
                                const float* bias, void* y, int batch,
                                int height, int width, int cin, int cout,
                                int cg, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (cin <= 0 || cin % 16 != 0 || cin > kMaxCin || cout <= 0 ||
      cout % 8 != 0 || cg <= 0 || cg % 16 != 0 || cin % cg != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(cin, cg);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)err;
  }
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  Geometry g;
  g.height = height;
  g.width = width;
  g.cin = cin;
  g.cout = cout;
  g.cg = cg;
  g.tiles_x = (width + kTileW - 1) / kTileW;
  g.tiles_y = (height + kTileRows - 1) / kTileRows;
  g.n_tiles = (long long)batch * g.tiles_y * g.tiles_x;
  const int chunks = (cout + kChunk - 1) / kChunk;
  long long per_chunk = sms / chunks;
  if (per_chunk < 1) per_chunk = 1;
  const unsigned grid_x =
      (unsigned)(g.n_tiles < per_chunk ? g.n_tiles : per_chunk);
  stem_conv_kernel<<<dim3(grid_x, chunks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wpack), bias,
      static_cast<__nv_bfloat16*>(y), g);
  err = cudaGetLastError();
  return (int)err;
}

extern "C" const char* stem_conv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
