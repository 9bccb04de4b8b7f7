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
// Design. The TPU kernel's layout (CHW rows padded to 400 lanes, 8-row
// blocks, junk pad columns) serves the TPU's (8, 128) tiling and is not
// carried over: this kernel reads and writes the NHWC tensors in place.
// It is an implicit GEMM with M = output pixels, N = Cout, K = 9*Cin:
//   * a block of 4 warps owns a tile of 8 rows x 16 columns of output
//     pixels and one chunk of up to 64 output channels; it is persistent,
//     loading the chunk's [9*Cin, 64] weights into shared memory once and
//     then walking over spatial tiles;
//   * per tile it loads the haloed (8+2) x (16+2) x Cin input patch into
//     shared memory with 16-byte loads, zeroes outside the image;
//   * each warp computes 2 output rows (two m16 tiles of 16 pixels) x 64
//     channels (eight n8 tiles) with mma.sync m16n8k16 bf16 -> f32: the A
//     fragments are ldmatrix loads of 16 shifted pixels of the patch (one
//     tap (dy, dx), 16 input channels), the B fragments ldmatrix.trans
//     loads of the weights. Rows of both are padded by 16 bytes in shared
//     memory, so the eight 16-byte rows of an ldmatrix hit distinct banks;
//   * the epilogue adds the bias, applies ReLU and stores bf16 pairs.
// The two blocks an SM holds overlap one's patch load with the other's
// products. TMA, wgmma and staged 16-byte output stores are later work.
// Needs Cin % 16 == 0 and Cout % 8 == 0 (the wrapper checks). The
// [9*Cin, 64] weight chunk and the patch fit an H100 block's 227 KB of
// shared memory up to Cin = 128; beyond it the launcher returns the error
// of cudaFuncSetAttribute. Nothing is allocated here; the launch goes on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 2 * kWarps;  // two m16 tiles (rows) per warp
constexpr int kTileCols = 16;          // one m16 tile is 16 pixels of a row
constexpr int kChunk = 64;             // output channels per block
constexpr int kNTiles = kChunk / 8;
constexpr int kPad = 8;                // bf16 values of padding per row
constexpr int kWRow = kChunk + kPad;   // shared weight row, bf16 values

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wmat,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, int batch, int height,
                 int width, int cin, int cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cin_row = cin + kPad;  // shared patch pixel, bf16 values
  const int k_total = 9 * cin;
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = s_w + (size_t)k_total * kWRow;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int co0 = blockIdx.y * kChunk;
  const int n_valid = min(kNTiles, (cout - co0) / 8);

  // this chunk's weights, once: rows of 9*Cin, n_valid*8 channels each
  {
    const int vecs = n_valid;  // 16-byte vectors (8 channels) per row
    for (int i = tid; i < k_total * vecs; i += kThreads) {
      const int row = i / vecs;
      const int v = i - row * vecs;
      const uint4 val = *reinterpret_cast<const uint4*>(
          wmat + (size_t)row * cout + co0 + v * 8);
      *reinterpret_cast<uint4*>(s_w + row * kWRow + v * 8) = val;
    }
  }

  const int tiles_x = (width + kTileCols - 1) / kTileCols;
  const int tiles_y = (height + kTileRows - 1) / kTileRows;
  const long long n_tiles = (long long)batch * tiles_y * tiles_x;
  const int vpp = cin / 8;  // 16-byte vectors per pixel
  const int patch_w = kTileCols + 2;
  const int patch_vecs = (kTileRows + 2) * patch_w * vpp;

  // ldmatrix row addresses: lane -> (matrix j, row i)
  const int mj = lane >> 3;
  const int mi = lane & 7;
  // A (16 pixels x 16 channels): matrices ordered rows 0-7 / 8-15, then
  // channels 0-7 / 8-15
  const int a_pix = mi + (mj & 1) * 8;
  const int a_k = (mj >> 1) * 8;
  // B (16 channels-in x 2 n8 tiles), transposed loads: matrices ordered
  // k 0-7 / 8-15 of tile nt, then of tile nt + 1
  const int b_k = mi + (mj & 1) * 8;
  const int b_n = (mj >> 1) * 8;
  const int g = lane >> 2;  // accumulator row (pixel) within an m16 tile
  const int t4 = lane & 3;  // accumulator column pair within an n8 tile

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = (int)(rest % tiles_y);
    const int n = (int)(rest / tiles_y);
    const int y0 = ty * kTileRows;
    const int x0 = tx * kTileCols;

    __syncthreads();  // the previous tile's products are done with s_x
    for (int i = tid; i < patch_vecs; i += kThreads) {
      const int pix = i / vpp;
      const int v = i - pix * vpp;
      const int py = pix / patch_w;
      const int px = pix - py * patch_w;
      const int gy = y0 - 1 + py;
      const int gx = x0 - 1 + px;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
        val = *reinterpret_cast<const uint4*>(
            x + (((size_t)n * height + gy) * width + gx) * cin + v * 8);
      }
      *reinterpret_cast<uint4*>(s_x + pix * cin_row + v * 8) = val;
    }
    __syncthreads();

    float acc[2][kNTiles][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      for (int kc = 0; kc < cin; kc += 16) {
        const int krow = tap * cin + kc;
        uint32_t b[kNTiles][2];
#pragma unroll
        for (int nt = 0; nt < kNTiles; nt += 2) {
          if (nt < n_valid) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                smem_addr(s_w + (krow + b_k) * kWRow + nt * 8 + b_n), r);
            b[nt][0] = r[0];
            b[nt][1] = r[1];
            b[nt + 1][0] = r[2];
            b[nt + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = warp * 2 + mt + dy;  // patch row
          uint32_t a[4];
          ldmatrix_x4(smem_addr(s_x + (row * patch_w + a_pix + dx) * cin_row
                                + kc + a_k), a);
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            if (nt < n_valid) mma_bf16(acc[mt][nt], a, b[nt]);
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int gy = y0 + warp * 2 + mt;
      if (gy >= height) continue;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        if (nt >= n_valid) continue;
        const int co = co0 + nt * 8 + 2 * t4;
        const float b0 = __ldg(bias + co);
        const float b1 = __ldg(bias + co + 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gx = x0 + g + half * 8;
          if (gx >= width) continue;
          const float v0 = fmaxf(acc[mt][nt][2 * half] + b0, 0.0f);
          const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + b1, 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(
              y + (((size_t)n * height + gy) * width + gx) * cout + co) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

size_t smem_bytes(int cin) {
  return sizeof(__nv_bfloat16) *
         ((size_t)9 * cin * kWRow +
          (size_t)(kTileRows + 2) * (kTileCols + 2) * (cin + kPad));
}

}  // namespace

extern "C" int stem_conv_launch(const void* x, const void* wmat,
                                const float* bias, void* y, int batch,
                                int height, int width, int cin, int cout,
                                void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (cin <= 0 || cin % 16 != 0 || cout <= 0 || cout % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(cin);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)err;
  }
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_conv_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  const int chunks = (cout + kChunk - 1) / kChunk;
  const long long tiles = (long long)batch *
                          ((height + kTileRows - 1) / kTileRows) *
                          ((width + kTileCols - 1) / kTileCols);
  long long resident = (long long)sms * per_sm / chunks;
  if (resident < 1) resident = 1;
  const unsigned grid_x = (unsigned)(tiles < resident ? tiles : resident);
  stem_conv_kernel<<<dim3(grid_x, chunks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wmat), bias,
      static_cast<__nv_bfloat16*>(y), batch, height, width, cin, cout);
  return (int)cudaGetLastError();
}

extern "C" const char* stem_conv_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
