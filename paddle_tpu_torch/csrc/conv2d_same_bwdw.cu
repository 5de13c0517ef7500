// Filter gradient of the stride-1 SAME convolution (odd square kernel,
// k in {1, 3}) for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py
//   _conv_bwdw_kernel  (:226, called by _bwd_filter_impl :252, "K8")
//
// Function (x [N, H, W, C] NHWC, dy [N, H, W, F], both float32 or both
// bfloat16):
//   dw[dh,dw,c,f] = sum_{n,h,w} x[n, h+dh-k/2, w+dw-k/2, c] * dy[n,h,w,f]
// with positions outside the image counted as zero, summed in float32 and
// returned float32 [k, k, C, F] (the caller casts it to w's dtype). The
// bfloat16 TPU kernel multiplies bfloat16 operands with float32
// accumulation (:237-249); so do the tensor cores here.
//
// Design: the GEMM dW[R, F] = Z^T[R, M] . dY[M, F] with R = k*k*C rows in
// (tap, channel) order (dW's HWIO memory order) and a reduction over the
// M = N*H*W positions, which is long (207,936 at ResNet-50's stage 2, batch
// 64) while the output is small (at most 4608 x 512). On the TPU the grid
// ran in order and carried the sum in the output block from one image to
// the next; blocks on this card run in no order, so M is split instead:
//   pass 1  block (filter tile, row tile, split s) sums its 128 rows x 64
//           (or 128) filters over the s-th contiguous range of positions
//           and writes
//           the float32 partial tile to workspace[s] (every entry, zeros
//           included);
//   pass 2  one thread per dW entry adds the S partials in the order
//           s = 0, 1, ..., S-1.
// No atomics, so the result is the same bit for bit from run to run. The
// split count S and the range length come from the caller's planner
// (ops/conv_kernels.bwdw_plan); S = 1 writes dW directly and skips pass 2.
//
// Both operand tiles of a chunk are stored position-major in shared
// memory: Z[p][r] (8 or 4 consecutive r are consecutive channels of one
// tap, C % 8 == 0, so one 16-byte copy each) and dY[p][f]. They arrive by
// cp.async through a 3-stage ring straight from NHWC x and dy: a border tap
// is a zero-fill (src-size 0), not a padded copy. Pass 1 has two paths,
// picked by dtype:
//   bfloat16  tensor cores: 256 threads, 8 warps of 32 rows x 32 filters
//             (x 64 in 128-filter tiles, taken where F >= 128: the tile's
//             copies are then spread over twice the products), chunks of
//             32 positions; ldmatrix.trans turns the
//             position-major tiles into the A (Z^T) and B (dY) fragments of
//             mma.sync.m16n8k16 bf16 with float32 accumulators. mma.sync
//             rather than wgmma: the A operand is the transpose of what is
//             stored and is gathered tap by tap, which ldmatrix.trans
//             handles per warp without the swizzled, descriptor-addressed
//             layout wgmma needs; wgmma is the next step for this kernel.
//   float32   CUDA cores (the function's products are full float32; TF32
//             stays off): 128 threads, each an 8 x 8 micro-tile (4 shared
//             loads for 64 FMA), chunks of 16 positions.
// Each loader thread copies one position of a chunk for a few row groups;
// it decodes its row groups' taps once and walks its position forward
// without a division, so a copy costs a few compares and an add.
//
// What bounds it on this card: 2*M*R*F operations on a few MB of operands,
// so the arithmetic rate (989 TFLOP/s bf16 on the tensor cores, 67 float32
// on the CUDA cores). The workspace round trip of pass 2 (S*R*F floats, a
// few MB per conv at the ResNet-50 shapes, mostly in L2) is small beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kPathTensorBf16 = 1;
constexpr int kPathFloat32 = 2;

constexpr int kBM = 128;  // dW rows (tap, channel) per block
constexpr int kBN = 64;   // filters per block
constexpr int kStages = 3;
constexpr int kReduceThreads = 256;

constexpr int kTcBK = 32;  // positions per chunk, tensor-core path
constexpr int kTcThreads = 256;
constexpr int kTcZLd = kBM + 8;  // 272-byte rows: ldmatrix conflict-free

constexpr int kF32BK = 16;  // positions per chunk, CUDA-core path
constexpr int kF32Threads = 128;

// error codes beside cudaError_t values (which are all >= 0)
constexpr int kErrBadArgument = -1;
constexpr int kErrTooLarge = -2;

// The position a loader thread copies in the current chunk, walked forward
// chunk by chunk without a division per chunk. In NHWC the position index
// m is also the pixel's index, so only (h, w) are kept for the border.
struct Position {
  long long m;
  int h, w;

  __device__ __forceinline__ void start(long long m0, int height,
                                        int width) {
    m = m0;
    w = static_cast<int>(m0 % width);
    h = static_cast<int>((m0 / width) % height);
  }

  __device__ __forceinline__ void advance(int step, int height, int width) {
    m += step;
    w += step;
    while (w >= width) {
      w -= width;
      if (++h == height) h = 0;
    }
  }
};

// A loader thread's dW row group, decoded once: the tap's offsets, the
// first channel, and the element offset of the tap from the pixel.
struct RowGroup {
  int dh, dw;
  long long offset;  // (dh * width + dw) * cin + channel
  bool ok;           // inside the R rows

  __device__ __forceinline__ void decode(int r, int rows, int cin, int ksize,
                                         int width) {
    ok = r < rows;
    const int rr = ok ? r : 0;
    const int tap = rr / cin;
    dh = tap / ksize - ksize / 2;
    dw = tap % ksize - ksize / 2;
    offset = (static_cast<long long>(dh) * width + dw) * cin + (rr - tap * cin);
  }
};

// One 16-byte segment of the Z tile: the channels of a row group at
// position p, shifted by its tap; zeros past R, past the range's end and
// outside the image (src-size 0).
template <typename T>
__device__ __forceinline__ void copy_z(T* dst, const T* __restrict__ x,
                                       const Position& p, long long m_end,
                                       const RowGroup& g, int cin,
                                       int height, int width) {
  const int ih = p.h + g.dh;
  const int iw = p.w + g.dw;
  const bool ok = g.ok && p.m < m_end && ih >= 0 && ih < height && iw >= 0 &&
                  iw < width;
  sm90::cp_async16(dst, ok ? x + p.m * cin + g.offset : x, ok ? 16 : 0);
}

// One 16-byte segment of the dY tile: filters f .. at position p.
template <typename T>
__device__ __forceinline__ void copy_dy(T* dst, const T* __restrict__ dy,
                                        const Position& p, long long m_end,
                                        int f, int cout) {
  const bool ok = f < cout && p.m < m_end;
  sm90::cp_async16(dst, ok ? dy + p.m * cout + f : dy, ok ? 16 : 0);
}

// ---------------------------------------------------------------------------
// Pass 1, bfloat16: tensor cores. BN = 128 filters where F allows it (the
// tile's loads are then spread over twice the products), else 64.

template <int BN>
constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(__nv_bfloat16)) * kStages * kTcBK *
         (kTcZLd + BN + 8);
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads)
bwdw_tc_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ dy, float* __restrict__ out,
             int n_img, int height, int width, int cin, int cout, int ksize,
             long long per_split) {
  constexpr int kYLd = BN + 8;  // 144- or 272-byte rows: conflict-free
  constexpr int kNT = BN / 16;  // n8 tiles of a warp (its 32 x BN/2)
  extern __shared__ __align__(16) unsigned char smem[];
  auto z_s = reinterpret_cast<__nv_bfloat16(*)[kTcBK][kTcZLd]>(smem);
  auto y_s = reinterpret_cast<__nv_bfloat16(*)[kTcBK][kYLd]>(
      smem + sizeof(__nv_bfloat16) * kStages * kTcBK * kTcZLd);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rows = ksize * ksize * cin;
  const int f0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * kBM;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m_begin = static_cast<long long>(blockIdx.z) * per_split;
  const long long m_end =
      m_begin + per_split < m_total ? m_begin + per_split : m_total;
  const int n_chunks =
      m_end > m_begin ? static_cast<int>((m_end - m_begin + kTcBK - 1) / kTcBK)
                      : 0;

  // loader: position slot j of the chunk; Z row groups q and q + 8 (8 rows
  // each), dY filter groups q + 8i (8 filters each)
  const int j = tid / 8;
  const int q = tid % 8;
  RowGroup za, zb;
  za.decode(r0 + q * 8, rows, cin, ksize, width);
  zb.decode(r0 + (q + 8) * 8, rows, cin, ksize, width);
  Position pos;
  pos.start(m_begin + j, height, width);
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const int st = chunk % kStages;
      copy_z(&z_s[st][j][q * 8], x, pos, m_end, za, cin, height, width);
      copy_z(&z_s[st][j][(q + 8) * 8], x, pos, m_end, zb, cin, height,
             width);
#pragma unroll
      for (int i = 0; i < BN / 64; ++i) {
        copy_dy(&y_s[st][j][(q + 8 * i) * 8], dy, pos, m_end,
                f0 + (q + 8 * i) * 8, cout);
      }
      pos.advance(kTcBK, height, width);
    }
    sm90::cp_async_commit();  // an empty group past the end keeps the count
  };

  const int wm = (warp % 4) * 32;  // the warp's 32 rows x BN/2 filters
  const int wn = (warp / 4) * (BN / 2);
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  load(0);
  load(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();  // this chunk has landed
    __syncthreads();           // ... for every thread; chunk-1 is consumed
    load(chunk + 2);
    const int st = chunk % kStages;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      uint32_t a[2][4], b[kNT / 2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sm90::ldmatrix_x4_trans(
            a[mt], &z_s[st][ks + (lane / 16) * 8 + lane % 8]
                        [wm + mt * 16 + ((lane / 8) % 2) * 8]);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        sm90::ldmatrix_x4_trans(
            b[np], &y_s[st][ks + lane % 8 + ((lane / 8) % 2) * 8]
                        [wn + np * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          sm90::mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
                         b[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  sm90::cp_async_wait<0>();

  float* part = out + static_cast<long long>(blockIdx.z) * rows * cout;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm + mt * 16 + g + h * 8;
        const int f = f0 + wn + nt * 8 + t * 2;  // cout % 8 == 0: f+1 too
        if (r < rows && f < cout) {
          *reinterpret_cast<float2*>(part + static_cast<long long>(r) * cout +
                                     f) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
}

// ---------------------------------------------------------------------------
// Pass 1, float32: CUDA cores.

__global__ void __launch_bounds__(kF32Threads)
bwdw_simt_f32(const float* __restrict__ x, const float* __restrict__ dy,
              float* __restrict__ out, int n_img, int height, int width,
              int cin, int cout, int ksize, long long per_split) {
  __shared__ __align__(16) float z_s[kStages][kF32BK][kBM];
  __shared__ __align__(16) float y_s[kStages][kF32BK][kBN];

  const int tid = threadIdx.x;
  const int rows = ksize * ksize * cin;
  const int f0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m_begin = static_cast<long long>(blockIdx.z) * per_split;
  const long long m_end =
      m_begin + per_split < m_total ? m_begin + per_split : m_total;
  const int n_chunks =
      m_end > m_begin
          ? static_cast<int>((m_end - m_begin + kF32BK - 1) / kF32BK)
          : 0;

  // loader: position slot j; Z row groups q + 8i (4 rows each, i = 0..3),
  // dY filter groups q and q + 8 (4 filters each)
  const int j = tid / 8;
  const int q = tid % 8;
  RowGroup zg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    zg[i].decode(r0 + (q + 8 * i) * 4, rows, cin, ksize, width);
  }
  Position pos;
  pos.start(m_begin + j, height, width);
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const int st = chunk % kStages;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        copy_z(&z_s[st][j][(q + 8 * i) * 4], x, pos, m_end, zg[i], cin,
               height, width);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int g = q + 8 * i;
        copy_dy(&y_s[st][j][g * 4], dy, pos, m_end, f0 + g * 4, cout);
      }
      pos.advance(kF32BK, height, width);
    }
    sm90::cp_async_commit();
  };

  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; filters tx*4 + {0..3} and
  // 32 + tx*4 + {0..3}
  const int tx = tid % 8;
  const int ty = tid / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;

  load(0);
  load(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();
    __syncthreads();
    load(chunk + 2);
    const int st = chunk % kStages;
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&z_s[st][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&z_s[st][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&y_s[st][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&y_s[st][kk][32 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
    }
  }
  sm90::cp_async_wait<0>();

  float* part = out + static_cast<long long>(blockIdx.z) * rows * cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = f0 + half * 32 + tx * 4;  // cout % 8 == 0: all 4 or none
      if (f < cout) {
        *reinterpret_cast<float4*>(part + static_cast<long long>(r) * cout +
                                   f) =
            make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                        acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dw[i] = sum over s = 0, 1, ..., splits-1 of ws[s][i], in that
// order.

__global__ void __launch_bounds__(kReduceThreads)
conv_bwdw_reduce(const float* __restrict__ ws, float* __restrict__ dw,
                 long long count, int splits) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * count + i];
    dw[i] = s;
  }
}

int launch(int dtype, const void* x, const void* dy, void* dw, void* ws,
           int n_img, int height, int width, int cin, int cout, int ksize,
           int path, int filters_per_tile, int splits, long long per_split,
           cudaStream_t stream, int* info) {
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const int rows = ksize * ksize * cin;
  const int bk = path == kPathTensorBf16 ? kTcBK : kF32BK;
  if ((path == kPathTensorBf16) != (dtype == 1) || per_split < 1 ||
      per_split % bk != 0 || (splits - 1) * per_split >= m_total ||
      splits * per_split < m_total || (splits > 1 && ws == nullptr)) {
    return kErrBadArgument;
  }
  if (path == kPathFloat32 ? filters_per_tile != kBN
                            : filters_per_tile != 64 && filters_per_tile != 128) {
    return kErrBadArgument;
  }
  const dim3 grid((cout + filters_per_tile - 1) / filters_per_tile,
                  (rows + kBM - 1) / kBM, splits);
  float* out = static_cast<float*>(splits > 1 ? ws : dw);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  if (path == kPathTensorBf16 && filters_per_tile == 128) {
    cudaFuncSetAttribute(bwdw_tc_bf16<128>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         tc_smem_bytes<128>());
    bwdw_tc_bf16<128><<<grid, kTcThreads, tc_smem_bytes<128>(), stream>>>(
        xb, dyb, out, n_img, height, width, cin, cout, ksize, per_split);
    info[4] = tc_smem_bytes<128>();
  } else if (path == kPathTensorBf16) {
    bwdw_tc_bf16<64><<<grid, kTcThreads, tc_smem_bytes<64>(), stream>>>(
        xb, dyb, out, n_img, height, width, cin, cout, ksize, per_split);
    info[4] = tc_smem_bytes<64>();
  } else {
    bwdw_simt_f32<<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), out,
        n_img, height, width, cin, cout, ksize, per_split);
    info[4] = static_cast<int>(sizeof(float) * kStages * kF32BK * (kBM + kBN));
  }
  cudaError_t err = cudaGetLastError();
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = splits;
  info[3] = static_cast<int>(per_split);
  info[5] = 1;
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(rows) * cout;
  long long blocks = (count + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 4096) blocks = 4096;
  conv_bwdw_reduce<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                     stream>>>(static_cast<const float*>(ws),
                               static_cast<float*>(dw), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and dy); dw [ksize, ksize, cin, cout]
// and the workspace ws [splits, ksize*ksize*cin, cout] (unused when splits
// is 1) are float32. x [n, height, width, cin] NHWC, dy [n, height, width,
// cout]; all contiguous and 16-byte aligned. path 1 = tensor cores
// (bfloat16; filters_per_tile 64 or 128), 2 = CUDA cores (float32;
// filters_per_tile 64); the reduction is split into
// ``splits`` ranges of ``per_split`` positions (a multiple of the path's
// chunk, 32 or 16; every range non-empty). info receives {filter tiles, row
// tiles, splits, positions per split, static shared memory bytes of pass 1,
// launches made (one per call: pass 1 and pass 2 together)}. Returns 0, a
// cudaError_t value, or a negative code above.
int conv2d_same_bwdw(int dtype, const void* x, const void* dy, void* dw,
                     void* ws, int n_img, int height, int width, int cin,
                     int cout, int ksize, int path, int filters_per_tile,
                     int splits, int per_split, int device, void* stream,
                     int* info) {
  if (n_img < 1 || height < 1 || width < 1 || cin < 8 || cout < 8 ||
      cin % 8 != 0 || cout % 8 != 0 || (ksize != 1 && ksize != 3) ||
      splits < 1 || (dtype != 0 && dtype != 1)) {
    return kErrBadArgument;
  }
  if (splits > 65535 || (ksize * ksize * cin + kBM - 1) / kBM > 65535) {
    return kErrTooLarge;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(dtype, x, dy, dw, ws, n_img, height, width, cin, cout, ksize,
                path, filters_per_tile, splits, per_split,
                static_cast<cudaStream_t>(stream), info);
}

const char* conv2d_same_bwdw_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code, an empty shape, C or F not a "
             "multiple of 8, k not 1 or 3, or a plan the path does not take)";
    case kErrTooLarge:
      return "more than 65535 splits or row tiles";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
